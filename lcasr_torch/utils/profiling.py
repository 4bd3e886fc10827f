"""Profiling and timing helpers (counterpart of lcasr_tpu/utils/profiling.py).

`trace` records a `torch.profiler` trace of the CPU and, where there is one,
the GPU, and writes it under `log_dir` as a Chrome trace (`*.pt.trace.json`,
which TensorBoard's profiler plugin and Perfetto open).  `time_fn` and
`time_fn_chain` time a callable with the device work finished: they
synchronise the CUDA device of every tensor the callable returns, and do not
synchronise for CPU tensors.

The port's own ranges.  While any `torch.profiler` records (`trace`, or a
profiler of the caller's own), the port opens `record_function` ranges named
`lcasr.<span>` where its work happens: the decode loop (`lcasr.decode.*`),
the Trainer's host work (`lcasr.train.*`), the model's modules
(`ff`, `attention`, `conv`, `mixer`, `self_cond`, `head`, `norm`,
`subsampling`), the ops (`attn_fwd`, `attn_bwd`, `scan_fwd`,
`scan_bwd`, `ctc_fwd`, `ctc_bwd`, `relpos_attn`) and the audio frontend
(`frontend.read`, `frontend.resample`, `frontend.mel`).  They go into the same trace as the
kernels, on the profiler's clock: in Perfetto (ui.perfetto.dev, open the
`.pt.trace.json`) each range is a slice on the thread that opened it, above
the launch calls it holds, which flow arrows join to their kernels, and a
search for `lcasr.` lists them; in TensorBoard's profiler plugin they are rows of the
trace viewer and of the operator table.  A backward range (`attn_bwd`,
`scan_bwd`, `ctc_bwd`, the modules' recomputed forwards) is on autograd's
thread, not on the one that called `backward()`.  Without a profiler a
span costs one check of a flag.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch


SPAN_PREFIX = "lcasr."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`with span("norm"): ...` records the range `lcasr.norm` while a torch
    profiler is recording, and is one shared no-op otherwise: a bare
    `record_function` costs microseconds a call even with no profiler."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def backward_span(name: str, output: torch.Tensor, origin: torch.Tensor) -> None:
    """The range `lcasr.<name>` around the backward of the ops from `origin`
    to `output`: opened when `output`'s gradient arrives and closed when
    `origin`'s is complete, by hooks that run on the thread that runs that
    backward (autograd's device thread on the card).  Only while a profiler
    is recording, and only where both need a gradient."""
    if not (torch.autograd.profiler._is_profiler_enabled
            and output.requires_grad and origin.requires_grad):
        return
    opened = []

    def open_range(grad):
        opened.append(span(name))
        opened[-1].__enter__()

    def close_range(grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    output.register_hook(open_range)
    origin.register_hook(close_range)


def _devices(out) -> set:
    """The CUDA devices of every tensor in `out` (nested lists, tuples and
    dicts)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_devices(o) for o in out)) if out else set()
    return set()


def _sync(out) -> None:
    """Wait for the device work behind `out`: one synchronise per CUDA device
    among its tensors, none for CPU tensors."""
    for device in _devices(out):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """`with trace(d) as prof: fn()` records CPU and CUDA activity and writes
    a Chrome trace under d (by default `lcasr_trace` in the temporary
    directory, which follows TMPDIR) on exit; `prof.key_averages()` sums it
    by name."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "lcasr_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def time_fn(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 10,
    **kwargs,
) -> Dict[str, float]:
    """Wall time of fn(*args, **kwargs), each call waited for on its device."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        _sync(fn(*args, **kwargs))
    total = time.perf_counter() - t0
    return {"mean_s": total / iters, "total_s": total, "iters": iters}


def time_fn_chain(
    fn: Callable,
    x: torch.Tensor,
    n: int = 10,
    warmup: int = 1,
    iters: int = 3,
) -> Dict[str, float]:
    """Milliseconds a call of `fn` (one tensor in, a tensor out) with n calls
    queued back to back and one synchronise at the end, the best of `iters`
    chains.  Each call's input carries `0 * out` of the call before, as the
    JAX package's loop does, so the calls form one chain of dependences."""

    def chain(x0):
        c = x0
        for _ in range(n):
            o = fn(c)
            c = c + (0.0 * o).to(c.dtype)
        return c

    for _ in range(warmup):
        _sync(chain(x))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(chain(x))
        best = min(best, time.perf_counter() - t0)
    return {"ms": best / n * 1000.0, "n": n, "iters": iters}
