"""Profiling and timing helpers (counterpart of lcasr_tpu/utils/profiling.py).

`trace` records a `torch.profiler` trace of the CPU and, where there is one,
the GPU, and writes it under `log_dir` as a Chrome trace (`*.pt.trace.json`,
which TensorBoard's profiler plugin and Perfetto open).  `time_fn` and
`time_fn_chain` time a callable with the device work finished: they
synchronise the CUDA device of every tensor the callable returns, and do not
synchronise for CPU tensors.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch


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
