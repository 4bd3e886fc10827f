"""Profiler ranges around the port's op boundaries, opened from the harness's
own code, for the traced run only.

The model modules reach the attention through `_FlashAttention` (forward in
the model's call, backward in autograd's), the scan through
`_SelectiveScan`, and the subsampling's conv chain through the names
`dw_striding_chain` / `fused_dw_striding` that `ops/conv.py` binds; the
Trainer's `make_chunks` gets a range too, so that the host's time between
steps has a name in the breakdown.  Each is wrapped, while `installed()` is
open, in a `record_function` range named `lcbench.<span>`; the trace credits a span with the device time of every
kernel launched inside its ranges, whatever those kernels are called, so a
later kernel under the same op is measured on the same work.  Each call's
shape (and the attention's lengths, kept on the device and read after the
window) goes into `calls`, from which the metrics compute the bounds.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List

from lcbench.harness.trace import SPAN_PREFIX


class CallLog:
    """What the wrapped ops were called with, by span."""

    def __init__(self):
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.active = False  # recorded only inside the window

    def add(self, span: str, **info) -> None:
        if self.active:
            self.calls[span].append(info)


def _range(name: str):
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def host_range(name: str, on: bool):
    """A range around host work of the harness's own (the Trainer's loader),
    in the traced run only."""
    return _range(name) if on else contextlib.nullcontext()


@contextlib.contextmanager
def installed(log: CallLog):
    """Wrap the op boundaries for as long as the context is open."""
    import lcasr_torch.ops.conv as conv
    import lcasr_torch.training.trainer as trainer
    from lcasr_torch.ops.flash_attention import _FlashAttention
    from lcasr_torch.ops.ssm import _SelectiveScan

    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    attn_fwd, attn_bwd = _FlashAttention.forward, _FlashAttention.backward

    def attention_forward(ctx, q, k, v, lengths, *rest):
        B, T, H, D = q.shape
        log.add("attn_fwd", B=B, T=T, H=H, D=D, lengths=lengths)
        ctx.lcbench_call = dict(B=B, T=T, H=H, D=D, lengths=lengths)
        with _range("attn_fwd"):
            return attn_fwd(ctx, q, k, v, lengths, *rest)

    def attention_backward(ctx, do):
        log.add("attn_bwd", **getattr(ctx, "lcbench_call", {}))
        with _range("attn_bwd"):
            return attn_bwd(ctx, do)

    scan_fwd, scan_bwd = _SelectiveScan.forward, _SelectiveScan.backward

    def scan_forward(ctx, x, delta, A, B, C, need_states):
        shape = (*x.shape, A.shape[1])
        log.add("scan_fwd", shape=shape, x_bytes=x.element_size(),
                bc_bytes=B.element_size(), states=bool(need_states))
        ctx.lcbench_call = dict(shape=shape, x_bytes=x.element_size(),
                                bc_bytes=B.element_size(), states=True)
        with _range("scan_fwd"):
            return scan_fwd(ctx, x, delta, A, B, C, need_states)

    def scan_backward(ctx, g):
        log.add("scan_bwd", **getattr(ctx, "lcbench_call", {}))
        with _range("scan_bwd"):
            return scan_bwd(ctx, g)

    chain, fused = conv.dw_striding_chain, conv.fused_dw_striding

    def chain_call(h, params, act="silu", causal=False, seq=None):
        B, _, T, F = h.shape
        log.add("subsampling", B=B, T=T, F=F, C=params[0].shape[0],
                elem_bytes=h.element_size(), act=act)
        with _range("subsampling"):
            return chain(h, params, act, causal, seq)

    def fused_call(x, params, act="silu"):
        B, T, F = x.shape
        log.add("subsampling", B=B, T=T, F=F, C=params[0].shape[0],
                elem_bytes=x.element_size(), act=act)
        with _range("subsampling"):
            return fused(x, params, act)

    chunks = trainer.make_chunks

    def make_chunks(*args, **kwargs):
        with _range("make_chunks"):
            return chunks(*args, **kwargs)

    patch(trainer, "make_chunks", make_chunks)
    patch(_FlashAttention, "forward", staticmethod(attention_forward))
    patch(_FlashAttention, "backward", staticmethod(attention_backward))
    patch(_SelectiveScan, "forward", staticmethod(scan_forward))
    patch(_SelectiveScan, "backward", staticmethod(scan_backward))
    patch(conv, "dw_striding_chain", chain_call)
    patch(conv, "fused_dw_striding", fused_call)
    try:
        yield log
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
