"""Ring attention: context-parallel exact attention with rotating K / V
blocks (counterpart of lcasr_tpu/parallel/ring_attention.py).

Each rank of the `seq` axis keeps its own K / V block.  Over n steps the
blocks rotate to the right neighbour (`batch_isend_irecv`, the next block in
flight while the kernel runs on the current one), and each rank merges its
queries' attention over every block by the partial outputs' log-sum-exp in
fp32 (`merge`).  Every step is one forward kernel launch (K1, or K2 under
LCASR_ATTN_FWD_DB=1) with global q / kv offsets, so bands and length masks
stay exact; a block wholly outside a band is skipped tile by tile inside
the kernel.

The backward takes n steps of the backward kernels (K3, or K4 + K5 where
the band is two-sided) against the merged lse, which makes each block's
(dk, dv) and each step's dq exact; the (dk, dv) accumulators travel with
their block and are home after n rotations.  KV memory is O(T / n) a rank.

The per-block compute (`ring_step_fwd`, `merge`, `ring_finish`,
`ring_step_bwd`) needs no process group, so one card can run a whole
schedule block by block and hold it against one kernel over the sequence.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from lcasr_torch.ops.flash_attention import flash_attention_bwd, flash_attention_with_lse
from lcasr_torch.parallel.collectives import Axis, p2p, p2p_start

NEG_INF = -1e30


def ring_init(q: torch.Tensor):
    """The empty fp32 accumulator (num (B, T, H, D), den and m (B, T, H, 1))."""
    B, T, H, D = q.shape
    num = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, T, H, 1), dtype=torch.float32, device=q.device)
    m = torch.full((B, T, H, 1), NEG_INF, dtype=torch.float32, device=q.device)
    return num, den, m


def merge(num, den, m, o_s, lse_s):
    """Online-softmax merge of a normalised partial (o_s, lse_s (B, H, T))
    into the running (num, den, m); all fp32 (the JAX `_merge`)."""
    lse = lse_s.transpose(1, 2)[..., None]  # (B, T, H, 1)
    m_new = torch.maximum(m, lse)
    scale_old = torch.exp(m - m_new)
    scale_new = torch.exp(lse - m_new)
    num = num * scale_old + o_s.float() * scale_new
    den = den * scale_old + scale_new
    return num, den, m_new


def ring_finish(num, den, m, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out in `dtype`, merged lse (B, H, T), NEG_INF on fully-masked rows)."""
    ok = den > 0.0
    safe = den.clamp_min(1e-37)
    out = torch.where(ok, num / safe, torch.zeros_like(num)).to(dtype)
    lse = torch.where(ok, m + torch.log(safe), torch.full_like(m, NEG_INF))
    return out, lse[..., 0].transpose(1, 2).contiguous()


def ring_step_fwd(q, k_blk, v_blk, lengths, window, softmax_scale, q_offset: int,
                  kv_offset: int):
    """One step: the local queries against one K / V block -> (o_s, lse_s)."""
    return flash_attention_with_lse(q, k_blk, v_blk, lengths=lengths, window=window,
                                    softmax_scale=softmax_scale, q_offset=q_offset,
                                    kv_offset=kv_offset)


def ring_step_bwd(q, k_blk, v_blk, out, lse, do, lengths, window, softmax_scale,
                  q_offset: int, kv_offset: int):
    """One backward step against the merged (out, lse): (dq_s, dk_s, dv_s)."""
    return flash_attention_bwd(q, k_blk, v_blk, out, lse, do, lengths=lengths, window=window,
                               softmax_scale=softmax_scale, q_offset=q_offset,
                               kv_offset=kv_offset)


def _rotation(tensors, axis: Axis, tag0: int):
    """Sends to the right neighbour, receives from the left one; returns the
    receive buffers and the requests."""
    i, n = axis.index, axis.size
    right, left = axis.ranks[(i + 1) % n], axis.ranks[(i - 1) % n]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [("send", t, right, tag0 + j) for j, t in enumerate(tensors)]
    ops += [("recv", b, left, tag0 + j) for j, b in enumerate(bufs)]
    return bufs, ops


def _ring_fwd(q, k, v, lengths, window, softmax_scale, axis: Axis):
    i, n, t = axis.index, axis.size, q.shape[1]
    acc = ring_init(q)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for s in range(n):
        reqs = []
        if s + 1 < n:
            nxt, ops = _rotation((k_cur, v_cur), axis, 0)
            reqs = p2p_start(ops, axis.group)
        # the block held at step s started on rank (i - s) mod n
        o_s, lse_s = ring_step_fwd(q, k_cur, v_cur, lengths, window, softmax_scale,
                                   i * t, ((i - s) % n) * t)
        acc = merge(*acc, o_s, lse_s)
        for r in reqs:
            r.wait()
        if s + 1 < n:
            k_cur, v_cur = nxt
    return ring_finish(*acc, q.dtype)


def _ring_bwd(q, k, v, out, lse, do, lengths, window, softmax_scale, axis: Axis):
    i, n, t = axis.index, axis.size, q.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for s in range(n):
        reqs = []
        if s + 1 < n:
            nxt, ops = _rotation((k_cur, v_cur), axis, 0)
            reqs = p2p_start(ops, axis.group)
        dq_s, dk_s, dv_s = ring_step_bwd(q, k_cur, v_cur, out, lse, do, lengths, window,
                                         softmax_scale, i * t, ((i - s) % n) * t)
        dq += dq_s.float()
        dk += dk_s.float()
        dv += dv_s.float()
        if n > 1:  # (dk, dv) travel with their block: n rotations bring them home
            (dk_n, dv_n), ops = _rotation((dk, dv), axis, 2)
            p2p(ops, axis.group)
            dk, dv = dk_n, dv_n
        for r in reqs:
            r.wait()
        if s + 1 < n:
            k_cur, v_cur = nxt
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, window, softmax_scale, axis):
        out, lse = _ring_fwd(q, k, v, lengths, window, softmax_scale, axis)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.args = (window, softmax_scale, axis)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        window, softmax_scale, axis = ctx.args
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, do.contiguous(), lengths, window,
                               softmax_scale, axis)
        return dq, dk, dv, None, None, None, None


def ring_attention(
    q: torch.Tensor,  # (B, t_local, H, D): this rank's shard
    k: torch.Tensor,
    v: torch.Tensor,
    axis: Axis,
    lengths: Optional[torch.Tensor] = None,  # (B,) global
    window: Tuple[int, int] = (-1, -1),
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention of the local queries over the whole sequence, K / V
    rotating around the `seq` axis; differentiable in q, k and v."""
    if lengths is None:
        lengths = torch.full((q.shape[0],), q.shape[1] * axis.size, dtype=torch.int32,
                             device=q.device)
    return _RingAttention.apply(q, k, v, lengths.to(torch.int32), tuple(window),
                                softmax_scale, axis)
