"""Attention masks and the exact attention oracle (counterpart of
lcasr_tpu/ops/attention.py).

Non-causal softmax attention with scale 1/sqrt(D), key-padding masks from
per-sequence lengths, an optional (left, right) band (-1 = unbounded) where
row i sees columns i - left <= j <= i + right, zero rows where every key is
masked, and zeroed padded query rows.  fp32 statistics whatever the input
dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def length_mask(lengths: torch.Tensor, max_len: int, offset: int = 0) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool, True = valid."""
    pos = offset + torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def window_mask(seqlen_q: int, seqlen_k: int, window: Tuple[int, int],
                q_offset: int = 0, device=None) -> Optional[torch.Tensor]:
    """(seqlen_q, seqlen_k) bool, True = inside the band; None if unbounded."""
    left, right = window
    if left < 0 and right < 0:
        return None
    rows = q_offset + torch.arange(seqlen_q, device=device)[:, None]
    cols = torch.arange(seqlen_k, device=device)[None, :]
    ok = torch.ones((seqlen_q, seqlen_k), dtype=torch.bool, device=device)
    if right >= 0:
        ok &= cols <= rows + right
    if left >= 0:
        ok &= cols >= rows - left
    return ok


def reference_attention(q, k, v, q_lengths=None, kv_lengths=None,
                        window: Tuple[int, int] = (-1, -1),
                        softmax_scale: Optional[float] = None, q_offset: int = 0,
                        return_weights: bool = False):
    """q: (B, Tq, H, D); k, v: (B, Tk, H, D) -> (B, Tq, H, D) in q's dtype;
    with `return_weights`, also the fp32 probabilities (B, H, Tq, Tk)
    (padded query rows keep theirs; only the output is zeroed there)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    valid = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if kv_lengths is not None:
        valid = valid & length_mask(kv_lengths, Tk)[:, None, None, :]
    wm = window_mask(Tq, Tk, window, q_offset=q_offset, device=q.device)
    if wm is not None:
        valid = valid & wm[None, None]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    e = torch.where(valid, torch.exp(scores - m), 0.0)
    probs = e / e.sum(-1, keepdim=True).clamp_min(1e-37)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    if q_lengths is not None:
        qmask = length_mask(q_lengths, Tq, offset=q_offset)
        out = torch.where(qmask[:, :, None, None], out, 0.0)
    if return_weights:
        return out.to(q.dtype), probs
    return out.to(q.dtype)
