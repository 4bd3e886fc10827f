"""Context-parallel attention, gather form (counterpart of
lcasr_tpu/parallel/context_parallel.py `context_parallel_attention`).

Each rank of the `seq` axis holds a time shard of q, k and v.  K and V are
all-gathered over the axis (their gradient is reduce-scattered back), and
the attention kernel runs on the local queries against the whole sequence
with `q_offset = rank * t_local`, so the band and the length masks stay
exact in global coordinates.  The output stays sharded, as the position-local
layers around it need.  KV memory is O(T) on every rank; `ring_attention`
keeps it at O(T / n).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from lcasr_torch.ops.flash_attention import flash_attention
from lcasr_torch.parallel.collectives import Axis, all_gather_seq


def context_parallel_attention(
    q: torch.Tensor,  # (B, t_local, H, D): this rank's shard
    k: torch.Tensor,
    v: torch.Tensor,
    axis: Axis,
    lengths: Optional[torch.Tensor] = None,  # (B,) global
    window: Tuple[int, int] = (-1, -1),
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    t_local = q.shape[1]
    if lengths is None:
        lengths = torch.full((q.shape[0],), t_local * axis.size, dtype=torch.int32,
                             device=q.device)
    k_full = all_gather_seq(k, axis, dim=1)
    v_full = all_gather_seq(v, axis, dim=1)
    return flash_attention(q, k_full, v_full, lengths=lengths, window=window,
                           softmax_scale=softmax_scale, q_offset=axis.index * t_local)
