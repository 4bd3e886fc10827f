"""The bound of one call to the relative-position attention op
(`lcasr_torch.ops.rel_pos_attention.rel_pos_attention`), whatever computes it:
the larger of its operations at the bf16 peak and its bytes at the memory
rate (`bounds.PEAK_FLOPS`, `bounds.PEAK_BYTES_PER_S`).

  operations: 6 T'q T'k D a head over the (query, key) pairs the lengths
      leave valid: the content term (q + u) . k, the position term
      (q + v) . p(i - j) and the weighted values, 2 D each;
  bytes: q, k, v (B, T, H, D) and the position table p (2T - 1, H, D) read
      once in bf16, the output (B, T, H, D) written once, and the lengths.
"""
from __future__ import annotations

from lcbench.harness.bounds import PEAK_BYTES_PER_S, PEAK_FLOPS, valid_pairs


def relpos_attention_bound(B, T, H, D, lengths=None, elem_bytes: int = 2):
    """(bound ms, bound_by, flops) of one call."""
    flops = 6 * H * D * valid_pairs(lengths, B, T, (-1, -1), 0, 0)
    nbytes = elem_bytes * (4 * B * T * H * D + (2 * T - 1) * H * D) + 4 * B
    t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops
