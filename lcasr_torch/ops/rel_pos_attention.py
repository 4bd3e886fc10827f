"""Relative-position multi-head attention (Transformer-XL, arXiv:1901.02860,
as NeMo's `RelPositionMultiHeadAttention` with untied biases computes it).

For a head with query q_i, key k_j, value v_j and head size D, the score of
the pair (i, j) holds a content term and a position term:

    score[i, j] = ((q_i + u) . k_j + (q_i + v) . p(i - j)) / sqrt(D)

where p(r) = PE(r) W_pos is the sinusoid table at relative position r
(`sinusoid_table`) through the layer's unbiased `linear_pos`, and u, v are
the layer's (H, D) biases.  Padded keys get -10000 added (NeMo fills them
with -10000: the same softmax, as exp underflows to 0 beside any valid
key), and the rows of padded queries come out zero.

`rel_pos_attention` computes it on any device in plain PyTorch, with no host
synchronisation:

  1. the position term of every query against every relative position,
     M = ((q + v) / sqrt(D)) P^T, one product of (T, D) by (D, 2T - 1) a
     head, with P's rows from position T - 1 down to -(T - 1) (and zero
     rows after them up to a multiple of 8);
  2. the pair (i, j) needs M[i, T - 1 - i + j]: a strided view of M with
     row stride one less than M's (NeMo's `rel_shift`, without its copy),
     written once, with the keys' -10000, into a (T, T) bias (the fused
     kernels of `scaled_dot_product_attention` take it as it is where T is
     a multiple of 8, as at the decode's T' = 2048, and pad a copy
     otherwise);
  3. `scaled_dot_product_attention(q + u, k, v, bias)`: the content term,
     the sum, the softmax and the weighted values in one library call.

So every term is computed at every pair; the position term is materialised
(2T + T columns a row in the compute dtype), which a fused kernel would
avoid.  `launch_counts["rel_pos_attention"]` counts the calls, and each call
is the span `relpos_attn` (utils/profiling.py).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lcasr_torch import kernels
from lcasr_torch.ops.dense import Dense
from lcasr_torch.utils.profiling import span

MASKED = -10000.0  # NeMo's fill of a padded key's score


def sinusoid_table(n: int, d_model: int, device=None) -> torch.Tensor:
    """(2n - 1, d_model) fp32: row c is PE(r) at r = n - 1 - c, with
    PE(r)[2m] = sin(r 10000^(-2m / d_model)), PE(r)[2m + 1] = cos(...)."""
    pos = torch.arange(n - 1, -n, -1, dtype=torch.float32, device=device)
    inv = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    ang = pos[:, None] * inv[None, :]
    return torch.stack([ang.sin(), ang.cos()], dim=-1).reshape(2 * n - 1, d_model)


def rel_pos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                      bias_u: torch.Tensor, bias_v: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v (B, T, H, D); pos (2T - 1, H, D), the projected table of
    `sinusoid_table(T, ...)`; bias_u, bias_v (H, D); lengths (B,) or None
    -> (B, T, H, D), zero on the rows of padded queries."""
    with span("relpos_attn"):
        kernels.launch_counts["rel_pos_attention"] += 1
        B, T, H, D = q.shape
        if pos.shape != (2 * T - 1, H, D):
            raise ValueError(f"rel_pos_attention: pos {tuple(pos.shape)} for q {tuple(q.shape)}; "
                             f"expected {(2 * T - 1, H, D)}")
        scale = D ** -0.5
        qu = (q + bias_u.to(q.dtype)).transpose(1, 2)
        qv = ((q + bias_v.to(q.dtype)) * scale).transpose(1, 2)
        # rows of zeros after the table's last, so that M's rows are a multiple
        # of 8 elements long (cuBLAS's fast products need aligned rows)
        W = -(-2 * T // 8) * 8
        table = F.pad(pos, (0, 0, 0, 0, 0, W - (2 * T - 1)))
        m = torch.matmul(qv, table.permute(1, 2, 0)).contiguous()  # (B, H, T, W)
        shifted = m.as_strided((B, H, T, T), (H * T * W, T * W, W - 1, 1),
                               m.storage_offset() + T - 1)
        if lengths is None:
            bias = shifted.contiguous()
        else:
            keys = torch.arange(T, device=q.device)[None, :] < lengths.to(q.device)[:, None]
            bias = shifted + torch.where(keys, 0.0, MASKED).to(q.dtype)[:, None, None, :]
        del m
        out = F.scaled_dot_product_attention(qu, k.transpose(1, 2), v.transpose(1, 2),
                                             attn_mask=bias, scale=scale).transpose(1, 2)
        if lengths is not None:
            out = out.masked_fill(~keys[:, :, None, None], 0.0)
        return out


class RelPositionAttention(nn.Module):
    """Biased q / k / v / out projections, the unbiased `linear_pos`, the
    (H, D) biases `pos_bias_u`, `pos_bias_v` (NeMo's names) and the op.
    forward(x (B, T, d), pe (2T - 1, d) the sinusoid table, lengths)."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = n_heads * head_dim
        self.n_heads, self.head_dim = n_heads, head_dim
        self.linear_q = Dense(d_model, inner, dtype=dtype, site="qkv")
        self.linear_k = Dense(d_model, inner, dtype=dtype, site="qkv")
        self.linear_v = Dense(d_model, inner, dtype=dtype, site="qkv")
        self.linear_pos = Dense(d_model, inner, bias=False, dtype=dtype, site="proj")
        self.linear_out = Dense(inner, d_model, dtype=dtype, site="attn_out")
        self.pos_bias_u = nn.Parameter(torch.zeros(n_heads, head_dim))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_heads, head_dim))

    def forward(self, x: torch.Tensor, pe: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        H, D = self.n_heads, self.head_dim
        q = self.linear_q(x).view(B, T, H, D)
        k = self.linear_k(x).view(B, T, H, D)
        v = self.linear_v(x).view(B, T, H, D)
        pos = self.linear_pos(pe).view(2 * T - 1, H, D)
        out = rel_pos_attention(q, k, v, pos, self.pos_bias_u, self.pos_bias_v, lengths)
        return self.linear_out(out.reshape(B, T, H * D))
