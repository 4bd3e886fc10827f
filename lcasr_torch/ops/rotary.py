"""Rotary position embeddings (counterpart of lcasr_tpu/ops/rotary.py).

Inverse frequencies 1/base^(2i/d), positions divided by the interpolation
factor, fp32 tables `concat(freqs, freqs)`.  `apply_rotary` multiplies q and
k by the fp32 tables (so bf16 q promotes to fp32) and casts back to q's and
k's dtype, as the JAX package does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def _inv_freq(dim: int, base: float, device=None) -> torch.Tensor:
    return 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def rotary_tables(
    seq_len: int,
    dim: int,
    base: float = 10000.0,
    interpolation_factor: float = 1.0,
    inv_freq: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
    offset: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (seq_len, dim); `offset` shifts the positions."""
    if inv_freq is None:
        inv_freq = _inv_freq(dim, base, device)
    inv_freq = inv_freq.float()
    t = (offset + torch.arange(seq_len, dtype=torch.float32, device=inv_freq.device)) / interpolation_factor
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(q, k, cos, sin, q_offset: int = 0):
    """q, k: (B, T, H, D); cos, sin: (T_kv, D)."""
    cos_b = cos[None, :, None, :]
    sin_b = sin[None, :, None, :]
    q_cos = cos_b[:, q_offset : q_offset + q.shape[1]]
    q_sin = sin_b[:, q_offset : q_offset + q.shape[1]]
    k_cos = cos_b[:, : k.shape[1]]
    k_sin = sin_b[:, : k.shape[1]]
    q_out = q * q_cos + rotate_half(q) * q_sin
    k_out = k * k_cos + rotate_half(k) * k_sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


class RotaryEmbedding(nn.Module):
    """Carrier of the (optionally learned) inverse frequencies."""

    def __init__(self, dim: int, base: float = 10000.0, learned_freq: bool = False,
                 interpolation_factor: float = 1.0):
        super().__init__()
        self.dim = dim
        self.base = base
        self.interpolation_factor = interpolation_factor
        inv = _inv_freq(dim, base)
        if learned_freq:
            self.inv_freq = nn.Parameter(inv)
        else:
            self.register_buffer("inv_freq", inv, persistent=False)

    def forward(self, seq_len: int, dtype: torch.dtype = torch.float32, offset: int = 0):
        return rotary_tables(
            seq_len, self.dim, interpolation_factor=self.interpolation_factor,
            inv_freq=self.inv_freq, dtype=dtype, offset=offset,
        )
