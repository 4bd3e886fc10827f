"""Learnable Fourier positional encoding, the dynamic position bias and the
scaled sinusoidal embedding (counterparts of lcasr_tpu/models/positional.py
`LearnableFourierPosEnc`, the `fourier` arm of the paper's
positional-encoding ablations, `DynamicPositionBias`, the V2
encoder-decoder's attention bias, and `ScaledSinuEmbedding`, a spare
component no configuration uses).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lcasr_torch.ops.dense import Dense


class LearnableFourierPosEnc(nn.Module):
    """x + learnable Fourier features of the absolute position: a
    gamma-scaled Gaussian projection `w_r` of the scalar position into
    d_model / 2 cos / sin pairs, scaled by d_model^-1/2.  `gamma=None` means
    d_model // 2.  With `hidden_dim` the features pass a Linear-GELU-Linear
    MLP before they are added (the conformer uses none).  `offsets` (B,)
    shifts each sample's positions."""

    def __init__(self, d_model: int, gamma: Optional[float] = 1.0,
                 hidden_dim: Optional[int] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        gamma = gamma if gamma is not None else d_model // 2
        self.w_r = nn.Parameter(torch.randn(1, d_model // 2) * gamma ** -0.5)
        self.hidden_dim = hidden_dim
        if hidden_dim is not None:
            self.mlp_0 = Dense(d_model, hidden_dim, dtype=dtype)
            self.mlp_1 = Dense(hidden_dim, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor, offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        T = x.shape[1]
        pos = torch.arange(T, dtype=torch.float32, device=x.device)[None, :, None]
        if offsets is not None:
            pos = pos + offsets[:, None, None].float()
        proj = pos @ self.w_r  # (B or 1, T, d_model // 2)
        pe = torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1) * self.d_model ** -0.5
        if self.hidden_dim is not None:
            pe = self.mlp_1(F.gelu(self.mlp_0(pe.to(self.dtype)), approximate="none"))
        return x + pe.to(x.dtype)


class DynamicPositionBias(nn.Module):
    """An fp32 MLP over the relative distances -(Tk-1) .. Tq-1 (`depth`
    silu Dense layers of width `dim`, then `proj` to one bias per head),
    read out as bias[i - j + Tk - 1] for query i and key j: (H, Tq, Tk)
    fp32.  `log_distance` feeds sign(r) log(1 + |r|) instead of r."""

    def __init__(self, dim: int, heads: int, depth: int = 2, log_distance: bool = False):
        super().__init__()
        self.depth, self.log_distance = depth, log_distance
        for i in range(depth):
            self.add_module(f"mlp_{i}", Dense(1 if i == 0 else dim, dim, dtype=torch.float32))
        self.proj = Dense(dim, heads, dtype=torch.float32)

    def forward(self, seqlen_q: int, seqlen_k: int) -> torch.Tensor:
        device = self.proj.weight.device
        rel = torch.arange(-(seqlen_k - 1), seqlen_q, dtype=torch.float32, device=device)[:, None]
        if self.log_distance:
            rel = torch.sign(rel) * torch.log1p(rel.abs())
        h = rel
        for i in range(self.depth):
            h = F.silu(getattr(self, f"mlp_{i}")(h))
        bias = self.proj(h)  # (Tq + Tk - 1, H)
        idx = (torch.arange(seqlen_q, device=device)[:, None]
               - torch.arange(seqlen_k, device=device)[None, :] + seqlen_k - 1)
        return bias[idx].permute(2, 0, 1)


class ScaledSinuEmbedding(nn.Module):
    """x + scale * [sin(t f), cos(t f)] over absolute positions t, the
    frequencies f = 10000^(-2i / d_model), one learned scalar `scale` (1.0 at
    init).  f is computed once, on the CPU, and moves with the module: a
    `pow` of another device can round f an ulp apart, which t up to 16,383
    turns into arguments 2^-9 apart."""

    def __init__(self, d_model: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        self.scale = nn.Parameter(torch.ones(1))
        inv_freq = 1.0 / (10000 ** (torch.arange(0, d_model, 2, dtype=torch.float32,
                                                 device="cpu") / d_model))
        self.register_buffer("inv_freq", inv_freq, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)
        sinu = t[:, None] * self.inv_freq[None, :]
        emb = torch.cat([torch.sin(sinu), torch.cos(sinu)], dim=-1)
        return x + (emb * self.scale).to(x.dtype)[None]
