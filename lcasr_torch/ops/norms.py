"""Normalisation layers (counterpart of lcasr_tpu/ops/norms.py).

Statistics are fp32 whatever the input dtype; the output is cast back to
the input's dtype.  Each forward is the span `norm` (utils/profiling.py).
"""
from __future__ import annotations

import torch
from torch import nn

from lcasr_torch.utils.profiling import span


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm"):
            xf = x.float()
            mean = xf.mean(-1, keepdim=True)
            var = ((xf - mean) ** 2).mean(-1, keepdim=True)
            y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
            return (y * self.scale + self.bias).to(x.dtype)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale, eps 1e-6 (apex FusedRMSNorm)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm"):
            xf = x.float()
            ms = (xf * xf).mean(-1, keepdim=True)
            y = xf * torch.reciprocal(torch.sqrt(ms + self.eps))
            return (y * self.scale).to(x.dtype)


def get_norm(name: str):
    if name == "rms_norm":
        return RMSNorm
    if name == "layer_norm":
        return LayerNorm
    raise ValueError(f"default_norm must be rms_norm or layer_norm (got {name})")
