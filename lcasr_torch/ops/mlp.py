"""Conformer feed-forward (counterpart of lcasr_tpu/ops/mlp.py):
Dense -> tanh-approximate GELU -> Dense, or Swish (SiLU) in its place with
`activation="swish"` (NeMo's FastConformer); `site` tags both for W8A8
(ops/qdense.py).  `SwiGLU` is the JAX package's spare gated unit, which no
configuration uses."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lcasr_torch.ops.dense import Dense


class ConformerFeedForward(nn.Module):
    def __init__(self, d_model: int, hidden_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, bias1: bool = False,
                 bias2: bool = False, dtype: torch.dtype = torch.float32,
                 site: Optional[str] = None, activation: str = "gelu_tanh"):
        super().__init__()
        if activation not in ("gelu_tanh", "swish"):
            raise ValueError(f"activation must be gelu_tanh or swish, got {activation!r}")
        hidden = hidden_dim or d_model * 4
        self.swish = activation == "swish"
        self.fc1 = Dense(d_model, hidden, bias=bias1, dtype=dtype, site=site)
        self.fc2 = Dense(hidden, out_dim or d_model, bias=bias2, dtype=dtype, site=site)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(F.silu(h) if self.swish else F.gelu(h, approximate="tanh"))


class SwiGLU(nn.Module):
    """out_proj(silu(gate) * up), gate and up the halves of in_proj(x); both
    projections without bias, the hidden width d_model x expansion_factor."""

    def __init__(self, d_model: int, expansion_factor: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = d_model * expansion_factor
        self.in_proj = Dense(d_model, hidden * 2, bias=False, dtype=dtype)
        self.out_proj = Dense(hidden, d_model, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.in_proj(x).chunk(2, dim=-1)
        return self.out_proj(F.silu(gate) * up)
