"""Dense layer with flax `nn.Dense(dtype=...)` semantics.

Parameters stay fp32; input, weight and bias are cast to the compute dtype
at use, so a bf16 model runs its GEMMs in bf16 with fp32 accumulation, as
the JAX package's `nn.Dense(dtype=bf16)` does.  The weight is (out, in),
torch's layout; `models/import_jax.py` transposes flax's (in, out) kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype
        nn.init.normal_(self.weight, std=in_features ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)
