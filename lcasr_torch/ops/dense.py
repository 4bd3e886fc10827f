"""Dense layer with flax `nn.Dense(dtype=...)` semantics.

Parameters stay fp32; input, weight and bias are cast to the compute dtype
at use, so a bf16 model runs its GEMMs in bf16 with fp32 accumulation, as
the JAX package's `nn.Dense(dtype=bf16)` does.  The weight is (out, in),
torch's layout; `models/import_jax.py` transposes flax's (in, out) kernel.

Under tensor parallelism (`parallel/tensor_parallel.py` sets `tp` to a
(mode, model axis) pair and cuts the weight) the layer holds one rank's
shard: "col" ("col_heads": the qkv cut by heads) keeps a slice of the outputs (the input enters with
`copy_to`, whose backward all-reduces), "col_gather" also gathers the
outputs back whole, "row" takes a slice of the inputs and all-reduces the
partial products (`reduce_from`) before the bias is added once,
"row_split" first cuts that slice from a whole input.

`site` names the GEMM family the layer belongs to (ops/qdense.py's
ALL_SITES; None: never quantised); with `quant` set (by
`qdense.apply_quant_policy`) the product runs W8A8 through int8.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lcasr_torch.ops.qdense import w8a8_linear
from lcasr_torch.parallel.collectives import copy_to, gather_from, reduce_from


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, site: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype
        self.tp = None  # (mode, collectives.Axis) under tensor parallelism
        self.site, self.quant = site, False
        nn.init.normal_(self.weight, std=in_features ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = self.bias.to(dt) if self.bias is not None else None
        x, w = x.to(dt), self.weight.to(dt)
        if self.quant:
            if self.tp is not None:
                raise NotImplementedError("W8A8 under tensor parallelism is not supported")
            return w8a8_linear(x, w, b)
        if self.tp is None:
            return F.linear(x, w, b)
        mode, axis = self.tp
        x = x if mode == "row" else copy_to(x, axis.group)
        if mode in ("col", "col_heads"):
            return F.linear(x, w, b)
        if mode == "col_gather":
            return gather_from(F.linear(x, w, b), axis, dim=-1)
        if mode == "row_split":
            x = x.narrow(-1, axis.index * w.shape[1], w.shape[1])
        y = reduce_from(F.linear(x, w), axis.group)
        return y + b if b is not None else y
