"""The dw_striding conv chain as plain PyTorch convolutions (counterpart of
lcasr_tpu/ops/subsampling_pallas.py `dw_striding_chain_lax`, the default
path of the JAX package; its fused Pallas variant is opt-in there and is not
ported yet).

Layout NCHW with H = time and W = frequency: (B, 1, T, F) in,
(B, C, T/8, F/8) out for the 8x chain.  Full 3x3 stride-2 conv to C
channels, then per remaining stage a 3x3 stride-2 depthwise conv and a 1x1
pointwise conv, the activation after each stage.  Padding 1 on both sides
of both axes (non-causal).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

ACTS = {
    "silu": F.silu,
    "relu": F.relu,
    "gelu": lambda v: F.gelu(v, approximate="none"),
    "none": lambda v: v,
}


def dw_striding_chain(h: torch.Tensor, params: Sequence[torch.Tensor],
                      act: str = "silu") -> torch.Tensor:
    """params = (k0, b0, [kd, bd, kp, bp] x stages), torch OIHW kernels."""
    f = ACTS[act]
    k0, b0 = params[0], params[1]
    C = k0.shape[0]
    h = f(F.conv2d(h, k0, b0, stride=2, padding=1))
    for i in range((len(params) - 2) // 4):
        kd, bd, kp, bp = params[2 + 4 * i : 6 + 4 * i]
        h = F.conv2d(h, kd, bd, stride=2, padding=1, groups=C)
        h = f(F.conv2d(h, kp, bp))
    return h
