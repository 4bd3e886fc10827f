"""The dw_striding conv chain: plain PyTorch convolutions and the fused CUDA
kernel (counterpart of lcasr_tpu/ops/subsampling_pallas.py
`dw_striding_chain_lax`, `fused_dw_striding` and `fused_subsampling_enabled`).

`dw_striding_chain` is the default path, as in the JAX package.  Layout NCHW
with H = time and W = frequency: (B, 1, T, F) in, (B, C, T/8, F/8) out for
the 8x chain.  Full 3x3 stride-2 conv to C channels, then per remaining stage
a 3x3 stride-2 depthwise conv and a 1x1 pointwise conv, the activation after
each stage.  Padding 1 on both sides of both axes, or (2, 1) when causal.

`fused_dw_striding` computes the same 3-stage chain in one launch of the
kernel in `lcasr_torch/csrc/subsampling_fused.cu` (K8): (B, T, F) in,
(B, T/8, F/8, C) out with C minor, the layout `ConvSubsampling.out` reads.
It is opt-in (`LCASR_FUSED_SUB=1`, read at call time).  On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs `dw_striding_chain`,
the kernel's plain version.  The kernel has no backward of its own: the
gradient recomputes through `dw_striding_chain` under autograd, as the JAX
`custom_vjp` recomputes through the lax chain.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn.functional as F

from lcasr_torch import kernels

ACTS = {
    "silu": F.silu,
    "relu": F.relu,
    "gelu": lambda v: F.gelu(v, approximate="none"),
    "none": lambda v: v,
}
_ACT_CODES = {"none": 0, "silu": 1, "relu": 2, "gelu": 3}  # `Act` in the kernel
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# the kernel's limits beyond `fused_eligible` (`MAX_C`, `MAX_F` in its source):
# conv channels up to the widest d_model in configs/, and a one-frame tile's
# 3 F/4 stage-1 positions within its 128-row product
MAX_CHANNELS, MAX_FEATURES = 2048, 168
_SRC = "subsampling_fused.cu"


def strided_conv(h: torch.Tensor, k: torch.Tensor, b: torch.Tensor, causal: bool = False,
                 groups: int = 1) -> torch.Tensor:
    """3x3 stride-2 conv on NCHW, padded (1, 1) on both axes, or (2, 1)
    (left k - 1, right s - 1) when causal."""
    if causal:
        return F.conv2d(F.pad(h, (2, 1, 2, 1)), k, b, stride=2, groups=groups)
    return F.conv2d(h, k, b, stride=2, padding=1, groups=groups)


def dw_striding_chain(h: torch.Tensor, params: Sequence[torch.Tensor],
                      act: str = "silu", causal: bool = False) -> torch.Tensor:
    """params = (k0, b0, [kd, bd, kp, bp] x stages), torch OIHW kernels."""
    f = ACTS[act]
    k0, b0 = params[0], params[1]
    C = k0.shape[0]
    h = f(strided_conv(h, k0, b0, causal))
    for i in range((len(params) - 2) // 4):
        kd, bd, kp, bp = params[2 + 4 * i : 6 + 4 * i]
        h = f(F.conv2d(strided_conv(h, kd, bd, causal, groups=C), kp, bp))
    return h


def fused_subsampling_enabled() -> bool:
    """The module-level gate: opt-in with LCASR_FUSED_SUB=1."""
    return os.environ.get("LCASR_FUSED_SUB", "0") == "1"


def fused_eligible(T: int, feat_in: int, channels: int, stages: int,
                   is_causal: bool = False) -> bool:
    """The shapes the fused chain takes (the conditions of the JAX
    `ConvSubsampling`): 3 stages, non-causal, T and feat_in multiples of 8
    (no stage then reads its right zero padding), C a multiple of 128."""
    return (not is_causal and stages == 3 and T % 8 == 0 and feat_in % 8 == 0
            and channels % 128 == 0)


def _chain_channels_last(x: torch.Tensor, params: Sequence[torch.Tensor], act: str
                         ) -> torch.Tensor:
    """The plain version in the kernel's layout: (B, T, F) -> (B, T/8, F/8, C)."""
    return dw_striding_chain(x[:, None], params, act).permute(0, 2, 3, 1)


def _check_fused_inputs(x: torch.Tensor, params: Sequence[torch.Tensor], act: str) -> int:
    if act not in _ACT_CODES:
        raise ValueError(f"fused_dw_striding: unknown activation {act!r}")
    if x.dim() != 3 or len(params) != 10:
        raise ValueError("fused_dw_striding takes x (B, T, F) and the 10 tensors of a "
                         f"3-stage chain, got x {tuple(x.shape)} and {len(params)} tensors")
    B, T, Fin = x.shape
    C = params[0].shape[0]
    if not fused_eligible(T, Fin, C, 3):
        raise ValueError(f"fused_dw_striding needs T % 8 == 0, F % 8 == 0 and C % 128 == 0, "
                         f"got T {T}, F {Fin}, C {C}")
    shapes = [(C, 1, 3, 3), (C,)] + [(C, 1, 3, 3), (C,), (C, C, 1, 1), (C,)] * 2
    for i, (t, shape) in enumerate(zip(params, shapes)):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_dw_striding: parameter {i} is {tuple(t.shape)}, "
                             f"expected {shape}")
    return C


def check_kernel_takes(B: int, T: int, Fin: int, C: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel takes a chain `fused_eligible` accepts at these
    sizes and dtype: bf16 or fp32, every multiple of 128 up to MAX_CHANNELS
    conv channels, feat_in up to MAX_FEATURES, a batch within the grid.
    Needs no card (the launch calls it first)."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the fused subsampling kernel takes bf16 or fp32, not {dtype}")
    if not fused_eligible(T, Fin, C, 3):
        raise ValueError(f"fused_dw_striding needs T % 8 == 0, F % 8 == 0 and C % 128 == 0, "
                         f"got T {T}, F {Fin}, C {C}")
    if C > MAX_CHANNELS:
        raise ValueError(f"the fused subsampling kernel takes at most {MAX_CHANNELS} conv "
                         f"channels, got {C}")
    if Fin > MAX_FEATURES:
        raise ValueError(f"the fused subsampling kernel takes at most {MAX_FEATURES} input "
                         f"features, got {Fin}")
    if B > 65535:
        raise ValueError(f"fused_dw_striding: batch {B} exceeds the grid's 65535")


def _launch_fused(x: torch.Tensor, params: Sequence[torch.Tensor], act: str) -> torch.Tensor:
    C = _check_fused_inputs(x, params, act)
    B, T, Fin = x.shape
    check_kernel_takes(B, T, Fin, C, x.dtype)
    for i, t in enumerate(params):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"fused_dw_striding: parameter {i} is {t.dtype} on {t.device}, "
                            f"x is {x.dtype} on {x.device}")
    x = x.contiguous()
    x = x if x.data_ptr() % 16 == 0 else x.clone()  # 16-byte copies of its rows
    fp32 = x.dtype == torch.float32
    # weights as the module holds them (OIHW; the bf16 kernel's tensor maps
    # read the pointwise weights (C out, C in) from 16-byte aligned bases); the
    # fp32 kernel's SIMT product reads them transposed, (C in, C out)
    flat = [t.detach().contiguous() for t in params]
    flat = [t if t.data_ptr() % 16 == 0 else t.clone() for t in flat]
    for i in (4, 8):
        flat[i] = flat[i].view(C, C).t().contiguous() if fp32 else flat[i]
    out = torch.empty((B, T // 8, Fin // 8, C), dtype=x.dtype, device=x.device)
    tile = int(os.environ.get("LCASR_SUB_TILE", "0"))  # output frames per tile; 0: the largest that fits
    lib = kernels.library(_SRC)
    with torch.cuda.device(x.device):
        err = lib.lcasr_subsampling_fused(
            x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in flat),
            B, T, Fin, C, int(fp32), _ACT_CODES[act], int(tile),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(lib, err, "subsampling_fused")
    kernels.launch_counts["subsampling_fused"] += 1
    return out


class _FusedDwStriding(torch.autograd.Function):
    """Forward: K8 (the plain chain for a CPU tensor).  Backward: the
    gradients of `dw_striding_chain`, recomputed under autograd."""

    @staticmethod
    def forward(ctx, x, act, *params):
        ctx.save_for_backward(x, *params)
        ctx.act = act
        if x.device.type == "cpu":
            _check_fused_inputs(x, params, act)
            return _chain_channels_last(x, params, act).contiguous()
        return _launch_fused(x, params, act)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(needs[i] if i == 0 else needs[i + 1])
                      for i, t in enumerate([x, *params])]
            y = _chain_channels_last(leaves[0], leaves[1:], ctx.act)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        out = [next(grads) if t.requires_grad else None for t in leaves]
        return (out[0], None, *out[1:])


def fused_dw_striding(x: torch.Tensor, params: Sequence[torch.Tensor],
                      act: str = "silu") -> torch.Tensor:
    """(B, T, F) -> (B, T/8, F/8, C); differentiable in x and the parameters."""
    return _FusedDwStriding.apply(x, act, *params)
