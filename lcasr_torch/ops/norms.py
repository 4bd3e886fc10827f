"""Normalisation layers (counterpart of lcasr_tpu/ops/norms.py).

Statistics are fp32 whatever the input dtype; the output is cast back to
the input's dtype.  Each forward is the span `norm` (utils/profiling.py).

On CUDA tensors both norms run the hand-written row-norm kernels,
`lcasr_torch/csrc/norms.cu` (`_RowNorm`): one read and one write of each
row, fp32 statistics in registers, and a backward kernel whose parameter
gradients are summed in a fixed order (no atomics).  `norm_launch` picks
their launch shape from the shape alone.  CPU tensors take the plain
versions (`layer_norm_ref`, `rms_norm_ref`), which compute the same
function in eager fp32 ops; there is no fallback from one to the other.
The JAX package leaves its norms to XLA, which fuses them: no Pallas body.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from lcasr_torch import kernels
from lcasr_torch.utils.profiling import span

_SRC = "norms.cu"
CARD_SMS = 132  # the H100's SMs: the persistent grid fills them
WARP_THREADS = 128  # four warps a block, a row each (csrc/norms.cu kWarpThreads)
MAX_WARP_D = 1024  # 32 elements a lane
MAX_BLOCK_THREADS = 512
MAX_D = 16384  # 32 elements a thread of a 512-thread block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class NormLaunch(NamedTuple):
    """A launch of the row-norm kernels: `elems` values a thread in
    registers, rows one to a warp (blocks of 128 threads) or one to a block
    (`block_rows`: `threads` up to 512), and a persistent `grid`."""

    elems: int
    block_rows: bool
    threads: int
    grid: int


def warp_blocks_per_sm(elems: int, elem_bytes: int, backward: bool) -> int:
    """Blocks of four warps an SM: what the register file holds at the
    registers a thread needs (the cached scale and bias, and backward the
    column sums, two rows of packs, ~40 more), as `__launch_bounds__` holds
    the kernels to (csrc/norms.cu `warp_min_blocks`)."""
    regs = -(-((3 if backward else 2) * elems + 2 * elems * elem_bytes // 4 + 40) // 8) * 8
    return max(1, min(16, 65536 // (WARP_THREADS * regs)))


def norm_launch(rows: int, D: int, dtype: torch.dtype, backward: bool = False) -> NormLaunch:
    """The kernels' launch shape for a (rows, D) norm of `dtype`.  D <= 1024:
    a warp a row, the fewest elements a lane (8, 16, 24 or 32) that hold the
    row, and as many blocks as the card holds at once (no more than a block
    per four rows).  1024 < D <= 16384: a block a row, the fewest elements a
    thread (8, 16 or 32) with at most 512 threads, and 2,048 threads an SM
    (no more than a block per row).  Rows must be whole 16-byte packs."""
    if dtype not in _DTYPES:
        raise ValueError(f"row-norm kernels: {dtype} is not fp32, bf16 or fp16")
    elem_bytes = torch.finfo(dtype).bits // 8
    vec = 16 // elem_bytes  # values a 16-byte pack
    if not 0 < D <= MAX_D or D % vec:
        raise ValueError(f"row-norm kernels: D = {D} is not a multiple of {vec} up to {MAX_D}")
    if D <= MAX_WARP_D:
        elems = next(e for e in (8, 16, 24, 32) if 32 * e >= D)
        per_sm = warp_blocks_per_sm(elems, elem_bytes, backward)
        return NormLaunch(elems, False, WARP_THREADS,
                          max(1, min(-(-rows // 4), CARD_SMS * per_sm)))
    elems = next(e for e in (8, 16, 32) if MAX_BLOCK_THREADS * e >= D)
    threads = 32 * -(-D // (32 * elems))
    return NormLaunch(elems, True, threads, max(1, min(rows, CARD_SMS * (2048 // threads))))


def _check_rows(x: torch.Tensor, what: str) -> None:
    """The kernels load and store rows in 16-byte packs, on the card."""
    if x.device.type != "cuda" or x.data_ptr() % 16:
        raise ValueError(f"{what}: a {x.dtype} tensor on {x.device} at address "
                         f"{x.data_ptr():#x} is not a 16-byte aligned CUDA tensor")


def row_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], eps: float,
                 stats: bool):
    """(y, mean, rstd) of the LayerNorm (a bias) or RMSNorm (bias None) of x
    over its last dimension, CUDA only: y in x's dtype; mean (LayerNorm) and
    rstd (rows,) fp32 where `stats`, else None.  scale and bias fp32."""
    x = x.contiguous()
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    launch = norm_launch(rows, D, x.dtype)
    rms = bias is None
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    mean = torch.empty((rows,), **f32) if stats and not rms else None
    rstd = torch.empty((rows,), **f32) if stats else None
    if rows:
        _check_rows(x, "row_norm_fwd")
        lib = kernels.library(_SRC)
        with torch.cuda.device(x.device):
            err = lib.lcasr_row_norm_fwd(
                x.data_ptr(), scale.data_ptr(), None if rms else bias.data_ptr(), y.data_ptr(),
                None if mean is None else mean.data_ptr(),
                None if rstd is None else rstd.data_ptr(), rows, D, eps, int(rms),
                _DTYPES[x.dtype], launch.elems, int(launch.block_rows), launch.threads,
                launch.grid, torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(lib, err, "row_norm_fwd")
        kernels.launch_counts["rms_norm_fwd" if rms else "layer_norm_fwd"] += 1
    return y, mean, rstd


def row_norm_bwd(x: torch.Tensor, dy: torch.Tensor, mean: Optional[torch.Tensor],
                 rstd: torch.Tensor, scale: torch.Tensor):
    """(dx, dscale, dbias) of the norm `row_norm_fwd` computed, CUDA only,
    from its input x, the output's gradient dy and the saved statistics
    (mean None: RMSNorm, and dbias None).  dx in x's dtype; dscale and dbias
    (D,) fp32, summed over the rows in a fixed order."""
    dy = dy.contiguous()
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    launch = norm_launch(rows, D, x.dtype, backward=True)
    rms = mean is None
    dx = torch.empty_like(x)
    alloc = torch.empty if rows else torch.zeros  # the column sums write every column
    dscale = alloc((D,), dtype=torch.float32, device=x.device)
    dbias = None if rms else alloc((D,), dtype=torch.float32, device=x.device)
    if rows:
        _check_rows(x, "row_norm_bwd")
        _check_rows(dy, "row_norm_bwd")
        part = torch.empty((1 if rms else 2, launch.grid, D), dtype=torch.float32,
                           device=x.device)
        lib = kernels.library(_SRC)
        with torch.cuda.device(x.device):
            err = lib.lcasr_row_norm_bwd(
                x.data_ptr(), dy.data_ptr(), None if rms else mean.data_ptr(), rstd.data_ptr(),
                scale.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                None if rms else dbias.data_ptr(), part.data_ptr(), rows, D, int(rms),
                _DTYPES[x.dtype], launch.elems, int(launch.block_rows), launch.threads,
                launch.grid, torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(lib, err, "row_norm_bwd")
        kernels.launch_counts["rms_norm_bwd" if rms else "layer_norm_bwd"] += 1
    return dx, dscale, dbias


class _RowNorm(torch.autograd.Function):
    """LayerNorm (bias given) or RMSNorm (bias None) of x on the card, with
    the statistics saved for the backward kernel."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x = x.contiguous()
        y, mean, rstd = row_norm_fwd(x, scale, bias, eps, stats=True)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = row_norm_bwd(x, dy, mean, rstd, scale)
        return dx, dscale, dbias, None


def _row_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              eps: float) -> torch.Tensor:
    """The kernels on a CUDA tensor: through `_RowNorm` where a gradient is
    wanted (the forward then saves its statistics), else the forward alone."""
    scale = scale.float()
    bias = None if bias is None else bias.float()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, bias)):
        return _RowNorm.apply(x, scale, bias, eps)
    return row_norm_fwd(x, scale, bias, eps, stats=False)[0]


def layer_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """The plain LayerNorm: eager fp32 ops, the output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale + bias).to(x.dtype)


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain RMSNorm: eager fp32 ops, the output in x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(ms + eps))
    return (y * scale).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm"):
            if x.is_cuda:
                return _row_norm(x, self.scale, self.bias, self.eps)
            return layer_norm_ref(x, self.scale, self.bias, self.eps)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale, eps 1e-6 (apex FusedRMSNorm)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm"):
            if x.is_cuda:
                return _row_norm(x, self.scale, None, self.eps)
            return rms_norm_ref(x, self.scale, self.eps)


def get_norm(name: str):
    if name == "rms_norm":
        return RMSNorm
    if name == "layer_norm":
        return LayerNorm
    raise ValueError(f"default_norm must be rms_norm or layer_norm (got {name})")
