"""Convolution ops (counterpart of lcasr_tpu/ops/conv.py): batch renorm,
the conformer conv module, conv subsampling and frame-stacking subsampling.

The running statistics of BatchRenorm are buffers.  In training it
normalises with masked batch statistics, corrected by the r/d factors of
the clip schedules on `num_batches_tracked`, and moves the running
statistics by momentum 0.01.  Under activation checkpointing the
backward re-runs the forward: there (inside `recomputing()`) the module
uses the running statistics its first pass saw and updates nothing, so
the statistics advance once per micro step, as JAX's functional
`mutable=["batch_stats"]` does.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.mlp import ConformerFeedForward
from lcasr_torch.ops.norms import LayerNorm
from lcasr_torch.ops.subsampling import ACTS, dw_striding_chain

_STATE = threading.local()


@contextlib.contextmanager
def recomputing():
    """Marks the backward's re-run of a checkpointed forward."""
    _STATE.recomputing = True
    try:
        yield
    finally:
        _STATE.recomputing = False


def is_recomputing() -> bool:
    return getattr(_STATE, "recomputing", False)


class BatchRenorm(nn.Module):
    """Batch renormalisation (arXiv:1702.03275) over (B, T, C).  Eval:
    (x - running_mean) / running_std, no eps, then affine.  Train: see the
    module docstring; `pad_mask` (True = padded) keeps frames out of the
    batch statistics."""

    def __init__(self, num_features: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_std", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self._first_pass = None  # running stats the last training forward used

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        xf = x.float()
        if not train:
            y = (xf - self.running_mean) / self.running_std
            return (self.weight * y + self.bias).to(x.dtype)
        if pad_mask is not None:
            w = (~pad_mask).to(xf.dtype)[..., None]  # (B, T, 1)
            count = w.sum((0, 1)).clamp_min(1.0)
            mean = (xf * w).sum((0, 1)) / count
            var = ((xf - mean) ** 2 * w).sum((0, 1)) / count
        else:
            count = float(xf.shape[0] * xf.shape[1])
            mean = xf.sum((0, 1)) / count
            var = ((xf - mean) ** 2).sum((0, 1)) / count
        std = torch.sqrt(var) + self.eps

        if is_recomputing():
            ra_mean, ra_std, steps = self._first_pass
        else:
            ra_mean, ra_std = self.running_mean.clone(), self.running_std.clone()
            steps = self.num_batches_tracked.clone()
            self._first_pass = (ra_mean, ra_std, steps)
        t = steps.float()
        rmax = (2.0 / 35000.0 * t + 25.0 / 35.0).clamp(1.0, 3.0)
        dmax = (5.0 / 20000.0 * t - 25.0 / 20.0).clamp(0.0, 5.0)
        r = torch.minimum(torch.maximum(std.detach() / ra_std, 1.0 / rmax), rmax)
        d = torch.minimum(torch.maximum((mean.detach() - ra_mean) / ra_std, -dmax), dmax)
        y = (xf - mean) / std * r + d
        if not is_recomputing():
            with torch.no_grad():
                self.running_mean.add_(self.momentum * (mean.detach() - ra_mean))
                self.running_std.add_(self.momentum * (std.detach() - ra_std))
                self.num_batches_tracked.add_(1)
        return (self.weight * y + self.bias).to(x.dtype)


def depthwise_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise 1-D conv with 'same' padding.  x: (B, T, C); kernel:
    (C, 1, K)."""
    K = kernel.shape[-1]
    out = F.conv1d(x.transpose(1, 2), kernel, bias, padding=(K - 1) // 2,
                   groups=kernel.shape[0])
    return out.transpose(1, 2)


class ConformerConvolution(nn.Module):
    """pointwise (2x) -> GLU -> zero padded frames -> depthwise (K) ->
    BatchRenorm -> SiLU -> pointwise, on (B, T, D)."""

    def __init__(self, d_model: int, kernel_size: int = 9,
                 norm_type: str = "batch_renorm", exp_factor: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if (kernel_size - 1) % 2:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        if norm_type != "batch_renorm":
            raise NotImplementedError(
                f"conv_norm_type={norm_type!r} is not ported yet (batch_renorm is)"
            )
        inner = int(d_model * exp_factor)
        self.dtype = dtype
        self.pointwise_conv1 = Dense(d_model, inner * 2, dtype=dtype)
        self.depthwise_kernel = nn.Parameter(
            torch.randn(inner, 1, kernel_size) * kernel_size ** -0.5
        )
        self.depthwise_bias = nn.Parameter(torch.zeros(inner))
        self.norm = BatchRenorm(inner)
        self.pointwise_conv2 = Dense(inner, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        x = self.pointwise_conv1(x)
        a, b = x.chunk(2, dim=-1)
        x = a * torch.sigmoid(b)  # GLU, a = first half
        if pad_mask is not None:
            x = x.masked_fill(pad_mask[..., None], 0.0)
        x = depthwise_conv1d(x, self.depthwise_kernel.to(x.dtype),
                             self.depthwise_bias.to(x.dtype))
        stat_mask = _stat_mask(pad_mask) if train and pad_mask is not None else None
        x = F.silu(self.norm(x, pad_mask=stat_mask, train=train))
        return self.pointwise_conv2(x)


def _stat_mask(pad_mask: torch.Tensor) -> torch.Tensor:
    """Frames kept out of the training batch statistics (True = out), the
    JAX module's rule for static batches (lcasr_tpu/ops/conv.py:283-319):
    rows of length 0 (finished samples) count for nothing, and live rows
    count every frame up to the longest live row's length, padding
    included, as the reference's shrinking dynamic batches do."""
    row_len = (~pad_mask).sum(1).float()  # (B,)
    live = row_len > 0
    u_len = torch.where(live, row_len, torch.zeros_like(row_len)).max()
    cols = torch.arange(pad_mask.shape[1], device=pad_mask.device, dtype=torch.float32)
    keep = live[:, None] & (cols[None, :] < u_len)
    return ~keep


def calc_length(lengths: torch.Tensor, all_paddings: int, kernel_size: int,
                stride: int, ceil_mode: bool, repeat_num: int = 1) -> torch.Tensor:
    """Output length through repeated strided convs, in fp32 like the JAX
    function."""
    add_pad = float(all_paddings - kernel_size)
    lengths = lengths.to(torch.float32)
    for _ in range(repeat_num):
        lengths = (lengths + add_pad) / stride + 1.0
        lengths = torch.ceil(lengths) if ceil_mode else torch.floor(lengths)
    return lengths.to(torch.int32)


class ConvSubsampling(nn.Module):
    """(B, T, feat_in) -> (B, T/factor, feat_out), mode dw_striding,
    non-causal.  The conv output (B, C, T', F') is permuted to
    (B, T', F', C) before flattening, so F'·C has C minor as in the JAX
    package's NHWC layout and the `out` weights line up."""

    def __init__(self, subsampling_factor: int = 8, feat_in: int = 80,
                 feat_out: int = 768, conv_channels: int = 256,
                 activation: str = "silu", norm_out: bool = False,
                 subsampling: str = "dw_striding", is_causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if subsampling != "dw_striding" or is_causal:
            raise NotImplementedError(
                f"subsampling={subsampling!r} causal={is_causal} is not ported "
                f"yet (non-causal dw_striding is)"
            )
        if activation not in ACTS:
            raise ValueError(f"unknown subsampling activation {activation!r}")
        self.sampling_num = int(math.log2(subsampling_factor))
        self.activation = activation
        self.dtype = dtype
        C = conv_channels
        self.conv_in = nn.Conv2d(1, C, 3)
        nn.init.uniform_(self.conv_in.weight, -1 / 3, 1 / 3)
        nn.init.uniform_(self.conv_in.bias, -1 / 3, 1 / 3)
        for i in range(self.sampling_num - 1):
            dw = nn.Conv2d(C, C, 3, groups=C)
            pw = nn.Conv2d(C, C, 1)
            for p in (dw.weight, dw.bias):
                nn.init.uniform_(p, -1 / 3, 1 / 3)
            for p in (pw.weight, pw.bias):
                nn.init.uniform_(p, -C ** -0.5, C ** -0.5)
            self.add_module(f"dw_conv_{i}", dw)
            self.add_module(f"pw_conv_{i}", pw)
        f = float(feat_in)
        for _ in range(self.sampling_num):
            f = math.floor((f - 3 + 2) / 2 + 1)
        self.out = Dense(int(f) * C, feat_out, bias=norm_out, dtype=dtype)
        self.norm_out = LayerNorm(feat_out) if norm_out else None

    def _conv_params(self):
        mods = [self.conv_in]
        for i in range(self.sampling_num - 1):
            mods += [getattr(self, f"dw_conv_{i}"), getattr(self, f"pw_conv_{i}")]
        return [t.to(self.dtype) for m in mods for t in (m.weight, m.bias)]

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        new_lengths = calc_length(lengths, all_paddings=2, kernel_size=3, stride=2,
                                  ceil_mode=False, repeat_num=self.sampling_num)
        h = x.to(self.dtype)[:, None]  # (B, 1, T, F)
        h = dw_striding_chain(h, self._conv_params(), self.activation)
        B, C, T, Fo = h.shape
        h = self.out(h.permute(0, 2, 3, 1).reshape(B, T, Fo * C))
        if self.norm_out is not None:
            h = self.norm_out(h)
        return h, new_lengths


class StackingSubsampling(nn.Module):
    """Frame-stacking subsampling: pad T to a multiple of the factor, an
    optional LayerNorm over the features, stack `factor` consecutive frames,
    then an MLP (4 x feat_out hidden, no biases) to feat_out.  `norm` and
    `norm_out` are independent, as in the JAX module."""

    def __init__(self, subsampling_factor: int, feat_in: int, feat_out: int,
                 norm: bool = True, norm_out: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.subsampling_factor = subsampling_factor
        self.pre_norm = LayerNorm(feat_in) if norm else None
        self.proj_out = ConformerFeedForward(feat_in * subsampling_factor, feat_out * 4,
                                             feat_out, dtype=dtype)
        self.norm_out = LayerNorm(feat_out) if norm_out else None

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, h = x.shape
        sf = self.subsampling_factor
        pad = (sf - t % sf) % sf
        x = F.pad(x, (0, 0, 0, pad))
        if self.pre_norm is not None:
            x = self.pre_norm(x)
        x = self.proj_out(x.reshape(b, (t + pad) // sf, h * sf))
        lengths = torch.clamp((lengths + pad) // sf, min=1).to(torch.int32)
        if self.norm_out is not None:
            x = self.norm_out(x)
        return x, lengths
