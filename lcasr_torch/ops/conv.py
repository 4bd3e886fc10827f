"""Convolution ops (counterpart of lcasr_tpu/ops/conv.py): batch renorm,
the conformer conv module and conv subsampling, in eval form.

The running statistics of BatchRenorm are buffers; training (batch
statistics, the r/d clip schedules and the keep-mask rule of the JAX
module) belongs to the training slice of the port and raises here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.norms import LayerNorm
from lcasr_torch.ops.subsampling import ACTS, dw_striding_chain

_TRAINING = "training is not ported yet (it comes with the training slice)"


class BatchRenorm(nn.Module):
    """Eval form: (x - running_mean) / running_std, no eps, then affine."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_std", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(f"BatchRenorm: {_TRAINING}")
        y = (x.float() - self.running_mean) / self.running_std
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
        if train:
            raise NotImplementedError(f"ConformerConvolution: {_TRAINING}")
        x = self.pointwise_conv1(x)
        a, b = x.chunk(2, dim=-1)
        x = a * torch.sigmoid(b)  # GLU, a = first half
        if pad_mask is not None:
            x = x.masked_fill(pad_mask[..., None], 0.0)
        x = depthwise_conv1d(x, self.depthwise_kernel.to(x.dtype),
                             self.depthwise_bias.to(x.dtype))
        x = F.silu(self.norm(x))
        return self.pointwise_conv2(x)


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
