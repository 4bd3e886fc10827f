"""Convolution ops (counterpart of lcasr_tpu/ops/conv.py): batch renorm and
batch norm, the conformer conv module with each of its norms, conv
subsampling in its three modes (causal or not) and frame-stacking
subsampling.

The running statistics of BatchRenorm are buffers.  In training it
normalises with masked batch statistics, corrected by the r/d factors of
the clip schedules on `num_batches_tracked`, and moves the running
statistics by momentum 0.01.  Under activation checkpointing the
backward re-runs the forward: there (inside `recomputing()`) the module
uses the running statistics its first pass saw and updates nothing, so
the statistics advance once per micro step, as JAX's functional
`mutable=["batch_stats"]` does.

Under a mesh (`lcasr_torch/parallel/`) the modules read the model's
`ParallelState`: batch statistics (count, sum, squared deviation) are
all-reduced over its `stat_axes`, as JAX psums them inside shard_map and
pjit computes them over the global batch, so every rank's running
statistics are those of one device; with a `seq` axis (context
parallelism) the depthwise conv and the stride-2 subsampling stages take
their time padding from the neighbouring shards (`halo_exchange`) and the
keep-mask runs at global columns.
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
from lcasr_torch.ops.subsampling import (
    ACTS, dw_striding_chain, fused_dw_striding, fused_eligible, fused_subsampling_enabled,
    strided_conv)
from lcasr_torch.parallel.collectives import all_reduce_, all_reduce_sum, halo_exchange
from lcasr_torch.parallel.mesh import NO_PARALLEL

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
        self.parallel = NO_PARALLEL

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        xf = x.float()
        if not train:
            y = (xf - self.running_mean) / self.running_std
            return (self.weight * y + self.bias).to(x.dtype)
        mean, var, _ = _masked_moments(xf, pad_mask, self.parallel.stat_groups())
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


def _masked_moments(xf: torch.Tensor, pad_mask: Optional[torch.Tensor], groups=()):
    """(mean, biased variance, frame count) over (B, T), padded frames out;
    each sum all-reduced over the process groups of `groups` ((name, group)
    pairs), as the JAX module's `_psum` over its stat_axes."""

    def psum(val):
        for _, g in groups:
            val = all_reduce_sum(val, g)
        return val

    if pad_mask is not None:
        w = (~pad_mask).to(xf.dtype)[..., None]  # (B, T, 1)
        count = psum(w.sum((0, 1))).clamp_min(1.0)
        mean = psum((xf * w).sum((0, 1))) / count
        var = psum(((xf - mean) ** 2 * w).sum((0, 1))) / count
    else:
        count = float(xf.shape[0] * xf.shape[1])
        if groups:
            count = psum(torch.tensor(count, dtype=xf.dtype, device=xf.device))
        mean = psum(xf.sum((0, 1))) / count
        var = psum(((xf - mean) ** 2).sum((0, 1))) / count
    return mean, var, count


class BatchNorm(nn.Module):
    """Plain batch norm over (B, T, C).  Eval: the running statistics.
    Train: masked batch statistics; the running mean moves by momentum 0.1
    and the running variance takes the unbiased batch variance, as torch's
    BatchNorm1d does.  A checkpointed recompute updates nothing."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.parallel = NO_PARALLEL

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, var, n = _masked_moments(xf, pad_mask, self.parallel.stat_groups())
            if not is_recomputing():
                with torch.no_grad():
                    n = torch.as_tensor(n, dtype=xf.dtype, device=xf.device)
                    unbias = n / (n - 1.0).clamp_min(1.0)
                    self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(self.momentum * var * unbias)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (self.weight * y + self.bias).to(x.dtype)


class GroupNorm(nn.Module):
    """Group norm over (B, T, C): 32 groups, statistics over a group's
    channels and all frames of a sample (padded ones included, as in the
    JAX module), eps 1e-5."""

    def __init__(self, num_features: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().transpose(1, 2), self.num_groups, self.scale, self.bias,
                         self.eps)
        return y.transpose(1, 2).to(x.dtype)


CONV_NORMS = ("batch_renorm", "batch_norm", "layer_norm", "group_norm", "none")


def depthwise_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, seq=None) -> torch.Tensor:
    """Depthwise 1-D conv with 'same' padding.  x: (B, T, C); kernel:
    (C, 1, K).  With `seq` (the `collectives.Axis` of a time-sharded x) the
    padding is a (K - 1) / 2-frame halo from the neighbouring shards and the
    conv runs 'valid': each shard's output is its slice of the global conv."""
    K = kernel.shape[-1]
    pad = (K - 1) // 2
    if seq is not None and pad > 0:
        x = halo_exchange(x, seq, left=pad, right=pad, dim=1)
        pad = 0
    out = F.conv1d(x.transpose(1, 2), kernel, bias, padding=pad, groups=kernel.shape[0])
    return out.transpose(1, 2)


class ConformerConvolution(nn.Module):
    """pointwise (2x) -> GLU -> zero padded frames -> depthwise (K) ->
    norm -> SiLU -> pointwise, on (B, T, D).  `norm_type`: batch_renorm (the
    default), batch_norm, layer_norm, group_norm or none."""

    def __init__(self, d_model: int, kernel_size: int = 9,
                 norm_type: str = "batch_renorm", exp_factor: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if (kernel_size - 1) % 2:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        if norm_type not in CONV_NORMS:
            raise ValueError(f"conv_norm_type={norm_type} is not valid")
        inner = int(d_model * exp_factor)
        self.dtype = dtype
        self.norm_type = norm_type
        self.pointwise_conv1 = Dense(d_model, inner * 2, dtype=dtype)
        self.depthwise_kernel = nn.Parameter(
            torch.randn(inner, 1, kernel_size) * kernel_size ** -0.5
        )
        self.depthwise_bias = nn.Parameter(torch.zeros(inner))
        if norm_type != "none":
            self.norm = {"batch_renorm": BatchRenorm, "batch_norm": BatchNorm,
                         "layer_norm": LayerNorm, "group_norm": GroupNorm}[norm_type](inner)
        self.pointwise_conv2 = Dense(inner, d_model, dtype=dtype)
        self.parallel = NO_PARALLEL

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        seq = self.parallel.seq()
        if seq is not None and self.norm_type == "group_norm":
            # its statistics run over every frame of a sample, which the
            # time shards split
            raise NotImplementedError("context parallel: conv_norm group_norm is unsupported")
        x = self.pointwise_conv1(x)
        a, b = x.chunk(2, dim=-1)
        x = a * torch.sigmoid(b)  # GLU, a = first half
        if pad_mask is not None:
            x = x.masked_fill(pad_mask[..., None], 0.0)
        x = depthwise_conv1d(x, self.depthwise_kernel.to(x.dtype),
                             self.depthwise_bias.to(x.dtype), seq=seq)
        if self.norm_type in ("batch_renorm", "batch_norm"):
            stat_mask = (_stat_mask(pad_mask, self.parallel) if train and pad_mask is not None
                         else None)
            x = self.norm(x, pad_mask=stat_mask, train=train)
        elif self.norm_type != "none":
            x = self.norm(x)
        return self.pointwise_conv2(F.silu(x))


def _stat_mask(pad_mask: torch.Tensor, parallel=NO_PARALLEL) -> torch.Tensor:
    """Frames kept out of the training batch statistics (True = out), the
    JAX module's rule for static batches (lcasr_tpu/ops/conv.py:283-319):
    rows of length 0 (finished samples) count for nothing, and live rows
    count every frame up to the longest live row's length, padding
    included, as the reference's shrinking dynamic batches do.  Under a
    mesh the rows' lengths are summed over the time shards, the columns
    are global, and the longest live row is the longest over the other
    statistics axes (the rows of the other data shards)."""
    T_loc = pad_mask.shape[1]
    row_len = (~pad_mask).sum(1).float()  # (B,)
    col0 = 0
    seq = parallel.seq()
    if seq is not None:
        row_len = all_reduce_(row_len, seq.group)
        col0 = seq.index * T_loc
    live = row_len > 0
    u_len = torch.where(live, row_len, torch.zeros_like(row_len)).max()
    for name, group in parallel.stat_groups():
        if name != parallel.seq_axis:
            u_len = all_reduce_(u_len, group, op=torch.distributed.ReduceOp.MAX)
    cols = col0 + torch.arange(T_loc, device=pad_mask.device, dtype=torch.float32)
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
    """(B, T, feat_in) -> (B, T/factor, feat_out).

    Modes: `dw_striding` (one full 3x3 stride-2 conv to C channels, then per
    remaining stage a 3x3 stride-2 depthwise and a 1x1 pointwise conv),
    `striding` (full 3x3 stride-2 convs) and `vggnet` (per stage two 3x3
    convs and a 2x2 max pool in ceil mode), the activation after every conv
    stage.  `is_causal` pads the strided convs (2, 1) on both axes instead
    of (1, 1).  The conv output (B, C, T', F') is permuted to (B, T', F', C)
    before flattening, so F'·C has C minor as in the JAX package's NHWC
    layout and the `out` weights line up.

    With LCASR_FUSED_SUB=1 the 8x non-causal dw_striding chain runs as one
    fused kernel on shapes it takes (T and feat_in multiples of 8, C a
    multiple of 128): see `ops/subsampling.py`.  A CUDA tensor then launches
    the kernel or raises; there is no quiet return to the conv chain."""

    def __init__(self, subsampling_factor: int = 8, feat_in: int = 80,
                 feat_out: int = 768, conv_channels: int = 256,
                 activation: str = "silu", norm_out: bool = False,
                 subsampling: str = "dw_striding", is_causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if subsampling not in ("dw_striding", "striding", "vggnet"):
            raise ValueError(f"Not valid sub-sampling: {subsampling}!")
        if activation not in ACTS:
            raise ValueError(f"unknown subsampling activation {activation!r}")
        self.sampling_num = int(math.log2(subsampling_factor))
        self.activation = activation
        self.mode, self.is_causal = subsampling, is_causal
        self.feat_in, self.conv_channels = feat_in, conv_channels
        self.dtype = dtype
        C = conv_channels

        def conv(name, cin, bound, **kw):
            m = nn.Conv2d(cin, C, **kw)
            if bound is not None:
                for p in (m.weight, m.bias):
                    nn.init.uniform_(p, -bound, bound)
            else:  # flax's defaults: lecun-normal kernel, zero bias
                nn.init.normal_(m.weight, std=(cin * 9) ** -0.5)
                nn.init.zeros_(m.bias)
            self.add_module(name, m)

        if subsampling == "dw_striding":
            conv("conv_in", 1, 1 / 3, kernel_size=3)
            for i in range(self.sampling_num - 1):
                conv(f"dw_conv_{i}", C, 1 / 3, kernel_size=3, groups=C)
                conv(f"pw_conv_{i}", C, C ** -0.5, kernel_size=1)
        elif subsampling == "striding":
            # torch's default bound 1/sqrt(fan_in): 1/3 for stage 0 (fan_in
            # 9), 1/sqrt(9 C) for the C-channel stages
            for i in range(self.sampling_num):
                conv(f"conv_{i}", 1 if i == 0 else C, 1 / 3 if i == 0 else (9 * C) ** -0.5,
                     kernel_size=3)
        else:
            for i in range(self.sampling_num):
                conv(f"vgg_conv_{i}_0", 1 if i == 0 else C, None, kernel_size=3)
                conv(f"vgg_conv_{i}_1", C, None, kernel_size=3)
        f = float(feat_in)
        for _ in range(self.sampling_num):
            if subsampling == "vggnet":
                f = math.ceil((f - 2) / 2 + 1)
            else:
                f = math.floor((f - 3 + (3 if is_causal else 2)) / 2 + 1)
        self.out = Dense(int(f) * C, feat_out, bias=norm_out, dtype=dtype)
        self.norm_out = LayerNorm(feat_out) if norm_out else None
        self.parallel = NO_PARALLEL

    def _params(self, *names):
        return [t.to(self.dtype) for n in names
                for t in (getattr(self, n).weight, getattr(self, n).bias)]

    def _conv_params(self):
        """(k0, b0, [kd, bd, kp, bp] x stages) of the dw_striding chain."""
        return self._params("conv_in", *(f"{kind}_conv_{i}" for i in range(self.sampling_num - 1)
                                         for kind in ("dw", "pw")))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.mode == "vggnet":
            new_lengths = calc_length(lengths, all_paddings=0, kernel_size=2, stride=2,
                                      ceil_mode=True, repeat_num=self.sampling_num)
        else:
            new_lengths = calc_length(lengths, all_paddings=3 if self.is_causal else 2,
                                      kernel_size=3, stride=2, ceil_mode=False,
                                      repeat_num=self.sampling_num)
        x = x.to(self.dtype)
        act = ACTS[self.activation]
        # context parallel: each stride-2 stage takes a one-frame left halo
        # from the previous time shard in place of its zero padding
        seq = self.parallel.seq()
        if seq is not None and self.mode == "vggnet":
            raise NotImplementedError("context parallel: use dw_striding/striding")
        if seq is not None and self.is_causal:
            # the causal right pad (s - 1) adds one output a stage that the
            # halo scheme does not reproduce
            raise NotImplementedError("context parallel: causal subsampling unsupported")
        if self.mode == "dw_striding":
            # never the fused kernel under context parallelism, as in JAX
            if seq is None and fused_subsampling_enabled() and fused_eligible(
                    x.shape[1], self.feat_in, self.conv_channels, self.sampling_num,
                    self.is_causal):
                h = fused_dw_striding(x, self._conv_params(), self.activation)
            else:
                h = dw_striding_chain(x[:, None], self._conv_params(), self.activation,
                                      causal=self.is_causal, seq=seq).permute(0, 2, 3, 1)
        elif self.mode == "striding":
            h = x[:, None]  # (B, 1, T, F)
            for i in range(self.sampling_num):
                h = act(strided_conv(h, *self._params(f"conv_{i}"), causal=self.is_causal,
                                     seq=seq))
            h = h.permute(0, 2, 3, 1)
        else:
            h = x[:, None]
            for i in range(self.sampling_num):
                for j in (0, 1):
                    k, b = self._params(f"vgg_conv_{i}_{j}")
                    h = act(F.conv2d(h, k, b, padding=1))
                # ceil mode pads the odd edge with -inf, as the JAX module does
                h = F.max_pool2d(h, 2, 2, ceil_mode=True)
            h = h.permute(0, 2, 3, 1)
        B, T, Fo, C = h.shape  # (B, T', F', C): C minor
        h = self.out(h.reshape(B, T, Fo * C))
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
