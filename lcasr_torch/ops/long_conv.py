"""Long convolution (HazyResearch "safari", arXiv:2302.06646), the
conformer conv module under `conv_type: longconv` (counterpart of
lcasr_tpu/ops/long_conv.py).

  * the kernel is either predicted per position by a small MLP
    (`PositionKernel`, the default: features [a i, log(b i), sin(c i)] with
    learned base rates) or a direct (channels, H, l_max) parameter,
    optionally smoothed (moving average, or a Gaussian over its spectrum)
    and soft-thresholded (`squash_kernel`);
  * bidirectional: two kernel channels, the second flipped and shifted
    left by L so that it sees strictly future positions;
  * FFT length `L_kernel + L`; a longer direct kernel is cropped by the
    rfft, as torch's and JAX's rfft crop;
  * the skip `y += u D`, exact GELU, then a GLU-gated output linear.

The module computes in fp32 whatever the model's dtype and casts its output
back.  The FFTs are `torch.fft` (cuFFT on the card), as the JAX module's
are `jnp.fft`: no kernel of this repo's own.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lcasr_torch.ops.dense import Dense


def squash_kernel(kernel: torch.Tensor, lam: float) -> torch.Tensor:
    """Soft threshold: sign(k) relu(|k| - lam)."""
    return torch.sign(kernel) * F.relu(kernel.abs() - lam)


def ma_smooth_kernel(kernel: torch.Tensor, window_len: int = 7) -> torch.Tensor:
    """Moving average over the last axis: odd window, stride 1, zero padding
    counted in the denominator (AvgPool1d's count_include_pad)."""
    if window_len % 2 != 1:
        raise ValueError("window size must be odd")
    flat = kernel.reshape(-1, 1, kernel.shape[-1])
    w = torch.full((1, 1, window_len), 1.0 / window_len, dtype=kernel.dtype,
                   device=kernel.device)
    return F.conv1d(flat, w, padding=window_len // 2).reshape(kernel.shape)


def freq_smooth_kernel(kernel: torch.Tensor, window_len: int = 7) -> torch.Tensor:
    """Gaussian smoothing of the kernel's spectrum: rfft, correlate each
    complex spectrum with exp(-0.5 |i - W//2|^2) ('same' padding), irfft.
    conv1d takes no complex input, so the real and imaginary parts are
    correlated apart."""
    L = kernel.shape[-1]
    kf = torch.fft.rfft(kernel.float(), dim=-1).reshape(-1, 1, L // 2 + 1)
    idx = torch.arange(window_len, dtype=torch.float32, device=kernel.device)
    w = torch.exp(-0.5 * (idx - window_len // 2).abs() ** 2)[None, None]

    def corr(part):
        return F.conv1d(part, w, padding=window_len // 2)

    sm = torch.complex(corr(kf.real.contiguous()), corr(kf.imag.contiguous()))
    out = torch.fft.irfft(sm[:, 0], n=L, dim=-1).to(kernel.dtype)
    return out.reshape(kernel.shape)


def double_exp_init(shape, scale: float = 0.02,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(C, H, L) randn * scale under the envelope exp(-(j / L) (H//2)^(i / H))."""
    C, H, L = shape
    k = torch.randn(shape, generator=generator) * scale
    i = torch.arange(H, dtype=torch.float32)[:, None]
    j = torch.arange(L, dtype=torch.float32)[None, :]
    return k * torch.exp(-(j / L) * torch.pow(float(H // 2), i / H))[None]


def fft_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution by FFT: x (B, L, H), kernel (H, Lk <= L)
    -> (B, L, H)."""
    L = x.shape[1]
    n = 2 * L
    k_f = torch.fft.rfft(kernel.float(), n=n, dim=-1)  # (H, n // 2 + 1)
    x_f = torch.fft.rfft(x.float(), n=n, dim=1)  # (B, n // 2 + 1, H)
    y = torch.fft.irfft(x_f * k_f.t()[None], n=n, dim=1)[:, :L]
    return y.to(x.dtype)


def _normal_dense(n_in: int, n_out: int, std: float) -> Dense:
    layer = Dense(n_in, n_out, dtype=torch.float32)
    with torch.no_grad():
        layer.weight.normal_(0.0, std)
        layer.bias.normal_(0.0, std)
    return layer


class PositionKernel(nn.Module):
    """The kernel value at each position predicted from the position:
    [i a, log(i b), sin(i c)] (i from 1; a, b, c learned, from 0.01, 1, 1)
    through Linear(3, 32), ReLU, Linear(32, H C), weights and biases
    N(0, 0.002^2).  forward(L) -> (C, H, min(L, l_max))."""

    def __init__(self, H: int, l_max: int, channels: int = 1, intermediate_dim: int = 32):
        super().__init__()
        self.H, self.l_max, self.channels = H, l_max, channels
        self.base_rates = nn.Parameter(torch.tensor([0.01, 1.0, 1.0]))
        self.mlp_in = _normal_dense(3, intermediate_dim, 0.002)
        self.mlp_out = _normal_dense(intermediate_dim, H * channels, 0.002)

    def forward(self, L: int) -> torch.Tensor:
        L = min(L, self.l_max)
        b = self.base_rates
        i = torch.arange(L, dtype=torch.float32, device=b.device) + 1.0
        feats = torch.stack([i * b[0], torch.log(i * b[1]), torch.sin(i * b[2])], dim=-1)
        k = self.mlp_out(F.relu(self.mlp_in(feats)))  # (L, C H)
        return k.reshape(L, self.channels, self.H).permute(1, 2, 0)


class LongConv(nn.Module):
    """kernel -> (bidirectional combine) -> FFT conv -> + u D -> GELU ->
    Linear(H C, 2 d_model) -> GLU, on (B, L, d_model).  The direct kernel's
    options (`weight_init`, smoothing, `lam`) apply only without
    `position_kernel`."""

    def __init__(self, d_model: int, l_max: int = 8192, channels: int = 1, lam: float = 0.001,
                 bidirectional: bool = True, position_kernel: bool = True,
                 intermediate_dim: int = 32, kernel_init_scale: float = 0.002,
                 weight_init: str = "random", use_ma_smoothing: bool = False,
                 ma_window_len: int = 7, smooth_freq: bool = False):
        super().__init__()
        self.d_model, self.l_max, self.channels, self.lam = d_model, l_max, channels, lam
        self.bidirectional, self.position_kernel = bidirectional, position_kernel
        self.use_ma_smoothing, self.ma_window_len = use_ma_smoothing, ma_window_len
        self.smooth_freq, self.weight_init = smooth_freq, weight_init
        kc = channels * (2 if bidirectional else 1)
        if position_kernel:
            self.kernel = PositionKernel(d_model, l_max, kc, intermediate_dim)
        elif weight_init == "double_exp":
            self.kernel = nn.Parameter(double_exp_init((kc, d_model, l_max), 0.02))
        elif weight_init == "random":
            self.kernel = nn.Parameter(torch.randn(kc, d_model, l_max) * kernel_init_scale)
        else:
            raise NotImplementedError(f"{weight_init} is not a valid weight_init")
        self.D = nn.Parameter(torch.randn(channels, d_model))
        self.output_linear = Dense(channels * d_model, 2 * d_model, dtype=torch.float32)
        bound = (channels * d_model) ** -0.5  # torch Linear's default
        with torch.no_grad():
            self.output_linear.weight.uniform_(-bound, bound)
            self.output_linear.bias.uniform_(-bound, bound)

    def _direct_kernel(self) -> torch.Tensor:
        """The whole (kc, H, l_max) kernel, whatever the input's length: the
        rfft crops it."""
        k = self.kernel
        if self.use_ma_smoothing:
            k = (freq_smooth_kernel(k, self.ma_window_len) if self.smooth_freq
                 else ma_smooth_kernel(k, self.ma_window_len))
        return squash_kernel(k, self.lam)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, H = x.shape
        if H != self.d_model:
            raise ValueError(f"LongConv of width {self.d_model} got {H} channels")
        C = self.channels
        u = x.float()
        if pad_mask is not None:
            u = u.masked_fill(pad_mask[..., None], 0.0)
        L_kernel = min(L, self.l_max)
        k = self.kernel(L_kernel) if self.position_kernel else self._direct_kernel()
        if self.bidirectional:
            # the forward kernel padded on the right, the backward one
            # flipped and padded on the left by L: it sees offsets >= 1
            zl = k.new_zeros((C, H, L))
            k = (torch.cat([k[:C], zl], -1) + torch.cat([zl, torch.flip(k[C:], (-1,))], -1))
        n = L_kernel + L
        k_f = torch.fft.rfft(k.float(), n=n, dim=-1)  # (C, H, F); crops a longer kernel
        u_f = torch.fft.rfft(u, n=n, dim=1)  # (B, F, H)
        y = torch.fft.irfft(u_f[:, None] * k_f.transpose(1, 2)[None], n=n, dim=2)[:, :, :L]
        y = y + u[:, None] * self.D[None, :, None, :]  # (B, C, L, H)
        y = F.gelu(y.permute(0, 2, 1, 3).reshape(B, L, C * H))
        a, b = self.output_linear(y).chunk(2, dim=-1)
        return (a * torch.sigmoid(b)).to(x.dtype)


class ConformerLongConvolution(nn.Module):
    """The conformer layer's conv slot under `conv_type: longconv`: the
    safari module itself (the layer pre-norms and adds the residual around
    it).  `norm_type` and `exp_factor` are accepted for the config's sake
    and unused, as in the JAX module."""

    def __init__(self, d_model: int, l_max: int = 8192, norm_type: str = "batch_renorm",
                 exp_factor: float = 1.0, bidirectional: bool = True,
                 position_kernel: bool = True, weight_init: str = "random",
                 use_ma_smoothing: bool = False, ma_window_len: int = 7,
                 smooth_freq: bool = False):
        super().__init__()
        self.long_conv = LongConv(d_model, l_max=l_max, bidirectional=bidirectional,
                                  position_kernel=position_kernel, weight_init=weight_init,
                                  use_ma_smoothing=use_ma_smoothing,
                                  ma_window_len=ma_window_len, smooth_freq=smooth_freq)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        return self.long_conv(x, pad_mask=pad_mask)
