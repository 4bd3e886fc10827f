"""Bidirectional-Mamba CTC model (counterpart of lcasr_tpu/models/mamba.py).

  subsampling (8x dw_striding, or frame stacking) -> n x MambaBlock -> CTC
  decoder, with self-conditioning after every block but the last.  The
  decoder always norms (RMSNorm), and the final norm is applied twice: once
  by `decoder.apply_norm` and once inside the decoder call, as in the JAX
  model; every self-conditioning step goes through the decoder's norm too.

Mixer: in_proj -> (x, z); x splits into a forward and a reverse half; the
reverse half is flipped within each sequence's length; each half gets its own
depthwise causal conv and SiLU; both halves share one selective scan, stacked
along the batch; the reverse half is flipped back, the halves are joined,
y_out, gate by SiLU(z), out_proj.

Parameters are fp32; `dtype` is the compute dtype, applied at use.  Module and
parameter names follow the flax tree one to one (`layers_3/mixer/in_proj/kernel`
is `layers.3.mixer.in_proj.weight`), and the mixer's raw parameters
(`conv1d_fwd_kernel` (K, C), `dt_proj_kernel` (dt_rank, C), `A_log` (C, N), ...)
keep the flax layout, so `models/import_jax.py` carries them over as they
are.  The selective scan runs the CUDA kernels on the GPU and their plain
versions on the CPU (`ops/ssm.py`), forward and backward.

`forward(..., train=True)` trains; the model has no dropout and no running
statistics, so `train` only switches on `checkpoint_every_n_layers` (blocks
recomputed in the backward, `torch.utils.checkpoint`, non-reentrant), which
changes memory and time and not one value.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lcasr_torch.device import resolve_device
from lcasr_torch.models.decoder import ASRLinearSCDecoder
from lcasr_torch.ops.conv import ConvSubsampling, StackingSubsampling
from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.norms import RMSNorm
from lcasr_torch.ops.qdense import TRAIN_REFUSAL, apply_quant_policy
from lcasr_torch.ops.ssm import causal_conv1d, flip_with_lengths, selective_scan
from lcasr_torch.utils.profiling import span


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


class BiMambaMixer(nn.Module):
    """x (B, L, d_model), lengths (B,) or None -> (B, L, d_model)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: Optional[int] = None, dt_min: float = 0.001, dt_max: float = 0.1,
                 dt_init_floor: float = 1e-4, conv_bias: bool = True, n_layer: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        d_inner = expand * d_model
        half = d_inner // 2
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.d_state = d_state

        def dense(n_in, n_out, bound):  # torch Linear's default, no bias
            layer = Dense(n_in, n_out, bias=False, dtype=dtype, site="proj")
            with torch.no_grad():
                layer.weight.copy_(_uniform((n_out, n_in), bound, gen))
            return layer

        self.in_proj = dense(d_model, d_inner * 2, d_model ** -0.5)
        cb = d_conv ** -0.5  # depthwise conv: fan_in = d_conv
        for name in ("conv1d_fwd", "conv1d_rvse"):
            self.register_parameter(f"{name}_kernel",
                                    nn.Parameter(_uniform((d_conv, half), cb, gen)))
            self.register_parameter(
                f"{name}_bias", nn.Parameter(_uniform((half,), cb, gen)) if conv_bias else None)
        self.x_proj = dense(half, self.dt_rank + d_state * 2, half ** -0.5)
        # dt projection: a raw fp32 matmul whose bias starts at the inverse
        # softplus of a log-uniform step in [dt_min, dt_max]
        self.dt_proj_kernel = nn.Parameter(_uniform((self.dt_rank, half), self.dt_rank ** -0.5, gen))
        u = torch.rand((half,), generator=gen)
        dt0 = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
        dt0 = dt0.clamp_min(dt_init_floor)
        self.dt_proj_bias = nn.Parameter(dt0 + torch.log(-torch.expm1(-dt0)))
        # S4D-real A (log-parameterised) and the skip D
        self.A_log = nn.Parameter(torch.log(
            torch.arange(1, d_state + 1, dtype=torch.float32).expand(half, d_state)).clone())
        self.D = nn.Parameter(torch.ones(half))
        self.y_out = dense(d_inner, d_inner, d_inner ** -0.5)
        # the GPT-2 residual scheme: out_proj scaled by 1 / sqrt(n_layer)
        self.out_proj = dense(d_inner, d_model, d_inner ** -0.5 / math.sqrt(n_layer))

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        x_fwd, x_rvse = xs.chunk(2, dim=-1)
        x_rvse = flip_with_lengths(x_rvse, lengths)

        def conv(h, name):
            kernel = getattr(self, f"{name}_kernel").to(h.dtype)
            return F.silu(causal_conv1d(h, kernel, getattr(self, f"{name}_bias")))

        # both directions stacked along the batch for one shared scan
        x_all = torch.cat([conv(x_fwd, "conv1d_fwd"), conv(x_rvse, "conv1d_rvse")], dim=0)
        x_dbl = self.x_proj(x_all)
        dt, Bssm, Cssm = x_dbl.split([self.dt_rank, self.d_state, self.d_state], dim=-1)
        delta = F.softplus(dt.float() @ self.dt_proj_kernel + self.dt_proj_bias)
        A = -torch.exp(self.A_log)

        y_fwd, y_rvse = selective_scan(x_all, delta, A, Bssm, Cssm, self.D).chunk(2, dim=0)
        y_rvse = flip_with_lengths(y_rvse, lengths)
        y = self.y_out(torch.cat([y_fwd, y_rvse], dim=-1))
        return self.out_proj(y * F.silu(z))


class MambaBlock(nn.Module):
    """Pre-norm residual block: x + mixer(RMSNorm(x))."""

    def __init__(self, d_model: int, n_layer: int = 1, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = RMSNorm(d_model)
        self.mixer = BiMambaMixer(d_model, n_layer=n_layer, dtype=dtype, generator=generator)

    def forward(self, x, lengths=None):
        with span("mixer"):
            return self.mixer(self.norm(x), lengths=lengths) + x


class Mamba(nn.Module):
    """forward(audio (B, feat_in, T), length (B,) or None) ->
    {'final_posteriors': (B, T', vocab+1) fp32 log-probs, 'length': (B,)}.

    `device=None` means the GPU and raises without one.  `init_seed` seeds
    the generator the initial parameters of the mixers are drawn from."""

    NOT_PORTED: dict = {}  # every option of the JAX model is taken

    def __init__(
        self,
        vocab_size: int = 128,
        feat_in: int = 80,
        subsampling: str = "dw_striding",
        subsampling_factor: int = 8,
        subsampling_conv_channels: int = 256,
        subsampling_act: str = "silu",
        subsampling_norm_out: bool = False,
        self_conditioning: bool = True,
        n_layers: int = 6,
        d_model: int = 768,
        checkpoint_every_n_layers: int = 0,
        quant_w8a8=False,  # False | True | "auto" | site names (ops/qdense.py)
        dtype: torch.dtype = torch.float32,
        init_seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.n_layers = n_layers
        self.subsampling_factor = subsampling_factor
        self.subsampling_mode = subsampling
        self.self_conditioning = self_conditioning
        self.checkpoint_every_n_layers = checkpoint_every_n_layers
        gen = torch.Generator().manual_seed(init_seed)

        if subsampling == "stacking":
            self.subsampling = StackingSubsampling(
                subsampling_factor=subsampling_factor, feat_in=feat_in, feat_out=d_model,
                norm=not subsampling_norm_out, norm_out=subsampling_norm_out, dtype=dtype)
        else:
            self.subsampling = ConvSubsampling(
                subsampling_factor=subsampling_factor, feat_in=feat_in, feat_out=d_model,
                conv_channels=(subsampling_conv_channels if subsampling_conv_channels != -1
                               else d_model),
                activation=subsampling_act, norm_out=subsampling_norm_out,
                subsampling=subsampling, dtype=dtype)
        self.layers = nn.ModuleList(
            MambaBlock(d_model, n_layer=n_layers, dtype=dtype, generator=gen)
            for _ in range(n_layers))
        # the Mamba decoder always norms
        self.decoder = ASRLinearSCDecoder(d_model, vocab_size, norm=True,
                                          norm_type="rms_norm", dtype=dtype,
                                          reproject=self_conditioning and n_layers > 1)
        apply_quant_policy(self, quant_w8a8)
        self.to(device)
        self.eval()

    def forward(self, audio_signal: torch.Tensor, length: Optional[torch.Tensor] = None,
                train: bool = False, return_logits: bool = False):
        if train and self.quant_sites:
            raise ValueError(TRAIN_REFUSAL)
        x = audio_signal.transpose(1, 2).to(self.dtype)  # (B, T, feat)
        have_lengths = length is not None
        if not have_lengths:
            length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        x, length = self.subsampling(x, length.to(x.device))
        # no length from the caller: the reverse half flips the whole axis
        lengths_arg = length if have_lengths else None

        dec = self.decoder
        n = self.checkpoint_every_n_layers
        for i, layer in enumerate(self.layers):
            if train and n > 0 and i % n == 0:
                x = checkpoint(layer, x, lengths_arg, use_reentrant=False)
            else:
                x = layer(x, lengths_arg)
            if i != self.n_layers - 1 and self.self_conditioning:
                with span("self_cond"):
                    posts = torch.softmax(dec(x, logits=True).float(), dim=-1).to(x.dtype)
                    x = x + dec.project_back(posts)
        with span("head"):
            x = dec.apply_norm(x)
            return {"final_posteriors": dec(x, logits=return_logits), "length": length}
