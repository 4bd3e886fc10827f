"""SCConformerXL: self-conditioned CTC conformer (counterpart of
lcasr_tpu/models/sconformer_xl.py).

  subsampling (conv, 8x dw_striding by default, or frame stacking) ->
  [learnable Fourier positions] -> n x ConformerLayer -> CTC decoder, with
  self-conditioning after every layer but the last and the legacy double
  norm before the output projection.

Layer order, all pre-norm residual: x += 1/2 FF1; x += MHSA; x += Conv;
x += 1/2 FF2; x = norm_out(x).

Parameters are fp32; `dtype` is the compute dtype (bf16 on the decode
path), applied at use.  Module and parameter names follow the flax tree one
to one (`layers_3/attend/qkv_proj/kernel` is `layers.3.attend.qkv_proj.weight`),
and the qkv projection keeps the JAX package's (3, H, D) output packing, so
`models/import_jax.py` maps a flax checkpoint onto this module directly.
Attention runs the flash-attention kernels on the GPU and their plain
versions on the CPU (`ops/flash_attention.py`), forward and backward.

`forward(..., train=True)` trains: BatchRenorm uses batch statistics and
moves its running ones, dropout is drawn from an explicit generator
(`dropout_seed`; one seed per layer call, so a checkpointed layer's
recompute draws the same masks), and `checkpoint_every_n_layers` /
`remat_subsampling` recompute layers / the subsampling in the backward
(`torch.utils.checkpoint`, non-reentrant; the JAX model's `nn.remat` with
policy "nothing").

Context parallelism (`seq_axis_name`, with a mesh from
`parallel.context_parallel_apply`): the audio's time axis is sharded over
the `seq` axis; the subsampling and the conformer convs take their padding
from the neighbouring shards, rotary tables, Fourier positions and masks
run at global positions, and the attention either gathers K / V
(`attention_cp_impl="gather"`) or rotates them around a ring ("ring").
`stat_axes` names the axes over which batch-norm statistics are summed.
Tensor parallelism (`parallel.tensor_parallel.parallelize`) splits each
attention by heads and each feed-forward by its hidden units.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from lcasr_torch.device import resolve_device
from lcasr_torch.models.decoder import ASRLinearSCDecoder
from lcasr_torch.ops.attention import length_mask
from lcasr_torch.models.positional import LearnableFourierPosEnc
from lcasr_torch.ops.conv import (
    ConformerConvolution, ConvSubsampling, StackingSubsampling, recomputing)
from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.flash_attention import flash_attention
from lcasr_torch.ops.mlp import ConformerFeedForward
from lcasr_torch.ops.norms import get_norm
from lcasr_torch.ops.rotary import RotaryEmbedding, apply_rotary
from lcasr_torch.parallel.context_parallel import context_parallel_attention
from lcasr_torch.parallel.mesh import NO_PARALLEL, ParallelState, bind
from lcasr_torch.parallel.ring_attention import ring_attention

# lcasr-9L-768D-6H, rotary theta 1.5e6 (~120M params): the repo's flagship
FLAGSHIP = dict(
    vocab_size=4095,
    d_model=768,
    n_layers=9,
    n_heads=6,
    head_dim=128,
    subsampling_conv_channels=256,
    expansion_factor=4,
    use_rotary=True,
    rotary_base_freq=1.5e6,
)

# Options of the JAX model that this slice does not port: name -> (the
# default, which is accepted, and what the option belongs to)
_NOT_PORTED = {
    "use_pallas": (True, "a TPU switch; the port always runs its own kernel"),
    "conv_type": ("standard", "longconv"),
    "longconv_weight_init": ("random", "longconv"),
    "longconv_position_kernel": (True, "longconv"),
    "longconv_ma_smoothing": (False, "longconv"),
    "longconv_ma_window_len": (7, "longconv"),
    "longconv_smooth_freq": (False, "longconv"),
    "return_attention_weights": (False, "attention capture (analysis)"),
    "capture_qkv": (False, "attention capture (analysis)"),
    "quant_w8a8": (False, "W8A8 quantisation"),
}


class Dropout:
    """Dropout masks from a generator seeded once per layer call (None:
    no dropout), so that a checkpointed layer's recompute draws the same
    masks.  Kept values are scaled by 1 / (1 - rate), as flax does."""

    def __init__(self, seed: Optional[int], device):
        self.gen = None if seed is None else torch.Generator(device=device).manual_seed(seed)

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0 or self.gen is None:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


NO_DROPOUT = Dropout(None, None)


def _remat_contexts():
    """checkpoint's (forward, recompute) contexts: BatchRenorm must know it
    is being recomputed (ops/conv.py)."""
    return contextlib.nullcontext(), recomputing()


# remat_policy "dots" (the JAX model's jax.checkpoint_policies.dots_saveable):
# the outputs of matrix products are saved, everything else is recomputed.
# A kernel launched through ctypes is no aten op, so the attention (K1) is
# recomputed, as JAX recomputes its Pallas call, which is no dot_general.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
            torch.ops.aten.linear.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _together(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _remat_contexts_dots():
    """`_remat_contexts` under the selective-checkpoint policy that saves
    the matrix products' outputs."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    forward, recompute = create_selective_checkpoint_contexts(_save_dots)
    return forward, _together(recompute, recomputing())


class Attention(nn.Module):
    """Fused-qkv multi-head attention with rotary and an optional band.
    Padded positions are zeroed before the qkv projection and on the
    attention output."""

    def __init__(self, n_feats: int, head_dim: int, n_heads: int,
                 window: Tuple[int, int] = (-1, -1), bias: bool = False,
                 qkv_bias: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # n_heads is this rank's share under tensor parallelism
        self.n_heads, self.head_dim, self.window = n_heads, head_dim, window
        self.dropout = dropout
        self.qkv_proj = Dense(n_feats, 3 * n_heads * head_dim, bias=qkv_bias, dtype=dtype)
        self.out_proj = Dense(n_heads * head_dim, n_feats, bias=bias, dtype=dtype)
        self.parallel = NO_PARALLEL

    def forward(self, x, lengths=None, rotary=None, drop: Dropout = NO_DROPOUT):
        B, N, _ = x.shape
        H, D = self.n_heads, self.head_dim
        seq = self.parallel.seq()
        q_off = seq.index * N if seq is not None else 0
        mask = length_mask(lengths, N, offset=q_off)[..., None] if lengths is not None else None
        if mask is not None:
            x = x.masked_fill(~mask, 0.0)
        qkv = self.qkv_proj(x).view(B, N, 3, H, D)
        q, k, v = qkv.unbind(2)
        if rotary is not None:
            # under context parallelism the tables are at the shard's
            # global positions, for q and the still-local k alike
            q, k = apply_rotary(q, k, *rotary)
        if seq is None:
            out = flash_attention(q, k, v, lengths=lengths, window=self.window)
        elif self.parallel.cp_impl == "ring":
            out = ring_attention(q, k, v, seq, lengths=lengths, window=self.window)
        else:
            out = context_parallel_attention(q, k, v, seq, lengths=lengths, window=self.window)
        out = out.reshape(B, N, H * D)
        if mask is not None:
            out = out.masked_fill(~mask, 0.0)
        # on the projected output, not on the probabilities, as in the JAX
        # model (every paper config trains at dropout_attn 0.0)
        return drop(self.out_proj(out), self.dropout)


class ConformerLayer(nn.Module):
    """1/2 FF1 -> MHSA -> Conv -> 1/2 FF2 -> norm_out, pre-norm residual."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 conv_kernel_size: int = 9, conv_expansion_factor: float = 1.0,
                 conv_norm: str = "batch_renorm", default_norm: str = "layer_norm",
                 sandwich_norm: bool = False, bias_in_ff: bool = False,
                 transformer: bool = False, window: Tuple[int, int] = (-1, -1),
                 dropout_ff: float = 0.0, dropout_conv: float = 0.0,
                 dropout_attn: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        Norm = get_norm(default_norm)
        self.sandwich_norm, self.transformer = sandwich_norm, transformer
        self.dropout_ff, self.dropout_conv = dropout_ff, dropout_conv

        def ff():  # hidden is always 4 x d_model, as in the JAX model
            return ConformerFeedForward(d_model, d_model * 4, bias1=bias_in_ff,
                                        bias2=bias_in_ff, dtype=dtype)

        if not transformer:
            self.ff1_norm, self.ff1 = Norm(d_model), ff()
            if sandwich_norm:
                self.ff1_norm_out = Norm(d_model)
        self.attn_norm = Norm(d_model)
        self.attend = Attention(d_model, head_dim, n_heads, window=window,
                                dropout=dropout_attn, dtype=dtype)
        if sandwich_norm:
            self.attn_norm_out = Norm(d_model)
        if not transformer:
            self.conv_norm = Norm(d_model)
            self.conv = ConformerConvolution(d_model, conv_kernel_size, conv_norm,
                                             conv_expansion_factor, dtype=dtype)
        self.ff2_norm, self.ff2 = Norm(d_model), ff()
        if sandwich_norm:
            self.ff2_norm_out = Norm(d_model)
        self.norm_out = Norm(d_model)

    def forward(self, x, lengths=None, pad_mask=None, rotary=None, train: bool = False,
                dropout_seed: Optional[int] = None):
        drop = Dropout(dropout_seed, x.device) if train else NO_DROPOUT
        if not self.transformer:
            h = self.ff1(self.ff1_norm(x))
            if self.sandwich_norm:
                h = self.ff1_norm_out(h)
            x = drop(h, self.dropout_ff) * 0.5 + x
        h = self.attend(self.attn_norm(x), lengths=lengths, rotary=rotary, drop=drop)
        h = drop(h, min(self.dropout_ff, 0.1))
        if self.sandwich_norm:
            h = self.attn_norm_out(h)
        x = h + x
        if not self.transformer:
            h = self.conv(self.conv_norm(x), pad_mask=pad_mask, train=train)
            x = drop(h, self.dropout_conv) + x
        h = self.ff2(self.ff2_norm(x))
        if self.sandwich_norm:
            h = self.ff2_norm_out(h)
        x = drop(h, self.dropout_ff) * 0.5 + x
        return self.norm_out(x)


class SCConformerXL(nn.Module):
    """forward(audio (B, feat_in, T), length (B,) or None) ->
    {'final_posteriors': (B, T', vocab+1) fp32 log-probs, 'length': (B,)}.

    `device=None` means the GPU and raises without one."""

    NOT_PORTED = _NOT_PORTED

    def __init__(
        self,
        vocab_size: int = 128,
        feat_in: int = 80,
        subsampling: str = "dw_striding",
        subsampling_factor: int = 8,
        subsampling_conv_channels: int = 256,
        subsampling_act: str = "silu",
        subsampling_norm_out: bool = False,
        n_layers: int = 6,
        d_model: int = 768,
        n_heads: int = 6,
        head_dim: int = 128,
        expansion_factor: int = 4,  # never reaches the FF, as in the JAX model
        dropout_ff: float = 0.0,  # dropout only acts in training
        dropout_conv: float = 0.0,
        dropout_attn: float = 0.0,
        checkpoint_every_n_layers: int = 0,
        remat_policy: str = "nothing",
        remat_subsampling: bool = False,
        conv_kernel_size: int = 9,
        conv_expansion_factor: float = 1.0,
        conv_norm: str = "batch_renorm",
        decoder_norm: bool = False,
        use_rotary: bool = False,
        fourier_pos_enc: bool = False,
        rotary_base_freq: float = 10000.0,
        rotary_interpolation_factor: float = 1.0,
        learned_rotary: bool = False,
        self_conditioning: bool = True,
        default_norm: str = "layer_norm",
        sandwich_norm: bool = False,
        bias_in_ff: bool = False,
        transformer: bool = False,
        legasee_double_norm: bool = True,
        attention_window_size: int = -1,
        attention_window_size_left: Optional[int] = None,
        attention_window_size_right: Optional[int] = None,
        seq_axis_name: Optional[str] = None,
        attention_cp_impl: str = "gather",
        stat_axes: Tuple[str, ...] = (),
        dtype: torch.dtype = torch.float32,
        dropout_seed: int = 0,
        device=None,
        **not_ported,
    ):
        super().__init__()
        if remat_policy not in ("nothing", "dots"):
            raise ValueError(f"remat_policy must be nothing|dots, got {remat_policy}")
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"SCConformerXL got an unexpected argument {name!r}")
            default, what = _NOT_PORTED[name]
            if value != default:
                raise NotImplementedError(f"{name}={value!r}: {what} is not ported yet")
        device = resolve_device(device)
        self.dtype = dtype
        self.n_layers = n_layers
        self.subsampling_factor = subsampling_factor
        self.subsampling_mode = subsampling
        self.self_conditioning = self_conditioning
        self.legasee_double_norm = legasee_double_norm
        self.use_rotary = use_rotary
        self.use_fourier = fourier_pos_enc
        self.checkpoint_every_n_layers = checkpoint_every_n_layers
        self.remat_contexts = _remat_contexts_dots if remat_policy == "dots" else _remat_contexts
        self.remat_subsampling = remat_subsampling
        self.dropout_rates = (dropout_ff, dropout_conv, dropout_attn)
        self.dropout_generator = torch.Generator().manual_seed(dropout_seed)
        left = (attention_window_size_left if attention_window_size_left is not None
                else attention_window_size)
        right = (attention_window_size_right if attention_window_size_right is not None
                 else attention_window_size)
        self.window = (left, right)

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
                subsampling=subsampling, dtype=dtype,
            )
        if use_rotary:
            self.rotary_pos_emb = RotaryEmbedding(
                head_dim, base=rotary_base_freq, learned_freq=learned_rotary,
                interpolation_factor=rotary_interpolation_factor,
            )
        if fourier_pos_enc:
            self.fourier_pos_enc = LearnableFourierPosEnc(d_model, dtype=dtype)
        self.layers = nn.ModuleList(
            ConformerLayer(
                d_model, n_heads, head_dim, conv_kernel_size=conv_kernel_size,
                conv_expansion_factor=conv_expansion_factor, conv_norm=conv_norm,
                default_norm=default_norm, sandwich_norm=sandwich_norm,
                bias_in_ff=bias_in_ff, transformer=transformer, window=self.window,
                dropout_ff=dropout_ff, dropout_conv=dropout_conv,
                dropout_attn=dropout_attn, dtype=dtype,
            )
            for _ in range(n_layers)
        )
        self.decoder = ASRLinearSCDecoder(d_model, vocab_size, norm=decoder_norm,
                                          norm_type=default_norm, dtype=dtype,
                                          reproject=self_conditioning and n_layers > 1)
        self.parallel = ParallelState(seq_axis=seq_axis_name, cp_impl=attention_cp_impl,
                                      stat_axes=tuple(stat_axes))
        bind(self, self.parallel)
        self.to(device)
        self.eval()

    def forward(self, audio_signal: torch.Tensor, length: Optional[torch.Tensor] = None,
                train: bool = False, return_logits: bool = False):
        x = audio_signal.transpose(1, 2).to(self.dtype)  # (B, T, feat)
        B = x.shape[0]
        # context parallel: x is this rank's time shard; lengths are global
        seq = self.parallel.seq()
        if seq is not None and self.subsampling_mode == "stacking":
            # StackingSubsampling pads the local shard to a factor multiple:
            # zeros in the middle of the global sequence
            raise NotImplementedError("context parallel: stacking subsampling unsupported "
                                      "(use dw_striding/striding)")
        have_lengths = length is not None
        if not have_lengths:
            t_global = x.shape[1] * (seq.size if seq is not None else 1)
            length = torch.full((B,), t_global, dtype=torch.int32, device=x.device)
        length = length.to(x.device)
        if train and self.remat_subsampling:
            x, length = checkpoint(self.subsampling, x, length, use_reentrant=False)
        else:
            x, length = self.subsampling(x, length)
        N = x.shape[1]
        off = seq.index * N if seq is not None else 0  # the shard's first global frame
        lengths_arg = length if have_lengths else None
        pad_mask = ~length_mask(length, N, offset=off) if have_lengths else None
        rotary = (self.rotary_pos_emb(N, dtype=torch.float32, offset=off) if self.use_rotary
                  else None)
        if self.use_fourier:
            x = self.fourier_pos_enc(
                x, offsets=torch.full((B,), off, device=x.device) if seq is not None else None)

        dec = self.decoder
        draw = train and max(self.dropout_rates) > 0.0
        for i, layer in enumerate(self.layers):
            seed = (int(torch.randint(2 ** 62, (1,), generator=self.dropout_generator))
                    if draw else None)
            n = self.checkpoint_every_n_layers
            if train and n > 0 and i % n == 0:
                x = checkpoint(layer, x, lengths_arg, pad_mask, rotary, train, seed,
                               use_reentrant=False, context_fn=self.remat_contexts)
            else:
                x = layer(x, lengths_arg, pad_mask, rotary, train, seed)
            if i != self.n_layers - 1 and self.self_conditioning:
                posts = torch.softmax(dec(x, logits=True).float(), dim=-1).to(x.dtype)
                x = x + dec.project_back(posts)
        if self.legasee_double_norm:
            x = dec.apply_norm(x)
        return {"final_posteriors": dec(x, logits=return_logits), "length": length}


@torch.no_grad()
def init_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and float buffer from a numpy seed: weights
    N(0, 1/fan_in), biases N(0, 0.02^2), norm scales 1 + N(0, 0.1^2),
    BatchRenorm running means N(0, 0.1^2) and running stds U(0.5, 1.5);
    rotary frequencies and cosine-attention temperatures keep their values.
    For runs with random weights that are the same across frameworks."""
    rng = np.random.default_rng(seed)
    tensors = list(model.named_parameters()) + [
        (n, b) for n, b in model.named_buffers() if b.is_floating_point()
    ]
    for name, t in tensors:
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if leaf == "running_std":
            arr = rng.uniform(0.5, 1.5, shape)
        elif leaf == "running_mean":
            arr = rng.normal(0.0, 0.1, shape)
        elif leaf in ("scale",) or (leaf == "weight" and t.dim() == 1):
            arr = 1.0 + rng.normal(0.0, 0.1, shape)
        elif leaf in ("bias", "depthwise_bias"):
            arr = rng.normal(0.0, 0.02, shape)
        elif leaf in ("inv_freq", "temperature"):
            continue
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            arr = rng.normal(0.0, fan_in ** -0.5, shape)
        t.copy_(torch.from_numpy(arr.astype(np.float32)))
    return model
