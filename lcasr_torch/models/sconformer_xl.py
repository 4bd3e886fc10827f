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

The JAX model's other options: `capture_qkv` / `return_attention_weights`
(the analysis captures, returned under "intermediates"; see `Attention`),
`quant_w8a8` (W8A8 projections by site, ops/qdense.py; inference only) and
`conv_type="longconv"` with its `longconv_*` options (ops/long_conv.py).
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
from lcasr_torch.ops.attention import length_mask, reference_attention
from lcasr_torch.models.positional import LearnableFourierPosEnc
from lcasr_torch.ops.conv import (
    ConformerConvolution, ConvSubsampling, StackingSubsampling, recomputing)
from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.flash_attention import flash_attention
from lcasr_torch.ops.long_conv import ConformerLongConvolution
from lcasr_torch.ops.mlp import ConformerFeedForward
from lcasr_torch.ops.norms import get_norm
from lcasr_torch.ops.qdense import TRAIN_REFUSAL, apply_quant_policy
from lcasr_torch.ops.rotary import RotaryEmbedding, apply_rotary
from lcasr_torch.parallel.collectives import all_gather_seq
from lcasr_torch.parallel.context_parallel import context_parallel_attention
from lcasr_torch.parallel.mesh import NO_PARALLEL, ParallelState, bind
from lcasr_torch.parallel.ring_attention import ring_attention
from lcasr_torch.utils.profiling import span

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

# Options of the JAX model that the port does not take: name -> (the
# default, which is accepted, and why)
_NOT_PORTED = {
    "use_pallas": (True, "a TPU switch; the port always runs its own kernel"),
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
    attention output.

    Analysis (the JAX module's `sow`s into `intermediates`): with
    `capture_qkv` set, the post-rotary (q, k, v, lengths) go into the
    `capture` dict the caller passes, under "attention_qkv", while the
    attention still runs the kernel; with `return_attention_weights` set,
    the attention runs the exact plain version instead and its fp32
    probabilities (B, H, T, T) go under "attention_probs"."""

    def __init__(self, n_feats: int, head_dim: int, n_heads: int,
                 window: Tuple[int, int] = (-1, -1), bias: bool = False,
                 qkv_bias: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # n_heads is this rank's share under tensor parallelism
        self.n_heads, self.head_dim, self.window = n_heads, head_dim, window
        self.dropout = dropout
        self.qkv_proj = Dense(n_feats, 3 * n_heads * head_dim, bias=qkv_bias, dtype=dtype,
                              site="qkv")
        self.out_proj = Dense(n_heads * head_dim, n_feats, bias=bias, dtype=dtype,
                              site="attn_out")
        self.capture_qkv = self.return_attention_weights = False
        self.parallel = NO_PARALLEL

    def forward(self, x, lengths=None, rotary=None, drop: Dropout = NO_DROPOUT,
                capture: Optional[dict] = None):
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
        if self.capture_qkv and capture is not None:
            capture["attention_qkv"] = (q, k, v, lengths)
        if self.return_attention_weights:
            if seq is not None and self.parallel.cp_impl == "ring":
                # ring attention never forms the scores
                raise NotImplementedError(
                    "return_attention_weights is unavailable under ring context "
                    "parallelism (use attention_cp_impl='gather')")
            if seq is not None:
                k, v = all_gather_seq(k, seq, dim=1), all_gather_seq(v, seq, dim=1)
            out, probs = reference_attention(q, k, v, q_lengths=lengths, kv_lengths=lengths,
                                             window=self.window, q_offset=q_off,
                                             return_weights=True)
            if capture is not None:
                capture["attention_probs"] = probs
        elif seq is None:
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
    """1/2 FF1 -> MHSA -> Conv -> 1/2 FF2 -> norm_out, pre-norm residual.
    `conv_type` "longconv" puts the safari long convolution
    (ops/long_conv.py) in the conv slot, with the `longconv_*` options."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 conv_kernel_size: int = 9, conv_expansion_factor: float = 1.0,
                 conv_norm: str = "batch_renorm", default_norm: str = "layer_norm",
                 sandwich_norm: bool = False, bias_in_ff: bool = False,
                 transformer: bool = False, window: Tuple[int, int] = (-1, -1),
                 dropout_ff: float = 0.0, dropout_conv: float = 0.0,
                 dropout_attn: float = 0.0, conv_type: str = "standard",
                 longconv_weight_init: str = "random", longconv_position_kernel: bool = True,
                 longconv_ma_smoothing: bool = False, longconv_ma_window_len: int = 7,
                 longconv_smooth_freq: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if conv_type not in ("standard", "longconv"):
            raise ValueError(f"conv_type must be standard|longconv, got {conv_type!r}")
        Norm = get_norm(default_norm)
        self.sandwich_norm, self.transformer = sandwich_norm, transformer
        self.dropout_ff, self.dropout_conv = dropout_ff, dropout_conv
        self.conv_type = conv_type

        def ff():  # hidden is always 4 x d_model, as in the JAX model
            return ConformerFeedForward(d_model, d_model * 4, bias1=bias_in_ff,
                                        bias2=bias_in_ff, dtype=dtype, site="ff")

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
            if conv_type == "longconv":
                self.conv = ConformerLongConvolution(
                    d_model, norm_type=conv_norm, exp_factor=conv_expansion_factor,
                    weight_init=longconv_weight_init,
                    position_kernel=longconv_position_kernel,
                    use_ma_smoothing=longconv_ma_smoothing,
                    ma_window_len=longconv_ma_window_len, smooth_freq=longconv_smooth_freq)
            else:
                self.conv = ConformerConvolution(d_model, conv_kernel_size, conv_norm,
                                                 conv_expansion_factor, dtype=dtype)
        self.ff2_norm, self.ff2 = Norm(d_model), ff()
        if sandwich_norm:
            self.ff2_norm_out = Norm(d_model)
        self.norm_out = Norm(d_model)
        self.parallel = NO_PARALLEL

    def forward(self, x, lengths=None, pad_mask=None, rotary=None, train: bool = False,
                dropout_seed: Optional[int] = None, capture: Optional[dict] = None):
        if self.conv_type == "longconv" and self.parallel.seq() is not None:
            raise NotImplementedError(
                "context parallel needs position-local convs (conv_type=standard)")
        drop = Dropout(dropout_seed, x.device) if train else NO_DROPOUT
        if not self.transformer:
            with span("ff"):
                h = self.ff1(self.ff1_norm(x))
                if self.sandwich_norm:
                    h = self.ff1_norm_out(h)
                x = drop(h, self.dropout_ff) * 0.5 + x
        with span("attention"):
            h = self.attend(self.attn_norm(x), lengths=lengths, rotary=rotary, drop=drop,
                            capture=capture)
            h = drop(h, min(self.dropout_ff, 0.1))
            if self.sandwich_norm:
                h = self.attn_norm_out(h)
            x = h + x
        if not self.transformer:
            with span("conv"):
                h = self.conv(self.conv_norm(x), pad_mask=pad_mask, train=train)
                x = drop(h, self.dropout_conv) + x
        with span("ff"):
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
        conv_type: str = "standard",
        longconv_weight_init: str = "random",
        longconv_position_kernel: bool = True,
        longconv_ma_smoothing: bool = False,
        longconv_ma_window_len: int = 7,
        longconv_smooth_freq: bool = False,
        return_attention_weights: bool = False,
        capture_qkv: bool = False,
        quant_w8a8=False,  # False | True | "auto" | site names (ops/qdense.py)
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
                dropout_attn=dropout_attn, conv_type=conv_type,
                longconv_weight_init=longconv_weight_init,
                longconv_position_kernel=longconv_position_kernel,
                longconv_ma_smoothing=longconv_ma_smoothing,
                longconv_ma_window_len=longconv_ma_window_len,
                longconv_smooth_freq=longconv_smooth_freq, dtype=dtype,
            )
            for _ in range(n_layers)
        )
        self.decoder = ASRLinearSCDecoder(d_model, vocab_size, norm=decoder_norm,
                                          norm_type=default_norm, dtype=dtype,
                                          reproject=self_conditioning and n_layers > 1)
        self.parallel = ParallelState(seq_axis=seq_axis_name, cp_impl=attention_cp_impl,
                                      stat_axes=tuple(stat_axes))
        bind(self, self.parallel)
        self.capture_qkv = capture_qkv
        self.return_attention_weights = return_attention_weights
        apply_quant_policy(self, quant_w8a8)
        self.to(device)
        self.eval()

    # the analysis switches live on every Attention; the model's are views
    @property
    def capture_qkv(self) -> bool:
        return self.layers[0].attend.capture_qkv if len(self.layers) else False

    @capture_qkv.setter
    def capture_qkv(self, on: bool) -> None:
        for layer in self.layers:
            layer.attend.capture_qkv = bool(on)

    @property
    def return_attention_weights(self) -> bool:
        return self.layers[0].attend.return_attention_weights if len(self.layers) else False

    @return_attention_weights.setter
    def return_attention_weights(self, on: bool) -> None:
        for layer in self.layers:
            layer.attend.return_attention_weights = bool(on)

    @property
    def rotary_interpolation_factor(self) -> float:
        return self.rotary_pos_emb.interpolation_factor if self.use_rotary else 1.0

    @rotary_interpolation_factor.setter
    def rotary_interpolation_factor(self, factor: float) -> None:
        if self.use_rotary:
            self.rotary_pos_emb.interpolation_factor = float(factor)

    def forward(self, audio_signal: torch.Tensor, length: Optional[torch.Tensor] = None,
                train: bool = False, return_logits: bool = False):
        """With `capture_qkv` or `return_attention_weights` set, the result
        also holds "intermediates": one dict a layer with its
        "attention_qkv" (post-rotary q, k, v and the lengths) and / or
        "attention_probs" (B, H, T', T'), the JAX model's sown values."""
        if train and self.quant_sites:
            raise ValueError(TRAIN_REFUSAL)
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
        captures = ([{} for _ in self.layers]
                    if self.capture_qkv or self.return_attention_weights else None)
        for i, layer in enumerate(self.layers):
            capture = captures[i] if captures is not None else None
            seed = (int(torch.randint(2 ** 62, (1,), generator=self.dropout_generator))
                    if draw else None)
            n = self.checkpoint_every_n_layers
            if train and n > 0 and i % n == 0:
                x = checkpoint(layer, x, lengths_arg, pad_mask, rotary, train, seed, capture,
                               use_reentrant=False, context_fn=self.remat_contexts)
            else:
                x = layer(x, lengths_arg, pad_mask, rotary, train, seed, capture)
            if i != self.n_layers - 1 and self.self_conditioning:
                with span("self_cond"):
                    posts = torch.softmax(dec(x, logits=True).float(), dim=-1).to(x.dtype)
                    x = x + dec.project_back(posts)
        with span("head"):
            if self.legasee_double_norm:
                x = dec.apply_norm(x)
            out = {"final_posteriors": dec(x, logits=return_logits), "length": length}
        if captures is not None:
            out["intermediates"] = captures
        return out


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
        elif leaf in ("inv_freq", "temperature", "base_rates"):
            continue
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            arr = rng.normal(0.0, fan_in ** -0.5, shape)
        t.copy_(torch.from_numpy(arr.astype(np.float32)))
    return model
