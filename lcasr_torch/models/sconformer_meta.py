"""SCConformerMeta: the gradient-predicting meta-learning conformer
(counterpart of lcasr_tpu/models/sconformer_meta.py).

  * a self-conditioned conformer encoder gives representations `reprs`
    and CTC posteriors (`encode`, then `decode_reprs`);
  * a meta branch, `combiner(logits, initial_signal)` -> `n_meta_layers`
    conformer layers -> a norm + linear head (`meta_predict`), predicts the
    gradient of the CTC loss with respect to `reprs`;
  * `training/meta.py` trains only the meta branch to match the true
    gradient, and `refine_at_inference` steps `reprs` along an EMA of the
    predicted gradient without labels.

The three methods are the JAX model's split apply-methods; `forward` chains
them.  Module names follow the flax tree (`meta_layers_0` is
`meta_layers.0`), so `models/import_jax.py` maps a flax checkpoint onto
this module.  Attention runs the flash-attention kernels on the GPU (K1
forward, K3 backward) and their plain versions on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from lcasr_torch.device import resolve_device
from lcasr_torch.models.decoder import ASRLinearSCDecoder
from lcasr_torch.models.positional import LearnableFourierPosEnc
from lcasr_torch.models.sconformer_xl import ConformerLayer
from lcasr_torch.ops.attention import length_mask
from lcasr_torch.ops.conv import ConvSubsampling, StackingSubsampling
from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.norms import LayerNorm
from lcasr_torch.ops.rotary import RotaryEmbedding

# the trainable branch (everything else stays frozen), as module prefixes
META_PARAM_PREFIXES = ("meta_layers.", "meta_decoder.", "combiner.")


class Combiner(nn.Module):
    """Two projected, normed streams (logits, initial signal) concatenated
    and mixed down to d_model."""

    def __init__(self, d_model: int, logit_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ff1, self.ff1_norm = Dense(logit_dim, d_model, dtype=dtype), LayerNorm(d_model)
        self.ff2, self.ff2_norm = Dense(d_model, d_model, dtype=dtype), LayerNorm(d_model)
        self.out = Dense(2 * d_model, d_model, dtype=dtype)

    def forward(self, logits: torch.Tensor, initial_signal: torch.Tensor) -> torch.Tensor:
        a = self.ff1_norm(self.ff1(logits))
        b = self.ff2_norm(self.ff2(initial_signal))
        return self.out(torch.cat([a, b], dim=-1))


class MetaDecoder(nn.Module):
    """norm -> bias-free linear meta head."""

    def __init__(self, d_model: int, classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(d_model)
        self.ff = Dense(d_model, classes, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(self.norm(x))


def ema_grad(prev: Optional[torch.Tensor], g: torch.Tensor, decay: float = 0.99):
    """EMA of the gradient, seeded with the first one."""
    return g if prev is None else decay * prev + (1.0 - decay) * g


def meta_param_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True for the meta branch's trainable parameters."""
    return {n: n.startswith(META_PARAM_PREFIXES) for n, _ in model.named_parameters()}


class SCConformerMeta(nn.Module):
    """forward(audio (B, feat_in, T), length (B,) or None) -> the standard
    {'final_posteriors', 'length'} plus 'reprs', 'initial_signal' and
    'grad_pred'.  `codebook_classes=-1` means d_model (the prediction lives
    in repr space).  As in the JAX model, any subsampling but "stacking"
    builds the default dw_striding chain.  `device=None` means the GPU and
    raises without one."""

    NOT_PORTED = {"use_pallas": (True, "a TPU switch; the port always runs its own kernel")}

    def __init__(
        self,
        vocab_size: int = 128,
        feat_in: int = 80,
        subsampling: str = "dw_striding",
        subsampling_factor: int = 8,
        subsampling_conv_channels: int = 256,
        subsampling_act: str = "silu",
        n_layers: int = 6,
        d_model: int = 768,
        n_heads: int = 6,
        head_dim: int = 128,
        expansion_factor: int = 4,  # never reaches the FF, as in the JAX model
        conv_kernel_size: int = 9,
        conv_norm: str = "batch_renorm",
        decoder_norm: bool = False,
        use_rotary: bool = False,
        rotary_base_freq: float = 10000.0,
        rotary_interpolation_factor: float = 1.0,
        self_conditioning: bool = True,
        default_norm: str = "layer_norm",
        sandwich_norm: bool = False,
        bias_in_ff: bool = False,
        transformer: bool = False,
        legasee_double_norm: bool = True,
        fourier_pos_enc: bool = False,
        window: Tuple[int, int] = (-1, -1),
        n_meta_layers: int = 1,
        codebook_classes: int = -1,
        inference_iterations: int = 10,
        inference_lr: float = 0.05,
        ema_decay: float = 0.99,
        dtype: torch.dtype = torch.float32,
        device=None,
        **not_ported,
    ):
        super().__init__()
        for name, value in not_ported.items():
            if name not in self.NOT_PORTED:
                raise TypeError(f"SCConformerMeta got an unexpected argument {name!r}")
            default, what = self.NOT_PORTED[name]
            if value != default:
                raise NotImplementedError(f"{name}={value!r}: {what}")
        device = resolve_device(device)
        self.dtype = dtype
        self.vocab_size, self.d_model, self.n_layers = vocab_size, d_model, n_layers
        self.self_conditioning = self_conditioning
        self.legasee_double_norm = legasee_double_norm
        self.use_rotary, self.use_fourier = use_rotary, fourier_pos_enc
        self.window = tuple(window)
        self.inference_iterations, self.inference_lr = inference_iterations, inference_lr
        self.ema_decay = ema_decay
        if subsampling == "stacking":
            self.subsampling = StackingSubsampling(
                subsampling_factor=subsampling_factor, feat_in=feat_in, feat_out=d_model,
                norm=True, dtype=dtype)
        else:
            self.subsampling = ConvSubsampling(
                subsampling_factor=subsampling_factor, feat_in=feat_in, feat_out=d_model,
                conv_channels=(subsampling_conv_channels if subsampling_conv_channels != -1
                               else d_model),
                activation=subsampling_act, dtype=dtype)
        if use_rotary:
            self.rotary_pos_emb = RotaryEmbedding(head_dim, base=rotary_base_freq,
                                                  interpolation_factor=rotary_interpolation_factor)
        if fourier_pos_enc:
            self.fourier_pos_enc = LearnableFourierPosEnc(d_model, dtype=dtype)

        def layer():
            return ConformerLayer(d_model, n_heads, head_dim, conv_kernel_size=conv_kernel_size,
                                  conv_norm=conv_norm, default_norm=default_norm,
                                  sandwich_norm=sandwich_norm, bias_in_ff=bias_in_ff,
                                  transformer=transformer, window=self.window, dtype=dtype)

        self.layers = nn.ModuleList(layer() for _ in range(n_layers))
        self.meta_layers = nn.ModuleList(layer() for _ in range(n_meta_layers))
        self.decoder = ASRLinearSCDecoder(d_model, vocab_size, norm=decoder_norm,
                                          norm_type=default_norm, dtype=dtype,
                                          reproject=self_conditioning and n_layers > 1)
        classes = codebook_classes if codebook_classes > 0 else d_model
        self.meta_decoder = MetaDecoder(d_model, classes, dtype=dtype)
        self.combiner = Combiner(d_model, vocab_size + 1, dtype=dtype)
        self.to(device)
        self.eval()

    def _rotary(self, N: int):
        return self.rotary_pos_emb(N, dtype=torch.float32) if self.use_rotary else None

    def encode(self, audio_signal: torch.Tensor, length: Optional[torch.Tensor] = None,
               train: bool = False) -> dict:
        """audio -> {'reprs', 'initial_signal', 'length', 'pad_mask',
        'lengths_arg'}; the initial signal is taken after the Fourier
        positions, as the JAX model takes it."""
        x = audio_signal.transpose(1, 2).to(self.dtype)
        have_lengths = length is not None
        if not have_lengths:
            length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        x, length = self.subsampling(x, length.to(x.device))
        N = x.shape[1]
        lengths_arg = length if have_lengths else None
        pad_mask = ~length_mask(length, N) if have_lengths else None
        rotary = self._rotary(N)
        if self.use_fourier:
            x = self.fourier_pos_enc(x)
        initial_signal = x
        dec = self.decoder
        for i, layer in enumerate(self.layers):
            x = layer(x, lengths_arg, pad_mask, rotary, train)
            if i != self.n_layers - 1 and self.self_conditioning:
                posts = torch.softmax(dec(x, logits=True).float(), dim=-1).to(x.dtype)
                x = x + dec.project_back(posts)
        return {"reprs": x, "initial_signal": initial_signal, "length": length,
                "pad_mask": pad_mask, "lengths_arg": lengths_arg}

    def decode_reprs(self, reprs: torch.Tensor, return_logits: bool = False) -> torch.Tensor:
        x = self.decoder.apply_norm(reprs) if self.legasee_double_norm else reprs
        return self.decoder(x, logits=return_logits)

    def meta_predict(self, logits: torch.Tensor, initial_signal: torch.Tensor,
                     length: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """(logits, initial signal) -> the predicted d loss / d reprs."""
        x = self.combiner(logits, initial_signal)
        N = x.shape[1]
        pad_mask = ~length_mask(length, N) if length is not None else None
        rotary = self._rotary(N)
        for layer in self.meta_layers:
            x = layer(x, length, pad_mask, rotary, train)
        return self.meta_decoder(x)

    def forward(self, audio_signal: torch.Tensor, length: Optional[torch.Tensor] = None,
                train: bool = False, return_logits: bool = False) -> dict:
        enc = self.encode(audio_signal, length=length, train=train)
        logits = self.decode_reprs(enc["reprs"], return_logits=True)
        grad_pred = self.meta_predict(logits, enc["initial_signal"], length=enc["lengths_arg"],
                                      train=train)
        final = (logits if return_logits
                 else torch.log_softmax(logits.float(), dim=-1).to(logits.dtype))
        return {"final_posteriors": final, "length": enc["length"], "reprs": enc["reprs"],
                "initial_signal": enc["initial_signal"], "grad_pred": grad_pred}


@torch.no_grad()
def refine_at_inference(model: SCConformerMeta, audio_signal: torch.Tensor,
                        length: Optional[torch.Tensor] = None,
                        iterations: Optional[int] = None, lr: Optional[float] = None) -> dict:
    """Label-free refinement: reprs <- reprs - lr EMA(grad_pred), the EMA
    seeded with the first prediction, then a decode.  Needs
    codebook_classes == d_model (the default)."""
    iterations = iterations or model.inference_iterations
    lr = lr or model.inference_lr
    enc = model.encode(audio_signal, length)
    reprs, ema = enc["reprs"], None
    for _ in range(iterations):
        logits = model.decode_reprs(reprs, return_logits=True)
        gp = model.meta_predict(logits, enc["initial_signal"], enc["lengths_arg"]).to(reprs.dtype)
        ema = ema_grad(ema, gp, model.ema_decay)
        reprs = reprs - lr * ema
    return {"final_posteriors": model.decode_reprs(reprs), "length": enc["length"]}
