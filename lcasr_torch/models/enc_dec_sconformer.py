"""Attention-encoder-decoder (AED) conformer models with joint CTC loss
(counterpart of lcasr_tpu/models/enc_dec_sconformer.py).

  * the conformer encoder of SCConformerXL (`ConformerLayer`, the
    self-conditioned CTC head `decoder` when ctc_loss_weight > 0), with
    learnable Fourier positions (MLP width 64) after the subsampling as
    well as rotary in the attention;
  * `language_model_decoder`, a cross-attention transformer decoder: token
    embedding + Fourier positions, n x [causal self-attention -> attention
    over the acoustic states -> FF], RMS norms, a normed output projection;
  * V2 (`EncDecSconformerV2`): the decoder's self-attention is cosine
    attention with one learned temperature and a `DynamicPositionBias`
    instead of rotary;
  * `calc_loss` (joint CTC + CE with the reference's normalisations),
    greedy decoding over the full prefix (`generate_greedy`) or with
    per-layer KV caches (`generate_greedy_cached`), and the internal-LM CTC
    beam search (`ctc_beam_search`).

Module and parameter names follow the flax tree one to one
(`language_model_decoder/self_attn_0/qkv_proj/kernel` is
`language_model_decoder.self_attn_0.qkv_proj.weight`; the token table keeps
flax's leaf name `embedding`, (vocab, d_model)), and the packed projections
keep the JAX package's output packing: qkv (3, H, D), the cross-attention's
kv (2, H, D).  The encoder's attention runs the flash-attention kernels on
the GPU (`models/sconformer_xl.Attention`); the decoder's attention is plain
torch, as the JAX package computes it with einsum outside any Pallas kernel:
fp32 scores, NEG_INF masking, fp32 softmax, the result in the query's dtype.

The JAX `lax.while_loop` of the greedy decoders is a Python loop over a
static (1, max_generate) token buffer and static (B, S, H, D) caches.  Each
token costs one host synchronisation, the eos check; the loop stops on eos
or at t = max_generate - 1 and returns ids 1..t without the eos ids.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lcasr_torch.device import resolve_device
from lcasr_torch.models.decoder import ASRLinearSCDecoder
from lcasr_torch.models.positional import DynamicPositionBias, LearnableFourierPosEnc
from lcasr_torch.models.sconformer_xl import ConformerLayer
from lcasr_torch.ops.attention import NEG_INF, length_mask
from lcasr_torch.ops.conv import ConvSubsampling
from lcasr_torch.ops.ctc import ctc_loss
from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.mlp import ConformerFeedForward
from lcasr_torch.ops.norms import get_norm
from lcasr_torch.ops.qdense import TRAIN_REFUSAL, apply_quant_policy
from lcasr_torch.ops.rotary import RotaryEmbedding, apply_rotary, rotate_half

Cache = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def init_decoder_cache(n_layers: int, n_heads: int, head_dim: int, batch: int, max_len: int,
                       dtype: torch.dtype = torch.float32, device=None) -> Cache:
    """Zeroed per-layer self-attention (k, v) caches, (batch, max_len, H, D)."""
    shape = (batch, max_len, n_heads, head_dim)
    return tuple((torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device)) for _ in range(n_layers))


def _softmax_attention(scores: torch.Tensor, mask: Optional[torch.Tensor], v: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """fp32 scores (B, H, Tq, Tk), mask True = keep -> (B, Tq, H, D) in dtype."""
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(dtype)


def _masked_softmax_attention(q, k, v, mask, scale: float) -> torch.Tensor:
    """q (B, Tq, H, D), k, v (B, Tk, H, D), mask (B or 1, 1, Tq, Tk) bool."""
    scores = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    return _softmax_attention(scores, mask, v, q.dtype)


class Embed(nn.Module):
    """flax `nn.Embed`: an fp32 (vocab, d_model) table named `embedding`,
    looked up and cast to the compute dtype."""

    def __init__(self, vocab_size: int, d_model: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.randn(vocab_size, d_model) * d_model ** -0.5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.dtype)


class DecoderSelfAttention(nn.Module):
    """Causal self-attention over a full prefix, or one cached step.  V2
    (`cosine`): q and k divided by their fp32 L2 norm + 1e-6, scores scaled
    by one shared learned `temperature` instead of D^-1/2."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, bias: bool = False,
                 cosine: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads, self.head_dim, self.cosine = n_heads, head_dim, cosine
        self.qkv_proj = Dense(d_model, 3 * n_heads * head_dim, bias=False, dtype=dtype,
                              site="proj")
        self.out_proj = Dense(n_heads * head_dim, d_model, bias=bias, dtype=dtype, site="proj")
        if cosine:
            self.temperature = nn.Parameter(torch.tensor(15.5))

    @staticmethod
    def _normalize(a: torch.Tensor) -> torch.Tensor:
        return a / (torch.linalg.vector_norm(a.float(), dim=-1, keepdim=True) + 1e-6).to(a.dtype)

    def forward(self, x, rotary=None, pos_bias=None, cache=None):
        """Full causal pass (cache None): out.  Cached step (x (B, 1, d),
        cache (k_cache, v_cache, t), caches holding steps < t): the new key
        and value are written at t in place and attention runs over columns
        <= t; returns (out, (k_cache, v_cache))."""
        B, T, _ = x.shape
        H, D = self.n_heads, self.head_dim
        q, k, v = self.qkv_proj(x).view(B, T, 3, H, D).unbind(2)
        scale = self.temperature if self.cosine else D ** -0.5

        if cache is not None:
            k_cache, v_cache, t = cache
            S = k_cache.shape[1]
            if rotary is not None:  # fp32 tables over max_len; q, k promote to fp32
                cos, sin = rotary
                cos_t, sin_t = cos[None, t:t + 1, None, :], sin[None, t:t + 1, None, :]
                q = q * cos_t + rotate_half(q) * sin_t
                k = k * cos_t + rotate_half(k) * sin_t
            if self.cosine:
                q, k = self._normalize(q), self._normalize(k)
            k_cache[:, t:t + 1] = k.to(k_cache.dtype)
            v_cache[:, t:t + 1] = v.to(v_cache.dtype)
            scores = torch.einsum("bthd,bshd->bhts", q.float(), k_cache.float()) * scale
            if pos_bias is not None:
                scores = scores + pos_bias[None]  # (1, H, 1, S)
            valid = (torch.arange(S, device=x.device) <= t)[None, None, None, :]
            out = _softmax_attention(scores, valid, v_cache, x.dtype)
            return self.out_proj(out.reshape(B, T, H * D)), (k_cache, v_cache)

        if rotary is not None:
            q, k = apply_rotary(q, k, *rotary)
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()[None, None]
        if self.cosine or pos_bias is not None:
            if self.cosine:
                q, k = self._normalize(q), self._normalize(k)
            scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
            if pos_bias is not None:  # the full pass and the cached step are one model
                scores = scores + pos_bias[None]
            out = _softmax_attention(scores, causal, v, x.dtype)
        else:
            out = _masked_softmax_attention(q, k, v, causal, scale)
        return self.out_proj(out.reshape(B, T, H * D))


class CrossAttention(nn.Module):
    """Text queries over acoustic keys and values, masked by the acoustic
    lengths."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        self.kv_proj = Dense(d_model, 2 * n_heads * head_dim, bias=False, dtype=dtype,
                             site="proj")
        self.q_proj = Dense(d_model, n_heads * head_dim, bias=False, dtype=dtype, site="proj")
        self.out_proj = Dense(n_heads * head_dim, d_model, bias=bias, dtype=dtype, site="proj")

    def project_kv(self, xkv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, Tk, _ = xkv.shape
        k, v = self.kv_proj(xkv).view(B, Tk, 2, self.n_heads, self.head_dim).unbind(2)
        return k, v

    def forward(self, xq, xkv=None, kv_lengths=None, kv=None):
        """xq over the keys and values of `xkv`, or over the projected `kv`
        pair (`project_kv`, once per recording when decoding)."""
        k, v = kv if kv is not None else self.project_kv(xkv)
        B, Tq, _ = xq.shape
        H, D = self.n_heads, self.head_dim
        q = self.q_proj(xq).view(B, Tq, H, D)
        mask = None
        if kv_lengths is not None:
            mask = length_mask(kv_lengths, k.shape[1])[:, None, None, :]
        out = _masked_softmax_attention(q, k, v, mask, D ** -0.5)
        return self.out_proj(out.reshape(B, Tq, H * D))


class CrossAttnDecoder(nn.Module):
    """Transformer decoder with cross-attention and RMS norms: the full
    teacher-forced pass (`forward`), and incremental decoding (`precompute`
    once per recording: the cross keys and values, the rotary tables and
    the (H, max_len, max_len) position-bias table; `step`: one token with
    per-layer KV caches).  Rotary unless the attention is cosine (V2).  The
    JAX module's options that EncDecSconformer never sets (no output norm,
    no rotary, another norm, an acoustic norm) are not ported."""

    def __init__(self, vocab_size: int, n_layers: int = 3, d_model: int = 768,
                 n_heads: int = 6, head_dim: int = 128, rotary_base_freq: float = 10000.0,
                 bias_in_ff: bool = False, cosine_attention: bool = False,
                 use_dynamic_pos_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        Norm = get_norm("rms_norm")
        self.n_layers, self.n_heads = n_layers, n_heads
        self.embed = Embed(vocab_size, d_model, dtype=dtype)
        self.pos_enc = LearnableFourierPosEnc(d_model, hidden_dim=64, dtype=dtype)
        self.use_rotary = not cosine_attention
        if self.use_rotary:
            self.rotary_pos_emb = RotaryEmbedding(head_dim, base=rotary_base_freq)
        self.dynamic_pos_bias = (DynamicPositionBias(dim=64, heads=n_heads)
                                 if use_dynamic_pos_bias else None)
        for i in range(n_layers):
            self.add_module(f"self_norm_{i}", Norm(d_model))
            self.add_module(f"self_attn_{i}", DecoderSelfAttention(
                d_model, n_heads, head_dim, bias=bias_in_ff, cosine=cosine_attention,
                dtype=dtype))
            self.add_module(f"cross_norm_{i}", Norm(d_model))
            self.add_module(f"cross_attn_{i}", CrossAttention(
                d_model, n_heads, head_dim, bias=bias_in_ff, dtype=dtype))
            self.add_module(f"ff_norm_{i}", Norm(d_model))
            self.add_module(f"ff_{i}", ConformerFeedForward(
                d_model, bias1=bias_in_ff, bias2=bias_in_ff, dtype=dtype, site="ff"))
        self.out_norm = Norm(d_model)
        self.out_proj = Dense(d_model, vocab_size, dtype=dtype, site="lm_head")

    def _layer(self, name: str, i: int) -> nn.Module:
        return getattr(self, f"{name}_{i}")

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(self.out_norm(x))

    def forward(self, tokens, a_hidden, a_lengths):
        T = tokens.shape[1]
        x = self.pos_enc(self.embed(tokens))
        rotary = self.rotary_pos_emb(T) if self.use_rotary else None
        pos_bias = self.dynamic_pos_bias(T, T) if self.dynamic_pos_bias is not None else None
        for i in range(self.n_layers):
            x = x + self._layer("self_attn", i)(self._layer("self_norm", i)(x),
                                                rotary=rotary, pos_bias=pos_bias)
            x = x + self._layer("cross_attn", i)(self._layer("cross_norm", i)(x), a_hidden,
                                                 kv_lengths=a_lengths)
            x = x + self._layer("ff", i)(self._layer("ff_norm", i)(x))
        return self._head(x)

    def precompute(self, a_hidden, a_lengths, max_len: int) -> Dict[str, object]:
        return {
            "cross_kv": [self._layer("cross_attn", i).project_kv(a_hidden)
                         for i in range(self.n_layers)],
            "rotary": self.rotary_pos_emb(max_len) if self.use_rotary else None,
            "pos_bias": (self.dynamic_pos_bias(max_len, max_len)
                         if self.dynamic_pos_bias is not None else None),
        }

    def step(self, token, t: int, caches: Cache, pre, a_lengths):
        """token (B,) at position t -> (logits (B, vocab) for position t,
        caches, written in place)."""
        B = token.shape[0]
        x = self.embed(token[:, None])
        x = self.pos_enc(x, offsets=torch.full((B,), t, dtype=torch.int32, device=x.device))
        pos_bias_row = pre["pos_bias"][:, t:t + 1] if pre["pos_bias"] is not None else None
        new_caches = []
        for i in range(self.n_layers):
            out, kv = self._layer("self_attn", i)(
                self._layer("self_norm", i)(x), rotary=pre["rotary"], pos_bias=pos_bias_row,
                cache=(caches[i][0], caches[i][1], t))
            new_caches.append(kv)
            x = x + out
            x = x + self._layer("cross_attn", i)(self._layer("cross_norm", i)(x),
                                                 kv_lengths=a_lengths, kv=pre["cross_kv"][i])
            x = x + self._layer("ff", i)(self._layer("ff_norm", i)(x))
        return self._head(x)[:, 0], tuple(new_caches)


# options of the JAX model that are not ported: name -> (accepted default, what)
_NOT_PORTED = {
    "use_pallas": (True, "a TPU switch; the port always runs its own kernel"),
}


class EncDecSconformer(nn.Module):
    """forward(audio (B, feat_in, T), text_sequence (B, U) or None,
    length (B,) or None) -> {'a_hidden', 'final_posteriors_ctc' (=
    'final_posteriors', (B, T', vocab+1) fp32 log-probs, None without the
    CTC head), 'length', and with text 'final_posteriors_lm' (B, U, vocab)
    logits in the compute dtype}.

    The decoder's depth is `n_layers` unless `decoder_layers` says
    otherwise.  `cosine_attention` / `use_dynamic_pos_bias` None means the
    class's default (off here, on in EncDecSconformerV2).  `device=None`
    means the GPU and raises without one."""

    NOT_PORTED = _NOT_PORTED
    V2 = False

    def __init__(
        self,
        vocab_size: int = 4096,
        feat_in: int = 80,
        subsampling_factor: int = 8,
        subsampling_conv_channels: int = 256,
        subsampling_act: str = "silu",
        n_layers: int = 6,
        d_model: int = 768,
        n_heads: int = 6,
        head_dim: int = 128,
        decoder_layers: Optional[int] = None,
        ctc_loss_weight: float = 0.5,
        self_conditioning: bool = True,
        default_norm: str = "layer_norm",
        conv_kernel_size: int = 9,
        use_rotary: bool = True,
        rotary_base_freq: float = 10000.0,
        bias_in_ff: bool = False,
        cosine_attention: Optional[bool] = None,
        use_dynamic_pos_bias: Optional[bool] = None,
        quant_w8a8=False,  # False | True | "auto" | site names (ops/qdense.py)
        dtype: torch.dtype = torch.float32,
        device=None,
        **not_ported,
    ):
        super().__init__()
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"{type(self).__name__} got an unexpected argument {name!r}")
            default, what = _NOT_PORTED[name]
            if value != default:
                raise NotImplementedError(f"{name}={value!r}: {what} is not ported yet")
        device = resolve_device(device)
        self.dtype = dtype
        self.n_layers, self.n_heads, self.head_dim = n_layers, n_heads, head_dim
        self.decoder_layers = decoder_layers if decoder_layers is not None else n_layers
        self.ctc_loss_weight = ctc_loss_weight
        self.self_conditioning = self_conditioning
        self.use_rotary = use_rotary
        self.subsampling_factor = subsampling_factor
        self.subsampling = ConvSubsampling(
            subsampling_factor=subsampling_factor, feat_in=feat_in, feat_out=d_model,
            conv_channels=subsampling_conv_channels, activation=subsampling_act, dtype=dtype)
        self.layers = nn.ModuleList(
            ConformerLayer(d_model, n_heads, head_dim, conv_kernel_size=conv_kernel_size,
                           default_norm=default_norm, bias_in_ff=bias_in_ff, dtype=dtype)
            for _ in range(n_layers))
        self.use_ctc = ctc_loss_weight > 0
        self.decoder = (ASRLinearSCDecoder(d_model, vocab_size, norm=True, norm_type=default_norm,
                                           dtype=dtype, reproject=self_conditioning and n_layers > 1)
                        if self.use_ctc else None)
        self.language_model_decoder = CrossAttnDecoder(
            vocab_size, n_layers=self.decoder_layers, d_model=d_model, n_heads=n_heads,
            head_dim=head_dim, bias_in_ff=bias_in_ff, rotary_base_freq=rotary_base_freq,
            cosine_attention=self.V2 if cosine_attention is None else cosine_attention,
            use_dynamic_pos_bias=self.V2 if use_dynamic_pos_bias is None else use_dynamic_pos_bias,
            dtype=dtype)
        if use_rotary:
            self.rotary_pos_emb = RotaryEmbedding(head_dim, base=rotary_base_freq)
        self.encoder_pos_enc = LearnableFourierPosEnc(d_model, hidden_dim=64, dtype=dtype)
        apply_quant_policy(self, quant_w8a8)
        self.to(device)
        self.eval()

    def encode(self, audio_signal: torch.Tensor, length: Optional[torch.Tensor] = None,
               train: bool = False):
        """-> (acoustic states (B, T', d_model), CTC log-probs or None, length)."""
        if train and self.quant_sites:
            raise ValueError(TRAIN_REFUSAL)
        x = audio_signal.transpose(1, 2).to(self.dtype)
        have_lengths = length is not None
        if not have_lengths:
            length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        x, length = self.subsampling(x, length.to(x.device))
        x = self.encoder_pos_enc(x)
        N = x.shape[1]
        lengths_arg = length if have_lengths else None
        pad_mask = ~length_mask(length, N) if have_lengths else None
        rotary = self.rotary_pos_emb(N) if self.use_rotary else None
        dec = self.decoder
        for i, layer in enumerate(self.layers):
            x = layer(x, lengths_arg, pad_mask, rotary, train)
            if self.use_ctc and self.self_conditioning and i != self.n_layers - 1:
                posts = torch.softmax(dec(x, logits=True).float(), dim=-1).to(x.dtype)
                x = x + dec.project_back(posts)
        ctc_posts = dec(dec.apply_norm(x)) if self.use_ctc else None
        return x, ctc_posts, length

    def forward(self, audio_signal: torch.Tensor, text_sequence: Optional[torch.Tensor] = None,
                length: Optional[torch.Tensor] = None, train: bool = False):
        a_hidden, ctc_posts, length = self.encode(audio_signal, length, train)
        out = {"a_hidden": a_hidden, "final_posteriors_ctc": ctc_posts,
               "final_posteriors": ctc_posts, "length": length}
        if text_sequence is not None:
            # the second positional argument is the text, not the lengths
            if text_sequence.dim() != 2:
                raise ValueError("text_sequence must be (B, U) token ids; got shape "
                                 f"{tuple(text_sequence.shape)} — pass lengths as length=...")
            out["final_posteriors_lm"] = self.language_model_decoder(
                text_sequence, a_hidden, length)
        return out

    def generate_step(self, tokens, a_hidden, a_lengths):
        """One decoder pass over a full token buffer -> logits."""
        return self.language_model_decoder(tokens, a_hidden, a_lengths)

    def decoder_precompute(self, a_hidden, a_lengths, max_len: int):
        return self.language_model_decoder.precompute(a_hidden, a_lengths, max_len)

    def decoder_step(self, token, t: int, caches: Cache, pre, a_lengths):
        return self.language_model_decoder.step(token, t, caches, pre, a_lengths)


class EncDecSconformerV2(EncDecSconformer):
    """V2: cosine-attention decoder with DynamicPositionBias by default."""

    V2 = True


def calc_loss(model: EncDecSconformer, audio_signal, text_sequence, a_lengths, t_lengths,
              ctc_loss_weight: Optional[float] = None, bos_id: int = 0, eos_id: int = 0,
              train: bool = False) -> Dict[str, torch.Tensor]:
    """Joint CTC + CE loss with the reference's normalisations: CTC sum /
    (B T') x 100 and CE sum / (B (U + 1)), weighted by ctc_loss_weight (the
    model's by default) and 1 - it.  The CE targets are the text shifted by
    one with eos at position t_lengths.  `train=True` runs the model in
    training mode (BatchRenorm updates its running statistics)."""
    if ctc_loss_weight is None:
        ctc_loss_weight = model.ctc_loss_weight
    B = text_sequence.shape[0]
    text_bos = F.pad(text_sequence, (1, 0), value=bos_id)
    t_lengths_bos = t_lengths + 1
    out = model(audio_signal, text_sequence=text_bos, length=a_lengths, train=train)
    ctc_out, lm_out, a_len_out = (out["final_posteriors_ctc"], out["final_posteriors_lm"],
                                  out["length"])
    ctc_to_bwd = torch.zeros((), device=lm_out.device)
    if ctc_loss_weight > 0 and ctc_out is not None:
        nll = ctc_loss(ctc_out.float(), text_sequence, a_len_out, t_lengths)
        ctc_to_bwd = nll / (ctc_out.shape[0] * ctc_out.shape[1]) * 100
    targets = torch.cat([text_bos[:, 1:], torch.zeros_like(text_bos[:, :1])], dim=1)
    pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
    targets = torch.where(pos == (t_lengths_bos - 1)[:, None], eos_id, targets)
    valid = pos < t_lengths_bos[:, None]
    logp = torch.log_softmax(lm_out.float(), dim=-1)
    ce = -logp.gather(-1, targets[..., None].long())[..., 0]
    lm_to_bwd = torch.where(valid, ce, 0.0).sum() / (B * lm_out.shape[1])
    loss = ctc_to_bwd * ctc_loss_weight + lm_to_bwd * (1 - ctc_loss_weight)
    return {"loss": loss, "ctc_loss": ctc_to_bwd, "lm_loss": lm_to_bwd, "length": a_len_out}


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _ids(tokens: torch.Tensor, t: int, eos_id: int) -> List[int]:
    return [i for i in tokens[0, 1:t + 1].tolist() if i != eos_id]


@torch.no_grad()
def generate_greedy(model: EncDecSconformer, audio_signal, max_generate: int = 256,
                    bos_id: int = 0, eos_id: int = 0) -> List[int]:
    """Greedy decoding of one recording (B = 1), one decoder pass over the
    whole static token buffer per emitted token (O(U^2))."""
    audio = torch.as_tensor(audio_signal, device=_model_device(model))
    a_hidden, _, length = model.encode(audio)
    tokens = torch.zeros((1, max_generate), dtype=torch.int64, device=audio.device)
    tokens[0, 0] = bos_id
    t = 0
    while t < max_generate - 1:
        nxt = model.generate_step(tokens, a_hidden, length)[0, t].argmax(-1)
        tokens[0, t + 1] = nxt
        t += 1
        if bool(nxt == eos_id):  # the loop's one host synchronisation
            break
    return _ids(tokens, t, eos_id)


@torch.no_grad()
def generate_greedy_cached(model: EncDecSconformer, audio_signal, max_generate: int = 256,
                           bos_id: int = 0, eos_id: int = 0) -> List[int]:
    """Greedy decoding with per-layer self-attention KV caches and the
    cross keys and values projected once (O(U)); the ids of
    `generate_greedy`."""
    audio = torch.as_tensor(audio_signal, device=_model_device(model))
    a_hidden, _, length = model.encode(audio)
    pre = model.decoder_precompute(a_hidden, length, max_generate)
    caches = init_decoder_cache(model.decoder_layers, model.n_heads, model.head_dim, batch=1,
                                max_len=max_generate, dtype=model.dtype, device=audio.device)
    tokens = torch.zeros((1, max_generate), dtype=torch.int64, device=audio.device)
    tokens[0, 0] = bos_id
    t = 0
    while t < max_generate - 1:
        logits, caches = model.decoder_step(tokens[:, t], t, caches, pre, length)
        nxt = logits[0].argmax(-1)
        tokens[0, t + 1] = nxt
        t += 1
        if bool(nxt == eos_id):  # the loop's one host synchronisation
            break
    return _ids(tokens, t, eos_id)


PREFIX_BUCKET = 16  # the internal LM's prefix widths are multiples of this


def _internal_lm_scorer(model: EncDecSconformer, a_hidden: torch.Tensor,
                       a_length: torch.Tensor):
    """`fn(histories) -> (n, vocab)` next-token log-probs (numpy fp32) from
    one batched full-prefix decoder pass over the histories, padded to a
    multiple of PREFIX_BUCKET (at least 16) tokens."""
    @torch.no_grad()
    def fn(histories):
        n = len(histories)
        U = max(PREFIX_BUCKET, -(-max(len(h) for h in histories) // PREFIX_BUCKET) * PREFIX_BUCKET)
        toks = np.zeros((n, U), np.int64)
        lens = np.zeros((n,), np.int64)
        for i, h in enumerate(histories):
            toks[i, : len(h)] = h
            lens[i] = len(h)
        dev = a_hidden.device
        logits = model.generate_step(torch.from_numpy(toks).to(dev),
                                     a_hidden.expand(n, -1, -1), a_length.expand(n))
        row = logits[torch.arange(n, device=dev), torch.from_numpy(lens - 1).to(dev)]
        return torch.log_softmax(row.float(), dim=-1).cpu().numpy()

    return fn


@torch.no_grad()
def ctc_beam_search(model: EncDecSconformer, audio_signal, tokenizer, beam_width: int = 25,
                    alpha: float = 0.45, beta: float = 1.53,
                    prune_less_than_val: Optional[float] = 8.0,
                    top_am_threshold: float = -6.0, bos_id: int = 0) -> str:
    """The V2 model's internal-LM beam search: the model's own decoder
    scores the frame-synchronous CTC beam search over its CTC posteriors
    (bos 0, blank = the tokenizer's vocab size), one batched decoder pass
    over the live beams per emitting frame.  Returns the best beam's text."""
    from lcasr_torch.decoding.frame_sync import FrameSyncBeamSearch, HistoryLM

    out = model(torch.as_tensor(audio_signal, device=_model_device(model)))
    if out["final_posteriors_ctc"] is None:
        raise ValueError("ctc_beam_search needs the CTC head (ctc_loss_weight > 0)")
    ctc_lp = out["final_posteriors_ctc"][0].float().cpu().numpy()
    search = FrameSyncBeamSearch(
        lm=HistoryLM(_internal_lm_scorer(model, out["a_hidden"], out["length"]), bos_id=bos_id),
        tokenizer=tokenizer, beam_width=beam_width, alpha=alpha, beta=beta,
        blank_id=tokenizer.vocab_size(), prune_less_than_val=prune_less_than_val,
        top_am_threshold=top_am_threshold, bos_id=bos_id)
    return search.run_search(ctc_lp, decode=True)
