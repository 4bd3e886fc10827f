"""Import reference PyTorch SCConformerXL checkpoints into lcasr_torch (the
port's copy of lcasr_tpu/models/import_torch.py).

The reference ships `.pt` checkpoints with the full config embedded
(reference `lcasr/utils/general.py:97-120`).  The JAX module maps that torch
state_dict onto the flax variable tree; the port keeps that numpy mapping as
it is (`convert_sconformer_state_dict`, `variables_from_torch`) and then
carries the flax-shaped tree into its own module tree with
`import_jax.state_dict_from_flax` (`state_dict_from_torch`).  Either step
raises on a name it does not know.  The encoder-decoder V2 layout has its
own copies (`convert_enc_dec_v2_state_dict`, `variables_from_torch_enc_dec`):
the packed (h, d, kv) cross-attention kv, the encoder's Fourier positions
and the decoder's RMS norms.

Layout conversions handled here:
  * Linear: torch (out, in) → flax Dense kernel (in, out)        [transpose]
  * Conv2d: torch (O, I, Kh, Kw) NCHW → flax (Kh, Kw, I, O) HWIO
  * fused QKV packing: the reference packs features as (h, d, qkv)
    innermost-qkv (reference `lcasr/components/attention.py:485`), this
    framework packs (qkv, h, d) outermost-qkv                     [permute]
  * subsampling output linear: the reference flattens (channels, freq)
    (reference `subsampling.py:422-423`), this framework flattens
    (freq, channels) for the NHWC layout                          [permute]
  * 1x1 "pointwise conv" Conv1d → Dense
  * depthwise Conv1d (C, 1, K) → (K, C)
  * BatchRenorm buffers → flax `batch_stats` collection
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, dtype=np.float32).T)


def _conv2d(w) -> np.ndarray:  # (O, I, Kh, Kw) → (Kh, Kw, I, O)
    return np.ascontiguousarray(np.transpose(np.asarray(w, dtype=np.float32), (2, 3, 1, 0)))


def convert_sconformer_state_dict(
    state_dict: Dict[str, Any],
    n_layers: int,
    n_heads: int,
    head_dim: int,
    conv_channels: int,
    feat_out_freq: int,
    sampling_num: int = 3,
    decoder_norm: bool = False,
    learned_rotary: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """torch state_dict → (params, batch_stats) flax trees.

    Raises on any leftover tensor it does not map (other than known inert
    buffers): flax.apply silently ignores extra leaves, so an unmapped
    weight would mean silently wrong logits."""
    raw = {k: np.asarray(v, dtype=np.float32) for k, v in state_dict.items()
           if not k.endswith("num_batches_tracked")}
    sd_int = {k: np.asarray(v) for k, v in state_dict.items()
              if k.endswith("num_batches_tracked")}
    consumed = set()

    class _Tracking(dict):
        def __getitem__(self, k):
            consumed.add(k)
            return dict.__getitem__(self, k)

    sd = _Tracking(raw)

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    # ---- subsampling ----
    sub_p: Dict[str, Any] = {}
    # torch Sequential indices: 0=conv_in, then per stage i: dw at 2+3i, pw at 3+3i
    sub_p["conv_in"] = {
        "kernel": _conv2d(sd["subsampling.conv.0.weight"]),
        "bias": sd["subsampling.conv.0.bias"],
    }
    for i in range(sampling_num - 1):
        dw_idx, pw_idx = 2 + 3 * i, 3 + 3 * i
        sub_p[f"dw_conv_{i}"] = {
            "kernel": _conv2d(sd[f"subsampling.conv.{dw_idx}.weight"]),
            "bias": sd[f"subsampling.conv.{dw_idx}.bias"],
        }
        sub_p[f"pw_conv_{i}"] = {
            "kernel": _conv2d(sd[f"subsampling.conv.{pw_idx}.weight"]),
            "bias": sd[f"subsampling.conv.{pw_idx}.bias"],
        }
    # output linear: reference flattens (C, F); we flatten (F, C)
    w = sd["subsampling.out.weight"]  # (d_model, C*F)
    d_model = w.shape[0]
    w = w.reshape(d_model, conv_channels, feat_out_freq)  # (d, C, F)
    w = np.transpose(w, (2, 1, 0)).reshape(feat_out_freq * conv_channels, d_model)
    sub_p["out"] = {"kernel": np.ascontiguousarray(w)}
    if "subsampling.out.bias" in sd:
        sub_p["out"]["bias"] = sd["subsampling.out.bias"]
    params["subsampling"] = sub_p

    def norm_params(prefix: str) -> Dict[str, Any]:
        out = {"scale": sd[f"{prefix}.weight"]}
        if f"{prefix}.bias" in sd:
            out["bias"] = sd[f"{prefix}.bias"]
        return out

    def mlp_params(prefix: str) -> Dict[str, Any]:
        out = {"fc1": {"kernel": _t(sd[f"{prefix}.fc1.weight"])},
               "fc2": {"kernel": _t(sd[f"{prefix}.fc2.weight"])}}
        if f"{prefix}.fc1.bias" in sd:
            out["fc1"]["bias"] = sd[f"{prefix}.fc1.bias"]
        if f"{prefix}.fc2.bias" in sd:
            out["fc2"]["bias"] = sd[f"{prefix}.fc2.bias"]
        return out

    # ---- conformer layers ----
    for i in range(n_layers):
        lp: Dict[str, Any] = {}
        ls: Dict[str, Any] = {}
        pre = f"layers.{i}"

        lp["ff1_norm"] = norm_params(f"{pre}.ff1.fn.norm")
        lp["ff1"] = mlp_params(f"{pre}.ff1.fn.fn")
        lp["ff2_norm"] = norm_params(f"{pre}.ff2.fn.norm")
        lp["ff2"] = mlp_params(f"{pre}.ff2.fn.fn")

        lp["attn_norm"] = norm_params(f"{pre}.attend.norm")
        qkv_w = sd[f"{pre}.attend.fn.qkv_proj.weight"]  # (3HD, d_model), (h,d,qkv) packing
        H, D = n_heads, head_dim
        qkv_w = qkv_w.reshape(H, D, 3, -1)  # (H, D, 3, d_model)
        qkv_w = np.transpose(qkv_w, (2, 0, 1, 3)).reshape(3 * H * D, -1)
        attn_p = {"qkv_proj": {"kernel": _t(qkv_w)},
                  "out_proj": {"kernel": _t(sd[f"{pre}.attend.fn.out_proj.weight"])}}
        # the reference ConformerLayer hardcodes Attention bias=False
        # (sconformer_xl.py:332), as does ours — a checkpoint carrying
        # attention biases cannot be represented, and flax.apply would
        # silently IGNORE the extra leaves (wrong logits, no error)
        for bias_key in (f"{pre}.attend.fn.qkv_proj.bias",
                         f"{pre}.attend.fn.out_proj.bias"):
            if bias_key in sd:
                raise ValueError(
                    f"checkpoint carries {bias_key}, but the conformer "
                    f"attention is built bias-free (reference parity) — "
                    f"importing would silently drop it"
                )
        lp["attend"] = attn_p

        lp["conv_norm"] = norm_params(f"{pre}.conv.norm")
        conv_p = {
            "pointwise_conv1": {
                "kernel": _t(sd[f"{pre}.conv.fn.pointwise_conv1.weight"][:, :, 0]),
                "bias": sd[f"{pre}.conv.fn.pointwise_conv1.bias"],
            },
            "depthwise_kernel": _t(sd[f"{pre}.conv.fn.depthwise_conv.weight"][:, 0, :]),
            "depthwise_bias": sd[f"{pre}.conv.fn.depthwise_conv.bias"],
            "pointwise_conv2": {
                "kernel": _t(sd[f"{pre}.conv.fn.pointwise_conv2.weight"][:, :, 0]),
                "bias": sd[f"{pre}.conv.fn.pointwise_conv2.bias"],
            },
        }
        bn = f"{pre}.conv.fn.batch_norm"
        if f"{bn}.weight" in sd:  # batch_renorm / batch_norm affine
            conv_p["norm"] = {"weight": sd[f"{bn}.weight"], "bias": sd[f"{bn}.bias"]}
        if f"{bn}.running_mean" in sd:
            ls["conv"] = {"norm": {
                "running_mean": sd[f"{bn}.running_mean"],
                "running_std": sd[f"{bn}.running_std"],
                "num_batches_tracked": sd_int.get(
                    f"{bn}.num_batches_tracked", np.zeros((), np.int32)
                ).astype(np.int32),
            }}
        lp["conv"] = conv_p
        lp["norm_out"] = norm_params(f"{pre}.norm_out")

        params[f"layers_{i}"] = lp
        if ls:
            stats[f"layers_{i}"] = ls

    # ---- decoder ----
    dec = {
        "ff": {"kernel": _t(sd["decoder.ff.weight"]), "bias": sd["decoder.ff.bias"]},
        "reprojection": {
            "kernel": _t(sd["decoder.reprojection.weight"]),
            "bias": sd["decoder.reprojection.bias"],
        },
    }
    if decoder_norm and "decoder.norm.weight" in sd:
        dec["norm"] = norm_params("decoder.norm")
    params["decoder"] = dec

    # ---- rotary ----
    # non-learned inv_freq is a BUFFER recomputed exactly from base/dim;
    # learned_freq=True makes it a trained Parameter (reference
    # rotary_emb.py:27-30) that MUST be carried over
    if learned_rotary:
        params["rotary_pos_emb"] = {"inv_freq": sd["rotary_pos_emb.inv_freq"]}
    else:
        consumed.add("rotary_pos_emb.inv_freq")  # inert buffer if present
    consumed.add("rotary_pos_emb.rotary_interpolation_factor")  # buffer

    leftovers = sorted(set(raw) - consumed)
    if leftovers:
        raise ValueError(
            f"unmapped tensors in checkpoint (would be silently ignored by "
            f"flax.apply): {leftovers[:8]}{'...' if len(leftovers) > 8 else ''}"
        )
    return params, stats


def load_torch_checkpoint(path: str):
    """Load a reference `.pt` checkpoint → (config dict, state_dict)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    config = ckpt.get("config", {})
    sd = ckpt.get("model", ckpt)
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    return config, sd


def variables_from_torch(
    state_dict: Dict[str, Any], model_cfg: Dict[str, Any]
) -> Dict[str, Any]:
    """Build the full flax `variables` dict from a torch state_dict and the
    model section of the checkpoint-embedded config."""
    import math

    n_layers = model_cfg.get("n_layers", 6)
    n_heads = model_cfg.get("n_heads", 6)
    head_dim = model_cfg.get("head_dim", 128)
    conv_channels = model_cfg.get("subsampling_conv_channels", 256)
    if conv_channels == -1:
        conv_channels = model_cfg.get("d_model", 768)
    feat_in = model_cfg.get("feat_in", 80)
    factor = model_cfg.get("subsampling_factor", 8)
    sampling_num = int(math.log2(factor))
    f = float(feat_in)
    for _ in range(sampling_num):
        f = math.floor((f - 3 + 2) / 2 + 1)
    params, stats = convert_sconformer_state_dict(
        state_dict,
        n_layers=n_layers,
        n_heads=n_heads,
        head_dim=head_dim,
        conv_channels=conv_channels,
        feat_out_freq=int(f),
        sampling_num=sampling_num,
        decoder_norm=model_cfg.get("decoder_norm", False),
        learned_rotary=model_cfg.get("learned_rotary", False),
    )
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def state_dict_from_torch(state_dict: Dict[str, Any], model_cfg: Dict[str, Any]):
    """A reference-layout torch state_dict -> the port's SCConformerXL
    state_dict (load it with `load_state_dict(sd, strict=True)`)."""
    from lcasr_torch.models.import_jax import state_dict_from_flax

    return state_dict_from_flax(variables_from_torch(state_dict, model_cfg))


def convert_enc_dec_v2_state_dict(
    state_dict: Dict[str, Any],
    n_layers: int,
    n_heads: int,
    head_dim: int,
    conv_channels: int,
    feat_out_freq: int,
    sampling_num: int = 3,
    decoder_layers: int | None = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """torch EncDecSconformerV2 state_dict → (params, batch_stats).

    The reference AED models are constructor-disabled upstream
    (`enc_dec_sconformer*.py` raise NotImplementedError mid-__init__); the
    module code below the raise is complete and this converter maps its
    state_dict — encoder via `convert_sconformer_state_dict` (identical
    layer structure; the CTC head is named `ctc_decoder` there), plus the
    encoder Fourier positions and the V2 cross-attention decoder
    (cosine self-attention with learned temperature, DynamicPositionBias,
    RMS norms — reference `enc_dec_sconformer_v2.py:30-1110`)."""
    raw = {k: np.asarray(v, dtype=np.float32) for k, v in state_dict.items()
           if not k.endswith("num_batches_tracked")}
    sd_int = {k: np.asarray(v) for k, v in state_dict.items()
              if k.endswith("num_batches_tracked")}
    dl = decoder_layers if decoder_layers is not None else n_layers

    # ---- encoder: reuse the SCConformerXL mapping on the renamed subset ----
    enc_sd: Dict[str, Any] = dict(sd_int)
    for k, v in raw.items():
        if k.startswith(("layers.", "subsampling.", "rotary_pos_emb.")):
            enc_sd[k] = v
        elif k.startswith("ctc_decoder."):
            enc_sd["decoder." + k[len("ctc_decoder."):]] = v
    params, stats = convert_sconformer_state_dict(
        enc_sd, n_layers=n_layers, n_heads=n_heads, head_dim=head_dim,
        conv_channels=conv_channels, feat_out_freq=feat_out_freq,
        sampling_num=sampling_num, decoder_norm=True,
    )

    consumed = {k for k in raw
                if k.startswith(("layers.", "subsampling.", "ctc_decoder.",
                                 "rotary_pos_emb."))}
    sd = raw

    def fourier(prefix: str) -> Dict[str, Any]:
        out = {
            "w_r": sd[f"{prefix}.w_r"],
            "mlp_0": {"kernel": _t(sd[f"{prefix}.mlp.0.weight"]),
                      "bias": sd[f"{prefix}.mlp.0.bias"]},
            "mlp_1": {"kernel": _t(sd[f"{prefix}.mlp.2.weight"]),
                      "bias": sd[f"{prefix}.mlp.2.bias"]},
        }
        consumed.update(f"{prefix}.{s}" for s in
                        ("w_r", "mlp.0.weight", "mlp.0.bias",
                         "mlp.2.weight", "mlp.2.bias"))
        return out

    params["encoder_pos_enc"] = fourier("pos_enc")

    # ---- V2 decoder ----
    H, D = n_heads, head_dim
    lm = "language_model_decoder"
    dec: Dict[str, Any] = {
        "embed": {"embedding": sd[f"{lm}.embed.weight"]},
        "pos_enc": fourier(f"{lm}.pos_enc"),
        "out_norm": {"scale": sd[f"{lm}.out_proj.0.scale"]},
        "out_proj": {"kernel": _t(sd[f"{lm}.out_proj.1.weight"]),
                     "bias": sd[f"{lm}.out_proj.1.bias"]},
        "dynamic_pos_bias": {
            "mlp_0": {"kernel": _t(sd[f"{lm}.positional_bias.mlp.0.0.weight"]),
                      "bias": sd[f"{lm}.positional_bias.mlp.0.0.bias"]},
            "mlp_1": {"kernel": _t(sd[f"{lm}.positional_bias.mlp.1.0.weight"]),
                      "bias": sd[f"{lm}.positional_bias.mlp.1.0.bias"]},
            "proj": {"kernel": _t(sd[f"{lm}.positional_bias.mlp.2.weight"]),
                     "bias": sd[f"{lm}.positional_bias.mlp.2.bias"]},
        },
    }
    consumed.update(f"{lm}.{s}" for s in (
        "embed.weight", "out_proj.0.scale", "out_proj.1.weight",
        "out_proj.1.bias", "positional_bias.mlp.0.0.weight",
        "positional_bias.mlp.0.0.bias", "positional_bias.mlp.1.0.weight",
        "positional_bias.mlp.1.0.bias", "positional_bias.mlp.2.weight",
        "positional_bias.mlp.2.bias"))

    for i in range(dl):
        pre = f"{lm}.layers.{i}"
        # [0] PreNorm(self-attn, cosine + temperature): the reference packs
        # qkv features (h, d, qkv) innermost-qkv; this framework packs
        # (qkv, h, d) — same permute as the encoder attention
        qkv_w = sd[f"{pre}.0.fn.qkv_proj.weight"]
        qkv_w = qkv_w.reshape(H, D, 3, -1)
        qkv_w = np.transpose(qkv_w, (2, 0, 1, 3)).reshape(3 * H * D, -1)
        dec[f"self_norm_{i}"] = {"scale": sd[f"{pre}.0.norm.scale"]}
        dec[f"self_attn_{i}"] = {
            "qkv_proj": {"kernel": _t(qkv_w)},
            "out_proj": {"kernel": _t(sd[f"{pre}.0.fn.out_proj.weight"])},
            "temperature": sd[f"{pre}.0.fn.temperature"],
        }
        # [1] PreNorm(cross-attn): kv packed (h, d, kv) innermost-kv → ours
        # (kv, h, d); the reference's CrossAttention also constructs a
        # qkv_proj it never uses in forward (dead parameter) — consume it
        kv_w = sd[f"{pre}.1.fn.kv_proj.weight"]
        kv_w = kv_w.reshape(H, D, 2, -1)
        kv_w = np.transpose(kv_w, (2, 0, 1, 3)).reshape(2 * H * D, -1)
        dec[f"cross_norm_{i}"] = {"scale": sd[f"{pre}.1.norm.scale"]}
        dec[f"cross_attn_{i}"] = {
            "q_proj": {"kernel": _t(sd[f"{pre}.1.fn.q_proj.weight"])},
            "kv_proj": {"kernel": _t(kv_w)},
            "out_proj": {"kernel": _t(sd[f"{pre}.1.fn.out_proj.weight"])},
        }
        consumed.add(f"{pre}.1.fn.qkv_proj.weight")  # dead upstream param
        # [2] PreNorm(ff)
        dec[f"ff_norm_{i}"] = {"scale": sd[f"{pre}.2.norm.scale"]}
        dec[f"ff_{i}"] = {
            "fc1": {"kernel": _t(sd[f"{pre}.2.fn.fc1.weight"])},
            "fc2": {"kernel": _t(sd[f"{pre}.2.fn.fc2.weight"])},
        }
        consumed.update(f"{pre}.{s}" for s in (
            "0.fn.qkv_proj.weight", "0.norm.scale", "0.fn.out_proj.weight",
            "0.fn.temperature", "1.fn.kv_proj.weight", "1.norm.scale",
            "1.fn.q_proj.weight", "1.fn.out_proj.weight", "2.norm.scale",
            "2.fn.fc1.weight", "2.fn.fc2.weight"))
    params["language_model_decoder"] = dec

    leftovers = sorted(set(raw) - consumed)
    if leftovers:
        raise ValueError(
            f"unmapped AED tensors (flax.apply would silently ignore them): "
            f"{leftovers[:8]}{'...' if len(leftovers) > 8 else ''}")
    return params, stats


def variables_from_torch_enc_dec(
    state_dict: Dict[str, Any], model_cfg: Dict[str, Any]
) -> Dict[str, Any]:
    """Full flax variables for EncDecSconformerV2 from a torch state_dict."""
    import math

    conv_channels = model_cfg.get("subsampling_conv_channels", 256)
    if conv_channels == -1:
        conv_channels = model_cfg.get("d_model", 768)
    feat_in = model_cfg.get("feat_in", 80)
    factor = model_cfg.get("subsampling_factor", 8)
    sampling_num = int(math.log2(factor))
    f = float(feat_in)
    for _ in range(sampling_num):
        f = math.floor((f - 3 + 2) / 2 + 1)
    params, stats = convert_enc_dec_v2_state_dict(
        state_dict,
        n_layers=model_cfg.get("n_layers", 6),
        n_heads=model_cfg.get("n_heads", 6),
        head_dim=model_cfg.get("head_dim", 128),
        conv_channels=conv_channels,
        feat_out_freq=int(f),
        sampling_num=sampling_num,
        decoder_layers=model_cfg.get("decoder_layers"),
    )
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
