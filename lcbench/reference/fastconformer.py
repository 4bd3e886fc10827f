"""NeMo's FastConformer CTC model (Parakeet-CTC-1.1B's architecture), plain and
in fp32.

  8x dw_striding subsampling (ReLU, output projection with a bias) ->
  x * sqrt(d_model) -> n x layer -> CTC head:
  layer: x += 1/2 FF1(LN x); x += MHSA(LN x); x += Conv(LN x);
         x += 1/2 FF2(LN x); x = LN x
  FF: Linear(d, 4d) -> Swish -> Linear(4d, d), with biases;
  MHSA: Transformer-XL relative-position attention with untied biases u, v
        (H, D): q, k, v with biases, p(r) = PE(r) W_pos without one,
        score[i, j] = ((q_i + u) . k_j + (q_i + v) . p(i - j)) / sqrt(D),
        softmax over the keys, out = sum_j a_ij v_j, Linear with a bias;
        PE(r)[2m] = sin(r 10000^(-2m/d)), PE(r)[2m + 1] = cos(...);
  Conv: Linear(d, 2d) -> GLU -> padded frames zeroed -> depthwise conv (K,
        'same', bias) -> BatchNorm (running statistics, eps 1e-5) -> Swish ->
        Linear(d, d);
  head: log_softmax(W x + b) over vocab + 1 classes (blank last).

The position term is computed the obvious way: for each query row i and key
j, the dot product of q_i + v with p(i - j), p taken by the index i - j from
the table of every relative position, in blocks of query rows so that it
fits (no shift trick).  The table is computed in float64 and rounded to
fp32.  TF32 is off (`layers.fp32_products`, which the judge opens).

Departures from NeMo: dropout is left out (inference); padded keys get
NeMo's fill of -10000 and padded query rows give zeros, as NeMo's masked
softmax does; the flattened subsampling output has its channels minor (the
port's layout: a NeMo checkpoint's weight would be permuted, with seeded
weights it is the same model); the weights are drawn from the seed (the
published `.nemo` file is not in the repository) and the windows are
lcasr's averaged moving-window decode's, not NeMo's buffered inference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lcbench.reference.layers import (
    dw_striding, layer_norm, length_mask, linear, subsampled_lengths)

MASKED = -10000.0  # NeMo's fill of a padded key's score
BLOCK = 256  # query rows a block of the attention


def position_table(n: int, d_model: int, device=None) -> torch.Tensor:
    """(2n - 1, d_model): row r + n - 1 is PE(r), for r = -(n - 1) .. n - 1."""
    r = torch.arange(-(n - 1), n, dtype=torch.float64, device=device)
    m = torch.arange(0, d_model, 2, dtype=torch.float64, device=device)
    ang = r[:, None] * torch.exp(-m * math.log(10000.0) / d_model)[None, :]
    pe = torch.empty((2 * n - 1, d_model), dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.float()


def rel_pos_attention(q, k, v, p, u, vb, lengths, block: int = BLOCK):
    """q, k, v (B, T, H, D); p (2T - 1, H, D) by relative position r at row
    r + T - 1; u, vb (H, D) -> (B, T, H, D), rows past each length zero."""
    B, T, H, D = q.shape
    valid = length_mask(lengths, T)
    outs = []
    for i0 in range(0, T, block):
        i1 = min(T, i0 + block)
        qb = q[:, i0:i1]
        content = torch.einsum("bihd,bjhd->bhij", qb + u, k)
        # rows i0..i1-1 meet r = i - j from i0 - (T - 1) to i1 - 1: table rows i0 .. i1 + T - 2
        dots = torch.einsum("bihd,rhd->bhir", qb + vb, p[i0:i1 + T - 1])
        i = torch.arange(i1 - i0, device=q.device)[:, None]
        j = torch.arange(T, device=q.device)[None, :]
        index = (i - j + T - 1).expand(B, H, i1 - i0, T)  # the column of p(i - j)
        position = torch.gather(dots, -1, index)
        s = (content + position) / math.sqrt(D)
        s = s.masked_fill(~valid[:, None, None, :], MASKED)
        a = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhij,bjhd->bihd", a, v))
    out = torch.cat(outs, dim=1)
    return torch.where(valid[:, :, None, None], out, 0.0)


def _ff(x, p, pre):
    h = F.silu(linear(x, p[f"{pre}.fc1.weight"], p[f"{pre}.fc1.bias"]))
    return linear(h, p[f"{pre}.fc2.weight"], p[f"{pre}.fc2.bias"])


def _attention(h, pe, lengths, p, a, cfg):
    """The relative-position attention op of the module `a` on its input h:
    (B, T', H, D), before the output projection."""
    B, N, _ = h.shape
    H, D = cfg["n_heads"], cfg["head_dim"]
    q, k, v = (linear(h, p[f"{a}.linear_{n}.weight"], p[f"{a}.linear_{n}.bias"]).view(B, N, H, D)
               for n in ("q", "k", "v"))
    pos = linear(pe, p[f"{a}.linear_pos.weight"]).view(2 * N - 1, H, D)
    return rel_pos_attention(q, k, v, pos, p[f"{a}.pos_bias_u"], p[f"{a}.pos_bias_v"], lengths)


def _layer(x, pe, lengths, p, pre, cfg, stats):
    def ln(h, name):
        return layer_norm(h, p[f"{pre}.{name}.scale"], p[f"{pre}.{name}.bias"])

    B, N, d = x.shape
    mask = length_mask(lengths, N)
    x = _ff(ln(x, "ff1_norm"), p, f"{pre}.ff1") * 0.5 + x

    a = f"{pre}.attend"
    o = _attention(ln(x, "attn_norm"), pe, lengths, p, a, cfg)
    x = linear(o.reshape(B, N, -1), p[f"{a}.linear_out.weight"], p[f"{a}.linear_out.bias"]) + x

    c = f"{pre}.conv"
    h = linear(ln(x, "conv_norm"), p[f"{c}.pointwise_conv1.weight"], p[f"{c}.pointwise_conv1.bias"])
    g1, g2 = h.chunk(2, dim=-1)
    h = (g1 * torch.sigmoid(g2)).masked_fill(~mask[..., None], 0.0)
    kern = p[f"{c}.depthwise_kernel"]
    h = F.conv1d(h.transpose(1, 2), kern, p[f"{c}.depthwise_bias"],
                 padding=(kern.shape[-1] - 1) // 2, groups=kern.shape[0]).transpose(1, 2)
    h = ((h - stats["running_mean"]) / torch.sqrt(stats["running_var"] + 1e-5)
         * p[f"{c}.norm.weight"] + p[f"{c}.norm.bias"])
    x = linear(F.silu(h), p[f"{c}.pointwise_conv2.weight"], p[f"{c}.pointwise_conv2.bias"]) + x
    x = _ff(ln(x, "ff2_norm"), p, f"{pre}.ff2") * 0.5 + x
    return ln(x, "norm_out")


def _encoder_input(p, cfg, audio, lengths):
    """(x (B, T', d), T' lengths, the position table) after the subsampling."""
    x = dw_striding(audio.transpose(1, 2).float(), p, "subsampling", act=F.relu)
    lengths = subsampled_lengths(lengths)
    if cfg.get("xscaling", True):
        x = x * math.sqrt(cfg["d_model"])
    return x, lengths, position_table(x.shape[1], cfg["d_model"], x.device)


def forward(p, cfg, audio, lengths, stats=None):
    """audio (B, 80, T), lengths (B,) -> (log-probs (B, T', V + 1), T' lengths).
    `stats`: {layer prefix: {running_mean, running_var}} (`eval_stats`)."""
    stats = eval_stats(p, cfg) if stats is None else stats
    x, lengths, pe = _encoder_input(p, cfg, audio, lengths)
    for i in range(cfg["n_layers"]):
        pre = f"layers.{i}"
        x = _layer(x, pe, lengths, p, pre, cfg, stats[f"{pre}.conv.norm"])
    logits = linear(x, p["decoder.weight"], p["decoder.bias"])
    return torch.log_softmax(logits, dim=-1), lengths


def first_attention(p, cfg, audio, lengths):
    """The first layer's relative-position attention op's output (B, T', H,
    D) for audio (B, 80, T): the judge's probe of the mechanism, which the
    seeded deep model's output barely shows (PERF.md)."""
    x, lengths, pe = _encoder_input(p, cfg, audio, lengths)
    x = _ff(layer_norm(x, p["layers.0.ff1_norm.scale"], p["layers.0.ff1_norm.bias"]), p,
            "layers.0.ff1") * 0.5 + x
    h = layer_norm(x, p["layers.0.attn_norm.scale"], p["layers.0.attn_norm.bias"])
    return _attention(h, pe, lengths, p, "layers.0.attend", cfg)


def eval_stats(p, cfg):
    """The running statistics of every layer's BatchNorm, as the weights hold
    them."""
    return {f"layers.{i}.conv.norm": {
        "running_mean": p[f"layers.{i}.conv.norm.running_mean"],
        "running_var": p[f"layers.{i}.conv.norm.running_var"]}
        for i in range(cfg["n_layers"])}
