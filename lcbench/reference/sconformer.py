"""The self-conditioned CTC conformer (SCConformerXL), plain and in fp32.

  8x dw_striding subsampling -> n x conformer layer -> CTC head, with
  self-conditioning after every layer but the last:
  layer: x += 1/2 FF1(LN x); x += MHSA(LN x) with rotary q, k;
         x += Conv(LN x); x += 1/2 FF2(LN x); x = LN x
  FF: Linear(d, 4d) -> tanh GELU -> Linear(4d, d), no biases;
  MHSA: fused qkv (no bias, (3, H, D) packing), padded frames zeroed before
        it and after it, output projection without bias;
  Conv: Linear(d, 2d) -> GLU -> padded frames zeroed -> depthwise conv (K,
        'same') -> batch renorm -> SiLU -> Linear(d, d);
  self-conditioning: x += W_back softmax(W_out x + b_out) + b_back;
  head: log_softmax(W_out x + b_out) over vocab + 1 classes (blank last).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lcbench.reference.layers import (
    attention, batch_renorm, dw_striding, gelu_tanh, layer_norm, length_mask, linear,
    rotary_tables, rotate, subsampled_lengths)


def _ff(x, p, pre, q):
    return linear(gelu_tanh(linear(x, p[f"{pre}.fc1.weight"], None, q)),
                  p[f"{pre}.fc2.weight"], None, q)


def _layer(x, lengths, cos, sin, p, pre, cfg, stats, train, q, remat):
    def ln(h, name):
        return layer_norm(h, p[f"{pre}.{name}.scale"], p[f"{pre}.{name}.bias"])

    B, N, d = x.shape
    H, D = cfg["n_heads"], cfg["head_dim"]
    mask = length_mask(lengths, N)
    x = _ff(ln(x, "ff1_norm"), p, f"{pre}.ff1", q) * 0.5 + x
    h = ln(x, "attn_norm").masked_fill(~mask[..., None], 0.0)
    qkv = linear(h, p[f"{pre}.attend.qkv_proj.weight"], None, q).view(B, N, 3, H, D)
    qh, kh, vh = qkv.unbind(2)
    qh, kh = rotate(qh, cos, sin), rotate(kh, cos, sin)
    o = attention(qh, kh, vh, lengths, q, remat=remat)
    o = o.reshape(B, N, H * D).masked_fill(~mask[..., None], 0.0)
    x = linear(o, p[f"{pre}.attend.out_proj.weight"], None, q) + x
    h = linear(ln(x, "conv_norm"), p[f"{pre}.conv.pointwise_conv1.weight"],
               p[f"{pre}.conv.pointwise_conv1.bias"], q)
    a, g = h.chunk(2, dim=-1)
    h = (a * torch.sigmoid(g)).masked_fill(~mask[..., None], 0.0)
    k = p[f"{pre}.conv.depthwise_kernel"]
    h = F.conv1d(h.transpose(1, 2), k, p[f"{pre}.conv.depthwise_bias"],
                 padding=(k.shape[-1] - 1) // 2, groups=k.shape[0]).transpose(1, 2)
    h = batch_renorm(h, p, f"{pre}.conv.norm", ~mask, stats, train)
    x = linear(F.silu(h), p[f"{pre}.conv.pointwise_conv2.weight"],
               p[f"{pre}.conv.pointwise_conv2.bias"], q) + x
    x = _ff(ln(x, "ff2_norm"), p, f"{pre}.ff2", q) * 0.5 + x
    return ln(x, "norm_out")


def forward(p, cfg, audio, lengths, train=False, stats=None, q=None, remat=False):
    """audio (B, 80, T), lengths (B,) -> (log-probs (B, T', V + 1), T' lengths).
    `stats`: {layer prefix: batch-renorm state}, the running statistics
    (read in eval; in training their next values are left in it);
    `remat`: every layer recomputed in the backward (memory only)."""
    x = dw_striding(audio.transpose(1, 2).float(), p, "subsampling", q)
    lengths = subsampled_lengths(lengths)
    N = x.shape[1]
    cos, sin = rotary_tables(N, cfg["head_dim"], cfg["rotary_base_freq"],
                             cfg.get("rotary_interpolation_factor", 1.0), x.device)
    for i in range(cfg["n_layers"]):
        pre = f"layers.{i}"
        args = (lengths, cos, sin, p, pre, cfg, stats[f"{pre}.conv.norm"], train, q, remat)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, *args, use_reentrant=False)
        else:
            x = _layer(x, *args)
        if i != cfg["n_layers"] - 1 and cfg.get("self_conditioning", True):
            posts = torch.softmax(linear(x, p["decoder.ff.weight"], p["decoder.ff.bias"], q), -1)
            x = x + linear(posts, p["decoder.reprojection.weight"],
                           p["decoder.reprojection.bias"], q)
    logits = linear(x, p["decoder.ff.weight"], p["decoder.ff.bias"], q)
    return torch.log_softmax(logits, dim=-1), lengths


def eval_stats(p, cfg):
    """The running statistics of every batch-renorm layer, as the weights hold
    them."""
    return {f"layers.{i}.conv.norm": {
        "running_mean": p[f"layers.{i}.conv.norm.running_mean"],
        "running_std": p[f"layers.{i}.conv.norm.running_std"], "steps": 0}
        for i in range(cfg["n_layers"])}
