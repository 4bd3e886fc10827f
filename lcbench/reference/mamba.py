"""The bidirectional-Mamba CTC model, plain and in fp32.

  8x dw_striding subsampling -> n x (x + mixer(RMSNorm x)) -> RMSNorm ->
  CTC head (which norms again), with self-conditioning after every block
  but the last, through the head's norm.
  mixer: in_proj (no bias) -> (x, z); x halves into a forward and a reverse
  half, the reverse one flipped within each row's length; each half its own
  causal depthwise conv (K 4) and SiLU; both halves share the selective
  scan (delta = softplus(dt W_dt + b_dt) from x_proj's first dt_rank
  outputs, B and C its next two d_state; A = -exp(A_log); skip D); the
  reverse half flipped back; y_out over the joined halves; gated by
  SiLU(z); out_proj.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lcbench.reference.layers import (
    causal_conv1d, dw_striding, flip_with_lengths, linear, rms_norm, selective_scan,
    subsampled_lengths)


def _mixer(x, lengths, p, pre, cfg, q):
    xs, z = linear(x, p[f"{pre}.in_proj.weight"], None, q).chunk(2, dim=-1)
    x_f, x_r = xs.chunk(2, dim=-1)
    x_r = flip_with_lengths(x_r, lengths)
    x_all = torch.cat([F.silu(causal_conv1d(x_f, p[f"{pre}.conv1d_fwd_kernel"],
                                            p[f"{pre}.conv1d_fwd_bias"])),
                       F.silu(causal_conv1d(x_r, p[f"{pre}.conv1d_rvse_kernel"],
                                            p[f"{pre}.conv1d_rvse_bias"]))], dim=0)
    N = p[f"{pre}.A_log"].shape[1]
    R = p[f"{pre}.dt_proj_kernel"].shape[0]
    dt, Bs, Cs = linear(x_all, p[f"{pre}.x_proj.weight"], None, q).split([R, N, N], dim=-1)
    delta = F.softplus(dt @ p[f"{pre}.dt_proj_kernel"] + p[f"{pre}.dt_proj_bias"])
    y = selective_scan(x_all, delta, -torch.exp(p[f"{pre}.A_log"]), Bs, Cs, p[f"{pre}.D"])
    y_f, y_r = y.chunk(2, dim=0)
    y = linear(torch.cat([y_f, flip_with_lengths(y_r, lengths)], dim=-1),
               p[f"{pre}.y_out.weight"], None, q)
    return linear(y * F.silu(z), p[f"{pre}.out_proj.weight"], None, q)


def forward(p, cfg, audio, lengths, train=False, stats=None, q=None, remat=False):
    """audio (B, 80, T), lengths (B,) -> (log-probs (B, T', V + 1), T' lengths)."""
    if train:
        raise NotImplementedError("the reference trains the conformer only")
    x = dw_striding(audio.transpose(1, 2).float(), p, "subsampling", q)
    lengths = subsampled_lengths(lengths)

    def head(h):
        return linear(rms_norm(h, p["decoder.norm.scale"]), p["decoder.ff.weight"],
                      p["decoder.ff.bias"], q)

    for i in range(cfg["n_layers"]):
        pre = f"layers.{i}"
        x = _mixer(rms_norm(x, p[f"{pre}.norm.scale"]), lengths, p, f"{pre}.mixer", cfg, q) + x
        if i != cfg["n_layers"] - 1 and cfg.get("self_conditioning", True):
            posts = torch.softmax(head(x), -1)
            x = x + linear(posts, p["decoder.reprojection.weight"],
                           p["decoder.reprojection.bias"], q)
    x = rms_norm(x, p["decoder.norm.scale"])
    return torch.log_softmax(head(x), dim=-1), lengths


def eval_stats(p, cfg):
    return {}
