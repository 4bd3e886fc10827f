"""Model FLOPs of the work a cell does, from the configuration's widths and
the windows or rows it ran: the yardstick of `mfu.*`.

Counted: every matrix product (2 operations a multiply-add), the attention's
4 T'^2 D a head and layer over the pairs the lengths leave valid, the
subsampling's convolutions and the depthwise convolutions.  Not counted:
elementwise work, norms, softmaxes, the scan's recurrence (it is no matrix
product; `scan_fwd_roofline` measures it).  A training step is three times
its forward (the backward's two products for each of the forward's), less
the input gradient of the first convolution, which the data does not need;
recomputed work is not counted.
"""
from __future__ import annotations

import math


def subsampled(n: int, factor: int = 8) -> int:
    """Output frames of the 8x dw_striding subsampling (`calc_length`)."""
    for _ in range(int(math.log2(factor))):
        n = (n - 1) // 2 + 1
    return int(n)


def subsampling_flops(T: int, feat_in: int, C: int, d_model: int) -> dict:
    """{'conv_in', 'rest'}: the first conv (1 -> C, 3x3 stride 2) and the two
    depthwise + pointwise stages and the output projection, for one row of
    T frames."""
    t0, t1, t2 = (T + 1) // 2, (T + 3) // 4, (T + 7) // 8
    f0, f1, f2 = (feat_in + 1) // 2, (feat_in + 3) // 4, (feat_in + 7) // 8
    conv_in = 2 * t0 * f0 * C * 9
    rest = 2 * (t1 * f1 + t2 * f2) * C * (9 + C) + 2 * t2 * (f2 * C) * d_model
    return {"conv_in": conv_in, "rest": rest}


def conformer_forward(cfg: dict, T: int) -> float:
    """One row of T true input frames through SCConformerXL."""
    d, H, Dh = cfg["d_model"], cfg["n_heads"], cfg["head_dim"]
    L, V = cfg["n_layers"], cfg["vocab_size"] + 1
    K = cfg.get("conv_kernel_size", 9)
    Tp = subsampled(T)
    sub = subsampling_flops(T, cfg.get("feat_in", 80), cfg["subsampling_conv_channels"], d)
    inner = 4 * d  # the feed-forward's hidden width
    per_layer = (2 * 2 * Tp * d * inner * 2      # two feed-forwards, two products each
                 + 2 * Tp * d * 3 * H * Dh      # qkv
                 + 2 * Tp * H * Dh * d          # attention output
                 + 4 * H * Dh * Tp ** 2         # scores and values
                 + 2 * Tp * d * 2 * d           # conv pointwise 1 (to the GLU)
                 + 2 * Tp * d * K               # depthwise
                 + 2 * Tp * d * d)              # conv pointwise 2
    selfcond = (L - 1) * 2 * (2 * Tp * d * V) if cfg.get("self_conditioning", True) else 0
    head = 2 * Tp * d * V
    return sub["conv_in"] + sub["rest"] + L * per_layer + selfcond + head


def mamba_forward(cfg: dict, T: int) -> float:
    """One row of T true input frames through the bidirectional Mamba."""
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab_size"] + 1
    d_inner = cfg.get("expand", 2) * d
    half = d_inner // 2
    N, R, K = cfg.get("d_state", 16), cfg.get("dt_rank", math.ceil(d / 16)), cfg.get("d_conv", 4)
    Tp = subsampled(T)
    sub = subsampling_flops(T, cfg.get("feat_in", 80), cfg["subsampling_conv_channels"], d)
    per_layer = (2 * Tp * d * 2 * d_inner        # in_proj
                 + 2 * 2 * Tp * half * K         # the two causal depthwise convs
                 + 2 * 2 * Tp * half * (R + 2 * N)  # x_proj of both directions
                 + 2 * 2 * Tp * R * half         # dt projection of both directions
                 + 2 * Tp * d_inner * d_inner    # y_out
                 + 2 * Tp * d_inner * d)         # out_proj
    selfcond = (L - 1) * 2 * (2 * Tp * d * V) if cfg.get("self_conditioning", True) else 0
    head = 2 * Tp * d * V
    return sub["conv_in"] + sub["rest"] + L * per_layer + selfcond + head


FORWARD = {"SCConformerXL": conformer_forward, "Mamba": mamba_forward}


def forward_flops(model_class: str, cfg: dict, frames: int) -> float:
    """One row's forward over its true length in frames (padding is not
    useful work, and a row of length 0 is none)."""
    return FORWARD[model_class](cfg, frames) if frames > 0 else 0.0


def train_step_flops(model_class: str, cfg: dict, lengths) -> float:
    """Forward and backward of one batch of rows with these true lengths
    (in frames): three times the forward, less the first conv's input
    gradient."""
    total = 0.0
    for n in lengths:
        if n > 0:
            conv_in = subsampling_flops(int(n), cfg.get("feat_in", 80),
                                        cfg["subsampling_conv_channels"], cfg["d_model"])
            total += 3 * forward_flops(model_class, cfg, int(n)) - conv_in["conv_in"]
    return total
