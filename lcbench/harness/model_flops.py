"""Model FLOPs of the configurations that name their FLOP function by the
`flops` key of their file (the yardstick of their `mfu.*`), counted as
`flops.py` counts the others: every matrix product (2 operations a
multiply-add), the attention's products over the pairs the lengths leave
valid, the subsampling's and the depthwise convolutions; no elementwise
work, norms or softmaxes.
"""
from __future__ import annotations

from lcbench.harness.flops import subsampled, subsampling_flops


def fastconformer_forward(cfg: dict, T: int) -> float:
    """One window of T true input frames through FastConformerCTC: per layer
    two feed-forwards, q / k / v / out, `linear_pos` over the 2T' - 1
    relative positions, the attention's three products of 2 T'^2 D a head
    (content term, position term, weighted values), the conv module; then
    the CTC head."""
    d, H, Dh = cfg["d_model"], cfg["n_heads"], cfg["head_dim"]
    L, V = cfg["n_layers"], cfg["vocab_size"] + 1
    K = cfg.get("conv_kernel_size", 9)
    inner = cfg.get("ff_expansion_factor", 4) * d
    Tp = subsampled(T)
    sub = subsampling_flops(T, cfg.get("feat_in", 80), cfg["subsampling_conv_channels"], d)
    per_layer = (2 * 2 * Tp * d * inner * 2        # two feed-forwards, two products each
                 + 2 * Tp * d * 4 * H * Dh        # q, k, v and out
                 + 2 * (2 * Tp - 1) * d * H * Dh  # linear_pos
                 + 6 * H * Dh * Tp ** 2           # content, position, values
                 + 2 * Tp * d * 2 * d             # conv pointwise 1 (to the GLU)
                 + 2 * Tp * d * K                 # depthwise
                 + 2 * Tp * d * d)                # conv pointwise 2
    return sub["conv_in"] + sub["rest"] + L * per_layer + 2 * Tp * d * V


FORWARD = {"fastconformer": fastconformer_forward}


def forward_flops(name: str, cfg: dict, frames: int) -> float:
    """One window's forward over its true length in frames (0 for none)."""
    return FORWARD[name](cfg, frames) if frames > 0 else 0.0
