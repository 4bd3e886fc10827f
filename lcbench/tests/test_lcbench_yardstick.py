"""The yardstick: the copied bounds against the numbers the repository's
kernel table gives, the FLOP counts against a hand count, and the idle
share as a union of intervals."""
import math

import pytest

from lcbench.harness import bounds, flops, trace


def test_attention_bound_is_k1s():
    ms, by, fl = bounds.attention_bound(16, 2048, 6, 128)
    assert by == "operations"
    assert round(ms, 4) == 0.2085
    assert fl == 4 * 6 * 128 * 16 * 2048 ** 2


def test_attention_bound_counts_valid_pairs_only():
    full = bounds.attention_bound(2, 2048, 6, 128)[2]
    half = bounds.attention_bound(2, 2048, 6, 128, lengths=[2048, 0])[2]
    assert half * 2 == full
    assert bounds.valid_pairs([3, 5], 8, 8, (-1, -1), 0, 0) == 9 + 25


def test_backward_bound_is_k3s():
    assert round(bounds.attention_bwd_bound(4, 2048, 6, 128)[0], 4) == 0.1303


def test_scan_bound_is_k6s():
    ms, by = bounds.ssm_bound("fwd", (32, 2048, 768, 16), 4, 2, False, 132, 1.98e9)
    assert by == "operations"
    assert round(ms, 4) == 0.1926


def test_subsampling_bound_is_k8s():
    ms, by, parts, _ = bounds.sub_bound(16, 16384, 80, 256, 2, "bf16", 132, 1.98e9)
    assert round(ms, 4) == 0.4213
    assert parts["by"] == "special functions"


FLAGSHIP = dict(d_model=768, n_heads=6, head_dim=128, n_layers=9, vocab_size=4095,
                subsampling_conv_channels=256, conv_kernel_size=9, self_conditioning=True)
MAMBA = dict(d_model=768, n_layers=6, vocab_size=4095, subsampling_conv_channels=256,
             self_conditioning=True)


def _subsampling_by_hand(T=16384, C=256, d=768):
    # 3x3 stride-2 convs on (T, 80): (8192, 40) then (4096, 20) then (2048, 10)
    return (2 * 8192 * 40 * C * 9 + 2 * 4096 * 20 * C * (9 + C)
            + 2 * 2048 * 10 * C * (9 + C) + 2 * 2048 * 10 * C * d)


def test_flagship_flops_by_hand():
    n, d, V = 2048, 768, 4096
    layer = (2 * n * d * 3072 * 4          # two feed-forwards of two products
             + 2 * n * d * 3 * d + 2 * n * d * d  # qkv and output
             + 4 * d * n * n               # scores and values, 6 heads of 128
             + 2 * n * d * 2 * d + 2 * n * d * 9 + 2 * n * d * d)  # the conv module
    head = 2 * n * d * V
    total = _subsampling_by_hand() + 9 * layer + 8 * 2 * head + head
    assert flops.forward_flops("SCConformerXL", FLAGSHIP, 16384) == total
    assert math.isclose(total, 8.63e11, rel_tol=0.01)


def test_mamba_flops_by_hand():
    n, d, di, V = 2048, 768, 1536, 4096
    layer = (2 * n * d * 2 * di + 2 * 2 * n * 768 * 4 + 2 * 2 * n * 768 * (48 + 32)
             + 2 * 2 * n * 48 * 768 + 2 * n * di * di + 2 * n * di * d)
    head = 2 * n * d * V
    total = _subsampling_by_hand() + 6 * layer + 5 * 2 * head + head
    assert flops.forward_flops("Mamba", MAMBA, 16384) == total


def test_training_step_is_three_forwards_less_the_data_gradient():
    fwd = flops.forward_flops("SCConformerXL", FLAGSHIP, 16384)
    conv_in = 2 * 8192 * 40 * 256 * 9
    assert flops.train_step_flops("SCConformerXL", FLAGSHIP, [16384, 16384, 0]) == \
        2 * (3 * fwd - conv_in)


def test_idle_share_is_a_union_not_a_sum():
    # kernels on two streams overlap on [1, 2) and [4.25, 4.5): their times
    # sum to 4.75, their union is 3.5, and an empty one splits no gap
    kernels = [(0.0, 2.0), (1.0, 3.0), (4.0, 4.5), (4.25, 4.5), (5.0, 5.0)]
    assert trace.union_length(kernels) == pytest.approx(3.5)
    assert trace.idle_gaps(kernels, 0.0, 6.0) == [(3.0, 4.0), (4.5, 6.0)]
    assert trace.union_length([]) == 0.0
