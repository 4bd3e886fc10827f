"""lcasr_torch's flash-attention backward against lcasr_tpu's, on the CPU in
fp32.

The JAX side runs its Pallas kernels in interpret mode (as the JAX
package's own tests run them on the CPU): `jax.grad` through
`flash_attention`'s custom VJP, and the public `flash_attention_bwd` with
an external (o, lse).  The port's side is its autograd Function and
`flash_attention_bwd`, which on CPU tensors run `flash_attention_bwd_ref`,
the plain version of the K3/K4/K5 kernels.

Tolerance: both sides compute in fp32 from the same inputs; sums over up to
~200 keys of O(1) terms in another order differ by a few 1e-7, and the
gradients here are O(1), so 1e-5 absolute keeps a wide margin while a
wrong mask, scale or sign moves them by 1e-2 or more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_tpu.ops import flash_attention as jfa
from lcasr_torch.ops import flash_attention as tfa

ATOL = 1e-5

# (name, B, T, H, D, lengths, window, q_offset, kv_offset)
CASES = [
    ("ragged_zero", 3, 150, 2, 32, [150, 97, 0], (-1, -1), 0, 0),
    ("T_not_tile_multiple", 2, 200, 1, 64, [200, 133], (-1, -1), 0, 0),
    ("band", 2, 160, 2, 32, [160, 120], (24, 16), 0, 0),
    ("band_left_only", 1, 130, 2, 32, [101], (20, -1), 0, 0),
    ("offsets", 2, 140, 1, 32, [160, 90], (-1, -1), 17, 9),
    ("offsets_band", 2, 140, 1, 32, [150, 120], (30, 20), 17, 9),
    ("D128", 1, 140, 2, 128, [140], (-1, -1), 0, 0),
    # the edges of the bf16 backward's tiles on the card (128 keys per CTA,
    # 64-row q tiles), where the kernels must mask exactly as this does
    ("T63", 2, 63, 1, 32, [63, 40], (-1, -1), 0, 0),
    ("T65", 2, 65, 1, 32, [65, 64], (-1, -1), 0, 0),
    ("T191", 1, 191, 2, 32, [191], (-1, -1), 0, 0),
    ("T257", 1, 257, 1, 32, [200], (-1, -1), 0, 0),
    ("offsets_64", 1, 130, 1, 32, [194], (-1, -1), 64, 64),
    ("offsets_128_band", 1, 130, 1, 32, [300], (64, 24), 128, 128),
    ("left_window_on_q_tile_edge", 1, 192, 1, 32, [192], (64, -1), 0, 0),
    # the edges of K4's tiles on the card (128 q rows per CTA, a walk over
    # 64-key tiles); the two-sided bands take JAX's split path through
    # `_bwd_dq_kernel`, as they take K4 + K5 on the card
    ("T127", 1, 127, 1, 32, [127], (-1, -1), 0, 0),
    ("T129", 2, 129, 1, 32, [129, 128], (-1, -1), 0, 0),
    ("T255", 1, 255, 1, 32, [200], (-1, -1), 0, 0),
    ("T383", 1, 383, 1, 32, [383], (-1, -1), 0, 0),
    ("band_edge_in_128_q_tile", 1, 300, 1, 32, [290], (100, 72), 0, 0),
    ("offsets_128_band_across_tiles", 1, 260, 1, 32, [420], (96, 40), 128, 128),
    # head_dim 256 (lcasr_6l_768d_3h): on the card K3 / K5 take 64-key CTAs
    # and K4 32-key tiles there; the JAX `_bwd_impl` shrinks its blocks
    ("D256_ragged_T_off_tiles", 2, 100, 1, 256, [100, 37], (-1, -1), 0, 0),
    ("D256_band", 1, 130, 1, 256, [130], (20, 12), 0, 0),
    ("D256_offsets", 2, 97, 1, 256, [120, 70], (-1, -1), 33, 20),
]


def _inputs(B, T, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_autograd_matches_jax_grad(case):
    _, B, T, H, D, lengths, window, qo, ko = case
    q, k, v, do = _inputs(B, T, H, D)
    lens = np.asarray(lengths, np.int32)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, lengths=jnp.asarray(lens), window=window,
                                q_offset=jnp.int32(qo), kv_offset=jnp.int32(ko))
        return (o * do).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(qt, kt, vt, lengths=torch.from_numpy(lens), window=window,
                            q_offset=qo, kv_offset=ko)
    got = torch.autograd.grad((o * torch.from_numpy(do)).sum(), (qt, kt, vt))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bwd_with_external_o_lse_matches_jax(case):
    """The public backward with an external (o, lse) pair, the form ring
    attention reuses; o and lse from the JAX forward go into both."""
    _, B, T, H, D, lengths, window, qo, ko = case
    q, k, v, do = _inputs(B, T, H, D, seed=1)
    lens = jnp.asarray(np.asarray(lengths, np.int32))
    kw = dict(lengths=lens, window=window, q_offset=jnp.int32(qo), kv_offset=jnp.int32(ko))
    o, lse = jfa.flash_attention_with_lse(q, k, v, **kw)
    want = jfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = tfa.flash_attention_bwd(t(q), t(k), t(v), t(o), t(lse), t(do),
                                  lengths=t(lens), window=window, q_offset=qo, kv_offset=ko)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_zero_length_rows_get_zero_gradients_without_nan():
    """Finished samples (length 0) carry lse = -1e30: the select keeps
    exp(s + 1e30) = inf away from every gradient."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 70, 2, 32, seed=2))
    lens = torch.tensor([70, 0], dtype=torch.int32)
    o, lse = tfa.flash_attention_with_lse(q, k, v, lens)
    assert (lse[1] == -1e30).all()
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, lens)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all() and (g[1] == 0).all() and (g[0] != 0).any()


@pytest.mark.parametrize("window,env,fused", [((-1, -1), "1", True), ((-1, -1), "0", False),
                                              ((8, 8), "1", False), ((8, -1), "1", True)])
def test_kernel_choice_follows_the_jax_gate(monkeypatch, window, env, fused):
    """K3 unless the band is two-sided or LCASR_FUSED_ATTN_BWD=0."""
    monkeypatch.setenv("LCASR_FUSED_ATTN_BWD", env)
    assert tfa._fused_bwd(window) is fused


# the same edges, on the card: chip_smoke.py holds K3 and K4 + K5 against
# flash_attention_bwd_ref on every case of `attention_cases` and
# `bwd_d256_cases`
BWD_TILE_EDGES = {"T": (63, 65, 191, 257), "offsets": (64, 128)}
# and those of K4's: 128 q rows per CTA, 64-key tiles
K4_TILE_EDGES = {"T": (127, 129, 255, 383), "banded_D": (128, 64, 32)}


def test_chip_smoke_attention_cases_hold_the_backward_tile_edges():
    import chip_smoke

    bf16 = [c for c in chip_smoke.attention_cases(torch) + chip_smoke.bwd_d256_cases(torch)
            if c[5] == torch.bfloat16]
    two_sided = lambda c: c[7][0] >= 0 and c[7][1] >= 0  # noqa: E731  (K4 + K5 only)
    for T in BWD_TILE_EDGES["T"]:
        assert any(c[2] == T and not two_sided(c) for c in bf16), T  # K3 and K4 + K5
    for off in BWD_TILE_EDGES["offsets"]:
        assert any(c[8] == c[9] == off for c in bf16), off
    # a left window whose rows start on a 64-row edge, on K3's route
    assert any(c[7][0] > 0 and c[7][0] % 64 == 0 and c[7][1] < 0 for c in bf16)
    # a band edge inside a 64-row q tile, on both routes
    assert any(two_sided(c) and c[7][1] % 64 for c in bf16)
    assert any(c[7][0] < 0 <= c[7][1] and c[7][1] % 64 for c in bf16)
    # every head dim the backward kernels take
    assert {c[4] for c in bf16} == set(tfa.BWD_KERNEL_HEAD_DIMS)
    # K4's tile edges (both routes take the unbanded ones)
    for T in K4_TILE_EDGES["T"]:
        assert any(c[2] == T for c in bf16), T
    # a two-sided band whose edges cut 128-row q tiles (K4 + K5 only)
    assert any(two_sided(c) and c[7][0] % 128 and c[7][1] % 128 and c[2] > 256 for c in bf16)
    # a shard at q / kv offset 128 under a two-sided band
    assert any(two_sided(c) and c[8] == c[9] == 128 for c in bf16)
    # every head dim under a two-sided band
    for D in K4_TILE_EDGES["banded_D"]:
        assert any(two_sided(c) and c[4] == D for c in bf16), D


def test_bwd_experiment_patches_apply_to_the_source():
    """scripts/attention_bwd_experiments.py patches copies of the backward's
    source: every planted fault and design variant must still find its text
    exactly once, or the script measures nothing."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "attention_bwd_experiments", os.path.join(root, "scripts", "attention_bwd_experiments.py"))
    exp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exp)
    source = open(os.path.join(root, exp.SOURCE)).read()
    for name, patches in {**exp.CONTROLS, **exp.VARIANTS}.items():
        text = source
        for old, new in patches:
            assert text.count(old) == 1, (name, old[:60])
            text = text.replace(old, new)
        assert text != source, name
