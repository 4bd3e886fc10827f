"""The attention forward at the edges of the bf16 kernels' 128 x 128 tiles,
and the layout rules of their TMA tensor maps.

The CUDA kernels K1 and K2 cannot run here; what the CPU can hold is the
rest of the chain.  Their plain version `flash_attention_ref` is held against
the JAX `flash_attention_with_lse` (Pallas in interpret mode, as
tests/test_flash_attention.py runs it) at the shapes whose tiling changed:
lengths one below and one above a tile edge, a left window whose first
visited tile starts on an edge, a shard offset by one tile.  Some cases run
under LCASR_ATTN_FWD_DB=1, where the JAX side takes its double-buffered
kernel.  Both sides are fp32 with the same pre-scaled q: atol 1e-5.
`chip_smoke.py` holds the kernels against the same plain version on the card
at these cases (D = 128 there; D = 32 here keeps the interpreter fast), and
at D = 256 (`chip_smoke.d256_cases`; a few such cases here too).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ATOL = 1e-5

EDGE_CASES = {  # B = 2, H = 2, D = 32
    "T127": dict(T=127, lengths=[127, 100]),
    "T129": dict(T=129, lengths=[129, 128]),
    "T255": dict(T=255, lengths=[255, 129]),
    "T257": dict(T=257, lengths=[257, 256]),
    "T257_no_lengths": dict(T=257),
    "T129_zero_length": dict(T=129, lengths=[129, 0]),
    # global rows 256.. need keys from 128 on: the first visited tile
    # starts exactly on a tile edge
    "left_window_on_tile_edge": dict(T=257, lengths=[385, 300], window=(128, -1), q_offset=128),
    "shard_offsets_128": dict(T=255, lengths=[383, 300], window=(64, -1), q_offset=128,
                              kv_offset=128),
    "band_across_tile_edge": dict(T=257, lengths=[257, 200], window=(3, 5)),
}
DB_CASES = ("T129", "T257", "left_window_on_tile_edge", "shard_offsets_128")


def _run_case(kw, seed, D=32):
    from lcasr_tpu.ops.flash_attention import flash_attention_with_lse as pallas_fwd
    from lcasr_torch.ops.flash_attention import flash_attention_ref, flash_attention_with_lse

    rng = np.random.default_rng(seed)
    B, T, H = 2, kw["T"], 2
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    lengths = np.asarray(kw["lengths"], np.int32) if "lengths" in kw else None
    window = kw.get("window", (-1, -1))
    qo, ko = kw.get("q_offset", 0), kw.get("kv_offset", 0)
    o_j, lse_j = pallas_fwd(
        q, k, v, lengths=None if lengths is None else jnp.asarray(lengths), window=window,
        q_offset=jnp.int32(qo) if qo else None, kv_offset=jnp.int32(ko) if ko else None,
    )
    lt = None if lengths is None else torch.from_numpy(lengths)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o_t, lse_t = flash_attention_ref(qt, kt, vt, lt, window, None, qo, ko)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL, rtol=0)
    # the wrapper takes the plain version for CPU tensors, under either flag
    o_w, lse_w = flash_attention_with_lse(qt, kt, vt, lt, window, None, qo, ko)
    assert torch.equal(o_w, o_t) and torch.equal(lse_w, lse_t)
    if lengths is not None and (lengths == 0).any():
        zero = np.flatnonzero(lengths == 0)
        assert (o_t[zero] == 0).all() and (lse_t[zero] == -1e30).all()


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_plain_forward_matches_pallas_at_tile_edges(case, monkeypatch):
    monkeypatch.delenv("LCASR_ATTN_FWD_DB", raising=False)
    _run_case(EDGE_CASES[case], seed=21)


@pytest.mark.parametrize("case", DB_CASES)
def test_plain_forward_matches_pallas_double_buffered_at_tile_edges(case, monkeypatch):
    monkeypatch.setenv("LCASR_ATTN_FWD_DB", "1")
    _run_case(EDGE_CASES[case], seed=22)


# head_dim 256 (lcasr_6l_768d_3h): the bf16 kernels take 64-key tiles there;
# the JAX `_fwd` shrinks its blocks (`_fit_blocks`).  Cases at the edges of
# both: T one past a 64-key tile, a band, offsets.
D256_CASES = {
    "T65": dict(T=65, lengths=[65, 64]),
    "T191_band": dict(T=191, lengths=[191, 129], window=(40, 24)),
    "left_window_on_64_tile_edge": dict(T=193, lengths=[321, 200], window=(64, -1),
                                        q_offset=128, kv_offset=64),
}


@pytest.mark.parametrize("case", sorted(D256_CASES))
def test_plain_forward_matches_pallas_at_head_dim_256(case, monkeypatch):
    monkeypatch.delenv("LCASR_ATTN_FWD_DB", raising=False)
    _run_case(D256_CASES[case], seed=23, D=256)


def test_head_dim_256_is_a_kernel_dim_both_ways_and_its_gradients_match_jax():
    """K1, K2 and the backward K3-K5 all take D = 256; on the CPU both
    directions run their plain versions there, and the gradients equal the
    JAX `flash_attention_bwd` (Pallas in interpret mode) within ATOL: both
    sides fp32 from the same pre-scaled q."""
    from lcasr_tpu.ops import flash_attention as jfa
    from lcasr_torch.ops import flash_attention as tfa

    assert 256 in tfa.KERNEL_HEAD_DIMS and 256 in tfa.BWD_KERNEL_HEAD_DIMS
    rng = np.random.default_rng(24)
    q, k, v, do = (rng.normal(size=(2, 20, 2, 256)).astype(np.float32) for _ in range(4))
    lens = np.asarray([20, 13], np.int32)
    o, lse = jfa.flash_attention_with_lse(q, k, v, lengths=jnp.asarray(lens))
    want = jfa.flash_attention_bwd(q, k, v, o, lse, do, lengths=jnp.asarray(lens))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    o_t, lse_t = tfa.flash_attention_with_lse(t(q), t(k), t(v), t(lens))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o), atol=ATOL, rtol=0)
    got = tfa.flash_attention_bwd(t(q), t(k), t(v), o_t, lse_t, t(do), t(lens))
    for g, w in zip(got, want):
        assert g.shape == (2, 20, 2, 256)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the TMA layout rules: CPU tensors, since the rules do not depend on the device
# ---------------------------------------------------------------------------
def _ok(t):
    from lcasr_torch.ops.flash_attention import _tma_layout_ok

    return _tma_layout_ok(t.shape, t.stride(), t.dtype, t.data_ptr())


def test_tma_layout_accepts_qkv_views_and_contiguous():
    qkv = torch.zeros((2, 300, 3, 6, 128), dtype=torch.bfloat16)
    assert all(_ok(x) for x in qkv.unbind(2))
    assert _ok(torch.zeros((2, 300, 6, 64), dtype=torch.bfloat16))
    assert _ok(torch.zeros((2, 300, 6, 32), dtype=torch.bfloat16))


def test_tma_layout_refuses_misaligned_base():
    from lcasr_torch.ops.flash_attention import _tma_layout_ok

    shape, strides = (2, 64, 2, 128), (16384, 256, 128, 1)
    assert _tma_layout_ok(shape, strides, torch.bfloat16, 1024)
    for off in (2, 8, 14):
        assert not _tma_layout_ok(shape, strides, torch.bfloat16, 1024 + off)
    flat = torch.zeros(2 * 64 * 2 * 128 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 2 * 64 * 2 * 128].view(shape)  # one element past flat's base
    assert _ok(shifted) == (shifted.data_ptr() % 16 == 0)


def test_tma_layout_refuses_odd_strides():
    odd_h = torch.zeros((2, 64, 2, 129), dtype=torch.bfloat16)[..., :128]
    assert odd_h.stride(2) == 129 and not _ok(odd_h)
    odd_t = torch.zeros((2, 63, 2 * 128 + 4), dtype=torch.bfloat16)[..., :256].view(2, 63, 2, 128)
    assert not _ok(odd_t)  # T stride 260 elements = 520 bytes
    assert not _ok(torch.zeros((2, 8, 2, 256), dtype=torch.bfloat16)[..., ::2])  # D stride 2
    # a dimension of size 1 is never stepped: its stride does not matter
    one_head = torch.zeros((2, 64, 1, 128), dtype=torch.bfloat16).as_strided(
        (2, 64, 1, 128), (64 * 128, 128, 129, 1))
    assert _ok(one_head)


def test_tma_layout_accepts_the_fp32_dq_buffer():
    """K3 adds dq into a zeroed fp32 (B, T, H, D) buffer by TMA reduce-add:
    the wrapper's contiguous buffer passes at every head dim; a view with an
    H stride off the 16-byte grid does not."""
    from lcasr_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    for D in KERNEL_HEAD_DIMS:
        assert _ok(torch.zeros((2, 63, 6, D), dtype=torch.float32))
    odd_h = torch.zeros((2, 64, 2, 129), dtype=torch.float32)[..., :128]
    assert odd_h.stride(2) == 129 and not _ok(odd_h)
    assert not _ok(torch.zeros((2, 64, 2, 2), dtype=torch.float32))  # 8-byte rows


def test_tma_layout_refuses_rows_not_a_multiple_of_16_bytes():
    assert not _ok(torch.zeros((2, 64, 2, 4), dtype=torch.bfloat16))  # 8-byte rows
    assert not _ok(torch.zeros((2, 64, 2, 12), dtype=torch.bfloat16))  # 24-byte rows
    assert _ok(torch.zeros((2, 64, 2, 8), dtype=torch.bfloat16))  # 16-byte rows
