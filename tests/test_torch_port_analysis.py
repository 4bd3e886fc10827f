"""lcasr_torch's attention analysis (captures, `flash_attention_probs`,
`attention_summary`, attribution, the rotary probe) against lcasr_tpu's, on
the CPU in fp32.

Both sides run exact fp32 attention (the JAX forward kernel in Pallas
interpret mode for the lse; the port's plain version of K1).
Probabilities and the per-row statistics agree to 1e-5 (fp32 sums of up to
a few hundred terms in another order; the expected distances, which reach
~20 frames, to 1e-5 relative as well); the top-k columns are compared
exactly, ties included: `jax.lax.top_k` puts the lower index first.
Log-probs and the attribution keep the model tests' 1e-4 (a few layers of
GEMMs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import state_dict_from_flax
from tests.test_torch_port_ops import randomize

TOL = 1e-5
ATOL = 1e-4
TINY = dict(vocab_size=16, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            subsampling_conv_channels=32, use_rotary=True, rotary_base_freq=1.5e6)


def _pair(cfg, seed=0):
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    jm = JModel(**cfg)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 128))), seed=seed)
    port = SCConformerXL(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, port


@pytest.fixture(scope="module")
def pair():
    return _pair(TINY, seed=3)


@pytest.fixture(scope="module")
def banded():
    # a band narrower than top_k: most rows have fewer than 8 nonzero
    # probabilities, so the top-k ties at 0
    return _pair(dict(TINY, attention_window_size_left=2, attention_window_size_right=1),
                 seed=4)


def _audio(seed, B=2, T=300):
    return np.random.default_rng(seed).normal(size=(B, 80, T)).astype(np.float32)


LENGTHS = np.array([300, 173], np.int32)


def test_captures_match_jax(pair):
    """Post-rotary (q, k, v, lengths) of every layer, and every layer's
    probabilities from the plain attention, as the JAX model sows them."""
    from lcasr_tpu.evaluation import analysis as janalysis
    from lcasr_torch.evaluation import analysis

    jm, variables, port = pair
    audio = _audio(1)
    want = janalysis._captured_qkv(jm, variables, audio, LENGTHS)
    got = analysis._captured_qkv(port, audio, LENGTHS)
    assert len(got) == len(want) == TINY["n_layers"]
    for (q, k, v, lens), wq in zip(got, want):
        for a, b in zip((q, k, v), wq[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(lens.numpy(), np.asarray(wq[3]))
    assert port.capture_qkv is False  # the option is back as it was
    probs_w = janalysis.get_attention_weights(jm, variables, audio, LENGTHS)
    probs = analysis.get_attention_weights(port, audio, LENGTHS)
    for p, w in zip(probs, probs_w):
        assert p.shape == w.shape
        np.testing.assert_allclose(p, w, atol=TOL, rtol=0)
    assert port.return_attention_weights is False


PROB_CASES = {
    "full": dict(window=(-1, -1), lengths=[40, 27], rows=(5, 20)),
    "band": dict(window=(6, 3), lengths=[40, 40], rows=(0, 40)),
    # rows past the length (all masked) and a one-sided band
    "masked_rows": dict(window=(-1, 0), lengths=[40, 9], rows=(3, 30)),
    "offsets": dict(window=(4, 4), lengths=[70, 55], rows=(2, 17), q_offset=30, kv_offset=20),
}


@pytest.mark.parametrize("case", sorted(PROB_CASES))
def test_flash_attention_probs_matches_jax(case):
    from lcasr_tpu.ops.flash_attention import flash_attention_probs as jprobs
    from lcasr_torch.ops.flash_attention import flash_attention_probs

    c = PROB_CASES[case]
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 40, 2, 32)).astype(np.float32) for _ in range(3))
    lens = np.array(c["lengths"], np.int32)
    kw = dict(window=c["window"], rows=c["rows"])
    jkw = dict(kw)
    if "q_offset" in c:
        jkw.update(q_offset=jnp.int32(c["q_offset"]), kv_offset=jnp.int32(c["kv_offset"]))
        kw.update(q_offset=c["q_offset"], kv_offset=c["kv_offset"])
    want = np.asarray(jprobs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             lengths=jnp.asarray(lens), **jkw))
    got = flash_attention_probs(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                lengths=torch.from_numpy(lens), **kw).numpy()
    assert got.shape == want.shape == (2, 2, c["rows"][1], 40)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    live = want.sum(-1) > 0
    np.testing.assert_allclose(got.sum(-1)[live], 1.0, atol=1e-5)
    if case == "masked_rows":
        assert (~live).any() and not got[~live].any()


@pytest.mark.parametrize("which", ["full", "banded"])
def test_attention_summary_matches_jax(which, pair, banded):
    """T' = 38 over blocks of 16 (not a multiple), a padded second
    recording, and under the band rows with fewer than top_k nonzero
    probabilities: the columns agree exactly, ties to the lower index."""
    from lcasr_tpu.evaluation import analysis as janalysis
    from lcasr_torch.evaluation import analysis

    jm, variables, port = pair if which == "full" else banded
    audio = _audio(2)
    kw = dict(row_block=16, top_k=8)
    want = janalysis.attention_summary(jm, variables, audio, LENGTHS, **kw)
    got = analysis.attention_summary(port, audio, LENGTHS, **kw)
    assert len(got) == len(want) == TINY["n_layers"]
    for g, w in zip(got, want):
        for key in ("entropy", "expected_distance", "topk_probs"):
            assert g[key].shape == w[key].shape
            # distances reach ~20 frames: their fp32 sums are held relatively
            rtol = TOL if key == "expected_distance" else 0
            np.testing.assert_allclose(g[key], w[key], atol=TOL, rtol=rtol, err_msg=key)
        np.testing.assert_array_equal(g["topk_cols"], w["topk_cols"])
    if which == "banded":
        assert (got[0]["topk_probs"][..., -1] == 0).all()  # every row ties at 0


def test_topk_lower_index_first_matches_lax_top_k():
    from lcasr_torch.evaluation.analysis import topk_lower_index_first

    rng = np.random.default_rng(6)
    p = rng.choice(np.array([0.0, 0.125, 0.25, 0.5], np.float32), size=(3, 5, 300))
    p[0, 0] = 0.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(p), 8)
    got_v, got_i = topk_lower_index_first(torch.from_numpy(p), 8)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_context_attribution_matches_jax(pair):
    from lcasr_tpu.evaluation import analysis as janalysis
    from lcasr_torch.evaluation import analysis

    jm, variables, port = pair
    audio = _audio(3, B=1, T=256)
    want = janalysis.context_attribution(jm, variables, audio, frame=17)
    got = analysis.context_attribution(port, audio, frame=17)
    assert got.shape == want.shape == (256,)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
    assert all(p.grad is None for p in port.parameters())


def test_rotary_interpolation_probe_matches_jax(pair):
    from lcasr_tpu.evaluation import analysis as janalysis
    from lcasr_torch.evaluation import analysis

    jm, variables, port = pair
    audio = _audio(4, B=1)
    want = janalysis.rotary_interpolation_probe(jm, variables, audio)
    got = analysis.rotary_interpolation_probe(port, audio)
    assert sorted(got) == sorted(want) == [1.0, 2.0, 4.0, 8.0]
    for f in want:
        assert abs(got[f]["mean_max_logprob"] - want[f]["mean_max_logprob"]) < ATOL
        assert got[f]["blank_fraction"] == want[f]["blank_fraction"]
    assert port.rotary_interpolation_factor == 1.0
    assert got[1.0] != got[8.0]


def test_attention_prob_rows_match_reference_weights(pair):
    """Rows normalised by K1's lse equal the plain attention's probabilities
    on the valid rows; rows past a recording's length are all zero (the
    plain attention keeps probabilities there and zeroes only its output)."""
    from lcasr_torch.evaluation import analysis

    _, _, port = pair
    audio = _audio(7)
    rows = analysis.attention_prob_rows(port, audio, layer=1, rows=(4, 20), lengths=LENGTHS)
    full = analysis.get_attention_weights(port, audio, LENGTHS)[1][:, :, 4:24]
    out_len = (LENGTHS + 7) // 8  # three stride-2 stages
    live = (4 + np.arange(20))[None, :] < out_len[:, None]
    assert (~live).any()
    np.testing.assert_allclose(rows.transpose(0, 2, 1, 3)[live],
                               full.transpose(0, 2, 1, 3)[live], atol=TOL, rtol=0)
    assert not rows.transpose(0, 2, 1, 3)[~live].any()


class _StubMesh:
    """The `seq` axis of a mesh of one, for refusals that come before any
    collective."""

    def axis(self, name):
        from lcasr_torch.parallel.collectives import Axis

        return Axis(None, 0, 1, (0,))


def test_weights_refused_under_ring_context_parallelism():
    from lcasr_torch.models.sconformer_xl import SCConformerXL
    from lcasr_torch.parallel.mesh import bind

    model = SCConformerXL(**TINY, seq_axis_name="seq", attention_cp_impl="ring",
                          return_attention_weights=True, device="cpu")
    model.parallel.mesh = _StubMesh()
    bind(model, model.parallel)
    with pytest.raises(NotImplementedError, match="ring context parallelism"):
        model(torch.zeros(1, 80, 128))
