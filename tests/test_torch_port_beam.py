"""lcasr_torch's host beam searches against lcasr_tpu's on the CPU: the
prefix beam search with and without an LM (its Python loop and its C++
block advance), and the frame-synchronous search with per-beam KV caches
for one recording and for many at once.  Beam width 4, 64-300 frames, the
LM at 2 layers x d_model 64, weights and logits from numpy seeds.

Tolerances: prefix-search texts, prefixes and timestamps equal, scores
within 1e-9 (the same float64 arithmetic in the same order); the native
block equal to the Python path, bit for bit; frame-sync ids equal, scores
within 1e-5 (the LM's fp32 log-probs differ in the last bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.decoding.beam_search import BeamSearch
from lcasr_torch.decoding.frame_sync import (
    CachedTransformerLM,
    FrameSyncBeamSearch,
    rescore_many,
)
from lcasr_torch.models.lm import TransformerLM, make_lm_scorer
from tests.test_torch_port_lm import lm_pair as make_lm_pair

V = 12  # LM vocabulary; AM classes V + 1, blank last
C = V + 1
LM_CFG = dict(vocab_size=V, d_model=64, n_layers=2, n_heads=4, head_dim=16)


@pytest.fixture(scope="module")
def lm_pair():
    return make_lm_pair(LM_CFG, 5)


def synth(T, rate, seed, boost=9.0, classes=C, scale=1.0):
    """Blank-dominated CTC log-posteriors with emission spikes (a trained
    model's shape; `boost` small and `scale` low make them flat)."""
    rng = np.random.default_rng(seed)
    lp = rng.normal(size=(T, classes)).astype(np.float32) * scale
    emit = rng.random(T) < rate
    tok = rng.integers(1, classes - 1, size=T)
    lp[np.arange(T), np.where(emit, tok, classes - 1)] += boost
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


def _state(bs):
    return [(b.prefix, b.p_blank, b.p_non_blank, b.frames, b.lm_score)
            for b in bs._beams.values()]


def _assert_same_beams(port, jax_bs, tol=1e-9):
    a, b = _state(port), _state(jax_bs)
    assert [x[0] for x in a] == [x[0] for x in b]  # prefixes, in order
    assert [x[3] for x in a] == [x[3] for x in b]  # timestamps
    for x, y in zip(a, b):
        for u, v in zip(x[1:3] + x[4:], y[1:3] + y[4:]):
            assert abs(u - v) <= tol * max(1.0, abs(v)), (u, v)


NO_LM_CASES = {
    "default": dict(beam_width=4),
    "pad": dict(beam_width=4, pad_id=0),
    "prune": dict(beam_width=4, pad_id=0, prune_less_than_val=3.0),
    "threshold": dict(beam_width=4, pad_id=0, top_am_threshold=-2.0),
}


@pytest.mark.parametrize("case", sorted(NO_LM_CASES))
@pytest.mark.parametrize("sharp", [True, False])
def test_no_lm_search_matches_jax_and_native_equals_python(case, sharp):
    """No LM: the port's native block advance and its Python loop leave the
    same beams, bit for bit, and both equal the JAX search's (its Python
    path: the JAX package's native module is not built here)."""
    from lcasr_tpu.decoding.beam_search import BeamSearch as JBeamSearch

    kw = NO_LM_CASES[case]
    lp = synth(200, 0.3, 1, boost=9.0 if sharp else 1.0, scale=1.0 if sharp else 0.3)
    native, python = BeamSearch(**kw), BeamSearch(**kw)
    python.force_python = True
    j = JBeamSearch(**kw)
    j._force_python = True
    ids = native.run_search(lp)
    assert python.run_search(lp) == ids == j.run_search(lp)
    assert _state(native) == _state(python)
    _assert_same_beams(native, j)


def test_native_block_streams_and_carries_empty_frames():
    """Advancing block by block (global t0) equals one advance over the
    whole; a frame whose only candidate is pad carries the beams over."""
    lp = synth(150, 0.4, 2)
    lp[40:45] = -50.0
    lp[40:45, 0] = 0.0  # pad alone clears the threshold
    whole = BeamSearch(beam_width=4, pad_id=0)
    whole.run_search(lp)
    streamed = BeamSearch(beam_width=4, pad_id=0)
    for t0 in range(0, 150, 32):
        streamed.advance(lp[t0 : t0 + 32], t0=t0)
    python = BeamSearch(beam_width=4, pad_id=0)
    python.force_python = True
    python.run_search(lp)
    assert _state(streamed) == _state(whole) == _state(python)


def _numpy_lm(seed=0, vocab=V):
    """A deterministic last-token-conditioned LM and its call log."""
    table = np.random.default_rng(seed).normal(size=(vocab, vocab))
    table = table - np.log(np.exp(table).sum(-1, keepdims=True))
    calls = []

    def lm_scores(prefixes):
        calls.extend(tuple(p) for p in prefixes)
        return np.stack([table[p[-1] if p else 2] for p in prefixes])

    return lm_scores, calls


@pytest.mark.parametrize("kw", [dict(alpha=0.5, beta=0.3), dict(alpha=0.3, beta=1.0,
                                                                  prune_less_than_val=6.0,
                                                                  max_cache_length=3)])
def test_lm_fused_search_matches_jax_and_scores_each_prefix_once(kw):
    from lcasr_tpu.decoding.beam_search import BeamSearch as JBeamSearch

    lp = synth(150, 0.4, 3, boost=4.0)
    lm_a, calls = _numpy_lm()
    lm_b, _ = _numpy_lm()
    port = BeamSearch(beam_width=4, pad_id=0, lm_scores=lm_a, **kw)
    j = JBeamSearch(beam_width=4, pad_id=0, lm_scores=lm_b, **kw)
    assert port.run_search(lp) == j.run_search(lp)
    _assert_same_beams(port, j)
    # the memo: without a context cut no prefix is scored twice here
    if "max_cache_length" not in kw:
        assert len(calls) == len(set(calls)) > 0


def test_decode_beams_word_timestamps_match_jax():
    """decode_beams with the port's tokenizer: text, word timestamps and
    scores equal JAX's (the logits spell known words)."""
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_tpu.decoding.beam_search import BeamSearch as JBeamSearch

    tok = load_tokenizer()
    ids = tok.encode("the cat sat on the mat and the dog ran")
    Cx = tok.vocab_size() + 1
    rng = np.random.default_rng(4)
    T = 4 * len(ids) + 8
    lp = rng.normal(size=(T, Cx)).astype(np.float32)
    lp[:, Cx - 1] += 12.0
    for i, t in enumerate(ids):
        lp[4 * i + 2, t] += 20.0
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    port = BeamSearch(tokenizer=tok, beam_width=4, blank_id=Cx - 1, pad_id=0, alpha=0, beta=0)
    j = JBeamSearch(tokenizer=tok, beam_width=4, blank_id=Cx - 1, pad_id=0, alpha=0, beta=0)
    j._force_python = True
    a, b = port.decode_beams(lp), j.decode_beams(lp)
    assert a["text"] == b["text"] == tok.decode(ids)
    assert a["frames"] == b["frames"] and len(a["frames"]) == 10
    assert abs(a["score"] - b["score"]) < 1e-9 and abs(a["am_score"] - b["am_score"]) < 1e-9


def test_prefix_search_with_the_transformer_lm_matches_jax(lm_pair):
    """BeamSearch fused with make_lm_scorer's TransformerLM on both sides:
    the same text and prefixes; the scores within the LM's fp32 rounding."""
    from lcasr_tpu.decoding.beam_search import BeamSearch as JBeamSearch
    from lcasr_tpu.models.lm import make_lm_scorer as jscorer

    jm, variables, port_lm = lm_pair
    lp = synth(64, 0.4, 5, boost=5.0)
    kw = dict(beam_width=4, pad_id=0, alpha=0.45, beta=1.53)
    port = BeamSearch(lm_scores=make_lm_scorer(port_lm), **kw)
    j = JBeamSearch(lm_scores=jscorer(jm, variables), **kw)
    assert port.run_search(lp) == j.run_search(lp)
    _assert_same_beams(port, j, tol=1e-5)


# ---------------- the frame-synchronous search ----------------
FS_CASES = {
    "basic": dict(beam_width=4, alpha=0.5, beta=0.2),
    "penalties": dict(beam_width=4, alpha=0.45, beta=1.53, blank_penalty=-0.3,
                      repetition_penalty=-0.2, prune_less_than_val=5.0),
}


@pytest.mark.parametrize("case", sorted(FS_CASES))
def test_frame_sync_with_cached_lm_matches_jax(lm_pair, case):
    from lcasr_tpu.decoding import frame_sync as jfs

    jm, variables, port_lm = lm_pair
    kw = FS_CASES[case]
    lp = synth(120, 0.3, 6)
    port = FrameSyncBeamSearch(lm=CachedTransformerLM(port_lm, 4, max_len=122), **kw)
    j = jfs.FrameSyncBeamSearch(lm=jfs.CachedTransformerLM(jm, variables, 4, max_len=122), **kw)
    assert port.run_search(lp) == j.run_search(lp)
    assert [b.lm_sequence for b in port.beams] == [b.lm_sequence for b in j.beams]
    assert [b.stimes for b in port.beams] == [b.stimes for b in j.beams]
    np.testing.assert_allclose([b.score for b in port.beams], [b.score for b in j.beams],
                               atol=1e-5)


def test_cache_bucket_grows_and_overflow_raises(lm_pair):
    """A 300-frame emitting search outgrows the 256-position bucket (the
    buffer doubles, the ids stay the JAX search's); a cache sized below the
    emissions raises."""
    from lcasr_tpu.decoding import frame_sync as jfs

    jm, variables, port_lm = lm_pair
    lp = synth(300, 0.95, 7)
    lm = CachedTransformerLM(port_lm, 4, max_len=302)
    ids = FrameSyncBeamSearch(lm=lm, beam_width=4).run_search(lp)
    assert lm._buf_len > 256 and len(ids) > 256
    assert ids == jfs.FrameSyncBeamSearch(
        lm=jfs.CachedTransformerLM(jm, variables, 4, max_len=302), beam_width=4).run_search(lp)
    assert lm.warm_buckets() == [256, 303]
    with pytest.raises(RuntimeError, match="overflow"):
        FrameSyncBeamSearch(lm=CachedTransformerLM(port_lm, 4, max_len=50),
                            beam_width=4).run_search(lp)


def test_bf16_cache_tracks_fp32(lm_pair):
    _, _, port_lm = lm_pair
    lp = synth(100, 0.3, 8)
    a = FrameSyncBeamSearch(lm=CachedTransformerLM(port_lm, 4, 102), beam_width=4)
    b = FrameSyncBeamSearch(lm=CachedTransformerLM(port_lm, 4, 102, cache_dtype=torch.bfloat16),
                            beam_width=4)
    ids_a, ids_b = a.run_search(lp), b.run_search(lp)
    assert ids_a == ids_b and abs(a.beams[0].score - b.beams[0].score) < 0.05


@pytest.mark.parametrize("n_slots", [1, 3])
def test_rescore_many_equals_each_search_and_jax(lm_pair, n_slots):
    """Four recordings (one without a candidate frame) through 1 or 3 slots
    of one wide LM: each result is its own run_search's, and JAX's."""
    from lcasr_tpu.decoding import frame_sync as jfs

    jm, variables, port_lm = lm_pair
    logs = [synth(t, 0.3, s) for s, t in ((9, 80), (10, 64), (11, 100))]
    logs.append(np.full((20, C), -50.0, np.float32))
    logs[-1][:, 0] = 0.0  # only pad clears the threshold: no LM step at all
    kw = dict(beam_width=4, alpha=0.5, beta=0.2)
    got = rescore_many(CachedTransformerLM(port_lm, n_slots * 4, 101), logs, n_slots, **kw)
    single = [FrameSyncBeamSearch(lm=CachedTransformerLM(port_lm, 4, 101), **kw).run_search(lg)
              for lg in logs]
    want = jfs.rescore_many(jfs.CachedTransformerLM(jm, variables, n_slots * 4, 101), logs,
                            n_slots, **kw)
    assert got == single == want
    assert got[-1] == []
