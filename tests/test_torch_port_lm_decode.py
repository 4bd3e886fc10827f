"""lcasr_torch's frame-synchronous search on the device against lcasr_tpu's
device search and against the port's host search, on the CPU; then the
rescoring pipeline `cli/lm_rescore` end to end on a tiny model.

Beam width 4, max_candidates covering every proposable id (so the device
and host searches see the same candidates), 40-80 frames in segments of 16
(the last one padded), the LM at 2 layers x d_model 32.  Tolerances: ids and
timestamps equal; scores within 1e-4 (fp32 accumulation on the device
against float64 on the host, and JAX's fp32 in another order).
"""
import csv
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.decoding.frame_sync import CachedTransformerLM, FrameSyncBeamSearch
from lcasr_torch.decoding.frame_sync_device import (
    DeviceFrameSyncBeamSearch,
    _mulmod32,
    rescore_device,
)
from lcasr_torch.models.lm import TransformerLM
from tests.test_torch_port_beam import synth
from tests.test_torch_port_lm import lm_pair as make_lm_pair

V = 12
C = V + 1
K = 12  # every proposable id fits: device == host by construction
LM_CFG = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=2, head_dim=16)
SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def lm_pair():
    return make_lm_pair(LM_CFG, 6)


CASES = {
    "basic": dict(beam_width=4, alpha=0.5, beta=0.2),
    "penalties_prune": dict(beam_width=4, alpha=0.45, beta=1.53, blank_penalty=-0.3,
                            repetition_penalty=-0.2, prune_less_than_val=4.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_search_matches_jax_device_and_host(lm_pair, case):
    from lcasr_tpu.decoding.frame_sync_device import DeviceFrameSyncBeamSearch as JDevice

    jm, variables, port_lm = lm_pair
    kw = CASES[case]
    lp = synth(50, 0.35, 1, boost=4.0)  # 50 frames: the last 16-frame segment padded
    dev = DeviceFrameSyncBeamSearch(port_lm, max_tokens=52, max_candidates=K,
                                    frame_bucket=16, **kw)
    ids = dev.run_search(lp)
    jdev = JDevice(jm, variables, max_tokens=52, max_candidates=K, frame_bucket=16, **kw)
    host = FrameSyncBeamSearch(lm=CachedTransformerLM(port_lm, 4, 52), **kw)
    assert ids == jdev.run_search(lp) == host.run_search(lp) and len(ids) > 5
    assert dev.timestamps == jdev.timestamps == list(host.beams[0].stimes[1:])
    assert abs(dev.score - jdev.score) < SCORE_TOL
    assert abs(dev.score - host.beams[0].score) < SCORE_TOL


def test_many_recordings_in_lockstep_match_each_alone(lm_pair):
    """Three recordings of different lengths in one search (one of them
    without any candidate frame for its last 20 frames): each result is its
    own search's and the JAX batched search's."""
    from lcasr_tpu.decoding.frame_sync_device import rescore_device as jrescore

    jm, variables, port_lm = lm_pair
    logs = [synth(t, 0.3, s, boost=4.0) for s, t in ((2, 40), (3, 33), (4, 48))]
    logs[2][28:] = -50.0
    logs[2][28:, 0] = 0.0
    kw = dict(beam_width=4, alpha=0.5, beta=0.2, max_tokens=50, max_candidates=K,
              frame_bucket=16)
    got = rescore_device(port_lm, logs, batch_recordings=3, **kw)
    alone = rescore_device(port_lm, logs, batch_recordings=1, **kw)
    assert got == alone == jrescore(jm, variables, logs, batch_recordings=3, **kw)


def test_capacity_guard(lm_pair):
    _, _, port_lm = lm_pair
    lp = synth(40, 0.9, 5)
    with pytest.raises(RuntimeError, match="max_tokens"):
        DeviceFrameSyncBeamSearch(port_lm, beam_width=4, max_tokens=8, max_candidates=K,
                                  frame_bucket=16).run_search(lp)


def test_candidates_break_ties_as_lax_top_k(lm_pair):
    """Frames whose values tie at the K boundary: the same candidate set, in
    the same ascending order, as the JAX search's lax.top_k."""
    from lcasr_tpu.decoding.frame_sync_device import DeviceFrameSyncBeamSearch as JDevice

    jm, variables, port_lm = lm_pair
    rng = np.random.default_rng(6)
    lp = np.round(rng.normal(size=(32, C)) * 2.0).astype(np.float32) / 2.0  # many ties
    lp[:, C - 1] += 1.0
    port = DeviceFrameSyncBeamSearch(port_lm, max_candidates=4)
    jdev = JDevice(jm, variables, max_candidates=4)
    want = [np.asarray(x) for x in jdev._jit_candidates(jnp.asarray(lp))]
    got = [x.numpy() for x in port._candidates(torch.from_numpy(lp))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_hash_products_wrap_as_uint32():
    h = np.random.default_rng(7).integers(0, 2 ** 32, 1000, dtype=np.uint64)
    for p in (1000003, 2654435761):
        want = (h * np.uint64(p)) & np.uint64(0xFFFFFFFF)
        got = _mulmod32(torch.from_numpy(h.astype(np.int64)), p).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


# ---------------- cli/lm_rescore end to end ----------------
@pytest.fixture(scope="module")
def rescore_dirs(tmp_path_factory):
    """A tiny SCConformerXL checkpoint (its CTC head scaled so that its
    posteriors are peaked, as a trained head's are), its dumped logits of
    two synthetic recordings, and a tiny LM checkpoint, all of the port."""
    from lcasr_torch.cli.lm_rescore import create_logits
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.sconformer_xl import SCConformerXL, init_weights_
    from lcasr_torch.training.checkpointing import save_checkpoint

    base = tmp_path_factory.mktemp("rescore")
    vocab = load_tokenizer().vocab_size()
    am_cfg = dict(d_model=64, n_layers=1, n_heads=2, head_dim=32, subsampling_conv_channels=32)
    am = init_weights_(SCConformerXL(vocab_size=vocab, **am_cfg, device="cpu"), 0)
    with torch.no_grad():
        am.decoder.ff.weight.mul_(80.0)
    save_checkpoint(str(base / "am"), 0, am.state_dict(), config=Config({"model": am_cfg}))
    lm_cfg = dict(vocab_size=vocab, d_model=32, n_layers=1, n_heads=2, head_dim=16)
    lm = init_weights_(TransformerLM(**lm_cfg, device="cpu"), 1)
    save_checkpoint(str(base / "lm"), 0, lm.state_dict(),
                    config=Config({"model_class": "TransformerLM", "model": lm_cfg}))
    create_logits(str(base / "am"), "synthetic", "test", str(base / "logits"), seq_len=256,
                  dataset_kwargs={"n_recordings": 2, "n_frames": 384}, device="cpu")
    return base


def test_create_logits_dumps_each_recording(rescore_dirs):
    for i in range(2):
        data = np.load(rescore_dirs / "logits" / f"synthetic_{i}.npz")
        lg = data["logits"].astype(np.float32)
        assert lg.dtype == np.float32 and lg.shape == (48, 4096)
        np.testing.assert_allclose(np.exp(lg).sum(-1), 1.0, atol=2e-2)  # fp16 at rest
        assert str(data["gold"]) == "this is a synthetic gold transcript"


DECODERS = {
    "prefix": dict(decoder="prefix"),
    "prefix_lm": dict(decoder="prefix", lm=True),
    "frame_sync": dict(decoder="frame_sync", lm=True),
    "frame_sync_parallel": dict(decoder="frame_sync", lm=True, parallel_recordings=2),
    "device": dict(decoder="frame_sync", lm=True, device_search=True),
}


def _beam_stage(dirs, name, monkeypatch, **over):
    """beam_stage with DECODERS[name] -> (WER, the hypotheses it scored)."""
    import lcasr_torch.evaluation.normalizer as normalizer
    from lcasr_torch.cli.lm_rescore import beam_stage

    kw = dict(DECODERS[name], **over)
    if kw.pop("lm", False):
        kw["lm"] = str(dirs / "lm")
    texts, real = [], normalizer.normalize

    def spy(text):
        texts.append(text)
        return real(text)

    with monkeypatch.context() as m:
        m.setattr(normalizer, "normalize", spy)
        wer = beam_stage(str(dirs / "logits"), beta=1.53, beam_width=4, device="cpu", **kw)
    return wer, texts


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_beam_stage_decoders_and_csv_without_pandas(rescore_dirs, name, monkeypatch):
    """Every decoder of beam_stage on the CPU, over an alpha grid of two
    points: a finite WER each, and a results CSV written by the standard
    library (pandas blocked) with its header once."""
    out = rescore_dirs / f"{name}.csv"
    monkeypatch.setitem(sys.modules, "pandas", None)
    for alpha in (0.45, 0.3):
        wer, texts = _beam_stage(rescore_dirs, name, monkeypatch, alpha=alpha,
                                 results_csv=str(out))
        assert np.isfinite(wer) and len(texts) == 2
    with open(out, newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["recording", "wer", "words", "alpha", "beta", "beam_width"]
    assert len(rows) == 5 and [r[0] for r in rows[1:]] == ["synthetic_0", "synthetic_1"] * 2


def test_frame_sync_decoders_agree(rescore_dirs, monkeypatch):
    """The dumped logits have at most 8 candidates a frame (the device
    search's default), so the host frame-sync search, two recordings at
    once, and the device search give the same texts; the prefix search with
    the LM gives the JAX search's over the same logits and LM weights."""
    from lcasr_torch.cli.lm_rescore import load_lm_checkpoint
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.import_jax import flax_from_state_dict
    from lcasr_tpu.decoding.beam_search import BeamSearch as JBeamSearch
    from lcasr_tpu.models.lm import TransformerLM as JLM
    from lcasr_tpu.models.lm import make_lm_scorer

    logs = [np.load(rescore_dirs / "logits" / f"synthetic_{i}.npz")["logits"].astype(np.float32)
            for i in range(2)]
    for lg in logs:
        assert ((lg > lg.max(-1, keepdims=True) - 6.0)[:, 1:]).sum(-1).max() <= 8
    texts = {name: _beam_stage(rescore_dirs, name, monkeypatch, alpha=0.45)[1]
             for name in ("frame_sync", "frame_sync_parallel", "device", "prefix_lm")}
    assert texts["frame_sync"] == texts["frame_sync_parallel"] == texts["device"]
    assert any(texts["frame_sync"])

    lm = load_lm_checkpoint(str(rescore_dirs / "lm"), device="cpu")
    jm = JLM(vocab_size=lm.vocab_size, d_model=32, n_layers=1, n_heads=2, head_dim=16)
    tok = load_tokenizer()
    bs = JBeamSearch(tokenizer=tok, beam_width=4, blank_id=tok.vocab_size(), alpha=0.45,
                     beta=1.53, lm_scores=make_lm_scorer(jm, flax_from_state_dict(
                         lm.state_dict())), pad_id=tok.pad_id())
    assert texts["prefix_lm"] == [bs.run_search(lg) for lg in logs]
