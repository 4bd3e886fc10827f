"""lcasr_torch's dynamic evaluation and single-utterance self-training
against lcasr_tpu's, on the CPU in fp32.

With the SpecAugment masks switched off (no masks on either side: the
draws are each framework's own) the adaptation is deterministic, and one
recording's adapted log-probs agree with the JAX function's to 2e-4 of
the largest |log-prob| (a MADGRAD step of fp32 gradients in another
order moves the weights by ~1e-7 of lr apart, and the log-probs follow).
At lr 0 the steps change nothing, and the result equals the plain
moving-window decode to 1e-5.  The model's parameters and buffers are
bit-equal after every call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import state_dict_from_flax
from tests.test_torch_port_ops import randomize

TINY = dict(vocab_size=16, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            subsampling_conv_channels=32, use_rotary=True)
NO_MASKS = {"n_time_masks": 0, "n_freq_masks": 0, "freq_mask_param": 0}
TOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    jm = JModel(**TINY)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 128))), seed=1)
    port = SCConformerXL(**TINY, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, port


class _TinyTok:
    def vocab_size(self):
        return 16

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)

    def encode(self, text):
        return [int(w[1:]) for w in text.split()] if text else []

    def pad_id(self):
        return 0


def _spec(seed, T=640):
    return np.random.default_rng(seed).normal(size=(1, 80, T)).astype(np.float32)


def _bits(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _same_bits(model, before):
    after = model.state_dict()
    assert set(after) == set(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


KW = dict(seq_len=256, overlap=128, tokenizer=_TinyTok(), num_negatives=1)


def test_dynamic_eval_at_lr0_is_the_plain_decode(pair):
    """(The JAX function's own test holds its lr-0 result equal to its plain
    decode; the adaptation test below holds the two functions equal.)"""
    from lcasr_torch.evaluation.dynamic_eval import dynamic_eval_ctc_loss
    from lcasr_torch.evaluation.streaming import fetch_logits, make_windowed_model_fn

    _, _, port = pair
    spec = _spec(3)
    before = _bits(port)
    got = dynamic_eval_ctc_loss(port, spec, **KW, epochs=1, lr=0.0)
    plain = fetch_logits(make_windowed_model_fn(port), spec, seq_len=256, overlap=128,
                         n_classes=17)
    assert got.shape == plain.shape
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    _same_bits(port, before)


def test_dynamic_eval_adaptation_matches_jax_and_restores(pair):
    from lcasr_tpu.evaluation.dynamic_eval import dynamic_eval_ctc_loss as jdyn
    from lcasr_torch.evaluation.dynamic_eval import dynamic_eval_ctc_loss

    jm, variables, port = pair
    spec = _spec(4)
    before = _bits(port)
    kw = dict(KW, epochs=2, lr=5e-3, spec_augment_config=NO_MASKS)
    want = jdyn(jm, variables, spec, **kw)
    got = dynamic_eval_ctc_loss(port, spec, **kw)
    base = dynamic_eval_ctc_loss(port, spec, **dict(kw, lr=0.0))
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)
    assert np.abs(got - base).max() > 10 * TOL * np.abs(want).max()  # it adapted
    _same_bits(port, before)
    # with the default masks it runs, adapts and restores too
    masked = dynamic_eval_ctc_loss(port, spec, **dict(KW, epochs=1, lr=5e-3))
    assert masked.shape == base.shape and np.isfinite(masked).all()
    _same_bits(port, before)


def test_dynamic_eval_empty_pseudo_label_still_adapts(pair, monkeypatch):
    import lcasr_torch.evaluation.dynamic_eval as de

    _, _, port = pair
    monkeypatch.setattr(de, "GreedyCTCDecoder", lambda tokenizer, blank_id: (lambda lp: ""))
    spec = _spec(5)
    base = de.dynamic_eval_ctc_loss(port, spec, **KW, epochs=1, lr=0.0)
    adapted = de.dynamic_eval_ctc_loss(port, spec, **KW, epochs=2, lr=5e-3)
    assert np.abs(adapted - base).max() > 1e-4


def test_selftrain_matches_jax_and_restores(pair):
    from lcasr_tpu.evaluation.selftrain import SelfTrainWrapper as JWrapper
    from lcasr_torch.evaluation.selftrain import SelfTrainWrapper

    jm, variables, port = pair
    audio = _spec(6, T=256)
    kw = dict(n_iterations=2, num_negatives=1, lr=5e-3, spec_augment_config=NO_MASKS)
    want = np.asarray(JWrapper(jm, variables, _TinyTok(), **kw)(audio)["final_posteriors"])
    before = _bits(port)
    got = SelfTrainWrapper(port, _TinyTok(), **kw)(audio)["final_posteriors"].numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)
    with torch.no_grad():
        plain = port(torch.from_numpy(audio))["final_posteriors"].numpy()
    assert np.abs(got - plain).max() > 10 * TOL * np.abs(want).max()
    _same_bits(port, before)


def test_selftrain_empty_pseudo_label_still_adapts(pair, monkeypatch):
    import lcasr_torch.evaluation.selftrain as st

    _, _, port = pair
    monkeypatch.setattr(st, "GreedyCTCDecoder", lambda tokenizer, blank_id: (lambda lp: ""))
    audio = _spec(7, T=128)
    out = st.SelfTrainWrapper(port, _TinyTok(), n_iterations=2, lr=5e-3)(audio)
    with torch.no_grad():
        plain = port(torch.from_numpy(audio))["final_posteriors"]
    assert (out["final_posteriors"] - plain).abs().max() > 1e-4
