"""lcasr_torch's TransformerLM, its loss, its prefix scorer and its trainer
against lcasr_tpu's on the CPU in fp32, at a small size (2 layers, d_model
64, 4 heads x 16): the same weights (a flax init redrawn from a numpy seed,
carried over by `import_jax`), the same tokens.

Tolerances: log-probs of the full pass and of a cached step within 1e-5 of
JAX's (fp32 sums in another order); one train_lm step's parameters within
1e-5 of optax's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import flax_from_state_dict, state_dict_from_flax
from lcasr_torch.models.lm import TransformerLM, lm_loss, make_lm_scorer
from tests.test_torch_port_ops import randomize

CFG = dict(vocab_size=40, d_model=64, n_layers=2, n_heads=4, head_dim=16)
TOL = 1e-5


def lm_pair(cfg, seed):
    """(JAX model, its variables, the port's model) with the same weights,
    drawn from a numpy seed (`init_weights_`) and carried to flax by
    `flax_from_state_dict`; test_flax_names_round_trip holds that tree
    equal to a flax init's."""
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_tpu.models.lm import TransformerLM as JLM

    port = init_weights_(TransformerLM(**cfg, device="cpu"), seed)
    return JLM(**cfg), flax_from_state_dict(port.state_dict()), port


@pytest.fixture(scope="module")
def pair():
    return lm_pair(CFG, 3)


def _tokens(B, U, seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (B, U)).astype(np.int32)


def _logp(x):
    x = np.asarray(x, np.float64)
    return x - np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1, keepdims=True)) - x.max(
        -1, keepdims=True)


def test_full_pass_matches_jax(pair):
    jm, variables, port = pair
    tok = _tokens(3, 37, 0)
    want = np.asarray(jm.apply(variables, jnp.asarray(tok)))
    with torch.no_grad():
        got = port(torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(_logp(got), _logp(want), atol=TOL)


def _cache_case(name, rng, B=4, Nmax=7):
    L, H, D = CFG["n_layers"], CFG["n_heads"], CFG["head_dim"]
    cache = rng.normal(size=(L, 2, B, H, Nmax, D)).astype(np.float32)
    lengths = np.array([0, 3, Nmax - 1, Nmax], np.int32)  # the last row's write drops
    kw = {}
    if name in ("write_mask", "pos_row"):
        kw["write_mask"] = np.array([True, False, True, True])
    if name == "pos_row":
        kw["pos_row"] = rng.integers(0, B, (B, Nmax)).astype(np.int32)
        kw["write_rows"] = np.array([2, 0, 3, 1], np.int32)
    return cache, lengths, kw


@pytest.mark.parametrize("name", ["plain", "write_mask", "pos_row"])
def test_cached_step_matches_jax(pair, name):
    """One cached step: logits, the updated cache and the lengths, with a
    write mask, the row indirection and write rows, and a row at Nmax."""
    jm, variables, port = pair
    rng = np.random.default_rng(1)
    cache, lengths, kw = _cache_case(name, rng)
    tok = _tokens(4, 1, 2)
    lj, cj, nj = jm.apply(variables, jnp.asarray(tok), cache=jnp.asarray(cache),
                          cache_lengths=jnp.asarray(lengths),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        lt, ct, nt = port(torch.from_numpy(tok), cache=torch.from_numpy(cache.copy()),
                          cache_lengths=torch.from_numpy(lengths),
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(_logp(lt.numpy()), _logp(lj), atol=TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=TOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("name", ["plain", "write_mask", "pos_row"])
def test_masked_rows_and_the_drop_at_nmax_keep_the_cache(pair, name):
    """Exactly the cells of the rows that write change: a masked row, and a
    row whose length is Nmax, leave every cell as it was, bit for bit."""
    _, _, port = pair
    rng = np.random.default_rng(4)
    cache, lengths, kw = _cache_case(name, rng)
    mask = kw.get("write_mask", np.ones(4, bool))
    rows = kw.get("write_rows", np.arange(4))
    before = torch.from_numpy(cache.copy())
    with torch.no_grad():
        _, after, n = port(torch.from_numpy(_tokens(4, 1, 5)), cache=before.clone(),
                           cache_lengths=torch.from_numpy(lengths),
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    written = np.zeros(cache.shape, bool)
    for b in range(4):
        if mask[b] and lengths[b] < cache.shape[4]:
            written[:, :, rows[b], :, lengths[b]] = True
    np.testing.assert_array_equal(after.numpy()[~written], cache[~written])
    assert not np.array_equal(after.numpy()[written], cache[written])
    np.testing.assert_array_equal(n.numpy(), lengths + mask)


def test_cached_decode_equals_the_full_pass(pair):
    """25 rows fed one token a step through a 40-position cache give the
    log-probs of one full causal pass at every position."""
    _, _, port = pair
    B, U = 25, 24
    tok = torch.from_numpy(_tokens(B, U, 6))
    L, H, D = CFG["n_layers"], CFG["n_heads"], CFG["head_dim"]
    cache = torch.zeros((L, 2, B, H, 40, D))
    lengths = torch.zeros((B,), dtype=torch.int32)
    steps = []
    with torch.no_grad():
        for t in range(U):
            logits, cache, lengths = port(tok[:, t : t + 1], cache=cache, cache_lengths=lengths)
            steps.append(logits[:, 0])
        full = port(tok)
    np.testing.assert_allclose(_logp(torch.stack(steps, 1).numpy()), _logp(full.numpy()),
                               atol=TOL)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_lm_loss_matches_jax(pair, with_lengths):
    from lcasr_tpu.models.lm import lm_loss as jloss

    jm, variables, port = pair
    tok = _tokens(3, 37, 7)
    lengths = np.array([37, 9, 2], np.int32) if with_lengths else None
    want = float(jloss(jm, variables, jnp.asarray(tok),
                       None if lengths is None else jnp.asarray(lengths)))
    with torch.no_grad():
        got = float(lm_loss(port, torch.from_numpy(tok),
                            None if lengths is None else torch.from_numpy(lengths)))
    assert abs(got - want) < TOL * max(1.0, abs(want))


def test_train_step_matches_optax(pair):
    """One step of train_lm's optimizer (clip_grad_norm_(1.0), AdamW with
    weight decay 0.01) against optax.chain(clip_by_global_norm(1.0),
    adamw(lr, weight_decay=0.01)) from the same parameters, at train_lm's
    learning rate, on a batch whose gradient norm exceeds 1 (the clip
    acts).  (Adam moves a parameter by about lr whatever its gradient's
    size, so where a gradient is near eps its fp32 rounding decides the
    step: the tolerance is a fraction of lr.)"""
    import optax

    from lcasr_torch.cli.train_lm import make_optimizer, train_step
    from lcasr_tpu.models.lm import lm_loss as jloss

    jm, variables, _ = pair
    port = TransformerLM(**CFG, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    tok = _tokens(4, 33, 8)
    lengths = np.array([33, 20, 12, 5], np.int32)
    lr = 3e-4
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=0.01))
    params = variables["params"]

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(
            lambda p: jloss(jm, {"params": p}, jnp.asarray(tok), jnp.asarray(lengths)))(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, optax.global_norm(grads), optax.apply_updates(params, updates)

    loss, norm, new = step(params)
    assert float(norm) > 1.0
    want = flax_from_state_dict(state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, new)}))["params"]
    got_loss = train_step(port, make_optimizer(port, lr), torch.from_numpy(tok),
                          torch.from_numpy(lengths))
    assert abs(float(got_loss) - float(loss)) < TOL
    got = flax_from_state_dict(port.state_dict())["params"]
    flat_w, flat_g = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g)
    for w, g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, w, atol=TOL)
    # and 99% of them within 1e-7: the decay (lr 0.01 |p|, ~3e-7 here), the
    # bias corrections and eps are optax's, which 1e-5 alone would not show
    d = np.concatenate([np.abs(g - w).ravel() for w, g in zip(flat_w, flat_g)])
    assert np.quantile(d, 0.99) < 1e-7


@pytest.mark.parametrize("device_side", [True, False])
def test_prefix_scorer_matches_jax(pair, device_side):
    """make_lm_scorer's next-token log-probs over ragged prefixes (length and
    batch buckets), with the last position taken on the device (fn_last) or
    on the host (fn)."""
    from lcasr_tpu.models.lm import make_lm_scorer as jscorer

    jm, variables, port = pair
    prefixes = [[5, 6, 7], [1], [], list(range(3, 40))]
    js, ts = jscorer(jm, variables), make_lm_scorer(port)
    if not device_side:
        js.fn_last = ts.fn_last = None
    want, got = js(prefixes), ts(prefixes)
    assert got.shape == (4, CFG["vocab_size"])
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)


def test_flax_names_round_trip(pair):
    """A flax init's tree carries over to the port and back, leaf for leaf;
    an unknown name raises."""
    jm, _, _ = pair
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)), 3)
    port = TransformerLM(**CFG, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    back = flax_from_state_dict(port.state_dict())
    want = jax.tree.map(np.asarray, variables)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown module"):
        state_dict_from_flax({"params": {"lm_tail": {"kernel": np.zeros((2, 2))}}})


def test_registry_and_refusals():
    from lcasr_torch.config import Config
    from lcasr_torch.models.registry import load_model

    model = load_model(Config({"model_class": "TransformerLM", "model": dict(
        d_model=32, n_layers=1, n_heads=2, head_dim=16)}), 50, device="cpu")
    assert isinstance(model, TransformerLM) and model.vocab_size == 50
    # W8A8 is taken (tests/test_torch_port_qdense.py); training refuses it
    quant = TransformerLM(**CFG, quant_w8a8=True, device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        lm_loss(quant, torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(TypeError):
        TransformerLM(**CFG, no_such_option=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransformerLM(**CFG)


def test_batches_from_text_match_jax():
    """The same shuffled, bucketed batches as the JAX CLI's, token for token."""
    from lcasr_torch.cli.train_lm import batches_from_text
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_tpu.cli.train_lm import batches_from_text as jbatches

    tok = load_tokenizer()
    lines = ["the cat sat on the mat", "a dog ran in the park " * 12, "", "the cat ran"] * 3
    a, b = batches_from_text(lines, tok, 4, 40, seed=3), jbatches(lines, tok, 4, 40, seed=3)
    for _ in range(5):
        (ta, la), (tb, lb) = next(a), next(b)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)


def test_train_lm_cli_end_to_end(tmp_path):
    """cli/train_lm on the CPU: a text file -> a checkpoint of the port whose
    loss fell; load_lm_checkpoint gives the same logits as the trained
    weights."""
    from lcasr_torch.cli.lm_rescore import load_lm_checkpoint
    from lcasr_torch.cli.train_lm import train_lm
    from lcasr_torch.training.checkpointing import load_checkpoint

    text = tmp_path / "corpus.txt"
    text.write_text("\n".join(["the cat sat on the mat", "a dog ran in the park",
                               "the cat ran", "a dog sat"] * 4))
    save = tmp_path / "lm"
    ckpt = train_lm(str(text), str(save), d_model=32, n_layers=1, n_heads=2, head_dim=16,
                    batch_size=4, seq_len=16, lr=3e-3, steps=30, save_every=30,
                    log_every=10, device="cpu")
    lines = [json.loads(line) for line in open(save / "metrics.jsonl")]
    assert [m["step"] for m in lines] == [1, 10, 20, 30]
    assert lines[-1]["loss"] < lines[0]["loss"]
    arrays, meta = load_checkpoint(ckpt)
    assert meta["config"]["model_class"] == "TransformerLM"
    model = load_lm_checkpoint(str(save), device="cpu")
    assert model.d_model == 32 and model.vocab_size == 4095
    ref = TransformerLM(**meta["config"]["model"], device="cpu")
    ref.load_state_dict(arrays["model"])
    tok = torch.from_numpy(_tokens(2, 9, 9))
    with torch.no_grad():
        assert torch.equal(model(tok), ref(tok))
    with pytest.raises(ValueError, match="orbax"):
        load_lm_checkpoint(str(tmp_path), device="cpu")
