"""The Trainer's options that the port now takes, against lcasr_tpu on the
CPU in fp32: wild-card CTC (`ops/ctc.wctc_loss`), presegmented utterances
(`data/utterances.py`, `Trainer.train_utterances`, the CLI's
`data.utterances_dir`) and the gradient statistics of `-debug_hooks`
(`training/debug_hooks.py`).  `remat_policy: dots` is held in
tests/test_torch_port_train.py.

Tolerances: wctc's value and gradient are sums over ~40 frames of O(1)
log-probabilities, the same fp32 arithmetic in another order: 1e-5
absolute on the value, 1e-5 on the gradient.  Utterance files and batches
are integers or the same stored values: exact.  The two Trainers' logged
losses per frame: 1e-4 relative, their parameters after two MADGRAD steps
2e-5 absolute (tests/test_torch_port_train.py's tolerances).  Gradient
statistics: 1e-5 relative (norms of float32 tensors summed in another
order).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import flax_from_state_dict, state_dict_from_flax
from tests.test_torch_port_ops import randomize
from tests.test_train_trajectory_parity import _make_corpus


# ---------------------------------------------------------------------------
# wild-card CTC
# ---------------------------------------------------------------------------
def _wctc_inputs(seed=0):
    rng = np.random.default_rng(seed)
    B, T, C, U = 4, 40, 9, 6
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    labels = rng.integers(0, C - 1, (B, U)).astype(np.int32)
    labels[1, 2] = labels[1, 1]  # a repeat: no skip between them
    # ragged; every row can align (a row with fewer frames than labels has
    # an end log-likelihood of -1e30 in both packages, and the soft mode's
    # gradient there is rounding noise of that size)
    input_lengths = np.array([40, 25, 12, 31], np.int32)
    label_lengths = np.array([6, 3, 5, 0], np.int32)  # one empty target
    return lp, labels, input_lengths, label_lengths


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("mode", ["soft", "max_prob", "sum_prob"])
def test_wctc_value_and_gradient_match_jax(mode, reduction):
    from lcasr_tpu.ops.ctc import wctc_loss as jax_wctc
    from lcasr_torch.ops.ctc import wctc_loss

    lp, labels, il, ll = _wctc_inputs()
    weights = np.arange(1, lp.shape[0] + 1, dtype=np.float32)  # weighs the "none" rows

    def scalar(out):
        return out.sum() if reduction != "none" else (out * weights).sum()

    value_j, grad_j = jax.value_and_grad(
        lambda x: scalar(jax_wctc(x, labels, il, ll, mode=mode, reduction=reduction)))(lp)
    x = torch.from_numpy(lp).requires_grad_()
    out = wctc_loss(x, torch.from_numpy(labels), torch.from_numpy(il), torch.from_numpy(ll),
                    mode=mode, reduction=reduction)
    assert out.shape == (() if reduction != "none" else (lp.shape[0],))
    value = out.sum() if reduction != "none" else (out * torch.from_numpy(weights)).sum()
    value.backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(value.item(), float(value_j), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), atol=1e-5, rtol=0)


def test_wctc_refuses_an_unknown_mode():
    from lcasr_torch.ops.ctc import wctc_loss

    lp, labels, il, ll = (torch.from_numpy(a) for a in _wctc_inputs())
    with pytest.raises(ValueError, match="mode"):
        wctc_loss(lp, labels, il, ll, mode="hard")


# ---------------------------------------------------------------------------
# utterances
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def utterances(tmp_path_factory):
    """The same corpus chopped into 256-frame utterances by both packages."""
    from lcasr_tpu.data.tokenizer import load_tokenizer as jax_tokenizer
    from lcasr_tpu.data.utterances import save_utterances as jax_save
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.data.utterances import save_utterances

    root = tmp_path_factory.mktemp("utterances")
    pairs = _make_corpus(root, [700, 520, 900, 300], seed=21)
    saved = save_utterances(pairs, str(root / "port"), load_tokenizer(), chunk_size=256)
    jax_saved = jax_save(pairs, str(root / "jax"), jax_tokenizer(), chunk_size=256)
    return root, saved, jax_saved


def test_saved_utterances_equal_jax_files(utterances):
    root, saved, jax_saved = utterances
    assert [os.path.basename(p) for p in saved] == [os.path.basename(p) for p in jax_saved]
    assert len(saved) >= 8
    for a, b in zip(saved, jax_saved):
        x, y = np.load(a), np.load(b)
        assert set(x.files) == set(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("seen", [0, 3], ids=["all", "seen_3"])
def test_utterance_batches_equal_jax_for_the_same_seed(utterances, seen):
    from lcasr_tpu.data.utterances import UtteranceDataloader as JLoader
    from lcasr_torch.data.utterances import UtteranceDataloader

    root, saved, _ = utterances
    seen_ids = [os.path.basename(p)[:-4] for p in saved[:seen]]
    port = UtteranceDataloader(str(root / "port"), batch_size=3, seen_ids=seen_ids,
                               random_seed=7)
    ref = JLoader(str(root / "port"), batch_size=3, seen_ids=seen_ids, random_seed=7)
    assert port.total_recordings() == ref.total_recordings() == len(saved) - seen
    got, want = list(port), list(ref)
    assert len(got) == len(want) == len(port)
    for g, w in zip(got, want):
        assert g["ids"] == w["ids"] and not set(g["ids"]) & set(seen_ids)
        for k in ("audio", "text", "text_lengths", "audio_lengths"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


UTT_MODEL = dict(d_model=64, n_layers=2, n_heads=2, head_dim=32, subsampling_conv_channels=32,
                 use_rotary=True, checkpoint_every_n_layers=1)


def _utt_config(ckpt_dir, utt_dir=""):
    return {
        "model_class": "SCConformerXL",
        "model": dict(UTT_MODEL),
        "data": {"path": "", "utterances_dir": str(utt_dir)},
        "audio_chunking": {"size": 256, "overlap": 0},
        "training": {"batch_size": 4, "max_epochs": 1, "clip_value": 0.8, "random_seed": 3},
        "optimizer": {"name": "madgrad", "args": {"lr": 1e-3}},
        "scheduler": {"warmup_steps": 1, "final_value": 0.0},
        "checkpointing": {"dir": str(ckpt_dir), "save_every_n_steps": 10 ** 6},
    }


def _logged(ckpt_dir, key):
    return [json.loads(line)[key] for line in open(os.path.join(ckpt_dir, "metrics.jsonl"))
            if f'"{key}"' in line]


def test_train_utterances_two_steps_match_jax(utterances, tmp_path):
    """The same utterance folder, seed and initial weights: the two
    Trainers' first two optimizer steps (the warmup's, then the cosine's
    after the handoff) log the same losses and leave the same parameters."""
    from lcasr_tpu.config import Config as JConfig
    from lcasr_tpu.data.tokenizer import load_tokenizer as jax_tokenizer
    from lcasr_tpu.data.utterances import UtteranceDataloader as JLoader
    from lcasr_tpu.models.registry import load_model as jax_load_model
    from lcasr_tpu.training.trainer import Trainer as JTrainer
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.data.utterances import UtteranceDataloader
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training.trainer import Trainer

    root, saved, _ = utterances
    utt_dir = root / "port"
    first_two = [os.path.basename(p)[:-4] for p in saved[8:]]  # 8 files: two batches of 4

    jtok = jax_tokenizer()
    jcfg = JConfig(_utt_config(tmp_path / "jax", utt_dir))
    jtr = JTrainer(jcfg, jax_load_model(jcfg, jtok.vocab_size()), jtok)
    state = jtr.init_state(jax.random.PRNGKey(0))
    variables = randomize({"params": state["params"], "batch_stats": state["batch_stats"]},
                          seed=22)
    state["params"] = jax.tree.map(jnp.asarray, variables["params"])
    state["batch_stats"] = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state["opt_state"] = jtr.optimizer.init(state["params"])
    state = jtr.train_utterances(
        state, JLoader(str(utt_dir), batch_size=4, seen_ids=first_two, random_seed=3))

    tok = load_tokenizer()
    cfg = Config(_utt_config(tmp_path / "port", utt_dir))
    model = load_model(cfg, tok.vocab_size(), device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    tr = Trainer(cfg, model, tok, device="cpu")
    steps = tr.train_utterances(
        UtteranceDataloader(str(utt_dir), batch_size=4, seen_ids=first_two, random_seed=3))
    assert steps == 2 and _logged(tmp_path / "port", "utterance_step") == [1, 2]
    np.testing.assert_allclose(_logged(tmp_path / "port", "loss"),
                               _logged(tmp_path / "jax", "loss"), rtol=1e-4)
    np.testing.assert_allclose(_logged(tmp_path / "port", "learning_rate"),
                               _logged(tmp_path / "jax", "learning_rate"), rtol=1e-6)
    got = flax_from_state_dict(tr.model.state_dict())
    for coll in ("params", "batch_stats"):
        for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(state[coll]),
                                     jax.tree_util.tree_leaves_with_path(got[coll])):
            np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=0,
                                       err_msg=jax.tree_util.keystr(path))


def test_cli_trains_utterances_with_debug_hooks(utterances, tmp_path):
    """`python -m lcasr_torch.cli.train -config ... -debug_hooks` with
    `data.utterances_dir`: utterance steps are logged, each after the
    gradient statistics of its accumulated gradient."""
    import yaml

    from lcasr_torch.cli.train import main

    root, saved, _ = utterances
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_utt_config(tmp_path / "ckpt", root / "port")))
    main(["-config", str(path), "--device", "cpu", "-debug_hooks"])
    steps = _logged(tmp_path / "ckpt", "utterance_step")
    norms = _logged(tmp_path / "ckpt", "grad/global_norm")
    assert steps == list(range(1, -(-len(saved) // 4) + 1)) and len(norms) == len(steps)
    assert all(np.isfinite(n) and n > 0 for n in norms)
    keys = json.loads(next(line for line in open(tmp_path / "ckpt" / "metrics.jsonl")
                           if "grad/global_norm" in line))
    assert "grad/layers_1/attend/qkv_proj/kernel/norm" in keys


# ---------------------------------------------------------------------------
# debug hooks
# ---------------------------------------------------------------------------
def test_grad_statistics_equal_jax_on_the_same_gradients():
    """Seeded gradients in the flax tree of a 2-layer model: the port's
    statistics over the port's parameter names and layouts have the JAX
    function's keys and values."""
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_tpu.training.debug_hooks import grad_statistics as jax_stats
    from lcasr_torch.training.debug_hooks import grad_statistics

    jm = JModel(vocab_size=16, **UTT_MODEL)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256)))["params"]
    grads = randomize({"params": params}, seed=23)["params"]
    leaves = jax.tree_util.tree_leaves(grads)
    leaves[0][...] = 0.0  # all near zero
    leaves[1][: leaves[1].shape[0] // 2] = 1e-9  # half near zero
    want = jax_stats(jax.tree.map(jnp.asarray, grads))
    got = grad_statistics(state_dict_from_flax({"params": grads}))
    assert set(got) == set(want)
    assert "grad/layers_0/attend/qkv_proj/kernel/std" in got
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-5, abs=1e-12), k


def test_trainer_logs_grad_statistics_only_with_debug_hooks(tmp_path):
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training.trainer import Trainer

    tok = load_tokenizer()
    cfg = Config(_utt_config(tmp_path))
    tr = Trainer(cfg, load_model(cfg, tok.vocab_size(), device="cpu"), tok, device="cpu")
    tr.init_state()
    assert tr.debug_hooks is False
    for p in tr._params():
        p.grad = torch.ones_like(p)
    tr.fold_group(0.5)
    stats = tr.grad_statistics()
    n = sum(p.numel() for p in tr._params())
    assert stats["grad/global_norm"] == pytest.approx(0.5 * n ** 0.5, rel=1e-6)
    tr.optimizer_step(0.0)
    assert not os.path.exists(tmp_path / "metrics.jsonl") or not _logged(
        tmp_path, "grad/global_norm")
