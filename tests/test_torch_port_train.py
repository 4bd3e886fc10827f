"""lcasr_torch's training path against lcasr_tpu's, on the CPU in fp32:
BatchRenorm training statistics, the conv keep-mask, the model's loss and
gradients with train=True, remat, make_chunks, both Trainers over two
optimizer steps, save / resume, and the configuration chip_smoke.py trains.

Tolerances: fp32 on both sides, the same arithmetic in another order.
Module outputs of O(1): 1e-5 absolute.  Gradients of the tiny model's CTC
sum (a sum over ~300 frames): 1e-4 of each tensor's largest entry, and
never below 1e-6 of the largest gradient of all.  The
Trainers' logged losses per frame (~90): 1e-4 relative; their parameters
after two MADGRAD steps (updates of ~1e-4 on O(1) values): 2e-5 absolute.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import flax_from_state_dict, state_dict_from_flax
from tests.test_torch_port_model import TINY
from tests.test_torch_port_ops import randomize
from tests.test_train_trajectory_parity import _make_corpus

ATOL = 1e-5


# ---------------------------------------------------------------------------
# BatchRenorm and the conformer conv in train mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("steps", [0, 5000, 40000], ids=lambda s: f"tracked_{s}")
def test_batch_renorm_train_matches_jax(steps):
    """Batch statistics with a pad mask, the r / d clips at several
    num_batches_tracked, the momentum update, and the input gradient
    (r and d carry no gradient)."""
    from lcasr_tpu.ops.conv import BatchRenorm as JBR
    from lcasr_torch.ops.conv import BatchRenorm

    C = 12
    rng = np.random.default_rng(steps)
    x = (rng.normal(size=(3, 20, C)) * 2 + 0.5).astype(np.float32)
    pad = np.zeros((3, 20), bool)
    pad[1, 13:] = True
    g = rng.normal(size=x.shape).astype(np.float32)
    jm = JBR(C)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), seed=steps + 1)
    v["batch_stats"]["num_batches_tracked"] = np.asarray(steps, np.int32)

    def f(x):
        y, mut = jm.apply(v, x, pad_mask=jnp.asarray(pad), train=True, mutable=["batch_stats"])
        return (y * g).sum(), (y, mut)

    (_, (y_j, mut)), gx_j = jax.value_and_grad(f, has_aux=True)(x)
    m = BatchRenorm(C)
    m.load_state_dict(state_dict_from_flax(v), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt, pad_mask=torch.from_numpy(pad), train=True)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=ATOL)
    for name in ("running_mean", "running_std"):
        np.testing.assert_allclose(getattr(m, name).numpy(),
                                   np.asarray(mut["batch_stats"][name]), atol=1e-6)
    assert int(m.num_batches_tracked) == steps + 1


def test_conv_module_train_uses_the_keep_mask():
    """Static batch with a finished (length 0) row and a short row: the
    keep-mask counts live rows up to the longest live length."""
    from lcasr_tpu.ops.conv import ConformerConvolution as JConv
    from lcasr_torch.ops.conv import ConformerConvolution, _stat_mask

    D = 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 24, D)).astype(np.float32)
    lens = np.array([17, 0, 9])
    pad = np.arange(24)[None, :] >= lens[:, None]
    jm = JConv(D)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), seed=4)
    y_j, mut = jm.apply(v, x, pad_mask=jnp.asarray(pad), train=True, mutable=["batch_stats"])
    m = ConformerConvolution(D)
    m.load_state_dict(state_dict_from_flax(v), strict=True)
    y = m(torch.from_numpy(x), pad_mask=torch.from_numpy(pad), train=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(m.norm.running_std.numpy(),
                               np.asarray(mut["batch_stats"]["norm"]["running_std"]), atol=1e-6)
    keep = ~_stat_mask(torch.from_numpy(pad))
    assert keep.sum(1).tolist() == [17, 0, 17]


# ---------------------------------------------------------------------------
# the model in train mode
# ---------------------------------------------------------------------------
VOCAB = TINY["vocab_size"]


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(3, 80, 320)).astype(np.float32)
    lens = np.array([320, 250, 0], np.int32)
    labels = rng.integers(1, VOCAB, size=(3, 8)).astype(np.int32)
    label_lens = np.array([8, 5, 0], np.int32)
    weight = np.array([1.0, 1.0, 0.0], np.float32)
    return audio, lens, labels, label_lens, weight


def _port_loss(model, audio, lens, labels, label_lens, weight):
    from lcasr_torch.ops.ctc import ctc_loss

    out = model(torch.from_numpy(audio), torch.from_numpy(lens), train=True)
    nll = ctc_loss(out["final_posteriors"].float(), torch.from_numpy(labels), out["length"],
                   torch.from_numpy(label_lens), blank_id=VOCAB, reduction="none")
    nll = torch.where(nll < 1e29, nll, torch.zeros_like(nll))
    return (nll * torch.from_numpy(weight)).sum()


@pytest.mark.parametrize("remat", [False, True, "dots"], ids=["plain", "remat", "remat_dots"])
def test_model_train_loss_and_grads_match_jax(remat):
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_tpu.ops.ctc import ctc_loss as jax_ctc
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    cfg = dict(TINY, checkpoint_every_n_layers=int(bool(remat)), remat_subsampling=bool(remat))
    if remat == "dots":  # jax.checkpoint_policies.dots_saveable on the JAX side
        cfg["remat_policy"] = "dots"
    audio, lens, labels, label_lens, weight = _batch()
    jm = JModel(**cfg)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 320))), seed=6)

    def f(params):
        out, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, audio,
                            length=jnp.asarray(lens), train=True, mutable=["batch_stats"])
        nll = jax_ctc(out["final_posteriors"].astype(jnp.float32), labels, out["length"],
                      label_lens, blank_id=VOCAB, reduction="none")
        return (jnp.where(nll < 1e29, nll, 0.0) * weight).sum(), mut

    (loss_j, mut), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"])
    port = SCConformerXL(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    loss = _port_loss(port, audio, lens, labels, label_lens, weight)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, g_j)})
    params = dict(port.named_parameters())
    assert set(want) == set(params)
    gmax = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        got = params[name].grad
        # a bias in front of BatchRenorm has a gradient that is 0 up to
        # rounding (the batch mean takes it out): its floor is 1e-6 of the
        # largest gradient
        tol = 1e-4 * max(w.abs().max().item(), 1e-2 * gmax)
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=tol, rtol=0, err_msg=name)
    # running statistics moved once, as JAX's mutated batch_stats
    stats = state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    for name, w in stats.items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(), w.numpy(), atol=1e-6,
                                   err_msg=name)


def test_remat_gives_equal_gradients_and_one_stats_update():
    from lcasr_torch.models.sconformer_xl import SCConformerXL, init_weights_

    batch = _batch(seed=7)
    grads, stats = [], []
    for remat in (0, 1):
        m = init_weights_(SCConformerXL(**TINY, checkpoint_every_n_layers=remat,
                                        remat_subsampling=bool(remat), device="cpu"), seed=8)
        _port_loss(m, *batch).backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
        stats.append({n: b.clone() for n, b in m.named_buffers() if "running" in n or "tracked" in n})
        assert int(m.layers[1].conv.norm.num_batches_tracked) == 1
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=1e-6)
    for n in stats[0]:
        assert torch.equal(stats[0][n], stats[1][n]), n


def test_dropout_masks_repeat_under_remat():
    """Dropout > 0: the recompute draws the same masks (one seed per layer
    call), so remat does not change the gradient."""
    from lcasr_torch.models.sconformer_xl import SCConformerXL, init_weights_

    batch = _batch(seed=9)
    grads = []
    for remat in (0, 1):
        m = init_weights_(SCConformerXL(**TINY, dropout_ff=0.2, dropout_conv=0.1,
                                        dropout_attn=0.1, checkpoint_every_n_layers=remat,
                                        device="cpu"), seed=10)
        _port_loss(m, *batch).backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_remat_policy_dots_gives_the_gradients_of_nothing():
    """remat_policy "dots" saves the matrix products' outputs and recomputes
    the rest: the loss, the gradients and the one update of the running
    statistics are those of "nothing" (the same fp32 ops on the CPU, so
    within 1e-6); an unknown policy raises as in the JAX model."""
    from lcasr_torch.models.sconformer_xl import SCConformerXL, init_weights_

    batch = _batch(seed=11)
    runs = []
    for policy in ("nothing", "dots"):
        m = init_weights_(SCConformerXL(**TINY, checkpoint_every_n_layers=1,
                                        remat_policy=policy, device="cpu"), seed=12)
        loss = _port_loss(m, *batch)
        loss.backward()
        assert int(m.layers[1].conv.norm.num_batches_tracked) == 1
        runs.append((loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()},
                     {n: b.clone() for n, b in m.named_buffers() if "running" in n}))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    for n in runs[0][1]:
        torch.testing.assert_close(runs[1][1][n], runs[0][1][n], rtol=0, atol=1e-6)
    for n in runs[0][2]:
        torch.testing.assert_close(runs[1][2][n], runs[0][2][n], rtol=0, atol=1e-7)
    with pytest.raises(ValueError):
        SCConformerXL(**TINY, remat_policy="everything", device="cpu")


# ---------------------------------------------------------------------------
# make_chunks and the two Trainers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _make_corpus(tmp_path_factory.mktemp("port_corpus"), [256, 256, 256, 256], seed=12)


def test_make_chunks_matches_jax(tmp_path):
    from lcasr_tpu.training.trainer import make_chunks as jax_chunks
    from lcasr_torch.data.dataloading import load_sample
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.training.trainer import make_chunks

    pairs = _make_corpus(tmp_path, [700, 300, 520], seed=13)
    specs, txts = zip(*(load_sample(e) for e in pairs.values()))
    T = max(s.shape[-1] for s in specs)
    audio = np.zeros((3, 80, T), np.float32)
    for i, s in enumerate(specs):
        audio[i, :, : s.shape[-1]] = s[0]
    lens = np.array([s.shape[-1] for s in specs])
    words = [t["results"][-1]["alternatives"][0]["words"] for t in txts]
    tok = load_tokenizer()
    want = jax_chunks(audio, lens, words, tok, 256, 0, tok.pad_id())
    got = make_chunks(audio, lens, words, tok, 256, 0, tok.pad_id())
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got[-1]["weight"].tolist() == [1.0, 0.0, 1.0]  # 300 frames: done after 2


MODEL_KW = dict(d_model=64, n_layers=2, n_heads=2, head_dim=32, subsampling_conv_channels=32,
                use_rotary=True, checkpoint_every_n_layers=1, remat_subsampling=True)


def _config(corpus, ckpt_dir):
    return {
        "model_class": "SCConformerXL",
        "model": dict(MODEL_KW),
        "data": {"path": ""},
        "audio_chunking": {"size": 256, "overlap": 0},
        "training": {"batch_size": 2, "backprop_every": 1, "max_epochs": 1, "clip_value": 0.8,
                     "random_seed": 12345},
        "optimizer": {"name": "madgrad", "args": {"lr": 1e-3}},
        "scheduler": {"warmup_steps": 1, "final_value": 0.0},
        "checkpointing": {"dir": str(ckpt_dir), "save_every_n_steps": 10 ** 6},
    }


def _losses(ckpt_dir):
    return [json.loads(line)["loss"] for line in open(os.path.join(ckpt_dir, "metrics.jsonl"))
            if "loss" in line]


def _port_trainer(corpus, ckpt_dir, variables):
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training.trainer import Trainer

    tok = load_tokenizer()
    cfg = Config(_config(corpus, ckpt_dir))
    model = load_model(cfg, tok.vocab_size(), device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    trainer = Trainer(cfg, model, tok, device="cpu")
    trainer.init_state()
    return trainer


def test_two_optimizer_steps_of_both_trainers_agree(corpus, tmp_path):
    """Same corpus, same initial weights, chunk 256 x batch 2: two batches
    of one chunk each, so two optimizer steps (the first at the warmup's
    lr 0, the second at the peak)."""
    from lcasr_tpu.config import Config as JConfig
    from lcasr_tpu.data.dataloading import VariableBatchSimpleDataloader as JLoader
    from lcasr_tpu.data.tokenizer import load_tokenizer as jax_tokenizer
    from lcasr_tpu.models.registry import load_model as jax_load_model
    from lcasr_tpu.training.trainer import Trainer as JTrainer
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader

    jtok = jax_tokenizer()
    jcfg = JConfig(_config(corpus, tmp_path / "jax"))
    jtr = JTrainer(jcfg, jax_load_model(jcfg, jtok.vocab_size()), jtok)
    state = jtr.init_state(jax.random.PRNGKey(0))
    variables = randomize({"params": state["params"], "batch_stats": state["batch_stats"]},
                          seed=14)
    state["params"] = jax.tree.map(jnp.asarray, variables["params"])
    state["batch_stats"] = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state["opt_state"] = jtr.optimizer.init(state["params"])
    state = jtr.train(state, JLoader(pairs=corpus, tokenizer=jtok, batch_size=2, chunk_size=256,
                                     chunk_overlap=0, prefetch=False))

    tr = _port_trainer(corpus, tmp_path / "port", variables)
    tr.train(VariableBatchSimpleDataloader(pairs=corpus, tokenizer=tr.tokenizer, batch_size=2,
                                           chunk_size=256, chunk_overlap=0))
    losses_j, losses_t = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(losses_j) == len(losses_t) == 2
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    got = flax_from_state_dict(tr.model.state_dict())
    moved = 0.0
    for coll in ("params", "batch_stats"):
        for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(state[coll]),
                                     jax.tree_util.tree_leaves_with_path(got[coll])):
            np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=0,
                                       err_msg=jax.tree_util.keystr(path))
    for (_, w), (_, w0) in zip(jax.tree_util.tree_leaves_with_path(state["params"]),
                               jax.tree_util.tree_leaves_with_path(variables["params"])):
        moved = max(moved, float(np.abs(np.asarray(w) - w0).max()))
    assert moved > 1e-4  # the second step did move the parameters


def test_save_resume_round_trip(corpus, tmp_path):
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader

    jm = JModel(vocab_size=4095, **MODEL_KW)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256))), seed=15)
    tr = _port_trainer(corpus, tmp_path, v)
    tr.train(VariableBatchSimpleDataloader(pairs=corpus, tokenizer=tr.tokenizer, batch_size=2,
                                           chunk_size=256, chunk_overlap=0))
    meta = json.load(open(tmp_path / "step_4" / "meta.json"))
    assert set(meta) == {"podcast_step", "epoch", "seen_ids", "config", "scheduler",
                         "sequence_scheduler"}
    fresh = _port_trainer(corpus, tmp_path, randomize(v, seed=16))
    step, epoch, seen = fresh.resume()
    assert (step, epoch) == (4, 1) and seen == meta["seen_ids"] and len(seen) == 4
    for (n, a), b in zip(tr.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = tr.optimizer.state_dict(), fresh.optimizer.state_dict()
    for k in sa["state"]:
        for name, val in sa["state"][k].items():
            assert torch.equal(torch.as_tensor(val), torch.as_tensor(sb["state"][k][name]))
    assert fresh.scheduler.state_dict() == tr.scheduler.state_dict()


def test_resume_refuses_a_stale_reprojection(corpus, tmp_path):
    """A checkpoint written while the decoder always made its reprojection
    holds two parameters that a model without self-conditioning lacks (and
    its optimizer state counts them): resuming refuses it by name."""
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training import checkpointing
    from lcasr_torch.training.trainer import Trainer

    tok = load_tokenizer()
    cfg_d = _config(corpus, tmp_path)
    cfg_d["model"]["self_conditioning"] = False
    cfg = Config(cfg_d)
    trainer = Trainer(cfg, load_model(cfg, tok.vocab_size(), device="cpu"), tok, device="cpu")
    trainer.init_state()
    state = dict(trainer.model.state_dict())
    assert not any(k.startswith("decoder.reprojection.") for k in state)
    n_classes, d_model = tok.vocab_size() + 1, MODEL_KW["d_model"]
    state["decoder.reprojection.weight"] = torch.zeros(d_model, n_classes)
    state["decoder.reprojection.bias"] = torch.zeros(d_model)
    checkpointing.save_checkpoint(str(tmp_path), step=1, model_state=state, config=cfg)
    with pytest.raises(ValueError, match="decoder.reprojection.weight"):
        trainer.resume()


def test_mesh_larger_than_the_host_runs_on_one_device(capsys, corpus, tmp_path):
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.sconformer_xl import SCConformerXL
    from lcasr_torch.training.trainer import Trainer

    cfg = Config(dict(_config(corpus, tmp_path), parallel={"mesh": {"data": 64}}))
    tok = load_tokenizer()
    Trainer(cfg, SCConformerXL(vocab_size=4095, **MODEL_KW, device="cpu"), tok, device="cpu")
    assert "running single-device" in capsys.readouterr().out


def test_trainer_without_device_raises_when_no_gpu(corpus, tmp_path):
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import SCConformerXL
    from lcasr_torch.training.trainer import Trainer

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None means cuda there")
    cfg = Config(_config(corpus, tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(cfg, 4095)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, SCConformerXL(vocab_size=4095, **MODEL_KW, device="cpu"),
                load_tokenizer())


# ---------------------------------------------------------------------------
# the configuration chip_smoke.py trains
# ---------------------------------------------------------------------------
def test_chip_smoke_config_is_the_ladder_yaml():
    import yaml

    import chip_smoke
    from lcasr_torch.config import Config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "ladder_9l_768d_6h.yaml")) as f:
        assert chip_smoke.LADDER_CONFIG == yaml.safe_load(f)
    loaded = Config.load(os.path.join(root, "configs", "ladder_9l_768d_6h.yaml"))
    over = [f"{a}.{b}={v}" for a, d in chip_smoke.SMOKE_OVERRIDES.items() for b, v in d.items()]
    want = loaded.apply_overrides(over).to_dict()
    assert chip_smoke.merged(chip_smoke.LADDER_CONFIG, chip_smoke.SMOKE_OVERRIDES) == want
    # the overrides are only the ladder's start, its stop and the save cadence
    assert set(chip_smoke.SMOKE_OVERRIDES) == {"audio_chunking", "training",
                                               "sequence_scheduler", "checkpointing"}


# ---------------------------------------------------------------------------
# SpecAugment with injected masks
# ---------------------------------------------------------------------------
def test_spec_augment_with_the_jax_masks_matches_jax():
    """The JAX module draws its masks inside; `_draw_jax_masks` replays the
    same draws, and the port applies them: the masked spectrograms agree
    (fill value: the length-aware mean, computed by each framework)."""
    from lcasr_tpu.data.augmentation import SpecAugment as JAug
    from lcasr_torch.data.augmentation import SpecAugment
    from tests.test_train_trajectory_parity import SPEC_AUGMENT_CFG, _draw_jax_masks

    rng = np.random.default_rng(17)
    spec = rng.normal(size=(3, 80, 256)).astype(np.float32)
    lens = np.array([256, 200, 90], np.int32)
    key = jax.random.PRNGKey(5)
    want = JAug(**SPEC_AUGMENT_CFG)(key, jnp.asarray(spec), jnp.asarray(lens))
    masks = [(axis, torch.from_numpy(s), torch.from_numpy(e))
             for axis, s, e in _draw_jax_masks(key, 3, 80, 256, SPEC_AUGMENT_CFG)]
    aug = SpecAugment(**SPEC_AUGMENT_CFG)
    got = aug.apply(torch.from_numpy(spec), torch.from_numpy(lens), masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    drawn = aug.draw_masks(3, 80, 256, torch.Generator().manual_seed(0))
    assert [m[0] for m in drawn] == [m[0] for m in masks]  # time masks first
    assert all((e >= s).all() for _, s, e in drawn)


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------
def test_cli_train_runs_on_the_cpu_and_resumes(corpus, tmp_path):
    """`python -m lcasr_torch.cli.train -config ... --device cpu` at a tiny
    size: trains the corpus, saves, and a second invocation resumes past
    the finished epoch without training again."""
    import yaml

    from lcasr_torch.cli.train import main

    cfg = _config(corpus, tmp_path / "ckpt")
    pairs = tmp_path / "pairs.json"
    pairs.write_text(json.dumps(corpus))
    cfg["data"]["path"] = str(pairs)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    main(["-config", str(path), "--device", "cpu"])
    assert len(_losses(tmp_path / "ckpt")) == 2
    assert os.path.exists(tmp_path / "ckpt" / "step_4" / "meta.json")
    main(["-config", str(path), "--device", "cpu"])
    assert len(_losses(tmp_path / "ckpt")) == 2  # epoch 1 of 1 was done


# the gradient gate chip_smoke.py holds the training steps to
def _fake_step(base, state):
    from lcasr_torch import kernels

    def one_step():
        kernels.launch_counts["flash_attention_fwd"] += 1  # the gate asks for a launch
        gen = torch.Generator().manual_seed(state["draw"])
        state["draw"] += 1
        return 1.0 + state["noise"], {n: v + state["noise"] * torch.randn(v.shape, generator=gen)
                                      for n, v in base.items()}
    return one_step


@pytest.mark.parametrize("kernel_noise,passes", [(1e-3, True), (2e-2, False)])
def test_chip_smoke_gradient_gate_takes_the_largest_yardstick(kernel_noise, passes):
    import contextlib

    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    base = {f"w{i}": torch.randn(64, generator=gen) for i in range(4)}
    state = {"noise": 0.0, "draw": 0}

    @contextlib.contextmanager
    def noise(x):
        old, state["noise"] = state["noise"], x
        try:
            yield
        finally:
            state["noise"] = old

    # yardsticks at 1e-4 and 2e-3: the gate is 3x the larger
    yardsticks = {"small": noise(1e-4), "large": noise(2e-3)}
    run = lambda: chip_smoke.gradient_gate("fake", "the reference", _fake_step(base, state),
                                           noise(0.0), yardsticks, kernel_ctx=noise(kernel_noise),
                                           plain_contexts=False)
    from lcasr_torch import kernels

    try:
        if passes:
            got = run()
            assert got["rel_l2"] <= got["rel_l2_max"] and 5e-3 < got["rel_l2_max"] < 7e-3
        else:
            with pytest.raises(AssertionError, match="disagrees"):
                run()
    finally:
        kernels.reset_launch_counts()


def test_chip_smoke_subsampling_without_cudnn_keeps_the_chains_gradient():
    """On the CPU the other convolution kernels are the same ones: the value
    and the gradient equal the plain chain's."""
    import chip_smoke
    import lcasr_torch.ops.conv as conv
    from lcasr_torch.ops.subsampling import dw_striding_chain

    gen = torch.Generator().manual_seed(1)
    C = 8
    shapes = [(C, 1, 3, 3), (C,)] + [(C, 1, 3, 3), (C,), (C, C, 1, 1), (C,)] * 2
    params = [torch.randn(s, generator=gen).requires_grad_() for s in shapes]
    h = torch.randn((2, 1, 32, 16), generator=gen)
    with chip_smoke.subsampling_without_cudnn():
        y = conv.dw_striding_chain(h, params)
    assert conv.dw_striding_chain is dw_striding_chain
    got = torch.autograd.grad(y.square().sum(), params)
    y_ref = dw_striding_chain(h, params)
    want = torch.autograd.grad(y_ref.square().sum(), params)
    assert torch.equal(y, y_ref)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
