"""lcasr_torch's bidirectional-Mamba model against lcasr_tpu's, on the CPU in
fp32: the mixer, the whole model, the converter, the weight-decay grouping,
the streaming decode, one training step's loss and gradient, and a short
Trainer run.

Weights come from flax `init`, are redrawn from a numpy seed
(`tests/test_torch_port_ops.py::randomize`), go through
`state_dict_from_flax` and are loaded with strict=True.  Both sides run the
selective scan in fp32 (JAX's associative-scan reference, the port's
sequential plain version).  Log-probs are compared at atol 1e-4, as for the
conformer (tests/test_torch_port_model.py): the same fp32 arithmetic in
another order through two layers leaves differences of a few 1e-6, and a
wrong layout, flip or op order moves log-probs by 1e-2 or more.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import flax_from_state_dict, state_dict_from_flax
from tests.test_torch_port_ops import assert_close, load_port, randomize, t
from tests.test_train_trajectory_parity import _make_corpus

ATOL = 1e-4
TINY = dict(vocab_size=16, d_model=64, n_layers=2, subsampling_conv_channels=32)


def _pair(cfg, T, seed=0):
    from lcasr_tpu.models.mamba import Mamba as JModel
    from lcasr_torch.models.mamba import Mamba

    jm = JModel(**cfg)
    variables = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 80, T))),
                          seed=seed)
    port = Mamba(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, port


@pytest.mark.parametrize("lengths", [np.array([37, 20, 1], np.int32), None],
                         ids=["ragged", "no_lengths"])
def test_mixer_matches_jax(lengths):
    from lcasr_tpu.models.mamba import BiMambaMixer as JMixer
    from lcasr_torch.models.mamba import BiMambaMixer

    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 37, 64)).astype(np.float32)
    jm = JMixer(d_model=64, n_layer=2)
    jl = None if lengths is None else jnp.asarray(lengths)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jl), seed=2)
    want = jm.apply(v, jnp.asarray(x), jl)
    port = load_port(BiMambaMixer(64, n_layer=2), v)
    with torch.no_grad():
        got = port(t(x), None if lengths is None else t(lengths))
    assert_close(got, want, atol=ATOL)


@pytest.mark.parametrize("variant", ["lengths", "no_lengths", "no_self_conditioning", "stacking",
                                     "norm_out"])
def test_tiny_model_matches_jax(variant):
    cfg = dict(TINY)
    if variant == "no_self_conditioning":
        cfg.update(self_conditioning=False)
    if variant == "stacking":
        cfg.update(subsampling="stacking")
    if variant == "norm_out":
        cfg.update(subsampling_norm_out=True, subsampling_conv_channels=-1)
    jm, variables, port = _pair(cfg, 300, seed=3)
    rng = np.random.default_rng(4)
    audio = rng.normal(size=(3, 80, 300)).astype(np.float32)
    lengths = None if variant == "no_lengths" else np.array([300, 211, 97], np.int32)
    want = jax.jit(jm.apply)(variables, audio,
                             length=None if lengths is None else jnp.asarray(lengths))
    with torch.no_grad():
        got = port(t(audio), length=None if lengths is None else t(lengths))
    lp = got["final_posteriors"]
    assert lp.dtype == torch.float32 and lp.shape == want["final_posteriors"].shape
    np.testing.assert_array_equal(got["length"].numpy(), np.asarray(want["length"]))
    assert_close(lp, want["final_posteriors"], atol=ATOL)
    with torch.no_grad():
        logits = port(t(audio), length=None if lengths is None else t(lengths),
                      return_logits=True)["final_posteriors"]
    assert_close(torch.log_softmax(logits, -1), lp, atol=1e-6)


def test_default_widths_match_jax():
    """The class defaults (d_model 768: d_inner 1536, half 768, dt_rank 48,
    d_state 16) at two layers."""
    cfg = dict(vocab_size=4095, n_layers=2)
    jm, variables, port = _pair(cfg, 128, seed=5)
    mixer = port.layers[0].mixer
    assert mixer.dt_rank == 48 and mixer.A_log.shape == (768, 16)
    assert mixer.in_proj.weight.shape == (3072, 768) and mixer.x_proj.weight.shape == (80, 768)
    audio = np.random.default_rng(6).normal(size=(2, 80, 128)).astype(np.float32)
    lengths = np.array([128, 90], np.int32)
    want = jax.jit(jm.apply)(variables, audio, length=jnp.asarray(lengths))["final_posteriors"]
    with torch.no_grad():
        got = port(t(audio), length=t(lengths))["final_posteriors"]
    assert_close(got, want, atol=ATOL)


def test_bf16_model_runs_and_tracks_fp32():
    from lcasr_torch.models.mamba import Mamba

    _, variables, _ = _pair(TINY, 128, seed=7)
    audio = t(np.random.default_rng(8).normal(size=(2, 80, 256)).astype(np.float32))
    lengths = torch.tensor([256, 100], dtype=torch.int32)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        m = Mamba(**TINY, dtype=dt, device="cpu")
        m.load_state_dict(state_dict_from_flax(variables), strict=True)
        with torch.no_grad():
            outs[dt] = m(audio, length=lengths)["final_posteriors"]
    lp = outs[torch.bfloat16]
    assert lp.dtype == torch.float32 and torch.isfinite(lp).all()
    np.testing.assert_allclose(lp.exp().sum(-1).numpy(), 1.0, atol=1e-4)
    # bf16 keeps ~3 significant digits through two layers
    assert (lp - outs[torch.float32]).abs().max() < 0.25


# ---------------------------------------------------------------------------
# converter, registry, grouping, initialisers
# ---------------------------------------------------------------------------
def test_converter_loads_strict_round_trips_and_refuses_unknown_names():
    from lcasr_torch.models.mamba import Mamba

    _, variables, port = _pair(TINY, 128, seed=9)
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(port.state_dict())
    p = variables["params"]["layers_1"]["mixer"]
    np.testing.assert_array_equal(sd["layers.1.mixer.in_proj.weight"].numpy(),
                                  p["in_proj"]["kernel"].T)
    for raw in ("conv1d_fwd_kernel", "conv1d_rvse_bias", "dt_proj_kernel", "dt_proj_bias",
                "A_log", "D"):
        np.testing.assert_array_equal(sd[f"layers.1.mixer.{raw}"].numpy(), p[raw])
    back = flax_from_state_dict(sd)
    assert set(back) == {"params"}
    flat = lambda tree: {jax.tree_util.keystr(k): v
                         for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    a, b = flat(back["params"]), flat(variables["params"])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    del sd["layers.0.mixer.D"]
    with pytest.raises(RuntimeError):
        Mamba(**TINY, device="cpu").load_state_dict(sd, strict=True)
    bad = dict(variables["params"])
    bad["layers_0"] = dict(bad["layers_0"], mystery={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unknown module"):
        state_dict_from_flax({"params": bad})
    bad = dict(variables["params"])
    bad["decoder"] = dict(bad["decoder"], B_log=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unknown params leaf"):
        state_dict_from_flax({"params": bad})


def test_decay_mask_matches_jax():
    from lcasr_tpu.models.base import decay_mask as jax_mask
    from lcasr_torch.models.base import decay_mask

    from lcasr_torch.models.import_jax import flax_path

    jm, variables, port = _pair(TINY, 128)
    want = {tuple(k.key for k in path): bool(v) for path, v in
            jax.tree_util.tree_leaves_with_path(jax_mask(variables["params"], model=jm))}
    params = dict(port.named_parameters())
    got = decay_mask(port)
    assert {flax_path(k, params[k])[1]: v for k, v in got.items()} == want
    assert {k for k, v in got.items() if v} == {
        "layers.0.norm.scale", "layers.1.norm.scale", "decoder.norm.scale"}


def test_registry_builds_mamba_and_keeps_each_class_its_own_options():
    from lcasr_torch.config import Config
    from lcasr_torch.models.mamba import Mamba
    from lcasr_torch.models.registry import get_model_class, load_model
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    assert get_model_class({"model_class": "Mamba"}) is Mamba
    assert get_model_class({}) is SCConformerXL
    with pytest.raises(NotImplementedError, match="Mamba.*SCConformerXL"):
        get_model_class({"model_class": "NoSuchModel"})
    cfg = {"model_class": "Mamba", "training": {"dtype": "bfloat16"},
           # keys of another class are ignored, as the JAX registry ignores them
           "model": dict(TINY, checkpoint_every_n_layers=1, conv_type="longconv", n_heads=2)}
    model = load_model(Config(cfg), 16, device="cpu")
    assert isinstance(model, Mamba) and model.dtype == torch.bfloat16
    assert model.checkpoint_every_n_layers == 1
    assert model.layers[0].mixer.in_proj.weight.dtype == torch.float32
    # W8A8 is taken (tests/test_torch_port_qdense.py): the mixers' projections
    # are site "proj", the decoder's "decoder"
    for value, proj in ((True, True), ("auto", False), (["proj"], True)):
        cfg["model"]["quant_w8a8"] = value
        quant = load_model(Config(cfg), 16, device="cpu")
        assert quant.layers[0].mixer.in_proj.quant == proj
        assert quant.decoder.ff.quant == (value != ["proj"])
    cfg["model"]["quant_w8a8"] = False
    load_model(Config(cfg), 16, device="cpu")
    with pytest.raises(TypeError):
        Mamba(**TINY, device="cpu", n_heads=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Mamba(**TINY)


def test_initialisers_follow_the_jax_model():
    """Bounds and structure of the mixer's initial parameters, drawn from an
    explicit generator: the same seed gives the same model."""
    from lcasr_torch.models.mamba import Mamba

    m = Mamba(vocab_size=16, d_model=64, n_layers=4, subsampling_conv_channels=32,
              init_seed=3, device="cpu")
    mx = m.layers[2].mixer
    half, d_inner = 64, 128
    assert mx.in_proj.weight.abs().max() <= 64 ** -0.5
    assert mx.in_proj.weight.abs().max() > 0.9 * 64 ** -0.5
    assert mx.out_proj.weight.abs().max() <= d_inner ** -0.5 / 2  # 1 / sqrt(4 layers)
    assert mx.y_out.weight.abs().max() <= d_inner ** -0.5
    assert mx.conv1d_fwd_kernel.shape == (4, half) and mx.conv1d_rvse_bias.abs().max() <= 0.5
    assert mx.dt_proj_kernel.abs().max() <= 4 ** -0.5  # dt_rank = ceil(64 / 16)
    dt0 = torch.nn.functional.softplus(mx.dt_proj_bias)
    assert dt0.min() >= 0.001 * 0.999 and dt0.max() <= 0.1 * 1.001
    torch.testing.assert_close(mx.A_log.exp(), torch.arange(1.0, 17.0).expand(half, 16))
    assert torch.equal(mx.D, torch.ones(half))
    again = Mamba(vocab_size=16, d_model=64, n_layers=4, subsampling_conv_channels=32,
                  init_seed=3, device="cpu")
    other = Mamba(vocab_size=16, d_model=64, n_layers=4, subsampling_conv_channels=32,
                  init_seed=4, device="cpu")
    assert torch.equal(again.layers[2].mixer.x_proj.weight, mx.x_proj.weight)
    assert not torch.equal(other.layers[2].mixer.x_proj.weight, mx.x_proj.weight)
    assert not torch.equal(m.layers[1].mixer.x_proj.weight, mx.x_proj.weight)


# ---------------------------------------------------------------------------
# the slice as a whole: streaming decode
# ---------------------------------------------------------------------------
N_CLASSES = TINY["vocab_size"] + 1
SEQ_LEN, OVERLAP, WB = 256, 192, 4


@pytest.fixture(scope="module")
def decoders():
    from lcasr_tpu.evaluation.streaming import StreamingDecoder as JDec
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    jm, variables, port = _pair(TINY, SEQ_LEN, seed=10)
    jdec = JDec(jm, variables, N_CLASSES, window_batch_size=WB, transfer_dtype=jnp.float32)
    tdec = StreamingDecoder(port, N_CLASSES, window_batch_size=WB,
                            transfer_dtype=torch.float32, device="cpu")
    spec = np.random.default_rng(11).normal(size=(1, 80, 1000)).astype(np.float32)
    return jdec, tdec, spec


def test_streaming_logits_match_jax(decoders):
    """13 windows (a ragged last one, three zero-length padding windows):
    the reverse half flips within each window's length."""
    jdec, tdec, spec = decoders
    want = jdec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    got = tdec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    assert got.shape == want.shape == (125, N_CLASSES)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_streaming_greedy_ids_match_jax(decoders):
    """Ids are equal except where JAX's top-2 margin is below 1e-5."""
    jdec, tdec, spec = decoders
    want = np.asarray(jdec.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP))
    got = tdec.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    top2 = np.sort(jdec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP), axis=-1)[:, -2:]
    close = (top2[:, 1] - top2[:, 0]) < 1e-5
    np.testing.assert_array_equal(got[~close], want[~close])


# ---------------------------------------------------------------------------
# the slice as a whole: training
# ---------------------------------------------------------------------------
VOCAB = TINY["vocab_size"]


def _batch(seed=12):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(3, 80, 320)).astype(np.float32)
    lens = np.array([320, 250, 0], np.int32)
    labels = rng.integers(1, VOCAB, size=(3, 8)).astype(np.int32)
    label_lens = np.array([8, 5, 0], np.int32)
    weight = np.array([1.0, 1.0, 0.0], np.float32)
    return audio, lens, labels, label_lens, weight


def _port_loss(model, audio, lens, labels, label_lens, weight):
    from lcasr_torch.ops.ctc import ctc_loss

    out = model(t(audio), t(lens), train=True)
    nll = ctc_loss(out["final_posteriors"].float(), t(labels), out["length"], t(label_lens),
                   blank_id=VOCAB, reduction="none")
    nll = torch.where(nll < 1e29, nll, torch.zeros_like(nll))
    return (nll * t(weight)).sum()


@pytest.mark.parametrize("remat", [0, 1], ids=["plain", "remat"])
def test_train_step_loss_and_whole_gradient_match_jax(remat):
    """One training step: the CTC loss and the gradient of every parameter
    against jax.grad of the JAX loss on the same batch.  The port's backward
    goes through the autograd Function and the written-out reverse
    recurrence, JAX's through the associative scan's VJP."""
    from lcasr_tpu.ops.ctc import ctc_loss as jax_ctc
    from lcasr_torch.models.mamba import Mamba

    audio, lens, labels, label_lens, weight = _batch()
    jm, v, _ = _pair(TINY, 320, seed=13)

    def f(params):
        out = jm.apply({"params": params}, audio, length=jnp.asarray(lens), train=True)
        nll = jax_ctc(out["final_posteriors"].astype(jnp.float32), labels, out["length"],
                      label_lens, blank_id=VOCAB, reduction="none")
        return (jnp.where(nll < 1e29, nll, 0.0) * weight).sum()

    loss_j, g_j = jax.jit(jax.value_and_grad(f))(v["params"])
    port = Mamba(**TINY, checkpoint_every_n_layers=remat, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    loss = _port_loss(port, audio, lens, labels, label_lens, weight)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, g_j)})
    params = dict(port.named_parameters())
    assert set(want) == set(params)
    gmax = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        # fp32 in another order: 1e-4 of the tensor's largest gradient, with
        # a floor of 1e-6 of the largest gradient of all
        tol = 1e-4 * max(w.abs().max().item(), 1e-2 * gmax)
        np.testing.assert_allclose(params[name].grad.numpy(), w.numpy(), atol=tol, rtol=0,
                                   err_msg=name)


def test_remat_changes_no_gradient():
    from lcasr_torch.models.mamba import Mamba

    batch = _batch(seed=14)
    plain = Mamba(**TINY, init_seed=5, device="cpu")
    remat = Mamba(**TINY, checkpoint_every_n_layers=1, device="cpu")
    remat.load_state_dict(plain.state_dict())
    for m in (plain, remat):
        _port_loss(m, *batch).backward()
    for (n, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert p.grad.abs().max() > 0, n
        torch.testing.assert_close(q.grad, p.grad, rtol=0, atol=1e-6, msg=n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _make_corpus(tmp_path_factory.mktemp("mamba_corpus"), [256, 256, 256, 256], seed=15)


MODEL_KW = dict(d_model=64, n_layers=2, subsampling_conv_channels=32, checkpoint_every_n_layers=1)


def _config(ckpt_dir):
    return {
        "model_class": "Mamba",
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


def _port_trainer(ckpt_dir, variables):
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training.trainer import Trainer

    tok = load_tokenizer()
    cfg = Config(_config(ckpt_dir))
    model = load_model(cfg, tok.vocab_size(), device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    trainer = Trainer(cfg, model, tok, device="cpu")
    trainer.init_state()
    return trainer


def test_two_optimizer_steps_of_both_trainers_agree(corpus, tmp_path):
    """Same corpus, same initial weights, chunk 256 x batch 2, model_class
    Mamba in both Trainers: two optimizer steps (warmup lr 0, then the
    peak); losses and every trained parameter agree."""
    from lcasr_tpu.config import Config as JConfig
    from lcasr_tpu.data.dataloading import VariableBatchSimpleDataloader as JLoader
    from lcasr_tpu.data.tokenizer import load_tokenizer as jax_tokenizer
    from lcasr_tpu.models.registry import load_model as jax_load_model
    from lcasr_tpu.training.trainer import Trainer as JTrainer
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader

    jtok = jax_tokenizer()
    jcfg = JConfig(_config(tmp_path / "jax"))
    jtr = JTrainer(jcfg, jax_load_model(jcfg, jtok.vocab_size()), jtok)
    state = jtr.init_state(jax.random.PRNGKey(0))
    variables = randomize({"params": state["params"]}, seed=16)
    state["params"] = jax.tree.map(jnp.asarray, variables["params"])
    state["opt_state"] = jtr.optimizer.init(state["params"])
    state = jtr.train(state, JLoader(pairs=corpus, tokenizer=jtok, batch_size=2, chunk_size=256,
                                     chunk_overlap=0, prefetch=False))

    tr = _port_trainer(tmp_path / "port", variables)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.train(VariableBatchSimpleDataloader(pairs=corpus, tokenizer=tr.tokenizer, batch_size=2,
                                           chunk_size=256, chunk_overlap=0))
    losses_j, losses_t = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(losses_j) == len(losses_t) == 2 and np.isfinite(losses_t).all()
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    got = flax_from_state_dict(tr.model.state_dict())
    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(state["params"]),
                                 jax.tree_util.tree_leaves_with_path(got["params"])):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in tr.model.named_parameters())
    assert moved > 1e-4  # the second step did move the parameters


def test_trainer_save_resume_round_trip(corpus, tmp_path):
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader

    _, v, _ = _pair(dict(vocab_size=4095, **{k: MODEL_KW[k] for k in MODEL_KW
                                             if k != "checkpoint_every_n_layers"}), 256, seed=17)
    tr = _port_trainer(tmp_path, v)
    assert tr._stat_buffers() == []  # no BatchRenorm in this family
    tr.train(VariableBatchSimpleDataloader(pairs=corpus, tokenizer=tr.tokenizer, batch_size=2,
                                           chunk_size=256, chunk_overlap=0))
    assert np.isfinite(_losses(tmp_path)).all()
    meta = json.load(open(tmp_path / "step_4" / "meta.json"))
    assert meta["config"]["model_class"] == "Mamba"
    fresh = _port_trainer(tmp_path, randomize(v, seed=18))
    step, epoch, seen = fresh.resume()
    assert (step, epoch) == (4, 1) and seen == meta["seen_ids"] and len(seen) == 4
    for (n, a), b in zip(tr.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = tr.optimizer.state_dict(), fresh.optimizer.state_dict()
    for k in sa["state"]:
        for name, val in sa["state"][k].items():
            assert torch.equal(torch.as_tensor(val), torch.as_tensor(sb["state"][k][name]))


def test_cli_train_runs_mamba_on_the_cpu(corpus, tmp_path):
    import yaml

    from lcasr_torch.cli.train import main

    cfg = _config(tmp_path / "ckpt")
    pairs = tmp_path / "pairs.json"
    pairs.write_text(json.dumps(corpus))
    cfg["data"]["path"] = str(pairs)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    main(["-config", str(path), "--device", "cpu"])
    assert len(_losses(tmp_path / "ckpt")) == 2
    assert os.path.exists(tmp_path / "ckpt" / "step_4" / "meta.json")


# ---------------------------------------------------------------------------
# the configuration chip_smoke.py runs
# ---------------------------------------------------------------------------
def test_chip_smoke_mamba_config_is_the_class_defaults_at_full_width():
    import dataclasses

    import chip_smoke
    from lcasr_tpu.models.mamba import Mamba as JModel

    cfg = chip_smoke.MAMBA_CONFIG
    assert cfg["model_class"] == "Mamba"
    defaults = {f.name: f.default for f in dataclasses.fields(JModel) if f.init}
    for key in ("n_layers", "d_model", "subsampling", "subsampling_factor",
                "subsampling_conv_channels", "self_conditioning"):
        assert cfg["model"][key] == defaults[key], key
    assert (cfg["model"]["d_model"], cfg["model"]["n_layers"]) == (768, 6)
    # everything but the model is the ladder configuration's, unchanged
    for section in chip_smoke.LADDER_CONFIG:
        if section not in ("model_class", "model"):
            assert cfg[section] == chip_smoke.LADDER_CONFIG[section], section
    assert chip_smoke.MAMBA_EXPECTED_DECODE_LAUNCHES == 6 * 4


def test_chip_smoke_plain_scan_patches_only_inside_its_with_block():
    """The kernel-against-plain comparisons run the wrappers on one side and
    the plain versions on the other: building the context changes nothing,
    entering it swaps both wrappers, leaving it restores them."""
    import chip_smoke
    from lcasr_torch import kernels
    from lcasr_torch.ops import ssm

    fwd, bwd = ssm.selective_scan_fwd, ssm.selective_scan_bwd
    ref_ctx, yard_ctx = chip_smoke.plain_scan(torch.float64), chip_smoke.plain_scan(torch.float32)
    assert ssm.selective_scan_fwd is fwd and ssm.selective_scan_bwd is bwd
    rng = np.random.default_rng(19)
    x, delta = t(rng.normal(size=(1, 5, 3)).astype(np.float32)), torch.full((1, 5, 3), 0.1)
    A = -torch.ones(3, 16)
    Bm, Cm = (t(rng.normal(size=(1, 5, 16)).astype(np.float32)) for _ in range(2))
    want = ssm.selective_scan_ref(x, delta, A, Bm, Cm, dtype=torch.float64)
    for ctx in (yard_ctx, ref_ctx):
        with ctx:
            assert ssm.selective_scan_fwd is not fwd and ssm.selective_scan_bwd is not bwd
            y = ssm.selective_scan(x, delta, A, Bm, Cm)
            assert y.dtype == torch.float32
        assert ssm.selective_scan_fwd is fwd and ssm.selective_scan_bwd is bwd
    torch.testing.assert_close(y, want.float(), rtol=0, atol=1e-7)  # the fp64 scan, rounded once
    kernels.reset_launch_counts()
    chip_smoke.require_launches(False, "nothing ran")
    with pytest.raises(AssertionError, match="expected some"):
        chip_smoke.require_launches(True, "nothing ran")
    kernels.launch_counts["selective_scan_fwd"] += 1
    try:
        chip_smoke.require_launches(True, "one launch")
        with pytest.raises(AssertionError, match="expected none"):
            chip_smoke.require_launches(False, "one launch")
    finally:
        kernels.reset_launch_counts()


def test_d_state_32_forward_and_whole_gradient_match_jax(monkeypatch):
    """A Mamba whose mixers have d_state 32 (the mixer's option in both
    packages; each model builds its mixers at the default, so both mixer
    classes are given a default of 32 here; on the card the scan kernels'
    N = 32 instantiation): the forward's log-probs and one training step's
    loss and every parameter's gradient against JAX, at the tolerances of
    the d_state 16 tests above."""
    from lcasr_tpu.models import mamba as jmamba
    from lcasr_tpu.ops.ctc import ctc_loss as jax_ctc
    from lcasr_torch.models import mamba as pmamba

    class BiMambaMixer(jmamba.BiMambaMixer):
        d_state: int = 32

    class PortMixer(pmamba.BiMambaMixer):
        def __init__(self, d_model, d_state=32, **kw):
            super().__init__(d_model, d_state=d_state, **kw)

    monkeypatch.setattr(jmamba, "BiMambaMixer", BiMambaMixer)
    monkeypatch.setattr(pmamba, "BiMambaMixer", PortMixer)
    jm = jmamba.Mamba(**TINY)
    v = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 80, 320))), seed=14)
    port = pmamba.Mamba(**TINY, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert port.layers[0].mixer.A_log.shape[-1] == 32
    audio, lens, labels, label_lens, weight = _batch(seed=15)
    want = jax.jit(jm.apply)(v, audio, length=jnp.asarray(lens))["final_posteriors"]
    with torch.no_grad():
        got = port(t(audio), length=t(lens))["final_posteriors"]
    assert_close(got, want, atol=ATOL)

    def f(params):
        out = jm.apply({"params": params}, audio, length=jnp.asarray(lens), train=True)
        nll = jax_ctc(out["final_posteriors"].astype(jnp.float32), labels, out["length"],
                      label_lens, blank_id=VOCAB, reduction="none")
        return (jnp.where(nll < 1e29, nll, 0.0) * weight).sum()

    loss_j, g_j = jax.jit(jax.value_and_grad(f))(v["params"])
    loss = _port_loss(port.train(), audio, lens, labels, label_lens, weight)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, g_j)})
    params = dict(port.named_parameters())
    gmax = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        tol = 1e-4 * max(w.abs().max().item(), 1e-2 * gmax)
        np.testing.assert_allclose(params[name].grad.numpy(), w.numpy(), atol=tol, rtol=0,
                                   err_msg=name)
