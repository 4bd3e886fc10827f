"""lcasr_torch's SCConformerMeta, refine_at_inference, MetaTrainer and
cli.train_meta against lcasr_tpu's, on the CPU in fp32.

Log-probs, representations and predicted gradients agree to 1e-4 of the
largest value (the model tests' tolerance); the trainer's losses to 1e-4
relative (the CTC gradient and the meta branch are fp32 sums in another
order) and the updated meta parameters to 1e-5 of each tensor's largest
entry (MADGRAD's first step moves them by lr-sized amounts); every other
parameter is bit-equal after a step.  The control loss's row permutation
is the JAX step's own, handed to the port's step.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import state_dict_from_flax
from tests.test_torch_port_ops import randomize

VOCAB = 16
ATOL = 1e-4
TINY = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, head_dim=16,
            subsampling_conv_channels=32, n_meta_layers=1, use_rotary=True)


def _pair(seed=0, **over):
    from lcasr_tpu.models.sconformer_meta import SCConformerMeta as JMeta
    from lcasr_torch.models.sconformer_meta import SCConformerMeta

    cfg = dict(TINY, **over)
    jm = JMeta(**cfg)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256)),
                                  jnp.array([256])), seed=seed)
    port = SCConformerMeta(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, port


def _close(got, want, atol=ATOL, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol * max(1.0, float(np.abs(want).max())),
                               rtol=0, err_msg=what)


def _audio(seed, B=2, T=512):
    return np.random.default_rng(seed).normal(size=(B, 80, T)).astype(np.float32)


@pytest.mark.parametrize("fourier", [False, True])
def test_forward_and_split_methods_match_jax(fourier):
    from lcasr_tpu.models.sconformer_meta import SCConformerMeta as JMeta

    jm, variables, port = _pair(seed=1, fourier_pos_enc=fourier)
    audio, lengths = _audio(2), np.array([512, 400], np.int32)
    want = jm.apply(variables, jnp.asarray(audio), jnp.asarray(lengths))
    with torch.no_grad():
        got = port(torch.from_numpy(audio), torch.from_numpy(lengths))
        enc = port.encode(torch.from_numpy(audio), torch.from_numpy(lengths))
        logits = port.decode_reprs(enc["reprs"], return_logits=True)
        gp = port.meta_predict(logits, enc["initial_signal"], enc["lengths_arg"])
    for key in ("final_posteriors", "reprs", "initial_signal", "grad_pred"):
        _close(got[key], want[key], what=key)
    np.testing.assert_array_equal(got["length"].numpy(), np.asarray(want["length"]))
    jenc = jm.apply(variables, jnp.asarray(audio), jnp.asarray(lengths), method=JMeta.encode)
    _close(enc["reprs"], jenc["reprs"], what="encode")
    jlogits = jm.apply(variables, jenc["reprs"], True, method=JMeta.decode_reprs)
    _close(logits, jlogits, what="decode_reprs")
    jgp = jm.apply(variables, jlogits, jenc["initial_signal"], jenc["lengths_arg"],
                   method=JMeta.meta_predict)
    _close(gp, jgp, what="meta_predict")
    assert got["grad_pred"].shape == got["reprs"].shape  # codebook_classes -1: d_model


def test_refine_at_inference_matches_jax():
    from lcasr_tpu.models.sconformer_meta import refine_at_inference as jrefine
    from lcasr_torch.models.sconformer_meta import refine_at_inference

    jm, variables, port = _pair(seed=3)
    audio, lengths = _audio(4), np.array([512, 300], np.int32)
    want = jrefine(jm, variables, jnp.asarray(audio), jnp.asarray(lengths), iterations=4,
                   lr=0.5)
    got = refine_at_inference(port, torch.from_numpy(audio), torch.from_numpy(lengths),
                              iterations=4, lr=0.5)
    _close(got["final_posteriors"], want["final_posteriors"], what="refined log-probs")
    with torch.no_grad():
        plain = port(torch.from_numpy(audio), torch.from_numpy(lengths))["final_posteriors"]
    assert (got["final_posteriors"] - plain).abs().max() > 10 * ATOL  # it moved


class _Tok:
    def vocab_size(self):
        return VOCAB


def _trainer_config(module, lr=3e-3, loss="l2"):
    return module.Config({
        "training": {"loss": loss, "batch_size": 2, "max_epochs": 1, "clip_value": 0.8},
        "audio_chunking": {"size": 512},
        "optimizer": {"name": "madgrad", "args": {"lr": lr, "weight_decay": 1e-2}},
        "scheduler": {"warmup_steps": 0},
    })


@pytest.mark.parametrize("loss", ["l2", "cosine"])
def test_meta_trainer_step_matches_jax(loss, tmp_path):
    import lcasr_tpu.config as jconfig
    import lcasr_torch.config as tconfig
    from lcasr_tpu.optim.factory import set_learning_rate as jset_lr
    from lcasr_tpu.training.meta import MetaTrainer as JTrainer
    from lcasr_torch.training.meta import MetaTrainer

    jm, variables, port = _pair(seed=5)
    lr = 3e-3
    jt = JTrainer(_trainer_config(jconfig, lr, loss), jm, _Tok(),
                  checkpoint_dir=str(tmp_path / "j"))
    state = jt.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    opt_state = jset_lr(jt.optimizer.init(params), lr)
    rng = np.random.default_rng(6)
    audio, lens = _audio(7), np.array([512, 412], np.int32)
    labels = rng.integers(0, VOCAB, size=(2, 16)).astype(np.int64)
    label_lens = np.array([6, 4], np.int32)
    key = jax.random.PRNGKey(11)
    (new_params, _, _, ml1, ml2, cosim, orig, blank_p) = jt._step_fn()(
        params, stats, opt_state, jnp.asarray(audio), jnp.asarray(lens), jnp.asarray(labels),
        jnp.asarray(label_lens), key)
    perm = np.array(jax.random.permutation(key, 2 * 64))  # a writable copy

    trainer = MetaTrainer(_trainer_config(tconfig, lr, loss), port, _Tok(), device="cpu",
                          checkpoint_dir=str(tmp_path / "t")).init_state()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    out = trainer.step(torch.from_numpy(audio), torch.from_numpy(lens),
                       torch.from_numpy(labels), torch.from_numpy(label_lens),
                       perm=torch.from_numpy(perm))
    for name, want in (("meta_loss_1", ml1), ("meta_loss_2", ml2), ("cosim", cosim),
                       ("original_loss", orig), ("blank_p", blank_p)):
        np.testing.assert_allclose(float(out[name]), float(want), rtol=1e-4, err_msg=name)
    want_sd = state_dict_from_flax({"params": jax.tree.map(np.asarray, new_params)})
    moved = 0
    for name, p in port.named_parameters():
        if name.startswith(("meta_layers.", "meta_decoder.", "combiner.")):
            _close(p, want_sd[name], 1e-5, name)
            moved += int(not torch.equal(p, before[name]))
        else:  # frozen: the same bits
            assert torch.equal(p, before[name]), name
    assert moved > 0


def test_meta_mask_and_loss_functions_match_jax():
    from lcasr_tpu.models.sconformer_meta import meta_param_mask as jmask
    from lcasr_tpu.training.meta import make_meta_loss_fn as jloss
    from lcasr_torch.models.sconformer_meta import meta_param_mask
    from lcasr_torch.training.meta import make_meta_loss_fn

    _, variables, port = _pair()
    params = variables["params"]
    # the JAX mask as arrays of each parameter's shape, carried to port names
    want = state_dict_from_flax({"params": jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), jmask(params), params)})
    got = meta_param_mask(port)
    assert set(got) == set(want) and any(got.values()) and not all(got.values())
    for name, m in got.items():
        assert bool(want[name].flatten()[0]) == m, name
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 8, 4)).astype(np.float32)
    for kind in ("l2", "mse", "cosine"):
        np.testing.assert_allclose(
            float(make_meta_loss_fn(kind)(torch.from_numpy(a), torch.from_numpy(b), 32.0)),
            float(jloss(kind)(jnp.asarray(a), jnp.asarray(b), 32.0)), rtol=1e-6)
    with pytest.raises(ValueError):
        make_meta_loss_fn("l1")


def test_cli_train_meta_on_a_tiny_npz_folder(tmp_path):
    """`python -m lcasr_torch.cli.train_meta` end to end: a yaml config, a
    folder of saved utterances, an SCConformerXL checkpoint of the port
    starting the encoder; the metrics are finite."""
    import yaml

    from lcasr_torch.cli.train_meta import main
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.data.utterances import save_utterances
    from lcasr_torch.models.sconformer_xl import SCConformerXL, init_weights_
    from lcasr_torch.config import Config
    from lcasr_torch.training.checkpointing import save_checkpoint

    tok = load_tokenizer()
    rng = np.random.default_rng(0)
    spec = rng.normal(size=(1, 80, 2000)).astype(np.float32)
    np.save(tmp_path / "rec.spec.npy", spec)
    words = [{"word": f"word{j}", "startTime": f"{0.5 + 0.4 * j:.2f}s",
              "endTime": f"{0.8 + 0.4 * j:.2f}s"} for j in range(20)]
    (tmp_path / "rec.json").write_text(json.dumps(
        {"results": [{"alternatives": [{"words": words}]}]}))
    pairs = {"rec": {"audio": str(tmp_path / "rec.spec.npy"),
                     "txt": str(tmp_path / "rec.json"), "duration": 20.0}}
    save_utterances(pairs, str(tmp_path / "utts"), tok, chunk_size=512)

    model_cfg = {"d_model": 32, "n_layers": 1, "n_heads": 2, "head_dim": 16,
                 "subsampling_conv_channels": 16}
    enc = init_weights_(SCConformerXL(vocab_size=tok.vocab_size(), **model_cfg,
                                      device="cpu"), seed=4)
    pre = save_checkpoint(str(tmp_path / "pre"), 0, enc.state_dict(),
                          config=Config({"model": model_cfg}))
    cfg = {"model_class": "SCConformerMeta",
           "model": dict(model_cfg, load_pretrained_from=pre),
           "data": {"utterance_folder": str(tmp_path / "utts")},
           "training": {"batch_size": 2, "max_epochs": 1, "random_seed": 0},
           "optimizer": {"name": "madgrad", "args": {"lr": 1e-4}},
           "checkpointing": {"dir": str(tmp_path / "ckpt")}}
    (tmp_path / "meta.yaml").write_text(yaml.safe_dump(cfg))
    main(["-config", str(tmp_path / "meta.yaml"), "--device", "cpu"])
    rows = [json.loads(line) for line in open(tmp_path / "ckpt" / "metrics.jsonl")]
    assert rows and all(np.isfinite(r["meta_loss_1"]) and np.isfinite(r["original_loss"])
                        for r in rows)
