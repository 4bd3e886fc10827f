"""lcasr_torch's encoder-decoder family (EncDecSconformer, V2) against
lcasr_tpu's, on the CPU in fp32: DynamicPositionBias, the forward (CTC
log-probs and decoder logits), the cached step against the full pass,
calc_loss's value and gradients, the Trainer's enc_dec micro step, greedy
decoding both ways, the frame-synchronous beam search and the internal-LM
`ctc_beam_search`, the flax round trip, the registry and the Trainer's
refusals.

The model is tests/test_enc_dec.py's TINY (d_model 64, one encoder and one
decoder layer, 2 heads x 32) with its flax leaves redrawn from a numpy seed
(`randomize`), carried over with `state_dict_from_flax` and loaded with
strict=True; JAX runs use_pallas=False, its own tests' setting (exact jnp
attention), the port the plain version of K1 on the CPU.

Tolerances: fp32 on both sides, the same arithmetic in another order.
Values of O(1) (the position bias, log-probs, logits): 1e-4 of max(1, the
largest |value|), as tests/test_torch_port_model.py.  The cached step
against the full pass: 2e-4 (tests/test_enc_dec.py's bound); the bf16
model against the fp32 one and its own cached steps: 0.1 absolute.  Gradients:
1e-4 of each tensor's largest entry, never below 1e-6 of the largest
gradient of all (tests/test_torch_port_train.py).  Losses: 1e-5 relative.
Token ids and beam texts: equal.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import flax_from_state_dict, state_dict_from_flax
from tests.test_enc_dec import TINY
from tests.test_torch_port_ops import randomize

PORT_TINY = {k: v for k, v in TINY.items() if k != "use_pallas"}
VOCAB = TINY["vocab_size"]
VARIANTS = ("v1", "v2")
ATOL, STEP_ATOL, GRAD_REL, LOSS_RTOL = 1e-4, 2e-4, 1e-4, 1e-5
BF16_ATOL = 0.1  # bf16 keeps 8 bits: log-probs and logits of a few units move by ~1e-2


def _classes(variant):
    from lcasr_tpu.models import enc_dec_sconformer as jed
    from lcasr_torch.models import enc_dec_sconformer as ted

    name = "EncDecSconformer" if variant == "v1" else "EncDecSconformerV2"
    return getattr(jed, name), getattr(ted, name)


def _pair(variant, seed=0, **over):
    """(JAX model, randomized variables, port model with those weights)."""
    jcls, tcls = _classes(variant)
    jm = jcls(**dict(TINY, **over))
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 128)),
                                  text_sequence=jnp.zeros((1, 8), jnp.int32)), seed=seed)
    port = tcls(**dict(PORT_TINY, **over), device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, port


def _close(got, want, atol=ATOL, what=""):
    want = np.asarray(want)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol * max(1.0, float(np.abs(want).max())),
                               rtol=0, err_msg=what)


def _audio(seed, B=2, T=128):
    return np.random.default_rng(seed).normal(size=(B, 80, T)).astype(np.float32)


# ---------------------------------------------------------------------------
# modules and the forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("log_distance", [False, True])
def test_dynamic_position_bias_matches_jax(log_distance):
    from lcasr_tpu.models.positional import DynamicPositionBias as JBias
    from lcasr_torch.models.positional import DynamicPositionBias

    jb = JBias(dim=64, heads=3, log_distance=log_distance)
    variables = randomize(jb.init(jax.random.PRNGKey(0), 5, 7), seed=1)
    port = DynamicPositionBias(64, 3, log_distance=log_distance)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    for tq, tk in ((5, 7), (9, 9), (1, 4)):
        want = jb.apply(variables, tq, tk)
        with torch.no_grad():
            got = port(tq, tk)
        assert got.dtype == torch.float32
        _close(got, want, what=f"({tq}, {tk})")


@pytest.mark.parametrize("case", ["v1", "v2", "v1_two_layers_no_lengths",
                                  "v2_two_layers_no_ctc"])
def test_forward_matches_jax(case):
    """CTC log-probs, decoder logits, acoustic states and lengths; two
    encoder layers take the self-conditioning and the coupled decoder depth;
    ctc_loss_weight 0 drops the CTC head."""
    variant = case[:2]
    over = {}
    if "two_layers" in case:
        over = dict(n_layers=2, decoder_layers=None)
    if "no_ctc" in case:
        over["ctc_loss_weight"] = 0.0
    jm, variables, port = _pair(variant, seed=2, **over)
    audio = _audio(3, T=200)
    lens = None if "no_lengths" in case else np.array([200, 131], np.int32)
    text = np.random.default_rng(4).integers(1, VOCAB, size=(2, 11)).astype(np.int32)
    want = jm.apply(variables, jnp.asarray(audio), text_sequence=jnp.asarray(text),
                    length=None if lens is None else jnp.asarray(lens))
    with torch.no_grad():
        got = port(torch.from_numpy(audio), torch.from_numpy(text),
                   length=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_array_equal(got["length"].numpy(), np.asarray(want["length"]))
    _close(got["final_posteriors_lm"], want["final_posteriors_lm"], what="lm logits")
    _close(got["a_hidden"], want["a_hidden"], what="a_hidden")
    if "no_ctc" in case:
        assert got["final_posteriors_ctc"] is None and want["final_posteriors_ctc"] is None
        assert not any(k.startswith("decoder.") for k in port.state_dict())
    else:
        _close(got["final_posteriors_ctc"], want["final_posteriors_ctc"], what="ctc")
    with pytest.raises(ValueError, match="length="):
        port(torch.from_numpy(audio), torch.from_numpy(lens if lens is not None else text[0]))


@pytest.mark.parametrize("variant", VARIANTS + ("v1_pos_bias",))
def test_cached_step_matches_full_pass_and_jax(variant):
    """At every position of a 24-token prefix, the KV-cached step's logits
    equal the full teacher-forced pass's (the port's and JAX's); with the
    position bias on rotary attention, both passes add it."""
    from lcasr_torch.models.enc_dec_sconformer import init_decoder_cache

    over = dict(use_dynamic_pos_bias=True) if variant == "v1_pos_bias" else {}
    jm, variables, port = _pair(variant[:2], seed=5, **over)
    U = 24
    audio = _audio(6, B=1)
    tokens = np.random.default_rng(7).integers(1, VOCAB, size=(1, U)).astype(np.int32)
    a_hidden, _, length = jm.apply(variables, jnp.asarray(audio), method=jm.encode)
    want = jm.apply(variables, jnp.asarray(tokens), a_hidden, length, method=jm.generate_step)
    with torch.no_grad():
        a_t, _, len_t = port.encode(torch.from_numpy(audio))
        tok_t = torch.from_numpy(tokens).long()
        full = port.generate_step(tok_t, a_t, len_t)
        pre = port.decoder_precompute(a_t, len_t, U)
        caches = init_decoder_cache(port.decoder_layers, port.n_heads, port.head_dim, 1, U)
        steps = []
        for t in range(U):
            logits, caches = port.decoder_step(tok_t[:, t], t, caches, pre, len_t)
            steps.append(logits)
    _close(full, want, what="full pass against JAX")
    _close(torch.stack(steps, 1), full.numpy(), atol=STEP_ATOL, what="cached step")


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_model_decodes_and_tracks_fp32(variant):
    """The bf16 model (fp32 parameters, bf16 compute) on the CPU: its decoder
    log-probs within BF16_ATOL of the fp32 model's, its cached steps' logits
    within BF16_ATOL of its own full pass's, and both greedy decodes run."""
    from lcasr_torch.models.enc_dec_sconformer import (
        generate_greedy, generate_greedy_cached, init_decoder_cache)

    _, _, port = _pair(variant, seed=19)
    bf16 = type(port)(**PORT_TINY, dtype=torch.bfloat16, device="cpu")
    bf16.load_state_dict(port.state_dict(), strict=True)
    U = 16
    audio = torch.from_numpy(_audio(20, B=1))
    text = torch.from_numpy(np.random.default_rng(21).integers(1, VOCAB, size=(1, U)))
    with torch.no_grad():
        want = port(audio, text)["final_posteriors_lm"].log_softmax(-1)
        got = bf16(audio, text)
        assert got["final_posteriors_lm"].dtype == torch.bfloat16
        assert got["final_posteriors_ctc"].dtype == torch.float32
        a_hidden, _, length = bf16.encode(audio)
        full = bf16.generate_step(text, a_hidden, length).float()
        pre = bf16.decoder_precompute(a_hidden, length, U)
        caches = init_decoder_cache(bf16.decoder_layers, bf16.n_heads, bf16.head_dim, 1, U,
                                    dtype=torch.bfloat16)
        steps = []
        for t in range(U):
            logits, caches = bf16.decoder_step(text[:, t], t, caches, pre, length)
            steps.append(logits.float())
    np.testing.assert_allclose(got["final_posteriors_lm"].float().log_softmax(-1).numpy(),
                               want.numpy(), atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=BF16_ATOL,
                               rtol=0)
    for fn in (generate_greedy, generate_greedy_cached):
        ids = fn(bf16, audio, max_generate=12)
        assert all(0 < i < VOCAB for i in ids) and len(ids) <= 11


# ---------------------------------------------------------------------------
# losses and training
# ---------------------------------------------------------------------------
def _assert_grads_close(port, grads):
    """The port's .grad against a flax gradient tree, tensor by tensor."""
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)})
    params = dict(port.named_parameters())
    assert set(want) == set(params)
    gmax = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        tol = GRAD_REL * max(w.abs().max().item(), 1e-2 * gmax)
        np.testing.assert_allclose(params[name].grad.numpy(), w.numpy(), atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_calc_loss_value_and_gradients_match_jax(variant):
    from lcasr_tpu.models.enc_dec_sconformer import calc_loss as jax_calc_loss
    from lcasr_torch.models.enc_dec_sconformer import calc_loss

    jm, variables, port = _pair(variant, seed=8)
    rng = np.random.default_rng(9)
    audio = _audio(10)
    text = rng.integers(3, VOCAB - 2, size=(2, 6)).astype(np.int32)
    a_len, t_len = np.array([128, 100], np.int32), np.array([6, 4], np.int32)

    def f(params):
        out = jax_calc_loss(jm, {**variables, "params": params}, jnp.asarray(audio),
                            jnp.asarray(text), jnp.asarray(a_len), jnp.asarray(t_len))
        return out["loss"], out

    (loss_j, out_j), g_j = jax.value_and_grad(f, has_aux=True)(variables["params"])
    out = calc_loss(port, torch.from_numpy(audio), torch.from_numpy(text).long(),
                    torch.from_numpy(a_len), torch.from_numpy(t_len).long())
    out["loss"].backward()
    for key in ("loss", "ctc_loss", "lm_loss"):
        np.testing.assert_allclose(out[key].item(), float(out_j[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    _assert_grads_close(port, g_j)


class _Tok:
    """A tokenizer of VOCAB ids for both Trainers and both beam searches."""

    def vocab_size(self):
        return VOCAB

    def pad_id(self):
        return 0

    def decode(self, ids):
        return " ".join(f"t{i}" for i in ids)


def _enc_dec_config(model, ckpt_dir):
    return {"model_class": "EncDecSconformer", "model": dict(model),
            "training": {"loss_mode": "enc_dec", "batch_size": 3},
            "audio_chunking": {"size": 256},
            "checkpointing": {"dir": str(ckpt_dir)}}


def _chunk():
    """One chunk as make_chunks gives it: a weight-0 row (audio and labels
    of length 0) and labels padded to the 64 bucket."""
    rng = np.random.default_rng(11)
    labels = np.zeros((3, 64), np.int64)
    labels[0, :9] = rng.integers(1, VOCAB, 9)
    labels[1, :5] = rng.integers(1, VOCAB, 5)
    return {"audio": rng.normal(size=(3, 80, 256)).astype(np.float32),
            "audio_lengths": np.array([256, 180, 0], np.int32), "labels": labels,
            "label_lengths": np.array([9, 5, 0], np.int32),
            "weight": np.array([1.0, 1.0, 0.0], np.float32)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_trainer_enc_dec_micro_step_matches_jax(variant, tmp_path):
    """The joint loss and its gradient on a chunk with a dead row and
    bucketed labels: the divisors count the live rows and the true longest
    label + 1, not the padded shapes."""
    from lcasr_tpu.config import Config as JConfig
    from lcasr_tpu.training.trainer import Trainer as JTrainer
    from lcasr_torch.config import Config
    from lcasr_torch.training.trainer import Trainer

    jm, variables, port = _pair(variant, seed=12, ctc_loss_weight=0.3)
    model_cfg = dict(TINY, ctc_loss_weight=0.3)
    jtr = JTrainer(JConfig(_enc_dec_config(model_cfg, tmp_path / "jax")), jm, _Tok())
    jtr.init_state(jax.random.PRNGKey(0))
    chunk = _chunk()
    zeros = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), variables["params"])
    loss_j, grads_j, _, _ = jtr._micro_step_fn()(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in chunk.items()}, jax.random.PRNGKey(1), zeros)

    port_cfg = dict(PORT_TINY, ctc_loss_weight=0.3)
    tr = Trainer(Config(_enc_dec_config(port_cfg, tmp_path / "port")), port, _Tok(),
                 device="cpu")
    tr.init_state()
    loss, blank_p = tr.micro_step(chunk)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    assert blank_p.item() == 0.0
    _assert_grads_close(port, grads_j)


def test_enc_dec_decays_every_parameter_as_jax_does():
    """The family defines no weight-decay groups: both packages warn and
    decay every parameter, biases included."""
    from lcasr_tpu.models.base import decay_mask as jax_decay_mask
    from lcasr_torch.models.base import decay_mask

    jm, variables, port = _pair("v2")
    with pytest.warns(UserWarning, match="ALL parameters"):
        want = jax_decay_mask(variables["params"], model=jm)
    with pytest.warns(UserWarning, match="ALL parameters"):
        got = decay_mask(port)
    assert all(jax.tree.leaves(want)) and all(got.values())
    assert set(got) == set(dict(port.named_parameters()))


def test_cli_trains_an_enc_dec_config_on_the_cpu(tmp_path):
    """`python -m lcasr_torch.cli.train` with model_class EncDecSconformerV2
    and loss_mode enc_dec: a finite loss per optimizer step and a
    checkpoint."""
    import json
    import os

    import yaml

    from lcasr_torch.cli.train import main
    from tests.test_train_trajectory_parity import _make_corpus

    corpus = _make_corpus(tmp_path, [256, 256], seed=3)
    pairs = tmp_path / "pairs.json"
    pairs.write_text(json.dumps(corpus))
    cfg = _enc_dec_config(PORT_TINY, tmp_path / "ckpt")
    cfg.update(model_class="EncDecSconformerV2", data={"path": str(pairs)},
               optimizer={"name": "madgrad", "args": {"lr": 1e-3}})
    cfg["training"].update(batch_size=2, max_epochs=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    main(["-config", str(path), "--device", "cpu"])

    def losses():
        rows = [json.loads(line) for line in open(tmp_path / "ckpt" / "metrics.jsonl")]
        return [r["loss"] for r in rows if "loss" in r]

    assert len(losses()) == 1 and np.isfinite(losses()[0]) and losses()[0] > 0
    assert os.path.exists(tmp_path / "ckpt" / "step_2" / "meta.json")
    main(["-config", str(path), "--device", "cpu"])  # resumes past the finished epoch
    assert len(losses()) == 1


def test_trainer_refuses_a_mesh_it_could_run(tmp_path, capsys):
    """A parallel.mesh is sized against the process world, not the host's
    cards: without a world of 4 ranks a {data: 4} mesh runs on one device,
    however many cards there are, whatever the loss mode (the world's
    meshes are held against JAX in test_torch_port_parallel.py)."""
    from lcasr_torch.config import Config
    from lcasr_torch.training.trainer import Trainer

    class OnTheCard(torch.nn.Module):
        def parameters(self, recurse=True):
            yield types.SimpleNamespace(device=torch.device("cuda"))

    cfg = dict(_enc_dec_config(PORT_TINY, tmp_path), parallel={"mesh": {"data": 4}})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device_count", lambda: 8)
        # the trainer's augmentation generator would live on the card
        mp.setattr(torch, "Generator", lambda device=None: types.SimpleNamespace(
            manual_seed=lambda seed: None))
        trainer = Trainer(Config(cfg), OnTheCard(), _Tok(), device="cuda")
    assert trainer.mesh is None
    assert "needs 4 devices, have 1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant,bos", [("v1", 0), ("v2", 0), ("v2", 2)])
def test_greedy_ids_match_jax_both_ways(variant, bos):
    """These weights run v1 and v2 at bos 2 to max_generate and stop v2 at
    bos 0 on an eos after two ids: both ends of the loop."""
    from lcasr_tpu.models import enc_dec_sconformer as jed
    from lcasr_torch.models import enc_dec_sconformer as ted

    jm, variables, port = _pair(variant, seed=23)
    audio = _audio(14, B=1)
    for jfn, tfn in ((jed.generate_greedy, ted.generate_greedy),
                     (jed.generate_greedy_cached, ted.generate_greedy_cached)):
        want = jfn(jm, variables, jnp.asarray(audio), max_generate=20, bos_id=bos)
        got = tfn(port, torch.from_numpy(audio), max_generate=20, bos_id=bos)
        assert got == want, tfn.__name__
        assert 1 <= len(got) <= 19


def _numpy_lm(V, seed=0):
    """A deterministic history scorer: log-softmax of a random table row of
    the last token, shifted by the history's length."""
    table = np.random.default_rng(seed).normal(size=(V + 3, V)).astype(np.float32)

    def fn(histories):
        rows = np.stack([table[h[-1]] + 0.05 * len(h) * table[len(h) % V] for h in histories])
        rows = rows - rows.max(-1, keepdims=True)
        return rows - np.log(np.exp(rows).sum(-1, keepdims=True))

    return fn


@pytest.mark.parametrize("kw", [
    dict(beam_width=4, alpha=0.45, beta=1.53, prune_less_than_val=8.0),
    dict(beam_width=6, alpha=0.8, beta=0.2, blank_penalty=-0.3, repetition_penalty=-0.2),
    dict(beam_width=3, alpha=0.3, beta=0.5, max_cache_length=3),
], ids=["ctc_beam_search_defaults", "penalties", "trimmed_history"])
def test_frame_sync_beam_search_matches_jax(kw):
    from lcasr_tpu.decoding import frame_sync as jfs
    from lcasr_torch.decoding import frame_sync as tfs

    rng = np.random.default_rng(15)
    logits = rng.normal(size=(60, VOCAB + 1)).astype(np.float32) * 3
    logits[:, VOCAB] += 2.0  # blank-dominated, as CTC posteriors are
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    kw = dict(kw)
    cache = kw.pop("max_cache_length", -1)
    results = []
    for mod in (jfs, tfs):
        search = mod.FrameSyncBeamSearch(
            lm=mod.HistoryLM(_numpy_lm(VOCAB), bos_id=0, max_cache_length=cache),
            tokenizer=_Tok(), blank_id=VOCAB, bos_id=0, **kw)
        text = search.run_search(lp, decode=True)
        results.append((text, [(b.lm_sequence, b.am_sequence, b.score) for b in search.beams]))
    assert results[1] == results[0]
    assert len(results[0][0].split()) > 3  # the search emitted tokens


@pytest.mark.parametrize("variant", VARIANTS)
def test_ctc_beam_search_text_matches_jax(variant):
    from lcasr_tpu.models.enc_dec_sconformer import ctc_beam_search as jax_search
    from lcasr_torch.models.enc_dec_sconformer import ctc_beam_search

    jm, variables, port = _pair(variant, seed=16)
    audio = _audio(17, B=1)
    want = jax_search(jm, variables, audio, _Tok(), beam_width=4)
    got = ctc_beam_search(port, torch.from_numpy(audio), _Tok(), beam_width=4)
    assert got == want


# ---------------------------------------------------------------------------
# names, the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", VARIANTS)
def test_flax_round_trip_keeps_embedding_and_temperature(variant):
    jm, variables, port = _pair(variant, seed=18)
    sd = port.state_dict()
    table = variables["params"]["language_model_decoder"]["embed"]["embedding"]
    np.testing.assert_array_equal(
        sd["language_model_decoder.embed.embedding"].numpy(), table)  # (V, d), not transposed
    back = flax_from_state_dict(sd)
    flat = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(flat)
    for path, leaf in flat.items():
        assert got[path].shape == np.shape(leaf), jax.tree_util.keystr(path)
        np.testing.assert_array_equal(got[path], np.asarray(leaf))
    temps = [p for p in flat if p[-1].key == "temperature"]
    assert len(temps) == (TINY["decoder_layers"] if variant == "v2" else 0)
    assert all(got[p].shape == () for p in temps)


def test_load_model_builds_both_classes_and_refuses_quant():
    from lcasr_torch.config import Config
    from lcasr_torch.models.enc_dec_sconformer import EncDecSconformer, EncDecSconformerV2
    from lcasr_torch.models.registry import load_model

    for name, cls in (("EncDecSconformer", EncDecSconformer),
                      ("EncDecSconformerV2", EncDecSconformerV2)):
        cfg = {"model_class": name, "training": {"dtype": "bfloat16"},
               # keys of another class are ignored, as the JAX registry ignores them
               "model": dict(PORT_TINY, checkpoint_every_n_layers=1, fourier_pos_enc=True)}
        model = load_model(Config(cfg), VOCAB, device="cpu")
        assert type(model) is cls and model.dtype == torch.bfloat16
        v2 = name.endswith("V2")
        attn = model.language_model_decoder.self_attn_0
        assert attn.cosine == v2 and hasattr(attn, "temperature") == v2
        assert (model.language_model_decoder.dynamic_pos_bias is not None) == v2
        cfg["model"]["quant_w8a8"] = True
        with pytest.raises(NotImplementedError, match="A6"):
            load_model(Config(cfg), VOCAB, device="cpu")
    with pytest.raises(TypeError):
        EncDecSconformer(**PORT_TINY, device="cpu", conv_type="longconv")
