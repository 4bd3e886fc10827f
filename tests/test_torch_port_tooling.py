"""The port's host tooling against the JAX package's on the CPU: the
launcher, preprocessing, tokenizer training, the pretrained manifest and its
download, the speaker-aware text chunkers, checkpoint averaging and the
profiling helpers.  No test touches the network: the download runs against a
stand-in `huggingface_hub` that hands out a local file.

Tolerances: the launcher's YAMLs, the tokenizer's pieces and `.model` bytes,
the chunkers' outputs, the manifest's messages and the averaged parameters
are held equal (the averages bit for bit: both sum in float64 in the same
order and cast once).  `preprocess_file`'s fp16 spectrogram is held to
JAX's within the tolerance of tests/test_torch_port_audio.py (1e-4 of the
largest value: fp32 FFTs and sums in another order) plus one fp16 step of
each value (the cast may round the two fp32 values to neighbours)."""
import json
import os
import random
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_port_ops import randomize

# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
TEMPLATE = {
    "template_info": {"template_keys": ["sequence_scheduler.max_sequence_length",
                                        "training.random_seed"]},
    "model": {"d_model": 768},
    "training": {"random_seed": [1, 2, 3, 4]},
    "sequence_scheduler": {"max_sequence_length": [512, 2048, 16384, 360000]},
}


def _read_all(paths):
    return [open(p).read() for p in paths]


def test_launcher_expands_the_template_as_jax(tmp_path):
    from lcasr_torch.cli import launcher
    from lcasr_tpu.cli import launcher as jl

    tpath = tmp_path / "template.yaml"
    tpath.write_text(yaml.safe_dump(TEMPLATE))
    ours = launcher.expand_template(str(tpath), str(tmp_path / "port"))
    theirs = jl.expand_template(str(tpath), str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    assert _read_all(ours) == _read_all(theirs) and len(ours) == 4


def test_launcher_zoo_overlays_equal_jax_for_every_entry(tmp_path):
    from lcasr_torch.cli import launcher
    from lcasr_tpu.cli import launcher as jl

    assert launcher.DEFAULT_ZOO == jl.DEFAULT_ZOO
    with open(launcher.DEFAULT_ZOO) as f:
        zoo = yaml.safe_load(f)["zoo"]
    template = os.path.join(os.path.dirname(launcher.DEFAULT_ZOO), "paper_template_seq_rotary.yaml")
    for name in zoo:
        ours = launcher.expand_template(template, str(tmp_path / "p" / name), zoo_model=name)
        theirs = jl.expand_template(template, str(tmp_path / "j" / name), zoo_model=name)
        assert _read_all(ours) == _read_all(theirs), name
    empty = "model:\n  d_model: 768\nscheduler:\n"
    assert (launcher.apply_zoo_model(yaml.safe_load(empty), "lcasr_6l_256d_8h_5k_warmup")
            == jl.apply_zoo_model(yaml.safe_load(empty), "lcasr_6l_256d_8h_5k_warmup"))
    for mod in (launcher, jl):
        with pytest.raises(ValueError, match="unknown zoo model"):
            mod.apply_zoo_model({}, "lcasr_999l")


def test_launcher_restart_reseeds_as_jax(tmp_path):
    from lcasr_torch.cli import launcher
    from lcasr_tpu.cli import launcher as jl

    seeds = {}
    for tag, mod in (("port", launcher), ("jax", jl)):
        path = tmp_path / f"{tag}.yaml"
        path.write_text(yaml.safe_dump({"training": {"random_seed": 1234}}))
        mod.restart(str(path), dry_run=True, keep_seed=True)
        kept = yaml.safe_load(path.read_text())["training"]["random_seed"]
        mod.restart(str(path), dry_run=True, seed="777")
        pinned = yaml.safe_load(path.read_text())["training"]["random_seed"]
        random.seed(5)
        mod.restart(str(path), dry_run=True)
        drawn = yaml.safe_load(path.read_text())["training"]["random_seed"]
        seeds[tag] = (kept, pinned, drawn)
    assert seeds["port"] == seeds["jax"]
    assert seeds["port"][:2] == (1234, 777)


def test_launcher_job_script_runs_the_port_on_one_gpu(tmp_path):
    from lcasr_torch.cli import launcher
    from lcasr_tpu.cli import launcher as jl

    cfg = tmp_path / "run.yaml"
    cfg.write_text(yaml.safe_dump({"model": {}}))
    body = open(launcher.submit([str(cfg)], dry_run=True)[0]).read()
    assert f"python -m lcasr_torch.cli.train -config {cfg}" in body
    assert "#SBATCH --gres=gpu:1" in body
    jax_body = jl.DEFAULT_JOB_TEMPLATE.format(config_path=str(cfg),
                                              log_path=str(cfg).replace(".yaml", ".log"))
    ours = [l for l in body.splitlines() if "gres" not in l and "cli.train" not in l]
    theirs = [l for l in jax_body.splitlines() if "cli.train" not in l]
    assert ours == theirs


def test_launcher_cli_expands_and_writes_dry_run_scripts(tmp_path, capsys):
    from lcasr_torch.cli import launcher

    tpath = tmp_path / "template.yaml"
    tpath.write_text(yaml.safe_dump(TEMPLATE))
    launcher.main(["expand", "-template", str(tpath), "-out", str(tmp_path / "o"),
                   "--submit", "--dry_run"])
    printed = capsys.readouterr().out.split()
    assert len(printed) == 4 and all(os.path.exists(p.replace(".yaml", ".sh")) for p in printed)


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------
def _write_wav(path, seconds, rate, seed):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    sig = 0.3 * np.sin(2 * np.pi * (200 + 50 * seed) * t) + 0.05 * rng.normal(size=t.shape)
    stereo = np.stack([sig, 0.5 * sig], axis=1)
    wavfile.write(path, rate, (stereo * 32767).astype(np.int16))


def test_preprocess_file_matches_jax_within_one_fp16_step(tmp_path):
    from lcasr_torch.data import preprocess
    from lcasr_tpu.data import preprocess as jp

    wav = str(tmp_path / "a.wav")
    _write_wav(wav, 3.0, 44_100, seed=1)
    ours = np.load(preprocess.preprocess_file(wav, str(tmp_path / "port.spec.npy"), device="cpu"))
    theirs = np.load(jp.preprocess_file(wav, str(tmp_path / "jax.spec.npy")))
    assert ours.dtype == theirs.dtype == np.float16 and ours.shape == theirs.shape
    assert ours.flags["C_CONTIGUOUS"]  # the native .npy reader refuses Fortran order
    step = np.spacing(np.maximum(np.abs(ours), np.abs(theirs))).astype(np.float32)
    diff = np.abs(ours.astype(np.float32) - theirs.astype(np.float32))
    assert (diff <= 1e-4 * np.abs(theirs.astype(np.float32)).max() + step).all(), diff.max()


def test_preprocess_main_takes_its_shard(tmp_path, capsys):
    from lcasr_torch.data import preprocess

    for i in range(3):
        _write_wav(str(tmp_path / f"r{i}.wav"), 0.5, 16_000, seed=i)
    preprocess.main(["-audio", str(tmp_path), "--shard_index", "1", "--num_shards", "2",
                     "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["r0.wav", "r1.spec.npy", "r1.wav", "r2.wav"]
    assert "[1/1]" in capsys.readouterr().out


def test_pair_audio_txt_and_add_durations_equal_jax(tmp_path):
    from lcasr_torch.data import preprocess
    from lcasr_tpu.data import preprocess as jp

    rng = np.random.default_rng(3)
    # an audio folder's name keeps its first word only in the key
    for show, audio_show in (("show_a", "show_a (audio)"), ("show_b", "show_b")):
        for ep in range(3):
            d_audio = tmp_path / "audio" / "corpus" / audio_show / f"ep{ep}"
            d_txt = tmp_path / "txt" / "corpus" / show / f"ep{ep}"
            d_audio.mkdir(parents=True)
            d_txt.mkdir(parents=True)
            np.save(d_audio / "x.spec.npy",
                    rng.normal(size=(1, 80, int(rng.integers(50, 400)))).astype(np.float16))
            if ep != 1 or show == "show_b":  # one recording without a transcript
                (d_txt / "x.json").write_text("{}")
    args = (str(tmp_path / "audio"), str(tmp_path / "txt"))
    ours = preprocess.pair_audio_txt(*args, save_path=str(tmp_path / "p.json"))
    theirs = jp.pair_audio_txt(*args)
    assert ours == theirs and len(ours) == 5
    assert json.load(open(tmp_path / "p.json")) == theirs
    assert preprocess.add_durations(ours) == jp.add_durations(theirs)


# ---------------------------------------------------------------------------
# tokenizer training
# ---------------------------------------------------------------------------
SMALL_CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "cats and dogs sat together",
    "the the the cat cat dog",
] * 20


def _seeded_corpus(seed, n=300):
    rng = np.random.default_rng(seed)
    words = ["podcast", "music", "long", "context", "speech", "recognition", "the", "and",
             "Hello,", "WORLD!", "café", "naïve", "it's", "twenty-five", "42"]
    return [" ".join(rng.choice(words, size=int(rng.integers(3, 12)))) for _ in range(n)]


@pytest.mark.parametrize("corpus,vocab", [(SMALL_CORPUS, 80), (_seeded_corpus(7), 150)],
                         ids=["small", "seeded"])
def test_train_tokenizer_writes_jax_bytes_and_loads(tmp_path, corpus, vocab):
    from lcasr_torch.data import train_tokenizer as tt
    from lcasr_torch.data.tokenizer import SentencePieceBPE
    from lcasr_tpu.data import train_tokenizer as jt

    assert tt.learn_bpe(corpus, vocab_size=vocab) == jt.learn_bpe(corpus, vocab_size=vocab)
    ours = tt.train_tokenizer(corpus, str(tmp_path / "port.model"), vocab_size=vocab)
    theirs = jt.train_tokenizer(corpus, str(tmp_path / "jax.model"), vocab_size=vocab)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    native, plain = SentencePieceBPE(ours), SentencePieceBPE(ours, use_native=False)
    assert plain.pad_id() == 0 and plain.unk_id() == 1 and plain.bos_id() == 2
    for text in corpus[:6] + ["dogs and cats", "unseen words here"]:
        assert native.encode(text) == plain.encode(text)
    assert plain.decode(plain.encode("the cat sat")) == "the cat sat"


def test_retrieve_all_text_equals_jax(tmp_path):
    from lcasr_torch.data.train_tokenizer import retrieve_all_text
    from lcasr_tpu.data.train_tokenizer import retrieve_all_text as jax_retrieve

    pairs = {}
    for i in range(3):
        words = [{"word": w} for w in _seeded_corpus(i, 1)[0].split()]
        path = tmp_path / f"{i}.json"
        path.write_text(json.dumps({"results": [{"alternatives": [{"words": []}]},
                                                {"alternatives": [{"words": words}]}]}))
        pairs[str(i)] = {"txt": str(path)}
    ours = retrieve_all_text(pairs, save_path=str(tmp_path / "port.txt"))
    assert ours == jax_retrieve(pairs, save_path=str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


# ---------------------------------------------------------------------------
# the pretrained manifest and its download
# ---------------------------------------------------------------------------
def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_manifest_and_its_check_give_jax_messages(tmp_path, monkeypatch):
    from lcasr_torch.utils import pretrained as tp
    from lcasr_tpu.utils import pretrained as jp

    assert tp.MANIFEST == jp.MANIFEST and tp.KNOWN_CHECKPOINTS == jp.KNOWN_CHECKPOINTS
    assert tp.CHECKPOINT_PREFIX == jp.CHECKPOINT_PREFIX
    assert tp.expected_filenames() == jp.expected_filenames()
    assert tp.expected_filenames(3) == jp.expected_filenames(3)
    good = tmp_path / f"{tp.CHECKPOINT_PREFIX}.pt"
    good.write_bytes(b"not a real checkpoint")
    cases = [("lcasr-nonexistent", str(good), None),
             ("lcasr-9L-768D-6H", str(tmp_path / "model_final.pt"), None),
             ("lcasr-9L-768D-6H", str(good), 2),
             ("lcasr-9L-768D-6H", str(tmp_path / f"missing/{tp.CHECKPOINT_PREFIX}.pt"), None)]
    for name, path, repeat in cases:
        assert (_error(tp.manifest_check, name, path, repeat)
                == _error(jp.manifest_check, name, path, repeat))
    tp.manifest_check("lcasr-9L-768D-6H", str(good))
    for mod in (tp, jp):  # the dicts are separate copies: set both
        monkeypatch.setitem(mod.MANIFEST["lcasr-9L-768D-6H"], "sha256", "0" * 64)
    assert (_error(tp.manifest_check, "lcasr-9L-768D-6H", str(good))
            == _error(jp.manifest_check, "lcasr-9L-768D-6H", str(good)))


@pytest.fixture(scope="module")
def tiny_flax():
    """A tiny flax SCConformerXL's variables and its config (init once)."""
    from lcasr_tpu.models.sconformer_xl import SCConformerXL

    cfg = dict(d_model=32, n_layers=2, n_heads=2, head_dim=16, subsampling_conv_channels=16,
               use_rotary=True)
    model = SCConformerXL(vocab_size=16, **cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 64)))
    return jax.tree.map(np.asarray, dict(variables)), cfg


def test_download_and_load_pretrained_without_the_network(tmp_path, monkeypatch, tiny_flax):
    from lcasr_torch.evaluation.run import load_any_checkpoint
    from lcasr_torch.utils import pretrained as tp
    from tests.test_torch_port_eval import reference_state_dict

    variables, cfg = tiny_flax
    local = tmp_path / "hub" / f"{tp.CHECKPOINT_PREFIX}_repeat_1.pt"
    local.parent.mkdir()
    torch.save({"config": {"model": cfg},
                "model": reference_state_dict(randomize(variables, seed=1), cfg)}, local)
    asked = []

    def hf_hub_download(repo, fname, cache_dir=None):
        asked.append((repo, fname, cache_dir))
        if fname != local.name:
            raise FileNotFoundError(fname)
        return str(local)

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(hf_hub_download=hf_hub_download))
    path = tp.download_pretrained("lcasr-6L-256D-8H", cache_dir="c")
    assert path == str(local)
    repo = tp.MANIFEST["lcasr-6L-256D-8H"]["repo"]
    assert asked == [(repo, f"{tp.CHECKPOINT_PREFIX}.pt", "c"), (repo, local.name, "c")]
    with pytest.raises(RuntimeError, match="no checkpoint matching"):
        tp.download_pretrained("someone/else", repeat=4)
    got_cfg, got_sd = tp.load_pretrained("lcasr-6L-256D-8H")
    want_cfg, want_sd = load_any_checkpoint(str(local))
    assert got_cfg.to_dict() == want_cfg.to_dict() and got_sd.keys() == want_sd.keys()
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)


# ---------------------------------------------------------------------------
# speaker-aware chunkers
# ---------------------------------------------------------------------------
def _tagged_words(seed, n=120, tags=True):
    rng = np.random.default_rng(seed)
    out, t, speaker = [], 0.0, 1
    for i in range(n):
        t += float(rng.uniform(0.05, 0.6))
        dur = float(rng.uniform(0.1, 0.5))
        if rng.uniform() < 0.1:
            speaker = int(rng.integers(1, 4))
        w = {"word": f"w{i}", "startTime": f"{t:.2f}s", "endTime": f"{t + dur:.2f}s"}
        if tags:
            w["speakerTag"] = speaker
        out.append(w)
        t += dur
    return out, int(t * 100) + 50


@pytest.mark.parametrize("chunk,overlap,seconds", [(1000, 0, False), (1000, 300, True),
                                                   (777, 100, False)])
def test_speaker_chunkers_equal_jax(chunk, overlap, seconds):
    from lcasr_torch.data import dataloading as td
    from lcasr_tpu.data import dataloading as jd

    words, frames = _tagged_words(seed=chunk + overlap)
    for name in ("chunk_text_and_speakers_json", "chunk_text_json_with_speaker_change"):
        ours = getattr(td, name)(words, chunk, overlap, frames, get_seconds=seconds)
        theirs = getattr(jd, name)(words, chunk, overlap, frames, get_seconds=seconds)
        assert ours == theirs, name
    assert "¬" in " ".join(td.chunk_text_json_with_speaker_change(words, chunk, overlap, frames)
                           if not seconds else
                           td.chunk_text_json_with_speaker_change(words, chunk, overlap, frames)[0])


def test_speaker_chunkers_raise_keyerror_on_untagged_words():
    from lcasr_torch.data import dataloading as td
    from lcasr_tpu.data import dataloading as jd

    words, frames = _tagged_words(seed=1, n=10, tags=False)
    for name in ("chunk_text_and_speakers_json", "chunk_text_json_with_speaker_change"):
        for mod in (td, jd):
            with pytest.raises(KeyError, match="speakerTag"):
                getattr(mod, name)(words, 500, 0, frames)


# ---------------------------------------------------------------------------
# checkpoint averaging
# ---------------------------------------------------------------------------
def _save_both(tmp_path, layout_dir, step, variables, cfg):
    """The same variables as an orbax checkpoint of the JAX package (under
    jax/) and a port checkpoint (under port/), at the same relative path."""
    from lcasr_torch.config import Config
    from lcasr_torch.models.import_jax import state_dict_from_flax
    from lcasr_torch.training import checkpointing as tc
    from lcasr_tpu.training import checkpointing as jc

    jc.save_checkpoint(str(tmp_path / "jax" / layout_dir), step, params=variables["params"],
                       batch_stats=variables["batch_stats"])
    tc.save_checkpoint(str(tmp_path / "port" / layout_dir), step, state_dict_from_flax(variables),
                       config=Config({"model": cfg}))


@pytest.mark.parametrize("layout", ["repeats_step_name", "repeats_latest", "single_dir"])
def test_averaging_is_jax_bit_for_bit(tmp_path, tiny_flax, layout):
    """Three seeded trees: JAX's average over orbax checkpoints equals the
    port's over port checkpoints of the same trees (through
    `state_dict_from_flax`) bit for bit, parameters only, in all three of
    `avg_all_models_in_dir`'s layouts; an earlier step of a repeat does not
    enter the average."""
    from lcasr_torch.models.import_jax import state_dict_from_flax
    from lcasr_torch.training import checkpointing as tc
    from lcasr_tpu.training import checkpointing as jc

    variables, cfg = tiny_flax
    trees = [randomize(variables, seed=10 + i) for i in range(3)]
    step_name = None
    for i, tree in enumerate(trees):
        if layout == "single_dir":
            _save_both(tmp_path, "", 100 + i, tree, cfg)
        else:
            _save_both(tmp_path, f"repeat_{i}", 100, tree, cfg)
            _save_both(tmp_path, f"repeat_{i}", 50, randomize(variables, seed=99), cfg)
    if layout == "repeats_step_name":
        step_name = "step_100"
    ours = tc.avg_all_models_in_dir(str(tmp_path / "port"), step_name)
    theirs = state_dict_from_flax(
        {"params": jc.avg_all_models_in_dir(str(tmp_path / "jax"), step_name)})
    assert ours.keys() == theirs.keys()
    assert all(ours[k].dtype == torch.float32 and torch.equal(ours[k], theirs[k]) for k in ours)
    # the buffers (BatchRenorm's statistics) are not parameters: left out
    assert not any("running" in k or "num_batches" in k for k in ours)
    params = state_dict_from_flax({"params": trees[0]["params"]})
    want = {k: ((params[k].double() + state_dict_from_flax({"params": trees[1]["params"]})[k].double()
                 + state_dict_from_flax({"params": trees[2]["params"]})[k].double()) / 3).float()
            for k in params}
    assert all(torch.equal(ours[k], want[k]) for k in want)


def test_averaging_refuses_checkpoints_of_different_models(tmp_path, tiny_flax):
    from lcasr_torch.config import Config
    from lcasr_torch.models.import_jax import state_dict_from_flax
    from lcasr_torch.training import checkpointing as tc

    variables, cfg = tiny_flax
    a = tc.save_checkpoint(str(tmp_path / "a"), 1, state_dict_from_flax(variables),
                           config=Config({"model": cfg}))
    b = tc.save_checkpoint(str(tmp_path / "b"), 1, state_dict_from_flax(variables),
                           config=Config({"model": dict(cfg, n_layers=1)}))
    with pytest.raises(ValueError, match="another model"):
        tc.average_checkpoints([a, b])


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------
def test_time_fn_and_chain_return_jax_keys_on_the_cpu():
    from lcasr_torch.utils import profiling as tp
    from lcasr_tpu.utils import profiling as jp

    x = torch.ones(64, 64)
    ours = tp.time_fn(lambda a: a @ a, x, warmup=1, iters=3)
    theirs = jp.time_fn(lambda a: a @ a, jnp.ones((64, 64)), warmup=1, iters=3)
    assert ours.keys() == theirs.keys() and ours["iters"] == 3 and ours["mean_s"] > 0
    ours = tp.time_fn_chain(lambda a: (a @ a).sum(), x, n=4, warmup=1, iters=2)
    theirs = jp.time_fn_chain(lambda a: (a @ a).sum(), jnp.ones((64, 64)), n=4, warmup=1, iters=2)
    assert ours.keys() == theirs.keys() and (ours["n"], ours["iters"]) == (4, 2)
    assert ours["ms"] > 0


def test_time_fn_synchronises_only_cuda_outputs(monkeypatch):
    from lcasr_torch.utils import profiling as tp

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    tp.time_fn(lambda: {"a": [torch.ones(2)], "b": (torch.zeros(1), 3)}, warmup=0, iters=2)
    assert synced == []


def test_trace_writes_a_chrome_trace(tmp_path):
    from lcasr_torch.utils import profiling as tp

    with tp.trace(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = os.listdir(tmp_path / "trace")
    assert any(f.endswith(".pt.trace.json") for f in files), files
    assert any("mm" in e.key for e in prof.key_averages())


def test_trace_default_directory_follows_the_temporary_directory(tmp_path, monkeypatch):
    """Without `log_dir` the trace goes to `lcasr_trace` in tempfile's
    directory (TMPDIR), not to a fixed shared path."""
    import tempfile

    from lcasr_torch.utils import profiling as tp

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with tp.trace():
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(tmp_path / "lcasr_trace")
    assert any(f.endswith(".pt.trace.json") for f in files), files
