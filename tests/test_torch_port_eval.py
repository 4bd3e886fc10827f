"""lcasr_torch's evaluation path against lcasr_tpu's, on the CPU in fp32.

The port's own Whisper normaliser against the JAX package's (which takes
transformers' class, installed here), the numpy WER DP against rapidfuzz
(totals) and the JAX pure-Python DP (the S/I/D split), `words_from_ids`, the
dataset registry and STM parsing, `import_torch` on a synthetic
reference-layout state dict, and `evaluate` / `evaluate_loss` over the same
`.pt` checkpoint in both packages.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_ops import randomize

MODEL_CFG = dict(d_model=64, n_layers=2, n_heads=2, head_dim=32,
                 subsampling_conv_channels=32, use_rotary=True)
VOCAB = 4095  # the tokenizer's; evaluate builds its model from it

# ---------------------------------------------------------------------------
# text normalisation
# ---------------------------------------------------------------------------
NORMALIZER_STRINGS = [
    "Hello, World!",
    "It's twenty five dollars and fifty cents.",
    "I paid $20 million for it",
    "one oh one",
    "He finished first, she was second and they were twenty third",
    "the 1960s were loud",
    "Two hundred and fifty thousand people",
    "three point one four one five",
    "It costs £5 and 30p",
    "€12.50 per item",
    "ten percent of 90 per cent",
    "minus forty degrees",
    "double seven triple three",
    "I won't go, you can't make me",
    "let's go, y'all",
    "we're gonna wanna gotta",
    "she'd been there and he's gone",
    "Mr. Smith and Dr Jones met St. Mary",
    "The colour of the neighbour's harbour",
    "organise the organisation, realised",
    "the centre of the theatre is 5 metres",
    "travelled, cancelled, labelled",
    "grey programme catalogue",
    "[laughter] okay (inaudible) right <noise>",
    "hmm um uh well mm",
    "café naïve résumé coöperate",
    "œuvre ßtraße Æsir",
    "1,000,000 and 2,500",
    "version 2.0.1 released",
    "it's 3:30 pm",
    "a hundred and one dalmatians",
    "nineteen eighty four",
    "first of July, 4th of July",
    "sixty-five",
    "I'm, you're, they've, we'll",
    "ain't nothing but a hound dog",
    "the 90's and the 80s",
    "one and a half hours",
    "twelfth night",
    "Prof. Capt. Gen. Sen. Rep.",
    "what's up? nothing!",
    "  multiple   spaces\tand\nnewlines ",
    "ninety nine bottles",
    "a million and one",
    "two thousand and twenty",
    "0.5 of 1/2",
    "the ones and the twos",
    "ONE TWO THREE",
    "COVID-19 in 2020",
    "apologise for the behaviour",
    "a 10-minute walk",
    "email me at foo@bar.com",
    "fifty fifty",
    "zero zero seven",
]


@pytest.mark.parametrize("i", range(len(NORMALIZER_STRINGS)))
def test_normalizer_matches_jax(i):
    from lcasr_tpu.evaluation import normalizer as jn
    from lcasr_torch.evaluation import normalizer as tn

    s = NORMALIZER_STRINGS[i]
    assert tn.normalize(s) == jn.normalize(s), s


def test_normalizer_spelling_map_is_the_jax_map():
    from lcasr_tpu.evaluation.normalizer import SPELLING as J
    from lcasr_torch.evaluation.normalizer import SPELLING as T

    assert T == J


# ---------------------------------------------------------------------------
# WER
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_wer_totals_match_rapidfuzz_and_split_matches_jax_dp(seed, monkeypatch):
    from rapidfuzz.distance import Levenshtein

    import lcasr_tpu.evaluation.wer as jw
    from lcasr_torch.evaluation.wer import _edit_ops

    monkeypatch.setattr(jw, "_rf_lev", None)  # the JAX pure-Python DP
    rng = np.random.default_rng(seed)
    words = list("abcdefg")
    for _ in range(400):
        n, m = rng.integers(0, 15, 2)
        r, h = list(rng.choice(words, n)), list(rng.choice(words, m))
        got = _edit_ops(r, h)
        assert got["total"] == Levenshtein.distance(r, h)
        assert got == jw._edit_ops(r, h), (r, h)


def test_word_error_rate_detail_matches_jax():
    import lcasr_tpu.evaluation.wer as jw
    import lcasr_torch.evaluation.wer as tw

    rng = np.random.default_rng(7)
    vocab = "the cat sat on a mat and dog ran far".split()
    hyps = [" ".join(rng.choice(vocab, rng.integers(0, 30))) for _ in range(12)] + ["x y", ""]
    refs = [" ".join(rng.choice(vocab, rng.integers(1, 30))) for _ in range(12)] + ["", ""]
    # rapidfuzz's S/I/D split may differ among co-optimal alignments: the
    # rate tuple's first two entries (wer, words) are the totals
    assert tw.word_error_rate_detail(hyps, refs)[:2] == jw.word_error_rate_detail(hyps, refs)[:2]
    got = tw.word_error_rate_detail(hyps, refs, use_cer=True)
    assert got[:2] == jw.word_error_rate_detail(hyps, refs, use_cer=True)[:2]
    assert tw.word_error_rate([], []) == float("inf")
    with pytest.raises(ValueError):
        tw.word_error_rate_detail(["a"], [])


# ---------------------------------------------------------------------------
# timestamps, datasets
# ---------------------------------------------------------------------------
def test_words_from_ids_matches_jax():
    from lcasr_tpu.data.tokenizer import load_tokenizer as jtok
    from lcasr_tpu.decoding.timestamps import words_from_ids as jwords
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.decoding.timestamps import words_from_ids

    tok = load_tokenizer()
    ids = tok.encode("long context speech recognition with timestamps")
    frames = list(range(3, 3 + 4 * len(ids), 4))
    got = words_from_ids(tok, ids, frames, ds_factor=8)
    assert got == jwords(jtok(), ids, frames, ds_factor=8)
    assert " ".join(w["word"] for w in got) == tok.decode(ids)


def test_registry_lists_all_adapters():
    from lcasr_tpu.evaluation.datasets import available_datasets as javailable
    from lcasr_torch.evaluation.datasets import available_datasets, get_dataset_fn

    assert available_datasets() == javailable()
    with pytest.raises(ValueError):
        get_dataset_fn("nope")


def test_stm_parsing_and_segment_zeroing(tmp_path):
    from lcasr_tpu.evaluation.datasets.tedlium import parse_stm as jparse
    from lcasr_torch.evaluation.datasets.tedlium import parse_stm, zero_out_spectogram

    stm = "\n".join([
        "talk1 1 speakerA 0.00 4.50 <o,f0,male> hello world this is a talk",
        "talk1 1 inter_segment_gap 4.50 7.00 <o,f0,> ignore_time_segment_in_scoring",
        "talk1 1 speakerA 7.00 10.00 <o,f0,male> and it continues <unk> here",
    ])
    p = tmp_path / "talk1.stm"
    p.write_text(stm)
    text, remove = parse_stm(str(p))
    assert (text, remove) == jparse(str(p))
    assert text == "hello world this is a talk and it continues here"
    assert remove == [{"start": 4.5, "end": 7.0}]
    out = zero_out_spectogram(np.ones((1, 80, 1200), np.float32), remove, buffer=-0.5)
    assert out[:, :, 500:650].sum() == 0  # 4.5 + 0.5 -> frame 500; 7.0 - 0.5 -> 650
    assert out[:, :, :500].sum() > 0 and out[:, :, 650:].sum() > 0


def test_earnings22_preprocessing_and_synthetic_adapter():
    from lcasr_tpu.evaluation.datasets import get_dataset_fn as jget
    from lcasr_tpu.evaluation.datasets.earnings22 import preprocess_transcript as jpre
    from lcasr_torch.evaluation.datasets import get_dataset_fn
    from lcasr_torch.evaluation.datasets.earnings22 import preprocess_transcript

    text = "Hello, <silence> WORLD - this <laugh> is… a test? <crosstalk>"
    assert preprocess_transcript(text) == jpre(text)
    items = get_dataset_fn("synthetic")("test", n_recordings=2, n_frames=100)
    jitems = jget("synthetic")("test", n_recordings=2, n_frames=100)
    for it, jt in zip(items, jitems):
        (spec, gold), (jspec, jgold) = it["process_fn"](it), jt["process_fn"](jt)
        assert spec.shape == (1, 80, 100) and gold == jgold
        np.testing.assert_array_equal(spec, jspec)


def test_tedlium_adapter_runs_the_frontend_on_the_given_device(tmp_path):
    from scipy.io import wavfile

    from lcasr_tpu.evaluation.datasets import get_dataset_fn as jget
    from lcasr_torch.evaluation.datasets import get_dataset_fn

    base = tmp_path / "legacy" / "test"
    (base / "sph").mkdir(parents=True)
    (base / "stm").mkdir()
    rng = np.random.default_rng(3)
    wavfile.write(str(base / "sph" / "talk1.wav"), 16000,
                  (rng.normal(size=16000 * 3) * 3000).astype(np.int16))
    (base / "stm" / "talk1.stm").write_text(
        "talk1 1 s 0.00 1.50 <o,f0,male> hello there\n"
        "talk1 1 s 1.50 2.00 <o,f0,> ignore_time_segment_in_scoring\n")
    item = get_dataset_fn("tedlium")("test", base_path=str(tmp_path), device="cpu")[0]
    jitem = jget("tedlium")("test", base_path=str(tmp_path))[0]
    spec, gold = item["process_fn"](item)
    jspec, jgold = jitem["process_fn"](jitem)
    assert isinstance(spec, np.ndarray) and gold == jgold == "hello there"
    # fp32 frontends on both sides, the zeroed span included
    np.testing.assert_allclose(spec, jspec, rtol=0, atol=1e-4 * np.abs(jspec).max())


# ---------------------------------------------------------------------------
# reference-layout checkpoints (import_torch) and evaluate
# ---------------------------------------------------------------------------
def _conv2d_to_torch(k):  # (Kh, Kw, I, O) -> (O, I, Kh, Kw)
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def reference_state_dict(variables, cfg):
    """The reference (`lcasr`) torch layout of a flax SCConformerXL tree:
    the inverse of `lcasr_tpu.models.import_torch.convert_sconformer_state_dict`."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    H, D = cfg["n_heads"], cfg["head_dim"]
    C = cfg["subsampling_conv_channels"]
    sd = {}
    sub = p["subsampling"]
    sd["subsampling.conv.0.weight"] = _conv2d_to_torch(sub["conv_in"]["kernel"])
    sd["subsampling.conv.0.bias"] = sub["conv_in"]["bias"]
    for i in range(2):
        for name, idx in ((f"dw_conv_{i}", 2 + 3 * i), (f"pw_conv_{i}", 3 + 3 * i)):
            sd[f"subsampling.conv.{idx}.weight"] = _conv2d_to_torch(sub[name]["kernel"])
            sd[f"subsampling.conv.{idx}.bias"] = sub[name]["bias"]
    k = sub["out"]["kernel"]  # (F * C, d), flattened (F, C)
    F_, d = k.shape[0] // C, k.shape[1]
    sd["subsampling.out.weight"] = k.reshape(F_, C, d).transpose(2, 1, 0).reshape(d, C * F_)
    for i in range(cfg["n_layers"]):
        lp, pre = p[f"layers_{i}"], f"layers.{i}"

        def norm(prefix, leaf):
            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = leaf["scale"], leaf["bias"]

        for ff in ("ff1", "ff2"):
            norm(f"{pre}.{ff}.fn.norm", lp[f"{ff}_norm"])
            sd[f"{pre}.{ff}.fn.fn.fc1.weight"] = lp[ff]["fc1"]["kernel"].T
            sd[f"{pre}.{ff}.fn.fn.fc2.weight"] = lp[ff]["fc2"]["kernel"].T
        norm(f"{pre}.attend.norm", lp["attn_norm"])
        qkv = lp["attend"]["qkv_proj"]["kernel"].T  # (3HD, d), packed (3, H, D)
        sd[f"{pre}.attend.fn.qkv_proj.weight"] = (
            qkv.reshape(3, H, D, -1).transpose(1, 2, 0, 3).reshape(3 * H * D, -1))
        sd[f"{pre}.attend.fn.out_proj.weight"] = lp["attend"]["out_proj"]["kernel"].T
        norm(f"{pre}.conv.norm", lp["conv_norm"])
        conv, fn = lp["conv"], f"{pre}.conv.fn"
        sd[f"{fn}.pointwise_conv1.weight"] = conv["pointwise_conv1"]["kernel"].T[:, :, None]
        sd[f"{fn}.pointwise_conv1.bias"] = conv["pointwise_conv1"]["bias"]
        sd[f"{fn}.depthwise_conv.weight"] = conv["depthwise_kernel"].T[:, None, :]
        sd[f"{fn}.depthwise_conv.bias"] = conv["depthwise_bias"]
        sd[f"{fn}.pointwise_conv2.weight"] = conv["pointwise_conv2"]["kernel"].T[:, :, None]
        sd[f"{fn}.pointwise_conv2.bias"] = conv["pointwise_conv2"]["bias"]
        sd[f"{fn}.batch_norm.weight"] = conv["norm"]["weight"]
        sd[f"{fn}.batch_norm.bias"] = conv["norm"]["bias"]
        st = bs[f"layers_{i}"]["conv"]["norm"]
        sd[f"{fn}.batch_norm.running_mean"] = st["running_mean"]
        sd[f"{fn}.batch_norm.running_std"] = st["running_std"]
        sd[f"{fn}.batch_norm.num_batches_tracked"] = np.asarray(st["num_batches_tracked"],
                                                                np.int64)
        norm(f"{pre}.norm_out", lp["norm_out"])
    for name in ("ff", "reprojection"):
        sd[f"decoder.{name}.weight"] = p["decoder"][name]["kernel"].T
        sd[f"decoder.{name}.bias"] = p["decoder"][name]["bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """A `.pt` checkpoint in the reference layout: (path, flax variables)."""
    from lcasr_tpu.models.sconformer_xl import SCConformerXL

    model = SCConformerXL(vocab_size=VOCAB, **MODEL_CFG)
    variables = randomize(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256))), seed=3)
    path = str(tmp_path_factory.mktemp("ckpt") / "ref.pt")
    torch.save({"config": {"model": MODEL_CFG}, "model": reference_state_dict(variables, MODEL_CFG)},
               path)
    return path, variables


def test_import_torch_matches_jax(reference_checkpoint):
    """Both packages import the same reference-layout state dict: the same
    flax tree, and the port's model gives the JAX model's log-probs within
    1e-4 (fp32; see tests/test_torch_port_model.py)."""
    from lcasr_tpu.models import import_torch as jimp
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models import import_torch as timp
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    path, variables = reference_checkpoint
    cfg, sd = timp.load_torch_checkpoint(path)
    jv = jimp.variables_from_torch(jimp.load_torch_checkpoint(path)[1], MODEL_CFG)
    tv = timp.variables_from_torch(sd, cfg["model"])
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jv), tv)
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, variables["params"]),
                 tv["params"])
    port = SCConformerXL(vocab_size=VOCAB, **MODEL_CFG, device="cpu")
    port.load_state_dict(timp.state_dict_from_torch(sd, cfg["model"]), strict=True)
    x = np.random.default_rng(0).normal(size=(2, 80, 300)).astype(np.float32)
    lens = np.array([300, 211], np.int32)
    want = JModel(vocab_size=VOCAB, **MODEL_CFG, use_pallas=False).apply(
        jv, jnp.asarray(x), length=jnp.asarray(lens))["final_posteriors"]
    with torch.no_grad():
        got = port(torch.from_numpy(x), length=torch.from_numpy(lens))["final_posteriors"]
    n = min(got.shape[1], want.shape[1])
    for b, ln in enumerate([38, 27]):  # the valid output frames
        np.testing.assert_allclose(got[b, :ln].numpy(), np.asarray(want)[b, :ln],
                                   atol=1e-4, rtol=0)
    assert n >= 38
    bad = dict(sd, **{"layers.0.attend.fn.qkv_proj.bias": np.zeros(192, np.float32)})
    with pytest.raises(ValueError, match="bias"):
        timp.state_dict_from_torch(bad, cfg["model"])
    extra = dict(sd, mystery=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unmapped"):
        timp.state_dict_from_torch(extra, cfg["model"])


ENC_DEC_CFG = dict(d_model=64, n_layers=2, n_heads=2, head_dim=32,
                   subsampling_conv_channels=32, vocab_size=48)


def reference_enc_dec_state_dict(variables, cfg):
    """The reference (`lcasr`) torch layout of a flax EncDecSconformerV2
    tree: the inverse of `lcasr_tpu.models.import_torch.
    convert_enc_dec_v2_state_dict` (qkv packed (h, d, qkv), the cross kv
    (h, d, kv), the CTC head `ctc_decoder`, the decoder in PreNorm blocks)."""
    p = variables["params"]
    H, D = cfg["n_heads"], cfg["head_dim"]
    sd = {}
    for k, v in reference_state_dict(variables, cfg).items():  # the encoder
        sd["ctc_" + k if k.startswith("decoder.") else k] = v.numpy()
    norm = p["decoder"]["norm"]
    sd["ctc_decoder.norm.weight"], sd["ctc_decoder.norm.bias"] = norm["scale"], norm["bias"]

    def fourier(prefix, f):
        sd[f"{prefix}.w_r"] = f["w_r"]
        for i, j in ((0, 0), (1, 2)):
            sd[f"{prefix}.mlp.{j}.weight"] = f[f"mlp_{i}"]["kernel"].T
            sd[f"{prefix}.mlp.{j}.bias"] = f[f"mlp_{i}"]["bias"]

    def packed(kernel, n):  # ours (n, H, D) outermost -> the reference's (H, D, n)
        w = kernel.T
        return w.reshape(n, H, D, -1).transpose(1, 2, 0, 3).reshape(n * H * D, -1)

    fourier("pos_enc", p["encoder_pos_enc"])
    lm, dec = "language_model_decoder", p["language_model_decoder"]
    sd[f"{lm}.embed.weight"] = dec["embed"]["embedding"]
    fourier(f"{lm}.pos_enc", dec["pos_enc"])
    sd[f"{lm}.out_proj.0.scale"] = dec["out_norm"]["scale"]
    sd[f"{lm}.out_proj.1.weight"] = dec["out_proj"]["kernel"].T
    sd[f"{lm}.out_proj.1.bias"] = dec["out_proj"]["bias"]
    for j, name in enumerate(("mlp_0", "mlp_1", "proj")):
        leaf = dec["dynamic_pos_bias"][name]
        key = f"{lm}.positional_bias.mlp.{j}" + (".0" if j < 2 else "")
        sd[f"{key}.weight"], sd[f"{key}.bias"] = leaf["kernel"].T, leaf["bias"]
    for i in range(cfg["n_layers"]):
        pre, sa, ca = f"{lm}.layers.{i}", dec[f"self_attn_{i}"], dec[f"cross_attn_{i}"]
        sd[f"{pre}.0.norm.scale"] = dec[f"self_norm_{i}"]["scale"]
        sd[f"{pre}.0.fn.qkv_proj.weight"] = packed(sa["qkv_proj"]["kernel"], 3)
        sd[f"{pre}.0.fn.out_proj.weight"] = sa["out_proj"]["kernel"].T
        sd[f"{pre}.0.fn.temperature"] = sa["temperature"]
        sd[f"{pre}.1.norm.scale"] = dec[f"cross_norm_{i}"]["scale"]
        sd[f"{pre}.1.fn.q_proj.weight"] = ca["q_proj"]["kernel"].T
        sd[f"{pre}.1.fn.kv_proj.weight"] = packed(ca["kv_proj"]["kernel"], 2)
        sd[f"{pre}.1.fn.out_proj.weight"] = ca["out_proj"]["kernel"].T
        sd[f"{pre}.1.fn.qkv_proj.weight"] = np.zeros((3 * H * D, cfg["d_model"]), np.float32)
        sd[f"{pre}.2.norm.scale"] = dec[f"ff_norm_{i}"]["scale"]
        sd[f"{pre}.2.fn.fc1.weight"] = dec[f"ff_{i}"]["fc1"]["kernel"].T
        sd[f"{pre}.2.fn.fc2.weight"] = dec[f"ff_{i}"]["fc2"]["kernel"].T
    # np.array copies contiguously and keeps the scalar temperatures 0-d
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_import_torch_enc_dec_matches_jax(tmp_path):
    """Both packages import the same reference-layout EncDecSconformerV2
    `.pt`: the same flax tree (the one it was written from), and the port's
    model built from it gives the JAX model's CTC log-probs and decoder
    logits within 1e-4 (fp32).  A tensor neither maps raises."""
    from lcasr_tpu.models import import_torch as jimp
    from lcasr_tpu.models.enc_dec_sconformer import EncDecSconformerV2 as JModel
    from lcasr_torch.models import import_torch as timp
    from lcasr_torch.models.enc_dec_sconformer import EncDecSconformerV2
    from lcasr_torch.models.import_jax import state_dict_from_flax

    jm = JModel(**ENC_DEC_CFG, use_pallas=False)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256)),
                                  text_sequence=jnp.zeros((1, 4), jnp.int32)), seed=21)
    path = str(tmp_path / "enc_dec.pt")
    torch.save({"config": {"model": ENC_DEC_CFG},
                "model": reference_enc_dec_state_dict(variables, ENC_DEC_CFG)}, path)
    cfg, sd = timp.load_torch_checkpoint(path)
    jv = jimp.variables_from_torch_enc_dec(jimp.load_torch_checkpoint(path)[1], ENC_DEC_CFG)
    tv = timp.variables_from_torch_enc_dec(sd, cfg["model"])
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jv), tv)
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, variables), tv)
    port = EncDecSconformerV2(**ENC_DEC_CFG, device="cpu")
    port.load_state_dict(state_dict_from_flax(tv), strict=True)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, 80, 300)).astype(np.float32)
    lens = np.array([300, 211], np.int32)
    text = rng.integers(1, ENC_DEC_CFG["vocab_size"], size=(2, 9)).astype(np.int32)
    want = jm.apply(jv, jnp.asarray(x), text_sequence=jnp.asarray(text),
                    length=jnp.asarray(lens))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(text), length=torch.from_numpy(lens))
    for key in ("final_posteriors_ctc", "final_posteriors_lm"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0,
                                   err_msg=key)
    extra = dict(sd, **{"language_model_decoder.mystery": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unmapped"):
        timp.variables_from_torch_enc_dec(extra, cfg["model"])


def _rows(summary):
    """The rows and aggregate without the wall-clock numbers."""
    drop = ("wall_seconds", "rtfx", "device", "rows")
    rows = [{k: v for k, v in r.items() if k not in drop} for r in summary["rows"]]
    return rows, {k: v for k, v in summary.items() if k not in drop}


def _capture_hyps(monkeypatch, module):
    """Record each hypothesis string `evaluate` scores (its WER call)."""
    hyps = []
    real = module.word_error_rate_detail

    def spy(h, r, *a, **kw):
        hyps.append(h[0])
        return real(h, r, *a, **kw)

    monkeypatch.setattr(module, "word_error_rate_detail", spy)
    return hyps


@pytest.mark.parametrize("mode", ["averaged_moving_window", "buffered", "windowed_attention"])
def test_evaluate_matches_jax(mode, reference_checkpoint, monkeypatch):
    """The same `.pt` through both `evaluate`s on `synthetic`: the same
    hypothesis strings and the same rows and aggregate (fp32 models, the
    spectrogram uploaded in bf16 by both averaged-moving-window decoders)."""
    import lcasr_tpu.evaluation.run as jrun
    import lcasr_torch.evaluation.run as trun

    path, _ = reference_checkpoint
    kw = dict(checkpoint=path, dataset="synthetic", seq_len=512, overlap=384,
              evaluation_mode=mode, verbose=False,
              dataset_kwargs={"n_recordings": 2, "n_frames": 1500})
    jhyps, thyps = _capture_hyps(monkeypatch, jrun), _capture_hyps(monkeypatch, trun)
    want = jrun.evaluate(**kw)
    got = trun.evaluate(**kw, device="cpu")
    assert thyps == jhyps and len(thyps) == 2 and all(thyps)
    assert _rows(got) == _rows(want)
    assert got["device"] == "cpu" and got["rtfx"] > 0


def test_evaluate_refusals(reference_checkpoint, tmp_path):
    import lcasr_torch.evaluation.run as trun

    path, _ = reference_checkpoint
    kw = dict(checkpoint=path, dataset="synthetic", verbose=False, device="cpu")
    # data_parallel / context_parallel are taken (the spawned worlds of
    # test_torch_port_parallel.py / test_torch_port_cp.py run them); with no
    # world joined they decode on one device, as the JAX function does on one
    # chip, and give the rows of the decode without them
    small = dict(kw, seq_len=512, overlap=384,
                 dataset_kwargs={"n_recordings": 1, "n_frames": 1500})
    for mode in ("averaged_moving_window", "windowed_attention"):
        plain = trun.evaluate(**small, evaluation_mode=mode)
        both = trun.evaluate(**small, evaluation_mode=mode,
                             data_parallel=mode == "averaged_moving_window",
                             context_parallel=mode == "windowed_attention")
        assert _rows(both) == _rows(plain)
    # W8A8 is taken (tests/test_torch_port_qdense.py); a site it does not
    # know is refused
    with pytest.raises(ValueError, match="unknown quant_w8a8 site"):
        trun.evaluate(**kw, quant_w8a8="fp8")
    orbax = tmp_path / "orbax_ckpt"
    (orbax / "arrays").mkdir(parents=True)
    (orbax / "meta.json").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        trun.load_any_checkpoint(str(orbax))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trun.evaluate(checkpoint=path, dataset="synthetic", verbose=False)


def test_evaluate_reads_a_port_checkpoint_directory(reference_checkpoint, tmp_path):
    """A checkpoint written by the port's Trainer (step_N/arrays.pt +
    meta.json) gives the same rows as the `.pt` it was made from."""
    import lcasr_torch.evaluation.run as trun
    from lcasr_torch.config import Config
    from lcasr_torch.training.checkpointing import save_checkpoint

    path, _ = reference_checkpoint
    cfg, sd = trun.load_any_checkpoint(path)
    save_checkpoint(str(tmp_path), 7, sd, config=Config({"model": MODEL_CFG}))
    kw = dict(dataset="synthetic", seq_len=512, overlap=384, verbose=False, device="cpu",
              dataset_kwargs={"n_recordings": 1, "n_frames": 700})
    assert (_rows(trun.evaluate(checkpoint=str(tmp_path), **kw))
            == _rows(trun.evaluate(checkpoint=path, **kw)))


@pytest.mark.parametrize("target", ["gold", "hypothesis"])
def test_evaluate_loss_matches_jax(target, reference_checkpoint):
    """Per-recording CTC NLL over the same averaged log-probs: within 1e-3
    relative (fp32 decodes that agree to ~1e-4 in log-prob, summed over a
    few hundred frames)."""
    from lcasr_tpu.evaluation.loss_eval import evaluate_loss as jloss
    from lcasr_torch.evaluation.loss_eval import evaluate_loss

    path, _ = reference_checkpoint
    kw = dict(checkpoint=path, dataset="synthetic", seq_len=512, overlap=384, target=target,
              verbose=False, dataset_kwargs={"n_recordings": 2, "n_frames": 1200})
    want, got = jloss(**kw), evaluate_loss(**kw, device="cpu")
    assert len(got["rows"]) == len(want["rows"]) > 0
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["recording"], g["tokens"], g["frames"]) == (w["recording"], w["tokens"],
                                                              w["frames"])
        assert np.isclose(g["nll"], w["nll"], rtol=1e-3, atol=0)
    assert np.isclose(got["nll_per_token"], want["nll_per_token"], rtol=1e-3, atol=0)


def test_eval_cli_on_the_cpu(reference_checkpoint, capsys, monkeypatch):
    import sys

    import lcasr_torch.evaluation.run as trun

    path, _ = reference_checkpoint
    monkeypatch.setattr(sys, "argv", [
        "run", "-c", path, "-d", "synthetic", "-seq", "512", "-overlap", "384",
        "--device", "cpu", "--dataset_kwargs", "n_recordings=1", "n_frames=600"])
    trun.main()
    out = capsys.readouterr().out
    assert "synthetic_0: WER" in out and '"device": "cpu"' in out
    assert os.path.exists(path)
