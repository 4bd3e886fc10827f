"""The port's host side of training and of decoding from audio against
lcasr_tpu's, on the CPU: the native BPE (`lcasr_torch/native/bpe.cpp`), the
native `.npy` reader (`native/npy.cpp`), their build under concurrent
processes, the dataloader's prefetch thread, `make_chunks` through the
batch encoder, and `processing_chain`'s one-copy left channel.

Every comparison here is exact: token ids, arrays read from disk and
batches are integers or copies of the same bytes, and the left channel is
converted and scaled by a power of two as `load_audio` does, so the mel
spectrogram is the same bits; the JAX frontend runs in another framework,
so `processing_chain` is held to it within 1e-4 of the largest |value|
(`tests/test_torch_port_audio.py`'s tolerance).
"""
import json
import os
import random
import string
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# native BPE
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tokenizers():
    from lcasr_tpu.data.tokenizer import SentencePieceBPE as JaxBPE
    from lcasr_torch.data.tokenizer import SentencePieceBPE

    return (SentencePieceBPE(use_native=True), SentencePieceBPE(use_native=False),
            JaxBPE(use_native=True), JaxBPE(use_native=False))


def _random_texts(n, seed):
    """Seeded texts over letters, digits, punctuation, runs of spaces,
    non-ASCII letters and the surfaces of CONTROL pieces."""
    rng = random.Random(seed)
    alphabet = (list(string.ascii_lowercase * 3) + list(string.digits + ".,'?!-")
                + [" "] * 12 + list("éßüñçøæ中文日本語ё") + ["<s>", "</s>", "<unk>", "<pad>"])
    return ["".join(rng.choices(alphabet, k=rng.randint(0, 60))) for _ in range(n)]


EDGE_TEXTS = ["", " ", "   ", "a", "é", "ß", "ﬁ ligature", "<s>", "</s> <unk>",
              "多语言 mixed 文本", "x" * 2000, "supercalifragilistic" * 40, "Straße UPPER"]


def test_native_bpe_ids_equal_python_and_jax_on_3000_texts(tokenizers):
    native, python, jax_native, jax_python = tokenizers
    texts = _random_texts(3000, seed=0) + EDGE_TEXTS
    got = native.encode_batch(texts)
    assert got == [python.encode(t) for t in texts]
    assert got == [jax_native.encode(t) for t in texts]
    assert got[:400] == [jax_python.encode(t) for t in texts[:400]]  # the JAX Python loop is slow
    # one text at a time through the same library, and as pieces
    assert [native.encode(t) for t in texts[:300]] == got[:300]
    assert native.encode(texts[5], out_type=str) == python.encode(texts[5], out_type=str)


@pytest.mark.parametrize("text", EDGE_TEXTS, ids=range(len(EDGE_TEXTS)))
def test_native_bpe_edge_cases(tokenizers, text):
    native, python, jax_native, _ = tokenizers
    assert native.encode(text) == python.encode(text) == jax_native.encode(text)


def test_native_bpe_c_api_reports_the_capacity_it_needs(tokenizers):
    """`bpe_encode` with too small a buffer writes nothing and returns the
    count it needs; a large enough one gets the ids."""
    native, python = tokenizers[:2]
    native.encode("warm up")
    lib, handle = native._native
    text = native._prepared("hello world of long context speech").encode()
    want = python.encode("hello world of long context speech")
    small = np.full(2, -7, np.int32)
    assert lib.bpe_encode(handle, text, len(text), small.ctypes.data, 2) == len(want)
    assert (small == -7).all()
    big = np.zeros(64, np.int32)
    assert lib.bpe_encode(handle, text, len(text), big.ctypes.data, 64) == len(want)
    assert big[: len(want)].tolist() == want


def test_native_bpe_is_the_default_and_a_failed_build_raises(monkeypatch, tmp_path):
    from lcasr_torch import native
    from lcasr_torch.data.tokenizer import SentencePieceBPE

    assert SentencePieceBPE().use_native
    bad = tmp_path / "bpe.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="bpe"):
        SentencePieceBPE(use_native=True).encode("hello")
    assert not list((tmp_path / "build").glob("*.so"))


def test_make_chunks_equal_with_both_bpe_paths(tmp_path, tokenizers):
    from lcasr_torch.data.dataloading import load_sample
    from lcasr_torch.training.trainer import make_chunks
    from tests.test_train_trajectory_parity import _make_corpus

    pairs = _make_corpus(tmp_path, [700, 300, 520, 900], seed=31)
    samples = [load_sample(v) for v in pairs.values()]
    lens = np.array([s[0].shape[-1] for s in samples])
    audio = np.zeros((4, 80, lens.max()), np.float32)
    for i, (a, _) in enumerate(samples):
        audio[i, :, : a.shape[-1]] = a[0]
    words = [s[1]["results"][-1]["alternatives"][0]["words"] for s in samples]
    native, python = tokenizers[:2]
    a = make_chunks(audio, lens, words, native, 256, 0, native.pad_id())
    b = make_chunks(audio, lens, words, python, 256, 0, python.pad_id())
    assert len(a) == len(b) > 2
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ---------------------------------------------------------------------------
# the host build: named by digest, moved into place atomically
# ---------------------------------------------------------------------------
def test_two_processes_build_the_same_library_at_once_and_both_load_it(tmp_path):
    """Two processes compile the same source into an empty build directory
    at the same moment; both load a library and encode the same ids."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from lcasr_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "from lcasr_torch.data.tokenizer import SentencePieceBPE\n"
        "print(SentencePieceBPE(use_native=True).encode('long context speech recognition'))\n"
    )
    build = tmp_path / "host_build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)], cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert outs[0][0] == outs[1][0] and outs[0][0].startswith("[")
    libs = [f.name for f in build.iterdir()]
    assert len([n for n in libs if n.endswith(".so")]) == 1 and not any(
        n.endswith(".tmp") for n in libs), libs


# ---------------------------------------------------------------------------
# native .npy reader
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32, np.int16, np.int8, np.uint8])
def test_npy_reader_round_trip_every_dtype(tmp_path, dtype):
    from lcasr_tpu.native import load_npy_native
    from lcasr_torch.native import read_npy_batch

    rng = np.random.default_rng(0)
    arrays, paths = [], []
    for i, shape in enumerate([(80, 123), (1, 80, 7), (5,), (3, 1, 2, 4)]):
        a = (rng.normal(size=shape) * 10).astype(dtype)
        paths.append(str(tmp_path / f"a{i}.npy"))
        np.save(paths[-1], a)
        arrays.append(a)
    got = read_npy_batch(paths, threads=3)
    jax_reader = load_npy_native()
    want = jax_reader.read_npy_batch(paths, 3) if jax_reader is not None else arrays
    for g, a, w in zip(got, arrays, want):
        assert g.dtype == a.dtype and g.shape == a.shape
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, w)


def test_npy_reader_zero_dim_and_large(tmp_path):
    from lcasr_torch.native import read_npy_batch

    scalar = np.ones((), np.float32) * 3.5
    big = np.arange(80 * 20000, dtype=np.float16).reshape(80, 20000)
    np.save(tmp_path / "s.npy", scalar)
    np.save(tmp_path / "b.npy", big)
    out = read_npy_batch([str(tmp_path / "s.npy"), str(tmp_path / "b.npy")], threads=2)
    np.testing.assert_array_equal(out[0], scalar)
    np.testing.assert_array_equal(out[1], big)


def test_npy_reader_refuses_missing_non_npy_fortran_and_other_dtypes(tmp_path):
    from lcasr_torch.native import read_npy_batch

    with pytest.raises(FileNotFoundError):
        read_npy_batch([str(tmp_path / "nope.npy")])
    junk = tmp_path / "junk.npy"
    junk.write_bytes(b"not an npy file at all")
    with pytest.raises(ValueError, match="not an .npy"):
        read_npy_batch([str(junk)])
    np.save(tmp_path / "f.npy", np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4)))
    with pytest.raises(ValueError, match="fortran"):
        read_npy_batch([str(tmp_path / "f.npy")])
    np.save(tmp_path / "d.npy", np.zeros(3, np.float64))
    with pytest.raises(ValueError, match="descr"):
        read_npy_batch([str(tmp_path / "d.npy")])
    # a file cut short inside its data: the reader reports it
    np.save(tmp_path / "cut.npy", np.zeros(1000, np.float32))
    data = (tmp_path / "cut.npy").read_bytes()
    (tmp_path / "cut.npy").write_bytes(data[:-100])
    with pytest.raises(OSError, match="cut.npy"):
        read_npy_batch([str(tmp_path / "cut.npy")])


def _loader_batches(loader):
    return [(a.copy(), lens.copy(), json.dumps(txt), list(ids)) for a, lens, txt, ids in loader]


def _assert_same_batches(x, y):
    assert len(x) == len(y) > 0
    for (a1, l1, t1, i1), (a2, l2, t2, i2) in zip(x, y):
        assert i1 == i2 and t1 == t2
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(a1, a2)


def test_loader_prefetch_and_native_reader_give_the_python_and_jax_batches(tmp_path):
    """A whole epoch, then a rebuild with seen_ids at a new batch size (the
    sequence warmup's), and an iterator abandoned mid-epoch: the port's
    loader with prefetch and the native reader gives the batches of the
    port's loader without them and of the JAX loader, in the same order."""
    from lcasr_tpu.data.dataloading import VariableBatchSimpleDataloader as JLoader
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader
    from tests.test_train_trajectory_parity import _make_corpus

    pairs = _make_corpus(tmp_path, [300 + 37 * i for i in range(11)], seed=17)
    for i, v in enumerate(pairs.values()):  # fp16 specs on disk for some
        if i % 3 == 0:
            np.save(v["audio"], np.load(v["audio"]).astype(np.float16))
    kw = dict(pairs=pairs, tokenizer=None, batch_size=3, chunk_size=256, chunk_overlap=0,
              random_seed=5, subgroup_shuffle_size=4)
    fast = VariableBatchSimpleDataloader(**kw, prefetch=True, native=True)
    plain = VariableBatchSimpleDataloader(**kw, prefetch=False, native=False)
    ref = JLoader(**kw, prefetch=False)
    first = _loader_batches(fast)
    _assert_same_batches(first, _loader_batches(plain))
    _assert_same_batches(first, _loader_batches(ref))
    seen = [i for batch in first[:2] for i in batch[3]]
    it = iter(fast)
    next(it)  # abandoned mid-epoch, its worker must let go
    for loader in (fast, plain, ref):
        loader.update(batch_size=2, seen_ids=seen)
    again = _loader_batches(fast)
    assert not set(seen) & {i for batch in again for i in batch[3]}
    _assert_same_batches(again, _loader_batches(plain))
    _assert_same_batches(again, _loader_batches(ref))
    del it


def test_prefetch_raises_the_workers_error_where_its_batch_was():
    from lcasr_torch.data.dataloading import prefetched

    def batches():
        yield 1
        raise KeyError("broken file")

    it = prefetched(batches())
    assert next(it) == 1
    with pytest.raises(KeyError, match="broken file"):
        next(it)


# ---------------------------------------------------------------------------
# processing_chain: the left channel in one copy
# ---------------------------------------------------------------------------
def _write_wav(path, data, rate, bits):
    """PCM WAV of `data` (T, channels) int64 samples at `bits` per sample."""
    import struct

    width = bits // 8
    T, ch = data.shape
    raw = data.astype("<i8").view(np.uint8).reshape(T, ch, 8)[:, :, :width].tobytes()
    fmt = struct.pack("<HHIIHH", 1, ch, rate, rate * ch * width, ch * width, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack(
        "<I", len(raw)) + raw
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("bits,rate", [(16, 16000), (16, 44100), (24, 22050), (32, 16000)])
def test_processing_chain_left_channel_is_unchanged(tmp_path, bits, rate):
    from lcasr_tpu.data.audio import processing_chain as jax_chain
    from lcasr_torch.data import audio

    rng = np.random.default_rng(bits + rate)
    hi = 2 ** (bits - 1)
    data = rng.integers(-hi, hi, size=(rate // 2, 2))
    data[:, 1] = -data[:, 1] // 3  # the right channel differs
    path = str(tmp_path / f"s{bits}.wav")
    _write_wav(path, data, rate, bits)
    waveform, sr = audio.load_audio(path)
    left, sr2 = audio.load_left_channel(path)
    assert sr == sr2 == rate and left.dtype == np.float32 and left.flags.c_contiguous
    np.testing.assert_array_equal(left, audio.grab_left_channel(waveform))
    got = audio.processing_chain(path, device="cpu")
    x = torch.from_numpy(np.ascontiguousarray(audio.grab_left_channel(waveform)))
    want = audio.mel_spectrogram(audio.resample(x, sr, audio.SR), global_normalisation=True)
    assert torch.equal(got, want)  # the two-copy chain of before, bit for bit
    ref = np.asarray(jax_chain(path))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
