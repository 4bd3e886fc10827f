"""lcasr_torch's audio frontend against lcasr_tpu's, on the CPU.

`load_audio` must return what the JAX `load_audio` (scipy's reader) returns,
dtype and values exactly, for every WAV layout the port parses; the 24-bit,
WAVE_FORMAT_EXTENSIBLE and big-endian files are written here by hand, since
`scipy.io.wavfile.write` writes none of them.  `resample` is held against
`scipy.signal.resample_poly`, and the mel frontend against the JAX one, in
fp32 with the tolerances stated at each test.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile
from scipy.signal import resample_poly

from lcasr_tpu.data import audio as ja
from lcasr_torch.data import audio as ta


def _wav(path, data_bytes, tag, channels, sr, bits, width, extensible=False,
         big=False, extra_chunks=()):
    """A WAV file written field by field: `width` bytes a sample container,
    `extra_chunks` ((id, payload), ...) placed before the data chunk (an odd
    payload gets its pad byte)."""
    e = ">" if big else "<"
    block = channels * width
    if extensible:
        guid = struct.pack(e + "I", tag) + (
            b"\x00\x00\x00\x10\x80\x00\x00\xAA\x00\x38\x9B\x71" if big
            else b"\x00\x00\x10\x00\x80\x00\x00\xAA\x00\x38\x9B\x71")
        fmt = struct.pack(e + "HHIIHHHHI", 0xFFFE, channels, sr, sr * block, block, bits,
                          22, bits, (1 << channels) - 1) + guid
    else:
        fmt = struct.pack(e + "HHIIHH", tag, channels, sr, sr * block, block, bits)
    chunks = [(b"fmt ", fmt), *extra_chunks, (b"data", data_bytes)]
    body = b"WAVE"
    for cid, payload in chunks:
        body += cid + struct.pack(e + "I", len(payload)) + payload + b"\x00" * (len(payload) % 2)
    with open(path, "wb") as f:
        f.write((b"RIFX" if big else b"RIFF") + struct.pack(e + "I", len(body)) + body)


def _pcm24(samples: np.ndarray, big=False) -> bytes:
    """int32 samples in [-2^23, 2^23) as packed 3-byte words."""
    u = samples.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
    return (u[:, ::-1] if big else u).tobytes()


def _cases(tmp_path):
    rng = np.random.default_rng(0)
    n = 1001  # odd: 8-bit mono data chunks get a pad byte
    out = {}
    p = str(tmp_path / "u8.wav")
    wavfile.write(p, 16000, rng.integers(0, 256, n).astype(np.uint8))
    out["pcm8"] = p
    p = str(tmp_path / "i16.wav")
    wavfile.write(p, 44100, rng.integers(-32768, 32768, n).astype(np.int16))
    out["pcm16"] = p
    p = str(tmp_path / "i16_stereo.wav")
    wavfile.write(p, 48000, rng.integers(-32768, 32768, (n, 2)).astype(np.int16))
    out["pcm16_stereo"] = p
    p = str(tmp_path / "i32.wav")
    wavfile.write(p, 22050, rng.integers(-2 ** 31, 2 ** 31, (n, 3), dtype=np.int64).astype(np.int32))
    out["pcm32_3ch"] = p
    p = str(tmp_path / "f32.wav")
    wavfile.write(p, 16000, rng.normal(0, 0.3, (n, 2)).astype(np.float32))
    out["float32_stereo"] = p
    p = str(tmp_path / "f64.wav")
    wavfile.write(p, 8000, rng.normal(0, 0.3, n).astype(np.float64))
    out["float64"] = p
    s24 = rng.integers(-2 ** 23, 2 ** 23, 2 * n)
    p = str(tmp_path / "i24.wav")
    _wav(p, _pcm24(s24), 1, 2, 44100, 24, 3)
    out["pcm24_stereo"] = p
    p = str(tmp_path / "i24_ext_list.wav")
    _wav(p, _pcm24(s24[:n]), 1, 1, 48000, 24, 3, extensible=True,
         extra_chunks=((b"LIST", b"INFOISFT\x05\x00\x00\x00port\x00"), (b"junk", b"abc")))
    out["pcm24_extensible_list_odd_chunk"] = p
    p = str(tmp_path / "f32_ext.wav")
    _wav(p, rng.normal(0, 0.3, 3 * n).astype("<f4").tobytes(), 3, 3, 16000, 32, 4,
         extensible=True)
    out["float32_extensible_3ch"] = p
    p = str(tmp_path / "i16_ext_4ch.wav")
    _wav(p, rng.integers(-32768, 32768, 4 * n).astype("<i2").tobytes(), 1, 4, 32000, 16, 2,
         extensible=True)
    out["pcm16_extensible_4ch"] = p
    p = str(tmp_path / "i24_rifx.wav")
    _wav(p, _pcm24(s24[:n], big=True), 1, 1, 44100, 24, 3, big=True)
    out["pcm24_big_endian"] = p
    return out


CASES = ("pcm8", "pcm16", "pcm16_stereo", "pcm32_3ch", "float32_stereo", "float64",
         "pcm24_stereo", "pcm24_extensible_list_odd_chunk", "float32_extensible_3ch",
         "pcm16_extensible_4ch", "pcm24_big_endian")


@pytest.mark.parametrize("case", CASES)
def test_load_audio_matches_jax_exactly(case, tmp_path):
    path = _cases(tmp_path)[case]
    want, sr_want = ja.load_audio(path)
    got, sr_got = ta.load_audio(path)
    assert sr_got == sr_want
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and the raw samples are scipy's, dtype included (24-bit as int32 x 2^8;
    # the port's in native byte order where scipy keeps a RIFX file's)
    want_raw = wavfile.read(path)[1]
    got_raw = ta.read_wav(path)[1]
    assert got_raw.dtype == want_raw.dtype.newbyteorder("=")
    np.testing.assert_array_equal(got_raw, want_raw)


def test_load_audio_npy_and_refusals(tmp_path):
    x = np.random.default_rng(1).normal(size=(2, 300)).astype(np.float64)
    np.save(tmp_path / "w.npy", x)
    got, sr = ta.load_audio(str(tmp_path / "w.npy"))
    want, _ = ja.load_audio(str(tmp_path / "w.npy"))
    assert sr == ta.SR and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="Unsupported"):
        ta.load_audio(str(tmp_path / "x.mp3"))
    bad = tmp_path / "alaw.wav"
    _wav(str(bad), b"\x00" * 10, 6, 1, 8000, 8, 1)  # A-law: not PCM or float
    with pytest.raises(ValueError, match="format tag"):
        ta.load_audio(str(bad))


# 44.1 kHz -> 16 kHz: up 160, down 441, 8,821 taps; "short" is under the
# filter's half length in every case
@pytest.mark.parametrize("sr", [44100, 48000, 22050, 8000])
@pytest.mark.parametrize("n", [1, 7, 300, "3s+17"])
def test_resample_matches_scipy_resample_poly(sr, n):
    """float32 in, float32 out.  The taps are scipy's float32 taps and the
    sums are float32 in another order: agreement within 1e-6 of the largest
    output."""
    n = 3 * sr + 17 if n == "3s+17" else n
    x = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    g = np.gcd(sr, 16000)
    want = resample_poly(x, 16000 // g, sr // g, axis=-1)
    got = ta.resample(x, sr, 16000, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    # the JAX wrapper gives the same
    np.testing.assert_allclose(got.numpy(), ja.resample(x, sr, 16000), rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def test_resample_same_rate_is_identity():
    x = np.arange(10, dtype=np.float32)
    assert torch.equal(ta.resample(x, 16000, 16000, device="cpu"), torch.from_numpy(x))


@pytest.mark.parametrize("normalise", [True, False])
@pytest.mark.parametrize("n", [4001, 16000 * 2 + 33])
def test_mel_spectrogram_matches_jax(normalise, n):
    """fp32 on both sides: rfft and the filterbank product sum in other
    orders, within 1e-5 of the largest value."""
    w = (np.random.default_rng(n).normal(size=(2, n)) * 0.1).astype(np.float32)
    want = np.asarray(ja.mel_spectrogram(jnp.asarray(w), global_normalisation=normalise))
    got = ta.mel_spectrogram(torch.from_numpy(w), global_normalisation=normalise)
    assert tuple(got.shape) == want.shape == (2, 80, n // 160 + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    spec = ta.spectrogram(torch.from_numpy(w))
    np.testing.assert_allclose(spec.numpy(), np.asarray(ja.spectrogram(jnp.asarray(w))),
                               rtol=0, atol=1e-5 * float(spec.abs().max()))


def test_reflect_padding_matches_numpy_for_short_signals():
    for n in (1, 2, 3, 100, 255, 256, 257, 1000):
        x = np.arange(n)
        want = np.pad(x, (256, 256), mode="reflect") if n > 1 else np.zeros(n + 512, int)
        np.testing.assert_array_equal(x[ta._reflect_index(n, 256, "cpu").numpy()], want)


def test_processing_chain_matches_jax(tmp_path):
    """A 44.1 kHz stereo 16-bit file: left channel, resample, normalised
    mel.  The resampler's last-bit differences pass through the normalised
    mel: within 1e-4 of the largest value."""
    rng = np.random.default_rng(5)
    t = np.arange(int(44100 * 1.5)) / 44100
    left = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=t.size)
    stereo = np.stack([left, rng.normal(size=t.size) * 0.1], 1)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 44100, (stereo * 32767).astype(np.int16))
    want = np.asarray(ja.processing_chain(path))
    got = ta.processing_chain(path, device="cpu")
    assert tuple(got.shape) == want.shape == (1, 80, 151)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_frontend_runs_on_the_gpu_by_default(tmp_path):
    """Without device="cpu" the numpy entry points go to the GPU, and raise
    where there is none; a CPU tensor stays on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 16000, np.zeros(1600, np.int16))
    for call in (lambda: ta.processing_chain(path),
                 lambda: ta.resample(np.zeros(100, np.float32), 44100, 16000),
                 lambda: ta.mel_spectrogram(np.zeros(1600, np.float32))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert ta.mel_spectrogram(torch.zeros(1600)).device.type == "cpu"
