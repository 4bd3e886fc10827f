"""The port's audio frontend (`lcasr_torch.data.audio.processing_chain`) against
the benchmark's plain one (`lcbench/reference/frontend.py`, float64, nothing
of the port), on the CPU, at three input rates and two lengths.

Tolerances, on the normalised mel (each band zero mean, unit deviation):
  * ||M - M_ref|| / ||M_ref|| <= 1e-5: the port resamples in fp32 (sums of
    ~56-64 taps a phase), frames, transforms and filters in fp32, where the
    reference works in float64; measured 2.1e-7 to 2.3e-7;
  * max |M - M_ref| <= 1e-4: the same rounding at the worst frame and band,
    measured up to 2.2e-6;
and the reference's resampler equals scipy's `resample_poly` to 1e-12
(float64 against float64, measured 2e-15).  A resampler whose filter only
removes the upsampling's images (cutoff 1 / up in place of
1 / max(up, down): no anti-aliasing low-pass) moves the mel by more than 10%
(measured about 100% on white noise).
"""
import os
import struct

import numpy as np
import pytest
import torch

from lcasr_torch.data import audio
from lcbench.reference import frontend as ref

REL, MAX_ABS = 1e-5, 1e-4


def _wav(tmp_path, rate, seconds, seed=0):
    """A mono 16-bit PCM WAV file of white noise."""
    rng = np.random.default_rng(seed)
    pcm = np.clip(rng.standard_normal(int(rate * seconds)) * 4000, -32768, 32767)
    data = pcm.astype("<i2").tobytes()
    path = os.path.join(tmp_path, f"x_{rate}_{seconds}.wav")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt "
                + struct.pack("<IHHIIHH", 16, 1, 1, rate, 2 * rate, 2, 16)
                + b"data" + struct.pack("<I", len(data)) + data)
    return path


def _gaps(path):
    want = ref.frontend(path)
    got = audio.processing_chain(path, device="cpu")[0].double()
    assert got.shape == want.shape
    return float((got - want).norm() / want.norm()), float((got - want).abs().max())


@pytest.mark.parametrize("rate", [44100, 48000, 22050])
@pytest.mark.parametrize("seconds", [1.5, 4.0])
def test_port_frontend_matches_the_plain_one(tmp_path, rate, seconds):
    rel, worst = _gaps(_wav(tmp_path, rate, seconds))
    assert rel <= REL and worst <= MAX_ABS, (rel, worst)


@pytest.mark.parametrize("rate", [44100, 48000, 22050])
def test_reference_resampler_is_scipys(rate):
    from scipy.signal import resample_poly

    x = np.random.default_rng(1).standard_normal(rate)
    got = ref.resample_poly(torch.from_numpy(x), 16000, rate).numpy()
    np.testing.assert_allclose(got, resample_poly(x, 16000, rate), atol=1e-12, rtol=0)


def _lowpass_without_antialias(up, down):
    """`audio._lowpass`'s result for the filter that only removes the
    upsampling's images."""
    half_len = 10 * max(up, down)
    h = ref.kaiser_lowpass(up, down, cutoff=1.0 / up).astype(np.float32)
    n_pre_pad = down - half_len % down
    return np.concatenate([np.zeros(n_pre_pad, np.float32), h]), (half_len + n_pre_pad) // down


def test_a_resampler_without_its_lowpass_is_seen(tmp_path, monkeypatch):
    path = _wav(tmp_path, 44100, 2.0)
    with monkeypatch.context() as m:
        m.setattr(audio, "_lowpass", _lowpass_without_antialias)
        rel, _ = _gaps(path)
    assert rel > 0.1, rel
    assert _gaps(path)[0] <= REL
