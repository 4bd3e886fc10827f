"""The audio frontend, plain: a 16-bit PCM WAV file to the normalised log-free
mel spectrogram lcasr decodes (80 mels, 100 frames a second), in float64.

  read:      the RIFF chunks parsed here; 16-bit PCM, the left channel, / 2^15;
  resample:  to 16 kHz as `scipy.signal.resample_poly(x, up, down)` with its
             default window ('kaiser', 5.0): the low-pass of 2 * 10 *
             max(up, down) + 1 taps at cutoff 1 / max(up, down) of Nyquist,
             scaled to unit gain at DC and by `up`, zero-padded in front so
             that output 0 sits at its centre; every output evaluated
             directly as sum_i x[i] h[k down - i up] over the inputs whose
             tap lies inside the filter (upfirdn's definition, no polyphase
             tables), in blocks of outputs;
  mel:       `torch.stft` (n_fft 512, hop 160, a periodic Hann window of
             400 centred in 512, centre frames with reflect padding), |.|^2,
             the HTK triangular filterbank (80 bands over 0-8 kHz, no norm);
  normalise: each band to zero mean and unit (unbiased) standard deviation
             over the recording's frames.

Nothing of the port is imported: this is the yardstick of
`lcasr_torch.data.audio.processing_chain`.
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch

SR = 16000
N_FFT, HOP, WIN, N_MELS = 512, 160, 400, 80


def read_pcm16_left(path: str):
    """(left channel as float64 numpy array in [-1, 1), sample rate) of a
    16-bit PCM RIFF WAV file."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF WAVE file")
    pos, fmt, data = 12, None, None
    while pos + 8 <= len(buf):
        cid, size = buf[pos:pos + 4], struct.unpack("<I", buf[pos + 4:pos + 8])[0]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", buf[pos + 8:pos + 24])
        elif cid == b"data":
            data = (pos + 8, size)
        pos += 8 + size + (size % 2)
    tag, channels, rate, _, _, bits = fmt
    if tag != 1 or bits != 16:
        raise ValueError(f"{path}: format {tag}, {bits} bits; only 16-bit PCM is read here")
    samples = np.frombuffer(buf, dtype="<i2", count=data[1] // 2, offset=data[0])
    return samples.reshape(-1, channels)[:, 0].astype(np.float64) / 32768.0, rate


def kaiser_lowpass(up: int, down: int, beta: float = 5.0, cutoff=None) -> np.ndarray:
    """resample_poly's filter: firwin(2 * 10 * max_rate + 1, 1 / max_rate,
    window=('kaiser', beta)) times `up`, float64; `cutoff` (of Nyquist)
    in place of 1 / max_rate where given."""
    max_rate = max(up, down)
    n = 2 * 10 * max_rate + 1
    m = np.arange(n) - (n - 1) / 2.0
    cutoff = 1.0 / max_rate if cutoff is None else cutoff
    ideal = cutoff * np.sinc(cutoff * m)
    window = np.i0(beta * np.sqrt(1.0 - (2.0 * np.arange(n) / (n - 1) - 1.0) ** 2)) / np.i0(beta)
    h = ideal * window
    return h / h.sum() * up


def resample_poly(x: torch.Tensor, up: int, down: int, block: int = 1 << 21) -> torch.Tensor:
    """(n_in,) float64 -> (ceil(n_in up / down),), as scipy's resample_poly
    with zero padding."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x.clone()
    h = kaiser_lowpass(up, down)
    half = (len(h) - 1) // 2
    pre_pad = down - half % down
    h = torch.as_tensor(np.concatenate([np.zeros(pre_pad), h]), dtype=x.dtype, device=x.device)
    skip = (half + pre_pad) // down  # the outputs upfirdn makes before output 0
    n_in = x.shape[0]
    n_out = -(-n_in * up // down)
    width = -(-len(h) // up) + 1  # inputs that can meet the filter at one output
    t = torch.arange(width, device=x.device)
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    for k0 in range(0, n_out, block):
        k = torch.arange(k0, min(k0 + block, n_out), device=x.device) + skip
        i = (k * down // up)[:, None] - t[None, :]  # the newest input first
        tap = k[:, None] * down - i * up
        ok = (tap < len(h)) & (i >= 0) & (i < n_in)
        y[k0:k0 + len(k)] = torch.where(ok, x[i.clamp(0, n_in - 1)] * h[tap.clamp(0, len(h) - 1)],
                                        0.0).sum(-1)
    return y


def mel_filterbank(device=None) -> torch.Tensor:
    """(N_FFT / 2 + 1, N_MELS) HTK triangles over 0 .. SR / 2, float64."""
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    edges = hz(np.linspace(mel(0.0), mel(SR / 2), N_MELS + 2))
    freqs = np.linspace(0.0, SR / 2, N_FFT // 2 + 1)
    lo, mid, hi = edges[:-2], edges[1:-1], edges[2:]
    rise = (freqs[:, None] - lo[None, :]) / (mid - lo)[None, :]
    fall = (hi[None, :] - freqs[:, None]) / (hi - mid)[None, :]
    return torch.as_tensor(np.clip(np.minimum(rise, fall), 0.0, None), device=device)


def mel_spectrogram(wave: torch.Tensor) -> torch.Tensor:
    """(n,) float64 at 16 kHz -> (N_MELS, n // HOP + 1), normalised per band."""
    window = torch.hann_window(WIN, periodic=True, dtype=wave.dtype, device=wave.device)
    spec = torch.stft(wave, N_FFT, hop_length=HOP, win_length=WIN, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    mel = mel_filterbank(wave.device).T @ spec.abs() ** 2
    return (mel - mel.mean(-1, keepdim=True)) / mel.std(-1, keepdim=True)


def frontend(path: str, device=None) -> torch.Tensor:
    """A WAV file -> (N_MELS, frames) float64 on `device`."""
    left, rate = read_pcm16_left(path)
    return mel_spectrogram(resample_poly(torch.as_tensor(left, device=device), SR, rate))
