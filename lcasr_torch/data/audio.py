"""Audio frontend: WAV reader, polyphase resampler and mel spectrogram
(the port's copy of lcasr_tpu/data/audio.py).

Parameter-compatible with the reference frontend (reference
`lcasr/utils/audio_tools.py:14-72`): 16 kHz audio, win 400 / hop 160 (100
frames/s), n_fft 512, 80 HTK mels, power-2 magnitude, no log compression,
and per-recording mean/std normalisation over time for each mel bin (the
unbiased std, as torch's `Tensor.std`).

The JAX package reads WAV files with scipy and resamples with
`scipy.signal.resample_poly`.  The port needs neither: `load_audio` parses
the RIFF chunks itself and returns exactly what the JAX `load_audio` returns
(dtype and values), and `resample` is the same function as
`resample_poly(x, up, down)` with its default Kaiser (beta 5) window, run in
torch on the waveform's device.  `spectrogram`, `mel_spectrogram` and
`resample` run on the device of the tensor they are given (a numpy array
goes to `device`, where `None` means the GPU); `processing_chain` takes a
file to a (1, 80, T) mel spectrogram on `device`, in three spans
(`frontend.read`, `frontend.resample`, `frontend.mel`, utils/profiling.py).
"""
from __future__ import annotations

import functools
import math
import struct
from typing import Tuple, Union

import numpy as np
import torch

from lcasr_torch.device import resolve_device
from lcasr_torch.utils.profiling import span

WIN_LENGTH = 400
HOP_LENGTH = 160
N_FFT = 512
N_MELS = 80
SR = 16000

Array = Union[np.ndarray, torch.Tensor]


def total_seconds(spectogram_length: int) -> float:
    """Frames -> seconds (reference `audio_tools.py:59-61`)."""
    return (spectogram_length * HOP_LENGTH) / SR


def total_frames(seconds: float) -> int:
    """Seconds -> frames (reference `audio_tools.py:63-65`)."""
    return int((seconds * SR) / HOP_LENGTH)


def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def mel_filterbank(
    n_freqs: int = N_FFT // 2 + 1,
    f_min: float = 0.0,
    f_max: float = SR / 2,
    n_mels: int = N_MELS,
    sample_rate: int = SR,
) -> np.ndarray:
    """HTK-scale triangular mel filterbank, shape (n_freqs, n_mels), no norm."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(np.array(f_min)), _hz_to_mel_htk(np.array(f_max)), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _hann_window(win_length: int = WIN_LENGTH, n_fft: int = N_FFT) -> np.ndarray:
    """Periodic Hann window of win_length, zero-padded (centered) to n_fft."""
    n = np.arange(win_length)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[left : left + win_length] = w
    return out


def _as_tensor(x: Array, device=None) -> torch.Tensor:
    """A tensor stays where it is; a numpy array goes to `device`."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of a length-n signal reflect-padded by `pad` on each side
    (numpy's "reflect", repeated for signals shorter than the pad)."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _power(frames: torch.Tensor, win_length: int = WIN_LENGTH) -> torch.Tensor:
    """(..., n_frames, n_fft) raw frames -> (..., n_frames, n_freqs) |STFT|^2
    (Hann window, rfft) in the frames' dtype."""
    n_fft = frames.shape[-1]
    win = torch.as_tensor(_hann_window(win_length, n_fft), device=frames.device)
    return torch.fft.rfft(frames * win.to(frames.dtype), n=n_fft, dim=-1).abs() ** 2


def power_to_mel(frames: torch.Tensor) -> torch.Tensor:
    """(..., n_frames, N_FFT) raw frames -> (..., N_MELS, n_frames) mel power
    in the frames' dtype: Hann window, rfft, |.|^2, the HTK filterbank.  The
    offline frontend and the online transcriber's incremental frontend both
    end here, so they compute each frame the same way."""
    fb = torch.as_tensor(mel_filterbank(), device=frames.device).to(frames.dtype)
    return torch.matmul(_power(frames), fb).transpose(-1, -2)


def spectrogram_frames(waveform: torch.Tensor, n_fft: int = N_FFT,
                       hop_length: int = HOP_LENGTH) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_fft) frames with center=True reflect
    padding, n_frames = T // hop + 1."""
    pad = n_fft // 2
    x = waveform[..., _reflect_index(waveform.shape[-1], pad, waveform.device)]
    return x.unfold(-1, n_fft, hop_length)


def spectrogram(waveform: Array, n_fft: int = N_FFT, win_length: int = WIN_LENGTH,
                hop_length: int = HOP_LENGTH, device=None) -> torch.Tensor:
    """Power spectrogram |STFT|^2 with center=True reflect padding:
    (..., T) -> (..., n_freqs, n_frames)."""
    frames = spectrogram_frames(_as_tensor(waveform, device), n_fft, hop_length)
    return _power(frames, win_length).transpose(-1, -2)


def mel_spectrogram(waveform: Array, global_normalisation: bool = True,
                    device=None) -> torch.Tensor:
    """Mel spectrogram matching reference `to_spectogram`
    (`audio_tools.py:44-57`): (channels, T) or (T,) -> (channels, n_mels,
    n_frames), in the waveform's dtype, on its device.  The per-recording
    normalisation uses the unbiased std (ddof = 1) over time."""
    x = _as_tensor(waveform, device)
    if x.dim() == 1:
        x = x[None]
    mel = power_to_mel(spectrogram_frames(x))
    if global_normalisation:
        mean = mel.mean(-1, keepdim=True)
        n = mel.shape[-1]
        var = ((mel - mean) ** 2).sum(-1, keepdim=True) / max(n - 1, 1)
        mel = (mel - mean) / torch.sqrt(var)
    return mel


# ---------------------------------------------------------------------------
# polyphase resampling: scipy.signal.resample_poly(x, up, down) with its
# default window ('kaiser', 5.0) and constant (zero) padding
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _lowpass(up: int, down: int) -> Tuple[np.ndarray, int]:
    """The filter resample_poly designs and pads: (taps as float32 with the
    gain `up`, zero-padded in front so that output 0 sits at the filter's
    centre; the upfirdn outputs to drop in front)."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    numtaps = 2 * half_len + 1
    cutoff = 1.0 / max_rate  # relative to Nyquist
    m = np.arange(numtaps, dtype=np.float64) - 0.5 * (numtaps - 1)
    h = cutoff * np.sinc(cutoff * m) * np.kaiser(numtaps, 5.0)
    h = (h / h.sum()).astype(np.float32)  # firwin's unit gain at DC
    h *= np.float32(up)
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    return np.concatenate([np.zeros(n_pre_pad, np.float32), h]), n_pre_remove


def _resample_poly(x: torch.Tensor, up: int, down: int, chunk: int = 1 << 26) -> torch.Tensor:
    """(..., n_in) -> (..., n_out) along the last axis.

    upfirdn's output k is sum_i x[i] h[k down - i up] (h the padded taps),
    and resample_poly keeps outputs n_pre_remove .. n_pre_remove + n_out.
    Kept output k = r + up n (r = 0 .. up - 1) uses the taps of phase
    p_r = (k + n_pre_remove) down mod up, which depends on r alone, and the
    inputs b_r + n down - t for t = 0 .. taps per phase - 1, with
    b_r = floor((r + n_pre_remove) down / up).  So each residue r is one
    strided correlation with its phase's taps; they are gathered in chunks
    of about `chunk` products."""
    h, n_pre_remove = _lowpass(up, down)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    T = -(-len(h) // up)  # taps per phase
    taps = np.zeros(T * up, np.float32)
    taps[: len(h)] = h
    r = np.arange(up)
    phase = ((r + n_pre_remove) * down) % up
    base = ((r + n_pre_remove) * down) // up  # b_r
    w = torch.as_tensor(taps.reshape(T, up).T[phase], device=x.device).to(x.dtype)  # (up, T)
    n_per = -(-n_out // up)  # outputs per residue (the last row is cut below)
    # x padded with zeros: T - 1 in front (t up to T - 1 back from b_0 = 0
    # or more) and enough behind for the largest index
    front = T - 1
    last = int(base.max()) + (n_per - 1) * down
    back = max(0, last - (n_in - 1))
    lead = x.shape[:-1]
    xp = torch.nn.functional.pad(x.reshape(-1, n_in), (front, back))
    base_t = torch.as_tensor(base, device=x.device)[:, None, None]  # (up, 1, 1)
    t_idx = torch.arange(T, device=x.device)[None, None, :]
    n_chunk = max(1, chunk // (up * T))
    out = torch.empty((xp.shape[0], up, n_per), dtype=x.dtype, device=x.device)
    for n0 in range(0, n_per, n_chunk):
        n = torch.arange(n0, min(n0 + n_chunk, n_per), device=x.device)[None, :, None]
        idx = base_t + n * down - t_idx + front  # (up, n, T)
        out[:, :, n0 : n0 + n.shape[1]] = (xp[:, idx] * w[:, None, :]).sum(-1)
    y = out.transpose(1, 2).reshape(xp.shape[0], -1)[:, :n_out]
    return y.reshape(*lead, n_out)


def resample(waveform: Array, orig_sr: int, new_sr: int, device=None) -> torch.Tensor:
    """Polyphase resampling along the last axis, in torch on the waveform's
    device (a numpy array goes to `device`): `resample_poly(x, new_sr / g,
    orig_sr / g)`, g = gcd, float32 out."""
    x = _as_tensor(waveform, device).to(torch.float32)
    if orig_sr == new_sr:
        return x
    g = math.gcd(orig_sr, new_sr)
    return _resample_poly(x, new_sr // g, orig_sr // g)


# ---------------------------------------------------------------------------
# WAV files
# ---------------------------------------------------------------------------
_PCM, _IEEE_FLOAT, _EXTENSIBLE = 0x0001, 0x0003, 0xFFFE
# the tail of the KSDATAFORMAT_SUBTYPE GUIDs, {XXXXXXXX-0000-0010-8000-00AA00389B71}
_GUID_TAIL = {"<": b"\x00\x00\x10\x00\x80\x00\x00\xAA\x00\x38\x9B\x71",
              ">": b"\x00\x00\x00\x10\x80\x00\x00\xAA\x00\x38\x9B\x71"}


def read_wav(path: str) -> Tuple[int, np.ndarray]:
    """(sample rate, samples) of a RIFF (or big-endian RIFX) WAV file, as
    `scipy.io.wavfile.read` gives them: PCM of 8 bits or fewer as uint8,
    other PCM as the smallest signed type that holds a sample container,
    left-justified (24-bit in int32, scaled by 2^8), IEEE float 32/64 as
    float32/64, in native byte order; (T,) for one channel, else (T,
    channels).  Chunks other than `fmt ` and `data` (LIST, fact, ...) are
    skipped, with their pad byte when their size is odd;
    WAVE_FORMAT_EXTENSIBLE takes the format of its sub-format GUID."""
    with open(path, "rb") as f:
        buf = f.read()
    fmt, e, off, size = _wav_layout(buf, path)
    return fmt[2], _decode_samples(memoryview(buf)[off : off + size], *fmt, e)


def _wav_layout(buf: bytes, path: str):
    """(format, byte order, offset and size of the data chunk's samples) of
    a WAV file's bytes; the last data chunk counts, as it does for
    `read_wav`."""
    if buf[:4] == b"RIFF":
        e = "<"
    elif buf[:4] == b"RIFX":
        e = ">"
    else:
        raise ValueError(f"{path}: not a RIFF/RIFX file ({buf[:4]!r})")
    if buf[8:12] != b"WAVE":
        raise ValueError(f"{path}: RIFF form type is {buf[8:12]!r}, not WAVE")
    end = min(len(buf), struct.unpack(e + "I", buf[4:8])[0] + 8)
    pos, fmt, data = 12, None, None
    while pos + 8 <= end:
        cid = buf[pos : pos + 4]
        size = struct.unpack(e + "I", buf[pos + 4 : pos + 8])[0]
        if cid == b"fmt ":
            body = buf[pos + 8 : pos + 8 + size]
            if size < 16:
                raise ValueError(f"{path}: fmt chunk of {size} bytes")
            tag, channels, rate, byte_rate, block_align, bits = struct.unpack(
                e + "HHIIHH", body[:16])
            if tag == _EXTENSIBLE and size >= 18:
                if struct.unpack(e + "H", body[16:18])[0] < 22:
                    raise ValueError(f"{path}: WAVE_FORMAT_EXTENSIBLE without its fields")
                guid = body[24:40]
                if guid.endswith(_GUID_TAIL[e]):
                    tag = struct.unpack(e + "I", guid[:4])[0]
            if tag not in (_PCM, _IEEE_FLOAT):
                raise ValueError(f"{path}: format tag {tag:#06x} is not PCM or IEEE float")
            if tag == _PCM and byte_rate != rate * block_align:
                raise ValueError(f"{path}: byte rate {byte_rate} != rate {rate} x block "
                                 f"align {block_align}")
            fmt = (tag, channels, rate, block_align, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError(f"{path}: data chunk before fmt chunk")
            data = (pos + 8, min(size, len(buf) - pos - 8))
        pos += 8 + size + (size % 2)
    if fmt is None or data is None:
        raise ValueError(f"{path}: no {'fmt' if fmt is None else 'data'} chunk")
    return (fmt, e) + data


def _decode_samples(body, tag: int, channels: int, rate: int, block_align: int,
                    bits: int, e: str) -> np.ndarray:
    width = block_align // channels  # bytes a sample container
    n = len(body) // width
    raw = np.frombuffer(body[: n * width], dtype=np.uint8)
    if tag == _IEEE_FLOAT:
        if bits not in (32, 64):
            raise ValueError(f"{bits}-bit floating-point WAV data")
        data = raw.view(f"{e}f{width}").astype(f"f{width}")
    elif bits <= 8:
        data = raw.copy()  # unsigned
    elif width in (1, 2, 4, 8):
        data = raw.view(f"{e}i{width}").astype(f"i{width}")
    elif width <= 7:  # 3, 5, 6, 7 bytes: left-justified in int32 / int64
        big = 4 if width == 3 else 8
        grid = np.zeros((n, big), np.uint8)
        if e == ">":
            grid[:, :width] = raw.reshape(n, width)
        else:
            grid[:, big - width :] = raw.reshape(n, width)
        data = grid.view(f"{e}i{big}").reshape(n).astype(f"i{big}")
    else:
        raise ValueError(f"{bits}-bit integer WAV data")
    return data.reshape(-1, channels) if channels > 1 else data


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """An audio file -> ((channels, T) float32, sample rate), as the JAX
    `load_audio` gives it: signed PCM divided by 2^(container bits - 1),
    8-bit PCM as (x - 128) / 128, float as float32; `.npy` waveforms are
    16 kHz by contract."""
    if path.lower().endswith(".wav"):
        sr, data = read_wav(path)
        if data.dtype.kind == "i":
            # torchaudio divides by 2^(bits-1) (32768 for int16), not max
            data = data.astype(np.float32) / float(np.iinfo(data.dtype).max + 1)
        elif data.dtype.kind == "u":
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        return (data[None] if data.ndim == 1 else data.T), sr
    if path.lower().endswith(".npy"):
        # the preprocessing contract stores 16 kHz waveforms in .npy: there
        # is no header to consult, so SR is asserted, not detected
        arr = np.load(path)
        return (arr if arr.ndim == 2 else arr[None]).astype(np.float32), SR
    raise ValueError(
        f"Unsupported audio format for {path!r}: only .wav/.npy decode is "
        "available (no ffmpeg/soundfile)."
    )


def load_left_channel(path: str) -> Tuple[np.ndarray, int]:
    """(`grab_left_channel(load_audio(path)[0])`, sample rate), the same
    values, with one copy for a WAV file: the left channel is read as a
    strided view of the file's bytes and converted to float32 and scaled
    once, where `load_audio` converts every channel (twice, with the
    scale) and the left one is copied out after."""
    if not path.lower().endswith(".wav"):
        waveform, sr = load_audio(path)
        return np.ascontiguousarray(grab_left_channel(waveform)), sr
    with open(path, "rb") as f:
        buf = f.read()
    (tag, channels, sr, block_align, bits), e, off, size = _wav_layout(buf, path)
    width = block_align // channels
    if tag == _IEEE_FLOAT and bits in (32, 64):
        dtype = f"{e}f{width}"
    elif tag == _PCM and bits <= 8 and width == 1:
        dtype = "u1"
    elif tag == _PCM and bits > 8 and width in (2, 4, 8):
        dtype = f"{e}i{width}"
    else:  # 24-bit and other packed containers, and what read_wav refuses
        waveform, sr = load_audio(path)
        return np.ascontiguousarray(grab_left_channel(waveform)), sr
    n = size // width
    samples = np.frombuffer(buf, dtype=dtype, count=n, offset=off).reshape(-1, channels)
    left = samples[:, 0].astype(np.float32)[None]  # the one copy
    if dtype == "u1":
        left -= np.float32(128.0)
        left /= np.float32(128.0)
    elif tag == _PCM:  # exact: a power of two, as load_audio's division
        left *= np.float32(2.0 ** (1 - 8 * width))
    return left, sr


def grab_left_channel(waveform: Array) -> Array:
    """Reference `audio_tools.py:28-34` semantics."""
    if waveform.ndim == 2:
        return waveform[0:1]
    if waveform.ndim == 1:
        return waveform[None]
    raise ValueError("Waveform must be 1D or 2D")


def processing_chain(path_in: str, normalise: bool = True, device=None) -> torch.Tensor:
    """File -> normalised mel spectrogram (1, 80, T) on `device` (None: the
    GPU).  Reference `audio_tools.py:67-72`: load -> left channel ->
    resample to 16 kHz -> mel spectrogram with global normalisation."""
    with span("frontend.read"):
        left, sr = load_left_channel(path_in)
        x = torch.from_numpy(left).to(resolve_device(device))
    with span("frontend.resample"):
        x = resample(x, sr, SR)
    with span("frontend.mel"):
        return mel_spectrogram(x, global_normalisation=normalise)
