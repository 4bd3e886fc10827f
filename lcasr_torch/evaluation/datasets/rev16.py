"""Rev16 adapter (reference `eval/rev16/run.py:19-62`): ids from test.txt,
audio/<id>.mp3 + transcripts/<id>.txt, Whisper-normalized gold.  Noise-
robustness variants (reference `eval/rev16_gaussian_noise`,
`eval/rev16_background_noise`) inject noise at a controlled SNR into the
waveform before the mel frontend."""
from __future__ import annotations

import os

import numpy as np

from lcasr_torch.data.audio import grab_left_channel, load_audio, mel_spectrogram, resample, SR
from lcasr_torch.evaluation.datasets import register_dataset
from lcasr_torch.evaluation.normalizer import normalize


def _load_ids(ids_path: str):
    with open(ids_path) as f:
        return [el.strip() for el in f.read().strip().split(" ") if el.strip()]


def _find_audio(base: str, rec_id: str):
    for ext in (".mp3", ".wav", ".npy"):
        cand = os.path.join(base, "audio", rec_id + ext)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"no audio for {rec_id} under {base}/audio")


def add_gaussian_snr(waveform: np.ndarray, snr_db: float, seed: int = 0) -> np.ndarray:
    """AddGaussianSNR equivalent (reference `eval/rev16_gaussian_noise/run.py:51-61`)."""
    rng = np.random.default_rng(seed)
    signal_rms = np.sqrt(np.mean(waveform ** 2) + 1e-12)
    noise_rms = signal_rms / (10 ** (snr_db / 20.0))
    return waveform + rng.normal(0.0, noise_rms, size=waveform.shape).astype(waveform.dtype)


def _load_16k(path: str, device) -> np.ndarray:
    """The left channel at 16 kHz (resampled on `device`), back on the host
    for the numpy noise functions."""
    waveform, sr = load_audio(path)
    return resample(grab_left_channel(waveform), sr, SR, device=device).cpu().numpy()


def _mel(waveform: np.ndarray, device) -> np.ndarray:
    return mel_spectrogram(waveform, device=device).cpu().numpy()


def _make_process_fn(audio_path: str, txt_path: str, snr_db=None, noise_seed: int = 0,
                     device=None):
    def process_fn(item):
        with open(txt_path) as f:
            gold = normalize(f.read().strip()).lower()
        waveform = _load_16k(audio_path, device)
        if snr_db is not None:
            waveform = add_gaussian_snr(waveform, snr_db, seed=noise_seed)
        return _mel(waveform, device), gold

    return process_fn


def _collect(base_path: str, snr_db=None, device=None):
    ids = _load_ids(os.path.join(base_path, "test.txt"))
    items = []
    for rec_id in ids:
        items.append(
            {
                "id": rec_id,
                "process_fn": _make_process_fn(
                    _find_audio(base_path, rec_id),
                    os.path.join(base_path, "transcripts", rec_id + ".txt"),
                    snr_db=snr_db,
                    device=device,
                ),
            }
        )
    return items


@register_dataset("rev16")
def get_text_and_audio(split: str, base_path: str = None, device=None, **kwargs):
    assert split == "test", "Split must be test"
    assert base_path, "rev16 requires base_path"
    return _collect(base_path, device=device)


@register_dataset("rev16_gaussian_noise")
def get_text_and_audio_noise(split: str, base_path: str = None, snr_db: float = 10.0,
                             device=None, **kwargs):
    assert split == "test", "Split must be test"
    assert base_path, "rev16 requires base_path"
    return _collect(base_path, snr_db=snr_db, device=device)


def add_background_noise(waveform: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    """Mix a background-noise waveform at a target SNR
    (reference eval/rev16_background_noise/)."""
    if noise.shape[-1] < waveform.shape[-1]:
        reps = -(-waveform.shape[-1] // noise.shape[-1])
        noise = np.tile(noise, reps)[..., : waveform.shape[-1]]
    else:
        noise = noise[..., : waveform.shape[-1]]
    sig_rms = np.sqrt(np.mean(waveform ** 2) + 1e-12)
    noise_rms = np.sqrt(np.mean(noise ** 2) + 1e-12)
    target = sig_rms / (10 ** (snr_db / 20.0))
    return waveform + noise * (target / noise_rms)


@register_dataset("rev16_background_noise")
def get_text_and_audio_bg(split: str, base_path: str = None, noise_path: str = None,
                          snr_db: float = 10.0, device=None, **kwargs):
    assert split == "test", "Split must be test"
    assert base_path and noise_path, "rev16_background_noise requires base_path + noise_path"
    noise = _load_16k(noise_path, device)
    ids = _load_ids(os.path.join(base_path, "test.txt"))
    items = []
    for rec_id in ids:
        audio_path = _find_audio(base_path, rec_id)
        txt_path = os.path.join(base_path, "transcripts", rec_id + ".txt")

        def process_fn(item, audio_path=audio_path, txt_path=txt_path):
            with open(txt_path) as f:
                gold = normalize(f.read().strip()).lower()
            waveform = add_background_noise(_load_16k(audio_path, device), noise, snr_db)
            return _mel(waveform, device), gold

        items.append({"id": rec_id, "process_fn": process_fn})
    return items
