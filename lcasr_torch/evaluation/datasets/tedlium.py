"""Tedlium long-form adapter: STM transcript parsing + ignore-segment zeroing.

Counterpart of reference `eval/tedlium/run.py:23-90`:
  * one recording per talk (sph/wav audio + .stm transcript),
  * STM lines provide (start, end, text); `ignore_time_segment_in_scoring`
    regions are excluded from the gold text AND zeroed out of the
    spectrogram (reference `zero_out_spectogram`, `lcasr/eval/utils.py:7-12`),
  * `<unk>` tokens stripped from gold.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from lcasr_torch.data.audio import processing_chain, total_frames
from lcasr_torch.evaluation.datasets import register_dataset


def parse_stm(stm_path: str) -> Tuple[str, List[Dict[str, float]]]:
    """Parse an STM file → (gold_text, remove_timings).

    Lines: <file> <channel> <speaker> <start> <end> [<label>] transcript...
    Segments labelled ignore_time_segment_in_scoring are collected as
    removal spans instead of text.
    """
    text_parts: List[str] = []
    remove: List[Dict[str, float]] = []
    with open(stm_path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 6:
                continue
            start, end = float(parts[3]), float(parts[4])
            # optional label field like <o,f0,female>
            idx = 5
            if parts[idx].startswith("<"):
                idx += 1
            words = [w for w in parts[idx:] if w != "<unk>"]
            segment_text = " ".join(words)
            if "ignore_time_segment_in_scoring" in line:
                remove.append({"start": start, "end": end})
            elif segment_text:
                text_parts.append(segment_text)
    return " ".join(text_parts), remove


def zero_out_spectogram(spec, remove_timings: List[Dict[str, float]], buffer: float = -0.5):
    """Zero ignored time regions out of the spectrogram
    (reference `lcasr/eval/utils.py:7-12`)."""
    spec = np.asarray(spec).copy()
    for timing in remove_timings:
        start = timing["start"] - buffer
        end = timing["end"] + buffer
        s_f, e_f = total_frames(start), total_frames(end)
        spec[:, :, max(0, s_f):max(0, e_f)] = 0
    return spec


@register_dataset("tedlium")
def get_text_and_audio(split: str, base_path: str = None, device=None, **kwargs):
    assert base_path, "tedlium requires base_path (TEDLIUM_release-3 legacy dir)"
    split_dir = os.path.join(base_path, "legacy", split)
    audio_dir = os.path.join(split_dir, "sph")
    stm_dir = os.path.join(split_dir, "stm")
    items = []
    for stm in sorted(os.listdir(stm_dir)):
        if not stm.endswith(".stm"):
            continue
        rec = stm[: -len(".stm")]
        audio_path = None
        for ext in (".wav", ".sph", ".npy"):
            cand = os.path.join(audio_dir, rec + ext)
            if os.path.exists(cand):
                audio_path = cand
                break
        if audio_path is None:
            continue

        def process_fn(item, audio_path=audio_path, stm_path=os.path.join(stm_dir, stm)):
            gold, remove = parse_stm(stm_path)
            spec = processing_chain(audio_path, device=device).cpu().numpy()
            spec = zero_out_spectogram(spec, remove)
            return spec, gold

        items.append({"id": rec, "process_fn": process_fn})
    return items
