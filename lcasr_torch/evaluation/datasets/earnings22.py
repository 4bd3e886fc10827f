"""Earnings-22 adapter (reference `eval/earnings22/run.py:28-79`):
mp3 recordings + a full_transcripts.json keyed by meeting id; transcripts get
tag stripping (<silence>/<inaudible>/... ) + punctuation normalization before
Whisper text normalization."""
from __future__ import annotations

import json
import os
import re

from lcasr_torch.data.audio import processing_chain
from lcasr_torch.evaluation.datasets import register_dataset
from lcasr_torch.evaluation.normalizer import normalize

_TAGS = (
    "<silence>", "<inaudible>", "<laugh>", "<noise>", "<affirmative>", "<crosstalk>"
)


def preprocess_transcript(text: str) -> str:
    text = text.lower()
    for tag in _TAGS:
        text = text.replace(tag, "")
    text = text.replace("…", "")
    text = text.replace(",", "")
    text = text.replace("-", " ")
    text = text.replace(".", "")
    text = text.replace("?", "")
    text = re.sub(" +", " ", text)
    return normalize(text).lower()


@register_dataset("earnings22")
def get_text_and_audio(split: str, base_path: str = None, text_path: str = None,
                       full: bool = False, device=None, **kwargs):
    assert split in ("test", "dev"), f"Split must be test or dev (got {split})"
    assert base_path, "earnings22 requires base_path"
    suffix = "_full" if full else "_original"
    data_path = os.path.join(base_path, f"{split}{suffix}")
    if not os.path.isdir(data_path):
        # never fall back from _full to _original: results labeled
        # earnings22_full computed on trimmed recordings would silently
        # fake the long-context numbers
        raise FileNotFoundError(
            f"earnings22 split directory not found: {data_path}"
        )
    text_path = text_path or os.path.join(base_path, "full_transcripts.json")
    with open(text_path) as f:
        all_text = json.load(f)

    items = []
    for el in sorted(os.listdir(data_path)):
        stem, ext = os.path.splitext(el)
        if ext not in (".mp3", ".wav", ".npy"):
            continue

        def process_fn(item, path=os.path.join(data_path, el), meeting=stem):
            spec = processing_chain(path, device=device).cpu().numpy()
            return spec, preprocess_transcript(all_text[meeting])

        items.append({"id": stem, "process_fn": process_fn})
    return items


@register_dataset("earnings22_full")
def get_text_and_audio_full(split: str, **kwargs):
    """Full-length (untrimmed) earnings22 recordings
    (reference eval/earnings22_full/)."""
    kwargs.pop("full", None)
    return get_text_and_audio(split, full=True, **kwargs)
