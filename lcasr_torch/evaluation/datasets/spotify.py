"""Spotify podcast (in-domain) adapter: precomputed spectrograms + word-
aligned transcript JSONs from the training pairs file — the reference's
in-domain eval + spotify_loss probe (reference `eval/spotify_loss/run.py`)."""
from __future__ import annotations

import json

import numpy as np

from lcasr_torch.data.dataloading import load_sample
from lcasr_torch.evaluation.datasets import register_dataset
from lcasr_torch.evaluation.normalizer import normalize


@register_dataset("spotify")
def get_text_and_audio(
    split: str, pairs_path: str = None, max_recordings: int = -1, **kwargs
):
    assert pairs_path, "spotify requires pairs_path (audio_txt_pairs.json)"
    with open(pairs_path) as f:
        pairs = json.load(f)
    keys = sorted(pairs.keys())
    if max_recordings > 0:
        keys = keys[:max_recordings]

    items = []
    for key in keys:
        def process_fn(item, entry=pairs[key]):
            audio, txt = load_sample(entry)
            words = txt["results"][-1]["alternatives"][0]["words"]
            text = " ".join(w["word"] for w in words)
            return np.asarray(audio, np.float32), normalize(text).lower()

        items.append({"id": key, "process_fn": process_fn})
    return items
