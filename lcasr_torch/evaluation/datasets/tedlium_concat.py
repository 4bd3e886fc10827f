"""Tedlium-concat adapter: ALL talks concatenated into one spectrogram
(reference `eval/tedlium_concat/run.py:130-160`) — the stress test for
whole-corpus single-recording decode (hours of context)."""
from __future__ import annotations

import numpy as np

from lcasr_torch.evaluation.datasets import register_dataset
from lcasr_torch.evaluation.datasets.tedlium import get_text_and_audio as tedlium_items
from lcasr_torch.evaluation.normalizer import normalize


@register_dataset("tedlium_concat")
def get_text_and_audio(split: str, base_path: str = None, **kwargs):
    items = tedlium_items(split, base_path=base_path, **kwargs)

    def process_fn(item):
        specs, texts = [], []
        for it in items:
            spec, gold = it["process_fn"](it)
            specs.append(np.asarray(spec))
            texts.append(normalize(gold).lower())
        return np.concatenate(specs, axis=-1), " ".join(texts)

    return [{"id": f"tedlium_concat_{split}", "process_fn": process_fn}]
