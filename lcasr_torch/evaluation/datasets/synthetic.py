"""Synthetic dataset for pipeline tests and benchmarks: random spectrograms
with known gold text.  Not part of the reference — exists so the eval stack
is exercisable without the (licensed) corpora on disk."""
from __future__ import annotations

import numpy as np

from lcasr_torch.evaluation.datasets import register_dataset


@register_dataset("synthetic")
def get_text_and_audio(
    split: str,
    n_recordings: int = 2,
    n_frames: int = 2048,
    seed: int = 0,
    **kwargs,
):
    items = []
    for i in range(n_recordings):
        def process_fn(item, i=i):
            rng = np.random.default_rng(seed + i)
            spec = rng.normal(size=(1, 80, n_frames)).astype(np.float32)
            return spec, "this is a synthetic gold transcript"

        items.append({"id": f"synthetic_{i}", "process_fn": process_fn})
    return items
