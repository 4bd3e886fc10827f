"""Dataset adapters (the port's copy of lcasr_tpu/evaluation/datasets).

Each adapter exposes `get_text_and_audio(split) -> [{id, process_fn, ...}]`
where `process_fn(item)` returns (spectrogram (1, 80, T), gold transcript) —
the contract of the reference's per-dataset `run.py` files (reference
`eval/<dataset>/run.py`, registry at `eval/run.py:20-27`).

Dataset paths come from a `paths.yaml` next to the eval config (reference
`eval/paths_template.yaml`).  Adapters that read audio files run the
frontend (`data/audio.processing_chain`) on `device` (None: the GPU) and
hand back numpy spectrograms; nothing is fetched.
"""
from __future__ import annotations

from typing import Callable, Dict

_ADAPTERS: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        _ADAPTERS[name] = fn
        return fn

    return deco


def _populate():
    from lcasr_torch.evaluation.datasets import (  # noqa: F401
        earnings22,
        rev16,
        spotify,
        synthetic,
        tedlium,
        tedlium_concat,
        this_american_life,
    )


def get_dataset_fn(name: str):
    _populate()
    if name not in _ADAPTERS:
        raise ValueError(f"unknown dataset {name!r}; available: {sorted(_ADAPTERS)}")
    return _ADAPTERS[name]


def available_datasets():
    _populate()
    return sorted(_ADAPTERS)
