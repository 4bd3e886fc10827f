"""This American Life adapter (reference `eval/this_american_life/run.py:31-72`):
aligned-transcript JSON keyed by episode (utterance list with speakers),
audio as <episode-number>.mp3 under an audio dir."""
from __future__ import annotations

import json
import os

from lcasr_torch.data.audio import processing_chain
from lcasr_torch.evaluation.datasets import register_dataset
from lcasr_torch.evaluation.normalizer import normalize

_SPLIT_FILES = {
    "train": "train-transcripts-aligned.json",
    "dev": "valid-transcripts-aligned.json",
    "test": "test-transcripts-aligned.json",
}


@register_dataset("this_american_life")
def get_text_and_audio(split: str, base_path: str = None, device=None, **kwargs):
    assert base_path, "this_american_life requires base_path"
    if split == "all":
        out = []
        for s in ("train", "dev", "test"):
            out += get_text_and_audio(s, base_path=base_path, device=device, **kwargs)
        return out
    assert split in _SPLIT_FILES, f"Invalid split: {split}"
    with open(os.path.join(base_path, _SPLIT_FILES[split])) as f:
        txt_json = json.load(f)

    items = []
    for episode, utterances in txt_json.items():
        text = " ".join(u["utterance"] for u in utterances)
        speakers = len({u["speaker"] for u in utterances})
        audio = os.path.join(base_path, "audio", episode.split("-")[-1] + ".mp3")
        for ext in (".wav", ".npy"):
            cand = audio.replace(".mp3", ext)
            if os.path.exists(cand):
                audio = cand
                break

        def process_fn(item, audio=audio, text=text):
            return (processing_chain(audio, device=device).cpu().numpy(),
                    normalize(text).lower())

        items.append(
            {"id": episode, "process_fn": process_fn, "speakers": speakers}
        )
    return items
