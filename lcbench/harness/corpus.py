"""A seeded training corpus in the format the port's loader reads: one
`.npy` log-mel spectrogram (1, 80, T) per podcast, in fp16 as the port's
preprocessing writes them, and a word-aligned transcript JSON with a word
every 0.3 s over the whole recording (copied from the repository's chip
smoke script, `make_corpus`).  The spectrograms are drawn on the card from
the seed in one call each and copied to the host.
"""
from __future__ import annotations

import json
import os

WORDS = ("the podcast has these words about music and long context speech "
         "recognition models trained on hours of audio every week").split()


def make(directory: str, n: int, frames: int, seed: int, device, n_mels: int = 80,
         frames_per_second: int = 100) -> dict:
    """{id: {'audio', 'txt', 'duration'}} of `n` podcasts of `frames` frames."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed((seed * 104729 + 3) % (2 ** 63))
    pairs = {}
    for i in range(n):
        spec = torch.randn((1, n_mels, frames), generator=gen, device=device)
        np.save(os.path.join(directory, f"r{i}.spec.npy"), spec.half().cpu().numpy())
        words, t = [], 0.15
        while t + 0.25 <= frames / frames_per_second - 0.7:
            words.append({"word": WORDS[int(rng.integers(len(WORDS)))],
                          "startTime": f"{t:.2f}s", "endTime": f"{t + 0.25:.2f}s"})
            t += 0.3
        with open(os.path.join(directory, f"r{i}.json"), "w") as f:
            json.dump({"results": [{"alternatives": [{"words": words}]}]}, f)
        pairs[f"r{i}"] = {"audio": os.path.join(directory, f"r{i}.spec.npy"),
                          "txt": os.path.join(directory, f"r{i}.json"),
                          "duration": frames / frames_per_second}
    return pairs
