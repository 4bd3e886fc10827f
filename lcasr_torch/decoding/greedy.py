"""Greedy CTC decoding: argmax -> collapse repeats -> drop blank ->
detokenize (a copy of lcasr_tpu/decoding/greedy.py; blank = last id in the
lcasr convention, passed explicitly)."""
from __future__ import annotations

from typing import List, Union

import numpy as np


class GreedyCTCDecoder:
    def __init__(self, tokenizer=None, blank_id: int = 0):
        self.tokenizer = tokenizer
        self.blank = blank_id

    def __call__(self, emission, decode: bool = True) -> Union[str, List[int]]:
        """emission: (T, C) logits or log-probs, or (T,) per-frame ids that
        are already argmaxed (`StreamingDecoder.greedy`) -> transcript (or
        raw ids)."""
        emission = np.asarray(emission)
        indices = emission if emission.ndim == 1 else emission.argmax(-1)
        keep = np.ones_like(indices, dtype=bool)
        keep[1:] = indices[1:] != indices[:-1]
        ids = [int(i) for i in indices[keep] if i != self.blank]
        if decode and self.tokenizer is not None:
            return self.tokenizer.decode(ids)
        return ids
