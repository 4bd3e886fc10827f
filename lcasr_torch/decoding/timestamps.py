"""Word-level timestamps from per-token emission frames (the port's copy of
lcasr_tpu/decoding/timestamps.py).

Shared by the offline prefix beam search (`beam_search.decode_with_timestamps`,
the counterpart of the reference's pyctcdecode `decode_beams_lm` usage,
reference `lcasr/eval/utils.py:14-43`) and the online transcriber's `words`
view: token ids + the subsampled frame each was first emitted at → word
dicts {'word', 'start', 'end'} in seconds.  Word boundaries come from the
tokenizer's ▁ pieces; a word spans its first piece's emission frame through
its last piece's emission frame + 1.
"""
from __future__ import annotations

from typing import Dict, List, Sequence


def words_from_ids(
    tokenizer,
    ids: Sequence[int],
    frames: Sequence[int],
    ds_factor: float = 8.0,
    frames_per_second: float = 100.0,
) -> List[Dict]:
    pieces = [tokenizer.id_to_piece(i) for i in ids]
    words, cur, cur_frames = [], [], []
    for piece, f in zip(pieces, frames):
        if piece.startswith("▁") and cur:
            words.append(("".join(cur).replace("▁", " ").strip(), cur_frames))
            cur, cur_frames = [], []
        cur.append(piece)
        cur_frames.append(f)
    if cur:
        words.append(("".join(cur).replace("▁", " ").strip(), cur_frames))
    to_sec = lambda fr: fr * ds_factor / frames_per_second  # noqa: E731
    return [
        {"word": w, "start": to_sec(fs[0]), "end": to_sec(fs[-1] + 1)}
        for w, fs in words
        if w
    ]
