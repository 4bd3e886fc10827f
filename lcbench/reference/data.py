"""The training feed, worked out again from the raw corpus: the chunks of a
batch of podcasts and their labels.

A batch's podcasts are cut into windows of `chunk` frames; chunk c of a
podcast holds frames [c chunk, (c + 1) chunk) and the words that lie wholly
inside that span of seconds (100 frames a second), joined by spaces and
encoded by the tokenizer; a chunk in which no podcast has a word is
skipped.  The tokenizer reads the sentencepiece model file (a raw file that
the program reads too) and encodes each word as sentencepiece's BPE does:
"▁" + the word, its symbols merged pair by pair, the best-scoring piece
first and the leftmost on a tie.  It takes lowercase ASCII words only, for
which the model's normalisation changes nothing, and refuses other text.
"""
from __future__ import annotations

import json
import re
import struct
from typing import Dict, List

import numpy as np

_WS = "▁"
_CONTROL, _UNUSED, _UNKNOWN = 3, 5, 2
_PLAIN = re.compile(r"^[a-z]+( [a-z]+)*$")


def _varint(buf: bytes, pos: int):
    out, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire}")
        yield field, wire, val


class Tokenizer:
    def __init__(self, model_path: str):
        with open(model_path, "rb") as f:
            blob = f.read()
        pieces = []
        for field, wire, val in _fields(blob):
            if field == 1 and wire == 2:  # ModelProto.pieces: {piece 1, score 2, type 3}
                piece, score, kind = "", 0.0, 1
                for f2, w2, v2 in _fields(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        kind = v2
                pieces.append((piece, score, kind))
        self.size = len(pieces)
        self.match = {p: (i, s) for i, (p, s, k) in enumerate(pieces)
                      if k not in (_CONTROL, _UNUSED)}
        self.unk = next((i for i, (_, _, k) in enumerate(pieces) if k == _UNKNOWN), 1)
        if any(_WS in p[1:] for p in self.match):
            raise ValueError("a piece spans words: per-word encoding would differ")

    def _word(self, word: str) -> List[int]:
        sym = list(_WS + word)
        while len(sym) > 1:
            best = None
            for i in range(len(sym) - 1):
                hit = self.match.get(sym[i] + sym[i + 1])
                if hit is not None and (best is None or hit[1] > best[1]):
                    best = (i, hit[1])
            if best is None:
                break
            i = best[0]
            sym[i:i + 2] = [sym[i] + sym[i + 1]]
        return [self.match[s][0] if s in self.match else self.unk for s in sym]

    def encode(self, text: str) -> List[int]:
        if not text:
            return []
        if not _PLAIN.match(text):
            raise ValueError(f"the reference tokenizer takes lowercase ASCII words: {text!r}")
        return [i for w in text.split(" ") for i in self._word(w)]


def _words(path: str) -> List[tuple]:
    with open(path) as f:
        words = json.load(f)["results"][-1]["alternatives"][0]["words"]
    return [(float(w["startTime"][:-1]), float(w["endTime"][:-1]), w["word"]) for w in words]


def batch_chunks(pairs: Dict[str, dict], ids: List[str], chunk: int, tokenizer: Tokenizer,
                 frames_per_second: int = 100, pad_id: int = 0) -> List[dict]:
    """The chunks of one batch (podcasts `ids`, in that order), as the
    training step takes them: audio (B, 80, chunk) fp32, audio_lengths,
    labels (B, U) padded with `pad_id`, label_lengths and weight."""
    specs = [np.load(pairs[i]["audio"]).astype(np.float32)[0] for i in ids]
    words = [_words(pairs[i]["txt"]) for i in ids]
    T = max(s.shape[-1] for s in specs)
    out = []
    for start in range(0, T, chunk):
        lo, hi = start / frames_per_second, (start + chunk) / frames_per_second
        enc = [tokenizer.encode(" ".join(w for s, e, w in ws if s >= lo and e <= hi))
               for ws in words]
        if max(len(e) for e in enc) == 0:
            continue
        audio = np.zeros((len(ids), specs[0].shape[0], chunk), np.float32)
        lengths = np.zeros(len(ids), np.int32)
        for b, s in enumerate(specs):
            part = s[:, start:start + chunk]
            audio[b, :, :part.shape[-1]] = part
            lengths[b] = part.shape[-1]
        labels = np.full((len(ids), max(len(e) for e in enc)), pad_id, np.int64)
        for b, e in enumerate(enc):
            labels[b, :len(e)] = e
        out.append({"audio": audio, "audio_lengths": lengths, "labels": labels,
                    "label_lengths": np.array([len(e) for e in enc], np.int32),
                    "weight": (lengths > 0).astype(np.float32)})
    return out


def same_feed(program_chunk: dict, reference_chunk: dict) -> bool:
    """The program's chunk carries the reference's audio, lengths, labels
    (up to each row's length) and weights."""
    p, r = program_chunk, reference_chunk
    if not (np.array_equal(p["audio"], r["audio"])
            and np.array_equal(p["audio_lengths"], r["audio_lengths"])
            and np.array_equal(p["label_lengths"], r["label_lengths"])
            and np.array_equal(p["weight"], r["weight"])):
        return False
    return all(np.array_equal(p["labels"][b, :n], r["labels"][b, :n])
               for b, n in enumerate(r["label_lengths"]))
