"""BPE tokenizer training -> a SentencePiece `.model` (counterpart of
lcasr_tpu/data/train_tokenizer.py, pure Python; the same pieces and the same
bytes).

`learn_bpe` learns merges over the nmt_nfkc_cf-normalised, "▁"-prefixed
words: each merge is the most frequent adjacent pair (ties to the pair met
first), pieces [PAD] / [UNK] / [BOS] = 0 / 1 / 2, merged pieces scored -rank
and single characters below every merge.  `write_sentencepiece_model` writes
the pieces in the ModelProto wire format, which `data.tokenizer` (native and
Python) and sentencepiece load.
"""
from __future__ import annotations

import json
import struct
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

from lcasr_torch.data.tokenizer import _WS, normalize_nmt_nfkc_cf

_NORMAL, _UNKNOWN, _CONTROL = 1, 2, 3


def _encode_varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _field(num: int, wire: int) -> bytes:
    return _encode_varint((num << 3) | wire)


def _piece_msg(piece: str, score: float, ptype: int) -> bytes:
    body = (
        _field(1, 2) + _encode_varint(len(piece.encode())) + piece.encode()
        + _field(2, 5) + struct.pack("<f", score)
        + _field(3, 0) + _encode_varint(ptype)
    )
    return _field(1, 2) + _encode_varint(len(body)) + body


def learn_bpe(
    texts: Iterable[str],
    vocab_size: int = 4095,
    max_word_count: int = 5_000_000,
) -> List[Tuple[str, float, int]]:
    """The piece table [(piece, score, type), ...] of at most vocab_size."""
    word_freq: Counter = Counter()
    for text in texts:
        for w in normalize_nmt_nfkc_cf(text).split(" "):
            if w:
                word_freq[_WS + w] += 1
        if len(word_freq) > max_word_count:
            break

    char_freq: Counter = Counter()
    for w, f in word_freq.items():
        for ch in w:
            char_freq[ch] += f

    specials = [("[PAD]", 0.0, _CONTROL), ("[UNK]", 0.0, _UNKNOWN), ("[BOS]", 0.0, _CONTROL)]
    n_merges = vocab_size - len(specials) - len(char_freq)
    if n_merges < 0:
        raise ValueError(f"vocab_size {vocab_size} too small for {len(char_freq)} chars")

    words: Dict[Tuple[str, ...], int] = {tuple(w): f for w, f in word_freq.items()}
    merges: List[str] = []
    for _ in range(n_merges):
        pair_freq: Counter = Counter()
        for sym, f in words.items():
            for a, b in zip(sym, sym[1:]):
                pair_freq[(a, b)] += f
        if not pair_freq:
            break
        (a, b), f = pair_freq.most_common(1)[0]
        if f < 2:
            break
        merged = a + b
        merges.append(merged)
        new_words: Dict[Tuple[str, ...], int] = {}
        for sym, fq in words.items():
            out, i = [], 0
            while i < len(sym):
                if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + fq
        words = new_words

    pieces: List[Tuple[str, float, int]] = list(specials)
    for rank, m in enumerate(merges):
        pieces.append((m, float(-rank), _NORMAL))
    base = -len(merges)  # single characters below all merges (merges win ties)
    for i, (ch, _) in enumerate(char_freq.most_common()):
        pieces.append((ch, float(base - i - 1), _NORMAL))
    return pieces[:vocab_size]


def write_sentencepiece_model(pieces: List[Tuple[str, float, int]], path: str) -> None:
    with open(path, "wb") as f:
        for piece, score, ptype in pieces:
            f.write(_piece_msg(piece, score, ptype))


def train_tokenizer(texts: Iterable[str], save_path: str, vocab_size: int = 4095) -> str:
    """Learn and save; returns the `.model` path (`data.tokenizer.load_tokenizer`
    loads it)."""
    write_sentencepiece_model(learn_bpe(texts, vocab_size=vocab_size), save_path)
    return save_path


def retrieve_all_text(pairs: Dict[str, Dict[str, str]],
                      save_path: Optional[str] = None) -> List[str]:
    """The transcript of each pair, its words joined by spaces (the last
    result's first alternative, as the word-aligned JSONs hold them)."""
    out: List[str] = []
    for entry in pairs.values():
        with open(entry["txt"]) as f:
            j = json.load(f)
        words = j["results"][-1]["alternatives"][0]["words"]
        out.append(" ".join(w["word"] for w in words))
    if save_path:
        with open(save_path, "w") as f:
            f.write("\n".join(out) + "\n")
    return out
