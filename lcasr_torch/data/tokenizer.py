"""SentencePiece-model-compatible BPE tokenizer (no sentencepiece dependency);
the port's copy of lcasr_tpu/data/tokenizer.py, Python merge loop only,
reading the port's own copy of the model file (`lcasr_torch/artifacts`).

The reference loads `lcasr/artifacts/tokenizer.model` through the sentencepiece
C++ library (reference `lcasr/utils/audio_tools.py:167-194`): a BPE model with
vocab 4095, pad=0 / unk=1 / bos=2, `nmt_nfkc_cf` normalization.  The CTC models
add one blank class, giving 4096 output classes with blank = LAST id.

This module reads the very same binary artifact by parsing the protobuf wire
format directly (the relevant schema is tiny: ModelProto.pieces = repeated
{piece: string = 1, score: float = 2, type: enum = 3}), and implements the
standard BPE greedy best-merge encoder that sentencepiece's BPE mode uses:
repeatedly merge the adjacent symbol pair whose concatenation is the
highest-scoring piece in the vocab, ties broken by leftmost position.

Normalization is EXACT `nmt_nfkc_cf`: the artifact's NormalizerSpec embeds the
precompiled charsmap (a Darts double-array trie over utf-8 keys + a pool of
null-terminated replacements), and `PrecompiledCharsmap` implements the
longest-prefix-match rewrite sentencepiece applies, followed by the
remove_extra_whitespaces collapse.  `normalize_nmt_nfkc_cf` (NFKC + casefold +
whitespace) remains as the fallback for models whose spec carries no charsmap
(e.g. tokenizers trained by data/train_tokenizer.py).
"""
from __future__ import annotations

import heapq
import os
import struct
import unicodedata
from typing import Dict, List, Tuple

import numpy as np

_WS = "▁"  # sentencepiece meta symbol for space

# SentencePiece piece types
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6

DEFAULT_TOKENIZER_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "artifacts", "tokenizer.model"
)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for a protobuf message body."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        elif wire == 5:  # 32-bit
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_sentencepiece_model(path: str) -> List[Tuple[str, float, int]]:
    """Parse a sentencepiece .model file into [(piece, score, type), ...]."""
    with open(path, "rb") as f:
        blob = f.read()
    pieces: List[Tuple[str, float, int]] = []
    for field, wire, val in _parse_fields(blob):
        if field == 1 and wire == 2:  # ModelProto.pieces
            piece, score, ptype = "", 0.0, _NORMAL
            for f2, w2, v2 in _parse_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
    return pieces


def parse_normalizer_spec(path: str) -> Tuple[str, bytes]:
    """Return (name, precompiled_charsmap) from ModelProto.normalizer_spec
    (field 3: {name = 1, precompiled_charsmap = 2})."""
    with open(path, "rb") as f:
        blob = f.read()
    name, charsmap = "", b""
    for field, wire, val in _parse_fields(blob):
        if field == 3 and wire == 2:
            for f2, w2, v2 in _parse_fields(val):
                if f2 == 1 and w2 == 2:
                    name = v2.decode("utf-8")
                elif f2 == 2 and w2 == 2:
                    charsmap = v2
    return name, charsmap


class PrecompiledCharsmap:
    """Exact sentencepiece normalization from a precompiled charsmap blob.

    Layout: uint32 trie_size | Darts double-array units (uint32 each) |
    replacement pool (null-terminated utf-8 strings).  Rewrite = repeated
    longest-prefix match over the utf-8 bytes (unmatched valid characters
    copy through; invalid bytes become U+FFFD), exactly mirroring
    sentencepiece's Normalizer::NormalizePrefix.
    """

    def __init__(self, blob: bytes):
        import array

        (trie_bytes,) = struct.unpack("<I", blob[:4])
        units = array.array("I")
        units.frombytes(blob[4 : 4 + trie_bytes])
        self._units = units
        self._pool = blob[4 + trie_bytes :]

    # Darts double-array unit accessors (darts-clone encoding)
    @staticmethod
    def _offset(u: int) -> int:
        return (u >> 10) << ((u & (1 << 9)) >> 6)

    @staticmethod
    def _label(u: int) -> int:
        return u & ((1 << 31) | 0xFF)

    @staticmethod
    def _has_leaf(u: int) -> bool:
        return bool((u >> 8) & 1)

    def _longest_match(self, data: bytes, pos: int) -> Tuple[int, int]:
        """Longest trie match starting at data[pos] → (length, value) or
        (0, -1)."""
        units = self._units
        node = self._offset(units[0])
        best_len, best_val = 0, -1
        for i in range(pos, len(data)):
            c = data[i]
            nxt = node ^ c
            if nxt >= len(units):
                break
            unit = units[nxt]
            if self._label(unit) != c:
                break
            node = nxt ^ self._offset(unit)
            if self._has_leaf(unit):
                best_len = i - pos + 1
                best_val = units[node] & 0x7FFFFFFF
        return best_len, best_val

    def _replacement(self, value: int) -> bytes:
        end = self._pool.index(b"\x00", value)
        return self._pool[value:end]

    def normalize(self, text: str) -> str:
        data = text.encode("utf-8")
        out: List[bytes] = []
        i, n = 0, len(data)
        while i < n:
            length, value = self._longest_match(data, i)
            if length > 0:
                out.append(self._replacement(value))
                i += length
                continue
            # no rule: copy one utf-8 character (input comes from a Python
            # str, so the bytes are always valid utf-8 and codepoint-aligned)
            b0 = data[i]
            clen = 1 if b0 < 0x80 else 2 if b0 >> 5 == 0b110 else 3 if b0 >> 4 == 0b1110 else 4
            out.append(data[i : i + clen])
            i += clen
        text = b"".join(out).decode("utf-8")
        # NormalizerSpec.remove_extra_whitespaces collapses ASCII SPACE runs
        # only — str.split() would also eat e.g. U+0085, which the charsmap
        # deliberately passes through (sentencepiece encodes it as unk)
        while "  " in text:
            text = text.replace("  ", " ")
        return text.strip(" ")


def normalize_nmt_nfkc_cf(text: str) -> str:
    """NFKC + casefold + whitespace normalization (approximates nmt_nfkc_cf)."""
    text = unicodedata.normalize("NFKC", text)
    text = text.casefold()
    # nmt: map control chars / non-breaking spaces to plain space
    text = "".join(
        " " if (unicodedata.category(c) in ("Zs", "Cc", "Cf") or c in "\t\n\r") else c
        for c in text
    )
    return " ".join(text.split())


class SentencePieceBPE:
    """Drop-in replacement for spm.SentencePieceProcessor on BPE models.

    `use_native=True` runs the merge loop in the port's C++ library
    (`lcasr_torch/native/bpe.cpp`, built and loaded at the first encode; a
    failed build raises); `use_native=False` runs the plain Python loop.
    Both give the same ids on every input."""

    def __init__(self, model_path: str = DEFAULT_TOKENIZER_PATH, use_native: bool = True):
        self.pieces = parse_sentencepiece_model(model_path)
        # exact normalization when the model ships a precompiled charsmap
        self._charsmap = None
        try:
            _, blob = parse_normalizer_spec(model_path)
            if blob:
                self._charsmap = PrecompiledCharsmap(blob)
        except Exception as e:
            # the approximate fallback produces DIFFERENT ids for some
            # inputs (e.g. 'Straße'); never downgrade silently
            import warnings

            warnings.warn(
                f"failed to load the model's precompiled charsmap ({e!r}); "
                f"falling back to APPROXIMATE nmt_nfkc_cf normalization",
                stacklevel=2,
            )
            self._charsmap = None
        self.piece_to_id: Dict[str, int] = {p: i for i, (p, _, _) in enumerate(self.pieces)}
        # matchable surface: sentencepiece never matches CONTROL/UNUSED
        # pieces from raw text (their ids are only emitted explicitly)
        self._match_to_id: Dict[str, int] = {
            p: i for i, (p, _, t) in enumerate(self.pieces)
            if t not in (_CONTROL, _UNUSED)
        }
        self.scores = [s for (_, s, _) in self.pieces]
        self.types = [t for (_, _, t) in self.pieces]
        self._unk_id = next(
            (i for i, t in enumerate(self.types) if t == _UNKNOWN), 1
        )
        self._control = {i for i, t in enumerate(self.types) if t == _CONTROL}
        self.use_native = use_native
        self._native = None

    def _native_init(self):
        """The C++ tokenizer over these pieces: CONTROL / UNUSED pieces are
        not matchable from text (`_match_to_id`); every piece serves the
        per-character fallback (`piece_to_id`)."""
        import ctypes

        from lcasr_torch import native

        lib = native.library("bpe")
        surfaces = [p.encode("utf-8") for p, _, _ in self.pieces]
        offsets = np.zeros(len(surfaces) + 1, np.int64)
        offsets[1:] = np.cumsum([len(b) for b in surfaces])
        scores = np.asarray(self.scores, np.float64)
        matchable = np.asarray([t not in (_CONTROL, _UNUSED) for t in self.types], np.uint8)
        handle = lib.bpe_init(b"".join(surfaces), offsets.ctypes.data, len(surfaces),
                              scores.ctypes.data, matchable.ctypes.data, self._unk_id)
        self._native_free = (lib.bpe_free, handle)
        return lib, ctypes.c_void_p(handle)

    def __del__(self):
        free = getattr(self, "_native_free", None)
        if free is not None:
            free[0](free[1])

    # -- spm API surface -----------------------------------------------------
    def vocab_size(self) -> int:
        return len(self.pieces)

    def get_piece_size(self) -> int:
        return len(self.pieces)

    def pad_id(self) -> int:
        return 0

    def unk_id(self) -> int:
        return self._unk_id

    def bos_id(self) -> int:
        return 2

    def eos_id(self) -> int:
        return -1

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx][0]

    # -- encode ---------------------------------------------------------------
    def _encode_word_or_text(self, symbols: List[str]) -> List[int]:
        """Greedy BPE merge over a symbol list using piece scores.

        Uses a heap of candidate merges keyed by (-score, left_position) —
        equivalent to sentencepiece's agenda ordering for BPE.
        """
        n = len(symbols)
        if n == 0:
            return []
        # doubly linked list over active symbols
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(0, n - 1))
        alive = [True] * n
        sym = list(symbols)

        heap: List[Tuple[float, int, int, str]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if i < 0 or j < 0:
                return
            merged = sym[i] + sym[j]
            pid = self._match_to_id.get(merged)
            if pid is not None:
                heapq.heappush(heap, (-self.scores[pid], i, j, merged))

        for i in range(n - 1):
            push(i)

        while heap:
            _, i, j, merged = heapq.heappop(heap)
            if not (alive[i] and alive[j]) or nxt[i] != j or sym[i] + sym[j] != merged:
                continue  # stale entry
            sym[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            push(prv[i] if prv[i] >= 0 and alive[prv[i]] else -1)
            push(i)

        out: List[int] = []
        i = 0
        while i != -1:
            if alive[i]:
                pid = self._match_to_id.get(sym[i])
                if pid is not None:
                    out.append(pid)
                else:  # unknown: emit per-char ids / unk
                    for ch in sym[i]:
                        out.append(self.piece_to_id.get(ch, self._unk_id))
            i = nxt[i]
        return out

    def normalize(self, text: str) -> str:
        if self._charsmap is not None:
            return self._charsmap.normalize(text)
        return normalize_nmt_nfkc_cf(text)

    def _prepared(self, text: str) -> str:
        """Normalised text with sentencepiece's dummy prefix and escaped
        whitespace ("" for a text that normalises to nothing)."""
        text = self.normalize(text)
        return _WS + text.replace(" ", _WS) if text else ""

    def encode(self, text: str, out_type: type = int) -> List:
        ids = self.encode_batch([text])[0]
        if out_type is str:
            return [self.pieces[i][0] for i in ids]
        return ids

    def encode_as_ids(self, text: str) -> List[int]:
        return self.encode(text)

    def encode_batch(self, texts: List[str]) -> List[List[int]]:
        """The ids of each text; through the native loop, one call for the
        whole batch."""
        prepared = [self._prepared(t) for t in texts]
        if not self.use_native:
            return [self._encode_word_or_text(list(t)) for t in prepared]
        if self._native is None:
            self._native = self._native_init()
        lib, handle = self._native
        data = [t.encode("utf-8") for t in prepared]
        offsets = np.zeros(len(data) + 1, np.int64)
        offsets[1:] = np.cumsum([len(b) for b in data])
        out = np.empty(max(1, int(offsets[-1])), np.int32)  # ids <= code points <= bytes
        counts = np.empty(len(data), np.int64)
        total = lib.bpe_encode_batch(handle, b"".join(data), offsets.ctypes.data, len(data),
                                     out.ctypes.data, out.size, counts.ctypes.data)
        if total > out.size:
            raise RuntimeError(f"bpe_encode_batch needs {total} ids, more than {out.size}")
        bounds = np.concatenate([[0], np.cumsum(counts)])
        ids = out.tolist()
        return [ids[bounds[i]:bounds[i + 1]] for i in range(len(data))]

    # -- decode ---------------------------------------------------------------
    def decode(self, ids) -> str:
        if len(ids) > 0 and isinstance(ids[0], (list, tuple)):
            return [self.decode(x) for x in ids]
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if i in self._control:
                continue
            if i == self._unk_id:
                parts.append(" ⁇ ")
                continue
            parts.append(self.pieces[i][0])
        return "".join(parts).replace(_WS, " ").strip()


def load_tokenizer(tokenizer_path: str = DEFAULT_TOKENIZER_PATH,
                   use_native: bool = True) -> SentencePieceBPE:
    """Mirror of reference `lcasr/utils/audio_tools.py:191-194`."""
    return SentencePieceBPE(tokenizer_path, use_native=use_native)
