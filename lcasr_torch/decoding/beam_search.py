"""CTC beam search with optional language-model fusion (the port's copy of
lcasr_tpu/decoding/beam_search.py).

Counterpart of reference `lcasr/decoding/ctc_beam_search.py:18-322` (and the
pyctcdecode usage in `lcasr/eval/utils.py:14-43`): frame-synchronous prefix
beam search over CTC posteriors, score = AM + alpha LM + beta |tokens|, with
  * top-AM candidate pruning per frame (`logit > max + threshold`,
    reference `:224-228`),
  * merging of prefixes (logsumexp over blank / non-blank AM mass),
  * batched LM scoring: all beams needing LM probabilities are evaluated in
    one call per frame (reference `:287-317`).

The LM is any callable `lm_scores(prefixes: List[List[int]]) -> np.ndarray
(n_prefixes, vocab)` of next-token log-probs; `TorchLMScorer` adapts a
causal LM on the device (`models.lm.make_lm_scorer`).  With
`lm_scores=None` this is plain CTC prefix beam search, and a float32 block
advances in C++ (`native/beam.cpp`, the same arithmetic in the same order).

The host arithmetic is the JAX module's own: float64 Python floats, the
same merge order (dict insertion), the same stable ranking; results are
equal to it, not only close.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

LOG0 = -1e30
# reference default (`ctc_beam_search.py` top_am_threshold); shared with the
# serving layer's device-side above-threshold count
DEFAULT_TOP_AM_THRESHOLD = -6.0


def _logsumexp(a: float, b: float) -> float:
    if a <= LOG0 / 2:
        return b
    if b <= LOG0 / 2:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


@dataclass
class Beam:
    prefix: Tuple[int, ...] = ()
    p_blank: float = 0.0  # log prob of prefix ending in blank
    p_non_blank: float = LOG0  # log prob of prefix ending in its last token
    lm_score: float = 0.0  # cumulative alpha LM + beta len bonus
    frames: Tuple[int, ...] = ()  # first-emission frame per token (timestamps)
    best_contrib: float = LOG0  # strongest merged-in path mass (for frames)

    @property
    def am_score(self) -> float:
        return _logsumexp(self.p_blank, self.p_non_blank)

    @property
    def score(self) -> float:
        return self.am_score + self.lm_score


class BeamSearch:
    def __init__(
        self,
        tokenizer=None,
        beam_width: int = 25,
        blank_id: Optional[int] = None,
        alpha: float = 0.45,
        beta: float = 1.53,
        # beam-score prune margin (reference prune_less_than_val, a positive
        # value like 8.0: beams below best - val are dropped); None = off
        prune_less_than_val: Optional[float] = None,
        top_am_threshold: float = DEFAULT_TOP_AM_THRESHOLD,
        lm_scores: Optional[Callable[[List[List[int]]], np.ndarray]] = None,
        # > 0: truncate the LM context to the last n tokens (reference
        # trim_cache semantics, within one token for a stateless scorer)
        max_cache_length: int = -1,
        # lcasr convention: id 0 is pad/unk and never proposed (reference
        # :224, frame_sync :252).  None = every id is a candidate.
        pad_id: Optional[int] = None,
    ):
        self.tokenizer = tokenizer
        self.beam_width = beam_width
        self.blank_id = blank_id
        self.alpha = alpha
        self.beta = beta
        self.top_am_threshold = top_am_threshold
        self.lm_scores = lm_scores
        self.prune_less_than_val = prune_less_than_val
        self.max_cache_length = max_cache_length
        self.pad_id = pad_id
        # True: no-LM float32 blocks take the Python loop too (the parity
        # oracle of the native advance)
        self.force_python = False
        self.reset()

    def reset(self) -> None:
        """Clear the search state; advance() continues from a fresh empty
        beam (run_search = reset + advance + best; advance() alone serves
        streaming callers, which feed finalised logit blocks as they come)."""
        self._beams: Dict[Tuple[int, ...], Beam] = {(): Beam()}
        # per-prefix LM memo: a prefix's next-token distribution does not
        # depend on the frame, so only newly created prefixes need a forward
        # (pruned each frame to the live beam set)
        self._lm_memo: Dict[Tuple[int, ...], np.ndarray] = {}

    def run_search(self, log_probs: np.ndarray, decode: bool = True):
        """log_probs: (T, C) CTC log posteriors -> best transcript (or ids)."""
        self.reset()
        self.advance(log_probs)
        best = self.best()
        ids = list(best.prefix)
        if decode and self.tokenizer is not None:
            return self.tokenizer.decode(ids)
        return ids

    def best(self) -> Beam:
        """Highest-scoring live beam (also kept as self._best)."""
        best = max(self._beams.values(), key=lambda b: b.score)
        self._best = best
        return best

    def live_prefixes(self) -> List[Tuple[int, ...]]:
        """Live beam prefixes, best first (for streaming common-prefix
        emission)."""
        ranked = sorted(self._beams.values(), key=lambda b: -b.score)
        return [b.prefix for b in ranked]

    def advance(self, log_probs: np.ndarray, t0: int = 0) -> None:
        """Advance the search over a block of frames.  `t0` is the global
        index of the block's first frame, so timestamps stay global across
        streamed blocks.

        A no-LM search over a float32 block advances in C++
        (`native.beam_advance`, the same semantics); it raises if the library
        does not build.  The loop below is the parity oracle and the
        LM-fused path; a float64 block takes it too, because the candidate
        threshold compares in the input's dtype."""
        T, C = log_probs.shape
        blank = self.blank_id if self.blank_id is not None else C - 1
        if (self.lm_scores is None and T > 0 and log_probs.dtype == np.float32
                and not self.force_python):
            from lcasr_torch.native import beam_advance

            res = beam_advance(
                [(b.prefix, b.p_blank, b.p_non_blank, b.frames) for b in self._beams.values()],
                log_probs, t0, blank,
                -1 if (self.pad_id is None or self.pad_id == blank) else self.pad_id,
                float(self.top_am_threshold), self.beam_width, self.prune_less_than_val,
            )
            self._beams = {p: Beam(p, pb, pnb, 0.0, fr) for p, pb, pnb, fr in res}
            return
        beams = self._beams
        lm_memo = self._lm_memo

        for t_local in range(T):
            t = t0 + t_local
            frame = log_probs[t_local]
            # top-AM pruning (reference :224-228); the configured pad id is
            # never a candidate unless it is blank
            keep = np.where(frame > frame.max() + self.top_am_threshold)[0]
            if self.pad_id is not None and blank != self.pad_id:
                keep = keep[keep != self.pad_id]
            if keep.size == 0:
                # no candidate survived (pad was the sole above-threshold
                # class, or a non-negative threshold excluded even the
                # argmax): carry the beams unchanged rather than emptying the
                # beam set for all remaining frames
                continue

            # one batched LM call per frame for prefixes not already scored
            lm_next: Optional[Dict[Tuple[int, ...], np.ndarray]] = None
            if self.lm_scores is not None and any(k != blank for k in keep):
                missing = [p for p in beams if p not in lm_memo]
                if missing:
                    mcl = self.max_cache_length
                    ctx = [list(p)[-mcl:] if mcl > 0 else list(p) for p in missing]
                    scores = self.lm_scores(ctx)
                    for i, p in enumerate(missing):
                        lm_memo[p] = scores[i]
                lm_next = lm_memo

            new_beams: Dict[Tuple[int, ...], Beam] = {}

            def upd(prefix, lm_score, frames, p_blank=LOG0, p_non_blank=LOG0):
                b = new_beams.get(prefix)
                if b is None:
                    b = Beam(prefix, LOG0, LOG0, lm_score, frames)
                    new_beams[prefix] = b
                b.p_blank = _logsumexp(b.p_blank, p_blank)
                b.p_non_blank = _logsumexp(b.p_non_blank, p_non_blank)
                b.lm_score = lm_score  # deterministic per prefix
                # timestamps follow the strongest merged-in path, not
                # whichever was iterated first
                contrib = _logsumexp(p_blank, p_non_blank)
                if contrib > b.best_contrib:
                    b.best_contrib = contrib
                    b.frames = frames

            for prefix, beam in beams.items():
                last = prefix[-1] if prefix else None
                for c in keep:
                    p = float(frame[c])
                    if c == blank:
                        upd(prefix, beam.lm_score, beam.frames, p_blank=beam.am_score + p)
                    elif c == last:
                        # a repeat collapses into the same prefix...
                        upd(prefix, beam.lm_score, beam.frames,
                            p_non_blank=beam.p_non_blank + p)
                        # ...or extends it after an explicit blank
                        new_prefix = prefix + (int(c),)
                        lm_add = self._lm_add(lm_next, prefix, c)
                        upd(new_prefix, beam.lm_score + lm_add, beam.frames + (t,),
                            p_non_blank=beam.p_blank + p)
                    else:
                        new_prefix = prefix + (int(c),)
                        lm_add = self._lm_add(lm_next, prefix, c)
                        upd(new_prefix, beam.lm_score + lm_add, beam.frames + (t,),
                            p_non_blank=beam.am_score + p)

            ranked = sorted(new_beams.values(), key=lambda b: -b.score)
            ranked = ranked[: self.beam_width]
            if self.prune_less_than_val is not None and ranked:
                cut = ranked[0].score - self.prune_less_than_val
                ranked = [b for b in ranked if b.score >= cut]
            beams = {b.prefix: b for b in ranked}
            if self.lm_scores is not None:
                lm_memo = {p: v for p, v in lm_memo.items() if p in beams}

        self._beams = beams
        self._lm_memo = lm_memo

    def decode_beams(self, log_probs: np.ndarray, ds_factor: float = 8.0,
                     frames_per_second: float = 100.0):
        """Beam search with word-level timestamps (the reference's
        pyctcdecode `decode_beams_lm` usage, reference
        `lcasr/eval/utils.py:14-43`): {'text', 'frames': [{'word', 'start',
        'end'} in seconds], 'am_score', 'score'}.  Word boundaries come from
        the tokenizer's ▁ pieces; start / end frames are the first / last
        piece-emission frames scaled by the subsampling factor."""
        from lcasr_torch.decoding.timestamps import words_from_ids

        self.run_search(log_probs, decode=False)
        best = self._best
        ids, frames = list(best.prefix), list(best.frames)
        words = (words_from_ids(self.tokenizer, ids, frames, ds_factor, frames_per_second)
                 if self.tokenizer else [])
        return {
            "text": self.tokenizer.decode(ids) if self.tokenizer else ids,
            "frames": words,
            "am_score": best.am_score,
            "score": best.score,
        }

    def _lm_add(self, lm_next, prefix, c) -> float:
        if lm_next is None:
            return 0.0
        return self.alpha * float(lm_next[prefix][int(c)]) + self.beta

    # reference-compatible alias
    __call__ = run_search


class TorchLMScorer:
    """The batched `lm_scores` hook over a causal LM (the port's
    counterpart of lcasr_tpu's `FlaxLMScorer`): prefixes padded to a shared
    length bucket and batch bucket, one forward per frame.

    `fn(tokens (B, U) int32 numpy) -> (B, U, V) logits`; `fn_last(tokens,
    last (B,)) -> (B, V)` next-token log-probs, the position gathered and
    log-softmaxed on the device so that only B x V values come back
    (`models.lm.make_lm_scorer` builds both)."""

    def __init__(self, fn: Callable, bos_id: int = 2, pad_id: int = 0, bucket: int = 32,
                 fn_last: Optional[Callable] = None, batch_bucket: int = 8):
        self.fn = fn
        self.fn_last = fn_last
        self.bos_id = bos_id
        self.pad_id = pad_id
        self.bucket = bucket
        # the batch is bucketed too: live-beam counts vary frame to frame
        self.batch_bucket = batch_bucket

    def __call__(self, prefixes: List[List[int]]) -> np.ndarray:
        n = len(prefixes)
        nb = -(-n // self.batch_bucket) * self.batch_bucket
        max_len = max(len(p) for p in prefixes) + 1  # + bos
        U = -(-max_len // self.bucket) * self.bucket
        tokens = np.full((nb, U), self.pad_id, np.int32)
        tokens[:, 0] = self.bos_id  # padding rows stay valid inputs
        last = np.zeros((nb,), np.int32)
        for i, p in enumerate(prefixes):
            tokens[i, 1 : 1 + len(p)] = p
            last[i] = len(p)
        if self.fn_last is not None:
            return np.asarray(self.fn_last(tokens, last))[:n]
        logits = np.asarray(self.fn(tokens))
        out = logits[np.arange(n), last[:n]]
        m = out.max(-1, keepdims=True)  # stable log-softmax
        return out - (m + np.log(np.exp(out - m).sum(-1, keepdims=True)))
