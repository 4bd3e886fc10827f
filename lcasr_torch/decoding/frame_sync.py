"""Frame-synchronous LM-fused CTC beam search (the port's copy of the
host-side part of lcasr_tpu/decoding/frame_sync.py: `_sum_log_scores`,
`FSBeam`, `HistoryLM`, `FrameSyncBeamSearch`), numpy on the host.

The reference algorithm (reference `lcasr/decoding/ctc_beam_search.py`):

  * beams carry an `am_sequence` WITH collapsed blanks (a blank is appended
    once after a non-blank; repeats collapse) and an `lm_sequence`
    (bos + emitted tokens);
  * per frame, candidate set = ids with `lgp > max + top_am_threshold`,
    ids 1..vocab (id 0/pad is never proposed);
  * blank/repeat extensions keep the LM state and add AM only (+ blank /
    repetition penalties); new tokens add `am + alpha lm + beta`;
  * beams with identical am_sequences merge via logsumexp;
  * prune to beam_width, then drop beams below `top - prune_less_than_val`;
  * ONE batched LM call per frame for all beams that emitted a token, and
    none on a frame where no beam did.

The LM is anything with `init(width) -> (state, log-probs)` and
`step(state, parent_idx, tokens, update_mask) -> (state, (width, V)
log-probs)`; `HistoryLM` adapts any full-context scorer (the
encoder-decoder's internal LM, `models/enc_dec_sconformer.ctc_beam_search`).
The device-cached transformer LM (`CachedTransformerLM`) and the
search over many recordings (`rescore_many`) wait for `models/lm.py` (ROADMAP
queue A4).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

DEFAULT_BEAM_WIDTH = 25


def _sum_log_scores(s1: float, s2: float) -> float:
    # reference :161-162
    if s1 >= s2:
        return s1 + math.log(1 + math.exp(s2 - s1))
    return s2 + math.log(1 + math.exp(s1 - s2))


@dataclass
class FSBeam:
    am_sequence: Tuple = (None,)  # no bos for am (reference :137)
    lm_sequence: Tuple[int, ...] = ()  # starts with bos
    stimes: Tuple[int, ...] = (0,)
    score: float = 0.0
    row: int = 0  # LM cache row currently holding this beam's state
    next_lps: Optional[np.ndarray] = None  # next-token log-probs


class HistoryLM:
    """BatchedCachedLM over a full-context scorer
    `fn(histories: List[List[int]]) -> (n, V) next-token log-probs`.

    `max_cache_length > 0` truncates each history to its last n tokens —
    the reference's trim_cache semantics (`:177-184`)."""

    def __init__(self, fn: Callable, bos_id: int = 2, max_cache_length: int = -1):
        self.fn = fn
        self.bos_id = bos_id
        self.max_cache_length = max_cache_length

    def init(self, width: int):
        lps = self.fn([[self.bos_id]])[0]
        return [[self.bos_id] for _ in range(width)], np.asarray(lps)

    def step(self, state, parent_idx, tokens, update_mask):
        state = [list(state[p]) for p in parent_idx]
        feed_rows = [j for j in range(len(tokens)) if update_mask[j]]
        for j in feed_rows:
            state[j].append(int(tokens[j]))
        lps = np.full((len(tokens), 1), 0.0)
        if feed_rows:
            out = np.asarray(self.fn([state[j] for j in feed_rows]))
            lps = np.zeros((len(tokens), out.shape[-1]), out.dtype)
            for i, j in enumerate(feed_rows):
                lps[j] = out[i]
        # reference trim_cache (:177-184) trims AFTER the LM call — the LM
        # must see the full pre-trim context for this step (trimming before
        # scoring was measured to diverge beam-for-beam from the reference)
        if self.max_cache_length > 0:
            for j in feed_rows:
                state[j] = state[j][-self.max_cache_length:]
        return state, lps


class FrameSyncBeamSearch:
    def __init__(
        self,
        lm,
        tokenizer=None,
        beam_width: int = DEFAULT_BEAM_WIDTH,
        alpha: float = 0.4,
        beta: float = 0.4,
        blank_id: Optional[int] = None,
        blank_penalty: float = 0.0,
        repetition_penalty: float = 0.0,
        top_am_threshold: float = -6.0,
        prune_less_than_val: Optional[float] = None,
        bos_id: int = 2,
    ):
        self.lm = lm
        self.tokenizer = tokenizer
        self.beam_width = beam_width
        self.alpha = alpha
        self.beta = beta
        self.blank_id = blank_id
        self.blank_penalty = blank_penalty
        self.repetition_penalty = repetition_penalty
        self.top_am_threshold = top_am_threshold
        self.prune_less_than_val = prune_less_than_val
        self.bos_id = bos_id

    def run_search(self, log_probs: np.ndarray, decode: bool = False):
        """log_probs (T, C) → token ids (lm_sequence minus bos) or text."""
        state, lps0 = self.lm.init(self.beam_width)
        gen = self.search_gen(np.asarray(log_probs), lps0)
        try:
            req = next(gen)
            while True:
                state, lps = self.lm.step(state, *req)
                req = gen.send(lps)
        except StopIteration as stop:
            beams = stop.value
        return self._finalize(beams, decode)

    def _finalize(self, beams: List[FSBeam], decode: bool):
        self.beams = beams
        best = beams[0]
        ids = list(best.lm_sequence[1:])
        if decode and self.tokenizer is not None:
            return self.tokenizer.decode(ids)
        return ids

    def search_gen(self, log_probs: np.ndarray, lps0: np.ndarray):
        """Stepwise core of `run_search` as a generator: runs host-side
        through blank-dominated frames and PAUSES (yields) exactly when it
        needs an LM step, yielding `(parent_idx, tokens, update_mask)`
        arrays of width `beam_width`; the caller `.send()`s back the
        (width, V) next-token log-probs.  Returns the final beam list."""
        log_probs = np.asarray(log_probs)  # scores accumulate in input dtype
        T, C = log_probs.shape
        blank = self.blank_id if self.blank_id is not None else C - 1
        # the emit-score gather below clips ids to the LM vocab on the
        # assumption that ONLY blank can exceed it (blank = last id, LM
        # vocab = C-1); with a different layout a real token would silently
        # score with the wrong LM column — refuse instead
        V = len(lps0)
        top_nonblank = C - 2 if blank == C - 1 else C - 1
        if top_nonblank >= V:
            raise ValueError(
                f"LM vocab {V} cannot score emit candidates up to id "
                f"{top_nonblank} (C={C}, blank={blank}); only a trailing "
                f"blank may exceed the LM vocab"
            )

        beams: List[FSBeam] = [
            FSBeam(lm_sequence=(self.bos_id,), next_lps=lps0, row=0)
        ]

        for t in range(T):
            frame = log_probs[t]
            keep_arr = np.where(frame > frame.max() + self.top_am_threshold)[0]
            keep_arr = keep_arr[keep_arr >= 1]  # drop pad id 0 (reference :224)
            keep = [int(i) for i in keep_arr]
            K = len(keep)
            if K == 0:
                # argmax is id 0 (pad — never proposed, reference :224-231)
                # and nothing else clears the AM threshold: a candidate-less
                # frame carries the beams over unchanged instead of emptying
                # the beam set (which would crash the next frame)
                continue

            # vectorized candidate scoring: one (n_beams, K) matrix instead
            # of per-candidate float() math in the inner loop (the loop below
            # only constructs the surviving beam objects)
            am_k = frame[keep_arr].astype(np.float64)  # (K,)
            base = np.array([b.score for b in beams], np.float64)[:, None]
            # lm weighting stays in the lps dtype before the f64 sum — the
            # exact fp-op order of the scalar formulation (parity-sensitive).
            # Gather with CLIPPED ids: the blank/stay columns are never read
            # from lm_k (stay_scores path), and blank may exceed the LM vocab
            lm_gather = np.minimum(keep_arr, len(beams[0].next_lps) - 1)
            lm_k = np.stack([b.next_lps[lm_gather] for b in beams]) * self.alpha + self.beta
            emit_scores = am_k[None, :] + lm_k.astype(np.float64) + base  # (n_b, K)
            stay_scores = am_k[None, :] + base  # + penalty, applied per case

            new_beams: List[FSBeam] = []
            for bi, beam in enumerate(beams):
                last = beam.am_sequence[-1]
                for ki, i in enumerate(keep):
                    if last == i or i == blank:
                        new_beams.append(FSBeam(
                            am_sequence=(
                                beam.am_sequence + (i,)
                                if i == blank and last != blank
                                else beam.am_sequence
                            ),
                            lm_sequence=beam.lm_sequence,
                            stimes=beam.stimes,
                            score=stay_scores[bi, ki] + (
                                self.blank_penalty if i == blank
                                else self.repetition_penalty
                            ),
                            row=beam.row,
                            next_lps=beam.next_lps,
                        ))
                    else:
                        new_beams.append(FSBeam(
                            am_sequence=(
                                beam.am_sequence[:-1] + (i,)
                                if last == blank
                                else beam.am_sequence + (i,)
                            ),
                            lm_sequence=beam.lm_sequence + (i,),
                            stimes=beam.stimes + (t,),
                            score=emit_scores[bi, ki],
                            row=beam.row,
                            next_lps=None,
                        ))

            # merge identical am sequences (logsumexp; first occurrence keeps
            # its LM identity — reference dict-insertion order :164-172)
            merged = {}
            for b in new_beams:
                key = b.am_sequence
                if key in merged:
                    merged[key].score = _sum_log_scores(b.score, merged[key].score)
                else:
                    merged[key] = b
            new_beams = heapq.nlargest(
                self.beam_width, merged.values(), key=lambda b: b.score
            )
            if self.prune_less_than_val is not None:
                top = new_beams[0].score
                new_beams = [
                    b for b in new_beams
                    if not b.score < top - self.prune_less_than_val
                ]

            if t == T - 1:
                beams = new_beams
                break

            # ONE batched LM call for all beams that emitted a token — and
            # NO call at all when none did (the typical blank-dominated
            # frame): rows are read-only until the next real step, so beams
            # keep their parent's row (shared rows are fine — the step's
            # parent gather duplicates them).  Most frames so pay no device
            # round trip.
            if any(b.next_lps is None for b in new_beams):
                parent_idx = np.zeros((self.beam_width,), np.int32)
                tokens = np.zeros((self.beam_width,), np.int32)
                update = np.zeros((self.beam_width,), bool)
                for j, b in enumerate(new_beams):
                    parent_idx[j] = b.row
                    tokens[j] = b.lm_sequence[-1]
                    update[j] = b.next_lps is None
                lps = yield (parent_idx, tokens, update)
                for j, b in enumerate(new_beams):
                    b.row = j
                    if update[j]:
                        b.next_lps = lps[j]
            beams = new_beams

        return beams
