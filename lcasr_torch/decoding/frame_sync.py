"""Frame-synchronous LM-fused CTC beam search (the port's copy of
lcasr_tpu/decoding/frame_sync.py): the search on the host in numpy, its LM
on the device.

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
log-probs)`; `CachedTransformerLM` adapts `models/lm.py` (per-beam KV
caches on the device, one step a frame), `HistoryLM` any full-context scorer
(the encoder-decoder's internal LM, `models/enc_dec_sconformer.
ctc_beam_search`).  `rescore_many` runs many recordings' searches off one
wide LM, one batched step a tick for every search that waits on one.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


class CachedTransformerLM:
    """The LM protocol over `models/lm.py:TransformerLM` with per-beam KV
    caches on the model's device: one single-token step a frame over all
    beam rows, the parents' rows gathered by index first (the port's copy of
    lcasr_tpu's `CachedTransformerLM`).

    `cache_dtype`: fp32 by default (beam-for-beam parity); bf16 halves the
    buffer, the only large tensor of a rescoring run (keys and values round
    to bf16 at rest, the scores stay fp32)."""

    def __init__(self, model, width: int, max_len: int, bos_id: int = 2,
                 cache_dtype: Optional[torch.dtype] = None):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.bos_id = bos_id
        self.width = width
        self.max_len = max_len
        self.cache_dtype = cache_dtype if cache_dtype is not None else torch.float32
        # the host's shadow of the device lengths (the same gather and
        # increment), so an overflow is caught without a sync a step: past
        # max_len the model drops the write and scores would go wrong quietly
        self._host_lengths = np.zeros((width,), np.int64)
        L, H, D = model.n_layers, model.n_heads, model.head_dim
        self.cache_shape = (L, 2, width, H, max_len + 1, D)
        # position capacity in buckets: every step's parent gather and
        # attention read touch the whole buffer, so it starts at 256
        # positions and doubles when the longest beam nears it.  The
        # arithmetic is exact either way (padded columns are NEG_INF-masked
        # and their exp underflows to 0.0 in the fp32 softmax).
        self._buf_len = min(256, max_len + 1)

    @torch.no_grad()
    def _step(self, cache, lengths, parent_idx, tokens, update):
        # one whole-cache producer a step (the parent gather); the masked
        # advance writes B cells inside the model, so the peak is 2 buffers
        cache = cache[:, :, parent_idx]
        lengths = lengths[parent_idx]
        logits, cache, lengths = self.model(tokens[:, None], cache=cache,
                                            cache_lengths=lengths, write_mask=update)
        return cache, lengths, F.log_softmax(logits[:, 0].float(), -1)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def init(self, width: int):
        assert width == self.width
        self._buf_len = min(256, self.max_len + 1)
        cache = torch.zeros(self.cache_shape[:4] + (self._buf_len,) + self.cache_shape[5:],
                            dtype=self.cache_dtype, device=self.device)
        lengths = torch.zeros((width,), dtype=torch.int32, device=self.device)
        cache, lengths, lps = self._step(
            cache, lengths, torch.arange(width, device=self.device),
            torch.full((width,), self.bos_id, dtype=torch.int64, device=self.device),
            torch.ones((width,), dtype=torch.bool, device=self.device))
        self._host_lengths = np.ones((width,), np.int64)
        return (cache, lengths), lps[0].cpu().numpy()

    def step(self, state, parent_idx, tokens, update_mask):
        cache, lengths = state
        parent_idx = np.asarray(parent_idx, np.int64)
        update_mask = np.asarray(update_mask, bool)
        hl = self._host_lengths[parent_idx] + update_mask
        if hl.max(initial=0) > self.max_len + 1:
            raise RuntimeError(
                f"LM KV cache overflow: a beam reached {int(hl.max())} tokens > "
                f"max_len={self.max_len}; size the cache for the worst-case emission "
                f"count (one per candidate frame), not a heuristic")
        self._host_lengths = hl
        # grow the bucket before the step, so that this step's write position
        # stays strictly inside the buffer (the model drops a write at Nmax)
        needed = min(int(hl.max(initial=0)) + 1, self.max_len + 1)
        if needed > self._buf_len:
            target = self._buf_len
            while target < needed:
                target *= 2
            target = min(target, self.max_len + 1)
            cache = F.pad(cache, (0, 0, 0, target - self._buf_len))
            self._buf_len = target
        cache, lengths, lps = self._step(
            cache, lengths, self._put(parent_idx),
            self._put(np.asarray(tokens, np.int64)), self._put(update_mask))
        return (cache, lengths), lps.cpu().numpy()

    def warm_buckets(self):
        """Run the step once at every bucket size this cache can reach, so
        that a timed search pays no first-use cost when the buffer doubles.
        Returns the sizes."""
        sizes, b = [], min(256, self.max_len + 1)
        while True:
            sizes.append(b)
            if b >= self.max_len + 1:
                break
            b = min(b * 2, self.max_len + 1)
        dev, W = self.device, self.width
        for s in sizes:
            cache = torch.zeros(self.cache_shape[:4] + (s,) + self.cache_shape[5:],
                                dtype=self.cache_dtype, device=dev)
            self._step(cache, torch.zeros((W,), dtype=torch.int32, device=dev),
                       torch.arange(W, device=dev),
                       torch.full((W,), self.bos_id, dtype=torch.int64, device=dev),
                       torch.ones((W,), dtype=torch.bool, device=dev))
        return sizes


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


def rescore_many(
    lm,
    logits_list: Sequence[np.ndarray],
    n_slots: int,
    tokenizer=None,
    decode: bool = False,
    **search_kwargs,
):
    """Rescore many recordings at once off one shared LM.

    `lm` is an LM of width `n_slots * beam_width`: slot r owns rows
    [r W, (r+1) W).  Each recording's search runs on the host until it waits
    on an LM step (`FrameSyncBeamSearch.search_gen`); every tick issues one
    batched step serving all waiting searches, with identity parent rows and
    update False for the other slots.  The per-row LM arithmetic does not
    depend on the other rows, so each recording's result is its own
    `run_search`'s (reference counterpart: `eval/tedlium/tlm_beam.py:55-61`
    fans recordings out over CPUs with ray).  Returns the results in input
    order."""
    width = search_kwargs.get("beam_width", DEFAULT_BEAM_WIDTH)
    results: List = [None] * len(logits_list)

    for wave_start in range(0, len(logits_list), n_slots):
        wave = range(wave_start, min(wave_start + n_slots, len(logits_list)))
        state, lps0 = lm.init(n_slots * width)
        live = {}  # slot -> (recording index, searcher, generator)
        pending = {}  # slot -> (parent_idx, tokens, update)
        for slot, ridx in enumerate(wave):
            searcher = FrameSyncBeamSearch(lm=None, tokenizer=tokenizer, **search_kwargs)
            gen = searcher.search_gen(np.asarray(logits_list[ridx]), lps0)
            try:
                pending[slot] = next(gen)
                live[slot] = (ridx, searcher, gen)
            except StopIteration as stop:  # a recording with no LM step at all
                results[ridx] = searcher._finalize(stop.value, decode)

        while live:
            parent = np.arange(n_slots * width, dtype=np.int32)
            tokens = np.zeros((n_slots * width,), np.int32)
            update = np.zeros((n_slots * width,), bool)
            for slot, (p, t, u) in pending.items():
                base = slot * width
                parent[base:base + width] = base + np.asarray(p, np.int32)
                tokens[base:base + width] = t
                update[base:base + width] = u
            state, lps = lm.step(state, parent, tokens, update)
            pending = {}
            for slot in list(live):
                ridx, searcher, gen = live[slot]
                base = slot * width
                try:
                    pending[slot] = gen.send(lps[base:base + width])
                except StopIteration as stop:
                    results[ridx] = searcher._finalize(stop.value, decode)
                    del live[slot]

    return results
