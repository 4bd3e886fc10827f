"""Frame-synchronous LM-fused beam search on the device (the port's copy of
lcasr_tpu/decoding/frame_sync_device.py).

The host search (`decoding/frame_sync.py`) is beam-for-beam exact against
the reference (`lcasr/decoding/ctc_beam_search.py:93-322`) but runs its
loop on the host: every emitting frame pays a round trip for the LM step.
Here the whole search (candidate selection, beam extension, merging of equal
sequences, pruning and the cached LM step) runs on the device as torch ops
on fixed shapes; the host uploads the logits once, reads one flag array a
segment, and downloads the winning ids at the end.

Semantics are the host algorithm's, with fixed shapes:

  * W beam rows; dead rows carry score -1e30 (their extensions underflow to
    exactly 0 in every logsumexp merge, so they are arithmetically absent,
    and their merge hashes are per-row sentinels so they never claim a live
    beam's identity);
  * the AM sequence is tracked as two rolling 32-bit hashes (P1 = 1000003,
    P2 = 2654435761) of the sequence without a trailing blank, a
    trailing-blank flag and the last entry: enough to decide stay / emit and
    sequence equality (the merge rule) without the sequences.  The hashes
    are int64 tensors holding uint32 values, each product taken modulo 2^32
    in two 16-bit halves (CUDA has no uint32 multiply in torch, and a plain
    int64 product of two 32-bit values can overflow), so they equal JAX's
    uint32 wraparound;
  * candidates are the <= max_candidates ids above the AM threshold, in
    ascending id order: the host builds beams beam-major x candidate-
    ascending, and the merge rule ("the first occurrence keeps its LM
    identity") and top-W tie-breaking follow that insertion order.  The
    top-K is a stable descending sort in the IEEE total order (lax.top_k's
    choice among equal values at the boundary: the lower id, and -0.0 below
    +0.0; torch.topk promises no order among ties),
    and the beam ranking is a stable sort of -score over the insertion
    index, which is lexsort((index, -score)), the index key already sorted;
  * the KV cache is never permuted: beams read their prefix through a
    per-position row map (`pos_row`), forked children share their parent's
    cells, and each append is given an unreferenced cell by a per-frame
    free-cell matching;
  * the LM step: JAX skips it under `lax.cond` when no surviving beam
    emitted, a decision taken on the device.  Here the decision is taken
    once a segment on the host, from the candidates alone: a frame none of
    whose candidates (in any recording) is a non-blank id cannot emit, and
    skips the step; every other frame runs it under the write mask.  A step
    whose mask is all False leaves the cache, the lengths, the row map and
    the next-token log-probs exactly as they were (`models.lm` contract), so
    the result is the JAX search's while the host synchronises once a
    segment (the flags' copy), not once a frame.  A frame without any
    candidate in any recording (the padding of the last segment, for one)
    leaves every search as it was, and is skipped.

Differences from the host path, by construction (as in JAX): scores
accumulate in fp32 (host: float64), so over long searches near-ties may be
decided differently; at most `max_candidates` ids a frame (pick it to cover
the observed maximum); the LM must be `models/lm.py:TransformerLM`.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
P1, P2 = 1000003, 2654435761
MASK32 = 0xFFFFFFFF
# (dead rows, invalid candidate slots: sentinel hashes, as in JAX)
DEAD1, DEAD2, INVALID = 0xDEAD0000, 0x5EED0000, 0xBAD00000


def _mulmod32(h: torch.Tensor, p: int) -> torch.Tensor:
    """(h * p) mod 2^32 for int64 h in [0, 2^32): two 16-bit halves of h,
    each product below 2^48."""
    hi = (((h >> 16) * p) & 0xFFFF) << 16
    return (hi + (h & 0xFFFF) * p) & MASK32


class DeviceFrameSyncBeamSearch:
    """The device counterpart of `FrameSyncBeamSearch` +
    `CachedTransformerLM` for TransformerLM-rescored CTC beam search; runs
    on the LM's device."""

    def __init__(
        self,
        model,
        tokenizer=None,
        beam_width: int = 25,
        alpha: float = 0.4,
        beta: float = 0.4,
        blank_id: Optional[int] = None,
        blank_penalty: float = 0.0,
        repetition_penalty: float = 0.0,
        top_am_threshold: float = -6.0,
        prune_less_than_val: Optional[float] = None,
        bos_id: int = 2,
        max_tokens: int = 2048,
        max_candidates: int = 8,
        cache_dtype: Optional[torch.dtype] = None,
        frame_bucket: int = 2048,
    ):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.W = beam_width
        self.K = max_candidates
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.blank_id = blank_id
        self.blank_penalty = float(blank_penalty)
        self.repetition_penalty = float(repetition_penalty)
        self.thresh = float(top_am_threshold)
        self.plv = prune_less_than_val
        self.bos_id = bos_id
        self.S = max_tokens
        self.cache_dtype = cache_dtype if cache_dtype is not None else torch.float32
        # the search runs one frame_bucket segment at a time; the host reads
        # the segment's emit flags once (see the module docstring)
        self.frame_bucket = frame_bucket

    # ------------------------------------------------------------------
    def _candidates(self, log_probs: torch.Tensor):
        """(T, C) log-probs -> (cand, am, valid), each (T, K): the ids above
        the threshold (never id 0), at most K, ascending by id, invalid
        slots last."""
        T, C = log_probs.shape
        fmax = log_probs.max(-1, keepdim=True).values
        ids = torch.arange(C, device=log_probs.device)
        passes = (log_probs > fmax + self.thresh) & (ids >= 1)
        vals = torch.where(passes, log_probs, NEG).float()
        # lax.top_k orders by the IEEE total order (-0.0 below +0.0) and
        # takes the lower index among equal values: a stable descending sort
        # of the order-preserving integer image of the bits
        bits = vals.view(torch.int32)
        key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
        topi = torch.sort(key, dim=-1, descending=True, stable=True).indices[:, : self.K]
        topv = vals.gather(-1, topi)
        valid = topv > NEG / 2
        order = torch.sort(torch.where(valid, topi, C + 1), dim=-1, stable=True).indices
        return topi.gather(-1, order), topv.gather(-1, order), valid.gather(-1, order)

    @torch.no_grad()
    def _lm_apply(self, cache, lengths, tokens, update, pos_row=None, write_rows=None):
        logits, cache, lengths = self.model(tokens[:, None], cache=cache, cache_lengths=lengths,
                                            write_mask=update, pos_row=pos_row,
                                            write_rows=write_rows)
        return cache, lengths, F.log_softmax(logits[:, 0].float(), -1)

    def _init_carry(self, N: int) -> dict:
        W, S, dev = self.W, self.S, self.device
        Wt = N * W
        m = self.model
        # LM bootstrap: every row scored at (bos,), the host's lm.init.  The
        # cache rows are flat (N W): recording n owns rows [n W, (n+1) W),
        # and every indirection stays inside a recording's block.
        cache = torch.zeros((m.n_layers, 2, Wt, m.n_heads, S + 1, m.head_dim),
                            dtype=self.cache_dtype, device=dev)
        cache, _, lps0 = self._lm_apply(
            cache, torch.zeros((Wt,), dtype=torch.int64, device=dev),
            torch.full((Wt,), self.bos_id, dtype=torch.int64, device=dev),
            torch.ones((Wt,), dtype=torch.bool, device=dev))
        arW = torch.arange(W, device=dev)
        zeros = torch.zeros((N, W), dtype=torch.int64, device=dev)
        scores = torch.full((N, W), NEG, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        return dict(
            scores=scores,
            h1=zeros + 1,
            h2=zeros + 1,
            last=zeros - 1,  # am_sequence[-1]; -1 stands for None
            lblank=torch.zeros((N, W), dtype=torch.bool, device=dev),  # trailing blank
            lm_seq=torch.zeros((N, W, S), dtype=torch.int64, device=dev),
            lm_len=zeros.clone(),
            stimes=torch.zeros((N, W, S + 1), dtype=torch.int64, device=dev),  # host: (0,)
            st_len=zeros + 1,
            next_lps=lps0[0].expand(N, W, lps0.shape[-1]).clone(),
            cache=cache,
            clen=zeros + 1,
            # per-position row indirection (local rows 0..W-1): K/V at
            # position n of beam j live in row pos_row[j, n] of the
            # recording's block; the cache itself is never permuted
            pos_row=arW[None, :, None].expand(N, W, S + 1).clone(),
        )

    def _bookkeeping(self, book: dict, cand, am, valid, C: int):
        """One frame of every recording's search, the LM step aside:
        (new book, parent (N, W), token (N, W), update (N, W))."""
        W, K, S, dev = self.W, self.K, self.S, self.device
        N = cand.shape[0]
        blank = self.blank_id if self.blank_id is not None else C - 1
        V_lm = self.model.vocab_size
        arW = torch.arange(W, device=dev)
        scores, h1, h2 = book["scores"], book["h1"], book["h2"]
        last, lblank = book["last"], book["lblank"]

        # dead rows never merge with live ones: per-row sentinel hashes
        dead = scores <= NEG / 2
        h1 = torch.where(dead, DEAD1 + arW, h1)
        h2 = torch.where(dead, DEAD2 + arW, h2)

        is_blank = cand == blank  # (N, K)
        same = (~lblank[:, :, None]) & (cand[:, None, :] == last[:, :, None])
        is_stay = is_blank[:, None, :] | same  # (N, W, K)
        is_emit = (~is_stay) & valid[:, None, :]

        # scoring: the fp32 operation order of JAX's
        lm_ids = cand.clamp(max=V_lm - 1)[:, None, :].expand(N, W, K)
        lmk = book["next_lps"].gather(2, lm_ids) * self.alpha + self.beta
        pen = torch.where(is_blank[:, None, :], self.blank_penalty, self.repetition_penalty)
        stay_sc = (am[:, None, :] + scores[:, :, None]) + pen
        emit_sc = (am[:, None, :] + lmk) + scores[:, :, None]
        sc = torch.where(is_stay, stay_sc, emit_sc)
        sc = torch.where(valid[:, None, :], sc, NEG)

        # the children's sequence features (the hash leaves out a trailing
        # blank, so emit-over-blank and emit-append share one update)
        tok = cand[:, None, :]
        ch1 = torch.where(is_emit, (_mulmod32(h1, P1)[:, :, None] + tok) & MASK32,
                          h1[:, :, None])
        ch2 = torch.where(is_emit, (_mulmod32(h2, P2)[:, :, None] + tok) & MASK32,
                          h2[:, :, None])
        # children of invalid slots score NEG and must not claim a live
        # group's first-occurrence identity: sentinel hashes, singletons
        inv_sent = (INVALID + torch.arange(W * K, device=dev)).view(1, W, K)
        ch1 = torch.where(valid[:, None, :], ch1, inv_sent)
        ch2 = torch.where(valid[:, None, :], ch2, inv_sent)
        c_lblank = torch.where(is_emit, False, lblank[:, :, None] | is_blank[:, None, :])
        c_last = torch.where(is_emit, tok,
                             torch.where(is_blank[:, None, :], blank, last[:, :, None]))

        # merge equal AM sequences: a dense (WK, WK) equality matrix; rows
        # are in insertion order (beam-major, candidate-ascending), so the
        # first occurrence (the host's identity holder) is each group's
        # smallest index
        WK = W * K
        ins = torch.arange(WK, device=dev)
        f_sc = sc.reshape(N, WK)
        f_k1, f_k2 = ch1.reshape(N, WK), ch2.reshape(N, WK)
        f_kb = c_lblank.reshape(N, WK)
        E = ((f_k1[:, :, None] == f_k1[:, None, :]) & (f_k2[:, :, None] == f_k2[:, None, :])
             & (f_kb[:, :, None] == f_kb[:, None, :]))
        first = torch.where(E, ins, WK).min(-1).values
        is_head = first == ins
        row_max = torch.where(E, f_sc[:, None, :], NEG).max(-1).values
        row_sum = torch.where(E, torch.exp(f_sc[:, None, :] - row_max[:, :, None]), 0.0).sum(-1)
        msc = torch.where(is_head, row_max + torch.log(row_sum), 2 * NEG)

        # top-W groups; the host's nlargest is stable: ties break by the
        # first-occurrence (insertion) index
        sel = torch.sort(-msc, dim=-1, stable=True).indices[:, :W]
        new_scores = msc.gather(1, sel)
        pw, pk = sel // K, sel % K
        if self.plv is not None:
            top = new_scores[:, :1]
            new_scores = torch.where(new_scores < top - self.plv, NEG, new_scores)
        new_scores = new_scores.clamp(min=NEG)
        live = new_scores > NEG / 2

        tok = cand.gather(1, pk)
        update = is_emit.reshape(N, WK).gather(1, sel) & live
        parent = pw

        def rows(a):  # a (N, W, ...) -> its parents' rows
            idx = parent.view(N, W, *([1] * (a.dim() - 2))).expand(N, W, *a.shape[2:])
            return a.gather(1, idx)

        lm_len0 = book["lm_len"].gather(1, parent)
        n_lm_seq = rows(book["lm_seq"])
        widx = lm_len0.clamp(max=S - 1)[:, :, None]
        n_lm_seq.scatter_(2, widx, torch.where(update, tok, n_lm_seq.gather(2, widx)[..., 0])
                          [..., None])
        st_len0 = book["st_len"].gather(1, parent)
        n_stimes = rows(book["stimes"])
        sidx = st_len0.clamp(max=S)[:, :, None]
        n_stimes.scatter_(2, sidx, torch.where(update, book["t"], n_stimes.gather(2, sidx)[..., 0])
                          [..., None])
        new_book = dict(
            scores=new_scores,
            h1=ch1.reshape(N, WK).gather(1, sel), h2=ch2.reshape(N, WK).gather(1, sel),
            last=c_last.reshape(N, WK).gather(1, sel),
            lblank=c_lblank.reshape(N, WK).gather(1, sel),
            lm_seq=n_lm_seq, lm_len=lm_len0 + update,
            stimes=n_stimes, st_len=st_len0 + update,
            next_lps=rows(book["next_lps"]),
            clen=book["clen"].gather(1, parent),
            pos_row=rows(book["pos_row"]),
        )
        return new_book, tok, update

    def _alloc(self, clen, pos_row, update):
        """Free-cell allocation (recording-local): writer j appends at
        position p_j = clen[j] and needs a cell (r, p_j) that no live beam
        still references (forked children share their parent's cells through
        pos_row).  Beam x references cell (pos_row[x, p], p) iff clen[x] > p;
        with W beams at most W - #writers(p) cells at p are referenced, so
        every writer finds a free one; writers at the same position take
        distinct free rows by rank.  Returns (write rows (N, W), pos_row)."""
        W, S = self.W, self.S
        N = clen.shape[0]
        arW = torch.arange(W, device=clen.device)
        p_j = clen
        pcl = p_j.clamp(max=S)
        M = pos_row.gather(2, pcl[:, None, :].expand(N, W, W))  # (N, Wx, Wj)
        refs = clen[:, :, None] > p_j[:, None, :]
        claimed = ((M[..., None] == arW) & refs[..., None]).any(1)  # (N, Wj, Wr)
        free_cum = (~claimed).long().cumsum(-1)
        samep = update[:, None, :] & (p_j[:, None, :] == p_j[:, :, None])
        rank = (samep & (arW[None, :] < arW[:, None])).sum(-1)
        r_j = (free_cum > rank[:, :, None]).long().argmax(-1)
        put = update & (clen <= S)  # the model's write contract
        cur = pos_row.gather(2, pcl[:, :, None])[..., 0]
        pos_row = pos_row.scatter(2, pcl[:, :, None], torch.where(put, r_j, cur)[..., None])
        return r_j, pos_row

    BOOK = ("scores", "h1", "h2", "last", "lblank", "lm_seq", "lm_len", "stimes", "st_len",
            "next_lps", "clen", "pos_row")

    def _frame(self, carry: dict, cand, am, valid, t: int, C: int, lm_step: bool) -> dict:
        """One frame: `cand`, `am`, `valid` (N, K); `lm_step` False when no
        candidate of this frame is a non-blank id (no beam can emit)."""
        N, W = cand.shape[0], self.W
        book = {k: carry[k] for k in self.BOOK}
        book["t"] = t
        new_book, tok, update = self._bookkeeping(book, cand, am, valid, C)
        # recordings without a candidate carry over unchanged (the host's
        # `continue`); the cache stays out of this select
        has = valid.any(-1)  # (N,)
        out = {k: torch.where(has.view((N,) + (1,) * (new_book[k].dim() - 1)),
                              new_book[k], book[k]) for k in self.BOOK}
        out["cache"] = carry["cache"]
        if lm_step:
            update = update & has[:, None]
            r_j, pos_row = self._alloc(out["clen"], out["pos_row"], update)
            row_off = (torch.arange(N, device=self.device) * W)
            Wt, S1 = N * W, self.S + 1
            # a row that does not write may hold blank, past the LM's vocab:
            # its logits are junk either way (JAX's lookup fills NaN there)
            tok = tok.clamp(max=self.model.vocab_size - 1)
            cache, clen, lps = self._lm_apply(
                carry["cache"], out["clen"].reshape(Wt), tok.reshape(Wt), update.reshape(Wt),
                pos_row=(pos_row + row_off[:, None, None]).reshape(Wt, S1),
                write_rows=(r_j + row_off[:, None]).reshape(Wt))
            out["next_lps"] = torch.where(update[..., None], lps.view(N, W, -1), out["next_lps"])
            out["cache"], out["clen"], out["pos_row"] = cache, clen.view(N, W), pos_row
        return out

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run_search_many(self, logits_list, decode: bool = False) -> List:
        """Search N recordings in lockstep on the device (rows stacked, the
        per-frame bookkeeping shared).  Returns per-recording ids (or text);
        `self.timestamps` / `self.score` hold per-recording lists after."""
        recs = [np.asarray(lg, np.float32) for lg in logits_list]
        C = recs[0].shape[1]
        assert all(r.shape[1] == C for r in recs)
        blank = self.blank_id if self.blank_id is not None else C - 1
        top_nonblank = C - 2 if blank == C - 1 else C - 1
        if top_nonblank >= self.model.vocab_size:
            raise ValueError(
                f"LM vocab {self.model.vocab_size} cannot score emit candidates up to id "
                f"{top_nonblank} (C={C}, blank={blank})")
        # every recording padded to one bucketed length with frames that give
        # no candidate (only id 0 clears the threshold, and id 0 is never
        # proposed)
        T = max(r.shape[0] for r in recs)
        Tb = -(-T // self.frame_bucket) * self.frame_bucket
        padded = np.full((len(recs), Tb, C), NEG, np.float32)
        padded[:, :, 0] = 0.0
        for n, r in enumerate(recs):
            padded[n, : r.shape[0]] = r
        dev_logits = torch.from_numpy(padded).to(self.device)
        del padded
        carry = self._init_carry(len(recs))
        for t0 in range(0, Tb, self.frame_bucket):
            seg = [self._candidates(dev_logits[n, t0 : t0 + self.frame_bucket])
                   for n in range(len(recs))]
            cand, am, valid = (torch.stack(x) for x in zip(*seg))  # (N, Tseg, K)
            # the segment's one host read: has frame t a candidate anywhere,
            # and may it emit?  A frame with none leaves every recording's
            # search as it was (the padding, for one), so it is skipped
            flags = torch.stack([valid.any(-1).any(0),
                                 (valid & (cand != blank)).any(-1).any(0)]).cpu().numpy()
            for i in np.flatnonzero(flags[0]):
                carry = self._frame(carry, cand[:, i], am[:, i], valid[:, i], t0 + int(i), C,
                                    bool(flags[1, i]))
        lm_seq, lm_len = carry["lm_seq"].cpu().numpy(), carry["lm_len"].cpu().numpy()
        stimes, st_len = carry["stimes"].cpu().numpy(), carry["st_len"].cpu().numpy()
        scores = carry["scores"].cpu().numpy()
        if int(lm_len.max(initial=0)) >= self.S:
            raise RuntimeError(
                f"beam reached max_tokens={self.S}: size max_tokens for the worst-case "
                f"emission count (one per candidate frame)")
        out, self.timestamps, self.score = [], [], []
        for n in range(len(recs)):
            ids = [int(i) for i in lm_seq[n, 0, : int(lm_len[n, 0])]]
            self.timestamps.append([int(x) for x in stimes[n, 0, 1 : int(st_len[n, 0])]])
            self.score.append(float(scores[n, 0]))
            out.append(self.tokenizer.decode(ids)
                       if decode and self.tokenizer is not None else ids)
        return out

    def run_search(self, log_probs: np.ndarray, decode: bool = False):
        """log_probs (T, C) -> token ids of the best beam (or text).  After
        the call `self.timestamps` holds the emission frame of each id and
        `self.score` the winning beam's merged score."""
        out = self.run_search_many([log_probs], decode=decode)
        self.timestamps = self.timestamps[0]
        self.score = self.score[0]
        return out[0]


def rescore_device(model, logits_list, tokenizer=None, decode: bool = False,
                   batch_recordings: int = 1, **kwargs) -> List:
    """Rescore recordings with the device search, `batch_recordings` a
    search.  One is usually best: batched recordings run in lockstep, so
    every recording pays for the union of their emitting frames.  Returns
    the results in input order."""
    searcher = DeviceFrameSyncBeamSearch(model, tokenizer=tokenizer, **kwargs)
    out: List = []
    B = max(1, batch_recordings)
    for i in range(0, len(logits_list), B):
        out.extend(searcher.run_search_many(logits_list[i : i + B], decode=decode))
    return out
