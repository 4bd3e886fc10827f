"""Word/character error rate with insertion/deletion/substitution detail
(the port's copy of lcasr_tpu/evaluation/wer.py).

API-compatible with the reference metric (reference `lcasr/eval/wer.py:5-73`,
itself NeMo-style).  The JAX package aligns through rapidfuzz's C++ editops
when it is installed and through a pure-Python DP otherwise.  The port needs
neither: the Levenshtein DP runs one row at a time in numpy, the insertion
term of a row as a running minimum (`np.minimum.accumulate`).  Its totals
are the edit distance (what rapidfuzz gives); its S/I/D split is that of the
JAX pure-Python DP, which prefers a substitution, then an insertion, then a
deletion among equal costs, and always takes a match.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _edit_ops(ref: Sequence[str], hyp: Sequence[str]) -> Dict[str, int]:
    """Minimal-edit alignment counts.

    Row i of the DP holds, for every prefix hyp[:j], the (subs, ins, dels)
    of the chosen alignment of ref[:i] with it (the cost is their sum).
    Each cell takes the diagonal (a match, or a substitution when it is no
    dearer than the deletion from above), or the insertion from its left
    neighbour when that is cheaper, or as cheap and the diagonal candidate
    is a deletion.  The insertion chain is the running minimum of
    cand[j] - j; a cell that takes an insertion copies the counts of the
    nearest cell to its left that does not, plus one insertion for each
    step."""
    n, m = len(ref), len(hyp)
    vocab: Dict[str, int] = {}
    r = np.array([vocab.setdefault(w, len(vocab)) for w in ref], np.int64)
    h = np.array([vocab.setdefault(w, len(vocab)) for w in hyp], np.int64)
    j = np.arange(m + 1)
    subs = np.zeros(m + 1, np.int64)
    ins = j.copy()
    dels = np.zeros(m + 1, np.int64)
    for i in range(1, n + 1):
        cost = subs + ins + dels
        match = np.concatenate([[False], h == r[i - 1]])
        diag = cost[:-1]  # row i - 1, column j - 1
        # the candidate without an insertion, columns 1 .. m
        take_del = ~match[1:] & (cost[1:] < diag)
        c_sub = np.where(match[1:], diag, diag + 1)
        cand = np.where(take_del, cost[1:] + 1, c_sub)
        cs = np.concatenate([[subs[0]], np.where(take_del, subs[1:], subs[:-1] + ~match[1:])])
        ci = np.concatenate([[ins[0]], np.where(take_del, ins[1:], ins[:-1])])
        cd = np.concatenate([[i], np.where(take_del, dels[1:] + 1, dels[:-1])])
        cand = np.concatenate([[i], cand])
        # cost of the row: the running minimum of cand[k] + (j - k)
        row = np.minimum.accumulate(cand - j) + j
        left = np.concatenate([[np.iinfo(np.int64).max], row[:-1] + 1])
        is_del = np.concatenate([[False], take_del])
        take_ins = (left < cand) | ((left == cand) & is_del)
        src = np.maximum.accumulate(np.where(take_ins, 0, j))
        subs, ins, dels = cs[src], ci[src] + (j - src), cd[src]
    s, i_, d = int(subs[m]), int(ins[m]), int(dels[m])
    return {"substitutions": s, "insertions": i_, "deletions": d, "total": s + i_ + d}


def compute_measures(reference: str, hypothesis: str) -> Dict[str, int]:
    return _edit_ops(reference.split(), hypothesis.split())


def word_error_rate_detail(
    hypotheses: List[str], references: List[str], use_cer: bool = False
) -> Tuple[float, int, float, float, float]:
    """Returns (wer, n_ref_words, insertion_rate, deletion_rate, substitution_rate).

    Same contract as reference `lcasr/eval/wer.py:5-73`, including the
    empty-reference convention (all hypothesis words count as insertions).
    """
    if len(hypotheses) != len(references):
        raise ValueError(
            "hypotheses and references must have the same number of elements "
            f"(got {len(hypotheses)} and {len(references)})"
        )
    scores = words = 0
    ops = {"substitutions": 0, "insertions": 0, "deletions": 0}
    for h, r in zip(hypotheses, references):
        h_list = list(h) if use_cer else h.split()
        r_list = list(r) if use_cer else r.split()
        if len(r_list) == 0:
            errors = len(h_list)
            ops["insertions"] += errors
        else:
            m = _edit_ops(r_list, h_list)
            errors = m["total"]
            for k in ops:
                ops[k] += m[k]
        scores += errors
        words += len(r_list)

    if words != 0:
        return (
            scores / words,
            words,
            ops["insertions"] / words,
            ops["deletions"] / words,
            ops["substitutions"] / words,
        )
    inf = float("inf")
    return inf, 0, inf, inf, inf


def word_error_rate(hypotheses: List[str], references: List[str]) -> float:
    return word_error_rate_detail(hypotheses, references)[0]
