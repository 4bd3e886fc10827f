"""CTC losses (counterparts of lcasr_tpu/ops/ctc.py `ctc_loss` and
`wctc_loss`).

The JAX package scans the alpha recursion with `lax.scan` and writes the
Graves gradient by hand; that is no Pallas kernel, and here one PyTorch op,
`torch.nn.functional.ctc_loss`, computes the same negative log-likelihood.
What this wrapper adds are the JAX function's conventions:

  * blank may be any class id (the trainer passes blank = vocab size, the
    last class);
  * an impossible alignment (input_length == 0, or fewer frames than labels
    plus repeated neighbours) gives the finite lattice sentinel 1e30 with a
    zero gradient, not inf: the trainer's non-finite skip must not fire for
    it, and it filters rows at nll >= 1e29 instead;
  * zero-length labels are the all-blank path;
  * `segment_size` changes only how much memory the JAX backward keeps
    (segment-entry alpha checkpoints); the value and the gradient are the
    same, so it is accepted and changes nothing here.

PyTorch's CTC backward returns exp(log_probs) - posteriors, the gradient
with respect to the logits of a log_softmax; for log-probs that come out
of a log_softmax, as the model's do, the gradient that reaches the logits
is the exact one.

`wctc_loss` (wild-card CTC) is plain torch with autograd: the JAX function
is a `lax.scan` with no Pallas kernel, and no PyTorch op computes it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lcasr_torch.utils.profiling import backward_span, span

SENTINEL = 1e30  # -(-1e30): the JAX lattice's nll of an impossible alignment


def min_frames(labels: torch.Tensor, label_lengths: torch.Tensor) -> torch.Tensor:
    """(B,) frames a CTC alignment needs: labels plus repeated neighbours
    (each repeat needs a blank between)."""
    U = labels.shape[1]
    if U < 2:
        return label_lengths.clone()
    same = labels[:, 1:] == labels[:, :-1]
    inside = torch.arange(1, U, device=labels.device)[None, :] < label_lengths[:, None]
    return label_lengths + (same & inside).sum(1)


def ctc_loss(
    log_probs: torch.Tensor,  # (B, T, C) log-probs
    labels: torch.Tensor,  # (B, U) padded label ids
    input_lengths: torch.Tensor,  # (B,)
    label_lengths: torch.Tensor,  # (B,)
    blank_id: Optional[int] = None,
    reduction: str = "sum",
    segment_size: Optional[int] = None,  # noqa: ARG001 (memory only in JAX)
) -> torch.Tensor:
    """CTC negative log-likelihood, fp32; blank defaults to the last class.
    The spans `ctc_fwd` (this call) and `ctc_bwd` (PyTorch's CTC backward,
    on the thread that runs it) time it in a profiler trace."""
    with span("ctc_fwd"):
        if blank_id is None:
            blank_id = log_probs.shape[-1] - 1
        lp = log_probs.float()
        device = lp.device
        input_lengths = input_lengths.to(device=device, dtype=torch.long)
        label_lengths = label_lengths.to(device=device, dtype=torch.long)
        labels = labels.to(device=device, dtype=torch.long)
        impossible = (input_lengths == 0) | (input_lengths < min_frames(labels, label_lengths))
        if labels.shape[1] == 0:  # PyTorch wants a label axis
            labels = torch.full((labels.shape[0], 1), blank_id, dtype=torch.long, device=device)
        lp_t = lp.transpose(0, 1)
        nll = F.ctc_loss(
            lp_t, labels, input_lengths.clamp_min(1), label_lengths,
            blank=blank_id, reduction="none", zero_infinity=True,
        )
        backward_span("ctc_bwd", nll, lp_t)
        # the select, not a multiply, gives the sentinel rows a zero gradient
        nll = torch.where(impossible, torch.full_like(nll, SENTINEL), nll)
        if reduction == "sum":
            return nll.sum()
        if reduction == "mean":
            return (nll / label_lengths.clamp_min(1)).mean()
        return nll


NEG_INF = -1e30  # the JAX lattice's log of zero


def wctc_loss(
    log_probs: torch.Tensor,  # (B, T, C) log-probs
    labels: torch.Tensor,  # (B, U) padded label ids, U >= 1
    input_lengths: torch.Tensor,  # (B,)
    label_lengths: torch.Tensor,  # (B,)
    blank_id: Optional[int] = None,
    mode: str = "soft",
    reduction: str = "sum",
) -> torch.Tensor:
    """Wild-card CTC (lcasr_tpu/ops/ctc.py `wctc_loss`, after the reference
    `lcasr/losses/wctc.py`): a wildcard state pinned to log-prob 0 at every
    frame feeds the first blank and label states, so an alignment may begin
    at any frame; the two end states are read out at every frame t <
    input_length, and the per-frame end log-likelihoods y_t combine by
    `mode`: "soft" (sum_t softmax(y)_t y_t), "max_prob" (max_t y_t) or
    "sum_prob" (logsumexp_t y_t).  The recursion runs over the batch at
    once, one frame a step; the gradient is autograd's."""
    if mode not in ("soft", "max_prob", "sum_prob"):
        raise ValueError(f"unknown wctc mode {mode!r}")
    if blank_id is None:
        blank_id = log_probs.shape[-1] - 1
    lp = log_probs.float()
    B, T, _ = lp.shape
    device = lp.device
    lab = labels.to(device=device, dtype=torch.long)
    lab_ext = torch.cat([lab, lab[:, :1]], 1)  # (B, U + 1)
    # [b, l1, b, l2, ..., b, lU, b, l1]
    tgt = torch.stack([torch.full_like(lab_ext, blank_id), lab_ext], -1).reshape(B, -1)
    tgt = torch.where(tgt < 0, torch.full_like(tgt, blank_id), tgt)
    S = tgt.shape[1]
    # the first label may skip in from the wildcard at any frame
    diff = torch.cat([torch.tensor([False, True], device=device).expand(B, 2),
                      tgt[:, 2:] != tgt[:, :-2]], 1)
    emissions = lp.gather(2, tgt[:, None, :].expand(B, T, S))  # (B, T, S)
    ll = label_lengths.to(device=device, dtype=torch.long)
    ends = torch.stack([1 + 2 * ll, 2 + 2 * ll], -1)  # augmented columns of the end states
    neg = torch.full((B, 1), NEG_INF, device=device)
    zero = torch.zeros((B, 1), device=device)

    def end_ll(alpha):
        # [NEG, wildcard] + alpha, so that a zero-length target reads the
        # wildcard, as the reference's augmented lattice does
        return torch.logsumexp(torch.cat([neg, zero, alpha], 1).gather(1, ends), 1)

    alpha = torch.cat([lp[:, 0, blank_id:blank_id + 1], emissions[:, 0, 1:2],
                       torch.full((B, S - 2), NEG_INF, device=device)], 1)
    ys = [end_ll(alpha)]
    for t in range(1, T):
        from_left = torch.cat([zero, alpha[:, :-1]], 1)
        from_skip = torch.where(diff, torch.cat([neg, zero, alpha[:, :-2]], 1),
                                torch.full_like(alpha, NEG_INF))
        alpha = torch.logsumexp(torch.stack([alpha, from_left, from_skip]), 0) + emissions[:, t]
        ys.append(end_ll(alpha))
    ys = torch.stack(ys, 1)  # (B, T)
    valid = (torch.arange(T, device=device)[None, :]
             < input_lengths.to(device=device, dtype=torch.long)[:, None])
    masked = torch.where(valid, ys, torch.full_like(ys, NEG_INF))
    if mode == "soft":
        sigma = (torch.softmax(masked, 1) * torch.where(valid, ys, torch.zeros_like(ys))).sum(1)
    elif mode == "max_prob":
        sigma = masked.max(1).values
    else:
        sigma = torch.logsumexp(masked, 1)
    nll = -sigma
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.mean()
    return nll
