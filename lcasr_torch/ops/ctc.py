"""CTC loss (counterpart of lcasr_tpu/ops/ctc.py `ctc_loss`).

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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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
    """CTC negative log-likelihood, fp32; blank defaults to the last class."""
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
    nll = F.ctc_loss(
        lp.transpose(0, 1), labels, input_lengths.clamp_min(1), label_lengths,
        blank=blank_id, reduction="none", zero_infinity=True,
    )
    # the select, not a multiply, gives the sentinel rows a zero gradient
    nll = torch.where(impossible, torch.full_like(nll, SENTINEL), nll)
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return (nll / label_lengths.clamp_min(1)).mean()
    return nll
