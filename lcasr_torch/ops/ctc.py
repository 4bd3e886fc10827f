"""CTC losses (counterparts of lcasr_tpu/ops/ctc.py `ctc_loss` and
`wctc_loss`).

The JAX package scans the alpha recursion with `lax.scan` and writes the
Graves gradient by hand; that is no Pallas kernel.  Here CUDA tensors go
through a hand-written kernel, `lcasr_torch/csrc/ctc.cu` (`_CTCLoss`),
which spreads each batch row's lattice over a thread-block cluster
(`ctc_partition`).  Where a gradient is wanted the forward runs the alpha and
beta recursions at once (two clusters a row, meeting half-way in time) and
the gradient for a unit incoming gradient (`ctc_lattice`), and the backward
only scales it; else the forward runs alpha alone (`ctc_alpha`).  CPU
tensors go through `torch.nn.functional.ctc_loss`, the plain version, which
computes the same negative log-likelihood and gradient.  There is no
fallback from one to the other.  What this wrapper adds are the JAX
function's conventions:

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

Both routes' backward return PyTorch's gradient, exp(log_probs) -
posteriors, the gradient with respect to the logits of a log_softmax; for
log-probs that come out of a log_softmax, as the model's do, the gradient
that reaches the logits is the exact one.  Both zero the gradient of rows
whose nll is infinite (`zero_infinity`) and of frames at t >= input_length.

On the card nothing reads back to the host: the lengths stay on the device
and the largest lengths are the shapes (T frames, U label slots), so the
lattice is (B, T, 2U + 1) fp32, and with the (B, T, C) fp32 gradient it is
all the CTC allocates; the lattice is freed when the forward returns, and
the backward scales the gradient in place (a retained graph cannot run the
backward twice).  A lattice longer than the labels' longest row is padded
with states the kernels keep at log zero.

`wctc_loss` (wild-card CTC) is plain torch with autograd: the JAX function
is a `lax.scan` with no Pallas kernel, and no PyTorch op computes it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from lcasr_torch import kernels
from lcasr_torch.utils.profiling import backward_span, span

SENTINEL = 1e30  # -(-1e30): the JAX lattice's nll of an impossible alignment

_SRC = "ctc.cu"
MAX_THREADS = 1024  # a CTA's threads
MAX_CLUSTER = 16  # CTAs of a cluster (Hopper's non-portable size)
CARD_SMS = 132  # the H100's SMs: a batch's clusters shrink to fit them
PER_THREAD = (1, 2, 4)  # states a thread, as the kernels are built


class Partition(NamedTuple):
    """How a batch row's 2U + 1 states spread over the card: one cluster of
    `cluster` CTAs a row, `threads` a CTA, `per_thread` states a thread (in
    registers), and the lattice walked in `tiles` tiles of cluster x threads
    x per_thread states."""

    cluster: int
    threads: int
    per_thread: int
    tiles: int


def ctc_partition(batch: int, states: int) -> Partition:
    """The kernels' partition of a (batch, T, states) lattice.  Every step of
    the T-step chain waits for the slowest CTA, so a row's states are spread
    over as many CTAs as it takes to hold two a thread, up to a cluster of
    16, while the batch's clusters fit the card's SMs at once; the rest go
    to more states a thread (up to 4) and then to tiles.  T moves nothing:
    every partition runs the same T steps."""
    cluster = 1
    while (cluster < MAX_CLUSTER and cluster * MAX_THREADS * 2 < states
           and batch * cluster * 2 <= CARD_SMS):
        cluster *= 2
    per_cta = -(-states // cluster)
    per_thread = next((k for k in PER_THREAD if k * MAX_THREADS >= per_cta), PER_THREAD[-1])
    tiles = -(-per_cta // (per_thread * MAX_THREADS))
    threads = 32 * -(-per_cta // (per_thread * tiles * 32))
    return Partition(cluster, threads, per_thread, tiles)


def _lattice_args(lp: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
                  label_lengths: torch.Tensor, blank: int, part: Optional[Partition]):
    B, T, C = lp.shape
    U = labels.shape[1]
    for name, x, shape, dtype in (("log_probs", lp, (B, T, C), torch.float32),
                                  ("labels", labels, (B, U), torch.long),
                                  ("input_lengths", input_lengths, (B,), torch.long),
                                  ("label_lengths", label_lengths, (B,), torch.long)):
        if (tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous()
                or x.device != lp.device):
            raise ValueError(f"ctc kernels: {name} {tuple(x.shape)} {x.dtype} on {x.device} is "
                             f"not a contiguous {dtype} of shape {shape} on {lp.device}")
    if U < 1 or not 0 <= blank < C:
        raise ValueError(f"ctc kernels: {U} label slots, blank {blank} of {C} classes")
    part = part or ctc_partition(B, 2 * U + 1)
    head = (lp.data_ptr(), labels.data_ptr(), input_lengths.data_ptr(), label_lengths.data_ptr())
    return part, head, (B, T, C, U, blank, part.cluster, part.threads, part.per_thread, part.tiles)


def ctc_alpha(lp: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
              label_lengths: torch.Tensor, blank: int, part: Optional[Partition] = None):
    """(nll (B,), log-alpha (B, T, 2U + 1)), fp32, of `torch._ctc_loss` (the
    raw nll: +inf where no alignment exists); the lattice kernel's alpha
    pass alone, CUDA only.
    `part` replaces `ctc_partition`'s choice (tests and experiments)."""
    part, head, sizes = _lattice_args(lp, labels, input_lengths, label_lengths, blank, part)
    B, T = lp.shape[:2]
    nll = torch.empty((B,), dtype=torch.float32, device=lp.device)
    alpha = torch.empty((B, T, 2 * labels.shape[1] + 1), dtype=torch.float32, device=lp.device)
    lib = kernels.library(_SRC)
    with torch.cuda.device(lp.device):
        err = lib.lcasr_ctc_alpha(*head, alpha.data_ptr(), nll.data_ptr(), *sizes,
                                  torch.cuda.current_stream(lp.device).cuda_stream)
    kernels.check(lib, err, "ctc_alpha")
    kernels.launch_counts["ctc_alpha"] += 1
    return nll, alpha


def ctc_lattice(lp: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
                label_lengths: torch.Tensor, blank: int, part: Optional[Partition] = None):
    """(raw nll (B,), gradient of sum_b nll[b] with zero_infinity (B, T, C),
    alpha + beta (B, T, 2U + 1)), fp32: the lattice kernel (alpha and beta
    at once, two clusters a row) and the gradient kernel, CUDA only.  The
    sums hold only the rows' own states; the caller may drop them."""
    part, head, sizes = _lattice_args(lp, labels, input_lengths, label_lengths, blank, part)
    B, T, C = lp.shape
    f32 = dict(dtype=torch.float32, device=lp.device)
    nll = torch.empty((B,), **f32)
    sums = torch.empty((B, T, 2 * labels.shape[1] + 1), **f32)
    grad = torch.empty((B, T, C), **f32)
    edge = torch.empty((B, T, 2), **f32) if part.tiles > 1 else None
    flags = torch.zeros((B,), dtype=torch.int32, device=lp.device)
    lib = kernels.library(_SRC)
    with torch.cuda.device(lp.device):
        err = lib.lcasr_ctc_lattice(*head, sums.data_ptr(), nll.data_ptr(), grad.data_ptr(),
                                    None if edge is None else edge.data_ptr(), flags.data_ptr(),
                                    *sizes, torch.cuda.current_stream(lp.device).cuda_stream)
    kernels.check(lib, err, "ctc_lattice")
    kernels.launch_counts["ctc_alpha"] += 1
    kernels.launch_counts["ctc_beta"] += 1
    return nll, grad, sums


class _CTCLoss(torch.autograd.Function):
    """nll (B,) of fp32 log-probs (B, T, C) with zero_infinity.  Where a
    gradient is needed the forward runs both recursions and the gradient
    for a unit incoming gradient (`ctc_lattice`), and the backward scales
    it by the rows' incoming gradient, in place (span `ctc_bwd`); else the
    forward runs alpha alone (`ctc_alpha`)."""

    @staticmethod
    def forward(ctx, lp, labels, input_lengths, label_lengths, blank):
        ctx.grad = None
        if ctx.needs_input_grad[0]:
            nll, ctx.grad, _ = ctc_lattice(lp, labels, input_lengths, label_lengths, blank)
        else:
            nll, _ = ctc_alpha(lp, labels, input_lengths, label_lengths, blank)
        return torch.where(nll == math.inf, torch.zeros_like(nll), nll)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        if ctx.grad is None:
            raise RuntimeError("the CTC backward ran already: it scales its gradient in place")
        with span("ctc_bwd"):
            grad, ctx.grad = ctx.grad, None
            grad.mul_(grad_out.float()[:, None, None])
        return grad, None, None, None, None


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
    The spans `ctc_fwd` (this call) and `ctc_bwd` (the backward's kernels, or
    PyTorch's CTC backward on the CPU, on the thread that runs it) time it
    in a profiler trace."""
    with span("ctc_fwd"):
        if blank_id is None:
            blank_id = log_probs.shape[-1] - 1
        lp = log_probs.float()
        device = lp.device
        input_lengths = input_lengths.to(device=device, dtype=torch.long)
        label_lengths = label_lengths.to(device=device, dtype=torch.long)
        labels = labels.to(device=device, dtype=torch.long)
        impossible = (input_lengths == 0) | (input_lengths < min_frames(labels, label_lengths))
        if labels.shape[1] == 0:  # PyTorch and the kernels want a label axis
            labels = torch.full((labels.shape[0], 1), blank_id, dtype=torch.long, device=device)
        if device.type == "cuda":
            nll = _CTCLoss.apply(lp.contiguous(), labels.contiguous(),
                                 input_lengths.clamp_min(1), label_lengths.contiguous(), blank_id)
        else:
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
