"""The training step, plain: the CTC loss of a chunk, its gradient, the
global-norm clip and MADGRAD, from the same weights and the same chunks the
harness gave the program.

One step: loss = sum over rows of weight_b * CTC nll_b (an impossible
alignment counts 0); the gradient of 100 * loss / (chunk frames x batch);
clipped to norm `clip` where its global norm reaches it; then MADGRAD
(arXiv:2101.11075) at the step's learning rate, momentum 0.9, eps 1e-6:
    lamb = (lr + eps) sqrt(k + 1);  nu += lamb g^2;  s += lamb g
    z = x0 - s / (nu^(1/3) + eps);  p = 0.9 p + 0.1 z
The batch-renorm running statistics move once a step.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from lcbench.reference.layers import fp32_products


def ctc_sum(log_probs, out_lengths, labels, label_lengths, weight, blank):
    """sum_b weight_b * nll_b, impossible alignments (too few frames for the
    labels and their repeats) at 0."""
    lp = log_probs.float()
    labels = labels.long()
    lab_len = label_lengths.long()
    in_len = out_lengths.long()
    same = (labels[:, 1:] == labels[:, :-1]) & (
        torch.arange(1, labels.shape[1], device=lp.device)[None, :] < lab_len[:, None])
    impossible = (in_len == 0) | (in_len < lab_len + same.sum(1))
    nll = F.ctc_loss(lp.transpose(0, 1), labels, in_len.clamp_min(1), lab_len, blank=blank,
                     reduction="none", zero_infinity=True)
    nll = torch.where(impossible, torch.zeros_like(nll), nll)
    return (nll * weight).sum()


class Madgrad:
    """MADGRAD over a dict of fp32 tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], momentum=0.9, eps=1e-6):
        self.eps, self.ck, self.k = eps, 1.0 - momentum, 0
        self.x0 = {n: t.clone() for n, t in params.items()}
        self.nu = {n: torch.zeros_like(t) for n, t in params.items()}
        self.s = {n: torch.zeros_like(t) for n, t in params.items()}

    def step(self, params, grads, lr: float):
        lamb = (torch.tensor(lr, dtype=torch.float32) + self.eps if lr != 0.0
                else torch.zeros((), dtype=torch.float32)) * math.sqrt(self.k + 1.0)
        for n, g in grads.items():
            lamb_d = lamb.to(g.device)
            self.nu[n] += lamb_d * g * g
            self.s[n] += lamb_d * g
            z = self.x0[n] - self.s[n] / (torch.pow(self.nu[n], 1.0 / 3.0) + self.eps)
            params[n] = (1.0 - self.ck) * params[n] + self.ck * z
        self.k += 1


def follow(forward, cfg, weights: Dict[str, torch.Tensor], trainable: List[str], stats,
           chunks: List[dict], lrs: List[float], clip: float, blank: int, device, q=None) -> dict:
    """Follow the program's first steps from the same weights over the same
    chunks (host arrays, as the program's loader gave them).  Returns
    {'loss': [per step], 'grad1': {name: the clipped gradient of step 1},
    'params': {name: after the last step}}."""
    params = {n: weights[n].clone() for n in trainable}
    opt = Madgrad(params)
    out = {"loss": []}
    with fp32_products():
        for step, (chunk, lr) in enumerate(zip(chunks, lrs)):
            leaves = {n: t.detach().requires_grad_(True) for n, t in params.items()}
            p = dict(weights)
            p.update(leaves)
            audio = torch.from_numpy(chunk["audio"]).to(device)
            lengths = torch.from_numpy(chunk["audio_lengths"]).to(device)
            for s in stats.values():
                s.pop("next", None)
            log_probs, out_len = forward(p, cfg, audio, lengths, train=True, stats=stats, q=q,
                                         remat=True)
            loss = ctc_sum(log_probs, out_len, torch.from_numpy(chunk["labels"]).to(device),
                           torch.from_numpy(chunk["label_lengths"]).to(device),
                           torch.from_numpy(chunk["weight"]).to(device), blank)
            B, _, T = chunk["audio"].shape
            grads = torch.autograd.grad(loss * (100.0 / (T * B)), list(leaves.values()))
            out["loss"].append(float(loss.detach()))
            grads = dict(zip(leaves, (g.detach() for g in grads)))
            del log_probs, loss, leaves
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
            factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            grads = {n: g * factor for n, g in grads.items()}
            if step == 0:
                out["grad1"] = {n: g.clone() for n, g in grads.items()}
            opt.step(params, grads, lr)
            for s in stats.values():  # the running statistics move once a step
                s["running_mean"], s["running_std"] = s.pop("next")
                s["steps"] += 1
    out["params"] = params
    return out
