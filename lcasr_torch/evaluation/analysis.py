"""Attention analysis and long-context attribution (counterpart of
lcasr_tpu/evaluation/analysis.py): how much of its context an
attention-based model uses.

  * `get_attention_weights`: every layer's (B, H, T', T') probabilities,
    through the exact plain attention (`return_attention_weights`);
  * `context_attribution`: |d max logit of one output frame / d input|,
    summed over mel bins: the gradient runs through the attention backward
    (K3 on the card);
  * `rotary_interpolation_probe`: the model's confidence under other rotary
    position-interpolation factors;
  * `attention_prob_rows` / `attention_summary`: probabilities of any query
    rows of any layer, from the post-rotary q, k, v of one forward through
    the kernel (`capture_qkv`), normalised by K1's lse
    (`ops.flash_attention.flash_attention_probs`), row block by row block:
    hour-scale analysis never forms a (T', T') tensor.

The JAX functions clone the model with the option set; here the option is
set on the model for the one call and put back after it (`_options`), so
the caller's model is left as it was.  Audio comes in as numpy and goes to
the model's device; results come back as numpy, except `_captured_qkv`'s
tensors, which stay on the device for the kernels.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from lcasr_torch.ops.flash_attention import flash_attention_probs, flash_attention_with_lse


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _inputs(model, audio, lengths):
    dev = _device(model)
    a = torch.as_tensor(np.asarray(audio, np.float32), device=dev)
    lens = None if lengths is None else torch.as_tensor(np.asarray(lengths), device=dev)
    return a, lens


@contextlib.contextmanager
def _options(model, **options):
    """The model with `options` set for the duration of the block."""
    before = {name: getattr(model, name) for name in options}
    try:
        for name, value in options.items():
            setattr(model, name, value)
        yield model
    finally:
        for name, value in before.items():
            setattr(model, name, value)


def _layers(inter: List[dict], key: str) -> list:
    return [node[key] for node in inter]


def get_attention_weights(model, audio: np.ndarray,
                          lengths: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Per-layer attention probabilities [(B, H, T', T'), ...]."""
    a, lens = _inputs(model, audio, lengths)
    with _options(model, return_attention_weights=True), torch.no_grad():
        inter = model(a, length=lens)["intermediates"]
    return [p.cpu().numpy() for p in _layers(inter, "attention_probs")]


def context_attribution(model, audio: np.ndarray, frame: int,
                        lengths: Optional[np.ndarray] = None) -> np.ndarray:
    """Gradient attribution of one output frame's max log-prob onto the
    input spectrogram: |d / d input| summed over batch and mel bins, (T,).
    Only the input's gradient is taken; the parameters' `grad` are left
    alone."""
    a, lens = _inputs(model, audio, lengths)
    a.requires_grad_(True)
    target = model(a, length=lens)["final_posteriors"][0, frame].max()
    (g,) = torch.autograd.grad(target, a)
    return g.abs().sum((0, 1)).cpu().numpy()


def rotary_interpolation_probe(model, spec: np.ndarray, factors=(1.0, 2.0, 4.0, 8.0),
                               lengths: Optional[np.ndarray] = None) -> Dict[float, dict]:
    """For each factor: the mean max log-prob and the share of frames whose
    argmax is blank, with the model's rotary positions divided by it."""
    a, lens = _inputs(model, spec, lengths)
    results = {}
    for f in factors:
        with _options(model, rotary_interpolation_factor=float(f)), torch.no_grad():
            lp = model(a, length=lens)["final_posteriors"].float()
        results[float(f)] = {
            "mean_max_logprob": float(lp.amax(-1).mean()),
            "blank_fraction": float((lp.argmax(-1) == lp.shape[-1] - 1).double().mean()),
        }
    return results


def _captured_qkv(model, audio, lengths=None) -> list:
    """One forward through the kernel with each layer's post-rotary
    (q, k, v, lengths) kept: 3 B T' H D values a layer in the model's dtype
    (about 70 MB a layer in bf16 at one hour, T' = 45,000, d_model 768)."""
    a, lens = _inputs(model, audio, lengths)
    with _options(model, capture_qkv=True), torch.no_grad():
        inter = model(a, length=lens)["intermediates"]
    return _layers(inter, "attention_qkv")


def attention_prob_rows(model, audio: np.ndarray, layer: int, rows,
                        lengths: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact probabilities of query rows `rows` = (start, n) of one layer,
    normalised by K1's lse: (B, H, n, T')."""
    q, k, v, lens = _captured_qkv(model, audio, lengths)[layer]
    with torch.no_grad():
        p = flash_attention_probs(q, k, v, lengths=lens, window=model.window,
                                  rows=tuple(rows))
    return p.cpu().numpy()


def topk_lower_index_first(p: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row of p >= 0,
    ties to the lower index, as `jax.lax.top_k` orders them (`torch.topk`
    promises no order among equal values, and rows with fewer than k
    nonzero entries tie at 0).  The keys are unique: a non-negative fp32's
    bits order as its value, and below them goes the reversed column."""
    n = p.shape[-1]
    bits = max(1, (n - 1).bit_length())
    bits_of = p.float().contiguous().view(torch.int32).to(torch.int64)
    rev = (1 << bits) - 1 - torch.arange(n, device=p.device, dtype=torch.int64)
    _, pos = torch.topk((bits_of << bits) | rev, k, dim=-1)
    return p.gather(-1, pos), pos


def attention_summary(model, audio: np.ndarray, lengths: Optional[np.ndarray] = None,
                      row_block: int = 512, top_k: int = 8) -> List[Dict[str, np.ndarray]]:
    """Per-layer long-context statistics, row block by row block: entropy
    (B, H, T'), expected absolute attention distance in subsampled frames
    (B, H, T'), and the top-k columns and their probabilities
    (B, H, T', k).  One forward captures every layer; then each layer's lse
    is one K1 launch, and each block of rows is one (B, H, row_block, T')
    fp32 tensor: the extra memory is O(row_block T')."""
    captured = _captured_qkv(model, audio, lengths)
    window = model.window
    out = []
    with torch.no_grad():
        for q, k, v, lens in captured:
            B, T, H, _ = q.shape
            Tk = k.shape[1]
            if lens is None:
                lens = torch.full((B,), Tk, dtype=torch.int32, device=q.device)
            _, lse = flash_attention_with_lse(q, k, v, lengths=lens, window=window)
            ent = torch.empty((B, H, T), device=q.device)
            dist = torch.empty_like(ent)
            tv = torch.empty((B, H, T, top_k), device=q.device)
            ti = torch.empty((B, H, T, top_k), dtype=torch.int64, device=q.device)
            cols = torch.arange(Tk, device=q.device, dtype=torch.float32)
            for start in range(0, T, row_block):
                n = min(row_block, T - start)
                p = flash_attention_probs(q, k, v, lengths=lens, window=window,
                                          rows=(start, n), lse=lse)
                sl = slice(start, start + n)
                ent[:, :, sl] = -(p * torch.log(p.clamp_min(1e-30))).sum(-1)
                rows = start + torch.arange(n, device=q.device, dtype=torch.float32)
                dist[:, :, sl] = (p * (cols[None, :] - rows[:, None]).abs()).sum(-1)
                tv[:, :, sl], ti[:, :, sl] = topk_lower_index_first(p, top_k)
                del p
            out.append({"entropy": ent.cpu().numpy(),
                        "expected_distance": dist.cpu().numpy(),
                        "topk_probs": tv.cpu().numpy(),
                        "topk_cols": ti.cpu().numpy()})
    return out
