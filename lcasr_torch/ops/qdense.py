"""W8A8 dynamic-quantised dense products for inference (counterpart of
lcasr_tpu/ops/qdense.py).

  * weights: symmetric int8 per output channel (scale = the channel's
    max |w| / 127), from the weight as the layer uses it, that is after its
    cast to the compute dtype (a bf16 model quantises the bf16-rounded
    weight, as flax's Dense casts its kernel before `dot_general`);
  * activations: symmetric int8 per row (token), quantised at every call;
  * an int8 x int8 -> int32 product, then one rescale
    `y_int32 * (row_scale * col_scale)` in fp32, a cast to the compute
    dtype, and the bias added after it.

Rounding is half to even (`torch.round`, as `jnp.rint`).  Rows of zeros
stay zero (their scale is clamped at 1e-8 and every value rounds to 0).

The int8 product is `torch._int_mm` (cuBLAS on the card, its own loop on
the CPU): JAX computes it with `lax.dot_general` outside any Pallas kernel.
On CUDA `_int_mm` takes more than 16 rows and inner and outer sizes that
are multiples of 8; `int8_matmul` pads with zeros to meet that (the greedy
step of the encoder-decoder and the LM's cached step give a few rows), and
never falls back to a float product: fp32 is not exact past 2^24, and
127^2 x 3072 is about 5e7.

A model takes `quant_w8a8` as a policy: False (off), True (every site),
"auto" (AUTO_SITES) or an iterable of site names.  Each `Dense` carries the
site its owner gave it (`Dense.site`), and `apply_quant_policy` switches
those of the policy's sites to the int8 path.  Quantised products have no
useful gradient (rounding's is zero), so the models refuse to train with a
policy set, as the JAX models do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# every GEMM family a model can tag
ALL_SITES = frozenset({
    "qkv",       # attention input projections
    "attn_out",  # attention output projection
    "ff",        # conformer / transformer feed-forward pairs
    "conv",      # the conformer conv's pointwise pair
    "decoder",   # CTC decoder head (ff + reprojection)
    "proj",      # generic projections (the Mamba mixer, the AED decoder's attention)
    "lm_head",   # LM / AED vocabulary head
})

# the JAX package's "auto" subset (its choice, from its own measurements)
AUTO_SITES = frozenset({"ff", "decoder", "lm_head"})

TRAIN_REFUSAL = ("quant_w8a8 is inference-only (rounding blocks gradients); "
                 "build the training model without it")


def resolve_quant_policy(flag) -> frozenset:
    """A `quant_w8a8` value -> the frozenset of sites it quantises."""
    if flag is True:
        return ALL_SITES
    if flag is None or flag is False:
        return frozenset()
    if isinstance(flag, str):
        sites = AUTO_SITES if flag == "auto" else frozenset({flag})
    else:
        sites = frozenset(flag)
    bad = sites - ALL_SITES
    if bad:
        raise ValueError(f"unknown quant_w8a8 site(s) {sorted(bad)}; valid: "
                         f"{sorted(ALL_SITES)} or 'auto'")
    return sites


def quant_site(flag, site: str) -> bool:
    """True when the policy `flag` quantises GEMMs tagged `site`."""
    return site in resolve_quant_policy(flag)


def apply_quant_policy(model: torch.nn.Module, flag) -> frozenset:
    """Switch every `Dense` of `model` whose site the policy names to the
    int8 path, and every other one back; the model keeps the policy as
    `quant_w8a8` and its sites as `quant_sites` (what its forward reads to
    refuse training).  The parameters do not change: any checkpoint serves
    quantised."""
    from lcasr_torch.ops.dense import Dense

    sites = resolve_quant_policy(flag)
    for m in model.modules():
        if isinstance(m, Dense):
            m.quant = m.site in sites
    model.quant_w8a8, model.quant_sites = flag, sites
    return sites


def quantize_rows(x: torch.Tensor):
    """(int8 values, fp32 scales (..., 1)): symmetric per row of the last axis."""
    xf = x.float()
    scale = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * t.dim()
    pad[2 * (t.dim() - 1 - dim) + 1] = size - t.shape[dim]
    return F.pad(t, pad)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32, exact, through
    `torch._int_mm` on a row-major a and a column-major w^T (the layout its
    cuBLAS path is known to take); zero rows and columns are added where
    its CUDA shape rules need them and cut off again."""
    M, K = a.shape
    N = w.shape[0]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp, Np) != (M, K, N):
        a = _pad_to(_pad_to(a, 0, Mp), 1, Kp)
        w = _pad_to(_pad_to(w, 0, Np), 1, Kp)
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:M, :N]


def w8a8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) @ weight (N, K)^T [+ bias] through int8, in x's dtype.
    `weight` and `bias` are already in the compute dtype."""
    w_q, w_scale = quantize_rows(weight)  # per output channel: (N, K), (N, 1)
    x_q, x_scale = quantize_rows(x)
    lead = x.shape[:-1]
    y = int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q)
    y = y.reshape(*lead, weight.shape[0]).float() * (x_scale * w_scale[:, 0])
    y = y.to(x.dtype)
    return y + bias if bias is not None else y
