"""Per-parameter gradient statistics (the port's copy of
lcasr_tpu/training/debug_hooks.py, after the reference's backward hooks
behind -debug_hooks): each gradient's norm, standard deviation and share
of near-zero values, and the global norm, under the JAX package's keys
(`grad/layers_3/attend/qkv_proj/kernel/norm`: the flax path that
`models/import_jax.flax_path` gives each parameter).  A transpose changes
none of the three, so the port's layouts give the JAX values.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from lcasr_torch.models.import_jax import flax_path


def grad_statistics(grads: Mapping[str, torch.Tensor],
                    near_zero_eps: float = 1e-8) -> Dict[str, float]:
    """{parameter name: gradient} -> flat dict of per-parameter statistics
    and `grad/global_norm`.  The statistics are computed on the gradients'
    device and brought to the host in one transfer; the global norm sums
    the squared norms in the flax tree's order, as the JAX function does."""
    items = sorted((flax_path(name, g)[1], g) for name, g in grads.items())
    if not items:
        return {"grad/global_norm": 0.0}
    rows = torch.stack([
        torch.stack([g.norm(), g.std(correction=0), (g.abs() < near_zero_eps).float().mean()])
        for g in (g.detach().float() for _, g in items)
    ]).tolist()
    flat: Dict[str, float] = {}
    sq_sum = 0.0
    for (path, _), (norm, std, frac) in zip(items, rows):
        key = "/".join(path)
        flat[f"grad/{key}/norm"] = norm
        flat[f"grad/{key}/std"] = std
        flat[f"grad/{key}/frac_near_zero"] = frac
        sq_sum += norm ** 2
    flat["grad/global_norm"] = sq_sum ** 0.5
    return flat
