"""Weights made from the seed on the device, the same for the program and the
reference.

The model is built on the meta device (no host-side initialisation), moved
to empty device memory, and every parameter and floating buffer is filled
from one `torch.Generator` on the card in two calls, one draw of normals and
one of uniforms for all the tensors together.  Each tensor takes its slice
by a rule on its leaf name, after `init_weights_` of the port's flagship
(weights N(0, 1/fan_in), biases N(0, 0.02^2), norm scales 1 + N(0, 0.1^2),
batch-renorm running means N(0, 0.1^2) and stds U(0.5, 1.5)), with the
Mamba mixer's own shapes: S4D-real `A_log`, skip `D` near 1, and a
`dt_proj_bias` that is the inverse softplus of a log-uniform step in
[0.001, 0.1].  The rotary frequencies are no weights: the program's module
computes its own, and the reference its own.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

_SKIP = ("inv_freq", "num_batches_tracked")


def _rule(name: str, shape: Tuple[int, ...]):
    """(kind, a, b): the value is a + b * draw, where the draw is a standard
    normal ('normal') or uniform on [0, 1) ('uniform'); 'a_log' and
    'dt_bias' are the Mamba's."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_std":
        return ("uniform", 0.5, 1.0)
    if leaf == "running_mean":
        return ("normal", 0.0, 0.1)
    if leaf == "A_log":
        return ("a_log", 0.0, 0.0)
    if leaf == "dt_proj_bias":
        return ("dt_bias", 0.0, 0.0)
    if leaf == "D" or leaf == "scale" or (leaf == "weight" and len(shape) == 1):
        return ("normal", 1.0, 0.1)
    if leaf.endswith("bias"):
        return ("normal", 0.0, 0.02)
    if leaf in ("dt_proj_kernel",) or leaf.endswith("_kernel") and len(shape) == 2:
        return ("normal", 0.0, shape[0] ** -0.5)  # (K or rank, channels): fan_in first
    if leaf == "depthwise_kernel":
        return ("normal", 0.0, shape[-1] ** -0.5)
    fan_in = int(math.prod(shape[1:])) if len(shape) > 1 else shape[0]
    return ("normal", 0.0, fan_in ** -0.5)


def seeded_tensors(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, device
                   ) -> Dict[str, "torch.Tensor"]:
    """{name: fp32 tensor} for (name, shape) pairs, from `seed`: the same
    seed gives the same values on the same device."""
    import torch

    rules = [(n, s, _rule(n, s)) for n, s in shapes if n.rsplit(".", 1)[-1] not in _SKIP]
    n_normal = sum(math.prod(s) for _, s, r in rules if r[0] == "normal")
    n_uniform = sum(math.prod(s) for _, s, r in rules if r[0] in ("uniform", "dt_bias"))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    normal = torch.randn(max(n_normal, 1), generator=gen, device=device)
    uniform = torch.rand(max(n_uniform, 1), generator=gen, device=device)
    out, i, j = {}, 0, 0
    for name, shape, (kind, a, b) in rules:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = (a + b * normal[i:i + n]).view(shape)
            i += n
        elif kind == "uniform":
            out[name] = (a + b * uniform[j:j + n]).view(shape)
            j += n
        elif kind == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(uniform[j:j + n] * (hi - lo) + lo).clamp_min(1e-4)
            out[name] = (dt + torch.log(-torch.expm1(-dt))).view(shape)
            j += n
        else:  # a_log: log(1..N) along the state axis, every channel alike
            N = shape[-1]
            out[name] = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=device)
                                  ).expand(shape).contiguous()
    return out


def model_shapes(model) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter and floating buffer, in the model's
    order."""
    items = list(model.named_parameters()) + [
        (n, b) for n, b in model.named_buffers() if b.is_floating_point()]
    return [(n, tuple(t.shape)) for n, t in items]


def fill_(model, tensors: Dict[str, "torch.Tensor"]) -> None:
    """Copy the seeded tensors into the model's parameters and buffers."""
    import torch

    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    with torch.no_grad():
        for name, value in tensors.items():
            named[name].copy_(value)
