"""Optimizer factory (counterpart of lcasr_tpu/optim/factory.py).

name in {madgrad, mirror_madgrad, adam (coupled L2), adamw (decoupled)},
with the global-norm gradient clip chained in front (the JAX factory's
`optax.clip_by_global_norm`, reference clip 0.8) and the learning rate set
from the host-side scheduler by `set_learning_rate`.  The decay mask
(`models.base.decay_mask`, name -> bool) splits the parameters into a
decay group and a no-decay group.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from lcasr_torch.optim.madgrad import MADGRAD, MirrorMADGRAD


class ClippedOptimizer:
    """`inner` behind a global-norm clip of the gradients in `p.grad`:
    g -> g * clip_value / norm when norm >= clip_value (optax's rule)."""

    def __init__(self, inner: torch.optim.Optimizer, clip_value: float):
        self.inner = inner
        self.clip_value = clip_value

    @property
    def param_groups(self):
        return self.inner.param_groups

    @torch.no_grad()
    def clip_(self, norm: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """Clip by `norm`, or by the norm of the gradients here when it is
        None (under a mesh the Trainer passes the global norm of gradients
        that are sharded over ranks)."""
        if not self.clip_value or self.clip_value <= 0:
            return None
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if not grads:
            return None
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)).float())
        # a select on the device (no host sync); multi-tensor scaling
        factor = torch.where(norm < self.clip_value, torch.ones_like(norm),
                             self.clip_value / norm)
        torch._foreach_mul_(grads, factor)
        return norm

    def step(self, norm: Optional[torch.Tensor] = None) -> None:
        self.clip_(norm)
        self.inner.step()

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state) -> None:
        self.inner.load_state_dict(state)


def param_groups(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 weight_decay: float,
                 weight_decay_mask: Optional[Dict[str, bool]] = None):
    named = list(named_params)
    if weight_decay_mask is None or not weight_decay:
        return [{"params": [p for _, p in named], "weight_decay": weight_decay}]
    decay = [p for n, p in named if weight_decay_mask[n]]
    no_decay = [p for n, p in named if not weight_decay_mask[n]]
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def build_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    name: str,
    lr: float = 1e-3,
    weight_decay: float = 0.0,
    momentum: float = 0.9,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: Optional[float] = None,
    clip_value: float = 0.8,
    weight_decay_mask: Optional[Dict[str, bool]] = None,
    decouple_decay: bool = False,
) -> ClippedOptimizer:
    groups = param_groups(named_params, weight_decay, weight_decay_mask)
    name = name.lower()
    if name == "madgrad":
        inner = MADGRAD(groups, lr=lr, momentum=momentum, weight_decay=weight_decay,
                        eps=1e-6 if eps is None else eps, decouple_decay=decouple_decay)
    elif name in ("mirror_madgrad", "mirrormadgrad"):
        inner = MirrorMADGRAD(groups, lr=lr, momentum=momentum, weight_decay=weight_decay,
                              eps=0.0 if eps is None else eps,
                              decouple_decay=decouple_decay)
    elif name in ("adam", "adamw"):
        # 'adam' adds the decay to the gradient (coupled L2, torch Adam's
        # weight_decay); 'adamw' decays the weights (torch AdamW)
        cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
        inner = cls(groups, lr=lr, betas=tuple(betas), eps=1e-8 if eps is None else eps,
                    weight_decay=weight_decay)
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    return ClippedOptimizer(inner, clip_value)


def set_learning_rate(optimizer: ClippedOptimizer, lr: float) -> None:
    """Write the scheduler's current lr into every param group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
