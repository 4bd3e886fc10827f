"""MADGRAD and MirrorMADGRAD (counterpart of lcasr_tpu/optim/madgrad.py;
facebookresearch MADGRAD, arXiv:2101.11075).

State is fp32 whatever the parameter dtype.  The update is elementwise
PyTorch; the step count k is shared by every parameter, as in the JAX
transformation.  Weight decay goes by param group (`weight_decay` per
group), which is how the port expresses the JAX decay mask.

MADGRAD (momentum c = 1 - momentum), with lr_k = lr + eps when lr != 0:
    lamb = lr_k * sqrt(k + 1)
    nu  += lamb * g^2;   s += lamb * g
    z    = x0 - s / (nu^(1/3) + eps)
    p    = (1 - c) p + c z
MirrorMADGRAD:
    nu   = nu * sqrt(k / (k + 1)) + g^2
    z   -= lr_k * (k + 1)^(1/3) * g / (nu^(1/3) + eps)
    p    = (1 - c) p + c z
"""
from __future__ import annotations

import math

import torch


def _lr(lr: float, eps: float) -> torch.Tensor:
    """lr + eps in fp32, or 0 while a warmup holds lr at 0 (reference
    madgrad.py:101-102: the parameters stay frozen)."""
    lr32 = torch.tensor(lr, dtype=torch.float32)
    return lr32 + eps if lr != 0.0 else torch.zeros((), dtype=torch.float32)


def _rms(gss: torch.Tensor, eps: float) -> torch.Tensor:
    rms = torch.pow(gss, 1.0 / 3.0) + eps
    # eps = 0 with an all-zero history: inf keeps z at its start, not NaN
    return torch.where(rms == 0.0, torch.full_like(rms, math.inf), rms)


class MADGRAD(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 0.0, eps: float = 1e-6,
                 decouple_decay: bool = False):
        if not 0 <= momentum < 1:
            raise ValueError(f"Momentum {momentum} must be in the range [0,1)")
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      eps=eps, decouple_decay=decouple_decay))

    @torch.no_grad()
    def step(self, closure=None):
        # one multi-tensor (_foreach) pass per param group: a loop over the
        # tensors would launch ~15 small kernels for each of them
        for group in self.param_groups:
            eps, wd = group["eps"], group["weight_decay"]
            ck = 1.0 - group["momentum"]
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["grad_sum_sq"] = torch.zeros_like(p, dtype=torch.float32)
                    st["s"] = torch.zeros_like(p, dtype=torch.float32)
                    st["x0"] = p.detach().float().clone()
            states = [self.state[p] for p in ps]
            k = states[0]["step"]
            lr = _lr(group["lr"], eps).to(ps[0].device)
            lamb = lr * math.sqrt(k + 1.0)
            g = [p.grad.float() for p in ps]
            p32 = [p.float() for p in ps]
            if wd != 0.0 and not group["decouple_decay"]:
                g = torch._foreach_add(g, p32, alpha=wd)
            gss = [st["grad_sum_sq"] for st in states]
            s = [st["s"] for st in states]
            lg = torch._foreach_mul(g, lamb)
            torch._foreach_add_(gss, torch._foreach_mul(lg, g))
            torch._foreach_add_(s, lg)
            rms = [_rms(x, eps) for x in gss] if eps == 0.0 else torch._foreach_add(
                torch._foreach_pow(gss, 1.0 / 3.0), eps)
            z = torch._foreach_sub([st["x0"] for st in states], torch._foreach_div(s, rms))
            p_new = torch._foreach_add(torch._foreach_mul(p32, 1.0 - ck),
                                       torch._foreach_mul(z, ck))
            if wd != 0.0 and group["decouple_decay"]:
                p_new = torch._foreach_sub(p_new, torch._foreach_mul(p32, lr * wd))
            upd = torch._foreach_sub(p_new, p32)
            torch._foreach_add_(ps, [u.to(p.dtype) for u, p in zip(upd, ps)])
            for st in states:
                st["step"] += 1
        return None


class MirrorMADGRAD(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 0.0, eps: float = 0.0,
                 decouple_decay: bool = False):
        if not 0 <= momentum < 1:
            raise ValueError(f"Momentum {momentum} must be in the range [0,1)")
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      eps=eps, decouple_decay=decouple_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            eps, wd = group["eps"], group["weight_decay"]
            ck = 1.0 - group["momentum"]
            lr = _lr(group["lr"], eps)
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["grad_sum_sq"] = torch.zeros_like(p, dtype=torch.float32)
                    st["z"] = p.detach().float().clone()
                kf = torch.tensor(float(st["step"]), dtype=torch.float32)
                update_ratio = torch.sqrt(kf / (kf + 1.0)).to(p.device)
                lamb = torch.pow(kf + 1.0, 1.0 / 3.0).to(p.device)
                g = p.grad.float()
                p32 = p.float()
                if wd != 0.0:
                    if group["decouple_decay"]:
                        st["z"].sub_(lr.to(p.device) * wd * st["z"])
                    else:
                        g = g + wd * p32
                gss = st["grad_sum_sq"].mul_(update_ratio).add_(g * g)
                st["z"].sub_(lr.to(p.device) * lamb * g / _rms(gss, eps))
                p_new = (1.0 - ck) * p32 + ck * st["z"]
                p.add_((p_new - p32).to(p.dtype))
                st["step"] += 1
        return None
