"""Plain fp32 building blocks of both families.

Every function takes the weights as plain tensors, named as the program's
modules name them (the harness made them and hands the same to both), and
computes in fp32.  `q` is the precision of the matrix products: None for
fp32, or a `Quant`: fp8 (the control).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30  # a masked score


@contextlib.contextmanager
def fp32_products():
    """Matrix products and convolutions in full fp32: TF32 off while open."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 format with one scale a tensor (its largest
    |value| maps to the format's largest, `top`)."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).clamp(-top, top).to(dtype).float() * scale


class _Fp8Linear(torch.autograd.Function):
    """y = x W^T + b with x and W in e4m3 and, in the backward, the incoming
    gradient in e5m2 (the usual fp8 recipe)."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = _fp8(x, torch.float8_e4m3fn, 448.0), _fp8(w, torch.float8_e4m3fn, 448.0)
        ctx.save_for_backward(xq, wq)
        ctx.has_bias = b is not None
        y = xq @ wq.t()
        return y + b if b is not None else y

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2, 57344.0)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


class Quant:
    """The precision below bf16 for the control: every linear layer in fp8
    (`_Fp8Linear`), and the other products' operands (convolutions,
    attention) rounded to e4m3 in the forward, their gradient passed
    straight through."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x + (_fp8(x.detach(), torch.float8_e4m3fn, 448.0) - x).detach()


def _q(x, q):
    return q(x) if q is not None else x


def linear(x, w, b=None, q: Optional[Quant] = None):
    if q is not None:
        return _Fp8Linear.apply(x, w, b)
    return F.linear(x, w, b)


def layer_norm(x, scale, bias, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def rms_norm(x, scale, eps=1e-6):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def length_mask(lengths, n):
    return torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]


def subsampled_lengths(lengths, stages=3):
    """floor((L + 2 - 3) / 2 + 1) per stride-2 stage, in fp32 as the
    architecture defines it."""
    n = lengths.to(torch.float32)
    for _ in range(stages):
        n = torch.floor((n - 1.0) / 2.0 + 1.0)
    return n.to(torch.int32)


def dw_striding(x, p, prefix, q=None, act=F.silu):
    """(B, T, F) -> (B, T/8, F/8 * C), then the output projection: a 3x3
    stride-2 conv to C channels, then two stages of a 3x3 stride-2
    depthwise and a 1x1 pointwise conv, the activation after each, padding
    1; the channels last before flattening."""
    h = x[:, None]

    def conv(h, name, groups=1, stride=2, padding=1):
        return F.conv2d(_q(h, q), _q(p[f"{prefix}.{name}.weight"], q), p[f"{prefix}.{name}.bias"],
                        stride=stride, padding=padding, groups=groups)

    h = act(conv(h, "conv_in"))
    C = h.shape[1]
    i = 0
    while f"{prefix}.dw_conv_{i}.weight" in p:
        h = act(conv(conv(h, f"dw_conv_{i}", groups=C), f"pw_conv_{i}", stride=1, padding=0))
        i += 1
    B, C, T, Fo = h.shape
    h = h.permute(0, 2, 3, 1).reshape(B, T, Fo * C)
    return linear(h, p[f"{prefix}.out.weight"], p.get(f"{prefix}.out.bias"), q)


def rotary_tables(n, dim, base, interpolation=1.0, device=None):
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(n, dtype=torch.float32, device=device) / interpolation
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos[None, :, None, :] + torch.cat([-x2, x1], dim=-1) * sin[None, :, None, :]


def _attention_block(qb, k, v, kvalid, q=None):
    """Softmax attention of one block of query rows over every key."""
    s = torch.einsum("bhqd,bhkd->bhqk", _q(qb, q), _q(k, q))
    s = torch.where(kvalid[:, None, None, :], s, NEG)
    m = s.amax(-1, keepdim=True)
    e = torch.where(kvalid[:, None, None, :], torch.exp(s - m), 0.0)
    prob = e / e.sum(-1, keepdim=True).clamp_min(1e-37)
    return torch.einsum("bhqk,bhkd->bhqd", _q(prob, q), _q(v, q))


def attention(qx, kx, vx, lengths, q=None, block=2048, remat=False):
    """q, k, v (B, T, H, D) -> (B, T, H, D): non-causal softmax attention with
    scale D^-1/2, keys past each length masked, rows past it zero; in blocks
    of query rows (each recomputed in the backward when `remat`)."""
    B, T, H, D = qx.shape
    qh = qx.transpose(1, 2) * D ** -0.5
    kh, vh = kx.transpose(1, 2), vx.transpose(1, 2)
    kvalid = length_mask(lengths, T)
    outs = []
    for i in range(0, T, block):
        qb = qh[:, :, i:i + block]
        if remat and torch.is_grad_enabled():
            outs.append(checkpoint(_attention_block, qb, kh, vh, kvalid, q, use_reentrant=False))
        else:
            outs.append(_attention_block(qb, kh, vh, kvalid, q))
    out = torch.cat(outs, dim=2).transpose(1, 2)
    return torch.where(kvalid[:, :, None, None], out, 0.0)


def batch_renorm(x, p, prefix, pad_mask, state, train, eps=1e-3, momentum=0.01):
    """Batch renormalisation (arXiv:1702.03275) over (B, T, C).  Eval: the
    running statistics, no eps.  Train: the statistics of the frames that
    count (live rows up to the longest live row), corrected by r and d
    within the clip schedules of the step count, and the running
    statistics moved by `momentum` (in `state`, a dict of this layer's
    running_mean, running_std and steps)."""
    w, b = p[f"{prefix}.weight"], p[f"{prefix}.bias"]
    if not train:
        return w * (x - state["running_mean"]) / state["running_std"] + b
    if pad_mask is not None:
        row_len = (~pad_mask).sum(1).float()
        live = row_len > 0
        u_len = torch.where(live, row_len, torch.zeros_like(row_len)).max()
        cols = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
        keep = (live[:, None] & (cols[None, :] < u_len)).to(x.dtype)[..., None]
        count = keep.sum((0, 1)).clamp_min(1.0)
        mean = (x * keep).sum((0, 1)) / count
        var = (((x - mean) ** 2) * keep).sum((0, 1)) / count
    else:
        mean = x.mean((0, 1))
        var = ((x - mean) ** 2).mean((0, 1))
    std = torch.sqrt(var) + eps
    ra_mean, ra_std, t = state["running_mean"], state["running_std"], float(state["steps"])
    rmax = min(max(2.0 / 35000.0 * t + 25.0 / 35.0, 1.0), 3.0)
    dmax = min(max(5.0 / 20000.0 * t - 25.0 / 20.0, 0.0), 5.0)
    r = torch.clamp(std.detach() / ra_std, 1.0 / rmax, rmax)
    d = torch.clamp((mean.detach() - ra_mean) / ra_std, -dmax, dmax)
    y = (x - mean) / std * r + d
    if state.get("update", True):
        state["next"] = (ra_mean + momentum * (mean.detach() - ra_mean),
                         ra_std + momentum * (std.detach() - ra_std))
    return w * y + b


def causal_conv1d(x, kernel, bias):
    """Depthwise causal conv, x (B, L, C), kernel (K, C)."""
    K, C = kernel.shape
    out = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), kernel.t()[:, None, :], groups=C)
    return out.transpose(1, 2) + bias


def flip_with_lengths(x, lengths):
    """Reverse each row within its length; padding keeps its place."""
    L = x.shape[1]
    idx = torch.arange(L, device=x.device)[None, :]
    src = lengths.to(torch.int64)[:, None] - 1 - idx
    src = torch.where(src >= 0, src, idx)
    return torch.take_along_dim(x, src[..., None], dim=1)


def selective_scan(x, delta, A, B, C, D):
    """h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t;  y_t = C_t . h_t + D x_t,
    step by step in fp32.  x, delta (Bt, L, Dm); A (Dm, N); B, C (Bt, L, N)."""
    Bt, L, Dm = x.shape
    h = torch.zeros((Bt, Dm, A.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dt = delta[:, t, :, None]
        h = torch.exp(dt * A) * h + (dt * x[:, t, :, None]) * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1) + D * x


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
