"""Flash attention: the CUDA kernels' wrappers, their plain versions and the
autograd Function (counterpart of lcasr_tpu/ops/flash_attention.py
`flash_attention`, `flash_attention_with_lse`, `flash_attention_bwd` and
the custom VJP `_fwd_rule` / `_bwd_rule`), and `flash_attention_probs`,
which normalises row blocks of probabilities by K1's lse.

Public layout (B, T, H, D), as in the JAX package.  The softmax scale is
folded into q in q's dtype before the kernel (the JAX `_fwd` does the same,
`q * jnp.asarray(scale, q.dtype)`), and the lse is in that scaled domain.
`lengths` masks keys and query rows alike: rows at or past
min(len, q_offset + Tq) give o = 0 and lse = -1e30, and so do rows whose
every key is masked.  The band and the lengths are in global coordinates,
shifted by `q_offset` / `kv_offset` (context parallelism).

On a CUDA tensor the forward launches the kernel in
`lcasr_torch/csrc/flash_attn_fwd.cu` (K1) or, with `LCASR_ATTN_FWD_DB=1`
(read at call time) and an attention that is not banded on both sides, the
double-buffered one in `csrc/flash_attn_fwd_db.cu` (K2), as the JAX `_fwd`
chooses; both compute the same function and `flash_attention_ref` is the
plain version of both.  The backward launches the kernels in
`csrc/flash_attn_bwd.cu`: the one-pass K3 when the attention is not banded
on both sides, else K4 (dq) and K5 (dk, dv), as `_bwd_impl` chooses; with
`LCASR_FUSED_ATTN_BWD=0` the split pair runs always.  In bf16, K1-K5 read
their inputs by TMA (and K3 adds dq into its fp32 buffer by TMA reduce-add,
by atomics at D = 256),
so those tensors must meet `_tma_layout_ok`.  All take bf16 or
fp32 and D in 32, 64, 128, 256, and they raise on anything else.  On a CPU tensor
they run `flash_attention_ref` / `flash_attention_bwd_ref`, the plain fp32
versions.  There is no fallback from one to the other.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from lcasr_torch import kernels
from lcasr_torch.ops.attention import NEG_INF, length_mask, window_mask
from lcasr_torch.utils.profiling import span

KERNEL_HEAD_DIMS = (32, 64, 128, 256)  # the forward K1, K2
BWD_KERNEL_HEAD_DIMS = (32, 64, 128, 256)  # the backward K3-K5
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_SRC = "flash_attn_fwd.cu"
_DB_SRC = "flash_attn_fwd_db.cu"
_BWD_SRC = "flash_attn_bwd.cu"


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else q.shape[-1] ** -0.5


def _scaled(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    return q * torch.tensor(_scale(q, scale), dtype=q.dtype, device=q.device)


def _lengths(lengths, B: int, Tk: int, device) -> torch.Tensor:
    if lengths is None:
        return torch.full((B,), Tk, dtype=torch.int32, device=device)
    return torch.as_tensor(lengths, device=device).to(torch.int32)


def _valid_pairs(q, k, lengths, window, q_offset, kv_offset) -> torch.Tensor:
    """(B, Tq, Tk) bool: the (row, col) pairs the masks leave valid."""
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    lens = _lengths(lengths, B, Tk, q.device)
    # global row r < min(len, q_offset + Tq) is r < len for every local row;
    # likewise for columns
    valid = (length_mask(lens, Tq, offset=q_offset)[:, :, None]
             & length_mask(lens, Tk, offset=kv_offset)[:, None, :])
    band = window_mask(Tq, Tk, window, q_offset=q_offset - kv_offset, device=q.device)
    if band is not None:
        valid = valid & band[None]
    return valid


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    window: Tuple[int, int] = (-1, -1),
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernels K1 and K2: eager fp32 math on
    the same pre-scaled q, the same masks and lse conventions.  Returns
    (o in q's dtype, lse (B, H, Tq) fp32)."""
    valid = _valid_pairs(q, k, lengths, window, q_offset, kv_offset)
    s = torch.einsum("bthd,bshd->bhts", _scaled(q, scale).float(), k.float())
    s = s.masked_fill(~valid[:, None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    p = e / torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhts,bshd->bthd", p, v.float())
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, NEG_INF))
    return o.to(q.dtype), lse[..., 0]


def _tma_layout_ok(shape, strides, dtype, data_ptr: int) -> bool:
    """Whether a (B, T, H, D) tensor can be read (K3's fp32 dq buffer:
    reduced into) through the bf16 kernels' TMA tensor maps: unit stride on D, a 16-byte-aligned base, byte strides of
    B, T and H that are multiples of 16 (a dimension of size 1 is never
    stepped, and the kernel ignores its stride), and D rows whose byte
    length is a multiple of 16."""
    size = torch.empty((), dtype=dtype).element_size()
    if len(shape) != 4 or strides[-1] != 1 or data_ptr % 16 or (shape[-1] * size) % 16:
        return False
    return all(n == 1 or (s * size) % 16 == 0 for n, s in zip(shape[:3], strides[:3]))


def _check_kernel_inputs(q, k, v, do=None):
    named = (("q", q), ("k", k), ("v", v)) + ((("do", do),) if do is not None else ())
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on cuda")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, T, H, D)")
        if t.stride(-1) != 1:
            raise ValueError(
                f"flash_attention: {name} needs a unit stride on D (got "
                f"{t.stride()}); make it contiguous first"
            )
        if t.dtype == torch.bfloat16 and not _tma_layout_ok(
            t.shape, t.stride(), t.dtype, t.data_ptr()
        ):
            raise ValueError(
                f"flash_attention: bf16 {name} needs a 16-byte-aligned base and "
                f"B, T, H strides that are multiples of 8 for the kernels' TMA and "
                f"16-byte loads (got {t.stride()}); make it contiguous first"
            )
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash_attention kernel takes bf16 or fp32, not {q.dtype}")
    D = q.shape[-1]
    dims = KERNEL_HEAD_DIMS if do is None else BWD_KERNEL_HEAD_DIMS
    if D not in dims:
        raise ValueError(f"flash_attention kernel supports head_dim {dims}, got {D}")
    B, _, H, _ = q.shape
    if k.shape[0] != B or k.shape[2:] != q.shape[2:] or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {q.shape}, k {k.shape}, v {v.shape}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"flash_attention: do {do.shape} is not shaped like q {q.shape}")


def _double_buffered_fwd(window: Tuple[int, int]) -> bool:
    """K2 under LCASR_ATTN_FWD_DB=1 unless the band is two-sided (the gate of
    the JAX `_fwd`)."""
    banded = window[0] >= 0 and window[1] >= 0
    return not banded and os.environ.get("LCASR_ATTN_FWD_DB", "0") == "1"


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    window: Tuple[int, int] = (-1, -1),
    softmax_scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, Tq, H, D), lse (B, H, Tq) fp32)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, lengths, window, softmax_scale,
                                   int(q_offset), int(kv_offset))
    _check_kernel_inputs(q, k, v)
    B, Tq, H, D = q.shape
    qs = _scaled(q, softmax_scale)
    lens = _lengths(lengths, B, k.shape[1], q.device).contiguous()
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    name = _launch_fwd(qs, k, v, o, lse, lens, window, q_offset, kv_offset,
                       _double_buffered_fwd(window))
    kernels.launch_counts[name] += 1
    return o, lse


def _launch_fwd(qs, k, v, o, lse, lens, window, q_offset, kv_offset, db: bool) -> str:
    """One launch of K1 (db: K2) on checked inputs: q already scaled, the
    int32 lengths and the outputs made by the caller.  Raises on the
    kernel's error; returns the kernel's launch-counter name, which the
    caller counts."""
    B, Tq, H, D = qs.shape
    if db:
        name, lib = "flash_attention_fwd_db", kernels.library(_DB_SRC)
        launch = lib.lcasr_flash_attn_fwd_db
    else:
        name, lib = "flash_attention_fwd", kernels.library(_SRC)
        launch = lib.lcasr_flash_attn_fwd
    with torch.cuda.device(qs.device):
        err = launch(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), lens.data_ptr(), B, H, Tq, k.shape[1], D,
            int(qs.dtype == torch.float32),
            *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(q_offset), int(kv_offset), int(window[0]), int(window[1]),
            torch.cuda.current_stream(qs.device).cuda_stream,
        )
    kernels.check(lib, err, name)
    return name


def flash_attention_probs(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    window: Tuple[int, int] = (-1, -1),
    softmax_scale: Optional[float] = None,
    rows: Optional[Tuple[int, int]] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention probabilities of the query rows `rows` = (start, n)
    (None: all), (B, H, n, Tk) fp32, normalised by the forward kernel's
    own lse (counterpart of the JAX `flash_attention_probs`).

    The lse comes from K1 (`flash_attention_with_lse`; pass `lse` back in to
    reuse it across row blocks).  The scores of the requested rows are
    recomputed as the kernel computes them: the scale folded into q in q's
    dtype, the product accumulated in fp32 (bf16 values are exact in fp32,
    so the fp32 product of the upcast operands is that accumulation), the
    masks in global coordinates.  Rows whose every key is masked (lse
    -1e30: past the length, or an empty band) are all zero.  Memory is
    O(n Tk): stream row blocks to go through any length."""
    B, T, H, D = q.shape
    Tk = k.shape[1]
    lens = _lengths(lengths, B, Tk, q.device)
    if lse is None:
        _, lse = flash_attention_with_lse(q, k, v, lens, window, softmax_scale,
                                          q_offset, kv_offset)
    start, n = rows if rows is not None else (0, T)
    qs = _scaled(q[:, start:start + n], softmax_scale)
    s = torch.einsum("bnhd,bmhd->bhnm", qs.float(), k.float())
    g_rows = q_offset + start + torch.arange(n, device=q.device)
    g_cols = kv_offset + torch.arange(Tk, device=q.device)
    valid = ((g_cols[None, None, None, :] < lens[:, None, None, None])
             & (g_rows[None, None, :, None] < lens[:, None, None, None]))
    rel = g_rows[:, None] - g_cols[None, :]
    left, right = window
    if right >= 0:
        valid = valid & (rel >= -right)
    if left >= 0:
        valid = valid & (rel <= left)
    lse_r = lse[:, :, start:start + n].float()
    live = lse_r > NEG_INF / 2
    valid = valid & live[..., None]
    p = torch.exp(s - torch.where(live, lse_r, torch.zeros_like(lse_r))[..., None])
    return torch.where(valid, p, torch.zeros_like(p))


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    window: Tuple[int, int] = (-1, -1),
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: eager fp32 math from the same
    pre-scaled q and the given (o, lse), with p = exp(s - lse) selected on
    the valid pairs (rows past the length carry lse = -1e30 and are never
    exponentiated into the result).  Returns (dq, dk, dv) in q's dtype."""
    sc = _scale(q, scale)
    valid = _valid_pairs(q, k, lengths, window, q_offset, kv_offset)[:, None]
    qs, kf, vf, dof = _scaled(q, scale).float(), k.float(), v.float(), do.float()
    s = torch.einsum("bthd,bshd->bhts", qs, kf)
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # (B, H, Tq)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhts,bthd->bshd", ds, qs)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * sc
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _fused_bwd(window: Tuple[int, int]) -> bool:
    """K3 unless the band is two-sided or LCASR_FUSED_ATTN_BWD=0 (the gate
    of `_bwd_impl`; the port has no probe: the one-pass kernel's dq
    accumulation is exact on CUDA)."""
    banded = window[0] >= 0 and window[1] >= 0
    return not banded and os.environ.get("LCASR_FUSED_ATTN_BWD", "1") != "0"


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    window: Tuple[int, int] = (-1, -1),
    softmax_scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward with an external (o, lse (B, H, Tq)) pair: (dq, dk, dv),
    each shaped and typed like its input.  With a merged lse (ring
    attention) the per-block dk, dv are exact and the dq are summable."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, lengths, window,
                                       softmax_scale, int(q_offset), int(kv_offset))
    do = do.contiguous()
    _check_kernel_inputs(q, k, v, do)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = _scale(q, softmax_scale)
    qs = _scaled(q, scale)
    lens = _lengths(lengths, B, Tk, q.device).contiguous()
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()  # (B, H, Tq)
    fused = _fused_bwd(window)
    dq32 = (torch.zeros if fused else torch.empty)(
        (B, Tq, H, D), dtype=torch.float32, device=q.device)
    if fused and q.dtype == torch.bfloat16 and not _tma_layout_ok(
            dq32.shape, dq32.stride(), dq32.dtype, dq32.data_ptr()):
        # the bf16 K3 adds its dq parts into this buffer by TMA reduce-add
        raise ValueError(f"flash_attention_bwd: the fp32 dq buffer {tuple(dq32.shape)} "
                         f"(strides {dq32.stride()}) cannot take K3's TMA reduce-add")
    dk = torch.empty((B, Tk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = kernels.library(_BWD_SRC)

    def launch(kind, name, dq_ptr, dk_ptr, dv_ptr):
        with torch.cuda.device(q.device):
            err = lib.lcasr_flash_attn_bwd(
                kind, qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), lens.data_ptr(), dq_ptr, dk_ptr,
                dv_ptr, B, H, Tq, Tk, D, int(q.dtype == torch.float32),
                *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
                int(q_offset), int(kv_offset), int(window[0]), int(window[1]),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        kernels.check(lib, err, name)
        kernels.launch_counts[name] += 1

    if fused:
        launch(0, "flash_attention_bwd_fused", dq32.data_ptr(), dk.data_ptr(), dv.data_ptr())
    else:
        launch(1, "flash_attention_bwd_dq", dq32.data_ptr(), None, None)
        launch(2, "flash_attention_bwd_dkv", None, dk.data_ptr(), dv.data_ptr())
    # the chain-rule scale of dq, after the kernel (`_bwd_impl`)
    return (dq32 * scale).to(q.dtype), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward: K1 or K2 (saves q, k, v, o, lse).  Backward: K3, or K4 + K5."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, window, softmax_scale, q_offset, kv_offset):
        with span("attn_fwd"):
            o, lse = flash_attention_with_lse(q, k, v, lengths, window, softmax_scale,
                                              q_offset, kv_offset)
            ctx.save_for_backward(q, k, v, o, lse, lengths)
            ctx.args = (window, softmax_scale, q_offset, kv_offset)
            return o

    @staticmethod
    def backward(ctx, do):
        with span("attn_bwd"):
            q, k, v, o, lse, lengths = ctx.saved_tensors
            window, softmax_scale, q_offset, kv_offset = ctx.args
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, lengths, window,
                                             softmax_scale, q_offset, kv_offset)
            return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, lengths=None, window=(-1, -1), softmax_scale=None,
                    q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """(B, Tq, H, D) in, (B, Tq, H, D) out; differentiable in q, k, v."""
    return _FlashAttention.apply(q, k, v, lengths, tuple(window), softmax_scale,
                                 int(q_offset), int(kv_offset))
