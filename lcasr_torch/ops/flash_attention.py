"""Flash-attention forward: the CUDA kernel's wrapper and its plain version
(counterpart of lcasr_tpu/ops/flash_attention.py `flash_attention`,
`flash_attention_with_lse`).

Public layout (B, T, H, D), as in the JAX package.  The softmax scale is
folded into q in q's dtype before the kernel (the JAX `_fwd` does the same,
`q * jnp.asarray(scale, q.dtype)`), and the lse is in that scaled domain.
`lengths` masks keys and query rows alike: rows at or past
min(len, q_offset + Tq) give o = 0 and lse = -1e30, and so do rows whose
every key is masked.  The band and the lengths are in global coordinates,
shifted by `q_offset` / `kv_offset` (context parallelism).

On a CUDA tensor the wrapper launches the kernel in
`lcasr_torch/csrc/flash_attn_fwd.cu` (bf16 or fp32; D in 32, 64, 128) and
raises on anything the kernel does not take.  On a CPU tensor it runs
`flash_attention_ref`, the plain fp32 version.  There is no fallback from
one to the other.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from lcasr_torch import kernels
from lcasr_torch.ops.attention import NEG_INF, length_mask, window_mask

KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_SRC = "flash_attn_fwd.cu"


def _scaled(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _lengths(lengths, B: int, Tk: int, device) -> torch.Tensor:
    if lengths is None:
        return torch.full((B,), Tk, dtype=torch.int32, device=device)
    return torch.as_tensor(lengths, device=device).to(torch.int32)


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
    """Plain version of the kernel: eager fp32 math on the same pre-scaled q,
    the same masks and lse conventions.  Returns (o in q's dtype,
    lse (B, H, Tq) fp32)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    lens = _lengths(lengths, B, Tk, q.device)
    # global row r < min(len, q_offset + Tq) is r < len for every local row;
    # likewise for columns
    valid = (length_mask(lens, Tq, offset=q_offset)[:, :, None]
             & length_mask(lens, Tk, offset=kv_offset)[:, None, :])  # (B, Tq, Tk)
    band = window_mask(Tq, Tk, window, q_offset=q_offset - kv_offset, device=q.device)
    if band is not None:
        valid = valid & band[None]
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


def _check_kernel_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
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
        if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
        ):
            raise ValueError(
                f"flash_attention: bf16 {name} must be 16-byte aligned with "
                f"strides that are multiples of 8 (got {t.stride()}); make it "
                f"contiguous first"
            )
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash_attention kernel takes bf16 or fp32, not {q.dtype}")
    D = q.shape[-1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel supports head_dim {KERNEL_HEAD_DIMS}, got {D} "
            f"(D=256 is not ported yet)"
        )
    B, _, H, _ = q.shape
    if k.shape[0] != B or k.shape[2:] != q.shape[2:] or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {q.shape}, k {k.shape}, v {v.shape}")


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
    Tk = k.shape[1]
    qs = _scaled(q, softmax_scale)
    lens = _lengths(lengths, B, Tk, q.device).contiguous()
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = kernels.library(_SRC)
    with torch.cuda.device(q.device):
        err = lib.lcasr_flash_attn_fwd(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), lens.data_ptr(), B, H, Tq, Tk, D,
            int(q.dtype == torch.float32),
            *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(q_offset), int(kv_offset), int(window[0]), int(window[1]),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check(lib, err, "flash_attention_fwd")
    kernels.launch_counts["flash_attention_fwd"] += 1
    return o, lse


def flash_attention(q, k, v, lengths=None, window=(-1, -1), softmax_scale=None,
                    q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """(B, Tq, H, D) in, (B, Tq, H, D) out."""
    return flash_attention_with_lse(q, k, v, lengths, window, softmax_scale,
                                    q_offset, kv_offset)[0]
