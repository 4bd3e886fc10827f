"""Selective state-space scan (Mamba) ops: the CUDA kernels' wrappers, their
plain versions and the autograd Function (counterpart of
lcasr_tpu/ops/ssm.py).

    h_t = exp(delta_t * A) h_{t-1} + (delta_t * B_t) x_t
    y_t = C_t . h_t + D * x_t

x, delta, y are (Bt, L, D); A is (D, N); B, C are (Bt, L, N).  On CUDA
tensors `selective_scan` launches the forward kernel K6 and, in the backward,
K7 (`lcasr_torch/csrc/selective_scan.cu`); on CPU tensors it runs
`selective_scan_ref` / `selective_scan_bwd_ref`, the plain fp32 recurrences.
There is no fallback from one to the other.  The kernels are built for
d_state 16, 32 and 64 (`KERNEL_D_STATES`); any other d_state up to
`MAX_D_STATE` is padded up to the next of them (`pad_d_state`: zero columns
of B and C, -1 in A's), which is exact: a padded state starts at 0, receives
B x = 0 and adds C h = 0 to y, its adjoint is C g = 0, so its dA, dB and dC
are 0, and they are sliced away.  Above 64 the wrappers raise.  They take x
in fp32, B and C in bf16 or fp32, any L >= 1 (they stop at L; nothing is
padded), and read B and C through their strides, so the last-dimension slices
of the mixer's `x_proj` output are not copied.  The wrappers make x, delta
and A fp32 (the mixer's x is fp32 already: the conv's fp32 bias promotes it)
and the gradient in y contiguous fp32.

K6 cuts the time axis into `fwd_segments(Bt, L, D)` segments of whole
chunks where rows x channels alone do not fill the card: the segments'
exits from a zero entry first, then every segment from its true entry (its
wrapper allocates the exits and sums of delta that join them, and counts
one `selective_scan_fwd` launch per call).  The count depends on the shape
only, so y is the same with and without the states.  For the backward the
forward saves the state at the entry of every chunk of `STATE_INTERVAL`
steps, (Bt, ceil(L / 32), N, D) fp32; K7 recomputes the states inside a
chunk on chip.  K7 splits the time axis: a local adjoint per
chunk, a carry pass over the chunks, then every chunk's gradients from its
true carry, and sums dB, dC and dA in a fixed order itself (no atomics: the
same bits each run).  Its wrapper allocates the workspace those passes need
and counts one `selective_scan_bwd` launch per call.  `LCASR_NATIVE_SSM_BWD`
of the JAX package chooses between two JAX routes and has no meaning here:
the backward of a CUDA tensor is always K7.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lcasr_torch import kernels
from lcasr_torch.utils.profiling import span

STATE_INTERVAL = 32  # steps between saved states; TC in selective_scan.cu
KERNEL_D_STATES = (16, 32, 64)  # the instantiations of csrc/selective_scan.cu
MAX_D_STATE = KERNEL_D_STATES[-1]
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_SRC = "selective_scan.cu"


def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, L, C); kernel: (K, C) -> (B, L, C).  A
    library convolution, as the JAX package leaves it to `lax.conv`."""
    K, C = kernel.shape
    out = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), kernel.t()[:, None, :],
                   groups=C).transpose(1, 2)
    if bias is not None:
        out = out + bias  # an fp32 bias promotes a bf16 conv output, as in JAX
    return out


def flip_with_lengths(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Reverse each sequence within its valid region; padding keeps its
    position.  `lengths=None` flips the whole axis."""
    if lengths is None:
        return torch.flip(x, dims=(1,))
    L = x.shape[1]
    idx = torch.arange(L, device=x.device)[None, :]
    src = lengths.to(x.device, torch.int64)[:, None] - 1 - idx
    src = torch.where(src >= 0, src, idx)
    return torch.take_along_dim(x, src[..., None], dim=1)


# K6's split of the time axis (csrc/selective_scan.cu): 64 channels a block,
# of 128, 256 or 512 threads at d_state 16, 32 or 64.  One segment where that
# gives FWD_FILL_BLOCKS blocks (two for each of an H100's 132 SMs: the
# decode's 384 run best unsplit); else the time axis is cut so that each of
# K6's two launches has FWD_SPLIT_BLOCKS (eight an SM).  Both count blocks
# launched, not blocks resident at once; chosen at d_state 16, they are as
# fast as a cut for 2 or 4 blocks an SM, or within 1% of it, at d_state 32
# and 64 too, at the decode, 16384x4 and 120,000-frame shapes
# (chip_smoke.ssm_split_sweep; PERF.md)
FWD_CHANNELS = 64
FWD_FILL_BLOCKS = 2 * 132
FWD_SPLIT_BLOCKS = 8 * 132


def _n_chunks(L: int) -> int:
    return -(-L // STATE_INTERVAL)


def fwd_segments(Bt: int, L: int, D: int) -> int:
    """K6's number of time segments at this shape: 1 where Bt x ceil(D / 64)
    blocks reach FWD_FILL_BLOCKS, else enough that the S - 1 segments of each
    launch reach FWD_SPLIT_BLOCKS, at most one a chunk.  Segments are whole
    32-step chunks, all of ceil(n_chunks / S) but the last, none empty."""
    n_chunks = _n_chunks(L)
    blocks = Bt * -(-D // FWD_CHANNELS)
    if blocks >= FWD_FILL_BLOCKS or n_chunks == 1:
        return 1
    want = min(1 + -(-FWD_SPLIT_BLOCKS // blocks), n_chunks)
    per = -(-n_chunks // want)
    return -(-n_chunks // per)


def fwd_grids(Bt: int, L: int, D: int) -> dict:
    """{kernel: grid (x, y, z)} of K6's launches at this shape, 128 threads
    each (as `fwd_grid` in csrc/selective_scan.cu gives them)."""
    S = fwd_segments(Bt, L, D)
    blocks = -(-D // FWD_CHANNELS)
    grids = {"selective_scan_fwd_body": (blocks, max(S - 1, 1), Bt)}
    if S > 1:
        grids = {"selective_scan_fwd_local": (blocks, S - 1, Bt), **grids}
    return grids


def selective_scan_ref(x, delta, A, B, C, return_states: bool = False,
                       dtype: torch.dtype = torch.float32):
    """Plain version of K6: the sequential recurrence in `dtype` (fp32).
    Returns y (Bt, L, D), and with `return_states` also the state at the entry
    of every chunk of STATE_INTERVAL steps, (Bt, ceil(L / 32), N, D)."""
    Bt, L, Dm = x.shape
    xf, df, Af, Bf, Cf = (t.to(dtype) for t in (x, delta, A, B, C))
    h = torch.zeros((Bt, Dm, A.shape[1]), dtype=dtype, device=x.device)
    ys, states = [], []
    for t in range(L):
        if return_states and t % STATE_INTERVAL == 0:
            states.append(h.transpose(1, 2))
        dt = df[:, t, :, None]  # (Bt, D, 1)
        h = torch.exp(dt * Af) * h + (dt * xf[:, t, :, None]) * Bf[:, t, None, :]
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1)
    if return_states:
        return y, torch.stack(states, dim=1).contiguous()
    return y


def selective_scan_bwd_ref(x, delta, A, B, C, g, dtype: torch.dtype = torch.float32):
    """Plain version of K7: the reverse recurrence written out on tensors,

        lambda_t = C_t (x) g_t + a_{t+1} * lambda_{t+1},   a_t = exp(delta_t A)
        dx_t     = delta_t sum_n lambda_t B_t
        ddelta_t = sum_n lambda_t (B_t x_t + A a_t h_{t-1})
        dB_t     = sum_d lambda_t delta_t x_t ;  dC_t = sum_d g_t h_t
        dA       = sum_{b,t} lambda_t delta_t a_t h_{t-1}

    with every h_t kept from a forward sweep (the kernel recomputes them chunk
    by chunk instead).  Returns (dx, ddelta, dA, dB, dC) in `dtype`."""
    Bt, L, Dm = x.shape
    xf, df, Af, Bf, Cf, gf = (t.to(dtype) for t in (x, delta, A, B, C, g))
    h = torch.zeros((Bt, Dm, A.shape[1]), dtype=dtype, device=x.device)
    hs = [h]  # hs[t] = h_{t-1}
    for t in range(L):
        dt = df[:, t, :, None]
        h = torch.exp(dt * Af) * h + (dt * xf[:, t, :, None]) * Bf[:, t, None, :]
        hs.append(h)
    carry = torch.zeros_like(h)  # a_{t+1} * lambda_{t+1}
    dA = torch.zeros_like(Af)
    dx, dd, dB, dC = [], [], [], []
    for t in range(L - 1, -1, -1):
        dt, xt, gt = df[:, t, :, None], xf[:, t, :, None], gf[:, t, :, None]
        Bt_, Ct_ = Bf[:, t, None, :], Cf[:, t, None, :]
        a = torch.exp(dt * Af)
        lam = carry + Ct_ * gt  # (Bt, D, N)
        sum_lb = (lam * Bt_).sum(-1)
        gain = lam * a * hs[t]
        dx.append(df[:, t] * sum_lb)
        dd.append(xf[:, t] * sum_lb + (gain * Af).sum(-1))
        dB.append((lam * (dt * xt)).sum(1))
        dC.append((gt * hs[t + 1]).sum(1))
        dA = dA + (gain * dt).sum(0)
        carry = lam * a
    rev = lambda parts: torch.stack(parts[::-1], dim=1)
    return rev(dx), rev(dd), dA, rev(dB), rev(dC)


def kernel_d_state(N: int) -> int:
    """The built d_state that runs N: the least of KERNEL_D_STATES >= N."""
    for built in KERNEL_D_STATES:
        if N <= built:
            return built
    raise ValueError(f"selective_scan kernels take d_state up to {MAX_D_STATE} "
                     f"(built for {KERNEL_D_STATES}), got {N}")


def pad_d_state(A, B, C, n_to: int):
    """A (D, N), B and C (..., N) padded to n_to states: A's new columns -1,
    B's and C's 0.  A padded state stays 0 and adds nothing to y or to any
    gradient of the first N states."""
    pad = n_to - A.shape[-1]
    if pad == 0:
        return A, B, C
    return (F.pad(A, (0, pad), value=-1.0), F.pad(B, (0, pad)), F.pad(C, (0, pad)))


def _check_kernel_inputs(x, delta, A, B, C):
    Bt, L, Dm = x.shape
    N = A.shape[-1]
    if N not in KERNEL_D_STATES:
        raise ValueError(f"selective_scan kernels are built for d_state 16, 32 and 64, "
                         f"got {N}")
    if L < 1 or Bt < 1:
        raise ValueError(f"selective_scan: empty input {tuple(x.shape)}")
    want = {"delta": (Bt, L, Dm), "A": (Dm, N), "B": (Bt, L, N), "C": (Bt, L, N)}
    for name, t in (("x", x), ("delta", delta), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, x on {x.device}")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if name != "A" and t.stride(-1) != 1:
            raise ValueError(f"selective_scan: {name} needs a unit stride on its last "
                             f"dimension (got {t.stride()}); make it contiguous first")
    if B.dtype not in KERNEL_DTYPES:
        raise TypeError(f"selective_scan kernel takes B and C in bf16 or fp32, not {B.dtype}")


def _kernel_args(x, delta, A, B, C):
    """Inputs as the kernels take them (d_state padded to a built one), and
    the argument tail shared by both launches (sizes, B and C's dtype flag,
    strides in elements)."""
    A, B, C = pad_d_state(A, B, C, kernel_d_state(A.shape[-1]))
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"selective_scan kernel takes x in bf16 or fp32, not {x.dtype}")
    x = x.float()  # a bf16 x is cast here; the mixer gives fp32
    delta = delta.float()
    if delta.stride(-1) != 1:
        delta = delta.contiguous()
    A = A.float().contiguous()
    if C.dtype != B.dtype:
        C = C.to(B.dtype)
    _check_kernel_inputs(x, delta, A, B, C)
    Bt, L, Dm = x.shape
    tail = (Bt, L, Dm, A.shape[1], int(B.dtype == torch.float32),
            *x.stride()[:2], *delta.stride()[:2],
            *B.stride()[:2], *C.stride()[:2])
    return (x, delta, A, B, C), tail


def selective_scan_fwd(x, delta, A, B, C, return_states: bool = False):
    """y (Bt, L, D) fp32 without the skip term, and with `return_states` the
    chunk-entry states for the backward, (Bt, ceil(L / 32), N', D) at the
    built d_state N' that runs N.  K6 on CUDA tensors, the plain version on
    CPU tensors."""
    if x.device.type == "cpu":
        return selective_scan_ref(x, delta, A, B, C, return_states)
    (x, delta, A, B, C), tail = _kernel_args(x, delta, A, B, C)
    Bt, L, Dm = x.shape
    segments = fwd_segments(Bt, L, Dm)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bt, L, Dm), **f32)
    states = None
    if return_states:
        states = torch.empty((Bt, _n_chunks(L), A.shape[1], Dm), **f32)
    lib = kernels.library(_SRC)
    workspace = torch.empty(
        (lib.lcasr_selective_scan_fwd_workspace(Bt, L, Dm, A.shape[1], segments),), **f32)
    with torch.cuda.device(x.device):
        err = lib.lcasr_selective_scan_fwd(
            x.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), None if states is None else states.data_ptr(),
            workspace.data_ptr(), segments, *tail,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(lib, err, "selective_scan_fwd")
    kernels.launch_counts["selective_scan_fwd"] += 1
    return (y, states) if return_states else y


def selective_scan_bwd(x, delta, A, B, C, states, g
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, ddelta, dA, dB, dC), all fp32, from the forward's chunk-entry
    states and g = dL/dy (without the skip term).  K7 on CUDA tensors, the
    plain version (which needs no states) on CPU tensors."""
    if x.device.type == "cpu":
        return selective_scan_bwd_ref(x, delta, A, B, C, g)
    n_in = A.shape[1]
    (x, delta, A, B, C), tail = _kernel_args(x, delta, A, B, C)
    Bt, L, Dm = x.shape
    N = A.shape[1]
    g = g.float().contiguous()
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"selective_scan_bwd: g {tuple(g.shape)} on {g.device}")
    if (tuple(states.shape) != (Bt, _n_chunks(L), N, Dm) or states.dtype != torch.float32
            or not states.is_contiguous() or states.device != x.device):
        raise ValueError(f"selective_scan_bwd: states {tuple(states.shape)} {states.dtype} "
                         f"are not the forward's for x {tuple(x.shape)}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bt, L, Dm), **f32)
    dd = torch.empty((Bt, L, Dm), **f32)
    dB = torch.empty((Bt, L, N), **f32)
    dC = torch.empty((Bt, L, N), **f32)
    dA = torch.empty((Dm, N), **f32)
    lib = kernels.library(_SRC)
    workspace = torch.empty((lib.lcasr_selective_scan_bwd_workspace(Bt, L, Dm, N),), **f32)
    with torch.cuda.device(x.device):
        err = lib.lcasr_selective_scan_bwd(
            x.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            g.data_ptr(), states.data_ptr(), dx.data_ptr(), dd.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), workspace.data_ptr(), *tail,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(lib, err, "selective_scan_bwd")
    kernels.launch_counts["selective_scan_bwd"] += 1
    if n_in != N:  # the padded states' gradients are 0: sliced away
        dA, dB, dC = dA[:, :n_in], dB[..., :n_in], dC[..., :n_in]
    return dx, dd, dA, dB, dC


class _SelectiveScan(torch.autograd.Function):
    """Forward: K6, with the chunk-entry states only when a gradient is
    needed.  Backward: K7; each gradient is cast to its input's dtype."""

    @staticmethod
    def forward(ctx, x, delta, A, B, C, need_states):
        with span("scan_fwd"):
            if not need_states:
                return selective_scan_fwd(x, delta, A, B, C)
            y, states = selective_scan_fwd(x, delta, A, B, C, return_states=True)
            ctx.save_for_backward(x, delta, A, B, C, states)
            return y

    @staticmethod
    def backward(ctx, g):
        with span("scan_bwd"):
            x, delta, A, B, C, states = ctx.saved_tensors
            grads = selective_scan_bwd(x, delta, A, B, C, states, g)
            return (*(gr.to(t.dtype) for gr, t in zip(grads, (x, delta, A, B, C))), None)


def selective_scan(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Selective scan; returns y (Bt, L, D) in x's dtype, differentiable in
    x, delta, A, B, C and D.  The skip term D * x is added in fp32."""
    need_states = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, delta, A, B, C))
    y = _SelectiveScan.apply(x, delta, A, B, C, need_states)
    if D is not None:
        y = y + D.float()[None, None] * x.float()
    return y.to(x.dtype)
