"""The yardstick's peaks and the kernels' bounds: the least time the card could
take for the work a call needs, the larger of its operations over the peak
of their kind and its bytes over the memory rate.

Copied from the repository's chip smoke script (`attention_bound`,
`ssm_bound`, `sub_bound`, `valid_pairs`, `PEAK_FLOPS`, `PEAK_BYTES_PER_S`)
so that a change to the program cannot move the yardstick.  Two changes of
form, none of arithmetic: the card's SM count and highest SM clock are
arguments (the harness reads them once), and `valid_pairs` counts an
unbounded window in closed form (its mask at 45,000 rows would not fit).
"""
from __future__ import annotations

import numpy as np

# published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
# special-function units: one exp per clock on each of 16 units per SM
SFU_PER_CLOCK_PER_SM = 16


def valid_pairs(lengths, B, T, window, q_off, kv_off) -> int:
    """(row, col) pairs this input's masks leave valid: the work it needs."""
    lens = np.full(B, T) if lengths is None else np.asarray(lengths)
    if window == (-1, -1) or tuple(window) == (-1, -1):
        rows = np.clip(np.minimum(lens, q_off + T) - q_off, 0, T)
        cols = np.clip(np.minimum(lens, kv_off + T) - kv_off, 0, T)
        return int((rows.astype(np.int64) * cols.astype(np.int64)).sum())
    rows = q_off + np.arange(T)
    cols = kv_off + np.arange(T)
    total = 0
    for ln in lens:
        ok = (rows[:, None] < min(ln, q_off + T)) & (cols[None, :] < min(ln, kv_off + T))
        if window[1] >= 0:
            ok &= cols[None, :] <= rows[:, None] + window[1]
        if window[0] >= 0:
            ok &= cols[None, :] >= rows[:, None] - window[0]
        total += int(ok.sum())
    return total


def attention_bound(B, T, H, D, lengths=None):
    """(bound ms, bound_by, flops) of one bf16 forward: 4 T^2 D operations per
    (b, h) over the pairs the lengths leave valid, at the bf16 peak, against
    q, k, v, o, lse and the lengths at the memory rate."""
    flops = 4 * H * D * valid_pairs(lengths, B, T, (-1, -1), 0, 0)
    nbytes = 2 * 4 * B * T * H * D + 4 * B * H * T + 4 * B
    t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def attention_bwd_bound(B, T, H, D, lengths=None):
    """(bound ms, bound_by, flops) of one fused bf16 backward (K3's work): 5
    products of 2 T^2 D per (b, h) over the valid pairs, against q, k, v, o,
    do, lse in and dq, dk, dv out."""
    flops = 5 * 2 * H * D * valid_pairs(lengths, B, T, (-1, -1), 0, 0)
    nbytes = 2 * 8 * B * T * H * D + 4 * B * H * T + 4 * B
    t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def ssm_bound(kind, shape, x_bytes, bc_bytes, states: bool, sms: int, clock_hz: float):
    """(bound ms, 'bytes' or 'operations') of one scan: every input read once
    and every output written once at the memory rate, against the fp32
    operations at the fp32 peak and the exps at the special-function rate
    (16 per clock per SM at the card's highest SM clock)."""
    Bt, L, D, N = shape
    elems, small = Bt * L * D, Bt * L * N
    state_bytes = 4 * Bt * -(-L // 32) * N * D if states else 0
    if kind == "fwd":  # x, delta in; y out; per (t, d, n): 1 exp and 6 flops
        nbytes = elems * (x_bytes + 4 + 4) + 2 * small * bc_bytes + 4 * D * N + state_bytes
        exps, flops = elems * N, 6 * elems * N
    else:  # x, delta, g in; dx, ddelta out; dB, dC, dA; one exp and 20 flops
        nbytes = (elems * (x_bytes + 4 * 4) + 2 * small * bc_bytes + 2 * small * 4
                  + 2 * 4 * D * N + state_bytes)
        exps, flops = elems * N, 20 * elems * N
    sfu_rate = SFU_PER_CLOCK_PER_SM * sms * clock_hz
    t_ops = max(flops / PEAK_FLOPS["fp32"], exps / sfu_rate) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sub_bound(B, T, F, C, elem_bytes, dtype_name, sms, clock_hz, act="silu"):
    """(bound ms, bound_by, parts, flops): the larger of three times, the
    chain's multiply-adds at the peak of their type (the tensor cores' in
    bf16), one special-function operation (an exp) per silu value of the
    chain, and x read once, the output written once and the weights.  The
    values counted are the chain's own (B (T/2 F/2 + T/4 F/4 + T/8 F/8) C)."""
    T0, T1, T8, F0, F1, F8 = T // 2, T // 4, T // 8, F // 2, F // 4, F // 8
    flops = 2 * B * (T0 * F0 * C * 9 + T1 * F1 * C * (9 + C) + T8 * F8 * C * (9 + C))
    values = B * (T0 * F0 + T1 * F1 + T8 * F8) * C
    nbytes = elem_bytes * (B * T * F + B * T8 * F8 * C + 3 * 10 * C + 2 * C * C)
    sfu_rate = SFU_PER_CLOCK_PER_SM * sms * clock_hz
    mma = "tensor cores" if dtype_name == "bf16" else "fp32 cores"
    parts = {mma: flops / PEAK_FLOPS[dtype_name] * 1e3,
             "special functions": (values if act == "silu" else 0) / sfu_rate * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    by = max(parts, key=parts.get)
    parts["by"] = by
    return parts[by], ("bytes" if by == "bytes" else "operations"), parts, flops
