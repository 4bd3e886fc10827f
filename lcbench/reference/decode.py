"""The averaged moving-window decode, plain: windows of `seq_len` frames at a
stride of `seq_len - overlap`, one trailing short window allowed, the
posteriors of the frames that windows share averaged.

Window w starts at frame w * stride and holds min(seq_len, T - start)
frames, the rest of its `seq_len` columns zero.  Its subsampled outputs go
to rows starting where the last window's ended, less the overlap measured
in its own frames per output; each row's average is the sum of exp(log p)
of the windows that cover it over their number.
"""
from __future__ import annotations

import math

import torch


def subsampled_length(n: int, factor: int = 8) -> int:
    for _ in range(int(math.log2(factor))):
        n = math.floor((n - 1) / 2 + 1)
    return int(n)


def windows(n_frames: int, seq_len: int, overlap: int):
    """[(start, true length)], walking until one window shorter than the one
    before it has been taken."""
    out, last, stop = [], None, False
    for i in range(0, n_frames, seq_len - overlap):
        u = min(seq_len, n_frames - i)
        if stop:
            break
        if last is not None and u < last:
            stop = True
        last = u
        out.append((i, u))
    return out


def row_offsets(positions, seq_len: int, overlap: int, factor: int = 8):
    """(first row of each window, its valid rows, the merged length)."""
    offsets, n_valid, pos = [], [], 0
    for i, u in positions:
        n = subsampled_length(u, factor)
        if i != 0:
            pos -= int(overlap / (u / n))
        offsets.append(pos)
        n_valid.append(n)
        pos += n
    return offsets, n_valid, pos


GROUP = 26  # windows a forward: a 20-minute recording's 52 in two


def averaged_probs(forward, spec: torch.Tensor, seq_len: int, overlap: int, n_classes: int,
                   group: int = GROUP) -> torch.Tensor:
    """spec (80, T) fp32 on the device -> averaged probabilities (T', C);
    `forward(audio (W, 80, seq_len), lengths (W,))` -> (log-probs, lengths),
    run on `group` windows at a time."""
    n = spec.shape[-1]
    positions = windows(n, seq_len, overlap)
    offsets, n_valid, total = row_offsets(positions, seq_len, overlap)
    dev = spec.device
    sums = torch.zeros((total, n_classes), dtype=torch.float32, device=dev)
    counts = torch.zeros((total, 1), dtype=torch.float32, device=dev)
    for g in range(0, len(positions), group):
        part = positions[g:g + group]
        batch = torch.zeros((len(part), spec.shape[0], seq_len), dtype=torch.float32, device=dev)
        for j, (i, u) in enumerate(part):
            batch[j, :, :u] = spec[:, i:i + u]
        lengths = torch.tensor([u for _, u in part], dtype=torch.int32, device=dev)
        with torch.no_grad():
            log_probs, _ = forward(batch, lengths)
        for j in range(len(part)):
            off, m = offsets[g + j], n_valid[g + j]
            sums[off:off + m] += torch.exp(log_probs[j, :m])
            counts[off:off + m] += 1.0
    return sums / counts.clamp_min(1.0)
