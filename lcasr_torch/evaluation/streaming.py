"""Averaged-moving-window streaming decode (counterpart of
lcasr_tpu/evaluation/streaming.py `StreamingDecoder`).

Overlapping windows of `seq_len` frames at stride `seq_len - overlap`; the
posteriors of overlapping frames are averaged.  The spectrogram is uploaded
once; windows are gathered on the device, `window_batch_size` per forward,
with columns past each window's true length zeroed and the ragged last
batch padded with zero-length windows that add nothing.  `exp(log_probs)`
and counts accumulate into fp32 (total, C) buffers on the device at offsets
computed on the host; the result is the argmax (`greedy`) or the log
(`logits`) of the average.  The JAX package's compile bucketing (of the
buffer rows, the upload width and the batch count) exists for XLA
recompiles only and is dropped: outputs up to `n_out` are the same.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from lcasr_torch.device import resolve_device


def subsampled_length(u_len: int, factor: int, mode: str = "dw_striding",
                      window_t: Optional[int] = None) -> int:
    """Host-side output length of each subsampling mode (`calc_length`)."""
    if mode == "stacking":
        t = window_t if window_t is not None else u_len
        pad = (factor - t % factor) % factor
        return max((u_len + pad) // factor, 1)
    n = u_len
    for _ in range(int(math.log2(factor))):
        if mode == "vggnet":
            n = math.ceil((n - 2) / 2 + 1)
        else:
            n = math.floor((n - 1) / 2 + 1)
    return int(n)


def _window_positions(spec_n: int, seq_len: int, overlap: int):
    """(start, true_length) per window, with the reference's truncation
    guard: one trailing short window is allowed, then the walk stops."""
    positions, last_ulen, kill_next = [], None, False
    for i in range(0, spec_n, seq_len - overlap):
        u_len = min(seq_len, spec_n - i)
        if kill_next:
            break
        if last_ulen is not None and u_len < last_ulen:
            kill_next = True
        last_ulen = u_len
        positions.append((i, u_len))
    return positions


_TRANSFER = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


class StreamingDecoder:
    """Device-resident moving-window decoder for one model.

    `device=None` means the GPU and raises without one.  `transfer_dtype`
    is the upload dtype of the spectrogram (fp32, bf16 or fp16; default
    bf16)."""

    def __init__(self, model, n_classes: int, subsampling_factor: Optional[int] = None,
                 window_batch_size: int = 16, transfer_dtype=torch.bfloat16,
                 subsampling_mode: Optional[str] = None, device=None,
                 pipeline_upload: bool = False, mesh=None, cache_upload: bool = False):
        if pipeline_upload or cache_upload or mesh is not None:
            raise NotImplementedError(
                "pipeline_upload, cache_upload and the mesh data-parallel decode "
                "are not ported yet"
            )
        name = str(transfer_dtype).replace("torch.", "")
        if name not in _TRANSFER:
            raise NotImplementedError(
                f"transfer_dtype {transfer_dtype!r}: only float32, bfloat16 and "
                f"float16 are ported (int8/int4 come later)"
            )
        self.transfer_dtype = _TRANSFER[name]
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.n_classes = n_classes
        self.ds = subsampling_factor or getattr(model, "subsampling_factor", 8)
        self.mode = subsampling_mode or getattr(model, "subsampling_mode", "dw_striding")
        self.W = window_batch_size

    @torch.no_grad()
    def _run(self, spec: np.ndarray, seq_len: int, overlap: int):
        spec = np.asarray(spec)
        if spec.ndim == 3:
            spec = spec[0]
        spec_n = spec.shape[-1]
        if seq_len > spec_n:  # windowed-attention mode: one window
            seq_len, overlap = spec_n, 0
        if overlap % self.ds:
            raise ValueError("overlap must be a multiple of the downsampling factor")
        if seq_len <= overlap:
            raise ValueError(f"seq_len {seq_len} must exceed overlap {overlap}")
        positions = _window_positions(spec_n, seq_len, overlap)

        out_offsets, n_valid, pos = [], [], 0
        for i, u_len in positions:
            n = subsampled_length(u_len, self.ds, self.mode, window_t=seq_len)
            if i != 0:
                pos -= int(overlap / (u_len / n))
            out_offsets.append(pos)
            n_valid.append(n)
            pos += n
        n_out = pos
        total = n_out + subsampled_length(seq_len, self.ds, self.mode, window_t=seq_len)

        dev = self.device
        spec_dev = torch.from_numpy(np.ascontiguousarray(spec, np.float32)).to(
            dev, self.transfer_dtype)  # the one upload
        T = spec_dev.shape[-1]
        sums = torch.zeros((total, self.n_classes), dtype=torch.float32, device=dev)
        counts = torch.zeros((total, 1), dtype=torch.float32, device=dev)
        W = min(self.W, len(positions))
        cols = torch.arange(seq_len, device=dev)
        for b0 in range(0, len(positions), W):
            group = positions[b0 : b0 + W]
            starts = torch.zeros(W, dtype=torch.int64)
            lengths = torch.zeros(W, dtype=torch.int32)
            for j, (i, u_len) in enumerate(group):
                starts[j], lengths[j] = i, u_len
            starts, lengths = starts.to(dev), lengths.to(dev)
            idx = (starts[:, None] + cols[None, :]).clamp(max=T - 1)
            wins = spec_dev[:, idx].transpose(0, 1)  # (W, 80, seq_len)
            wins = wins.masked_fill((cols[None, :] >= lengths[:, None])[:, None, :], 0.0)
            log_probs = self.model(wins, length=lengths)["final_posteriors"]
            for j in range(len(group)):  # padding windows add nothing
                off, n = out_offsets[b0 + j], n_valid[b0 + j]
                sums[off : off + n] += torch.exp(log_probs[j, :n].float())
                counts[off : off + n] += 1.0
        avg = sums[:n_out] / counts[:n_out].clamp_min(1.0)
        return avg

    def logits(self, spec: np.ndarray, seq_len: int, overlap: int) -> np.ndarray:
        """Merged averaged log-probs (T', C)."""
        return torch.log(self._run(spec, seq_len, overlap)).cpu().numpy()

    def greedy(self, spec: np.ndarray, seq_len: int, overlap: int) -> np.ndarray:
        """Merged per-frame argmax ids (T',)."""
        return self._run(spec, seq_len, overlap).argmax(-1).cpu().numpy()
