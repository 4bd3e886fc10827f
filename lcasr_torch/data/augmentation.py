"""SpecAugment: time and frequency masking (counterpart of
lcasr_tpu/data/augmentation.py).

Drawing and applying are separate steps, so that a test can hand the same
masks to both frameworks: `draw_masks` takes a `torch.Generator` and
returns (axis, start (B,), end (B,)) per mask, time masks first, with the
JAX module's widths (`min_p` splits T * min_p over the time masks, `max_p`
caps a mask at that share of its axis); `apply` fills the masked bands
with the length-aware mean of the spectrogram (or 0 with `zero_masking`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

Mask = Tuple[int, torch.Tensor, torch.Tensor]


class SpecAugment:
    def __init__(
        self,
        n_time_masks: int,
        n_freq_masks: int,
        freq_mask_param: int,
        time_mask_param: int = -1,
        min_p: float = -1.0,
        max_p: float = 1.0,
        zero_masking: bool = False,
        **kwargs,
    ):
        if n_time_masks != 0:
            assert min_p != -1 or time_mask_param != -1, (
                "Either min_p or time_mask_param must be set"
            )
        assert min_p == -1 or 0 <= min_p <= 1
        assert 0 <= max_p <= 1
        self.n_time_masks = n_time_masks
        self.n_freq_masks = n_freq_masks
        self.freq_mask_param = freq_mask_param
        self.time_mask_param = time_mask_param
        self.min_p = min_p
        self.max_p = max_p
        self.zero_masking = zero_masking

    def draw_masks(self, B: int, F: int, T: int, generator: torch.Generator,
                   device=None) -> List[Mask]:
        time_width = self.time_mask_param
        if self.min_p != -1 and self.n_time_masks > 0:
            time_width = int(T * self.min_p) // self.n_time_masks
        masks = []
        for i in range(self.n_time_masks + self.n_freq_masks):
            axis = 2 if i < self.n_time_masks else 1
            size = T if axis == 2 else F
            param = time_width if axis == 2 else self.freq_mask_param
            max_val = max(1, min(param, int(size * self.max_p)) if self.max_p < 1.0 else param)
            value = torch.rand(B, generator=generator, device=device) * float(max_val)
            span = torch.clamp(size - value, min=1e-6)
            start = torch.rand(B, generator=generator, device=device) * span
            masks.append((axis, start.to(torch.int32), (start + value).to(torch.int32)))
        return masks

    def apply(self, spec: torch.Tensor, lengths: Optional[torch.Tensor],
              masks: List[Mask]) -> torch.Tensor:
        """spec (B, F, T); the fill value is computed once, before masking."""
        B, F, T = spec.shape
        if self.zero_masking:
            value = torch.zeros((), dtype=spec.dtype, device=spec.device)
        elif lengths is None:
            value = spec.mean()
        else:
            valid = (torch.arange(T, device=spec.device)[None, :]
                     < lengths.to(spec.device)[:, None]).to(spec.dtype)
            value = (spec * valid[:, None, :]).sum() / torch.clamp(valid.sum() * F, min=1.0)
        for axis, start, end in masks:
            idx = torch.arange(spec.shape[axis], device=spec.device)[None, :]
            hit = (idx >= start.to(spec.device)[:, None]) & (idx < end.to(spec.device)[:, None])
            shape = [B, 1, 1]
            shape[axis] = spec.shape[axis]
            spec = torch.where(hit.reshape(shape), value, spec)
        return spec

    def __call__(self, generator: torch.Generator, spec: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, F, T = spec.shape
        return self.apply(spec, lengths,
                          self.draw_masks(B, F, T, generator, generator.device))
