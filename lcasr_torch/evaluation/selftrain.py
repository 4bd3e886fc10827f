"""Single-utterance self-training (counterpart of
lcasr_tpu/evaluation/selftrain.py): each call first adapts the model to
its own input for `n_iterations` steps (SpecAugmented copies against the
greedy pseudo-labels of the clean pass, MADGRAD), then returns the adapted
model's output.  Defaults are the reference wrapper's: 10 iterations,
lr 9e-5, one augmented copy, frequency masks only.

The model's parameters and buffers are copied back after every call, bit
for bit (`dynamic_eval.restored`); the masks' generator runs on from call
to call, as the JAX wrapper's key does.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lcasr_torch.data.augmentation import SpecAugment
from lcasr_torch.decoding.greedy import GreedyCTCDecoder
from lcasr_torch.evaluation.dynamic_eval import adapt_step, pseudo_labels, restored
from lcasr_torch.optim.madgrad import MADGRAD


class SelfTrainWrapper:
    def __init__(self, model, tokenizer, n_iterations: int = 10, num_negatives: int = 1,
                 lr: float = 9e-5, spec_augment_config: Optional[Dict] = None, seed: int = 0):
        self.model = model
        self.tokenizer = tokenizer
        self.n_iterations = n_iterations
        self.num_negatives = num_negatives
        self.lr = lr
        self.blank_id = tokenizer.vocab_size()
        self.augmentation = SpecAugment(**(spec_augment_config or {
            "n_time_masks": 0, "n_freq_masks": 6, "freq_mask_param": 34}))
        self.decoder = GreedyCTCDecoder(tokenizer, blank_id=self.blank_id)
        self.generator = torch.Generator().manual_seed(seed)

    def __call__(self, audio, length: Optional[torch.Tensor] = None) -> dict:
        """audio (1, 80, T) -> the adapted model's output dict."""
        model = self.model
        device = next(model.parameters()).device
        audio = torch.as_tensor(np.asarray(audio, np.float32), device=device)
        nn_ = self.num_negatives
        lengths = torch.full((nn_ + 1,), audio.shape[-1], dtype=torch.int32, device=device)
        with restored(model):
            optimizer = MADGRAD(model.parameters(), lr=self.lr)
            for _ in range(self.n_iterations):
                reps = audio.repeat(nn_ + 1, 1, 1)
                aug = self.augmentation(self.generator, reps[:nn_])
                batch = torch.cat([aug, reps[nn_:]], dim=0)
                with torch.no_grad():
                    clean_lp = model(batch, length=lengths)["final_posteriors"][-1]
                pseudo, pseudo_len = pseudo_labels(
                    self.decoder, self.tokenizer, clean_lp.float().cpu().numpy(), nn_, 16)
                adapt_step(model, optimizer, batch, lengths, pseudo.to(device),
                           pseudo_len.to(device), nn_, self.blank_id)
            with torch.no_grad():
                return model(audio, length=None if length is None else length.to(device))
