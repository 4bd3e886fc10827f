"""CTC decoder head with self-conditioning reprojection (counterpart of
lcasr_tpu/models/decoder.py).  `vocab_size + 1` classes, blank = last id;
log-softmax in fp32 whatever the compute dtype.

The reprojection exists only where a model calls `project_back`, that is
with self-conditioning on and more than one layer, as flax creates it only
on its first call; so a flax checkpoint and the port's state_dict have the
same keys in every configuration."""
from __future__ import annotations

import torch
from torch import nn

from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.norms import get_norm


class ASRLinearSCDecoder(nn.Module):
    def __init__(self, d_model: int, vocab_size: int, norm: bool = False,
                 norm_type: str = "layer_norm", dtype: torch.dtype = torch.float32,
                 reproject: bool = True):
        super().__init__()
        self.num_classes = vocab_size + 1
        self.norm = get_norm(norm_type)(d_model) if norm else None
        self.ff = Dense(d_model, self.num_classes, dtype=dtype, site="decoder")
        self.reprojection = (Dense(self.num_classes, d_model, dtype=dtype, site="decoder")
                             if reproject else None)

    def apply_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x) if self.norm is not None else x

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        x = self.ff(self.apply_norm(x))
        if not logits:
            x = torch.log_softmax(x.float(), dim=-1)
        return x

    def project_back(self, posteriors: torch.Tensor) -> torch.Tensor:
        return self.reprojection(posteriors)
