"""Weight-decay parameter grouping (counterpart of lcasr_tpu/models/base.py
`decay_mask`).

The rule is the JAX function's, applied to each parameter's flax name
(`models.import_jax.flax_path`): every bias gets no decay; linear,
feed-forward, conv and rotary parameters get no decay; norm affine scales
(LayerNorm / RMSNorm `scale`, BatchRenorm `weight`) decay.  That is the
reference's effective grouping.  A model class without groups upstream
takes the reference's warning branch: decay on every parameter.
"""
from __future__ import annotations

import warnings
from typing import Dict

from torch import nn

from lcasr_torch.models.import_jax import flax_path

_NORM_SCOPE_HINTS = ("norm", "batchrenorm")
_GROUPED_MODELS = {"SCConformerXL", "SCConformerMeta", "Mamba"}


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies."""
    name = type(model).__name__
    params = dict(model.named_parameters())
    if name not in _GROUPED_MODELS:
        warnings.warn(
            f"{name} defines no weight-decay groups (matching the reference "
            f"warning branch, lcasr/models/base.py:29-32): weight decay "
            f"will apply to ALL parameters"
        )
        return {k: True for k in params}

    def rule(key: str) -> bool:
        _, path = flax_path(key, params[key])
        leaf = path[-1]
        if leaf.endswith("bias"):
            return False
        in_norm_scope = any(h in m.lower() for m in path[:-1] for h in _NORM_SCOPE_HINTS)
        return in_norm_scope and leaf in ("scale", "weight")

    return {k: rule(k) for k in params}
