"""Config-driven model construction (counterpart of
lcasr_tpu/models/registry.py `load_model`)."""
from __future__ import annotations

import inspect
from typing import Any, Dict

import torch

from lcasr_torch.config import Config
from lcasr_torch.models import sconformer_xl
from lcasr_torch.models.sconformer_xl import SCConformerXL

_REGISTRY = {"SCConformerXL": SCConformerXL}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def get_model_class(config: Config | Dict[str, Any] | None = None):
    name = (config or {}).get("model_class", "SCConformerXL")
    if name not in _REGISTRY:
        raise NotImplementedError(f"model_class {name!r} is not ported yet "
                                  f"(ported: {sorted(_REGISTRY)})")
    return _REGISTRY[name]


def load_model(config: Config, vocab_size: int, device=None) -> SCConformerXL:
    """Build the model from config.model plus the tokenizer's vocab size.
    `training.dtype` sets the compute dtype when `model.dtype` does not;
    parameters stay fp32 (an fp32 master with bf16 compute).  Keys the JAX
    model does not know are ignored, as the JAX registry ignores them.
    `device=None` means the GPU and raises without one."""
    cls = get_model_class(config)
    cfg = config["model"].to_dict() if hasattr(config["model"], "to_dict") else dict(config["model"])
    cfg["vocab_size"] = vocab_size
    if "dtype" not in cfg:
        cfg["dtype"] = config.get("training", {}).get("dtype", None)
    if cfg["dtype"] is None:
        del cfg["dtype"]
    elif isinstance(cfg["dtype"], str):
        cfg["dtype"] = _DTYPES[cfg["dtype"]]
    known = set(inspect.signature(cls).parameters) | set(sconformer_xl._NOT_PORTED)
    kwargs = {k: v for k, v in cfg.items() if k in known and k != "device"}
    return cls(**kwargs, device=device)
