"""Config-driven model construction (counterpart of
lcasr_tpu/models/registry.py `load_model`)."""
from __future__ import annotations

import inspect
from typing import Any, Dict, Union

import torch

from lcasr_torch.config import Config
from lcasr_torch.models.enc_dec_sconformer import EncDecSconformer, EncDecSconformerV2
from lcasr_torch.models.fastconformer import FastConformerCTC
from lcasr_torch.models.lm import TransformerLM
from lcasr_torch.models.mamba import Mamba
from lcasr_torch.models.sconformer_meta import SCConformerMeta
from lcasr_torch.models.sconformer_xl import SCConformerXL

_REGISTRY = {"SCConformerXL": SCConformerXL, "Mamba": Mamba,
             "EncDecSconformer": EncDecSconformer, "EncDecSconformerV2": EncDecSconformerV2,
             "TransformerLM": TransformerLM, "SCConformerMeta": SCConformerMeta,
             "FastConformerCTC": FastConformerCTC}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def get_model_class(config: Config | Dict[str, Any] | None = None):
    name = (config or {}).get("model_class", "SCConformerXL")
    if name not in _REGISTRY:
        raise NotImplementedError(f"model_class {name!r} is not ported yet "
                                  f"(ported: {sorted(_REGISTRY)})")
    return _REGISTRY[name]


def load_model(config: Config, vocab_size: int, device=None, model_class=None
               ) -> Union[SCConformerXL, Mamba, EncDecSconformer, TransformerLM, SCConformerMeta,
                          FastConformerCTC]:
    """Build the model `config.model_class` names (SCConformerXL by default,
    Mamba, EncDecSconformer, EncDecSconformerV2, TransformerLM,
    SCConformerMeta or FastConformerCTC, which has no JAX counterpart), or
    `model_class` when given (the JAX function's third argument), from
    config.model plus the tokenizer's vocab size.
    `training.dtype` sets the compute dtype when `model.dtype` does not;
    parameters stay fp32 (an fp32 master with bf16 compute).  Keys the JAX
    model does not know are ignored, as the JAX registry ignores them.
    `device=None` means the GPU and raises without one."""
    cls = model_class if model_class is not None else get_model_class(config)
    cfg = config["model"].to_dict() if hasattr(config["model"], "to_dict") else dict(config["model"])
    cfg["vocab_size"] = vocab_size
    if "dtype" not in cfg:
        cfg["dtype"] = config.get("training", {}).get("dtype", None)
    if cfg["dtype"] is None:
        del cfg["dtype"]
    elif isinstance(cfg["dtype"], str):
        cfg["dtype"] = _DTYPES[cfg["dtype"]]
    # the class's own options, and those of its JAX counterpart that it
    # accepts at their default and refuses otherwise
    known = set(inspect.signature(cls).parameters) | set(cls.NOT_PORTED)
    kwargs = {k: v for k, v in cfg.items() if k in known and k != "device"}
    return cls(**kwargs, device=device)
