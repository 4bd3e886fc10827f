"""Flax variables of lcasr_tpu's SCConformerXL -> the port's state_dict.

The inverse direction of lcasr_tpu/models/import_torch.py, for the port's
own module tree (whose names follow the flax tree one to one):

  * `layers_3` -> `layers.3`; every other module name is kept;
  * Dense kernel (in, out) -> weight (out, in);
  * Conv kernel HWIO -> OIHW;
  * depthwise conv kernel (K, C) -> (C, 1, K);
  * norm `scale` / `bias`, BatchRenorm `weight` / `bias` and its
    `batch_stats` (`running_mean`, `running_std`, `num_batches_tracked`)
    are carried over as they are.

It takes numpy arrays (convert jax arrays with `np.asarray` first), so the
port needs no JAX.  Any leaf or module name it does not know raises: a
leaf dropped silently would give wrong outputs.  Load the result with
`model.load_state_dict(sd, strict=True)`.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_MODULE = re.compile(
    r"^(subsampling|conv_in|(dw|pw)_conv_\d+|out|norm_out|layers_\d+|"
    r"(ff1|ff2|attn|conv)_norm(_out)?|ff1|ff2|fc1|fc2|attend|qkv_proj|out_proj|"
    r"conv|pointwise_conv[12]|norm|decoder|ff|reprojection|rotary_pos_emb)$"
)
_PARAM_LEAVES = {"kernel", "bias", "scale", "weight", "depthwise_kernel",
                 "depthwise_bias", "inv_freq"}
_STAT_LEAVES = {"running_mean", "running_std", "num_batches_tracked"}


def _walk(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert(path: Tuple[str, ...], leaf: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, name = path
    for m in mods:
        if not _MODULE.match(m):
            raise ValueError(f"unknown module {m!r} in flax path {'/'.join(path)}")
    mods = [re.sub(r"^layers_(\d+)$", r"layers.\1", m) for m in mods]
    if name == "kernel":
        name = "weight"
        if leaf.ndim == 2:  # Dense (in, out) -> (out, in)
            leaf = leaf.T
        elif leaf.ndim == 4:  # conv HWIO -> OIHW
            leaf = leaf.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {leaf.ndim} at {'/'.join(path)}")
    elif name == "depthwise_kernel":  # (K, C) -> (C, 1, K)
        leaf = leaf.T[:, None, :]
    return ".".join(mods + [name]), leaf


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax `{'params': ..., 'batch_stats': ...}` (numpy leaves) -> state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection == "params":
            known = _PARAM_LEAVES
        elif collection == "batch_stats":
            known = _STAT_LEAVES
        else:
            raise ValueError(f"unknown flax collection {collection!r}")
        for path, leaf in _walk(tree):
            if path[-1] not in known:
                raise ValueError(f"unknown {collection} leaf {'/'.join(path)}")
            key, arr = _convert(path, np.asarray(leaf))
            dtype = np.int64 if path[-1] == "num_batches_tracked" else np.float32
            out[key] = torch.from_numpy(np.array(arr, dtype=dtype))  # a writable copy
    return out
