"""Partition rules: the tensor-parallel layout of the parameters, the ZeRO
rule, and the helpers that cut a whole state_dict into one rank's shard and
gather it back (counterpart of lcasr_tpu/parallel/partition.py).

`param_spec` is JAX's rule by leaf name, on flax paths:
  * column-parallel (kernel P(None, "model")): under `qkv_proj`, `fc1`, `ff`
    (the decoder's class projection);
  * row-parallel (kernel P("model", None)): under `out_proj`, `fc2`,
    `reprojection`;
  * everything else (biases, norms, convs, subsampling): replicated.
A leaf whose dimension does not divide the axis is replicated
(`leaf_spec`).  Specs are tuples of axis names or None, as PartitionSpecs
are.

The port computes the same function with its own cut (`tp_layout`): JAX's
qkv kernel is one (d, 3 H D) matrix whose contiguous column split is not a
split by head, so the port splits q, k and v each by heads (H / model heads
a rank), and an attention or a feed-forward is split only when its heads or
hidden units divide the axis.  A row-parallel layer keeps its whole bias,
added once after the all-reduce; a column-parallel one cuts its bias with
its outputs.  `shard_state_dict` / `gather_state_dict` go between whole
tensors and a rank's shards by that layout, so a checkpoint holds whole
tensors under the port's names and restores onto any mesh or onto none,
as JAX's Orbax arrays do.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from lcasr_torch.parallel.collectives import Axis, gather_along

COLUMN_PARALLEL_LEAVES = ("qkv_proj", "fc1", "ff")
ROW_PARALLEL_LEAVES = ("out_proj", "fc2", "reprojection")


def param_spec(path: Sequence[str]) -> Tuple:
    """The spec of a flax leaf by the names on its path ("layers_0",
    "attend", "qkv_proj", "kernel")."""
    names = list(path)
    if not names or names[-1] != "kernel":
        return ()
    parents = names[:-1]
    if any(n in COLUMN_PARALLEL_LEAVES for n in parents):
        return (None, "model")
    if any(n in ROW_PARALLEL_LEAVES for n in parents):
        return ("model", None)
    return ()


def leaf_spec(path: Sequence[str], shape: Sequence[int], mesh_shape: Mapping[str, int]) -> Tuple:
    """`param_spec`, replicated where a sharded dimension does not divide
    its axis (JAX `param_shardings`)."""
    spec = param_spec(path)
    for dim, axis in zip(shape, spec):
        if axis is not None and dim % mesh_shape.get(axis, 1) != 0:
            return ()
    return spec


def zero_spec(spec: Tuple, shape: Sequence[int], mesh_shape: Mapping[str, int]) -> Tuple:
    """ZeRO: also shard the largest currently unsharded dimension that the
    `data` axis divides over `data` (unchanged when none does or data is
    1).  The port's ZeRO (`optim/zero.py`) cuts every tensor flat instead,
    which needs no divisible dimension; this rule is the JAX layout."""
    d = mesh_shape.get("data", 1)
    if d <= 1:
        return tuple(spec)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, 0
    for i, (dim, ax) in enumerate(zip(shape, entries)):
        if ax is None and dim % d == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best < 0:
        return tuple(spec)
    entries[best] = "data"
    return tuple(entries)


def flax_path(prefix: str) -> Tuple[str, ...]:
    """The flax names of a port module prefix ("layers.3.attend.qkv_proj"
    -> ("layers_3", "attend", "qkv_proj"))."""
    out = []
    for part in prefix.split("."):
        if part.isdigit() and out:
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return tuple(out)


def tp_layout(model, size: int) -> Dict[str, str]:
    """{Dense prefix: mode} of the port's tensor-parallel cut of an
    SCConformerXL over `size` ranks.  Modes: "col_heads" (qkv by heads),
    "col", "col_gather" (the decoder's class projection, gathered back),
    "row", "row_split" (the reprojection, which cuts its whole input)."""
    from lcasr_torch.ops.dense import Dense

    layout = {}
    for prefix, m in model.named_modules():
        if not isinstance(m, Dense) or param_spec(flax_path(prefix) + ("kernel",)) == ():
            continue
        parent = model.get_submodule(prefix.rsplit(".", 1)[0]) if "." in prefix else model
        leaf = prefix.rsplit(".", 1)[-1]
        col = param_spec(flax_path(prefix) + ("kernel",)) == (None, "model")
        if leaf in ("qkv_proj", "out_proj"):
            ok = parent.n_heads % size == 0
        else:
            ok = (m.weight.shape[0] if col else m.weight.shape[1]) % size == 0
        if not ok:
            continue
        if leaf == "qkv_proj":
            layout[prefix] = "col_heads"
        elif leaf == "ff" and prefix.startswith("decoder"):
            layout[prefix] = "col_gather"
        elif leaf == "reprojection":
            layout[prefix] = "row_split"
        else:
            layout[prefix] = "col" if col else "row"
    return layout


def _split(key: str, layout: Mapping[str, str]):
    prefix, _, leaf = key.rpartition(".")
    return layout.get(prefix), leaf


def shard_tensor(key: str, full: torch.Tensor, layout: Mapping[str, str], index: int,
                 size: int, heads: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """Rank `index`'s shard of the whole tensor `key` (a parameter, or
    optimizer state shaped like one).  `heads[prefix]` is the whole head
    count of a "col_heads" layer."""
    mode, leaf = _split(key, layout)
    if mode is None or (leaf == "bias" and mode in ("row", "row_split")):
        return full
    if mode == "col_heads":
        H = heads[key.rpartition(".")[0]]
        h = H // size
        shaped = full.reshape((3, H, -1) + tuple(full.shape[1:]))
        return shaped[:, index * h:(index + 1) * h].reshape((-1,) + tuple(full.shape[1:]))
    dim = 0 if mode.startswith("col") else 1
    n = full.shape[dim] // size
    return full.narrow(dim, index * n, n)


def gather_tensor(key: str, local: torch.Tensor, layout: Mapping[str, str], axis: Axis
                  ) -> torch.Tensor:
    """The whole tensor from every rank's shard (an all-gather over the
    model axis; every rank gets it)."""
    mode, leaf = _split(key, layout)
    if mode is None or (leaf == "bias" and mode in ("row", "row_split")):
        return local
    if mode == "col_heads":
        g = gather_along(local.contiguous(), axis.group, axis.size, 0)  # (M * 3 h D, ...)
        shaped = g.reshape((axis.size, 3, -1) + tuple(local.shape[1:]))
        return shaped.transpose(0, 1).reshape((-1,) + tuple(local.shape[1:]))
    dim = 0 if mode.startswith("col") else 1
    return gather_along(local.contiguous(), axis.group, axis.size, dim)


def shard_state_dict(full: Mapping[str, torch.Tensor], layout: Mapping[str, str], index: int,
                     size: int, heads: Optional[Mapping[str, int]] = None
                     ) -> Dict[str, torch.Tensor]:
    """One rank's state_dict from a whole one."""
    return {k: shard_tensor(k, v, layout, index, size, heads) for k, v in full.items()}


def gather_state_dict(local: Mapping[str, torch.Tensor], layout: Mapping[str, str],
                      axis: Axis) -> Dict[str, torch.Tensor]:
    """The whole state_dict from every rank's (all ranks call it)."""
    return {k: gather_tensor(k, v, layout, axis) for k, v in local.items()}
