"""Tensor parallelism in the model (the counterpart of what XLA makes of
lcasr_tpu's `param_shardings` on the `model` axis).

`parallelize(model, mesh)` cuts an SCConformerXL in place into this rank's
shard of the `partition.tp_layout`: every attention by heads (q, k and v
each, H / model heads a rank; `out_proj` row-parallel), every feed-forward
by hidden units (`fc1` column-, `fc2` row-parallel), the decoder's class
projection by classes (gathered back before the softmax) and its
reprojection by classes (row-parallel).  A row-parallel output is
all-reduced over `model` and its bias added once; the replicated layers
run on every rank alike, and their gradients are whole on every rank
(the `copy_to` at each parallel region's entry all-reduces the input's
gradient).  Other families raise: only SCConformerXL has the layout
(`configs/lcasr_3l_2048d_16h_tp.yaml`).
"""
from __future__ import annotations

from typing import Dict

from torch import nn

from lcasr_torch.parallel.partition import shard_tensor, tp_layout


def refuse_family(model, what: str) -> None:
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    if not isinstance(model, SCConformerXL):
        raise NotImplementedError(f"{what} is ported for SCConformerXL only, not for "
                                  f"{type(model).__name__}")


def head_counts(model, layout) -> Dict[str, int]:
    """{qkv prefix: whole head count} of the "col_heads" layers."""
    return {p: model.get_submodule(p.rsplit(".", 1)[0]).n_heads
            for p, mode in layout.items() if mode == "col_heads"}


def parallelize(model, mesh, axis_name: str = "model"):
    """Cut `model` (whole weights, the same on every rank) into this rank's
    tensor-parallel shard; sets `model.tp_layout`, `model.tp_heads` (the
    whole head counts) and `model.tp_axis`.  Returns the model."""
    refuse_family(model, "tensor parallelism")
    axis = mesh.axis(axis_name)
    layout = tp_layout(model, axis.size)
    heads = head_counts(model, layout)
    for prefix, mode in layout.items():
        dense = model.get_submodule(prefix)
        for leaf in ("weight", "bias"):
            p = getattr(dense, leaf)
            if p is not None:
                cut = shard_tensor(f"{prefix}.{leaf}", p.detach(), layout, axis.index,
                                   axis.size, heads)
                setattr(dense, leaf, nn.Parameter(cut.clone(), requires_grad=p.requires_grad))
        dense.tp = (mode, axis)
        if mode == "col_heads":
            model.get_submodule(prefix.rsplit(".", 1)[0]).n_heads //= axis.size
    model.tp_layout, model.tp_heads, model.tp_axis = layout, heads, axis
    return model
