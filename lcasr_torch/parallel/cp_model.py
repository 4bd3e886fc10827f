"""Full-model context parallelism (counterpart of
lcasr_tpu/parallel/cp_model.py `context_parallel_apply`).

Each rank of the `seq` axis runs the model on its own time shard of the
audio, with the lengths global.  The model is CP-native once its
`ParallelState` names the axis (`models/sconformer_xl.py`): the
subsampling's stride-2 stages and the conformer convs take their padding
from the neighbouring shards, rotary tables, positions and masks run at
global positions, attention gathers K / V or rotates them around the ring,
and batch-renorm statistics are summed over `stat_axes`.
"""
from __future__ import annotations

from typing import Optional

import torch

from lcasr_torch.parallel.collectives import gather_from
from lcasr_torch.parallel.mesh import bind


def bind_mesh(model, mesh, seq_axis: Optional[str] = None, stat_axes=()):
    """Give `model` (and its modules) the mesh: the time axis sharded over
    `seq_axis` (None: not sharded), statistics summed over `stat_axes`.
    Any family: those without a time-sharded path take no `seq_axis`.
    `mesh=None` returns the model to one device.  Returns the model."""
    state = getattr(model, "parallel", None)
    if state is None:
        from lcasr_torch.parallel.mesh import NO_PARALLEL as state
    if seq_axis is not None:
        from lcasr_torch.parallel.tensor_parallel import refuse_family

        refuse_family(model, "context parallelism")
    state = state.replace(mesh=mesh, seq_axis=seq_axis, stat_axes=tuple(stat_axes))
    if hasattr(model, "parallel"):
        model.parallel = state
    bind(model, state)
    return model


def shard_time(x: torch.Tensor, mesh, seq_axis: str = "seq", dim: int = -1) -> torch.Tensor:
    """This rank's contiguous shard of `x` along its time dimension."""
    n, i = mesh.size(seq_axis), mesh.index(seq_axis)
    T = x.shape[dim]
    if T % n:
        raise ValueError(f"T={T} must divide the seq shards ({n})")
    return x.narrow(dim, i * (T // n), T // n)


def context_parallel_apply(model, audio: torch.Tensor, mesh,
                           lengths: Optional[torch.Tensor] = None, train: bool = False,
                           seq_axis: str = "seq", data_axis: Optional[str] = None,
                           gather: bool = False):
    """The model on this rank's shard `audio` (B, feat, T / n) of a batch
    whose lengths (B,) are global.  The global T must be a multiple of n x
    the subsampling factor, so that every stride-2 stage sees an even local
    length.  With `data_axis` of size > 1 the batch is also sharded over it
    (the rows are this rank's) and the statistics are summed over both axes
    (data x seq, the Trainer's layout).  Returns the model's dict: the
    posteriors of this shard, or with `gather` those of the whole sequence
    (an all-gather whose backward keeps this shard's gradient).  The model
    stays bound to the mesh afterwards (a checkpointed backward re-runs it
    so); `bind_mesh(model, None)` returns it to one device."""
    n = mesh.size(seq_axis)
    sf = getattr(model, "subsampling_factor", 8)
    if audio.shape[-1] % sf:
        raise ValueError(f"T={audio.shape[-1] * n} must divide seq shards ({n}) x "
                         f"subsampling factor ({sf})")
    stat_axes = (seq_axis,)
    if data_axis is not None and mesh.size(data_axis) > 1:
        stat_axes = (data_axis, seq_axis)
    bind_mesh(model, mesh, seq_axis=seq_axis, stat_axes=stat_axes)
    if lengths is None:
        lengths = torch.full((audio.shape[0],), audio.shape[-1] * n, dtype=torch.int32,
                             device=audio.device)
    out = model(audio, length=lengths, train=train)
    if gather:
        out = dict(out, final_posteriors=gather_from(out["final_posteriors"],
                                                     mesh.axis(seq_axis), dim=1))
    return out
