"""Process mesh: the (data, model, seq) axes over torch.distributed process
groups (counterpart of lcasr_tpu/parallel/mesh.py `maybe_init_distributed`
and `make_mesh`).

One process per GPU, as `torchrun` launches them.  Ranks lie on the mesh
in row-major order over (data, model, seq), as JAX reshapes its device list:
rank = (d * model + m) * seq + s.  Each axis has one process group per line
of the mesh along it; a rank keeps the group of its own line.  Collectives
are explicit calls on those groups (`parallel/collectives.py`), issued
whatever the axis size, so a mesh of one runs the same calls as a mesh of
eight.

Axes:
  * data  - batch sharding: each rank takes B / data rows, the gradient is
            all-reduced once per optimizer step (ZeRO: reduce-scattered);
  * model - tensor parallelism: column- and row-parallel projections
            (`parallel/tensor_parallel.py`);
  * seq   - context parallelism: the time axis of one recording sharded
            (`parallel/cp_model.py`).
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model", "seq")


def world_size() -> int:
    """The size of the initialised world, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def maybe_init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    init_method: Optional[str] = None,
    timeout: Optional[float] = None,
) -> bool:
    """Join the process group when something asks for a world: `torchrun`'s
    variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT) or
    the explicit arguments, which win (`coordinator_address` "host:port",
    or an `init_method` such as "file:///path").  A no-op returning False
    when neither is there, as the JAX function is; True when the group is
    up (also when it already was).

    NCCL on CUDA (the default device) with the CUDA device set to
    LOCAL_RANK; gloo only for `device="cpu"`.  There is no fallback from
    one to the other: a failed NCCL initialisation raises.  `timeout`
    (seconds) bounds every collective of the group."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and init_method is None and num_processes is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("maybe_init_distributed needs the number of processes and this "
                         f"process's id (got {num_processes}, {process_id})")
    if init_method is None:
        if coordinator_address is None:
            coordinator_address = f"{env.get('MASTER_ADDR', 'localhost')}:" \
                                  f"{env.get('MASTER_PORT', '29500')}"
        init_method = f"tcp://{coordinator_address}"
    device = torch.device(device) if device is not None else torch.device("cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("maybe_init_distributed: NCCL needs a CUDA device and none "
                               "is available; pass device='cpu' for a gloo world")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"maybe_init_distributed: no backend for device {device}")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, rank=process_id,
                            world_size=num_processes, **kw)
    return True


class Mesh:
    """The named axes of the world's first data x model x seq ranks, and
    this rank's place on them.  `size(axis)`, `index(axis)` and
    `group(axis)` (the process group of this rank's line along the axis;
    `ranks(axis)` lists its global ranks in axis order)."""

    def __init__(self, shape: Dict[str, int], rank: int, groups: Dict[str, object],
                 lines: Dict[str, Sequence[int]]):
        self.shape = dict(shape)
        self.rank = rank
        self._groups = groups
        self._lines = {ax: list(r) for ax, r in lines.items()}
        d, m, s = (self.shape[ax] for ax in AXES)
        self.coords = {"data": rank // (m * s), "model": (rank // s) % m, "seq": rank % s}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def ranks(self, axis: str):
        return self._lines[axis]

    def axis(self, axis: str):
        """The `collectives.Axis` of one axis of this rank."""
        from lcasr_torch.parallel.collectives import Axis

        return Axis.of(self, axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def make_mesh(shape: Optional[Dict[str, int]] = None) -> Mesh:
    """Build the mesh over the initialised world.  Default: every rank on
    `data`.  The product of the axes must not exceed the world size
    ("needs n devices, have m"); trailing ranks are left out, as JAX drops
    trailing devices, and get no mesh (they raise).  Every rank calls this,
    in the same order, because each group is created by all ranks."""
    have = world_size()
    if not shape:
        shape = {"data": have}
    unknown = set(shape) - set(AXES)
    if unknown:
        raise ValueError(f"mesh shape: unknown axes {sorted(unknown)} (axes: {AXES})")
    shape = {ax: int(shape.get(ax, 1)) for ax in AXES}
    n = shape["data"] * shape["model"] * shape["seq"]
    if n > have:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {have}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call maybe_init_distributed first "
                           "(or init_process_group)")
    me = dist.get_rank()
    d, m, s = shape["data"], shape["model"], shape["seq"]
    grid = torch.arange(n).reshape(d, m, s)
    groups, lines = {}, {}
    for ax, dim in zip(AXES, range(3)):
        moved = grid.movedim(dim, -1).reshape(-1, grid.shape[dim])
        for line in moved.tolist():
            g = dist.new_group(line)
            if me in line:
                groups[ax], lines[ax] = g, line
    if me >= n:
        raise ValueError(f"rank {me} lies outside the mesh {shape} (world {have})")
    return Mesh(shape, me, groups, lines)


class ParallelState:
    """What a model's modules need of the mesh: the `seq` axis name when the
    time axis is sharded (context parallelism), the attention's CP form
    (`gather` | `ring`) and the axes over which batch-norm statistics are
    summed (`stat_axes`).  A model holds one, shared by reference with the
    modules that read it (`bind`); the names resolve to process groups only
    once a mesh is set, as JAX's axis names resolve only inside shard_map."""

    def __init__(self, mesh: Optional[Mesh] = None, seq_axis: Optional[str] = None,
                 cp_impl: str = "gather", stat_axes: Sequence[str] = ()):
        if cp_impl not in ("gather", "ring"):
            raise ValueError(f"attention_cp_impl must be gather|ring, got {cp_impl!r}")
        unknown = set(stat_axes) - set(AXES)
        if unknown or (seq_axis is not None and seq_axis not in AXES):
            raise ValueError(f"unknown mesh axes {sorted(unknown) or [seq_axis]} (axes: {AXES})")
        self.mesh, self.seq_axis, self.cp_impl = mesh, seq_axis, cp_impl
        self.stat_axes = tuple(stat_axes)

    def _need_mesh(self, what: str) -> Mesh:
        if self.mesh is None:
            raise ValueError(f"{what} needs a mesh: run the model through "
                             "parallel.context_parallel_apply or give it one with "
                             "parallel.bind_mesh")
        return self.mesh

    def seq(self):
        """The `collectives.Axis` of the sharded time axis, or None."""
        if self.seq_axis is None:
            return None
        return self._need_mesh(f"seq_axis_name={self.seq_axis!r}").axis(self.seq_axis)

    def stat_groups(self):
        """[(axis name, process group)] of the statistics axes."""
        if not self.stat_axes:
            return []
        mesh = self._need_mesh(f"stat_axes={self.stat_axes}")
        return [(ax, mesh.group(ax)) for ax in self.stat_axes]

    def replace(self, **kw) -> "ParallelState":
        args = dict(mesh=self.mesh, seq_axis=self.seq_axis, cp_impl=self.cp_impl,
                    stat_axes=self.stat_axes)
        args.update(kw)
        return ParallelState(**args)


NO_PARALLEL = ParallelState()


def bind(model, state: ParallelState) -> None:
    """Share `state` with every module of `model` that reads one."""
    for m in model.modules():
        if hasattr(m, "parallel"):
            m.parallel = state
