"""ZeRO: the optimizer state sharded over the `data` axis (counterpart of
lcasr_tpu/parallel/partition.py `zero_spec` / `opt_state_shardings` and the
JAX Trainer's `_grads_sh` / `_opt_sh` under `zero_optimizer: true`).

The trainable parameters live back to back in one flat fp32 buffer, in
the model's order, its length padded to a multiple of `data`; every
parameter is a view of it.  Rank r owns the contiguous range
[r * shard, (r + 1) * shard) of the buffer, and its optimizer runs on the
pieces of the parameters that fall in that range, which are views of the
buffer too: MADGRAD keeps its three fp32 tensors for 1 / data of the
values, and an update lands in the parameters.  The Trainer accumulates
the gradient in a buffer of the same layout (`flat_buffer`).  An optimizer
step: one reduce-scatter of that buffer gives each rank the summed
gradient of its range, the optimizer updates the pieces (clipped by the
global norm, which the Trainer sums over the pieces), and one all-gather
of the ranges puts the whole parameter buffer back on every rank.  Both
collectives work in place, so ZeRO adds no buffer to the parameters and
the gradient, which a step without a mesh holds as well.  The
optimizers are elementwise, so the result is the unsharded step's.  A
checkpoint gathers the state back to whole tensors (`gather`), so it
resumes on any mesh.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from lcasr_torch.parallel.collectives import Axis


def flat_buffer(tensors: Sequence[torch.Tensor], multiple: int = 1, copy: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One zeroed fp32 buffer that holds `tensors` back to back in their
    order, its length padded to a multiple of `multiple`, and views of it
    in their shapes (with `copy`, holding their values)."""
    dtypes = {t.dtype for t in tensors}
    if dtypes != {torch.float32}:
        raise ValueError(f"a flat gradient / parameter buffer takes fp32 parameters only, "
                         f"got {sorted(str(d) for d in dtypes)}")
    numel = sum(t.numel() for t in tensors)
    flat = torch.zeros(-(-numel // multiple) * multiple, dtype=torch.float32,
                       device=tensors[0].device)
    views, o = [], 0
    for t in tensors:
        v = flat[o:o + t.numel()].view(t.shape)
        if copy:
            v.copy_(t.detach())
        views.append(v)
        o += t.numel()
    return flat, views


class ZeroShards:
    """`params` moved into one flat buffer cut over `axis` (see the module
    docstring).  `pieces` lists this rank's (parameter index, start, end)
    in the buffer, in the parameters' order."""

    def __init__(self, params: Sequence[torch.nn.Parameter], axis: Axis):
        self.axis = axis
        self.shapes = [tuple(p.shape) for p in params]
        self.flat, views = flat_buffer(params, axis.size, copy=True)
        with torch.no_grad():
            for p, v in zip(params, views):
                p.data = v
        self.shard = self.flat.numel() // axis.size
        total = sum(p.numel() for p in params)
        if (axis.size - 1) * self.shard >= total:  # the same verdict on every rank
            raise ValueError(f"zero_optimizer: {total} parameter values leave the last of "
                             f"{axis.size} data ranks without any")
        self.lo = axis.index * self.shard
        self.offsets, self.pieces, o = [], [], 0
        for i, p in enumerate(params):
            a, b = max(o, self.lo), min(o + p.numel(), self.lo + self.shard)
            if a < b:
                self.pieces.append((i, a, b))
            self.offsets.append(o)
            o += p.numel()

    def local(self) -> List[torch.Tensor]:
        """This rank's pieces: views of the parameter buffer."""
        return [self.flat[a:b] for _, a, b in self.pieces]

    def reduce_scatter(self, flat_grad: torch.Tensor) -> List[torch.Tensor]:
        """This rank's pieces of the sum over the axis of a gradient buffer
        in the parameters' layout, in place: the sum lands in this rank's
        own range of `flat_grad` (NCCL's in-place form; the rest of the
        buffer is left undefined).  Returns views of it."""
        dist.reduce_scatter_tensor(flat_grad[self.lo:self.lo + self.shard], flat_grad,
                                   group=self.axis.group)
        return [flat_grad[a:b] for _, a, b in self.pieces]

    def all_gather(self) -> None:
        """Every rank's (updated) range back into the parameter buffer, in
        place (this rank's range is its own slot of the output)."""
        dist.all_gather_into_tensor(self.flat, self.flat[self.lo:self.lo + self.shard],
                                    group=self.axis.group)

    def gather(self, pieces: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors in the parameters' shapes, one a parameter, from
        every rank's `pieces` (one tensor a piece, in `pieces` order, such
        as one optimizer state): one all-gather."""
        mine = torch.zeros(self.shard, dtype=pieces[0].dtype, device=pieces[0].device)
        for (_, a, b), v in zip(self.pieces, pieces):
            mine[a - self.lo:b - self.lo] = v.reshape(-1)
        whole = torch.empty(self.flat.numel(), dtype=mine.dtype, device=mine.device)
        dist.all_gather_into_tensor(whole, mine, group=self.axis.group)
        return [whole[o:o + int(torch.Size(s).numel())].view(s)
                for o, s in zip(self.offsets, self.shapes)]

    def cut(self, i: int, a: int, b: int, whole: torch.Tensor) -> torch.Tensor:
        """The piece [a, b) of the buffer out of `whole`, a tensor shaped
        like parameter i."""
        o = self.offsets[i]
        return whole.reshape(-1)[a - o:b - o].clone()
