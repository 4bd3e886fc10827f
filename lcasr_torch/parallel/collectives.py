"""The collectives of the parallel paths, each an autograd Function with its
adjoint (counterparts of the psum / all_gather / ppermute that JAX places
inside shard_map and of the collectives XLA inserts under pjit).

  forward                          backward
  all_reduce_sum: all-reduce       all-reduce (a sum over ranks that hold
                                   different data: batch-norm statistics)
  copy_to: identity                all-reduce (enters a tensor-parallel
                                   region whose ranks hold the same data)
  reduce_from: all-reduce          identity (leaves it: row-parallel output)
  gather_from: all-gather          this rank's slice (the gathered tensor
                                   feeds a computation every rank repeats)
  all_gather_seq: all-gather       reduce-scatter (K / V of context-parallel
                                   attention, each rank's queries read all)
  halo_exchange: edge frames from  the halo's gradient sent back and added
  the ring neighbours              into the neighbour's edge

Every call is issued whatever the group's size.  `Axis` names a mesh axis
for these functions: its group, this rank's index on it, its size and the
global ranks of its line (point-to-point ops address global ranks).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.distributed as dist

# torch >= 2.12 renames the tensor forms (all_gather_single, ...); the old
# names work on every version this port runs on
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)"
                        r".* is deprecated", category=FutureWarning)


@dataclass(frozen=True)
class Axis:
    group: object
    index: int
    size: int
    ranks: Sequence[int]

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        return cls(mesh.group(name), mesh.index(name), mesh.size(name), tuple(mesh.ranks(name)))


def _front(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


def gather_along(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """all_gather_into_tensor of x along `dim` (rank order), no autograd."""
    xf = _front(x, dim)
    out = torch.empty((size * xf.shape[0],) + xf.shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xf, group=group)
    return out.movedim(0, dim)


def reduce_scatter_along(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """reduce_scatter_tensor (sum) of x along `dim`, no autograd."""
    xf = _front(x, dim)
    out = torch.empty((xf.shape[0] // size,) + xf.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xf, group=group)
    return out.movedim(0, dim)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis, dim: int):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return gather_along(x, axis.group, axis.size, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n).contiguous(), None, None


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis, dim: int):
        ctx.axis, ctx.dim = axis, dim
        return gather_along(x, axis.group, axis.size, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_along(g, ctx.axis.group, ctx.axis.size, ctx.dim), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, axis, dim)


def all_gather_seq(x: torch.Tensor, axis: Axis, dim: int = 1) -> torch.Tensor:
    return _AllGatherSeq.apply(x, axis, dim)


def p2p_start(ops: List[tuple], group) -> list:
    """One batch_isend_irecv of (kind "send" | "recv", tensor, global peer,
    tag) tuples; returns the requests to wait for.  Nothing is issued for
    an empty list (an axis of size 1 has no neighbour)."""
    if not ops:
        return []
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend if kind == "send" else dist.irecv, t, peer, group, tag)
        for kind, t, peer, tag in ops])


def p2p(ops: List[tuple], group) -> None:
    """`p2p_start`, waited for."""
    for r in p2p_start(ops, group):
        r.wait()


def _edge(x: torch.Tensor, dim: int, start: int, n: int) -> torch.Tensor:
    return x.narrow(dim, start, n).contiguous()


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis, left: int, right: int, dim: int):
        ctx.axis, ctx.left, ctx.right, ctx.dim = axis, left, right, dim
        i, n, T = axis.index, axis.size, x.shape[dim]
        ops, parts = [], []
        if left > 0:
            shape = list(x.shape)
            shape[dim] = left
            halo = torch.zeros(shape, dtype=x.dtype, device=x.device)
            if i + 1 < n:  # receiver i + 1 takes our last `left` frames
                ops.append(("send", _edge(x, dim, T - left, left), axis.ranks[i + 1], 0))
            if i > 0:
                ops.append(("recv", halo, axis.ranks[i - 1], 0))
            parts.append(halo)
        parts.append(x)
        if right > 0:
            shape = list(x.shape)
            shape[dim] = right
            halo = torch.zeros(shape, dtype=x.dtype, device=x.device)
            if i > 0:
                ops.append(("send", _edge(x, dim, 0, right), axis.ranks[i - 1], 1))
            if i + 1 < n:
                ops.append(("recv", halo, axis.ranks[i + 1], 1))
            parts.append(halo)
        p2p(ops, axis.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        axis, left, right, dim = ctx.axis, ctx.left, ctx.right, ctx.dim
        i, n = axis.index, axis.size
        T = g.shape[dim] - left - right
        gx = g.narrow(dim, left, T).clone()
        ops, back = [], []
        if left > 0:  # our left halo came from i - 1's tail: its gradient goes back
            if i > 0:
                ops.append(("send", _edge(g, dim, 0, left), axis.ranks[i - 1], 0))
            if i + 1 < n:
                buf = torch.empty_like(_edge(gx, dim, T - left, left))
                ops.append(("recv", buf, axis.ranks[i + 1], 0))
                back.append((T - left, left, buf))
        if right > 0:
            if i + 1 < n:
                ops.append(("send", _edge(g, dim, left + T, right), axis.ranks[i + 1], 1))
            if i > 0:
                buf = torch.empty_like(_edge(gx, dim, 0, right))
                ops.append(("recv", buf, axis.ranks[i - 1], 1))
                back.append((0, right, buf))
        p2p(ops, axis.group)
        for start, size, buf in back:
            gx.narrow(dim, start, size).add_(buf)
        return gx, None, None, None, None


def halo_exchange(x: torch.Tensor, axis: Axis, left: int, right: int, dim: int = 1
                  ) -> torch.Tensor:
    """Prepend the last `left` frames of the previous shard and append the
    first `right` frames of the next one along `dim`; the edge shards
    receive zeros, which is the global convolution's 'same' zero padding
    (lcasr_tpu/ops/conv.py `halo_exchange`)."""
    return _HaloExchange.apply(x, axis, left, right, dim)
