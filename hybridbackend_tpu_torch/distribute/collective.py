"""Collectives across the ranks of a world.

Counterpart of ``hybridbackend_tpu/distribute/collective.py``: its
array-level ops (``allreduce``, ``broadcast``, ``allgather``,
``alltoall``) and its fixed-capacity ``all_to_all_v_t`` (``:180-210``),
over ``torch.distributed`` instead of ``shard_map``. Each op takes the
rank's local tensor and the :class:`~hybridbackend_tpu_torch.framework.
context.Context` of the world, and returns a new tensor; in a world of
one that was never joined it returns its input's values without any
collective. Every exchange has equal splits, so it maps onto the
backends' single-tensor calls (``all_to_all_single``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``), which NCCL and
gloo both take for CUDA tensors; gloo copies those through the host
itself.

Only ``Topology.ALL`` (every rank) and float32 on the wire are ported:
the intra- and inter-node topologies and the wire dtypes
(``collective.py:79-103``) are ROADMAP item 15b.
"""

from __future__ import annotations

import enum
from typing import Tuple

import torch

from hybridbackend_tpu_torch.framework.context import Context


class Topology(enum.IntEnum):
  """Which ranks a collective spans (``collective.py:50-61``)."""
  ALL = 0
  INTRA_NODE = 1
  INTER_NODE = 2


def _dist(topology: Topology):
  if topology != Topology.ALL:
    raise NotImplementedError(
        f'{topology!r}: only Topology.ALL is ported; the hierarchical '
        'topologies are ROADMAP item 15b (3)')
  import torch.distributed as dist
  return dist


_REDUCTIONS = ('sum', 'max', 'min', 'mean')


def allreduce(x: torch.Tensor, reduction: str = 'sum', *, ctx: Context,
              topology: Topology = Topology.ALL) -> torch.Tensor:
  """``reduction`` (``'sum'``, ``'max'``, ``'min'`` or ``'mean'``) of
  ``x`` over the ranks, on every rank. ``'mean'`` is the sum over the
  ranks divided by the world (float tensors)."""
  if reduction not in _REDUCTIONS:
    raise ValueError(f'Unsupported reduction: {reduction}')
  dist = _dist(topology)
  out = x.clone(memory_format=torch.contiguous_format)
  if ctx.distributed:
    op = {'max': dist.ReduceOp.MAX,
          'min': dist.ReduceOp.MIN}.get(reduction, dist.ReduceOp.SUM)
    dist.all_reduce(out, op=op, group=ctx.group)
  if reduction == 'mean':
    out /= ctx.world_size
  return out


def broadcast(x: torch.Tensor, root: int = 0, *, ctx: Context,
              topology: Topology = Topology.ALL) -> torch.Tensor:
  """Rank ``root``'s ``x`` on every rank."""
  dist = _dist(topology)
  out = x.clone(memory_format=torch.contiguous_format)
  if ctx.distributed:
    dist.broadcast(out, src=root, group=ctx.group)
  return out


def allgather(x: torch.Tensor, *, ctx: Context,
              topology: Topology = Topology.ALL) -> torch.Tensor:
  """The ranks' ``x`` concatenated in rank order along the leading
  dimension: ``[W·n, ...]`` from ``[n, ...]`` (JAX ``all_gather`` with
  ``tiled=True``). Every rank's ``x`` has one shape."""
  dist = _dist(topology)
  if not ctx.distributed:
    return x.clone()
  out = x.new_empty((ctx.world_size * x.shape[0],) + tuple(x.shape[1:]))
  gather = getattr(dist, 'all_gather_single', None) or (
      dist.all_gather_into_tensor)
  gather(out, x.contiguous(), group=ctx.group)
  return out


def alltoall(x: torch.Tensor, *, ctx: Context,
             topology: Topology = Topology.ALL) -> torch.Tensor:
  """Row block ``i`` of ``x`` (``[W·k, ...]``) to rank ``i``; returns the
  blocks received, in rank order (JAX ``all_to_all`` with
  ``tiled=True``)."""
  dist = _dist(topology)
  if x.shape[0] % ctx.world_size:
    raise ValueError(f'alltoall: {x.shape[0]} rows do not split over a '
                     f'world of {ctx.world_size}')
  if not ctx.distributed:
    return x.clone()
  out = torch.empty_like(x, memory_format=torch.contiguous_format)
  dist.all_to_all_single(out, x.contiguous(), group=ctx.group)
  return out


def reduce_scatter(x: torch.Tensor, *, ctx: Context,
                   topology: Topology = Topology.ALL) -> torch.Tensor:
  """The sum over the ranks of block ``r`` of ``x`` (``[W, ...]``), on
  rank ``r`` (JAX ``psum_scatter`` with ``tiled=False``)."""
  dist = _dist(topology)
  if x.shape[0] != ctx.world_size:
    raise ValueError(f'reduce_scatter: leading dimension {x.shape[0]}, '
                     f'world {ctx.world_size}')
  if not ctx.distributed:
    return x[0].clone()
  out = x.new_empty(tuple(x.shape[1:]))
  scatter = getattr(dist, 'reduce_scatter_single', None) or (
      dist.reduce_scatter_tensor)
  # Flat, as gloo splits the input's leading dimension by the world.
  scatter(out.view(-1), x.contiguous().view(-1), group=ctx.group)
  return out


def all_to_all_v(buckets: torch.Tensor, sizes: torch.Tensor, *,
                 ctx: Context, topology: Topology = Topology.ALL
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The fixed-capacity variable all-to-all of ``all_to_all_v_t``
  (``collective.py:180-210``): the per-peer sizes first, then the
  buckets.

  Args:
    buckets: ``[W, capacity, ...]``; row ``i`` is the padded payload for
      rank ``i``.
    sizes: ``[W]`` int32, the valid rows of each bucket.

  Returns ``(recv [W, capacity, ...], recv_sizes [W])``: ``recv[j]`` is
  the bucket rank ``j`` sent here, ``recv_sizes[j]`` its valid rows. The
  padding lanes travel too, as in JAX: the capacity, not the sizes,
  fixes the payload."""
  if buckets.shape[0] != ctx.world_size or sizes.shape != (ctx.world_size,):
    raise ValueError(f'all_to_all_v: buckets {tuple(buckets.shape)} and '
                     f'sizes {tuple(sizes.shape)} in a world of '
                     f'{ctx.world_size}')
  recv_sizes = alltoall(sizes, ctx=ctx, topology=topology)
  return alltoall(buckets, ctx=ctx, topology=topology), recv_sizes


__all__ = ['Topology', 'all_to_all_v', 'allgather', 'allreduce', 'alltoall',
           'broadcast', 'reduce_scatter']
