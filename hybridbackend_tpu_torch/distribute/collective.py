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

``allreduce``, ``allgather``, ``alltoall`` and ``all_to_all_v`` take a
``wire_dtype`` (``_with_wire_cast`` and ``_norm_wire``, ``:85-95`` and
``:281-285``): a float payload is cast to it before the call and back to
its own dtype after it, so a sum runs in the wire dtype on the backend.
``None`` and ``'float32'`` leave the payload as it is, and so does an
integer payload; ``'bfloat16'`` and ``'float16'`` are the only casts, and
any other name raises a ``ValueError``. ``reduce_scatter`` stays at the
payload's precision, as the JAX lookup keeps its ``psum_scatter``. A
backend that refuses the wire dtype raises a ``TypeError`` that names
the dtype and the backend; nothing is sent at a wider dtype instead.
Any other failure of the call (a timeout, a lost peer) comes out as the
backend raised it.

Only ``Topology.ALL`` (every rank) is ported: the intra- and inter-node
topologies are ROADMAP item 15b (3).
"""

from __future__ import annotations

import enum
import re
from typing import Callable, Optional, Tuple, Union

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
WireDtype = Optional[Union[str, torch.dtype]]


_WIRES = {'bfloat16': torch.bfloat16, 'float16': torch.float16}


def wire_dtype_of(wire_dtype: WireDtype) -> Optional[torch.dtype]:
  """The torch dtype that ``wire_dtype`` names (``'bfloat16'`` or
  ``'float16'``, a name or a dtype), or None for ``None``, ``''`` and
  ``'float32'``: no cast (JAX ``_norm_wire``). Any other dtype raises a
  ``ValueError``: a wire never widens the payload, and the backends were
  probed in these two."""
  if isinstance(wire_dtype, torch.dtype):
    wire_dtype = str(wire_dtype).replace('torch.', '')
  if wire_dtype in (None, '', 'float32'):
    return None
  if wire_dtype not in _WIRES:
    raise ValueError(f'wire dtype {wire_dtype!r} is not one of None, '
                     "'float32', 'bfloat16' or 'float16'")
  return _WIRES[wire_dtype]


# What a backend says when it refuses a tensor's dtype: gloo "Invalid
# scalar type", NCCL "... data type is not supported ...: BFloat16".
_REFUSES_DTYPE = re.compile(r'scalar type|data ?type|dtype|bfloat16|half|'
                            r'float16', re.IGNORECASE)


def _on_wire(x: torch.Tensor, wire_dtype: WireDtype, what: str,
             call: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
  """``call`` on ``x`` cast to the wire dtype, cast back to ``x``'s dtype
  (``_with_wire_cast``); ``x`` as it is when there is no cast to make. A
  backend that refuses the wire dtype raises a ``TypeError`` naming it;
  the backend's own errors (``DistError``: timeouts, lost peers) and
  any other error pass through unchanged."""
  wire = wire_dtype_of(wire_dtype)
  if wire is None or wire == x.dtype or not x.is_floating_point():
    return call(x)
  import torch.distributed as dist
  try:
    out = call(x.to(wire))
  except RuntimeError as e:
    if isinstance(e, dist.DistError) or not _REFUSES_DTYPE.search(str(e)):
      raise
    raise TypeError(f'{what}: the {dist.get_backend()} backend refuses '
                    f'{wire} on the wire ({e})') from e
  return out.to(x.dtype)


def allreduce(x: torch.Tensor, reduction: str = 'sum', *, ctx: Context,
              topology: Topology = Topology.ALL,
              wire_dtype: WireDtype = None) -> torch.Tensor:
  """``reduction`` (``'sum'``, ``'max'``, ``'min'`` or ``'mean'``) of
  ``x`` over the ranks, on every rank. ``'mean'`` is the sum over the
  ranks divided by the world (float tensors), in ``x``'s dtype after the
  cast back from ``wire_dtype``."""
  if reduction not in _REDUCTIONS:
    raise ValueError(f'Unsupported reduction: {reduction}')
  dist = _dist(topology)

  def call(v):
    out = v.clone(memory_format=torch.contiguous_format)
    if ctx.distributed:
      op = {'max': dist.ReduceOp.MAX,
            'min': dist.ReduceOp.MIN}.get(reduction, dist.ReduceOp.SUM)
      dist.all_reduce(out, op=op, group=ctx.group)
    return out

  out = _on_wire(x, wire_dtype if ctx.distributed else None, 'allreduce',
                 call)
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
              topology: Topology = Topology.ALL,
              wire_dtype: WireDtype = None) -> torch.Tensor:
  """The ranks' ``x`` concatenated in rank order along the leading
  dimension: ``[W·n, ...]`` from ``[n, ...]`` (JAX ``all_gather`` with
  ``tiled=True``). Every rank's ``x`` has one shape."""
  dist = _dist(topology)
  if not ctx.distributed:
    return x.clone()

  def call(v):
    out = v.new_empty((ctx.world_size * v.shape[0],) + tuple(v.shape[1:]))
    gather = getattr(dist, 'all_gather_single', None) or (
        dist.all_gather_into_tensor)
    gather(out, v.contiguous(), group=ctx.group)
    return out

  return _on_wire(x, wire_dtype, 'allgather', call)


def alltoall(x: torch.Tensor, *, ctx: Context,
             topology: Topology = Topology.ALL,
             wire_dtype: WireDtype = None) -> torch.Tensor:
  """Row block ``i`` of ``x`` (``[W·k, ...]``) to rank ``i``; returns the
  blocks received, in rank order (JAX ``all_to_all`` with
  ``tiled=True``)."""
  dist = _dist(topology)
  if x.shape[0] % ctx.world_size:
    raise ValueError(f'alltoall: {x.shape[0]} rows do not split over a '
                     f'world of {ctx.world_size}')
  if not ctx.distributed:
    return x.clone()

  def call(v):
    out = torch.empty_like(v, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, v.contiguous(), group=ctx.group)
    return out

  return _on_wire(x, wire_dtype, 'alltoall', call)


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
                 ctx: Context, topology: Topology = Topology.ALL,
                 wire_dtype: WireDtype = None
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
  fixes the payload. ``wire_dtype`` casts the buckets, never the
  sizes."""
  if buckets.shape[0] != ctx.world_size or sizes.shape != (ctx.world_size,):
    raise ValueError(f'all_to_all_v: buckets {tuple(buckets.shape)} and '
                     f'sizes {tuple(sizes.shape)} in a world of '
                     f'{ctx.world_size}')
  recv_sizes = alltoall(sizes, ctx=ctx, topology=topology)
  return alltoall(buckets, ctx=ctx, topology=topology,
                  wire_dtype=wire_dtype), recv_sizes


__all__ = ['Topology', 'all_to_all_v', 'allgather', 'allreduce', 'alltoall',
           'broadcast', 'reduce_scatter', 'wire_dtype_of']
