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

Every op takes a ``topology`` (``topology_axes``, ``:65-76``):
``Topology.ALL`` spans every rank; ``INTRA_NODE`` the ranks of this
rank's node (the JAX mesh's ``ici`` axis) and ``INTER_NODE`` the ranks of
every node with this rank's local rank (its ``dcn`` axis), each on the
joined context's subgroup (``Context.join``), with that subgroup's size
and this rank's index in it. A context made directly has no subgroups: a
topology that spans the world there takes the world's group, one that
spans this rank alone returns its input's values, and any other raises.
"""

from __future__ import annotations

import enum
import re
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from hybridbackend_tpu_torch.framework.context import Context


class Topology(enum.IntEnum):
  """Which ranks a collective spans (``collective.py:50-61``)."""
  ALL = 0
  INTRA_NODE = 1
  INTER_NODE = 2


class Span(NamedTuple):
  """The ranks a collective spans: their process group (None: the
  default group), their number, this rank's index among them, and
  whether the backend is called at all."""
  group: Any
  size: int
  index: int
  distributed: bool


def span(ctx: Context, topology: Topology = Topology.ALL) -> Span:
  """The :class:`Span` of ``topology`` in ``ctx``'s world."""
  if topology == Topology.ALL:
    return Span(ctx.group, ctx.world_size, ctx.rank, ctx.distributed)
  if topology == Topology.INTRA_NODE:
    group, size, index = ctx.intra_group, ctx.local_world_size, ctx.local_rank
  elif topology == Topology.INTER_NODE:
    group, size, index = ctx.inter_group, ctx.num_nodes, ctx.node
  else:
    raise ValueError(f'Unknown topology: {topology!r}')
  if group is not None:
    return Span(group, size, index, True)
  if size == ctx.world_size:
    return Span(ctx.group, size, index, ctx.distributed)
  if size == 1:
    return Span(None, 1, 0, False)
  raise ValueError(f'{topology!r} spans {size} of {ctx.world_size} ranks: '
                   'its subgroup comes from Context.join')


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
  sp = span(ctx, topology)

  def call(v):
    out = v.clone(memory_format=torch.contiguous_format)
    if sp.distributed:
      import torch.distributed as dist
      op = {'max': dist.ReduceOp.MAX,
            'min': dist.ReduceOp.MIN}.get(reduction, dist.ReduceOp.SUM)
      dist.all_reduce(out, op=op, group=sp.group)
    return out

  out = _on_wire(x, wire_dtype if sp.distributed else None, 'allreduce',
                 call)
  if reduction == 'mean':
    out /= sp.size
  return out


def broadcast(x: torch.Tensor, root: int = 0, *, ctx: Context,
              topology: Topology = Topology.ALL) -> torch.Tensor:
  """The ``x`` of the rank at index ``root`` of ``topology``'s ranks, on
  each of them."""
  sp = span(ctx, topology)
  out = x.clone(memory_format=torch.contiguous_format)
  if sp.distributed:
    import torch.distributed as dist
    src = root if sp.group is None else dist.get_global_rank(sp.group, root)
    dist.broadcast(out, src=src, group=sp.group)
  return out


def allgather(x: torch.Tensor, *, ctx: Context,
              topology: Topology = Topology.ALL,
              wire_dtype: WireDtype = None, axis: int = 0) -> torch.Tensor:
  """The ranks' ``x`` concatenated in rank order along the leading
  dimension: ``[W·n, ...]`` from ``[n, ...]`` (JAX ``all_gather`` with
  ``tiled=True``), or along ``axis``. Every rank's ``x`` has one
  shape."""
  sp = span(ctx, topology)
  if not sp.distributed:
    return x.clone()
  if axis:
    return allgather(x.movedim(axis, 0), ctx=ctx, topology=topology,
                     wire_dtype=wire_dtype).movedim(0, axis).contiguous()

  def call(v):
    import torch.distributed as dist
    out = v.new_empty((sp.size * v.shape[0],) + tuple(v.shape[1:]))
    gather = getattr(dist, 'all_gather_single', None) or (
        dist.all_gather_into_tensor)
    gather(out, v.contiguous(), group=sp.group)
    return out

  return _on_wire(x, wire_dtype, 'allgather', call)


def alltoall(x: torch.Tensor, *, ctx: Context,
             topology: Topology = Topology.ALL,
             wire_dtype: WireDtype = None) -> torch.Tensor:
  """Row block ``i`` of ``x`` (``[W·k, ...]``) to rank ``i``; returns the
  blocks received, in rank order (JAX ``all_to_all`` with
  ``tiled=True``)."""
  sp = span(ctx, topology)
  if x.shape[0] % sp.size:
    raise ValueError(f'alltoall: {x.shape[0]} rows do not split over '
                     f'{sp.size} ranks')
  if not sp.distributed:
    return x.clone()

  def call(v):
    import torch.distributed as dist
    out = torch.empty_like(v, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, v.contiguous(), group=sp.group)
    return out

  return _on_wire(x, wire_dtype, 'alltoall', call)


def reduce_scatter(x: torch.Tensor, *, ctx: Context,
                   topology: Topology = Topology.ALL,
                   wire_dtype: WireDtype = None) -> torch.Tensor:
  """The sum over the ranks of block ``r`` of ``x`` (``[W, ...]``), on
  rank ``r`` (JAX ``psum_scatter`` with ``tiled=False``)."""
  sp = span(ctx, topology)
  if x.shape[0] != sp.size:
    raise ValueError(f'reduce_scatter: leading dimension {x.shape[0]}, '
                     f'{sp.size} ranks')
  if not sp.distributed:
    return x[0].clone()

  def call(v):
    import torch.distributed as dist
    out = v.new_empty(tuple(v.shape[1:]))
    scatter = getattr(dist, 'reduce_scatter_single', None) or (
        dist.reduce_scatter_tensor)
    # Flat, as gloo splits the input's leading dimension by the world.
    scatter(out.view(-1), v.contiguous().view(-1), group=sp.group)
    return out

  return _on_wire(x, wire_dtype, 'reduce_scatter', call)


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
  n = span(ctx, topology).size
  if buckets.shape[0] != n or sizes.shape != (n,):
    raise ValueError(f'all_to_all_v: buckets {tuple(buckets.shape)} and '
                     f'sizes {tuple(sizes.shape)} over {n} ranks')
  recv_sizes = alltoall(sizes, ctx=ctx, topology=topology)
  return alltoall(buckets, ctx=ctx, topology=topology,
                  wire_dtype=wire_dtype), recv_sizes


__all__ = ['Span', 'Topology', 'all_to_all_v', 'allgather', 'allreduce',
           'alltoall', 'broadcast', 'reduce_scatter', 'span', 'wire_dtype_of']
