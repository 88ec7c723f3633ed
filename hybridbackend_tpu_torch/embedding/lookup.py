"""Embedding lookup: replicated, row-sharded, plain and combined.

Counterpart of ``hybridbackend_tpu/embedding/lookup.py``: ``lookup``
(``:51-248``) and ``lookup_sparse`` (``:423-455``). The contract: ids
that are negative or at least ``vocab_size`` read as zeros. ``jnp.take``
with ``mode='fill'`` gives that for free; torch's index ops raise on such
ids, so the lookup clamps them to row 0, gathers, then masks.

A replicated table (every table in a world of one) is gathered with
``index_select``, whose backward the dense-gradient path differentiates
through. The serving function, which needs no backward, passes
``serving=True``: the gather goes through kernel 5 (``ops/gather.py``,
which clips the ids itself), with the same bits. A
:class:`~hybridbackend_tpu_torch.embedding.quant.QuantizedTable` is
looked up by ``lookup_quantized``, as in the JAX package (``:66-70``).

A table row-sharded over a world of ranks (``TableConfig.should_shard``)
is looked up by each rank for its own ids, with one of the JAX package's
exchanges between the ranks, bit for bit:

* ``'allgather'`` (the default): every rank gathers all ranks' ids,
  reads the rows it owns (zeros elsewhere), and a reduce-scatter hands
  each rank the sum for its ids (``:267-279``);
* ``'alltoall'``: the ids are bucketed by owner (``partition_by_fn``),
  sent to their owners with ``all_to_all_v``, read there, sent back and
  unbucketed (``:286-346``). A bucket holds ``ceil(bucket_ratio·n/W)``
  ids; when one overflows on any rank, every rank takes the exact
  exchange instead (``overflow_fallback``). The predicate goes through
  an all-reduce and is read on the host, so every rank takes the same
  branch and runs the same collectives.

Every rank passes the same number of ids (a world splits the ids as
``shard_map`` does; :func:`world_slice` cuts a flat id list as the JAX
lookup pads and splits it, ``:72-82``). The sharded lookup has no
backward: the sparse step routes the embeddings' gradient itself
(``sparse_update.py``). ``'hierarchical'``, ``'gspmd'`` and
column-sharded tables are ROADMAP item 15b.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.distribute.partition import (
    Partitioned, partition_by_fn, unpartition)
from hybridbackend_tpu_torch.embedding.quant import (
    QuantizedTable, lookup_quantized)
from hybridbackend_tpu_torch.embedding.table import TableConfig
from hybridbackend_tpu_torch.embedding.unique import unique
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.ops.gather import gather_rows

Table = Union[torch.Tensor, QuantizedTable]
STRATEGIES = ('allgather', 'alltoall')


def lookup(table: Table, ids: torch.Tensor, config: TableConfig,
           serving: bool = False, *, ctx: Optional[Context] = None,
           strategy: str = 'allgather', bucket_ratio: float = 2.0,
           overflow_fallback: bool = True,
           unique_ratio: float = 1.0) -> torch.Tensor:
  """Look up ``ids`` (any shape) in ``table``; returns
  ``ids.shape + (dim,)`` in the table's dtype (float32 for a
  ``QuantizedTable``). Invalid ids give zero rows. ``serving=True``
  gathers through kernel 5, which has no backward.

  When ``config`` is sharded over ``ctx``, ``table`` is this rank's
  shard and ``ids`` this rank's ids; ``strategy``, ``bucket_ratio``
  (``emb_lookup_bucket_ratio``; 0 or less: full buckets),
  ``overflow_fallback`` and ``unique_ratio`` (``emb_unique_ratio``:
  below 1, the ids are deduplicated to that share of their number
  before the exchange, exactly, with the exact exchange when more are
  unique) are the JAX options of the same names. Elsewhere they are
  not used."""
  if isinstance(table, QuantizedTable):
    if config.should_shard(ctx):
      raise NotImplementedError('sharded int8 tables are ROADMAP item '
                                '15b (6)')
    return lookup_quantized(table, ids, config)
  if config.should_shard(ctx):
    if serving:
      raise NotImplementedError('a sharded table is not served; serving '
                                'sharded tables is ROADMAP item 15b (6)')
    with torch.no_grad():
      return _sharded(table, ids, config, ctx, strategy, bucket_ratio,
                      overflow_fallback, unique_ratio)
  valid = (ids >= 0) & (ids < config.vocab_size)
  rows = config.row_index(ids, ctx)
  if serving:
    out = gather_rows(table, rows)
  else:
    rows = torch.where(valid, rows, 0)
    out = table.index_select(0, rows.reshape(-1).to(torch.int64))
    out = out.reshape(*ids.shape, table.shape[1])
  return torch.where(valid.unsqueeze(-1), out, 0)


lookup.overflow_fallbacks = 0     # exact exchanges taken after an overflow


def world_slice(flat_ids: torch.Tensor, ctx: Context) -> torch.Tensor:
  """This rank's part of a flat id list that every rank holds whole: the
  list padded with ``-1`` to a multiple of the world and cut in equal
  parts, as the JAX lookup pads and ``shard_map`` splits it
  (``lookup.py:72-82``). The padding reads as zeros."""
  n = flat_ids.shape[0]
  padded = -(-n // ctx.world_size) * ctx.world_size
  if padded != n:
    flat_ids = torch.cat([flat_ids, flat_ids.new_full((padded - n,), -1)])
  return flat_ids[ctx.rows(padded)]


def _global_any(flag: torch.Tensor, ctx: Context) -> bool:
  """Whether ``flag`` is set on any rank: an all-reduce, read on the
  host, so that every rank branches alike."""
  total = collective.allreduce(flag.to(torch.int32).reshape(1), ctx=ctx)
  return bool(total.item() > 0)


def _sharded(shard, ids, config, ctx, strategy, bucket_ratio, fallback,
             unique_ratio):
  if config.partition != 'row':
    raise NotImplementedError(
        f'table {config.name!r}: partition={config.partition!r} is ROADMAP '
        'item 15b (3); only row-sharded tables are ported')
  if strategy not in STRATEGIES:
    if strategy in ('hierarchical', 'gspmd'):
      raise NotImplementedError(f'lookup strategy {strategy!r} is ROADMAP '
                                'item 15b (3); ported: ' + ', '.join(
                                    STRATEGIES))
    raise ValueError(f'Unknown lookup strategy: {strategy!r}')
  flat = ids.reshape(-1)
  if unique_ratio < 1.0:
    # Dedup before the exchange (``lookup.py:84-114``), on the rank's ids
    # with a capacity that is the same on every rank. The exchange of
    # the unique ids returns the same rows as that of all ids, so the
    # result is JAX's whichever branch a rank takes.
    cap = max(1, int(round(flat.shape[0] * unique_ratio)))
    u = unique(flat, capacity=cap, fill_value=-1)
    if not _global_any(u.overflowed, ctx):
      emb_u = _sharded(shard, u.values, config, ctx, strategy,
                       bucket_ratio, fallback, 1.0)
      return emb_u.index_select(0, u.index.long()).reshape(
          *ids.shape, config.dim)
    lookup.overflow_fallbacks += 1
  valid = (flat >= 0) & (flat < config.vocab_size)
  # Validity is a property of the logical id: an out-of-vocab id must not
  # mix to, or land on, a real or padding row. -1 has no owner.
  rows = torch.where(valid, config.row_index(flat, ctx), -1)
  rows_per_shard = config.padded_vocab(ctx) // ctx.world_size
  if strategy == 'allgather':
    out = _lookup_allgather(shard, rows, ctx, rows_per_shard)
  else:
    out = _lookup_alltoall(shard, rows, ctx, rows_per_shard, bucket_ratio,
                           fallback)
  return out.reshape(*ids.shape, config.dim)


def _lookup_allgather(shard, rows, ctx, rows_per_shard):
  """All ranks' ids, a masked local gather, a reduce-scatter."""
  all_ids = collective.allgather(rows, ctx=ctx).reshape(ctx.world_size, -1)
  owner = torch.div(all_ids, rows_per_shard, rounding_mode='floor')
  local = (all_ids - owner * rows_per_shard).clamp(0, shard.shape[0] - 1)
  contrib = shard.index_select(0, local.reshape(-1).long()).reshape(
      *all_ids.shape, shard.shape[1])
  contrib = torch.where((owner == ctx.rank).unsqueeze(-1), contrib, 0)
  return collective.reduce_scatter(contrib, ctx=ctx)


def _a2a_round_trip(shard, part: Partitioned, ctx, rows_per_shard):
  """The ids to their owners, the owners' gather, the rows back,
  unbucketed (``lookup.py:294-303``)."""
  recv, recv_sizes = collective.all_to_all_v(part.buckets, part.sizes,
                                             ctx=ctx)
  local = (recv - ctx.rank * rows_per_shard).clamp(0, rows_per_shard - 1)
  emb = shard.index_select(0, local.reshape(-1).long()).reshape(
      *local.shape, shard.shape[1])
  back, _ = collective.all_to_all_v(emb, recv_sizes, ctx=ctx)
  return unpartition(back.reshape(-1, shard.shape[1]), part.restore)


def _lookup_alltoall(shard, rows, ctx, rows_per_shard, bucket_ratio,
                     fallback):
  """Bucketed by owner, exchanged, read, exchanged back
  (``lookup.py:306-346``)."""
  world = ctx.world_size
  b = rows.shape[0]
  owner = torch.div(rows, rows_per_shard, rounding_mode='floor')
  valid = (owner >= 0) & (owner < world)

  def part(capacity):
    return partition_by_fn(
        rows, world,
        lambda x: torch.div(x, rows_per_shard,
                            rounding_mode='floor').clamp(0, world - 1),
        capacity=capacity, fill_value=-1, valid=valid)

  cap = None
  if bucket_ratio > 0:
    cap = max(1, int(math.ceil(bucket_ratio * b / world)))
    cap = cap if cap < b else None
  if cap is None:
    out = _a2a_round_trip(shard, part(None), ctx, rows_per_shard)
  else:
    p = part(cap)
    if fallback and _global_any(p.overflow, ctx):
      lookup.overflow_fallbacks += 1
      p = part(None)
    out = _a2a_round_trip(shard, p, ctx, rows_per_shard)
  return torch.where(valid.unsqueeze(-1), out, 0)


def lookup_sparse(table: Table, ids: torch.Tensor, mask: torch.Tensor,
                  config: TableConfig,
                  weights: Optional[torch.Tensor] = None,
                  combiner: Optional[str] = None,
                  serving: bool = False) -> torch.Tensor:
  """Combined lookup over padded ragged ids
  (``tf.nn.embedding_lookup_sparse``).

  ``ids``: ``[batch, max_len]``; ``mask``: its validity (bool or 0/1);
  ``weights``: optional per-id weights; ``combiner``: ``'sum'``,
  ``'mean'`` or ``'sqrtn'`` (the table's by default), the last two over
  the masked weight total floored at 1e-9; ``serving`` as in
  :func:`lookup`. Returns ``[batch, dim]``."""
  combiner = combiner or config.combiner
  emb = lookup(table, ids, config, serving)
  m = mask.to(emb.dtype)
  if weights is not None:
    m = m * weights.to(emb.dtype)
  total = torch.sum(emb * m[..., None], dim=-2)
  if combiner == 'sum':
    return total
  denom = torch.sum(m, dim=-1, keepdim=True)
  if combiner == 'mean':
    return total / torch.clamp(denom, min=1e-9)
  if combiner == 'sqrtn':
    return total / torch.sqrt(torch.clamp(denom, min=1e-9))
  raise ValueError(f'Unknown combiner: {combiner!r}')


__all__ = ['STRATEGIES', 'lookup', 'lookup_sparse', 'world_slice']
