"""Embedding lookup: replicated, row-sharded, plain and combined.

Counterpart of ``hybridbackend_tpu/embedding/lookup.py``: ``lookup``
(``:51-248``) and ``lookup_sparse`` (``:423-455``). The contract: ids
that are negative or at least ``vocab_size`` read as zeros. ``jnp.take``
with ``mode='fill'`` gives that for free; torch's index ops raise on such
ids, so the lookup clamps them to row 0, gathers, then masks.

A replicated table (every table in a world of one) is gathered with
``index_select`` (``_RowGather``), whose backward the dense-gradient path
differentiates through: ``ops.scatter.dense_row_totals``, a stable sort
of the rows and kernel 4 (``gsum_dense_sorted``), which sums each row's
gradients from 0.0 in list order, as the JAX package's scatter-add (the
transpose of ``jnp.take``) sums them on the CPU, and skips the invalid
ids, as ``mode='fill'`` drops them. So a table's gradient is JAX's bits
for an f32 table, and the same bits on every call on a card, where the
backward of ``index_select`` (an ``index_add_``) adds with atomics in no
fixed order. A bf16 table's totals are f32 sums rounded once to bf16.
The serving function, which needs no backward, passes
``serving=True``: the gather goes through kernel 5 (``ops/gather.py``,
which clips the ids itself), with the same bits. A
:class:`~hybridbackend_tpu_torch.embedding.quant.QuantizedTable` is
looked up by ``lookup_quantized``, as in the JAX package (``:66-70``),
a rank's shard of one over the allgather exchange whatever the strategy.

A table sharded over a world of ranks (``TableConfig.should_shard``) is
looked up by each rank for its own ids, with one of the JAX package's
exchanges between the ranks, bit for bit. A row-sharded table takes the
exchange that ``strategy`` names:

* ``'allgather'`` (the default): every rank gathers all ranks' ids,
  reads the rows it owns (zeros elsewhere), and a reduce-scatter hands
  each rank the sum for its ids (``:267-279``);
* ``'alltoall'``: the ids are bucketed by owner (``partition_by_fn``),
  sent to their owners with ``all_to_all_v``, read there, sent back and
  unbucketed (``:286-346``). ``wire_dtype`` (the JAX option
  ``comm_wire_dtype``, ``:199-205``) casts the rows on their way back,
  and nothing else: ids never travel as floats, and the allgather
  strategy's reduce-scatter stays at the table's precision. A bucket
  holds ``ceil(bucket_ratio·b/W)`` ids (``b`` the rank's ids); when one
  overflows on any rank, every rank takes the exact exchange instead
  (``overflow_fallback``). The predicate goes through an all-reduce and
  is read on the host, so every rank takes the same branch and runs the
  same collectives;
* ``'hierarchical'``: the same in two hops over the node layout
  (``_hier_pipeline`` and ``_lookup_hierarchical``, ``:349-420``): an id
  crosses its node's ranks to the local rank of its owner (``owner %
  L``, the intra-node subgroup), then the ranks of that local rank to
  the owner's node (``owner // L``, the inter-node subgroup), so only
  ids bound for the owner's column of the ``(node, local rank)`` grid
  cross nodes. The owner reads its rows; they travel back through the
  second hop and then the first, cast to ``wire_dtype`` on both. Each
  hop has its own capacity, ``ceil(bucket_ratio·b/L)`` and
  ``ceil(bucket_ratio·b/M)`` (``b`` the rank's own ids on both hops, as
  JAX's ``_cap``), none where that is at least ``b``; the first hop's
  fill lanes take no capacity of the second. An overflow of either hop
  on any rank sends every rank through both hops at full capacity;
* ``'gspmd'``: JAX's ``jnp.take`` on the row-sharded array, whose
  exchange XLA's SPMD partitioner picks (``:187-193``). The port has no
  partitioner; it runs the exchange the partitioner chose for this
  lookup, read from the compiled HLO (jax 0.9.0, 8 CPU devices, a
  ``[1024, 16]`` row-sharded f32 table, 512 ids): an all-gather of the
  ids (``s32[512,1]``), a masked local gather, an all-reduce of the
  ``f32[512,16]`` rows, and each device's slice of its own rows
  (``f32[64,16]``). Another partitioner (another version, mesh or size)
  may choose another exchange, the allgather strategy's reduce-scatter
  for one; the values are the same bits either way.

A column-sharded table (``partition='column'``, every rank all rows of
its dim slice) takes one exchange whatever the strategy
(``_lookup_column``, ``:173-185`` and ``:251-264``): every rank gathers
all ranks' ids, reads its slice of each (``[B, d/W]``), and a tiled
all-to-all hands each rank its rows' slices from every rank, joined
into ``[b, d]``.

Every rank passes the same number of ids (a world splits the ids as
``shard_map`` does; :func:`world_slice` cuts a flat id list as the JAX
lookup pads and splits it, ``:72-82``).

The sharded lookup is differentiable with respect to the shard, for the
dense-gradient path (a ``torch.autograd.Function`` around each
exchange): its backward gives the owner's shard, for each of its rows,
the sum of every rank's gradients of the embeddings read from it, the
transpose of the exchange. For ``'allgather'`` and ``'gspmd'`` that is
JAX's transpose of the all_gather and masked take: every rank's
gradients gathered, masked to the owner's rows and summed into the
shard. For ``'alltoall'`` and ``'hierarchical'`` the gradients go
back to the owners through the same buckets, hop by hop (cast to
``wire_dtype`` on the wire, as the transpose of the rows' cast), and are
summed there. For a column table the inverse all-to-all hands
each rank every rank's gradients of its slice, summed at every
id. Each of these sums is ``dense_row_totals`` (kernel 4 on a card), in
the order the owner holds its list: rank by rank, each rank's ids in
its order, which is the global batch's order, so without ``wire_dtype``
and dedup a shard's gradient is the world of one's rows bit for bit. A
bucket lane of the alltoall and hierarchical transposes is a plain
``index_add_``: it takes one id's gradient, and exact zeros from the
invalid ids, so its order does not matter (an id that a full bucket
leaves out, with ``overflow_fallback=False``, reads the last lane as
the forward's clamped gather does, and adds into it). Nothing is
scaled: a loss that is each rank's mean over its rows gives gradients
``W`` times the global mean's, which the dense step
divides once (``training/train.py``). A shard that needs no gradient
(the sparse step, which routes the embeddings' gradient itself through
``sparse_update.py``) is looked up under ``torch.no_grad()``.

A shard served with ``serving=True`` (no backward) runs the same
exchange under ``torch.no_grad()`` with the owner's local gather through
kernel 5 in place of ``index_select``: the same rows, bit for bit.

A sharded table, float or int8, is looked up as a shard only when it
holds fewer rows (a column table: fewer columns) than the table has at a
world of one (``table.is_shard``): a whole table (a shard gathered back,
as the exported dense bundle holds it) is looked up locally, with no
collective.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch

from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.distribute.partition import (
    Partitioned, partition_by_fn, unpartition)
from hybridbackend_tpu_torch.embedding.quant import (
    QuantizedTable, lookup_quantized)
from hybridbackend_tpu_torch.embedding.table import TableConfig, is_shard
from hybridbackend_tpu_torch.embedding.unique import unique
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.ops.gather import gather_rows
from hybridbackend_tpu_torch.ops.scatter import dense_row_totals

Table = Union[torch.Tensor, QuantizedTable]
STRATEGIES = ('allgather', 'alltoall', 'hierarchical', 'gspmd')


def lookup(table: Table, ids: torch.Tensor, config: TableConfig,
           serving: bool = False, *, ctx: Optional[Context] = None,
           strategy: str = 'allgather', bucket_ratio: float = 2.0,
           overflow_fallback: bool = True,
           unique_ratio: float = 1.0,
           wire_dtype: collective.WireDtype = None) -> torch.Tensor:
  """Look up ``ids`` (any shape) in ``table``; returns
  ``ids.shape + (dim,)`` in the table's dtype (float32 for a
  ``QuantizedTable``). Invalid ids give zero rows. ``serving=True``
  gathers through kernel 5, which has no backward (a shard's owners
  gather through it, under ``torch.no_grad()``).

  When ``config`` is sharded over ``ctx``, ``table`` is this rank's
  shard and ``ids`` this rank's ids; ``strategy``, ``bucket_ratio``
  (``emb_lookup_bucket_ratio``; 0 or less: full buckets),
  ``overflow_fallback`` and ``unique_ratio`` (``emb_unique_ratio``:
  below 1, the ids are deduplicated to that share of their number
  before the exchange, exactly, with the exact exchange when more are
  unique) are the JAX options of the same names (``strategy`` one of
  :data:`STRATEGIES`; a column-sharded table has one exchange), and
  ``wire_dtype`` the dtype of the alltoall and hierarchical strategies'
  returning rows (``None`` or ``'float32'``: the table's). Elsewhere
  they are not used."""
  if isinstance(table, QuantizedTable):
    return lookup_quantized(table, ids, config, ctx)
  if config.should_shard(ctx) and is_shard(config, table.shape):
    args = (table, ids, config, ctx, strategy, bucket_ratio,
            overflow_fallback, unique_ratio, wire_dtype,
            gather_rows if serving else _index_select)
    if table.requires_grad and torch.is_grad_enabled() and not serving:
      return _sharded(*args)
    with torch.no_grad():
      return _sharded(*args)
  valid = (ids >= 0) & (ids < config.vocab_size)
  rows = config.row_index(ids, ctx)
  if serving:
    return torch.where(valid.unsqueeze(-1), gather_rows(table, rows), 0)
  return _RowGather.apply(table, rows.reshape(-1), valid.reshape(-1)).reshape(
      *ids.shape, table.shape[1])


lookup.overflow_fallbacks = 0     # exact exchanges taken after an overflow


class _RowGather(torch.autograd.Function):
  """``table[rows]`` for ``[N]`` integer rows, zeros where ``valid`` is
  false; its backward sums each valid row's gradients in list order
  (``dense_row_totals``, kernel 4 on a card), rounded once to the
  table's dtype. The dense step is host-bound, one lookup a table, so
  each pass takes as few ops as the old ``index_select`` did, and the
  backward three more (a mask, the sort and its permutation)."""

  @staticmethod
  def forward(fctx, table, rows, valid):
    fctx.save_for_backward(rows, valid)
    fctx.vocab, fctx.dtype = table.shape[0], table.dtype
    out = table.index_select(0, torch.where(valid, rows, 0))
    return torch.where(valid.unsqueeze(-1), out, 0)

  @staticmethod
  def backward(fctx, grad):
    rows, valid = fctx.saved_tensors
    totals = dense_row_totals(torch.where(valid, rows, -1), grad, fctx.vocab)
    return totals.to(fctx.dtype), None, None


def _index_select(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
  """The training lookup's gather of a shard's rows, whose gradient is
  the exchange's transpose; ``gather_rows`` (kernel 5) is the serving
  one's. Both return ``rows.shape + (d,)``, the same bits."""
  return table.index_select(0, rows)


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
             unique_ratio, wire_dtype, gather):
  if strategy not in STRATEGIES:
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
                       bucket_ratio, fallback, 1.0, wire_dtype, gather)
      return _RowGather.apply(emb_u, u.index, u.index >= 0).reshape(
          *ids.shape, config.dim)
    lookup.overflow_fallbacks += 1
  valid = (flat >= 0) & (flat < config.vocab_size)
  # Validity is a property of the logical id: an out-of-vocab id must not
  # mix to, or land on, a real or padding row. -1 has no owner.
  rows = torch.where(valid, config.row_index(flat, ctx), -1)
  rows_per_shard = config.padded_vocab(ctx) // ctx.world_size
  if config.by_column:
    run = functools.partial(_lookup_column, ctx=ctx,
                            vocab=config.padded_vocab(ctx), gather=gather)
  elif strategy in ('allgather', 'gspmd'):
    run = functools.partial(_lookup_allgather, ctx=ctx,
                            rows_per_shard=rows_per_shard,
                            gspmd=strategy == 'gspmd', gather=gather)
  else:
    run = functools.partial(
        _lookup_alltoall if strategy == 'alltoall' else _lookup_hierarchical,
        ctx=ctx, rows_per_shard=rows_per_shard, bucket_ratio=bucket_ratio,
        fallback=fallback, wire_dtype=wire_dtype, gather=gather)
  return _Exchange.apply(shard, rows, run).reshape(*ids.shape, config.dim)


class _Exchange(torch.autograd.Function):
  """``run(shard, rows) -> (rows' embeddings, transpose)``, an exchange,
  with ``transpose(gradient of the embeddings) -> gradient of the
  shard`` as its backward."""

  @staticmethod
  def forward(fctx, shard, rows, run):
    out, fctx.transpose = run(shard, rows)
    return out

  @staticmethod
  def backward(fctx, grad):
    return fctx.transpose(grad.contiguous()), None, None


def _totals(local: torch.Tensor, grad: torch.Tensor,
            shard: torch.Tensor) -> torch.Tensor:
  """A transpose's last step: the shard's gradient, each of its rows the
  sum of the received gradients at that row in the order received
  (``dense_row_totals``; a ``-1`` lane is not this rank's), in the
  shard's dtype."""
  return dense_row_totals(local, grad, shard.shape[0]).to(shard.dtype)


def _lookup_allgather(shard, rows, ctx, rows_per_shard, gspmd, gather):
  """All ranks' ids, a masked local gather, then a reduce-scatter, or
  with ``gspmd`` an all-reduce of which each rank keeps its rows (the
  same bits: one rank holds each row, the others add zeros); transposed,
  all ranks' gradients, masked to this rank's rows, summed."""
  all_ids = collective.allgather(rows, ctx=ctx).reshape(ctx.world_size, -1)
  owner = torch.div(all_ids, rows_per_shard, rounding_mode='floor')
  local = (all_ids - owner * rows_per_shard).clamp(
      0, shard.shape[0] - 1).reshape(-1).long()
  mine = (owner == ctx.rank).reshape(-1, 1)
  contrib = gather(shard, local).reshape(*all_ids.shape, shard.shape[1])
  contrib = torch.where(mine.reshape(*all_ids.shape, 1), contrib, 0)

  def transpose(grad):
    every = collective.allgather(grad, ctx=ctx)
    return _totals(torch.where(mine.reshape(-1), local, -1), every, shard)

  if gspmd:
    return collective.allreduce(contrib, ctx=ctx)[ctx.rank], transpose
  return collective.reduce_scatter(contrib, ctx=ctx), transpose


def _lookup_column(shard, rows, ctx, vocab, gather):
  """All ranks' ids, this rank's slice of each row, and a tiled
  all-to-all that splits the rows and joins the columns (JAX
  ``all_to_all(split_axis=0, concat_axis=1, tiled=True)``); transposed,
  the inverse all-to-all, every rank's gradients of this slice, summed
  at every id."""
  world, b, c = ctx.world_size, rows.shape[0], shard.shape[1]
  all_ids = collective.allgather(rows, ctx=ctx)
  valid = ((all_ids >= 0) & (all_ids < vocab)).unsqueeze(-1)
  local = all_ids.clamp(0, shard.shape[0] - 1).long()
  emb = torch.where(valid, gather(shard, local), 0)
  got = collective.alltoall(emb, ctx=ctx)           # [W·b, c], by rank
  out = got.reshape(world, b, c).permute(1, 0, 2).reshape(b, world * c)

  def transpose(grad):
    back = collective.alltoall(
        grad.reshape(b, world, c).permute(1, 0, 2).reshape(world * b, c),
        ctx=ctx)
    return _totals(torch.where(valid.squeeze(-1), local, -1), back, shard)

  return out, transpose


def _a2a_round_trip(shard, part: Partitioned, ctx, rows_per_shard,
                    wire_dtype, gather):
  """The ids to their owners, the owners' gather, the rows back in
  ``wire_dtype``, unbucketed (``lookup.py:294-303``); and its transpose:
  each id's gradient into its bucket lane, to its owner, summed at the
  row it read."""
  recv, recv_sizes = collective.all_to_all_v(part.buckets, part.sizes,
                                             ctx=ctx)
  local = (recv - ctx.rank * rows_per_shard).clamp(
      0, rows_per_shard - 1).reshape(-1).long()
  d = shard.shape[1]
  emb = gather(shard, local).reshape(*recv.shape, d)
  back, _ = collective.all_to_all_v(emb, recv_sizes, ctx=ctx,
                                    wire_dtype=wire_dtype)
  lanes = back.shape[0] * back.shape[1]
  out = unpartition(back.reshape(lanes, d), part.restore)

  def transpose(grad):
    # A lane past the end (an id left out) carries a zero gradient here.
    flat = grad.new_zeros((lanes, d)).index_add_(
        0, part.restore.clamp(max=lanes - 1).long(), grad)
    got, _ = collective.all_to_all_v(flat.reshape(back.shape), part.sizes,
                                     ctx=ctx, wire_dtype=wire_dtype)
    return _totals(torch.where(recv.reshape(-1) >= 0, local, -1),
                   got.reshape(lanes, d), shard)

  return out, transpose


def _cap(bucket_ratio: float, b: int, buckets: int) -> Optional[int]:
  """A bucket's capacity for ``b`` ids over ``buckets`` peers
  (``lookup.py:217-221``): ``ceil(bucket_ratio·b/buckets)``, None (the
  exact exchange) when the ratio is not positive or the capacity is at
  least ``b``."""
  if bucket_ratio <= 0:
    return None
  cap = max(1, int(math.ceil(bucket_ratio * b / buckets)))
  return cap if cap < b else None


def _owner_of(rows_per_shard: int, world: int):
  return lambda x: torch.div(x, rows_per_shard,
                             rounding_mode='floor').clamp(0, world - 1)


def _lookup_alltoall(shard, rows, ctx, rows_per_shard, bucket_ratio,
                     fallback, wire_dtype, gather):
  """Bucketed by owner, exchanged, read, exchanged back
  (``lookup.py:306-346``)."""
  world = ctx.world_size
  b = rows.shape[0]
  owner = torch.div(rows, rows_per_shard, rounding_mode='floor')
  valid = ((owner >= 0) & (owner < world)).unsqueeze(-1)

  def part(capacity):
    return partition_by_fn(rows, world, _owner_of(rows_per_shard, world),
                           capacity=capacity, fill_value=-1,
                           valid=valid.squeeze(-1))

  cap = _cap(bucket_ratio, b, world)
  if cap is None:
    p = part(None)
  else:
    p = part(cap)
    if fallback and _global_any(p.overflow, ctx):
      lookup.overflow_fallbacks += 1
      p = part(None)
  out, transpose = _a2a_round_trip(shard, p, ctx, rows_per_shard,
                                   wire_dtype, gather)
  return torch.where(valid, out, 0), (
      lambda grad: transpose(torch.where(valid, grad, 0)))


def _lookup_hierarchical(shard, rows, ctx, rows_per_shard, bucket_ratio,
                         fallback, wire_dtype, gather):
  """Two hops to the owner, over this rank's node and then over its
  local rank's ranks of every node, and back (``_hier_pipeline`` and
  ``_lookup_hierarchical``, ``lookup.py:349-420``). Both hops' ids are
  bucketed before either's rows move, so an overflow on either hop (on
  any rank) restarts both at full capacity, with the values JAX's
  ``cond`` takes."""
  intra, inter = collective.Topology.INTRA_NODE, collective.Topology.INTER_NODE
  local, nodes, world = ctx.local_world_size, ctx.num_nodes, ctx.world_size
  b, d = rows.shape[0], shard.shape[1]
  owner_of = _owner_of(rows_per_shard, world)
  owner = torch.div(rows, rows_per_shard, rounding_mode='floor')
  valid = ((owner >= 0) & (owner < world)).unsqueeze(-1)

  def ids_out(cap0, cap1):
    # Hop 0: to the local rank of the owner, in this node.
    p0 = partition_by_fn(rows, local, lambda x: owner_of(x) % local,
                         capacity=cap0, fill_value=-1,
                         valid=valid.squeeze(-1))
    r0, s0 = collective.all_to_all_v(p0.buckets, p0.sizes, ctx=ctx,
                                     topology=intra)
    ids1 = r0.reshape(-1)
    # Hop 1: to the owner's node; the fill lanes of hop 0 stay behind.
    p1 = partition_by_fn(ids1, nodes, lambda x: owner_of(x) // local,
                         capacity=cap1, fill_value=-1, valid=ids1 >= 0)
    return p0, s0, p1, p0.overflow | p1.overflow

  cap0, cap1 = _cap(bucket_ratio, b, local), _cap(bucket_ratio, b, nodes)
  p0, s0, p1, overflow = ids_out(cap0, cap1)
  if ((cap0 is not None or cap1 is not None) and fallback
      and _global_any(overflow, ctx)):
    lookup.overflow_fallbacks += 1
    p0, s0, p1, _ = ids_out(None, None)
  r1, s1 = collective.all_to_all_v(p1.buckets, p1.sizes, ctx=ctx,
                                   topology=inter)
  at = (r1 - ctx.rank * rows_per_shard).clamp(
      0, rows_per_shard - 1).reshape(-1).long()
  emb1 = gather(shard, at).reshape(*r1.shape, d)
  b1, _ = collective.all_to_all_v(emb1, s1, ctx=ctx, topology=inter,
                                  wire_dtype=wire_dtype)
  lanes1 = b1.shape[0] * b1.shape[1]
  emb0 = unpartition(b1.reshape(lanes1, d), p1.restore).reshape(
      *p0.buckets.shape, d)
  b0, _ = collective.all_to_all_v(emb0, s0, ctx=ctx, topology=intra,
                                  wire_dtype=wire_dtype)
  lanes0 = b0.shape[0] * b0.shape[1]
  out = unpartition(b0.reshape(lanes0, d), p0.restore)

  def transpose(grad):
    grad = torch.where(valid, grad, 0)
    g0 = grad.new_zeros((lanes0, d)).index_add_(
        0, p0.restore.clamp(max=lanes0 - 1).long(), grad)
    g0, _ = collective.all_to_all_v(g0.reshape(b0.shape), p0.sizes, ctx=ctx,
                                    topology=intra, wire_dtype=wire_dtype)
    g1 = grad.new_zeros((lanes1, d)).index_add_(
        0, p1.restore.clamp(max=lanes1 - 1).long(), g0.reshape(-1, d))
    g1, _ = collective.all_to_all_v(g1.reshape(b1.shape), p1.sizes, ctx=ctx,
                                    topology=inter, wire_dtype=wire_dtype)
    return _totals(torch.where(r1.reshape(-1) >= 0, at, -1),
                   g1.reshape(lanes1, d), shard)

  return torch.where(valid, out, 0), transpose


def lookup_sparse(table: Table, ids: torch.Tensor, mask: torch.Tensor,
                  config: TableConfig,
                  weights: Optional[torch.Tensor] = None,
                  combiner: Optional[str] = None,
                  serving: bool = False, *,
                  ctx: Optional[Context] = None,
                  **exchange) -> torch.Tensor:
  """Combined lookup over padded ragged ids
  (``tf.nn.embedding_lookup_sparse``).

  ``ids``: ``[batch, max_len]``; ``mask``: its validity (bool or 0/1);
  ``weights``: optional per-id weights; ``combiner``: ``'sum'``,
  ``'mean'`` or ``'sqrtn'`` (the table's by default), the last two over
  the masked weight total floored at 1e-9; ``serving``, ``ctx`` and
  ``exchange`` (``strategy`` and the other exchange options) as in
  :func:`lookup`. Returns ``[batch, dim]``."""
  combiner = combiner or config.combiner
  emb = lookup(table, ids, config, serving, ctx=ctx, **exchange)
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
