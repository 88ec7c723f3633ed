"""Row-sparse table optimizers: Adagrad, SGD and LazyAdam.

Counterpart of ``hybridbackend_tpu/embedding/sparse_update.py``:
``sparse_adagrad_apply`` (``:629-782``, with ``_stream_adagrad`` at
``:253-287``), ``sparse_sgd_apply`` (``:784-832``) and
``sparse_adam_apply`` (``:853-935``). Given the batch's ids and the
gradient with respect to the looked-up embeddings, each updates only the
touched rows. Unlike the JAX functions, which return new arrays, they
update the table and its slots in place.

Every entry maps ids to rows, drops ids outside ``[0, vocab)``, sorts the
list stably (equal rows stay in list order, so each row's total is summed
in the same order on every run) and hands it to one kernel of
``ops/scatter.py``. The dense-split form of Adagrad (``split_dense``)
hands it to the dense row-totals kernel and applies the update with
elementwise torch ops over the whole table, as the JAX package leaves
that apply to XLA.

Tables may be float32 or bfloat16; the slots (``*_like(table)``, as in
JAX) and the gradient list take the table's dtype, and every update does
its math in float32 and rounds each stored result once
(``ops/scatter.py``).

In a world of more than one rank (``ctx``), Adagrad takes each rank's
ids and gradients. A replicated table gathers every rank's list and
applies the global update on every replica (``:709-731``). A row-sharded
table routes each row's gradient to the rank that owns it
(``:377-555``): each rank sums its duplicate rows, buckets the totals by
owner and sends them with ``all_to_all_v`` (``exchange='alltoall'``, a
bucket of ``ceil(bucket_ratio·ceil(n/W))`` rows; when one overflows on
any rank, every rank takes the allgather route instead), or every rank
gathers every list and keeps its own rows (``'allgather'``). The owner
sorts the rows it received and updates its shard through kernel 1, as at
a world of one (``apply_local``, ``:762-782``). ``dedup=False`` and
``split_dense`` on a sharded table, and SGD and LazyAdam at more than one
rank, are ROADMAP item 15b and raise; nothing falls back to a replicated
update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.distribute.partition import bucket_counts
from hybridbackend_tpu_torch.embedding.table import TableConfig
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.ops.scatter import (
    Lr, Step, _device_scalar, adagrad_update_sorted, adam_update_sorted,
    gsum_dense_sorted, scatter_add_sorted)


@dataclasses.dataclass
class SparseOptState:
  """Per-table slot state: ``(acc,)`` for Adagrad, ``(m, v)`` for
  LazyAdam."""
  acc: Tuple[torch.Tensor, ...]


def init_adagrad_state(table: torch.Tensor,
                       initial: float = 0.1) -> SparseOptState:
  """Accumulator of the table's shape, filled with ``initial``."""
  return SparseOptState(acc=(torch.full_like(table, initial),))


def init_adam_state(table: torch.Tensor) -> SparseOptState:
  """LazyAdam moments ``(m, v)`` of the table's shape, zero."""
  return SparseOptState(acc=(torch.zeros_like(table),
                             torch.zeros_like(table)))


def _valid_rows(rows, ids, config: TableConfig):
  """The lookup's validity contract: an id outside ``[0, vocab)`` must
  not resolve to a real (mixed or padding) row. For LazyAdam even a
  zero-gradient touch decays a row's moments."""
  return torch.where((ids >= 0) & (ids < config.vocab_size), rows, -1)


def _flat_list(table: torch.Tensor, ids: torch.Tensor, demb: torch.Tensor,
               config: TableConfig, ctx: Optional[Context] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The update list in the ids' order: ``(rows int32 [N], grads [N,
  d])``, invalid ids as row ``-1``."""
  flat = ids.reshape(-1)
  rows = _valid_rows(config.row_index(flat, ctx), flat, config).to(
      torch.int32)
  return rows, demb.reshape(-1, demb.shape[-1]).to(table.dtype)


def _sort(rows: torch.Tensor, g: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(rows, g)`` ordered by row, stably."""
  rows, order = torch.sort(rows, stable=True)
  return rows, g.index_select(0, order)


def _sorted_list(table: torch.Tensor, ids: torch.Tensor, demb: torch.Tensor,
                 config: TableConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The update list ``(rows int32 [N] ascending, grads [N, d])``."""
  return _sort(*_flat_list(table, ids, demb, config))


# ---------------------------------------------------------------------------
# The gradient's way back to the owners of a row-sharded table
# (``sparse_update.py:377-555``): each rank sums its duplicate rows,
# buckets the totals by owner with a fixed capacity and exchanges them;
# the allgather route, every rank receiving every list, is the exact
# fallback when a bucket overflows.
# ---------------------------------------------------------------------------


def _not_ported(what: str) -> NotImplementedError:
  return NotImplementedError(f'{what} in a world of more than one rank is '
                             'ROADMAP item 15b (1); it does not run '
                             'replicated instead')


def _local_combine(rows: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Each distinct row's gradient total (``:391-408``): ``(urows [n],
  gsum [n, d])``, the distinct rows ascending in a prefix and ``-1`` in
  the lanes after it. Rows ``< 0`` collapse into one ``-1`` lane, which
  the owners drop."""
  srows, sg = _sort(rows, g)
  is_first = torch.ones_like(srows, dtype=torch.bool)
  is_first[1:] = srows[1:] != srows[:-1]
  slot = torch.cumsum(is_first, 0) - 1
  gsum = torch.zeros_like(g).index_add_(0, slot, sg)
  urows = torch.full_like(rows, -1)
  urows[slot] = srows
  return urows, gsum


def _bucket_by_owner(urows: torch.Tensor, gsum: torch.Tensor, world: int,
                     rows_per_shard: int, cap: int):
  """``(row, gradient)`` pairs bucketed by owner with a fixed capacity,
  each bucket in list order (``:411-444``): ``(id_buckets [W, cap],
  g_buckets [W, cap, d], sizes [W] int32, overflow)``, padding lanes with
  row ``-1`` and zero gradients. Rows outside ``[0, W·rows_per_shard)``
  have no owner and are left out."""
  n, d = gsum.shape
  shard = torch.where((urows >= 0) & (urows < world * rows_per_shard),
                      torch.div(urows, rows_per_shard, rounding_mode='floor'),
                      world).to(torch.int32)
  order = torch.argsort(shard, stable=True)
  s_shard, s_rows, s_g = shard[order], urows[order], gsum[order]
  counts = bucket_counts(shard, world + 1)
  starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
  pos = torch.arange(n, device=urows.device) - starts[s_shard.long()]
  ok = (pos < cap) & (s_shard < world)
  flat = torch.where(ok, s_shard * cap + pos, world * cap)
  # Lanes past the capacity land in one spare slot past the end.
  id_buckets = torch.full((world * cap + 1,), -1, dtype=urows.dtype,
                          device=urows.device)
  id_buckets[flat] = s_rows
  g_buckets = gsum.new_zeros((world * cap + 1, d))
  g_buckets[flat] = s_g
  overflow = torch.any(counts[:world] > cap)
  sizes = torch.clamp(counts[:world], max=cap).to(torch.int32)
  return (id_buckets[:-1].reshape(world, cap),
          g_buckets[:-1].reshape(world, cap, d), sizes, overflow)


def _update_bucket_cap(n_local: int, world: int, ratio: float) -> int:
  """``emb_update_bucket_ratio``'s capacity (``:452-456``)."""
  cap = int(math.ceil(ratio * math.ceil(n_local / world)))
  return max(1, min(n_local, cap))


def _route_grads_allgather(rows: torch.Tensor, g: torch.Tensor,
                           ctx: Context, rows_per_shard: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Every rank receives every rank's list and keeps the rows it owns,
  shard-relative, the others as ``-1`` lanes with zero gradients
  (``:485-495``)."""
  all_ids = collective.allgather(rows, ctx=ctx)
  all_g = collective.allgather(g, ctx=ctx)
  owner = torch.div(all_ids, rows_per_shard, rounding_mode='floor')
  mine = (owner == ctx.rank) & (all_ids >= 0)
  local = torch.where(mine, all_ids - ctx.rank * rows_per_shard, -1)
  return local, torch.where(mine.unsqueeze(-1), all_g, 0)


def _route_grads_a2a(buckets, ctx: Context, rows_per_shard: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The buckets of :func:`_bucket_by_owner` to their owners; returns
  the received shard-relative rows (``-1`` lanes) and their gradients
  (``:459-482``)."""
  id_buckets, g_buckets, sizes, _ = buckets
  recv_ids, _ = collective.all_to_all_v(id_buckets, sizes, ctx=ctx)
  recv_g, _ = collective.all_to_all_v(g_buckets, sizes, ctx=ctx)
  local = torch.where(recv_ids >= 0,
                      recv_ids - ctx.rank * rows_per_shard, -1)
  return local.reshape(-1), recv_g.reshape(-1, g_buckets.shape[-1])


def _rowsharded_update(rows: torch.Tensor, g: torch.Tensor,
                       apply_local: Callable[[torch.Tensor, torch.Tensor],
                                             None],
                       config: TableConfig, ctx: Context, exchange: str,
                       bucket_ratio: float, fallback: bool) -> None:
  """The row-sharded update (``_rowsharded_update``, ``:498-555``): route
  this rank's ``(rows, g)`` to their owners by ``exchange`` and apply
  what this rank received with ``apply_local(local_rows, grads)``,
  ``-1`` lanes included. An overflow on any rank sends every rank down
  the allgather route (``fallback``); the predicate goes through an
  all-reduce and is read on the host, so that every rank runs the same
  collectives; ``sparse_adagrad_apply.overflow_fallbacks`` counts them."""
  if exchange not in ('alltoall', 'allgather'):
    raise ValueError(f'Unknown update exchange {exchange!r}; expected '
                     "'alltoall' or 'allgather'")
  world = ctx.world_size
  rows_per_shard = config.padded_vocab(ctx) // world
  if exchange == 'alltoall':
    cap = _update_bucket_cap(rows.shape[0], world, bucket_ratio)
    buckets = _bucket_by_owner(*_local_combine(rows, g), world,
                               rows_per_shard, cap)
    overflow = buckets[3]
    if not fallback or not bool(collective.allreduce(
        overflow.to(torch.int32).reshape(1), ctx=ctx).item()):
      apply_local(*_route_grads_a2a(buckets, ctx, rows_per_shard))
      return
    sparse_adagrad_apply.overflow_fallbacks += 1
  apply_local(*_route_grads_allgather(rows, g, ctx, rows_per_shard))


def _split_dense_adagrad(table: torch.Tensor, acc: torch.Tensor,
                         rows: torch.Tensor, g: torch.Tensor, lr: Lr,
                         eps: float):
  """The dense-split Adagrad update (``_stream_adagrad``'s split branch,
  ``:273-284``): dense f32 ``[V, d]`` row totals from
  :func:`gsum_dense_sorted`, then a whole-table elementwise apply in
  place, in the fused kernel's order of operations: ``a = f32(acc) +
  s·s``, then ``table = f32(table) - (lr·s) / (sqrt(a) + eps)``, each op
  rounded on its own (no ``addcdiv_``, no FMA across them) and each
  stored result rounded once to the storage dtype, the denominator taken
  from the unrounded ``a``. Rows with ``s == 0`` keep their bits: ``acc +
  0`` and ``table - 0``. A float32 table and acc are updated without a
  copy."""
  if table.dtype not in (torch.float32, torch.bfloat16) or (
      acc.dtype != table.dtype or acc.shape != table.shape):
    raise TypeError('the dense-split update takes a float32 or bfloat16 '
                    'table and an acc of its dtype and shape; got '
                    f'{table.dtype} {tuple(table.shape)} and {acc.dtype} '
                    f'{tuple(acc.shape)}')
  gsum = gsum_dense_sorted(rows, g, table.shape[0])
  tmp = gsum * gsum
  a = acc.float().add_(tmp)              # acc itself when it is float32
  t = table.float()
  denom = torch.sqrt(a, out=tmp).add_(eps)
  t.sub_(gsum.mul_(_device_scalar(lr, table.device)).div_(denom))
  for store, value in ((acc, a), (table, t)):
    if value is not store:
      store.copy_(value)


def sparse_adagrad_apply(table: torch.Tensor, state: SparseOptState,
                         ids: torch.Tensor, demb: torch.Tensor,
                         config: TableConfig, lr: Lr, eps: float = 1e-7,
                         dedup: bool = True, split_dense: bool = False, *,
                         ctx: Optional[Context] = None,
                         exchange: str = 'alltoall',
                         bucket_ratio: float = 2.0,
                         overflow_fallback: bool = True
                         ) -> Tuple[torch.Tensor, SparseOptState]:
  """Adagrad on touched rows only, in place.

  Args:
    ids: the batch's lookup ids, any shape.
    demb: gradient of the loss with respect to the looked-up embeddings,
      ``ids.shape + (dim,)``.
    dedup: duplicate ids are combined into per-row totals before
      squaring (exact Adagrad). ``False``: each occurrence's square is
      accumulated (TF ``SparseApplyAdagrad``, the JAX package's XLA path
      ``_adagrad_rows_nodedup``), with the denominator read after all of
      a row's squares land. The JAX stream kernel ignores ``False``; the
      port honours it on every device.
    split_dense: the dense-split form (the JAX option
      ``emb_update_split_dense='on'``): the dense per-row totals kernel,
      then an elementwise apply over the whole table and accumulator.
      The same result as the fused update, bit for bit; it moves the
      whole table. Needs ``dedup``: dense totals carry no per-occurrence
      squares.
    ctx: the world, when it has more than one rank: ``ids`` and ``demb``
      are this rank's, and ``table`` and the accumulator are this rank's
      shard when ``config`` is sharded over ``ctx``, else whole.
    exchange, bucket_ratio, overflow_fallback: the JAX options
      ``emb_update_exchange``, ``emb_update_bucket_ratio`` and
      ``emb_update_overflow_fallback``, for a sharded table.

  Returns ``(table, state)``, the same objects, updated.
  """
  if split_dense and not dedup:
    raise ValueError('split_dense=True needs dedup=True: the dense row '
                     'totals carry no per-occurrence squares')
  acc = state.acc[0]
  rows, g = _flat_list(table, ids, demb, config, ctx)
  if config.should_shard(ctx):
    if not dedup:
      raise _not_ported('dedup=False on a row-sharded table')
    if split_dense:
      raise _not_ported('split_dense=True on a row-sharded table')

    def apply_local(local, grads):
      # The owner's update: kernel 1 on its shard, the -1 lanes first in
      # the sorted list and skipped by it.
      adagrad_update_sorted(table, acc, *_sort(local.to(torch.int32), grads),
                            lr, eps)

    _rowsharded_update(rows, g, apply_local, config, ctx, exchange,
                       bucket_ratio, overflow_fallback)
    return table, state
  if ctx is not None and ctx.world_size > 1:
    # A replicated table: every replica applies the global update.
    rows = collective.allgather(rows, ctx=ctx)
    g = collective.allgather(g, ctx=ctx)
  rows, g = _sort(rows, g)
  if split_dense:
    _split_dense_adagrad(table, acc, rows, g, lr, eps)
  else:
    adagrad_update_sorted(table, acc, rows, g, lr, eps, dedup)
  return table, state


sparse_adagrad_apply.overflow_fallbacks = 0


def sparse_sgd_apply(table: torch.Tensor, ids: torch.Tensor,
                     demb: torch.Tensor, config: TableConfig,
                     lr: Lr, *, ctx: Optional[Context] = None
                     ) -> torch.Tensor:
  """SGD on touched rows only, in place (no slot state): each row moves
  by ``-lr`` times its gradient total. The gradients are scaled before
  they are summed, as the JAX stream path does. Returns ``table``. A
  world of more than one rank (``ctx``) is ROADMAP item 15b."""
  if ctx is not None and ctx.world_size > 1:
    raise _not_ported('sparse_sgd_apply')
  rows, g = _sorted_list(table, ids, demb, config)
  return scatter_add_sorted(table, rows, g * (-lr))


def sparse_adam_apply(table: torch.Tensor, state: SparseOptState,
                      ids: torch.Tensor, demb: torch.Tensor,
                      config: TableConfig, lr: Lr, step: Step,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      *, ctx: Optional[Context] = None
                      ) -> Tuple[torch.Tensor, SparseOptState]:
  """LazyAdam on touched rows only, in place (TF ``LazyAdam``: moments of
  untouched rows do not decay; a row present with a zero gradient total
  is touched). ``state.acc = (m, v)``; ``step`` is the 1-based step count
  for bias correction, a number or a device tensor. A world of more than
  one rank (``ctx``) is ROADMAP item 15b.

  Returns ``(table, state)``, the same objects, updated.
  """
  if ctx is not None and ctx.world_size > 1:
    raise _not_ported('sparse_adam_apply')
  m, v = state.acc
  rows, g = _sorted_list(table, ids, demb, config)
  adam_update_sorted(table, m, v, rows, g, lr, step, b1, b2, eps)
  return table, state


__all__ = ['SparseOptState', 'init_adagrad_state', 'init_adam_state',
           'sparse_adagrad_apply', 'sparse_adam_apply', 'sparse_sgd_apply']
