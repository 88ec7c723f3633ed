"""Static-shape id partitioning for the sharded exchanges.

Counterpart of ``hybridbackend_tpu/distribute/partition.py:26-145``, the
whole module, bit for bit: ids are bucketed by owner into a fixed
``[num_shards, capacity]`` layout with per-bucket sizes, the restore
index of every id and an overflow flag, by a stable sort by shard and a
scatter. The layout feeds :func:`~hybridbackend_tpu_torch.distribute.
collective.all_to_all_v`.

The JAX functions' gathers clamp an index out of range and their
scatters drop one; torch raises on both, so the scatters below write
into one spare slot past the end and cut it off, and ``unpartition``
clamps.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class Partitioned(NamedTuple):
  """A bucketed partition.

  Attributes:
    buckets: ``[num_shards, capacity]`` ids, padded with ``fill_value``.
    sizes: ``[num_shards]`` int32, the valid ids in each bucket.
    restore: ``[n]`` int32, the flat bucket position of each id:
      ``buckets.reshape(-1)[restore] == ids``. Ids left out by ``valid``
      or a full bucket carry ``num_shards * capacity``, one past the end
      (unbucket with a clamp and mask those lanes).
    overflow: 0-d bool, whether a bucket got more valid ids than
      ``capacity`` (those were dropped).
  """
  buckets: torch.Tensor
  sizes: torch.Tensor
  restore: torch.Tensor
  overflow: torch.Tensor


def bucket_counts(shard: torch.Tensor, length: int) -> torch.Tensor:
  """``jnp.bincount(shard, length=length)`` as int32, for shards in
  ``[0, length)`` (a negative one counts at 0, as there), by a
  scatter-add: ``torch.bincount`` reads its input's largest value back
  to the host."""
  counts = torch.zeros(length, dtype=torch.int32, device=shard.device)
  return counts.scatter_add_(0, shard.clamp(0, length - 1).long(),
                             torch.ones_like(shard, dtype=torch.int32))


def partition_by_fn(ids: torch.Tensor, num_shards: int,
                    shard_fn: Callable[[torch.Tensor], torch.Tensor],
                    capacity: Optional[int] = None, fill_value: int = 0,
                    valid: Optional[torch.Tensor] = None) -> Partitioned:
  """Bucket the ``[n]`` ids by ``shard_fn(ids)``, each bucket in the ids'
  order. ``capacity`` defaults to ``n`` (never overflows). ``valid``
  (``[n]`` bool) marks the ids to keep: the others take no capacity and
  no bucket."""
  n = ids.shape[0]
  if capacity is None:
    capacity = n
  shard = shard_fn(ids).to(torch.int32)
  if valid is not None:
    # Left-out ids go to a virtual bucket ``num_shards``, never stored.
    shard = torch.where(valid, shard, num_shards)
  order = torch.argsort(shard, stable=True)
  sorted_shard = shard[order]
  sorted_ids = ids[order]
  counts = bucket_counts(shard, num_shards + 1)
  sizes = counts[:num_shards]
  starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]]
                     ).to(torch.int32)
  pos = (torch.arange(n, dtype=torch.int32, device=ids.device)
         - starts[sorted_shard.clamp(0, num_shards).long()])
  in_cap = (pos < capacity) & (sorted_shard < num_shards)
  end = num_shards * capacity
  flat_pos = torch.where(in_cap, sorted_shard * capacity + pos, end
                         ).to(torch.int32)
  buckets = torch.full((end + 1,), fill_value, dtype=ids.dtype,
                       device=ids.device)
  buckets[flat_pos.long()] = sorted_ids
  restore = torch.empty(n, dtype=torch.int32, device=ids.device)
  restore[order] = flat_pos
  overflow = torch.any(sizes > capacity)
  if capacity < n:
    sizes = torch.clamp(sizes, max=capacity)
  return Partitioned(buckets[:end].reshape(num_shards, capacity), sizes,
                     restore, overflow)


def partition_by_modulo(ids: torch.Tensor, num_shards: int,
                        capacity: Optional[int] = None,
                        fill_value: int = 0) -> Partitioned:
  """Bucket ``ids`` by ``id % num_shards`` (Python's sign rule, as
  ``jnp``'s)."""
  return partition_by_fn(ids, num_shards, lambda x: x % num_shards,
                         capacity=capacity, fill_value=fill_value)


def partition_by_dual_modulo(ids: torch.Tensor, num_stage0: int,
                             num_stage1: int,
                             capacity: Optional[int] = None,
                             fill_value: int = 0
                             ) -> Tuple[Partitioned, torch.Tensor]:
  """The two-stage partition: buckets by ``(id // num_stage1) %
  num_stage0``, and each bucketed id's stage-1 key ``id % num_stage1``
  in the same ``[num_stage0, capacity]`` layout."""
  part = partition_by_fn(
      ids, num_stage0, lambda x: torch.div(x, num_stage1,
                                           rounding_mode='floor') % num_stage0,
      capacity=capacity, fill_value=fill_value)
  return part, part.buckets % num_stage1


def unpartition(flat_payload: torch.Tensor,
                restore: torch.Tensor) -> torch.Tensor:
  """Undo a partition on a payload that went through the buckets
  (``flat_payload`` in the buckets' layout, flattened over the first two
  dimensions). A restore position past the end reads the last row, as
  JAX's clamped gather does; mask those lanes."""
  return flat_payload[restore.clamp(max=flat_payload.shape[0] - 1).long()]


__all__ = ['Partitioned', 'bucket_counts', 'partition_by_dual_modulo',
           'partition_by_fn', 'partition_by_modulo', 'unpartition']
