"""Embedding table configuration, shard policy and creation.

Counterpart of ``hybridbackend_tpu/embedding/table.py:91-253``. Tables
are stored in their logical ``[vocab, dim]`` layout: the JAX package's
lane packing (``[V/p, 128]`` physical arrays) exists for the TPU's
128-lane tiles and has no counterpart here.

In a world of more than one rank a table is row-sharded or replicated by
the JAX package's policy (``:111-124``): sharded when the world has more
than one rank and the table at least as many rows as the world and as
``min_shard_rows``, unless ``sharded`` says otherwise. Rank ``r`` of
``W`` holds the contiguous rows ``[r·V/W, (r+1)·V/W)`` of the padded
vocab ``V``, rounded up to the world (``:164-173``), as JAX's
``P(axes, None)`` lays a global array out. Only row partitioning is
ported; ``partition='column'`` is ROADMAP item 15b.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Callable, Optional, Tuple

import torch

if TYPE_CHECKING:
  from hybridbackend_tpu_torch.framework.context import Context

# Knuth's multiplicative-hash constant, odd so that the mix is a bijection
# modulo any power of two (``hybridbackend_tpu/embedding/table.py:85-88``).
_MIX_CONSTANT = 0x9E3779B1 | 1
_U32 = 0xFFFFFFFF


def _round_up(x: int, m: int) -> int:
  return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class TableConfig:
  """Declarative embedding table spec (logical layout)."""
  name: str
  vocab_size: int
  dim: int
  # ``(generator, shape, dtype) -> tensor`` on the generator's device.
  initializer: Optional[Callable[[torch.Generator, Tuple[int, int],
                                  torch.dtype], torch.Tensor]] = None
  combiner: str = 'sum'            # for multivalent lookups
  dtype: torch.dtype = torch.float32   # or torch.bfloat16
  shuffle_ids: bool = False        # spread hot ids with an invertible mix
  sharded: Optional[bool] = None   # None: the policy of ``should_shard``
  partition: str = 'row'           # 'column' is not ported

  def should_shard(self, ctx: Optional['Context'] = None,
                   min_shard_rows: int = 0) -> bool:
    """Whether the table is row-sharded over ``ctx``'s world: never in a
    world of one; else as ``sharded`` says, or by default when it has at
    least as many rows as the world and as ``min_shard_rows``."""
    world = ctx.world_size if ctx is not None else 1
    if self.sharded is not None:
      return self.sharded and world > 1
    return (world > 1 and self.vocab_size >= world
            and self.vocab_size >= min_shard_rows)

  def padded_vocab(self, ctx: Optional['Context'] = None) -> int:
    """Rows of the table: the vocab, or its next power of two when the
    ids are mixed (the mix is invertible modulo a power of two), rounded
    up to the world when the table is sharded over ``ctx``."""
    v = self.vocab_size
    if self.shuffle_ids:
      v = 1 << (v - 1).bit_length()
    return _round_up(v, ctx.world_size if self.should_shard(ctx) else 1)

  def shard_rows(self, ctx: 'Context') -> slice:
    """The rows of the padded vocab that ``ctx``'s rank holds: all of
    them unless the table is sharded."""
    if not self.should_shard(ctx):
      return slice(0, self.padded_vocab(ctx))
    if self.partition != 'row':
      raise NotImplementedError(
          f'table {self.name!r}: partition={self.partition!r} is not '
          "ported; only 'row' is (column sharding is ROADMAP item 15b (3))")
    return ctx.rows(self.padded_vocab(ctx))

  def row_index(self, ids: torch.Tensor,
                ctx: Optional['Context'] = None) -> torch.Tensor:
    """Map feature ids to table rows (identity unless shuffled).

    The JAX package mixes in uint32 with wraparound; torch has no uint32
    arithmetic, so the mix runs in int64 (a non-negative int32 id times
    the 32-bit constant fits) masked to 32 bits. Negative (invalid) ids
    stay negative."""
    if not self.shuffle_ids:
      return ids
    n = self.padded_vocab(ctx)
    mixed = ((ids.to(torch.int64) * _MIX_CONSTANT) & _U32) % n
    return torch.where(ids >= 0, mixed.to(ids.dtype), ids)


def default_initializer(generator: torch.Generator, shape: Tuple[int, int],
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """Uniform in ``[-1/sqrt(dim), 1/sqrt(dim)]``, as the JAX package's
  ``default_initializer``."""
  scale = 1.0 / math.sqrt(shape[1])
  out = torch.empty(shape, dtype=torch.float32, device=generator.device)
  return out.uniform_(-scale, scale, generator=generator).to(dtype)


def create_table(config: TableConfig, generator: torch.Generator,
                 device: torch.device,
                 ctx: Optional['Context'] = None) -> torch.Tensor:
  """Materialize a ``[padded_vocab, dim]`` table on ``device``, or, when
  it is sharded over ``ctx``, this rank's rows of it.

  The values are drawn on the generator's device and then moved, so one
  seeded CPU generator gives the same table on every device; a shard is
  cut from the whole table drawn the same way, so every world holds the
  same logical table."""
  init = config.initializer or default_initializer
  out = init(generator, (config.padded_vocab(ctx), config.dim), config.dtype)
  if ctx is not None:
    out = out[config.shard_rows(ctx)]
  return out.to(device=device, dtype=config.dtype).contiguous()


__all__ = ['TableConfig', 'create_table', 'default_initializer']
