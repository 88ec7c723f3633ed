"""Embedding table configuration, shard policy and creation.

Counterpart of ``hybridbackend_tpu/embedding/table.py:91-253``. Tables
are stored in their logical ``[vocab, dim]`` layout: the JAX package's
lane packing (``[V/p, 128]`` physical arrays) exists for the TPU's
128-lane tiles and has no counterpart here.

In a world of more than one rank a table is sharded or replicated by
the JAX package's policy (``:111-124``): sharded when the world has more
than one rank and the table at least as many rows as the world and as
``min_shard_rows``, unless ``sharded`` says otherwise. A sharded table
is split by its ``partition``:

* ``'row'``: rank ``r`` of ``W`` holds the contiguous rows ``[r·V/W,
  (r+1)·V/W)`` of the padded vocab ``V``, rounded up to the world
  (``:164-173``), as JAX's ``P(axes, None)`` lays a global array out;
* ``'column'`` (large-dim tables): rank ``r`` holds every row of the dim
  slice ``[r·d/W, (r+1)·d/W)``, JAX's ``P(None, axes)``. The vocab is
  not rounded to the world, and a dim that the world does not divide
  raises (``:207-216``).

A rank's shard made into a parameter of the dense path (``init_tables``
with a world) is marked with its :class:`TableShard` (the attribute
``table_shard``, read by :func:`table_shard`), so that the dense step,
the checkpoints and the export can tell it from a replicated parameter:
its gradient comes from the lookup's backward and is never all-reduced,
each rank writes its own rows (or columns), and the export gathers
them.
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
  partition: str = 'row'           # or 'column': dim-axis shards

  def __post_init__(self):
    if self.partition not in ('row', 'column'):
      raise ValueError(f'table {self.name!r}: partition must be row or '
                       f'column, not {self.partition!r}')

  @property
  def by_column(self) -> bool:
    return self.partition == 'column'

  def should_shard(self, ctx: Optional['Context'] = None,
                   min_shard_rows: int = 0) -> bool:
    """Whether the table is sharded over ``ctx``'s world: never in a
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
    up to the world when the table is row-sharded over ``ctx``."""
    v = self.vocab_size
    if self.shuffle_ids:
      v = 1 << (v - 1).bit_length()
    by_rows = self.should_shard(ctx) and not self.by_column
    return _round_up(v, ctx.world_size if by_rows else 1)

  def shard_rows(self, ctx: 'Context') -> slice:
    """The rows of the padded vocab that ``ctx``'s rank holds: all of
    them unless the table is row-sharded."""
    if not self.should_shard(ctx) or self.by_column:
      return slice(0, self.padded_vocab(ctx))
    return ctx.rows(self.padded_vocab(ctx))

  def shard_cols(self, ctx: Optional['Context']) -> slice:
    """The columns that ``ctx``'s rank holds: all of them unless the
    table is column-sharded. A dim the world does not divide raises."""
    if not (self.should_shard(ctx) and self.by_column):
      return slice(0, self.dim)
    if self.dim % ctx.world_size:
      raise ValueError(
          f'Column-sharded table {self.name!r}: dim={self.dim} must divide '
          f'evenly by world_size={ctx.world_size} (pad dim or use '
          'partition="row")')
    per = self.dim // ctx.world_size
    return slice(ctx.rank * per, (ctx.rank + 1) * per)

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


@dataclasses.dataclass(frozen=True)
class TableShard:
  """A rank's shard of a sharded table: rows ``[start, start + n)`` of
  the table's padded vocab (``n`` the shard's rows), of which the first
  ``rows`` are the table's rows at a world of one (the rest are the
  world's padding, ``padded_vocab``); of a column shard (``dim`` set,
  the table's width), every row of the columns ``[col, col + m)``."""
  start: int
  rows: int
  col: int = 0
  dim: Optional[int] = None

  @property
  def by_column(self) -> bool:
    return self.dim is not None


def shard_of(config: TableConfig,
             ctx: Optional['Context']) -> Optional[TableShard]:
  """The :class:`TableShard` of ``ctx``'s rank when ``config`` is
  sharded over ``ctx``'s world, else None."""
  if ctx is None or not config.should_shard(ctx):
    return None
  if config.by_column:
    return TableShard(0, config.padded_vocab(), config.shard_cols(ctx).start,
                      config.dim)
  return TableShard(config.shard_rows(ctx).start, config.padded_vocab())


def is_shard(config: TableConfig, shape: Tuple[int, ...]) -> bool:
  """Whether a ``[rows, cols]`` array of ``shape`` is a rank's part of
  ``config``'s table and not the whole table: fewer rows than the table
  has at a world of one (a column shard: fewer columns than its dim). A
  whole table in a world (a shard gathered back, as an exported bundle
  holds it) is looked up locally, with no collective."""
  if config.by_column:
    return shape[1] < config.dim
  return shape[0] < config.padded_vocab()


def mark_shard(t: torch.Tensor, shard: Optional[TableShard]) -> torch.Tensor:
  """``t`` marked as ``shard`` (nothing for None); returns ``t``."""
  if shard is not None:
    t.table_shard = shard
  return t


def table_shard(t: torch.Tensor) -> Optional[TableShard]:
  """The :class:`TableShard` ``t`` was marked with, or None."""
  return getattr(t, 'table_shard', None)


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
  it is sharded over ``ctx``, this rank's rows (or columns) of it.

  The values are drawn on the generator's device and then moved, so one
  seeded CPU generator gives the same table on every device. The rows of
  a world of one are drawn, ``padded_vocab()`` of them, and the rows a
  world pads the table with are zeros, appended before a shard is cut:
  every world holds the same logical table and leaves the generator in
  the same state, so what is drawn after the table is the same too."""
  init = config.initializer or default_initializer
  cols = config.shard_cols(ctx)
  out = init(generator, (config.padded_vocab(), config.dim), config.dtype)
  pad = config.padded_vocab(ctx) - out.shape[0]
  if pad > 0:
    out = torch.cat([out, out.new_zeros((pad, out.shape[1]))])
  if ctx is not None:
    out = out[config.shard_rows(ctx), cols]
  return out.to(device=device, dtype=config.dtype).contiguous()


__all__ = ['TableConfig', 'TableShard', 'create_table', 'default_initializer',
           'is_shard', 'mark_shard', 'shard_of', 'table_shard']
