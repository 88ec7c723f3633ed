"""Table stacking: many same-dim tables in one physical table.

Counterpart of ``hybridbackend_tpu/embedding/stack.py:31-269``. Table
``i``'s rows live at ``offset[i] + local_id`` of the stacked table, so
the lookups of all members become one gather (one exchange in a world of
more than one rank) and their updates one sparse update. Sharded and
replicated tables stack apart, and a sharded member's rows take a range
rounded up to the world, so that they spread over the ranks as a table
of their own would (``:86-109``).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import torch

from hybridbackend_tpu_torch.embedding.table import (
    TableConfig, create_table, default_initializer)

if TYPE_CHECKING:
  from hybridbackend_tpu_torch.framework.context import Context

Layout = List[Tuple[str, Tuple[int, ...], int]]


@dataclasses.dataclass(frozen=True)
class TableStack:
  """A group of same-dim tables fused into one physical table."""
  configs: Tuple[TableConfig, ...]
  offsets: Tuple[int, ...]        # row offset of each member table
  stacked: TableConfig            # the physical (stacked) table config

  @property
  def dim(self) -> int:
    return self.stacked.dim

  def member(self, name: str) -> Tuple[TableConfig, int]:
    """The member table ``name``'s config and its row offset in the
    stacked table."""
    for cfg, off in zip(self.configs, self.offsets):
      if cfg.name == name:
        return cfg, off
    raise KeyError(name)


def build_stacks(configs: Sequence[TableConfig],
                 ctx: Optional['Context'] = None,
                 min_shard_rows: int = 0) -> List[TableStack]:
  """Group configs by (dim, dtype, sharded over ``ctx``) into stacks;
  tables with mixed ids keep a stack of their own. Stack names and
  member offsets match the JAX package's grouping (with one lookup
  strategy for all tables), so its checkpoints map one to one. In a
  world of more than one rank the stacked config states its shard
  policy (``sharded``), decided with ``min_shard_rows``.
  """
  world = ctx.world_size if ctx is not None else 1
  groups: Dict[Tuple, List[TableConfig]] = {}
  for cfg in configs:
    key = (('solo', cfg.name) if cfg.shuffle_ids else
           (cfg.dim, cfg.dtype, cfg.should_shard(ctx, min_shard_rows)))
    groups.setdefault(key, []).append(cfg)
  stacks = []
  for members in groups.values():
    sharded = members[0].should_shard(ctx, min_shard_rows)
    align = world if sharded else 1
    offsets, total = [], 0
    for cfg in members:
      offsets.append(total)
      total += -(-cfg.vocab_size // align) * align
    stacked_cfg = TableConfig(
        name='stack/' + '/'.join(c.name for c in members),
        vocab_size=total, dim=members[0].dim, dtype=members[0].dtype,
        combiner=members[0].combiner,
        shuffle_ids=len(members) == 1 and members[0].shuffle_ids,
        sharded=sharded if world > 1 else None,
        partition=members[0].partition)
    stacks.append(TableStack(tuple(members), tuple(offsets), stacked_cfg))
  return stacks


def create_stacked_tables(stacks: Sequence[TableStack],
                          generator: torch.Generator,
                          device: torch.device,
                          ctx: Optional['Context'] = None
                          ) -> Dict[str, torch.Tensor]:
  """One physical table per stack, each member initialized with its own
  initializer over its row range (drawn in member order); of a stack
  sharded over ``ctx``, this rank's rows of it."""
  out = {}
  for stack in stacks:
    vocab = stack.stacked.padded_vocab(ctx)
    bounds = list(stack.offsets[1:]) + [vocab]

    def init(gen, shape, dtype, _stack=stack, _bounds=bounds):
      parts = []
      for cfg, lo, hi in zip(_stack.configs, _stack.offsets, _bounds):
        init_fn = cfg.initializer or default_initializer
        parts.append(init_fn(gen, (hi - lo, cfg.dim), cfg.dtype))
      return torch.cat(parts).to(dtype)

    cfg = dataclasses.replace(stack.stacked, initializer=init)
    out[stack.stacked.name] = create_table(cfg, generator, device, ctx)
  return out


def member_tables(stack: TableStack, stacked: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
  """Split a stacked table back into ``{member_name: [rows, D]}``."""
  if stack.stacked.shuffle_ids:
    # Solo mixed stack: logical row r lives at mix(r).
    cfg = stack.configs[0]
    rows = stack.stacked.row_index(
        torch.arange(cfg.vocab_size, device=stacked.device))
    return {cfg.name: stacked[rows]}
  bounds = list(stack.offsets[1:]) + [stacked.shape[0]]
  return {cfg.name: stacked[lo:hi]
          for cfg, lo, hi in zip(stack.configs, stack.offsets, bounds)}


def pack_ids(stack: TableStack, ids_by_name: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Layout]:
  """Offset-shift and concatenate member ids into the stacked id space.

  Returns ``(all_ids [B, K] int32, layout [(name, orig_shape, width)])``.
  A member id outside ``[0, vocab)`` becomes ``-1``, so that it cannot
  land on the next member's rows."""
  names, cols, shapes, widths = [], [], [], []
  batch_dims = set()
  for cfg, off in zip(stack.configs, stack.offsets):
    if cfg.name not in ids_by_name:
      continue
    ids = ids_by_name[cfg.name]
    names.append(cfg.name)
    shapes.append(tuple(ids.shape))
    batch_dims.add(ids.shape[0])
    # Validity is tested in the ids' own dtype, before the cast: an int64
    # id of 2**32 + 5 must not wrap to row 5.
    col = ids.reshape(ids.shape[0], -1)
    valid = (col >= 0) & (col < cfg.vocab_size)
    cols.append(torch.where(valid, col + off, -1).to(torch.int32))
    widths.append(col.shape[1])
  if len(batch_dims) != 1:
    raise ValueError(
        f'stacked lookup needs a common leading batch dim; got {shapes}')
  return torch.cat(cols, dim=1), list(zip(names, shapes, widths))


def unpack_embeddings(stack: TableStack, emb: torch.Tensor,
                      layout: Layout) -> Dict[str, torch.Tensor]:
  """Split fused ``[B, K, D]`` embeddings back per member."""
  out = {}
  pos = 0
  for name, shape, width in layout:
    out[name] = emb[:, pos:pos + width].reshape(
        emb.shape[0], *shape[1:], stack.dim)
    pos += width
  return out


__all__ = ['TableStack', 'build_stacks', 'create_stacked_tables',
           'member_tables', 'pack_ids', 'unpack_embeddings']
