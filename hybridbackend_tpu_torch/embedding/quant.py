"""int8 embedding tables for serving.

Counterpart of ``hybridbackend_tpu/embedding/quant.py``: per-row
symmetric int8 tables, ``row v = q[v] * scale[v]`` with
``scale = max|row| / 127`` (1 for a zero row), about a quarter of an f32
table's bytes. Training stays f32 or bf16; a table is quantized when it
is exported (``SparseTrainer.export_saved_model(..., table_dtype=
'int8')``).

``q`` keeps the logical ``[V, d]`` layout: the JAX package lane-packs
narrow tables to ``[V/p, 128]`` for the TPU's 128-lane tiles, which the
port has no counterpart of (``convert.quantized_from_jax`` reshapes a
packed JAX table back). A lookup gathers the int8 rows and their scales
through kernel 5 (``ops/gather.py``) and multiplies them in f32: the one
product per element that the JAX package's packed lane select computes,
so the bits are the same.

A table row-sharded over a world of ranks (``TableConfig.should_shard``)
serves sharded, the bundle too large for one card that int8's fourfold
capacity is for: :func:`shard_quantized` cuts a rank's shard from a whole
table, and :func:`lookup_quantized` with the context looks a rank's ids
up over the allgather exchange (JAX ``shard_quantized`` and
``_q_lookup_sharded``, ``:97-161``). Quantization is per row, so
``quantize_table`` of a rank's float shard is ``shard_quantized`` of the
quantized whole table, bit for bit: a trainer's shards become int8
shards with no gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.embedding.table import TableConfig, is_shard
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.ops.gather import gather_rows


@dataclasses.dataclass
class QuantizedTable:
  """Per-row symmetric int8 table: ``row v = q[v] * scale[v]``."""
  q: torch.Tensor       # int8 [V, d]
  scale: torch.Tensor   # float32 [V]

  @property
  def vocab(self) -> int:
    return self.scale.shape[0]

  @property
  def dim(self) -> int:
    return self.q.shape[1]


# Its tensors are leaves of a parameter tree (``training/saved_model.py``
# flattens the served parameters into one list).
pytree.register_pytree_node(
    QuantizedTable, lambda t: ([t.q, t.scale], None),
    lambda leaves, _: QuantizedTable(*leaves),
    serialized_type_name='hybridbackend_tpu_torch.QuantizedTable')


def quantize_table(table: torch.Tensor) -> QuantizedTable:
  """Per-row symmetric int8 quantization of a ``[V, d]`` float table, on
  its device: the JAX ``quantize_table``'s bits (``rint`` rounds half to
  even, as ``torch.round`` does)."""
  t = table.detach().to(torch.float32)
  if t.dim() != 2:
    raise ValueError(f'expected a [V, d] table, got shape {tuple(t.shape)}')
  amax = t.abs().amax(dim=1)
  # A tensor divisor: CUDA divides by a Python number through its
  # reciprocal, which is not the IEEE quotient that numpy takes.
  scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)
  q = torch.clamp(torch.round(t / scale[:, None]), -127, 127)
  return QuantizedTable(q=q.to(torch.int8), scale=scale)


def dequantize_table(qt: QuantizedTable) -> torch.Tensor:
  """The ``[V, d]`` float32 table ``qt`` stands for."""
  return qt.q.to(torch.float32) * qt.scale[:, None]


def shard_quantized(qt: QuantizedTable, config: TableConfig,
                    ctx: Context) -> QuantizedTable:
  """This rank's shard of the whole table ``qt`` of ``config``: the rows
  the float shard of the same config holds (``config.shard_rows(ctx)``),
  copied; rows past ``qt``'s end (the world's padding) are ``q = 0``,
  ``scale = 1`` and read as zeros, as JAX pads (``:109-113``). ``qt``
  itself when ``config`` is not sharded over ``ctx``.

  JAX's signature takes no config: it pads the lane-packed rows to a
  multiple of the world, so a rank there holds ``ceil(V/(p·W))·p``
  logical rows. The port packs nothing, and a shard follows its own row
  sharding, ``ceil(V/W)`` rows; the two agree where ``V`` divides by
  ``p·W`` (``convert.quantized_from_jax`` cuts a JAX shard by these
  bounds). A column-sharded config raises: a row's scale is of the whole
  row, so int8 tables shard by rows only, as in JAX."""
  if not config.should_shard(ctx):
    return qt
  _by_rows(config)
  rows = config.shard_rows(ctx)
  q, scale = qt.q[rows].clone(), qt.scale[rows].clone()
  pad = (rows.stop - rows.start) - q.shape[0]
  if pad:
    q = torch.cat([q, q.new_zeros((pad, qt.dim))])
    scale = torch.cat([scale, scale.new_ones((pad,))])
  return QuantizedTable(q=q, scale=scale)


def lookup_quantized(qt: QuantizedTable, ids: torch.Tensor,
                     config: TableConfig,
                     ctx: Optional[Context] = None) -> torch.Tensor:
  """Look up ``ids`` (any shape) in ``qt``; returns ``ids.shape + (dim,)``
  float32, zeros for ids that are negative or at least ``vocab_size``.
  The int8 rows and the scales (a ``[V, 1]`` view) are gathered through
  kernel 5, which clips the ids; the product and the mask are torch
  elementwise ops, as the JAX package leaves them to XLA.

  When ``config`` is sharded over ``ctx`` and ``qt`` is a rank's shard
  (:func:`shard_quantized`; a whole table is looked up locally),
  ``ids`` are this rank's, the same number on every rank (``lookup.
  world_slice`` cuts a flat list as JAX pads and splits it, with
  ``-1``): the ranks' ids are all-gathered, each rank reads the rows it
  owns through kernel 5 and zeros elsewhere, and a reduce-scatter hands
  each rank the sum for its ids. That is JAX's allgather exchange, which
  it runs whatever the lookup strategy says, and so does the port. Each
  id's value is one owner's product plus exact zeros: bit for bit the
  world of one's. No backward."""
  if config.should_shard(ctx) and is_shard(config, qt.q.shape):
    return _lookup_sharded(qt, ids, config, ctx)
  valid = (ids >= 0) & (ids < config.vocab_size)
  rows = config.row_index(ids)
  q = gather_rows(qt.q, rows)
  scale = gather_rows(qt.scale.view(-1, 1), rows)
  return torch.where(valid.unsqueeze(-1), q.to(torch.float32) * scale, 0)


def _by_rows(config: TableConfig) -> None:
  if config.by_column:
    raise ValueError(f'table {config.name!r}: an int8 table is sharded by '
                     'rows; its config is column-partitioned')


def _lookup_sharded(qt: QuantizedTable, ids: torch.Tensor,
                    config: TableConfig, ctx: Context) -> torch.Tensor:
  _by_rows(config)
  world = ctx.world_size
  rows_per_shard = config.padded_vocab(ctx) // world
  if qt.vocab != rows_per_shard:
    raise ValueError(f'table {config.name!r}: a shard of {qt.vocab} rows, '
                     f'the world of {world} gives each rank '
                     f'{rows_per_shard} (shard_quantized)')
  flat = ids.reshape(-1)
  valid = (flat >= 0) & (flat < config.vocab_size)
  rows = torch.where(valid, config.row_index(flat, ctx), -1)
  all_ids = collective.allgather(rows, ctx=ctx).reshape(world, -1)
  owner = torch.div(all_ids, rows_per_shard, rounding_mode='floor')
  local = all_ids - owner * rows_per_shard
  q = gather_rows(qt.q, local)
  scale = gather_rows(qt.scale.view(-1, 1), local)
  contrib = torch.where((owner == ctx.rank).unsqueeze(-1),
                        q.to(torch.float32) * scale, 0)
  return collective.reduce_scatter(contrib, ctx=ctx).reshape(
      *ids.shape, qt.dim)


__all__ = ['QuantizedTable', 'dequantize_table', 'lookup_quantized',
           'quantize_table', 'shard_quantized']
