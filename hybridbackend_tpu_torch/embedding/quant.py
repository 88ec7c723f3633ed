"""int8 embedding tables for serving.

Counterpart of ``hybridbackend_tpu/embedding/quant.py`` at a world of
one: per-row symmetric int8 tables, ``row v = q[v] * scale[v]`` with
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
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from hybridbackend_tpu_torch.embedding.table import TableConfig
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


def lookup_quantized(qt: QuantizedTable, ids: torch.Tensor,
                     config: TableConfig) -> torch.Tensor:
  """Look up ``ids`` (any shape) in ``qt``; returns ``ids.shape + (dim,)``
  float32, zeros for ids that are negative or at least ``vocab_size``.
  The int8 rows and the scales (a ``[V, 1]`` view) are gathered through
  kernel 5, which clips the ids; the product and the mask are torch
  elementwise ops, as the JAX package leaves them to XLA."""
  valid = (ids >= 0) & (ids < config.vocab_size)
  rows = config.row_index(ids)
  q = gather_rows(qt.q, rows)
  scale = gather_rows(qt.scale.view(-1, 1), rows)
  return torch.where(valid.unsqueeze(-1), q.to(torch.float32) * scale, 0)


__all__ = ['QuantizedTable', 'dequantize_table', 'lookup_quantized',
           'quantize_table']
