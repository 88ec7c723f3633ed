"""Replicated embedding lookup, plain and combined.

Counterparts of the one-device branch of
``hybridbackend_tpu/embedding/lookup.py:116-164`` (``lookup``) and of
``:423-455`` (``lookup_sparse``). The contract: ids that are negative or
at least ``vocab_size`` read as zeros. ``jnp.take`` with ``mode='fill'``
gives that for free; torch's index ops raise on such ids, so the lookup
clamps them to row 0, gathers, then masks.

The gather is ``index_select``, whose backward the dense-gradient path
differentiates through. The serving function, which needs no backward,
passes ``serving=True``: the gather goes through kernel 5
(``ops/gather.py``, which clips the ids itself), with the same bits. A
:class:`~hybridbackend_tpu_torch.embedding.quant.QuantizedTable` is
looked up by ``lookup_quantized``, as in the JAX package
(``lookup.py:66-70``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from hybridbackend_tpu_torch.embedding.quant import (
    QuantizedTable, lookup_quantized)
from hybridbackend_tpu_torch.embedding.table import TableConfig
from hybridbackend_tpu_torch.ops.gather import gather_rows

Table = Union[torch.Tensor, QuantizedTable]


def lookup(table: Table, ids: torch.Tensor, config: TableConfig,
           serving: bool = False) -> torch.Tensor:
  """Look up ``ids`` (any shape) in ``table``; returns
  ``ids.shape + (dim,)`` in the table's dtype (float32 for a
  ``QuantizedTable``). Invalid ids give zero rows. ``serving=True``
  gathers through kernel 5, which has no backward."""
  if isinstance(table, QuantizedTable):
    return lookup_quantized(table, ids, config)
  valid = (ids >= 0) & (ids < config.vocab_size)
  if serving:
    out = gather_rows(table, config.row_index(ids))
  else:
    rows = torch.where(valid, config.row_index(ids), 0)
    out = table.index_select(0, rows.reshape(-1).to(torch.int64))
    out = out.reshape(*ids.shape, table.shape[1])
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


__all__ = ['lookup', 'lookup_sparse']
