"""Replicated embedding lookup, plain and combined.

Counterparts of the one-device branch of
``hybridbackend_tpu/embedding/lookup.py:116-164`` (``lookup``) and of
``:423-455`` (``lookup_sparse``). The contract: ids that are negative or
at least ``vocab_size`` read as zeros. ``jnp.take`` with ``mode='fill'``
gives that for free; torch's index ops raise on such ids, so the lookup
clamps them to row 0, gathers, then masks.
"""

from __future__ import annotations

from typing import Optional

import torch

from hybridbackend_tpu_torch.embedding.table import TableConfig


def lookup(table: torch.Tensor, ids: torch.Tensor,
           config: TableConfig) -> torch.Tensor:
  """Look up ``ids`` (any shape) in ``table``; returns
  ``ids.shape + (dim,)`` in the table's dtype. Invalid ids give zero
  rows."""
  valid = (ids >= 0) & (ids < config.vocab_size)
  rows = torch.where(valid, config.row_index(ids), 0)
  out = table.index_select(0, rows.reshape(-1).to(torch.int64))
  out = out.reshape(*ids.shape, table.shape[1])
  return torch.where(valid.unsqueeze(-1), out, 0)


def lookup_sparse(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  config: TableConfig,
                  weights: Optional[torch.Tensor] = None,
                  combiner: Optional[str] = None) -> torch.Tensor:
  """Combined lookup over padded ragged ids
  (``tf.nn.embedding_lookup_sparse``).

  ``ids``: ``[batch, max_len]``; ``mask``: its validity (bool or 0/1);
  ``weights``: optional per-id weights; ``combiner``: ``'sum'``,
  ``'mean'`` or ``'sqrtn'`` (the table's by default), the last two over
  the masked weight total floored at 1e-9. Returns ``[batch, dim]``."""
  combiner = combiner or config.combiner
  emb = lookup(table, ids, config)
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
