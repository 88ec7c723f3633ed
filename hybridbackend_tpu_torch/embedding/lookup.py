"""Replicated embedding lookup.

Counterpart of the one-device branch of
``hybridbackend_tpu/embedding/lookup.py:116-164``. Its contract: ids that
are negative or at least ``vocab_size`` read as zeros. ``jnp.take`` with
``mode='fill'`` gives that for free; torch's index ops raise on such ids,
so the lookup clamps them to row 0, gathers, then masks.
"""

from __future__ import annotations

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


__all__ = ['lookup']
