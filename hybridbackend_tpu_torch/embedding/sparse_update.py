"""Row-sparse Adagrad on embedding tables.

Counterpart of the replicated branch of
``hybridbackend_tpu/embedding/sparse_update.py:sparse_adagrad_apply``
(``:629-731``, with ``_stream_adagrad`` at ``:253-287``): given the
batch's ids and the gradient with respect to the looked-up embeddings,
it updates only the touched rows. Unlike the JAX function, which returns
new arrays, it updates the table and accumulator in place.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from hybridbackend_tpu_torch.embedding.table import TableConfig
from hybridbackend_tpu_torch.ops.scatter import Lr, adagrad_update_sorted


@dataclasses.dataclass
class SparseOptState:
  """Per-table slot state (the Adagrad accumulator)."""
  acc: Tuple[torch.Tensor, ...]


def init_adagrad_state(table: torch.Tensor,
                       initial: float = 0.1) -> SparseOptState:
  """Accumulator of the table's shape, filled with ``initial``."""
  return SparseOptState(acc=(torch.full_like(table, initial),))


def _valid_rows(rows, ids, config: TableConfig):
  """The lookup's validity contract: an id outside ``[0, vocab)`` must
  not resolve to a real (mixed or padding) row."""
  return torch.where((ids >= 0) & (ids < config.vocab_size), rows, -1)


def sparse_adagrad_apply(table: torch.Tensor, state: SparseOptState,
                         ids: torch.Tensor, demb: torch.Tensor,
                         config: TableConfig, lr: Lr, eps: float = 1e-7,
                         dedup: bool = True
                         ) -> Tuple[torch.Tensor, SparseOptState]:
  """Adagrad on touched rows only, in place.

  Args:
    ids: the batch's lookup ids, any shape.
    demb: gradient of the loss with respect to the looked-up embeddings,
      ``ids.shape + (dim,)``.
    dedup: duplicate ids are combined into per-row totals before
      squaring (exact Adagrad). Only ``True`` exists so far.

  Returns ``(table, state)``, the same objects, updated.
  """
  if not dedup:
    raise NotImplementedError(
        'dedup=False (TF SparseApplyAdagrad semantics) is not ported yet; '
        'see ROADMAP.md queue 1, "The other sparse optimizers"')
  flat = ids.reshape(-1)
  rows = _valid_rows(config.row_index(flat), flat, config).to(torch.int32)
  g = demb.reshape(-1, demb.shape[-1]).to(table.dtype)
  # A stable sort keeps equal rows in list order, so each row's total is
  # summed in the same order on every run.
  rows, order = torch.sort(rows, stable=True)
  adagrad_update_sorted(table, state.acc[0], rows, g.index_select(0, order),
                        lr, eps)
  return table, state


__all__ = ['SparseOptState', 'init_adagrad_state', 'sparse_adagrad_apply']
