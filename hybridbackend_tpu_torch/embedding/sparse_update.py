"""Row-sparse table optimizers: Adagrad, SGD and LazyAdam.

Counterpart of the replicated branch of
``hybridbackend_tpu/embedding/sparse_update.py`` at a world of one:
``sparse_adagrad_apply`` (``:629-731``, with ``_stream_adagrad`` at
``:253-287``), ``sparse_sgd_apply`` (``:784-832``) and
``sparse_adam_apply`` (``:853-935``). Given the batch's ids and the
gradient with respect to the looked-up embeddings, each updates only the
touched rows. Unlike the JAX functions, which return new arrays, they
update the table and its slots in place.

Every entry maps ids to rows, drops ids outside ``[0, vocab)``, sorts the
list stably (equal rows stay in list order, so each row's total is summed
in the same order on every run) and hands it to one kernel of
``ops/scatter.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from hybridbackend_tpu_torch.embedding.table import TableConfig
from hybridbackend_tpu_torch.ops.scatter import (
    Lr, Step, adagrad_update_sorted, adam_update_sorted, scatter_add_sorted)


@dataclasses.dataclass
class SparseOptState:
  """Per-table slot state: ``(acc,)`` for Adagrad, ``(m, v)`` for
  LazyAdam."""
  acc: Tuple[torch.Tensor, ...]


def init_adagrad_state(table: torch.Tensor,
                       initial: float = 0.1) -> SparseOptState:
  """Accumulator of the table's shape, filled with ``initial``."""
  return SparseOptState(acc=(torch.full_like(table, initial),))


def init_adam_state(table: torch.Tensor) -> SparseOptState:
  """LazyAdam moments ``(m, v)`` of the table's shape, zero."""
  return SparseOptState(acc=(torch.zeros_like(table),
                             torch.zeros_like(table)))


def _valid_rows(rows, ids, config: TableConfig):
  """The lookup's validity contract: an id outside ``[0, vocab)`` must
  not resolve to a real (mixed or padding) row. For LazyAdam even a
  zero-gradient touch decays a row's moments."""
  return torch.where((ids >= 0) & (ids < config.vocab_size), rows, -1)


def _sorted_list(table: torch.Tensor, ids: torch.Tensor, demb: torch.Tensor,
                 config: TableConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The update list ``(rows int32 [N] ascending, grads [N, d])``."""
  flat = ids.reshape(-1)
  rows = _valid_rows(config.row_index(flat), flat, config).to(torch.int32)
  g = demb.reshape(-1, demb.shape[-1]).to(table.dtype)
  rows, order = torch.sort(rows, stable=True)
  return rows, g.index_select(0, order)


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
      squaring (exact Adagrad). ``False``: each occurrence's square is
      accumulated (TF ``SparseApplyAdagrad``, the JAX package's XLA path
      ``_adagrad_rows_nodedup``), with the denominator read after all of
      a row's squares land. The JAX stream kernel ignores ``False``; the
      port honours it on every device.

  Returns ``(table, state)``, the same objects, updated.
  """
  rows, g = _sorted_list(table, ids, demb, config)
  adagrad_update_sorted(table, state.acc[0], rows, g, lr, eps, dedup)
  return table, state


def sparse_sgd_apply(table: torch.Tensor, ids: torch.Tensor,
                     demb: torch.Tensor, config: TableConfig,
                     lr: Lr) -> torch.Tensor:
  """SGD on touched rows only, in place (no slot state): each row moves
  by ``-lr`` times its gradient total. The gradients are scaled before
  they are summed, as the JAX stream path does. Returns ``table``."""
  rows, g = _sorted_list(table, ids, demb, config)
  return scatter_add_sorted(table, rows, g * (-lr))


def sparse_adam_apply(table: torch.Tensor, state: SparseOptState,
                      ids: torch.Tensor, demb: torch.Tensor,
                      config: TableConfig, lr: Lr, step: Step,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                      ) -> Tuple[torch.Tensor, SparseOptState]:
  """LazyAdam on touched rows only, in place (TF ``LazyAdam``: moments of
  untouched rows do not decay; a row present with a zero gradient total
  is touched). ``state.acc = (m, v)``; ``step`` is the 1-based step count
  for bias correction, a number or a device tensor.

  Returns ``(table, state)``, the same objects, updated.
  """
  m, v = state.acc
  rows, g = _sorted_list(table, ids, demb, config)
  adam_update_sorted(table, m, v, rows, g, lr, step, b1, b2, eps)
  return table, state


__all__ = ['SparseOptState', 'init_adagrad_state', 'init_adam_state',
           'sparse_adagrad_apply', 'sparse_adam_apply', 'sparse_sgd_apply']
