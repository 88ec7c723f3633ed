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
``ops/scatter.py``. The dense-split form of Adagrad (``split_dense``)
hands it to the dense row-totals kernel and applies the update with
elementwise torch ops over the whole table, as the JAX package leaves
that apply to XLA.

Tables may be float32 or bfloat16; the slots (``*_like(table)``, as in
JAX) and the gradient list take the table's dtype, and every update does
its math in float32 and rounds each stored result once
(``ops/scatter.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from hybridbackend_tpu_torch.embedding.table import TableConfig
from hybridbackend_tpu_torch.ops.scatter import (
    Lr, Step, _device_scalar, adagrad_update_sorted, adam_update_sorted,
    gsum_dense_sorted, scatter_add_sorted)


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


def _split_dense_adagrad(table: torch.Tensor, acc: torch.Tensor,
                         rows: torch.Tensor, g: torch.Tensor, lr: Lr,
                         eps: float):
  """The dense-split Adagrad update (``_stream_adagrad``'s split branch,
  ``:273-284``): dense f32 ``[V, d]`` row totals from
  :func:`gsum_dense_sorted`, then a whole-table elementwise apply in
  place, in the fused kernel's order of operations: ``a = f32(acc) +
  s·s``, then ``table = f32(table) - (lr·s) / (sqrt(a) + eps)``, each op
  rounded on its own (no ``addcdiv_``, no FMA across them) and each
  stored result rounded once to the storage dtype, the denominator taken
  from the unrounded ``a``. Rows with ``s == 0`` keep their bits: ``acc +
  0`` and ``table - 0``. A float32 table and acc are updated without a
  copy."""
  if table.dtype not in (torch.float32, torch.bfloat16) or (
      acc.dtype != table.dtype or acc.shape != table.shape):
    raise TypeError('the dense-split update takes a float32 or bfloat16 '
                    'table and an acc of its dtype and shape; got '
                    f'{table.dtype} {tuple(table.shape)} and {acc.dtype} '
                    f'{tuple(acc.shape)}')
  gsum = gsum_dense_sorted(rows, g, table.shape[0])
  tmp = gsum * gsum
  a = acc.float().add_(tmp)              # acc itself when it is float32
  t = table.float()
  denom = torch.sqrt(a, out=tmp).add_(eps)
  t.sub_(gsum.mul_(_device_scalar(lr, table.device)).div_(denom))
  for store, value in ((acc, a), (table, t)):
    if value is not store:
      store.copy_(value)


def sparse_adagrad_apply(table: torch.Tensor, state: SparseOptState,
                         ids: torch.Tensor, demb: torch.Tensor,
                         config: TableConfig, lr: Lr, eps: float = 1e-7,
                         dedup: bool = True, split_dense: bool = False
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
    split_dense: the dense-split form (the JAX option
      ``emb_update_split_dense='on'``): the dense per-row totals kernel,
      then an elementwise apply over the whole table and accumulator.
      The same result as the fused update, bit for bit; it moves the
      whole table. Needs ``dedup``: dense totals carry no per-occurrence
      squares.

  Returns ``(table, state)``, the same objects, updated.
  """
  if split_dense and not dedup:
    raise ValueError('split_dense=True needs dedup=True: the dense row '
                     'totals carry no per-occurrence squares')
  rows, g = _sorted_list(table, ids, demb, config)
  if split_dense:
    _split_dense_adagrad(table, state.acc[0], rows, g, lr, eps)
  else:
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
