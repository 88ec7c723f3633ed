"""Train step with row-sparse table updates.

Counterpart of ``hybridbackend_tpu/training/sparse_step.py:35-206`` at a
world of one: the tower is updated by a torch optimizer, each stacked
table by row-sparse Adagrad or LazyAdam on the rows the batch touched. The step
differentiates with respect to the looked-up embeddings, not the tables,
so no dense ``[V, D]`` gradient is ever built.

The JAX step donates its state and returns a new one. Here the state is
updated in place: the tables and accumulators by the sparse update, the
tower by its optimizer. The step returns the same state object.
``state.step`` counts steps on the host; LazyAdam's 1-based bias-correction
step is written to the device with the update, never read back.

The step follows the tables' dtype (``TableConfig.dtype``, float32 or
bfloat16): a bfloat16 table is looked up as bfloat16, the f32 tower
promotes its embeddings, their gradients come back as bfloat16, and the
table's slots, made ``*_like(table)``, are bfloat16 too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

from hybridbackend_tpu_torch.embedding.sparse_update import (
    SparseOptState, init_adagrad_state, init_adam_state,
    sparse_adagrad_apply, sparse_adam_apply)
from hybridbackend_tpu_torch.models.feature import (
    Batch, StackedFeatureExtractor)

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]
ModelLoss = Callable[[nn.Module, List[torch.Tensor], List[torch.Tensor],
                      Batch], Tuple[torch.Tensor, Dict[str, Any]]]


@dataclasses.dataclass
class SparseTrainState:
  step: int
  dense: nn.Module                          # the tower
  tables: Dict[str, torch.Tensor]           # one physical table per stack
  table_opt: Dict[str, SparseOptState]
  dense_opt: torch.optim.Optimizer

  @classmethod
  def create(cls, dense: nn.Module, tables: Dict[str, torch.Tensor],
             dense_optimizer: OptimizerFactory,
             adagrad_init: float = 0.1, *,
             adam: bool = False) -> 'SparseTrainState':
    """``dense_optimizer`` builds the tower's optimizer from its
    parameters, e.g. ``functools.partial(torch.optim.Adam, lr=1e-3)``
    for the JAX package's ``optax.adam(1e-3)``. ``adam`` gives each
    table LazyAdam slots ``(m, v)`` instead of an Adagrad accumulator
    (for ``table_optimizer='adam'``)."""
    if adam:
      table_opt = {name: init_adam_state(t) for name, t in tables.items()}
    else:
      table_opt = {name: init_adagrad_state(t, adagrad_init)
                   for name, t in tables.items()}
    return cls(step=0, dense=dense, tables=tables, table_opt=table_opt,
               dense_opt=dense_optimizer(dense.parameters()))


def make_sparse_train_step(fx: StackedFeatureExtractor,
                           model_loss: ModelLoss,
                           table_lr: float = 0.05, *,
                           table_dedup: bool = True,
                           table_optimizer: str = 'adagrad',
                           table_split_dense: bool = False
                           ) -> Callable[[SparseTrainState, Batch],
                                         Tuple[SparseTrainState, Dict]]:
  """Build ``step(state, batch) -> (state, metrics)``.

  Args:
    fx: the feature extractor declaring all embedding tables (stacked).
    model_loss: ``(tower, emb_features, dense_features, batch) ->
      (scalar_loss, aux)``, the model from combined features onward.
    table_lr: learning rate for all tables.
    table_dedup: exact duplicate-id combining before squaring; ``False``
      accumulates per-occurrence squares (TF ``SparseApplyAdagrad``).
      Adagrad only, as in the JAX package.
    table_optimizer: ``'adagrad'`` (accumulator slot) or ``'adam'``
      (LazyAdam, ``(m, v)`` slots: create the state with ``adam=True``).
    table_split_dense: the dense-split Adagrad update (the JAX option
      ``emb_update_split_dense='on'``; ``sparse_adagrad_apply(
      split_dense=True)``). Adagrad with ``table_dedup`` only: the JAX
      option applies to nothing else.

  The tower's optimizer is part of the state (a torch optimizer owns its
  slots), so unlike the JAX function this one takes no dense optimizer.
  ``metrics['loss']`` stays a device tensor: reading it is the caller's
  choice, and the step itself never waits for the device.
  """
  if table_optimizer not in ('adagrad', 'adam'):
    raise ValueError(f'Unknown table_optimizer {table_optimizer!r}; '
                     "expected 'adagrad' or 'adam'")
  if table_split_dense and (table_optimizer != 'adagrad' or not table_dedup):
    raise ValueError('table_split_dense=True needs table_optimizer='
                     "'adagrad' and table_dedup=True")
  stacks_by_name = {s.stacked.name: s for s in fx.stacks}

  def step(state: SparseTrainState, batch: Batch):
    # 1. Fused lookups; the tables are not differentiated.
    raw, ids_by_stack, layouts = fx.lookup_raw(state.tables, batch)
    raw = {name: emb.detach().requires_grad_() for name, emb in raw.items()}

    # 2. Gradients for the tower params and the raw embeddings.
    emb_f, dense_f = fx.combine_from_raw(raw, layouts, batch)
    loss, aux = model_loss(state.dense, emb_f, dense_f, batch)
    state.dense_opt.zero_grad(set_to_none=True)
    loss.backward()

    # 3. Tower update.
    state.dense_opt.step()

    # 4. Row-sparse optimizer per stacked table, in place.
    for name, emb in raw.items():
      args = (state.tables[name], state.table_opt[name], ids_by_stack[name],
              emb.grad, stacks_by_name[name].stacked, table_lr)
      if table_optimizer == 'adam':
        sparse_adam_apply(*args, step=state.step + 1)
      else:
        sparse_adagrad_apply(*args, dedup=table_dedup,
                             split_dense=table_split_dense)

    state.step += 1
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
    metrics['loss'] = loss.detach()
    return state, metrics

  return step


__all__ = ['SparseTrainState', 'make_sparse_train_step']
