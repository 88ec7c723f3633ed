"""Train step with row-sparse table updates.

Counterpart of ``hybridbackend_tpu/training/sparse_step.py:35-206``, with
both of its model hooks (``model_loss`` on the
combined features, ``raw_model_loss`` on the members' uncombined
embeddings): the tower is updated by a torch optimizer, each stacked
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

In a world of more than one rank (the feature extractor's context) each
rank runs the step on its rows ``[r·B/W, (r+1)·B/W)`` of the global
batch, as ``shard_map`` splits ``P(axes)``, with its shards of the
sharded stacks; this is the hybrid parallelism of the JAX step (the
reference's ``gradient.py:119-218``). The tower is data-parallel: its
gradients, means over the rank's rows, are summed over the ranks in one
flat all-reduce and divided by the world. The embeddings' gradients are
scaled by ``1/W``, so that they carry the global batch's ``1/B`` as in
JAX (``sparse_step.py:149``), and go to the tables' owners through the
sparse update's exchange. Both scalings take the loss to be a mean over
the rank's rows, as JAX's wire path does: a loss summed over the batch
gets gradients ``W`` times too small. The reported loss is the mean over the ranks.
The towers start equal: ``SparseTrainState.create`` broadcasts rank 0's.
Every table optimizer, both model hooks and both table dtypes run there
as at a world of one. A stack row-sharded over the ranks is looked up by
``lookup_strategy`` (``'allgather'``, ``'alltoall'``, ``'hierarchical'``
over the node layout, or ``'gspmd'``) and its gradients routed to the
owners by ``update_exchange`` over all ranks, as in JAX
(``sparse_update.py:514``); a column-sharded stack (``partition=
'column'``) takes its one exchange both ways, each rank updating its dim
slice with the whole batch's list. In raw mode each rank hands
``raw_model_loss`` its own rows of every member, unpacked from its own
raw block; per-example aux outputs stay the rank's own.
``gradient_wire_dtype`` casts the tower's all-reduce (the sum of
``g.astype(wire)``, then divided by the world, JAX ``:128-149``) and the
routed gradient buckets; ``wire_dtype`` the alltoall and hierarchical
lookups' returning rows.

The step's three phases run inside named ranges (``utils/profiler.py``:
``hb/lookup``, ``hb/tower``, ``hb/update``), one of each a step, which a
``torch.profiler`` trace shows and, on the card, Nsight Systems as NVTX
ranges; ``named_scopes=False`` leaves them out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.embedding.sparse_update import (
    SparseOptState, init_adagrad_state, init_adam_state,
    sparse_adagrad_apply, sparse_adam_apply)
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.models.feature import (
    Batch, StackedFeatureExtractor)
from hybridbackend_tpu_torch.utils.profiler import named_scope

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]
ModelLoss = Callable[[nn.Module, List[torch.Tensor], List[torch.Tensor],
                      Batch], Tuple[torch.Tensor, Dict[str, Any]]]
RawModelLoss = Callable[[nn.Module, Dict[str, torch.Tensor], Batch],
                        Tuple[torch.Tensor, Dict[str, Any]]]


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
             adam: bool = False,
             ctx: Optional[Context] = None) -> 'SparseTrainState':
    """``dense_optimizer`` builds the tower's optimizer from its
    parameters, e.g. ``functools.partial(torch.optim.Adam, lr=1e-3)``
    for the JAX package's ``optax.adam(1e-3)``. ``adam`` gives each
    table LazyAdam slots ``(m, v)`` instead of an Adagrad accumulator
    (for ``table_optimizer='adam'``). In a world of more than one rank
    (``ctx``) every rank's tower becomes rank 0's."""
    if ctx is not None and ctx.world_size > 1:
      broadcast_tower(dense, ctx)
    if adam:
      table_opt = {name: init_adam_state(t) for name, t in tables.items()}
    else:
      table_opt = {name: init_adagrad_state(t, adagrad_init)
                   for name, t in tables.items()}
    return cls(step=0, dense=dense, tables=tables, table_opt=table_opt,
               dense_opt=dense_optimizer(dense.parameters()))


def broadcast_tower(tower: nn.Module, ctx: Context) -> None:
  """Rank 0's parameters and buffers on every rank, in place."""
  with torch.no_grad():
    for t in [*tower.parameters(), *tower.buffers()]:
      t.copy_(collective.broadcast(t, 0, ctx=ctx))


def _mean_tower_grads(tower: nn.Module, ctx: Context,
                      wire_dtype: collective.WireDtype = None) -> None:
  """Each tower gradient, a mean over the rank's rows, replaced by the
  mean over the ranks: one flat all-reduce in ``wire_dtype``, then a
  division by the world in the gradients' dtype."""
  grads = [p.grad for p in tower.parameters() if p.grad is not None]
  if not grads:
    return
  flat = collective.allreduce(torch.cat([g.reshape(-1) for g in grads]),
                              ctx=ctx, wire_dtype=wire_dtype)
  flat /= ctx.world_size
  pos = 0
  for g in grads:
    g.copy_(flat[pos:pos + g.numel()].view_as(g))
    pos += g.numel()


def _exchange_options(ctx: Context, *, lookup_bucket_ratio: float,
                      update_exchange: str, update_bucket_ratio: float,
                      overflow_fallback: bool, unique_ratio: float,
                      wire_dtype: collective.WireDtype,
                      gradient_wire_dtype: collective.WireDtype
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
  """The keywords of the lookups (``fx.lookup_raw``, beside the
  strategy) and of the sparse updates (``sparse_*_apply``) in the world
  ``ctx``, from the steps' exchange options; the wire dtypes checked
  here, so that a bad name fails at build and not mid-step."""
  collective.wire_dtype_of(wire_dtype)
  collective.wire_dtype_of(gradient_wire_dtype)
  lookup = dict(bucket_ratio=lookup_bucket_ratio,
                overflow_fallback=overflow_fallback,
                unique_ratio=unique_ratio, wire_dtype=wire_dtype)
  update = dict(ctx=ctx, exchange=update_exchange,
                bucket_ratio=update_bucket_ratio,
                overflow_fallback=overflow_fallback,
                gradient_wire_dtype=gradient_wire_dtype)
  return lookup, update


def _table_grad(grad: torch.Tensor, world: int) -> torch.Tensor:
  """An embedding gradient, a mean over the rank's rows, scaled by
  ``1/W`` in a world of ``W > 1`` ranks, so that it carries the global
  batch's ``1/B`` as in JAX (``sparse_step.py:149``)."""
  return grad / world if world > 1 else grad


def _update_tables(state: SparseTrainState, grads: Dict[str, torch.Tensor],
                   ids_by_stack: Dict[str, torch.Tensor], stacks_by_name,
                   table_lr: float, table_optimizer: str,
                   update: Dict[str, Any], **adagrad) -> None:
  """One row-sparse update a stack, in place: LazyAdam at the step
  ``state.step + 1``, or Adagrad with ``adagrad``'s options (``dedup``,
  ``split_dense``); ``update`` the exchange's keywords."""
  for name, grad in grads.items():
    args = (state.tables[name], state.table_opt[name], ids_by_stack[name],
            grad, stacks_by_name[name].stacked, table_lr)
    if table_optimizer == 'adam':
      sparse_adam_apply(*args, step=state.step + 1, **update)
    else:
      sparse_adagrad_apply(*args, **adagrad, **update)


def _detached_metrics(aux: Dict[str, Any], loss: torch.Tensor,
                      ctx: Context) -> Dict[str, Any]:
  """``aux`` detached with ``loss`` under ``'loss'``; in a world of more
  than one rank the scalars become means over the ranks, as JAX's
  ``pmean``, and the per-example values stay the rank's own."""
  metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
             for k, v in aux.items()}
  metrics['loss'] = loss.detach()
  if ctx.world_size > 1:
    metrics = {k: (collective.allreduce(v, 'mean', ctx=ctx)
                   if isinstance(v, torch.Tensor) and v.dim() == 0 else v)
               for k, v in metrics.items()}
  return metrics


def loss_from_raw(fx: StackedFeatureExtractor,
                  model_loss: Optional[ModelLoss],
                  raw_model_loss: Optional[RawModelLoss] = None):
  """``loss(tower, raw_by_stack, layouts, batch) -> (loss, aux)`` from
  the stacks' raw embeddings (``fx.lookup_raw``): through
  ``raw_model_loss`` on the members' uncombined embeddings when it is
  given, else through ``model_loss`` on the combined features. The train
  step, the trainers' evaluation and predictions all run this one."""
  if raw_model_loss is not None:
    def loss(tower, raw, layouts, batch):
      return raw_model_loss(tower, fx.members_from_raw(raw, layouts), batch)
  else:
    def loss(tower, raw, layouts, batch):
      emb_f, dense_f = fx.combine_from_raw(raw, layouts, batch)
      return model_loss(tower, emb_f, dense_f, batch)
  return loss


def make_sparse_train_step(fx: StackedFeatureExtractor,
                           model_loss: Optional[ModelLoss],
                           table_lr: float = 0.05, *,
                           table_dedup: bool = True,
                           table_optimizer: str = 'adagrad',
                           table_split_dense: bool = False,
                           raw_model_loss: Optional[RawModelLoss] = None,
                           lookup_strategy: str = 'allgather',
                           lookup_bucket_ratio: float = 2.0,
                           update_exchange: str = 'alltoall',
                           update_bucket_ratio: float = 2.0,
                           overflow_fallback: bool = True,
                           unique_ratio: float = 1.0,
                           wire_dtype: collective.WireDtype = None,
                           gradient_wire_dtype: collective.WireDtype = None,
                           named_scopes: bool = True
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
    raw_model_loss: ``(tower, members {name: [B, ..., D]}, batch) ->
      (scalar_loss, aux)``, the model from the members' uncombined
      embeddings (each in its id column's shape plus ``D``): for sequence
      models, such as DIN's attention over a ``[B, L, D]`` history, that
      take the embeddings before any combiner. When it is given,
      ``model_loss`` is not used (pass ``None``). The gradient of each
      member's embeddings reaches its stack's update as on the combined
      path, with every table optimizer and dtype. In a world of more
      than one rank ``B`` is the rank's rows.
    lookup_strategy, lookup_bucket_ratio, update_exchange,
      update_bucket_ratio, overflow_fallback, unique_ratio: how the
      sharded stacks exchange ids, rows and gradients in a world of more
      than one rank, the JAX options ``emb_lookup_strategy``,
      ``emb_lookup_bucket_ratio``, ``emb_update_exchange``,
      ``emb_update_bucket_ratio``, ``emb_lookup_overflow_fallback`` and
      ``emb_update_overflow_fallback`` (one switch for both), and
      ``emb_unique_ratio``, with their defaults
      (``embedding/lookup.py``, ``embedding/sparse_update.py``).
    wire_dtype, gradient_wire_dtype: the JAX options
      ``comm_wire_dtype`` (the alltoall lookup's returning rows) and
      ``comm_gradient_wire_dtype`` (the tower's all-reduce and the
      routed table gradients): ``None`` or ``'float32'``, ``'bfloat16'``
      or ``'float16'``. Used in a world of more than one rank only, as in
      JAX.
    named_scopes: open the ranges ``hb/lookup``, ``hb/tower`` and
      ``hb/update`` around the step's phases (``utils/profiler.py``).

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
  ctx = fx.ctx
  world = ctx.world_size
  stacks_by_name = {s.stacked.name: s for s in fx.stacks}
  loss_of = loss_from_raw(fx, model_loss, raw_model_loss)
  exchange, update = _exchange_options(
      ctx, lookup_bucket_ratio=lookup_bucket_ratio,
      update_exchange=update_exchange,
      update_bucket_ratio=update_bucket_ratio,
      overflow_fallback=overflow_fallback, unique_ratio=unique_ratio,
      wire_dtype=wire_dtype, gradient_wire_dtype=gradient_wire_dtype)

  scope = (functools.partial(named_scope, device=ctx.device) if named_scopes
           else lambda name: contextlib.nullcontext())

  def step(state: SparseTrainState, batch: Batch):
    # 1. Fused lookups; the tables are not differentiated.
    with scope('hb/lookup'):
      raw, ids_by_stack, layouts = fx.lookup_raw(state.tables, batch,
                                                 lookup_strategy, **exchange)
      raw = {name: emb.detach().requires_grad_()
             for name, emb in raw.items()}

    with scope('hb/tower'):
      # 2. Gradients for the tower params and the raw embeddings.
      loss, aux = loss_of(state.dense, raw, layouts, batch)
      state.dense_opt.zero_grad(set_to_none=True)
      loss.backward()

      # 3. Tower update, from the mean of the ranks' gradients.
      if world > 1:
        _mean_tower_grads(state.dense, ctx, gradient_wire_dtype)
      state.dense_opt.step()

    # 4. Row-sparse optimizer per stacked table, in place. A stack the
    # loss did not read has a zero gradient, as in JAX.
    with scope('hb/update'):
      grads = {name: _table_grad(emb.grad if emb.grad is not None
                                 else torch.zeros_like(emb), world)
               for name, emb in raw.items()}
      _update_tables(state, grads, ids_by_stack, stacks_by_name, table_lr,
                     table_optimizer, update, dedup=table_dedup,
                     split_dense=table_split_dense)

    state.step += 1
    return state, _detached_metrics(aux, loss, ctx)

  return step


__all__ = ['SparseTrainState', 'broadcast_tower', 'loss_from_raw',
           'make_sparse_train_step']
