"""The trainers: train, evaluate, predict, checkpoint and resume.

Counterpart of ``hybridbackend_tpu/estimator/__init__.py:39-490``
(``Trainer`` and ``SparseTrainer``) at a world of one device. A trainer
owns the state, its step, the eval step, the checkpoints in
``model_dir`` (restored on construction), hooks, and the input path:
host batches go through ``SyncReplicasIterator`` and are placed on the
context's device in the loop, or with ``prefetch=True`` staged ahead of
the step by ``DeviceIterator``. The iterator's thread overlaps a
source's own waits (file reads, decoding) with the steps; from batches
already in memory there is nothing to overlap, and its staging costs the
host-bound step at least as much host time as placing each batch in the
loop (``chip_smoke.py`` phase 17 times both ways on the card), so it is
off by default.

Nothing in the loop reads the device back per step or per batch: the
train metrics are read once at the end of ``train`` (and by a hook at its
own windows), and the eval metrics stay device tensors until
``evaluate`` returns.

Host-backed tables (``SparseTrainer(caches=...)``) run through the
``_host_transform``, ``_eval_host_transform`` and ``_cache_runner``
hooks: each host batch's cached columns are mapped to cache slots
before it is placed (``CacheRunner.transform``: in the loop by default,
ahead in the producer thread with ``prefetch=True``; both orders give
the same tables), the oldest plan's evictions and uploads are applied in
place to the live state before each step, the resident rows are written
back at every checkpoint, and evaluation and prediction map ids
read-only (``embedding/service.py``).

``export_saved_model`` writes a serving bundle
(``training/saved_model.py``) that a cold process loads as ``Served``,
with bundled ``id_mappers`` for dynamic tables and cache-backed columns
served from their full host tables. Not in this slice (ROADMAP queue
1): summaries (item 17).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch import metrics as hbm
from hybridbackend_tpu_torch.data.prefetch import DeviceIterator, put_batch
from hybridbackend_tpu_torch.data.sync import (
    SYNC_VALID_KEY, SyncReplicasIterator)
from hybridbackend_tpu_torch.embedding.lookup import lookup
from hybridbackend_tpu_torch.embedding.quant import quantize_table
from hybridbackend_tpu_torch.embedding.service import (
    CacheRunner, EmbeddingCache)
from hybridbackend_tpu_torch.embedding.stack import member_tables
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.models.feature import (
    EmbeddingSpec, StackedFeatureExtractor, extract_features)
from hybridbackend_tpu_torch.training.checkpoint import CheckpointManager
from hybridbackend_tpu_torch.training.hooks import Hook, StepStatHook
from hybridbackend_tpu_torch.training.optimizer import (
    Adagrad, OptimizerFactory, init_state, load_slots_by_name, slots_by_name)
from hybridbackend_tpu_torch.training.saved_model import export
from hybridbackend_tpu_torch.training.sparse_step import (
    RawModelLoss, SparseTrainState, loss_from_raw, make_sparse_train_step)
from hybridbackend_tpu_torch.training.train import (
    TrainState, make_eval_step, make_train_step)

LOG = logging.getLogger('hybridbackend_tpu_torch')


def _metrics_step(auc_s, loss_s, gauc_s, labels, preds, pel, loss, valid,
                  ind):
  """One batch's metric updates, all on the device. ``pel`` (per-example
  loss), ``valid`` (``_sync_valid``) and ``ind`` (the group column) may
  be None."""
  auc_s = hbm.auc_update(auc_s, labels, preds, weights=valid)
  if pel is not None:
    loss_s = hbm.mean_update(loss_s, pel, valid)
  elif valid is not None:
    loss_s = hbm.mean_update(loss_s, loss.reshape(1), valid.sum().reshape(1))
  else:
    loss_s = hbm.mean_update(
        loss_s, loss.reshape(1),
        torch.full((1,), float(labels.shape[0]), device=labels.device))
  if ind is not None:
    if valid is not None:
      # Padding rows must not join a real group: give them an indicator
      # below every real one. Their labels are 0, so their group has one
      # class and is skipped. Signed, so the sentinel cannot wrap.
      ind = ind.to(torch.int64)
      ind = torch.where(valid > 0, ind, ind.min() - 1)
    # Eval batches need not hold each group in one run: sort them.
    gauc_s = hbm.gauc_update(gauc_s, labels, preds, ind, sort_groups=True)
  return auc_s, loss_s, gauc_s


class _Apply(nn.Module):
  """``fn(module, *args)`` as a module's forward, so that
  ``torch.func.functional_call`` can run ``fn`` on other values of
  ``module``'s parameters and buffers."""

  def __init__(self, module: nn.Module, fn: Callable):
    super().__init__()
    self.module = module
    self.fn = fn

  def forward(self, *args):
    return self.fn(self.module, *args)


def _leaves(module: nn.Module) -> Dict[str, torch.Tensor]:
  """``module``'s parameters and buffers by name: the served copy of its
  state, which the exported graph takes as inputs."""
  return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def _call_with(module: nn.Module, leaves: Dict[str, torch.Tensor],
               fn: Callable, *args):
  """``fn(module, *args)`` with ``leaves`` in place of ``module``'s state."""
  return torch.func.functional_call(
      _Apply(module, fn), {f'module.{k}': v for k, v in leaves.items()},
      args)


def _host_mean(v) -> float:
  if isinstance(v, torch.Tensor):
    return float(v.detach().to(torch.float32).mean())
  return float(v)


class Trainer:
  """Owns the training lifecycle of one model on the dense-gradient path.

  Class attributes ``_host_transform`` / ``_eval_host_transform`` /
  ``_cache_runner`` are the hooks of host-backed tables (set by
  ``SparseTrainer(caches=...)``): training batches pass through the
  first before placement (on ``DeviceIterator``'s producer thread with
  ``prefetch=True``), evaluation and prediction batches through the
  second, and the runner's pending array effects are applied to the
  state before each step. A dynamic table's ``DynamicEmbedding.
  transform(column)`` and ``transform(column, train=False)`` may be set
  on an instance as the first two, as the JAX trainer's are.

  Args:
    loss_fn: ``(params, batch) -> (scalar_loss, aux)``; ``aux`` should
      hold ``'preds'`` for the built-in metrics, and
      ``'per_example_loss'`` for an exact eval loss.
    params: an ``nn.Module`` on ``ctx.device`` that holds the tables (as
      parameters under a name with 'table' in it, for example an
      ``init_tables`` ParameterDict named ``tables``) and the tower.
    optimizer: built on ``params``, for example
      ``multi_optimizer(partial(Adagrad, lr=0.05), partial(torch.optim.
      Adam, lr=1e-3))(params)``; by default ``Adagrad(lr=0.1)`` on all.
    model_dir: checkpoint directory; its latest checkpoint is restored
      now. ``None`` keeps no checkpoints.
    ctx: the device everything runs on.
    label_key, group_key: the label column, and the column of group ids
      for GAUC (no GAUC when None).
    keep_checkpoint_max, grow_vocab: the checkpoint manager's
      ``max_to_keep`` and ``grow_vocab``.
    prefetch_capacity: batches ``DeviceIterator`` stages ahead (with
      ``prefetch=True``).
  """

  _host_transform: Optional[Callable] = None
  _eval_host_transform: Optional[Callable] = None
  _cache_runner = None

  def __init__(self, loss_fn: Callable, params: nn.Module,
               optimizer=None, model_dir: Optional[str] = None, *,
               ctx: Context, label_key: str = 'label',
               group_key: Optional[str] = None,
               keep_checkpoint_max: int = 5, grow_vocab: bool = False,
               prefetch_capacity: int = 2):
    for name, p in params.named_parameters():
      if p.device != ctx.device:
        raise ValueError(f'parameter {name} is on {p.device}, the context '
                         f'on {ctx.device}')
    if optimizer is None:
      optimizer = Adagrad(params.parameters(), lr=0.1)
    self.state = TrainState.create(params, optimizer)
    self._loss_fn = loss_fn
    self._step_fn = make_train_step(loss_fn)
    self._eval_fn = make_eval_step(loss_fn)
    self._setup(ctx, label_key, group_key, prefetch_capacity, model_dir,
                keep_checkpoint_max, grow_vocab)

  def _setup(self, ctx, label_key, group_key, prefetch_capacity, model_dir,
             keep_checkpoint_max, grow_vocab) -> None:
    self._ctx = ctx
    self._label_key = label_key
    self._group_key = group_key
    self._capacity = prefetch_capacity
    self._ckpt: Optional[CheckpointManager] = None
    if model_dir:
      self._ckpt = CheckpointManager(model_dir, keep_checkpoint_max,
                                     device=ctx.device,
                                     grow_vocab=grow_vocab)
      template = self._checkpoint_state()
      restored = self._ckpt.restore(template)
      if restored is not template:
        self._load_checkpoint_state(restored)
        LOG.info('restored checkpoint at step %d', self.global_step)

  # -- state -----------------------------------------------------------------

  def _checkpoint_state(self) -> Dict[str, Any]:
    return {'step': self.state.step,
            'params': self.state.params.state_dict(),
            'opt_state': slots_by_name(self.state.optimizer,
                                       self.state.params)}

  def _load_checkpoint_state(self, restored: Dict[str, Any]) -> None:
    self.state.params.load_state_dict(restored['params'])
    load_slots_by_name(self.state.optimizer, self.state.params,
                       restored['opt_state'])
    self.state.step = restored['step']

  def _save(self, step: int) -> None:
    self._ckpt.save(step, self._checkpoint_state())

  @property
  def params(self):
    return self.state.params

  @property
  def global_step(self) -> int:
    return self.state.step

  def _device_batches(self, it: Iterator, prefetch: bool,
                      transform: Optional[Callable] = None) -> Iterator:
    """``it``'s host batches through ``transform`` (when given) and
    onto the device: staged ahead by ``DeviceIterator`` (the transform on
    its producer thread), or each in the loop."""
    if prefetch:
      return DeviceIterator(it, self._ctx.device, capacity=self._capacity,
                            transform=transform)
    if transform is not None:
      it = map(transform, it)
    return (put_batch(b, self._ctx.device) for b in it)

  # -- training --------------------------------------------------------------

  def train(self, batches: Iterable[Dict[str, Any]],
            max_steps: Optional[int] = None,
            hooks: Sequence[Hook] = (),
            sync: bool = True,
            prefetch: bool = False,
            save_checkpoint_steps: int = 0,
            eval_every_n_steps: Optional[int] = None,
            eval_batches_fn: Optional[Callable[[], Iterable]] = None
            ) -> Dict[str, float]:
    """Run the training loop over host batches; returns the last step's
    metrics as host floats (the one read of the device here).

    ``prefetch=True`` feeds the steps through ``DeviceIterator``, for a
    source that waits (a file reader); by default each batch is placed
    in the loop. Checkpoints every ``save_checkpoint_steps`` steps (0:
    only at the end) when the trainer has a ``model_dir``. ``eval_every_n_steps``
    with ``eval_batches_fn`` runs a full :meth:`evaluate` every N steps.
    """
    it: Iterator = iter(batches)
    sync_it = None
    if sync:
      it = sync_it = SyncReplicasIterator(it)
    it = self._device_batches(it, prefetch, self._host_transform)
    runner = self._cache_runner
    hooks = list(hooks)
    if isinstance(it, DeviceIterator):
      for h in hooks:
        if isinstance(h, StepStatHook):
          h.set_input_iterator(it)
    for h in hooks:
      h.begin()
    step_metrics: Dict[str, Any] = {}
    steps_done = 0
    try:
      for batch in it:
        if max_steps is not None and steps_done >= max_steps:
          break
        step_no = self.global_step
        for h in hooks:
          h.before_step(step_no)
        if runner is not None:
          self.state = runner.apply_next(self.state)
        self.state, m = self._step_fn(self.state, batch)
        step_metrics = {k: v for k, v in m.items() if k != 'preds'}
        steps_done += 1
        step_no += 1
        for h in hooks:
          h.after_step(step_no, step_metrics)
        if (self._ckpt and save_checkpoint_steps
            and step_no % save_checkpoint_steps == 0):
          if runner is not None:
            # Mid-train the producer may keep planning: write the rows
            # back under their owners in the arrays, consuming no plan.
            runner.checkpoint_flush(self.state)
          self._save(step_no)
        if (eval_every_n_steps and eval_batches_fn
            and step_no % eval_every_n_steps == 0):
          LOG.info('eval @ step %d: %s', step_no,
                   self.evaluate(eval_batches_fn()))
    finally:
      if isinstance(it, DeviceIterator):
        it.close()           # closes the sync iterator it wraps
      elif sync_it is not None:
        sync_it.close()
      if runner is not None:
        # Batches planned ahead but never stepped: apply their effects,
        # so that the slot map and the arrays agree.
        self.state = runner.drain(self.state)
      for h in hooks:
        h.end(self.global_step)
      if self._ckpt:
        if runner is not None:
          runner.flush(self.state)
        self._save(self.global_step)
    return {k: _host_mean(v) for k, v in step_metrics.items()}

  # -- evaluation ------------------------------------------------------------

  def evaluate(self, batches: Iterable[Dict[str, Any]],
               prefetch: bool = False) -> Dict[str, float]:
    """A full pass: AUC, the mean loss, the batch count, and GAUC when
    the trainer has a ``group_key``.

    Every batch carries ``_sync_valid`` weights (ones with one replica)
    and every metric takes them as example weights. The loss mean is
    exact when the loss function returns ``aux['per_example_loss']``;
    otherwise each batch's scalar loss is weighted by its valid rows, and
    the result says ``loss_exact = 0.0``.
    """
    it = self._device_batches(
        SyncReplicasIterator(iter(batches), drop_remainder=False), prefetch,
        self._eval_host_transform)
    dev = self._ctx.device
    auc_s, loss_s, gauc_s = hbm.auc_init(device=dev), hbm.mean_init(
        dev), hbm.gauc_init(dev)
    n = 0
    loss_exact = True
    try:
      for batch in it:
        labels = batch[self._label_key]
        if labels.shape[0] == 0:
          continue
        valid = batch.get(SYNC_VALID_KEY)
        loss, aux = self._eval_fn(self.params, batch)
        pel = aux.get('per_example_loss')
        if pel is None and valid is not None and loss_exact:
          loss_exact = False
          LOG.warning(
              "evaluate: the loss function returns only a scalar loss "
              "while batches carry '_sync_valid' weights; the 'loss' "
              "weights each batch's loss by its valid rows. Return "
              "aux['per_example_loss'] for an exact mean. Results include "
              "loss_exact=0.0.")
        auc_s, loss_s, gauc_s = _metrics_step(
            auc_s, loss_s, gauc_s, labels, aux['preds'], pel, loss, valid,
            None if self._group_key is None else batch[self._group_key])
        n += 1
    finally:
      if isinstance(it, DeviceIterator):
        it.close()
    out = {'auc': float(hbm.auc_result(auc_s)),
           'loss': float(hbm.mean_result(loss_s)),
           'batches': float(n)}
    if not loss_exact:
      out['loss_exact'] = 0.0
    if self._group_key is not None:
      out['gauc'] = float(hbm.gauc_result(gauc_s))
    return out

  def train_and_evaluate(self, train_batches_fn: Callable[[], Iterable],
                         eval_batches_fn: Callable[[], Iterable],
                         epochs: int = 1,
                         max_steps_per_epoch: Optional[int] = None,
                         hooks: Sequence[Hook] = ()) -> Dict[str, float]:
    """Epochs of training, each followed by a full evaluation."""
    results: Dict[str, float] = {}
    for ep in range(epochs):
      self.train(train_batches_fn(), max_steps=max_steps_per_epoch,
                 hooks=hooks)
      results = self.evaluate(eval_batches_fn())
      LOG.info('epoch %d eval: %s', ep, results)
    return results

  def predict(self, batches: Iterable[Dict[str, Any]],
              prefetch: bool = False) -> Iterator[torch.Tensor]:
    """Yield each batch's predictions, a tensor on the context's device
    (reading it is the caller's choice)."""
    it = self._device_batches(iter(batches), prefetch,
                              self._eval_host_transform)
    try:
      for batch in it:
        _, aux = self._eval_fn(self.params, batch)
        yield aux['preds']
    finally:
      if isinstance(it, DeviceIterator):
        it.close()

  # -- export ----------------------------------------------------------------

  def export_saved_model(self, path: str, example_batch,
                         id_mappers=None, poly_batch: bool = False) -> str:
    """Export the serving bundle (``training/saved_model.py``): the loss
    function's ``aux['preds']``, the module's parameters and buffers its
    inputs. Its lookups are the loss function's own (``index_select``
    unless it passes ``serving=True``). ``example_batch`` carries every
    column the loss function reads, the label too; ``poly_batch=True``
    serves any batch size from one bundle; ``id_mappers`` (``{column:
    IdMapper}``) bundles the maps that ``Served`` applies to raw ids."""
    loss_fn = self._loss_fn
    module = self.state.params

    def serving_fn(leaves, batch):
      return _call_with(module, leaves,
                        lambda m, b: loss_fn(m, b)[1]['preds'], batch)

    return export(serving_fn, _leaves(module), example_batch, path,
                  id_mappers=id_mappers, poly_batch=poly_batch)


class SparseTrainer(Trainer):
  """A trainer whose tables update on the rows a batch touched, through
  ``make_sparse_train_step`` and the port's Hopper update kernels: no
  dense ``[V, d]`` gradient. Same lifecycle as :class:`Trainer`.

  Args:
    fx: the ``StackedFeatureExtractor`` declaring the tables; its context
      is the trainer's.
    model_loss: ``(tower, emb_features, dense_features, batch) -> (loss,
      aux)``.
    dense: the tower, moved to the context's device.
    raw_model_loss: ``(tower, members {name: [B, ..., D]}, batch) ->
      (loss, aux)``, on each member table's uncombined embeddings (for
      sequence models such as DIN); when it is given, ``model_loss`` is
      not used (pass ``None``). Training, evaluation, prediction and the
      exported bundle all run it.
    tables: the stacked tables; by default ``fx.init(generator)``.
    dense_optimizer: builds the tower's optimizer from its parameters;
      by default Adam 1e-3 (``optax.adam(1e-3)``).
    table_lr, adagrad_init, table_optimizer: the table update, row-sparse
      ``'adagrad'`` (accumulators from ``adagrad_init``) or ``'adam'``
      (LazyAdam), at ``table_lr``.
    generator: draws the default tables (seed 0 when None, the JAX
      ``PRNGKey(0)``).
    caches: ``{column: EmbeddingCache}``, host-backed tables: each
      column's fx table is declared with ``cache.slot_config()``, and the
      cache's host tables are ``'value'`` and one ``'slot{i}'`` per table
      optimizer slot (``slot0`` for Adagrad; ``slot0``, ``slot1`` for
      LazyAdam). The column's ids are mapped to cache slots on the host
      every batch, and the cache's evictions and uploads are applied in
      place to the live stacked table and its slots in step order (the
      reference's EmbeddingService hooks, ``service.py:253-324``). The
      resident rows are written back to storage at every checkpoint; with
      no ``model_dir``, call ``_cache_runner.flush(state)`` after
      training, as with the JAX trainer.
  The other arguments are :class:`Trainer`'s.
  """

  def __init__(self, fx: StackedFeatureExtractor, model_loss: Callable,
               dense: nn.Module,
               tables: Optional[Dict[str, torch.Tensor]] = None,
               dense_optimizer: Optional[OptimizerFactory] = None,
               table_lr: float = 0.05, adagrad_init: float = 0.1,
               table_optimizer: str = 'adagrad',
               model_dir: Optional[str] = None, *,
               raw_model_loss: Optional[RawModelLoss] = None,
               label_key: str = 'label', group_key: Optional[str] = None,
               generator: Optional[torch.Generator] = None,
               keep_checkpoint_max: int = 5, grow_vocab: bool = False,
               prefetch_capacity: int = 2,
               caches: Optional[Dict[str, EmbeddingCache]] = None):
    ctx = fx.ctx
    if ctx.world_size > 1:
      raise NotImplementedError('SparseTrainer in a world of more than one '
                                'rank is ROADMAP item 15b (5); the sparse '
                                'step runs there (make_sparse_train_step)')
    self._caches = dict(caches) if caches else {}
    if self._caches:
      nslots = 2 if table_optimizer == 'adam' else 1
      want = {'value'} | {f'slot{i}' for i in range(nslots)}
      for col, cache in self._caches.items():
        have = set(cache.device)
        if have != want:
          raise ValueError(
              f'cache for column {col!r} has tables {sorted(have)}; '
              f'{table_optimizer} needs exactly {sorted(want)}')
      self._cache_runner = CacheRunner(self._caches, fx)
      self._host_transform = self._cache_runner.transform
      self._eval_host_transform = self._cache_runner.eval_transform
    dense.to(ctx.device)
    if dense_optimizer is None:
      dense_optimizer = functools.partial(torch.optim.Adam, lr=1e-3)
    if tables is None:
      tables = fx.init(generator if generator is not None
                       else torch.Generator().manual_seed(0))
    self.state = SparseTrainState.create(
        dense, tables, dense_optimizer, adagrad_init,
        adam=table_optimizer == 'adam')
    init_state(self.state.dense_opt)
    self._fx = fx
    self._model_loss = model_loss
    self._raw_model_loss = raw_model_loss
    self._step_fn = make_sparse_train_step(
        fx, model_loss, table_lr, table_optimizer=table_optimizer,
        raw_model_loss=raw_model_loss)
    loss_of = loss_from_raw(fx, model_loss, raw_model_loss)

    def eval_fn(params, batch):
      tower, tables = params
      raw, _, layouts = fx.lookup_raw(tables, batch)
      return loss_of(tower, raw, layouts, batch)

    self._eval_fn = make_eval_step(eval_fn)
    self._setup(ctx, label_key, group_key, prefetch_capacity, model_dir,
                keep_checkpoint_max, grow_vocab)

  def _checkpoint_state(self) -> Dict[str, Any]:
    s = self.state
    return {'step': s.step, 'dense': s.dense.state_dict(),
            'dense_opt': slots_by_name(s.dense_opt, s.dense),
            'tables': dict(s.tables),
            'table_opt': {name: list(opt.acc)
                          for name, opt in s.table_opt.items()}}

  def _load_checkpoint_state(self, restored: Dict[str, Any]) -> None:
    s = self.state
    s.dense.load_state_dict(restored['dense'])
    load_slots_by_name(s.dense_opt, s.dense, restored['dense_opt'])
    with torch.no_grad():
      for name, table in restored['tables'].items():
        s.tables[name].copy_(table)
      for name, slots in restored['table_opt'].items():
        for live, value in zip(s.table_opt[name].acc, slots):
          live.copy_(value)
    s.step = restored['step']

  @property
  def params(self):
    return (self.state.dense, self.state.tables)

  def export_saved_model(self, path: str, example_batch,
                         id_mappers=None, table_dtype: str = 'float32',
                         poly_batch: bool = False) -> str:
    """Export a standalone serving bundle (``training/saved_model.py``):
    each stack is split back into its member tables, and the served
    function runs ``extract_features`` over them, every member lookup
    through kernel 5 (``serving=True``), then ``model_loss``'s
    ``aux['preds']``; in raw mode it looks each member table up on its
    column (``lookup(..., serving=True)``, kernel 5) and returns
    ``raw_model_loss``'s ``aux['preds']``. Its inputs are the tower's
    parameters and buffers and the member tables.

    ``table_dtype='int8'`` quantizes every member table per row
    (``embedding/quant.py``), about a quarter of the table bytes; the
    tower stays float. ``example_batch`` carries every column
    ``model_loss`` reads, the label too, with raw ids in a cached or
    dynamic column; ``poly_batch=True`` serves any batch size from one
    bundle. ``id_mappers`` (``{column: IdMapper}``) bundles the maps of
    dynamic tables, which ``Served`` applies read-only to those columns.

    A cache-backed column serves from its full host table, written back
    first (``checkpoint_flush``, which consumes no pending plan), as one
    member of the cache's ``config.vocab_size`` rows: a cold process
    serves it with no cache and no slot map."""
    if table_dtype not in ('float32', 'int8'):
      raise ValueError(f'table_dtype must be float32 or int8, got '
                       f'{table_dtype!r}')
    if self._cache_runner is not None:
      self._cache_runner.checkpoint_flush(self.state)
    tables: Dict[str, Any] = {}
    for stack in self._fx.stacks:
      tables.update(member_tables(stack, self.state.tables[
          stack.stacked.name]))
    # A stack addresses its members at offset + raw id (a member's
    # shuffle_ids is not applied inside a stack), so each extracted slice
    # serves with the identity row mapping.
    specs = []
    for s in self._fx.specs:
      cache = self._caches.get(s.key)
      if cache is None:
        specs.append(EmbeddingSpec(
            dataclasses.replace(s.config, shuffle_ids=False),
            column=s.column))
        continue
      vocab = cache.config.vocab_size
      tables[s.name] = torch.from_numpy(np.ascontiguousarray(
          cache.storage.pull('value', np.arange(vocab, dtype=np.int64))))
      specs.append(EmbeddingSpec(
          dataclasses.replace(cache.config, shuffle_ids=False),
          column=s.key))
    if table_dtype == 'int8':
      tables = {name: quantize_table(t) for name, t in tables.items()}
    dense_columns = list(self._fx.dense_columns)
    tower, model_loss = self.state.dense, self._model_loss
    raw_loss = self._raw_model_loss

    def serving_fn(params, batch):
      tower_leaves, member = params
      if raw_loss is not None:
        members = {s.name: lookup(member[s.name], batch[s.key], s.config,
                                  serving=True) for s in specs}
        return _call_with(tower, tower_leaves,
                          lambda t, *a: raw_loss(t, *a)[1]['preds'],
                          members, batch)
      emb_f, dense_f = extract_features(member, batch, specs, dense_columns,
                                        serving=True)
      return _call_with(tower, tower_leaves,
                        lambda t, *a: model_loss(t, *a)[1]['preds'], emb_f,
                        dense_f, batch)

    return export(serving_fn, (_leaves(tower), tables), example_batch, path,
                  id_mappers=id_mappers, poly_batch=poly_batch)


__all__ = ['SparseTrainer', 'Trainer']
