"""The trainers: train, evaluate, predict, checkpoint and resume.

Counterpart of ``hybridbackend_tpu/estimator/__init__.py:39-597``
(``Trainer`` and ``SparseTrainer``), at a world of one rank or of N. A trainer
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
served from their full host tables.

With a ``model_dir`` a trainer writes TensorBoard summaries there (JAX
``:77,119-128,200-205,324-328``), through the port's event writer
(``utils/summary.py``, opened at first use): ``train`` adds a
``SummaryHook`` that writes the train metrics under ``train/`` every
``summary_steps`` steps (100 by default, the JAX option's; 0 writes
none), and ``evaluate`` writes its results under ``eval/`` at the global
step.

In a world of N ranks (the trainer's context: ``ctx`` of ``Trainer``,
``fx.ctx`` of ``SparseTrainer``, joined by ``Context.join`` in each
process that ``python -m hybridbackend_tpu_torch.run`` starts) each rank
trains on its own batches, its rows of the global batch:

* ``SparseTrainer``'s stacks are sharded (by rows, or by columns with
  ``partition='column'``) and updated on the owners' shards by the
  update kernels (``make_sparse_train_step``), looked up through its
  ``lookup_strategy``; ``Trainer`` is data-parallel, its sharded tables
  (``init_tables(..., ctx=ctx)``) taking their dense gradients through
  the sharded lookup's backward (``training/train.py``), by the strategy
  its loss function passes ``extract_features``. The towers start
  equal: rank 0's are broadcast.
* ``train`` and ``evaluate`` agree on stopping through
  ``SyncReplicasIterator``: training stops on every rank when any rank
  runs out, evaluation goes on until all have, on padded batches whose
  ``_sync_valid`` weights keep the metrics exact. The AUC histograms and
  the loss sums are all-reduced once, at the end of ``evaluate``; GAUC
  is computed on each eval batch gathered over the ranks in rank order,
  the global batch JAX computes it on (a group may span ranks). Every
  rank returns the same dict.
* A checkpoint is written by every rank, each its own rows (or columns)
  of each sharded table and slot, rank 0 the replicated leaves
  (``training/checkpoint.py``); it restores at any world (of a column
  shard, any world that divides its dim).
* ``export_saved_model`` is called by every rank: the shards are gathered
  (a column shard's along the dim) and rank 0 alone writes the bundle,
  the unsharded one ``Served`` loads (JAX ``:362-375,513-533``).
* Rank 0 alone logs, its hooks alone report (``training/hooks.py``), and
  it alone writes the summaries.
* Host-backed tables (``SparseTrainer(caches=...)``) keep one slot map
  over the world, the same on every rank: each batch's cached ids are
  exchanged and planned as the world's batch, the cache's rows live on
  their owners' shards, and every rank's storage receives every evicted
  and flushed row (``embedding/service.py``). A checkpoint flushes on
  every rank before it saves the shards; the export writes the bundle
  from rank 0's storage, which holds every row.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import logging
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch import metrics as hbm
from hybridbackend_tpu_torch.data.prefetch import DeviceIterator, put_batch
from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.data.sync import (
    SYNC_VALID_KEY, SyncReplicasIterator)
from hybridbackend_tpu_torch.embedding.lookup import lookup
from hybridbackend_tpu_torch.embedding.quant import quantize_table
from hybridbackend_tpu_torch.embedding.service import (
    CacheRunner, EmbeddingCache)
from hybridbackend_tpu_torch.embedding.stack import (
    logical_segments, member_tables)
from hybridbackend_tpu_torch.embedding.table import shard_of, table_shard
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.models.feature import (
    EmbeddingSpec, StackedFeatureExtractor, extract_features)
from hybridbackend_tpu_torch.training.checkpoint import (
    CheckpointManager, Shard)
from hybridbackend_tpu_torch.training.hooks import (
    Hook, StepStatHook, SummaryHook, _host_float)
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
    gauc_s = _gauc_step(gauc_s, labels, preds, valid, ind)
  return auc_s, loss_s, gauc_s


def _gauc_step(gauc_s, labels, preds, valid, ind):
  """One batch's GAUC update; ``valid`` may be None."""
  if valid is not None:
    # Padding rows must not join a real group: give them an indicator
    # below every real one. Their labels are 0, so their group has one
    # class and is skipped. Signed, so the sentinel cannot wrap.
    ind = ind.to(torch.int64)
    ind = torch.where(valid > 0, ind, ind.min() - 1)
  # Eval batches need not hold each group in one run: sort them.
  return hbm.gauc_update(gauc_s, labels, preds, ind, sort_groups=True)


def _whole(t: torch.Tensor, shard, ctx: Context) -> torch.Tensor:
  """The whole table of a shard (a collective): the ranks' rows joined,
  or a column shard's columns."""
  return collective.allgather(t, ctx=ctx, axis=1 if shard.by_column else 0)


def _gathered(ctx: Context, *tensors: torch.Tensor):
  """Each tensor's rows of every rank, in rank order (a collective)."""
  return [collective.allgather(t.reshape(t.shape[0], -1), ctx=ctx).reshape(
      -1, *t.shape[1:]) for t in tensors]


def _all_summed(ctx: Context, *states):
  """Metric states (named tuples of tensors) summed over the ranks, in
  one all-reduce."""
  parts = [t for s in states for t in s]
  flat = collective.allreduce(torch.cat([t.reshape(-1) for t in parts]),
                              ctx=ctx)
  out, pos = [], 0
  for t in parts:
    out.append(flat[pos:pos + t.numel()].view_as(t))
    pos += t.numel()
  it = iter(out)
  return [type(s)(*(next(it) for _ in s)) for s in states]


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
    model_dir: checkpoint and summary directory; its latest checkpoint is
      restored now. ``None`` keeps no checkpoints and writes no
      summaries.
    ctx: the device everything runs on, and the world: in a world of
      more than one rank (a joined context) the trainer is data-parallel,
      each rank feeding its own rows of the global batch (see the module
      docstring); the tables are then made with ``init_tables(...,
      ctx=ctx)`` and looked up with ``extract_features(..., ctx=ctx)``.
    label_key, group_key: the label column, and the column of group ids
      for GAUC (no GAUC when None).
    keep_checkpoint_max, grow_vocab: the checkpoint manager's
      ``max_to_keep`` and ``grow_vocab``.
    prefetch_capacity: batches ``DeviceIterator`` stages ahead (with
      ``prefetch=True``).
    gradient_wire_dtype: the dtype of the gradients' all-reduce in a
      world (``make_train_step``).
    summary_steps: with a ``model_dir``, ``train`` writes the train
      metrics as summaries every this many steps (0: never; JAX's
      ``summary_steps`` option). ``evaluate`` writes its results whatever
      it is.
  """

  _host_transform: Optional[Callable] = None
  _eval_host_transform: Optional[Callable] = None
  _cache_runner = None
  _summary = None

  def __init__(self, loss_fn: Callable, params: nn.Module,
               optimizer=None, model_dir: Optional[str] = None, *,
               ctx: Context, label_key: str = 'label',
               group_key: Optional[str] = None,
               keep_checkpoint_max: int = 5, grow_vocab: bool = False,
               prefetch_capacity: int = 2, gradient_wire_dtype=None,
               summary_steps: int = 100):
    for name, p in params.named_parameters():
      if p.device != ctx.device:
        raise ValueError(f'parameter {name} is on {p.device}, the context '
                         f'on {ctx.device}')
    if optimizer is None:
      optimizer = Adagrad(params.parameters(), lr=0.1)
    self.state = TrainState.create(params, optimizer, ctx)
    self._loss_fn = loss_fn
    self._step_fn = make_train_step(loss_fn, gradient_wire_dtype, ctx)
    self._eval_fn = make_eval_step(loss_fn)
    self._setup(ctx, label_key, group_key, prefetch_capacity, model_dir,
                keep_checkpoint_max, grow_vocab, summary_steps)

  def _setup(self, ctx, label_key, group_key, prefetch_capacity, model_dir,
             keep_checkpoint_max, grow_vocab, summary_steps) -> None:
    self._ctx = ctx
    self._model_dir = model_dir
    self._summary_steps = summary_steps
    self._label_key = label_key
    self._group_key = group_key
    self._capacity = prefetch_capacity
    self._ckpt: Optional[CheckpointManager] = None
    if model_dir:
      self._ckpt = CheckpointManager(model_dir, keep_checkpoint_max,
                                     device=ctx.device,
                                     grow_vocab=grow_vocab, ctx=ctx)
      template = self._checkpoint_state()
      restored = self._ckpt.restore(template)
      if restored is not template:
        self._load_checkpoint_state(restored)
        self._log('restored checkpoint at step %d', self.global_step)

  @property
  def _world(self) -> int:
    return self._ctx.world_size

  def _log(self, *args) -> None:
    if self._ctx.is_chief:
      LOG.info(*args)

  def _summary_writer(self):
    """The event writer into ``model_dir``, opened at first use; None
    without a ``model_dir`` and on every rank but rank 0."""
    if not self._model_dir or not self._ctx.is_chief:
      return None
    if self._summary is None:
      from hybridbackend_tpu_torch.utils.summary import SummaryWriter
      self._summary = SummaryWriter(self._model_dir)
    return self._summary

  # -- state -----------------------------------------------------------------

  def _checkpoint_state(self) -> Dict[str, Any]:
    """The state to save: a sharded table's parameter, and each of its
    optimizer slots of its shape, as a :class:`Shard`."""
    params = self.state.params
    shards = {n: (p.shape, table_shard(p))
              for n, p in params.named_parameters()}

    def leaf(name, t):
      shape, shard = shards.get(name, (None, None))
      if shard is None or t.shape != shape:
        return t
      return Shard.of_rows(t, shard.start, shard.rows, shard.col, shard.dim)

    return {'step': self.state.step,
            'params': {k: leaf(k, v) for k, v in params.state_dict().items()},
            'opt_state': {
                name: {slot: leaf(name, v) for slot, v in slots.items()}
                for name, slots in slots_by_name(self.state.optimizer,
                                                 params).items()}}

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
                            transform=transform, world_size=self._world)
    if transform is not None:
      it = map(transform, it)
    return (put_batch(b, self._ctx.device, self._world) for b in it)

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
    In a world, ``batches`` are this rank's, and every rank stops when
    any runs out (``sync=False`` leaves that, and equal row counts, to
    the caller; with host-backed tables also that every rank maps the
    same batches). A trainer in a world reads no batch past
    ``max_steps``: the ranks then end together, through the sync
    iterator's final exchange, and not by a break after a batch whose
    exchange a peer may still be reading (nor with a producer thread's
    read-ahead planning other batches on one rank than on another).
    """
    it: Iterator = iter(batches)
    if self._world > 1 and max_steps is not None:
      it = itertools.islice(it, max_steps)
    runner = self._cache_runner
    if runner is not None:
      runner.open()
    sync_it = None
    if sync:
      it = sync_it = SyncReplicasIterator(it, ctx=self._ctx)
    it = self._device_batches(it, prefetch, self._host_transform)
    hooks = list(hooks)
    if isinstance(it, DeviceIterator):
      for h in hooks:
        if isinstance(h, StepStatHook):
          h.set_input_iterator(it)
    writer = self._summary_writer() if self._summary_steps else None
    if writer is not None:
      hooks.append(SummaryHook(writer, every_n_steps=self._summary_steps))
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
          self._log('eval @ step %d: %s', step_no,
                    self.evaluate(eval_batches_fn()))
    finally:
      if runner is not None:
        runner.cancel()      # a producer waiting for a peer's ids
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
    return {k: _host_float(v) for k, v in step_metrics.items()}

  # -- evaluation ------------------------------------------------------------

  def evaluate(self, batches: Iterable[Dict[str, Any]],
               prefetch: bool = False) -> Dict[str, float]:
    """A full pass: AUC, the mean loss, the batch count, and GAUC when
    the trainer has a ``group_key``.

    Every batch carries ``_sync_valid`` weights (ones with one replica)
    and every metric takes them as example weights. The loss mean is
    exact when the loss function returns ``aux['per_example_loss']``;
    otherwise each batch's scalar loss is weighted by its valid rows, and
    the result says ``loss_exact = 0.0``. In a world, ``batches`` are this
    rank's; the metrics are those of every rank's rows, and every rank
    returns them.
    """
    ctx = self._ctx
    it = self._device_batches(
        SyncReplicasIterator(iter(batches), drop_remainder=False, ctx=ctx),
        prefetch, self._eval_host_transform)
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
        ind = None if self._group_key is None else batch[self._group_key]
        if self._world > 1 and ind is not None:
          # GAUC on the global batch, as JAX computes it: a group may
          # span ranks.
          gauc_s = _gauc_step(gauc_s, *_gathered(
              ctx, labels, aux['preds'], valid, ind))
          ind = None
        auc_s, loss_s, gauc_s = _metrics_step(
            auc_s, loss_s, gauc_s, labels, aux['preds'], pel, loss, valid,
            ind)
        n += 1
    finally:
      if isinstance(it, DeviceIterator):
        it.close()
    if self._world > 1:
      auc_s, loss_s = _all_summed(ctx, auc_s, loss_s)
    out = {'auc': float(hbm.auc_result(auc_s)),
           'loss': float(hbm.mean_result(loss_s)),
           'batches': float(n)}
    if not loss_exact:
      out['loss_exact'] = 0.0
    if self._group_key is not None:
      out['gauc'] = float(hbm.gauc_result(gauc_s))
    writer = self._summary_writer()
    if writer is not None:
      writer.scalars(self.global_step, {'eval/' + k: v for k, v in out.items()
                                        if k != 'batches'})
      writer.flush()
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
      self._log('epoch %d eval: %s', ep, results)
    return results

  def predict(self, batches: Iterable[Dict[str, Any]],
              prefetch: bool = False) -> Iterator[torch.Tensor]:
    """Yield each batch's predictions, a tensor on the context's device
    (reading it is the caller's choice).

    In a world, every rank calls this with its own batches and yields the
    predictions of its own rows, batch by batch. The lookups are
    collectives, so the ranks step together through
    ``SyncReplicasIterator``'s eval mode: a rank whose batches run out
    first, or are shorter, steps on padding, which it does not yield."""
    it: Iterator = iter(batches)
    rows: collections.deque = collections.deque()
    if self._world > 1:
      def counted(synced):
        for b in synced:
          # Counted on the host, in batch order (the producer thread's,
          # with prefetch), so nothing reads the device.
          rows.append(int(np.asarray(b[SYNC_VALID_KEY]).sum()))
          yield b
      it = counted(SyncReplicasIterator(it, drop_remainder=False,
                                        ctx=self._ctx))
    it = self._device_batches(it, prefetch, self._eval_host_transform)
    try:
      for batch in it:
        _, aux = self._eval_fn(self.params, batch)
        if self._world == 1:
          yield aux['preds']
          continue
        n = rows.popleft()
        if n:
          yield aux['preds'][:n]
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
    IdMapper}``) bundles the maps that ``Served`` applies to raw ids.

    In a world, every rank must call this: each sharded table is
    gathered whole (a collective), a whole table is looked up locally
    (``embedding/lookup.py``), and rank 0 alone writes the bundle."""
    loss_fn = self._loss_fn
    module = self.state.params
    leaves = _leaves(module)
    if self._world > 1:
      leaves = {k: (_whole(v.detach(), table_shard(v), self._ctx)
                    if table_shard(v) is not None else v)
                for k, v in leaves.items()}
      if not self._ctx.is_chief:
        return path

    def serving_fn(leaves, batch):
      return _call_with(module, leaves,
                        lambda m, b: loss_fn(m, b)[1]['preds'], batch)

    return export(serving_fn, leaves, example_batch, path,
                  id_mappers=id_mappers, poly_batch=poly_batch)


class SparseTrainer(Trainer):
  """A trainer whose tables update on the rows a batch touched, through
  ``make_sparse_train_step`` and the port's Hopper update kernels: no
  dense ``[V, d]`` gradient. Same lifecycle as :class:`Trainer`.

  Args:
    fx: the ``StackedFeatureExtractor`` declaring the tables; its context
      is the trainer's, and its world the trainer's world (``tables``
      are then each rank's shards, as ``fx.init`` makes them).
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
    lookup_strategy: the row-sharded stacks' exchange in a world, for
      the train steps, evaluation and prediction (``lookup.STRATEGIES``;
      the JAX option ``emb_lookup_strategy``).
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
      training, as with the JAX trainer. In a world, every rank declares
      the same caches over the same host tables, with the world's
      context; each cache must hold the distinct ids of the world's
      batch (see ``embedding/service.py``).
    step_options: more keywords of ``make_sparse_train_step`` (the
      exchange options and wire dtypes of a world, such as
      ``wire_dtype``, ``gradient_wire_dtype``, ``lookup_bucket_ratio``,
      ``update_bucket_ratio``, ``unique_ratio``), the JAX options the
      JAX trainer reads.
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
               caches: Optional[Dict[str, EmbeddingCache]] = None,
               lookup_strategy: str = 'allgather',
               step_options: Optional[Dict[str, Any]] = None,
               summary_steps: int = 100):
    ctx = fx.ctx
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
        adam=table_optimizer == 'adam', ctx=ctx)
    init_state(self.state.dense_opt)
    self._fx = fx
    self._model_loss = model_loss
    self._raw_model_loss = raw_model_loss
    self._step_fn = make_sparse_train_step(
        fx, model_loss, table_lr, table_optimizer=table_optimizer,
        raw_model_loss=raw_model_loss, lookup_strategy=lookup_strategy,
        **(step_options or {}))
    loss_of = loss_from_raw(fx, model_loss, raw_model_loss)

    def eval_fn(params, batch):
      tower, tables = params
      raw, _, layouts = fx.lookup_raw(tables, batch, lookup_strategy)
      return loss_of(tower, raw, layouts, batch)

    self._eval_fn = make_eval_step(eval_fn)
    self._setup(ctx, label_key, group_key, prefetch_capacity, model_dir,
                keep_checkpoint_max, grow_vocab, summary_steps)

  def _checkpoint_state(self) -> Dict[str, Any]:
    """The state to save: a sharded stack's table and slots as
    :class:`Shard` leaves (of a column-sharded stack, with its
    columns)."""
    s = self.state
    shards = {}
    for st in self._fx.stacks:
      shard = shard_of(st.stacked, self._ctx)
      if shard is not None:
        shards[st.stacked.name] = (*logical_segments(st, self._ctx),
                                   shard.col, shard.dim)

    def leaf(name, t):
      return Shard(t, *shards[name]) if name in shards else t

    return {'step': s.step, 'dense': s.dense.state_dict(),
            'dense_opt': slots_by_name(s.dense_opt, s.dense),
            'tables': {name: leaf(name, t) for name, t in s.tables.items()},
            'table_opt': {name: [leaf(name, a) for a in opt.acc]
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

    In a world, every rank must call this: each sharded stack is gathered
    whole (a collective; a column-sharded one along the dim) and split
    into its members' rows, and rank 0
    alone writes the bundle, the one a world of one writes (``int8``
    quantized after the gather).

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
      table = self.state.tables[stack.stacked.name]
      shard = shard_of(stack.stacked, self._ctx)
      if shard is not None:
        table = _whole(table, shard, self._ctx)
      members = member_tables(stack, table)
      # A member's rows, without those a world pads it with.
      tables.update({cfg.name: members[cfg.name][:cfg.vocab_size]
                     for cfg in stack.configs})
    if not self._ctx.is_chief:
      return path
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
