"""A stock ``torch.nn.Module`` tower trained over the port's tables.

Counterpart of ``hybridbackend_tpu/flax_support.py:47-203``, which wraps
a stock flax module as the reference wraps a ``tf.keras.Model``
(``keras/model.py:462-850``). The port has no flax: the adapter wraps a
``torch.nn.Module`` (for example an ``nn.Sequential`` of ``nn.Linear``
layers) and feeds it from embedding tables that the port declares,
stacks, looks up and (in a world of ranks) shards, with the Keras-like
lifecycle over the dense ``Trainer``: ``compile``, ``fit``, ``evaluate``,
``predict``, ``save_weights``, ``load_weights`` and
``export_saved_model``.

Three input conventions (``inputs=``), as in JAX (``:73-96``):

* ``'concat'``: the module takes one ``[B, F]`` float32 tensor, every
  embedding feature and then every dense feature, joined in spec order;
* ``'features'``: the module takes ``(emb {name: [B, D]}, dense {column:
  [B, 1]})``;
* ``'raw'``: the module takes ``(members {name: [B, ..., D]}, batch)``,
  each member table's uncombined embeddings in its id column's shape
  (a sequence column keeps its ``[B, L, D]``, its mask in
  ``batch[column + '_mask']``), for attention models such as DIN.

::

    tower = nn.Sequential(nn.LazyLinear(32), nn.ReLU(), nn.Linear(32, 1),
                          nn.Sigmoid(), nn.Flatten(0))
    wrapped = wraps_module(tower, specs, dense_columns=['i0'],
                           ctx=Context('cuda'))
    params = wrapped.init(torch.Generator().manual_seed(0), example_batch)
    wrapped.compile(params, model_dir='/tmp/m')   # Adagrad 0.1 on all
    wrapped.fit(train_batches, max_steps=1000)
    wrapped.evaluate(eval_batches)
    wrapped.save_weights('/tmp/w')
    wrapped.export_saved_model('/tmp/bundle', example_batch)

Training and ``predict`` look the stacked tables up with ``index_select``
(the sharded lookup's exchange in a world); the lookup's backward gives
the dense ``Trainer`` its table gradients through kernel 4
(``dense_row_totals``, once a stack a step: each row's gradients summed
in list order, the same bits on every call). The exported bundle
serves every column through kernel 5 instead (``lookup(...,
serving=True)``, ``ops/gather.py``), on the member tables split out of
the stacks, as ``SparseTrainer.export_saved_model`` serves them.

In a world of N ranks (a joined ``ctx``) the stacks that the shard policy
shards are row-sharded over the ranks, each rank's tower is a replica, and
the trainer is data-parallel (``Trainer``): each rank feeds its own rows
of the global batch, as JAX's ``test_trains_hybrid_parallel`` trains on
its mesh. Checkpoints and ``save_weights`` store each stack by its
members' logical rows (``stack.logical_segments``), so they restore at
any world; the export gathers the shards and rank 0 writes the bundle.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch
from torch import nn

from hybridbackend_tpu_torch.data.prefetch import put_batch
from hybridbackend_tpu_torch.data.sync import SYNC_VALID_KEY
from hybridbackend_tpu_torch.embedding.lookup import lookup
from hybridbackend_tpu_torch.embedding.stack import (
    logical_segments, member_tables)
from hybridbackend_tpu_torch.embedding.table import mark_shard, shard_of
from hybridbackend_tpu_torch.estimator import (
    Trainer, _call_with, _leaves, _whole)
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.models.feature import (
    EmbeddingSpec, StackedFeatureExtractor, extract_features)
from hybridbackend_tpu_torch.training.checkpoint import (
    CheckpointManager, Shard)
from hybridbackend_tpu_torch.training.saved_model import export

INPUTS = ('concat', 'features', 'raw')


def binary_cross_entropy(preds: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
  """The mean binary cross-entropy of clipped predictions (JAX
  ``:56-59``)."""
  preds = torch.clamp(preds, 1e-6, 1 - 1e-6)
  return -torch.mean(labels * torch.log(preds)
                     + (1 - labels) * torch.log(1 - preds))


def _to(tree: Any, device: torch.device) -> Any:
  """``tree`` (tensors in tuples and dicts) on ``device``."""
  if isinstance(tree, torch.Tensor):
    return tree.to(device)
  if isinstance(tree, dict):
    return {k: _to(v, device) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_to(v, device) for v in tree)
  return tree


class _ModuleTrainer(Trainer):
  """The dense ``Trainer`` whose checkpoints store each sharded stack by
  its members' logical rows, as ``SparseTrainer``'s do: a world pads
  every sharded member to the world, so a stack's rows differ between
  worlds, and the logical rows restore at any world."""

  def __init__(self, fx: StackedFeatureExtractor, *args, **kwargs):
    self._fx = fx
    super().__init__(*args, **kwargs)

  def _checkpoint_state(self) -> Dict[str, Any]:
    state = super()._checkpoint_state()
    for stack in self._fx.stacks:
      shard = shard_of(stack.stacked, self._ctx)
      if shard is None:
        continue
      key = f'tables.{stack.stacked.name}'
      where = (*logical_segments(stack, self._ctx), shard.col, shard.dim)
      state['params'][key] = Shard(state['params'][key].value, *where)
      state['opt_state'][key] = {
          slot: Shard(v.value, *where) if isinstance(v, Shard) else v
          for slot, v in state['opt_state'][key].items()}
    return state


@dataclasses.dataclass(eq=False)
class WrappedModel:
  """A tower module and its embedding specs in the trainer's contract,
  with a Keras-like lifecycle (JAX ``WrappedFlaxModel``).

  Attributes:
    module: the tower, an ``nn.Module`` taking the inputs of ``inputs``.
    extractor: the ``StackedFeatureExtractor`` declaring the tables; its
      context is the model's device and world.
    label_key: the label column.
    loss: ``(preds, labels) -> scalar``; with the default
      :func:`binary_cross_entropy`, ``loss_fn`` weights each example by
      ``_sync_valid`` and returns ``aux['per_example_loss']`` (an exact
      eval loss over a world's padded batches).
    inputs: one of :data:`INPUTS`.
    lookup_strategy: the sharded stacks' exchange in a world
      (``lookup.STRATEGIES``), for training, evaluation and prediction.
  """
  module: nn.Module
  extractor: StackedFeatureExtractor
  label_key: str = 'label'
  loss: Callable[[torch.Tensor, torch.Tensor],
                 torch.Tensor] = binary_cross_entropy
  inputs: str = 'concat'
  lookup_strategy: str = 'allgather'
  _trainer: Optional[Trainer] = dataclasses.field(default=None, repr=False)

  def __post_init__(self):
    if self.inputs not in INPUTS:
      raise ValueError(f'Unknown inputs convention: {self.inputs!r}; '
                       f'expected one of {INPUTS}')

  # -- the module's inputs ---------------------------------------------------

  def _module_inputs(self, tables, batch) -> tuple:
    """The module's arguments from the stacked tables (training,
    evaluation, prediction)."""
    fx = self.extractor
    raw, _, layouts = fx.lookup_raw(tables, batch, self.lookup_strategy)
    if self.inputs == 'raw':
      return (fx.members_from_raw(raw, layouts), batch)
    return self._combined(*fx.combine_from_raw(raw, layouts, batch))

  def _served_inputs(self, members, batch, specs) -> tuple:
    """The module's arguments from the member tables, every column looked
    up through kernel 5 (the exported serving function)."""
    if self.inputs == 'raw':
      return ({s.name: lookup(members[s.name], batch[s.key], s.config,
                              serving=True) for s in specs}, batch)
    return self._combined(*extract_features(
        members, batch, specs, self.extractor.dense_columns, serving=True))

  def _combined(self, emb, dense) -> tuple:
    if self.inputs == 'concat':
      return (torch.cat([f.to(torch.float32) for f in emb + dense], -1),)
    fx = self.extractor
    return ({s.name: e for s, e in zip(fx.specs, emb)},
            dict(zip(fx.dense_columns, dense)))

  def init(self, generator: torch.Generator,
           example_batch: Dict[str, Any]) -> nn.Module:
    """The parameters: one ``nn.Module`` with the stacked tables under
    ``tables`` (a ``ParameterDict`` keyed by stack name, drawn from
    ``generator`` on the context's device; in a world, this rank's shard
    of a sharded stack, marked with its ``TableShard``) and the tower
    under ``net``.

    The tower is run once on the CPU on ``example_batch``'s inputs, which
    shapes any lazy module (``nn.LazyLinear``), and every submodule with
    a ``reset_parameters`` is then reset from a seed drawn from
    ``generator`` (under ``torch.random.fork_rng``: the global generator
    is left as it was), so that the weights are the generator's on every
    device and in every rank. A tower parameter of a module without
    ``reset_parameters`` keeps the value it was made with."""
    fx = self.extractor
    device = fx.ctx.device
    configs = {s.stacked.name: s.stacked for s in fx.stacks}
    tables = nn.ParameterDict({
        name: mark_shard(nn.Parameter(t), shard_of(configs[name], fx.ctx))
        for name, t in fx.init(generator).items()})
    batch = put_batch(example_batch, device)
    with torch.no_grad():
      inputs = _to(self._module_inputs(tables, batch), torch.device('cpu'))
      net = self.module.cpu()
      net(*inputs)
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    with torch.random.fork_rng(devices=[]):
      torch.manual_seed(seed)
      for m in net.modules():
        if hasattr(m, 'reset_parameters'):
          m.reset_parameters()
    return nn.ModuleDict({'tables': tables, 'net': net.to(device)})

  def apply(self, params: nn.Module, batch: Dict[str, Any]) -> torch.Tensor:
    """The module's output (the predictions) on ``batch``."""
    return params['net'](*self._module_inputs(params['tables'], batch))

  def loss_fn(self, params: nn.Module, batch: Dict[str, Any]):
    """``(loss, aux)`` for the trainer, ``aux['preds']`` the predictions
    (JAX ``:110-131``): the mean BCE, or over a batch with ``_sync_valid``
    weights the weighted mean, with ``aux['per_example_loss']``; a custom
    ``loss`` as it is."""
    preds = self.apply(params, batch)
    labels = batch[self.label_key]
    aux = {'preds': preds}
    if self.loss is not binary_cross_entropy:
      return self.loss(preds, labels), aux
    pc = torch.clamp(preds, 1e-6, 1 - 1e-6)
    pel = -(labels * torch.log(pc) + (1 - labels) * torch.log(1 - pc))
    valid = batch.get(SYNC_VALID_KEY)
    if valid is None:
      return torch.mean(pel), aux
    w = valid.to(pel.dtype)
    loss = torch.sum(pel * w) / torch.clamp(torch.sum(w), min=1e-6)
    aux['per_example_loss'] = pel
    return loss, aux

  # -- the Keras-like lifecycle ---------------------------------------------

  def compile(self, params: nn.Module, optimizer=None,
              model_dir: Optional[str] = None,
              group_key: Optional[str] = None,
              ctx: Optional[Context] = None, **trainer_options) -> Trainer:
    """Bind the parameters and the optimizer into the trainer (JAX
    ``compile``, the reference's ``Model.compile``). ``optimizer`` is
    built on ``params`` (by default the optax-equivalent ``Adagrad(lr=
    0.1)`` on every parameter, as in JAX); ``ctx`` is the extractor's
    unless given; ``trainer_options`` are more keywords of ``Trainer``
    (``summary_steps``, ``keep_checkpoint_max``, ``gradient_wire_dtype``,
    ...). A ``model_dir`` with a checkpoint restores it now."""
    self._trainer = _ModuleTrainer(
        self.extractor, self.loss_fn, params, optimizer, model_dir,
        ctx=ctx or self.extractor.ctx, label_key=self.label_key,
        group_key=group_key, **trainer_options)
    return self._trainer

  @property
  def trainer(self) -> Trainer:
    if self._trainer is None:
      raise RuntimeError('call compile(params) first')
    return self._trainer

  @property
  def params(self) -> nn.Module:
    return self.trainer.params

  def fit(self, batches: Iterable, **train_kwargs) -> Dict[str, float]:
    """Train (``Trainer.train``, every keyword of it: ``max_steps``,
    ``hooks``, ``sync``, ``eval_every_n_steps``, ...)."""
    return self.trainer.train(batches, **train_kwargs)

  def evaluate(self, batches: Iterable, **kwargs) -> Dict[str, float]:
    return self.trainer.evaluate(batches, **kwargs)

  def predict(self, batches: Iterable, **kwargs):
    return self.trainer.predict(batches, **kwargs)

  def _manager(self, path: str) -> CheckpointManager:
    ctx = self.trainer._ctx
    return CheckpointManager(path, None, device=ctx.device, ctx=ctx)

  def save_weights(self, path: str) -> None:
    """Save the parameters, their optimizer slots and the step into the
    directory ``path`` (``training/checkpoint.py``); in a world, every
    rank calls it and writes its rows. Any world restores them."""
    self._manager(path).save(self.trainer.global_step,
                             self.trainer._checkpoint_state())

  def load_weights(self, path: str) -> None:
    """Restore what :meth:`save_weights` wrote into ``path`` (at any
    world); raises ``FileNotFoundError`` when it holds none."""
    mgr = self._manager(path)
    template = self.trainer._checkpoint_state()
    restored = mgr.restore(template)
    if restored is template:
      raise FileNotFoundError(f'no weights saved in {path}')
    self.trainer._load_checkpoint_state(restored)

  def served_tables(self):
    """``(member tables {name: [vocab, d]}, specs)`` that the exported
    bundle serves: each stack split back into its members (in a world,
    every rank calls this: the shards are gathered), and the specs that
    address each member with the identity row mapping (a stack adds its
    members' offsets to the raw ids itself)."""
    fx = self.extractor
    ctx = self.trainer._ctx
    params = self.trainer.params
    members: Dict[str, torch.Tensor] = {}
    for stack in fx.stacks:
      table = params['tables'][stack.stacked.name].detach()
      shard = shard_of(stack.stacked, ctx)
      if shard is not None:
        table = _whole(table, shard, ctx)
      split = member_tables(stack, table)
      members.update({cfg.name: split[cfg.name][:cfg.vocab_size]
                      for cfg in stack.configs})
    specs = [EmbeddingSpec(dataclasses.replace(s.config, shuffle_ids=False),
                           column=s.column) for s in fx.specs]
    return members, specs

  def export_saved_model(self, path: str, example_batch,
                         poly_batch: bool = False) -> str:
    """Export the serving bundle (``training/saved_model.py``): each
    stack split back into its member tables (:meth:`served_tables`),
    every column looked up through kernel 5 (``serving=True``), then the
    module. Its inputs are the module's parameters and buffers and the
    member tables; ``example_batch`` carries every column the model
    reads, the label too; ``poly_batch=True`` serves any batch size. In
    a world, every rank calls this: the shards are gathered and rank 0
    writes."""
    members, specs = self.served_tables()
    if not self.trainer._ctx.is_chief:
      return path
    net = self.trainer.params['net']

    def serving_fn(leaves, batch):
      net_leaves, member = leaves
      return _call_with(net, net_leaves, lambda m, *a: m(*a),
                        *self._served_inputs(member, batch, specs))

    return export(serving_fn, (_leaves(net), members), example_batch, path,
                  poly_batch=poly_batch)


def wraps_module(module: nn.Module, specs: Sequence[EmbeddingSpec],
                 dense_columns: Sequence[str] = (), label_key: str = 'label',
                 loss: Optional[Callable] = None, inputs: str = 'concat',
                 ctx: Optional[Context] = None,
                 lookup_strategy: str = 'allgather') -> WrappedModel:
  """Wrap a stock tower module over the tables of ``specs`` (JAX
  ``wraps_flax_module``); see the module docstring for ``inputs``.
  ``ctx`` is the device and the world (the card, ``Context('cuda')``,
  when None)."""
  extractor = StackedFeatureExtractor(specs, dense_columns,
                                      ctx=ctx or Context('cuda'))
  return WrappedModel(module, extractor, label_key=label_key,
                      loss=loss or binary_cross_entropy, inputs=inputs,
                      lookup_strategy=lookup_strategy)


__all__ = ['INPUTS', 'WrappedModel', 'binary_cross_entropy', 'wraps_module']
