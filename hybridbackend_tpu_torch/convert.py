"""Convert a JAX package train state into the port's.

The JAX package hands its state over as numpy arrays (for example
``jax.tree.map(np.asarray, state)``), so this module imports no JAX. It
expects a state made in a JAX context of as many devices as the port's
world has ranks (one, unless the feature extractor's context says
otherwise), where stacks and their member offsets are laid out as in the
port. On one device a narrow table is lane-packed ``[V/p, 128]``
(``hybridbackend_tpu/embedding/table.py:143-145, 244-246``); a row-major
reshape to ``[-1, dim]`` restores the logical layout, and does nothing to
an unpacked ``[V, dim]`` table.
A bfloat16 table or slot (an ``ml_dtypes`` array, which ``torch.tensor``
does not take) is carried across bit for bit through its 16-bit view,
without importing ``ml_dtypes``.

Two states are carried: the sparse path's ``SparseTrainState``
(:func:`from_jax`) and the dense path's ``TrainState``
(:func:`from_jax_dense`: unstacked tables and the tower in one module).
Either may be taken at a later step: the step count, optax Adam's
``(mu, nu, count)`` of the tower (into torch Adam's ``exp_avg``,
``exp_avg_sq`` and ``step``) and optax Adagrad's ``sum_of_squares`` of
the tables (into the port's ``Adagrad``) come across with it. A JAX
int8 serving table (``QuantizedTable``, ``q`` lane-packed to ``[V/p,
p*d]``) becomes the port's ``[V, d]`` one by the same reshape
(:func:`quantized_from_jax`).

Host-backed tables need nothing here beyond the tower's weights
(:func:`load_dcn_v2` and its kin): an ``EmbeddingCache``'s host tables
and an ``IdMapper``'s ``state_dict`` are numpy arrays in both packages,
with the same keys, so the same arrays are handed to either one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch.distribute.collective import allgather
from hybridbackend_tpu_torch.embedding.quant import QuantizedTable
from hybridbackend_tpu_torch.embedding.sparse_update import SparseOptState
from hybridbackend_tpu_torch.embedding.table import TableConfig
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.models.feature import (
    EmbeddingSpec, StackedFeatureExtractor)
from hybridbackend_tpu_torch.models.layers import Dense, Dice
from hybridbackend_tpu_torch.models.ranking import DIN, DLRM, StackedDCNv2
from hybridbackend_tpu_torch.training.optimizer import init_state
from hybridbackend_tpu_torch.training.sparse_step import (
    OptimizerFactory, SparseTrainState)
from hybridbackend_tpu_torch.training.train import TrainState

Tower = Union[StackedDCNv2, DLRM, DIN]
# optax ``ScaleByAdamState`` of the tower: (mu, nu, count), mu and nu
# shaped as the tower's JAX params.
AdamState = Tuple[Any, Any, int]


def _tensor(arr: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
  """A copy of ``arr`` as ``dtype`` on ``device``; a numpy bfloat16 array
  goes through its bits."""
  if arr.dtype.name == 'bfloat16':
    bits = torch.tensor(arr.view(np.int16))
    return bits.view(torch.bfloat16).to(device=device, dtype=dtype)
  return torch.tensor(arr, dtype=dtype, device=device)


def _logical_table(arr: np.ndarray, cfg: TableConfig, device: torch.device,
                   name: str, ctx: Optional[Context] = None) -> torch.Tensor:
  flat = np.asarray(arr).reshape(-1, cfg.dim)
  vocab = cfg.padded_vocab(ctx)
  if flat.shape[0] < vocab:
    raise ValueError(f'{name}: {flat.shape[0]} rows, the port needs '
                     f'{vocab}')
  # Rows past padded_vocab are the JAX layout's alignment padding; no
  # valid id reaches them. torch.tensor copies: the port updates its
  # tables in place, and the source may be a read-only JAX buffer.
  flat = flat[:vocab]
  if ctx is not None:
    flat = flat[cfg.shard_rows(ctx)]
  return _tensor(flat, cfg.dtype, device)


def _logical(fx: StackedFeatureExtractor, arrays: Mapping[str, np.ndarray],
             ctx: Context) -> Dict[str, torch.Tensor]:
  return {s.stacked.name: _logical_table(arrays[s.stacked.name], s.stacked,
                                         ctx.device, s.stacked.name, ctx)
          for s in fx.stacks}


def gather_tables(fx: StackedFeatureExtractor,
                  tables: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
  """Each stack's whole logical table on every rank: the ranks' shards
  of a sharded stack gathered in rank order (a collective: every rank
  calls it), a replicated one as it is. For checks of a world of more
  than one rank against one of one, and for a table (or a slot) that
  leaves the world."""
  return {s.stacked.name: (allgather(tables[s.stacked.name], ctx=fx.ctx)
                           if s.stacked.should_shard(fx.ctx)
                           else tables[s.stacked.name])
          for s in fx.stacks}


def _layers(model: nn.Module, params: Mapping[str, Any]
            ) -> Tuple[List[Dense], List[Mapping]]:
  """The tower's ``Dense`` layers and the JAX ``{w, b}`` dicts of a
  params-shaped tree (the params, or Adam's ``mu`` or ``nu``), in one
  order."""
  if isinstance(model, StackedDCNv2):
    return ([model.cross, *model.mlp.layers],
            [params['cross'], *params['mlp']])
  if isinstance(model, DLRM):
    return ([*model.bottom_mlp.layers, model.bottom_out,
             *model.top_mlp.layers],
            [*params['bottom_mlp'], params['bottom_out'],
             *params['top_mlp']])
  if isinstance(model, DIN):      # DINSession too: the same parameters
    return ([*model.attention.mlp.layers, *model.dnn.layers, model.head],
            [*params['attention']['mlp'], *params['dnn'], params['head']])
  raise TypeError(f'no JAX params layout for {type(model).__name__}')


def _dense_pairs(layers: Sequence[Dense], params: Sequence[Mapping]
                 ) -> List[Tuple[nn.Parameter, torch.Tensor]]:
  """``(parameter, value)`` for every ``w`` and ``b`` of ``layers``, the
  value from the JAX ``{w, b}`` dicts as float32 (same layout)."""
  if len(layers) != len(params):
    raise ValueError(f'model has {len(layers)} dense layers, params '
                     f'{len(params)}')
  out = []
  for layer, p in zip(layers, params):
    for key in ('w', 'b'):
      target = getattr(layer, key)
      value = torch.tensor(np.asarray(p[key]), dtype=torch.float32)
      if value.shape != target.shape:
        raise ValueError(f'{key}: {tuple(value.shape)} does not fit '
                         f'{tuple(target.shape)}')
      out.append((target, value))
  return out


def _load_dense(layers: Sequence[Dense], params: Sequence[Mapping]):
  """Copy JAX ``{w, b}`` dicts into ``Dense`` layers (same layout)."""
  with torch.no_grad():
    for target, value in _dense_pairs(layers, params):
      target.copy_(value)


def _pairs(model: nn.Module, tree: Mapping[str, Any]
           ) -> List[Tuple[nn.Parameter, torch.Tensor]]:
  """``(parameter, value)`` for every weight of the tower, from a JAX
  params-shaped tree (the params, or Adam's ``mu`` or ``nu``)."""
  return _dense_pairs(*_layers(model, tree))


def _load_tower(model: nn.Module, params: Mapping[str, Any]) -> None:
  _load_dense(*_layers(model, params))


def load_dcn_v2(model: StackedDCNv2, params: Mapping[str, Any]) -> None:
  """Copy JAX ``stacked_dcn_v2`` params ``{'cross': {w, b}, 'mlp':
  [{w, b}, ...]}`` into ``model`` (same ``w: [in, out]`` layout)."""
  _load_tower(model, params)


def load_dlrm(model: DLRM, params: Mapping[str, Any]) -> None:
  """Copy JAX ``dlrm`` params ``{'bottom_mlp': [{w, b}, ...],
  'bottom_out': {w, b}, 'top_mlp': [{w, b}, ...]}`` into ``model``."""
  _load_tower(model, params)


def load_din(model: DIN, params: Mapping[str, Any]) -> None:
  """Copy JAX ``din_init`` (or ``din_session_init``) params
  ``{'attention': {'mlp': [{w, b}, ...]}, 'dnn': [{w, b}, ...], 'head':
  {w, b}}`` into a ``DIN`` or ``DINSession``."""
  _load_tower(model, params)


def load_dice(model: Dice, params: Mapping[str, Any]) -> None:
  """Copy JAX ``dice_init`` params ``{'alpha': [dim]}`` into ``model``."""
  with torch.no_grad():
    model.alpha.copy_(torch.tensor(np.asarray(params['alpha']),
                                   dtype=torch.float32))


def load_adam_state(optimizer, model: nn.Module, adam: AdamState) -> None:
  """Copy optax Adam's ``(mu, nu, count)`` of the tower ``model`` into
  torch Adam's ``exp_avg``, ``exp_avg_sq`` and ``step`` (``optimizer``
  is that Adam, or a ``MultiOptimizer`` that holds it)."""
  mu, nu, count = adam
  init_state(optimizer)
  state = optimizer.state
  with torch.no_grad():
    for (p, m), (_, v) in zip(_pairs(model, mu), _pairs(model, nu)):
      slots = state[p]
      slots['exp_avg'].copy_(m)
      slots['exp_avg_sq'].copy_(v)
      slots['step'].fill_(float(count))


def from_jax(fx: StackedFeatureExtractor, tables: Mapping[str, np.ndarray],
             slots: Mapping[str, Any], model: Tower,
             dense_params: Mapping[str, Any],
             dense_optimizer: OptimizerFactory, *, step: int = 0,
             adam: Optional[AdamState] = None,
             ctx: Optional[Context] = None) -> SparseTrainState:
  """The port's state from a JAX ``SparseTrainState`` given as numpy.

  In a world of more than one rank, each rank passes the JAX state's
  global arrays (made on a mesh of as many devices) and keeps its rows
  of each sharded stack's table and slots.

  Args:
    tables: ``state.tables``, one array per stack name.
    slots: each stack's table-optimizer slots, ``state.table_opt[name]
      .acc``: the Adagrad accumulator (an array, or a 1-tuple), or
      LazyAdam's ``(m, v)``.
    model: the port's tower (``StackedDCNv2``, ``DLRM``, ``DIN`` or
      ``DINSession``), loaded in place from ``dense_params``, the JAX
      ``stacked_dcn_v2``, ``dlrm`` or ``din`` params.
    dense_optimizer: builds the tower's optimizer (torch Adam for optax
      Adam).
    step: ``int(state.step)``.
    adam: the tower's ``state.dense_opt[0]`` as ``(mu, nu, count)``; None
      leaves the optimizer's state empty, as it is at step 0.
    ctx: the world, by default the feature extractor's.
  """
  _load_tower(model, dense_params)
  ctx = ctx or fx.ctx
  model.to(ctx.device)
  per_stack = {name: s if isinstance(s, (tuple, list)) else (s,)
               for name, s in slots.items()}
  widths = {len(s) for s in per_stack.values()}
  if len(widths) > 1 or not widths <= {1, 2}:
    raise ValueError('slots must be one accumulator or one (m, v) pair '
                     f'per stack; got {sorted(widths)} arrays')
  by_slot = [_logical(fx, {n: s[i] for n, s in per_stack.items()}, ctx)
             for i in range(max(widths, default=0))]
  state = SparseTrainState(
      step=step, dense=model, tables=_logical(fx, tables, ctx),
      table_opt={name: SparseOptState(acc=tuple(b[name] for b in by_slot))
                 for name in per_stack},
      dense_opt=dense_optimizer(model.parameters()))
  if adam is not None:
    load_adam_state(state.dense_opt, model, adam)
  return state


def from_jax_dense(module: nn.Module, specs: Sequence[EmbeddingSpec],
                   params: Mapping[str, Any], optimizer, *, step: int = 0,
                   sum_of_squares: Optional[Mapping[str, np.ndarray]] = None,
                   adam: Optional[AdamState] = None) -> TrainState:
  """The port's dense-path state from a JAX ``TrainState`` given as
  numpy.

  Args:
    module: the port's parameters, with the ``init_tables`` tables under
      ``tables`` and the tower under ``net``, on their device; loaded in
      place.
    specs: the tables' specs, in any order.
    params: ``state.params``, ``{'tables': {name: array}, 'net': tower
      params}``; a lane-packed table comes across in its logical layout.
    optimizer: built on ``module`` (for example ``multi_optimizer(
      partial(Adagrad, lr), partial(torch.optim.Adam, lr))(module)``).
    step: ``int(state.step)``.
    sum_of_squares: optax Adagrad's accumulators of the tables, ``{name:
      array}``, into the port's ``Adagrad``.
    adam: optax Adam's ``(mu, nu, count)`` of the tower, ``mu`` and
      ``nu`` shaped as ``params['net']``.
  """
  tables = module.tables
  configs = {s.name: s.config for s in specs}
  with torch.no_grad():
    for name, arr in params['tables'].items():
      tables[name].copy_(_logical_table(arr, configs[name],
                                        tables[name].device, name))
  _load_tower(module.net, params['net'])
  state = TrainState.create(module, optimizer)
  with torch.no_grad():
    for name, arr in (sum_of_squares or {}).items():
      acc = state.optimizer.state[tables[name]]['sum_of_squares']
      acc.copy_(_logical_table(arr, configs[name], acc.device, name))
  if adam is not None:
    load_adam_state(state.optimizer, module.net, adam)
  state.step = step
  return state


def quantized_from_jax(q: np.ndarray, scale: np.ndarray, dim: int,
                       device: torch.device) -> QuantizedTable:
  """The port's ``QuantizedTable`` from a JAX one's ``q`` (packed
  ``[V/p, p*dim]`` or ``[V, dim]`` int8) and ``scale`` (``[V]``): a
  row-major reshape of ``q`` to ``[V, dim]``, as JAX's
  ``dequantize_table`` does (``quant.py:90-94``)."""
  scale = np.asarray(scale, np.float32)
  q = np.asarray(q, np.int8).reshape(scale.shape[0], dim)
  return QuantizedTable(q=torch.tensor(q, device=device),
                        scale=torch.tensor(scale, device=device))


__all__ = ['from_jax', 'from_jax_dense', 'gather_tables', 'load_adam_state',
           'load_dcn_v2', 'load_dice', 'load_din', 'load_dlrm',
           'quantized_from_jax']
