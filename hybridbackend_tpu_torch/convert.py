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
The parameters of the JAX flax adapter (``flax_support.py``: stacked
tables and a flax tower) come into those of the port's module adapter
(``module_support.py``) through :func:`from_jax_module`, the flax
``Dense`` layers into ``nn.Linear`` ones.
Either may be taken at a later step: the step count, optax Adam's
``(mu, nu, count)`` of the tower (into torch Adam's ``exp_avg``,
``exp_avg_sq`` and ``step``) and optax Adagrad's ``sum_of_squares`` of
the tables (into the port's ``Adagrad``) come across with it. A JAX
int8 serving table (``QuantizedTable``, ``q`` lane-packed to ``[V/p,
p*d]``) becomes the port's ``[V, d]`` one by the same reshape
(:func:`quantized_from_jax`), or a rank's shard of a sharded one.

Host-backed tables need nothing here beyond the tower's weights
(:func:`load_dcn_v2` and its kin): an ``EmbeddingCache``'s host tables
and an ``IdMapper``'s ``state_dict`` are numpy arrays in both packages,
with the same keys, so the same arrays are handed to either one.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch.distribute.collective import allgather
from hybridbackend_tpu_torch.embedding.quant import (
    QuantizedTable, shard_quantized)
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
    flat = flat[cfg.shard_rows(ctx), cfg.shard_cols(ctx)]
  return _tensor(np.ascontiguousarray(flat), cfg.dtype, device)


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
  calls it), joined by rows or, column-sharded, along the dim; a
  replicated one as it is. For checks of a world of more than one rank
  against one of one, and for a table (or a slot) that leaves the
  world."""
  return {s.stacked.name: (allgather(tables[s.stacked.name], ctx=fx.ctx,
                                     axis=int(s.stacked.by_column))
                           if s.stacked.should_shard(fx.ctx)
                           else tables[s.stacked.name])
          for s in fx.stacks}


def gather_slots(fx: StackedFeatureExtractor,
                 table_opt: Mapping[str, SparseOptState]
                 ) -> Dict[str, Tuple[torch.Tensor, ...]]:
  """Each stack's table-optimizer slots (Adagrad's ``(acc,)``, LazyAdam's
  ``(m, v)``) whole on every rank, gathered as :func:`gather_tables`
  gathers the tables (a collective: every rank calls it)."""
  width = {len(s.acc) for s in table_opt.values()}
  if len(width) > 1:
    raise ValueError(f'the stacks hold {sorted(width)} slots each; one '
                     'optimizer has one number')
  per_slot = [gather_tables(fx, {n: s.acc[i] for n, s in table_opt.items()})
              for i in range(max(width, default=0))]
  return {name: tuple(g[name] for g in per_slot) for name in table_opt}


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
  global arrays (made on a mesh of as many devices, one node or a
  ``(dcn, ici)`` mesh of several) and keeps its rows of each sharded
  stack's table and slots, or its columns of a column-sharded one.

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
                   adam: Optional[AdamState] = None,
                   ctx: Optional[Context] = None) -> TrainState:
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
    ctx: the world of ``module``'s tables (``init_tables(..., ctx=ctx)``):
      each rank passes the JAX state's global arrays, made on a mesh of as
      many devices, and keeps its rows (or, column-sharded, its columns)
      of each sharded table and accumulator.
  """
  tables = module.tables
  configs = {s.name: s.config for s in specs}
  with torch.no_grad():
    for name, arr in params['tables'].items():
      tables[name].copy_(_logical_table(arr, configs[name],
                                        tables[name].device, name, ctx))
  _load_tower(module.net, params['net'])
  state = TrainState.create(module, optimizer, ctx)
  with torch.no_grad():
    for name, arr in (sum_of_squares or {}).items():
      acc = state.optimizer.state[tables[name]]['sum_of_squares']
      acc.copy_(_logical_table(arr, configs[name], acc.device, name, ctx))
  if adam is not None:
    load_adam_state(state.optimizer, module.net, adam)
  state.step = step
  return state


def _flax_dense(variables: Mapping[str, Any],
                layers: Optional[Mapping[str, str]], net: nn.Module
                ) -> List[Tuple[nn.Linear, Mapping[str, Any]]]:
  """``(nn.Linear, flax Dense params {kernel, bias})`` pairs: by the name
  map ``layers`` (a flax path, ``'/'``-joined, to a submodule of ``net``),
  or the flax module's ``Dense_<i>`` in the order of ``i`` against
  ``net``'s ``nn.Linear`` modules in ``net.modules()`` order."""
  flax = variables.get('params', variables)
  if layers is not None:
    modules = dict(net.named_modules())
    out = []
    for path, name in layers.items():
      node = flax
      for key in path.split('/'):
        node = node[key]
      out.append((modules[name], node))
    return out
  dense = sorted(((int(m[1]), v) for k, v in flax.items()
                  for m in [re.fullmatch(r'Dense_(\d+)', k)] if m),
                 key=lambda kv: kv[0])
  linears = [m for m in net.modules() if isinstance(m, nn.Linear)]
  if len(dense) != len(flax) or len(dense) != len(linears):
    raise ValueError(f'the flax module has {sorted(flax)}, the tower '
                     f'{len(linears)} nn.Linear modules: pass layers=')
  return list(zip(linears, (v for _, v in dense)))


def from_jax_module(params: nn.Module, fx: StackedFeatureExtractor,
                    jax_params: Mapping[str, Any], *,
                    layers: Optional[Mapping[str, str]] = None,
                    ctx: Optional[Context] = None) -> None:
  """Load the JAX flax adapter's parameters, given as numpy, into the
  port's module adapter's (``WrappedModel.init``'s module), in place.

  Args:
    params: the port's ``{'tables': ParameterDict, 'net': tower}``.
    fx: the port's extractor (``WrappedModel.extractor``), laid out as
      the JAX one.
    jax_params: ``WrappedFlaxModel.init``'s ``{'tables': {stack name:
      array}, 'net': flax variables}``; a lane-packed stack comes across
      in its logical layout (:func:`from_jax`'s reshape).
    layers: ``{flax path: port submodule name}``, for example
      ``{'Dense_0': '0', 'Dense_1': '2'}`` for an ``nn.Sequential``
      tower; by default the flax module's ``Dense_0``, ``Dense_1``, ...
      (its top level only) in order against the tower's ``nn.Linear``
      modules in ``modules()`` order. A flax kernel ``[in, out]`` becomes
      the weight ``[out, in]``.
    ctx: the world, by default the extractor's: each rank passes the
      global arrays and keeps its rows of a sharded stack.
  """
  ctx = ctx or fx.ctx
  with torch.no_grad():
    for name, t in _logical(fx, jax_params['tables'], ctx).items():
      params['tables'][name].copy_(t)
    for linear, p in _flax_dense(jax_params['net'], layers, params['net']):
      for target, value in ((linear.weight, np.asarray(p['kernel']).T),
                            (linear.bias, np.asarray(p['bias']))):
        if tuple(value.shape) != tuple(target.shape):
          raise ValueError(f'a flax array of {tuple(value.shape)} does not '
                           f'fit {tuple(target.shape)}')
        target.copy_(torch.tensor(value, dtype=target.dtype))


def quantized_from_jax(q: np.ndarray, scale: np.ndarray, dim: int,
                       device: torch.device,
                       config: Optional[TableConfig] = None,
                       ctx: Optional[Context] = None) -> QuantizedTable:
  """The port's ``QuantizedTable`` from a JAX one's ``q`` (packed
  ``[V/p, p*dim]`` or ``[V, dim]`` int8) and ``scale`` (``[V]``): a
  row-major reshape of ``q`` to ``[V, dim]``, as JAX's
  ``dequantize_table`` does (``quant.py:90-94``).

  With ``config`` sharded over ``ctx``, the arrays are the global ones of
  a JAX ``shard_quantized`` table (its padding rows ``q = 0``, ``scale =
  1``), and the result is this rank's shard by the port's bounds
  (``quant.shard_quantized``): JAX pads the packed rows to the world,
  so its global arrays hold at least the port's padded vocab."""
  scale = np.asarray(scale, np.float32)
  q = np.asarray(q, np.int8).reshape(scale.shape[0], dim)
  qt = QuantizedTable(q=torch.tensor(q), scale=torch.tensor(scale))
  if config is not None and config.should_shard(ctx):
    qt = shard_quantized(qt, config, ctx)
  return QuantizedTable(q=qt.q.to(device), scale=qt.scale.to(device))


__all__ = ['from_jax', 'from_jax_dense', 'from_jax_module', 'gather_slots',
           'gather_tables', 'load_adam_state', 'load_dcn_v2', 'load_dice',
           'load_din', 'load_dlrm', 'quantized_from_jax']
