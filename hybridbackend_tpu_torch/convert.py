"""Convert a JAX package train state into the port's.

The JAX package hands its state over as numpy arrays (for example
``jax.tree.map(np.asarray, state)``), so this module imports no JAX. It
expects a state made in a one-device JAX context, where stacks and their
member offsets are laid out as in the port. There a narrow table is
lane-packed ``[V/p, 128]`` (``hybridbackend_tpu/embedding/table.py:
143-145, 244-246``); a row-major reshape to ``[-1, dim]`` restores the
logical layout, and does nothing to an unpacked ``[V, dim]`` table.
A bfloat16 table or slot (an ``ml_dtypes`` array, which ``torch.tensor``
does not take) is carried across bit for bit through its 16-bit view,
without importing ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch.embedding.sparse_update import SparseOptState
from hybridbackend_tpu_torch.models.feature import StackedFeatureExtractor
from hybridbackend_tpu_torch.models.layers import Dense
from hybridbackend_tpu_torch.models.ranking import DLRM, StackedDCNv2
from hybridbackend_tpu_torch.training.sparse_step import (
    OptimizerFactory, SparseTrainState)

Tower = Union[StackedDCNv2, DLRM]


def _tensor(arr: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
  """A copy of ``arr`` as ``dtype`` on ``device``; a numpy bfloat16 array
  goes through its bits."""
  if arr.dtype.name == 'bfloat16':
    bits = torch.tensor(arr.view(np.int16))
    return bits.view(torch.bfloat16).to(device=device, dtype=dtype)
  return torch.tensor(arr, dtype=dtype, device=device)


def _logical(fx: StackedFeatureExtractor, arrays: Mapping[str, np.ndarray]
             ) -> Dict[str, torch.Tensor]:
  out = {}
  for stack in fx.stacks:
    name, cfg = stack.stacked.name, stack.stacked
    flat = np.asarray(arrays[name]).reshape(-1, cfg.dim)
    if flat.shape[0] < cfg.padded_vocab():
      raise ValueError(f'{name}: {flat.shape[0]} rows, the port needs '
                       f'{cfg.padded_vocab()}')
    # Rows past padded_vocab are the JAX layout's alignment padding; no
    # valid id reaches them. torch.tensor copies: the port updates its
    # tables in place, and the source may be a read-only JAX buffer.
    out[name] = _tensor(flat[:cfg.padded_vocab()], cfg.dtype, fx.ctx.device)
  return out


def _load_dense(layers: Sequence[Dense], params: Sequence[Mapping]):
  """Copy JAX ``{w, b}`` dicts into ``Dense`` layers (same layout)."""
  if len(layers) != len(params):
    raise ValueError(f'model has {len(layers)} dense layers, params '
                     f'{len(params)}')
  with torch.no_grad():
    for layer, p in zip(layers, params):
      for key in ('w', 'b'):
        target = getattr(layer, key)
        value = torch.tensor(np.asarray(p[key]), dtype=torch.float32)
        if value.shape != target.shape:
          raise ValueError(f'{key}: {tuple(value.shape)} does not fit '
                           f'{tuple(target.shape)}')
        target.copy_(value)


def load_dcn_v2(model: StackedDCNv2, params: Mapping[str, Any]) -> None:
  """Copy JAX ``stacked_dcn_v2`` params ``{'cross': {w, b}, 'mlp':
  [{w, b}, ...]}`` into ``model`` (same ``w: [in, out]`` layout)."""
  _load_dense([model.cross, *model.mlp.layers],
              [params['cross'], *params['mlp']])


def load_dlrm(model: DLRM, params: Mapping[str, Any]) -> None:
  """Copy JAX ``dlrm`` params ``{'bottom_mlp': [{w, b}, ...],
  'bottom_out': {w, b}, 'top_mlp': [{w, b}, ...]}`` into ``model``."""
  _load_dense([*model.bottom_mlp.layers, model.bottom_out,
               *model.top_mlp.layers],
              [*params['bottom_mlp'], params['bottom_out'],
               *params['top_mlp']])


def _load_tower(model: nn.Module, params: Mapping[str, Any]) -> None:
  if isinstance(model, StackedDCNv2):
    load_dcn_v2(model, params)
  elif isinstance(model, DLRM):
    load_dlrm(model, params)
  else:
    raise TypeError(f'no JAX params layout for {type(model).__name__}')


def from_jax(fx: StackedFeatureExtractor, tables: Mapping[str, np.ndarray],
             slots: Mapping[str, Any], model: Tower,
             dense_params: Mapping[str, Any],
             dense_optimizer: OptimizerFactory) -> SparseTrainState:
  """The port's state from a JAX ``SparseTrainState`` given as numpy.

  Args:
    tables: ``state.tables``, one array per stack name.
    slots: each stack's table-optimizer slots, ``state.table_opt[name]
      .acc``: the Adagrad accumulator (an array, or a 1-tuple), or
      LazyAdam's ``(m, v)``.
    model: the port's tower (``StackedDCNv2`` or ``DLRM``), loaded in
      place from ``dense_params``, the JAX ``stacked_dcn_v2`` or ``dlrm``
      params.
    dense_optimizer: builds the tower's optimizer. Its slots start empty,
      as the JAX ones are at step 0; moments of a later step are not
      carried over.
  """
  _load_tower(model, dense_params)
  model.to(fx.ctx.device)
  per_stack = {name: s if isinstance(s, (tuple, list)) else (s,)
               for name, s in slots.items()}
  widths = {len(s) for s in per_stack.values()}
  if len(widths) > 1 or not widths <= {1, 2}:
    raise ValueError('slots must be one accumulator or one (m, v) pair '
                     f'per stack; got {sorted(widths)} arrays')
  by_slot = [_logical(fx, {n: s[i] for n, s in per_stack.items()})
             for i in range(max(widths, default=0))]
  return SparseTrainState(
      step=0, dense=model, tables=_logical(fx, tables),
      table_opt={name: SparseOptState(acc=tuple(b[name] for b in by_slot))
                 for name in per_stack},
      dense_opt=dense_optimizer(model.parameters()))


__all__ = ['from_jax', 'load_dcn_v2', 'load_dlrm']
