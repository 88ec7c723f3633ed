"""Convert a JAX package train state into the port's.

The JAX package hands its state over as numpy arrays (for example
``jax.tree.map(np.asarray, state)``), so this module imports no JAX. It
expects a state made in a one-device JAX context, where stacks and their
member offsets are laid out as in the port. There a narrow table is
lane-packed ``[V/p, 128]`` (``hybridbackend_tpu/embedding/table.py:
143-145, 244-246``); a row-major reshape to ``[-1, dim]`` restores the
logical layout, and does nothing to an unpacked ``[V, dim]`` table.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from hybridbackend_tpu_torch.embedding.sparse_update import SparseOptState
from hybridbackend_tpu_torch.models.feature import StackedFeatureExtractor
from hybridbackend_tpu_torch.models.ranking import StackedDCNv2
from hybridbackend_tpu_torch.training.sparse_step import (
    OptimizerFactory, SparseTrainState)


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
    out[name] = torch.tensor(flat[:cfg.padded_vocab()], dtype=cfg.dtype,
                             device=fx.ctx.device)
  return out


def load_dcn_v2(model: StackedDCNv2, params: Mapping[str, Any]) -> None:
  """Copy JAX ``stacked_dcn_v2`` params ``{'cross': {w, b}, 'mlp':
  [{w, b}, ...]}`` into ``model`` (same ``w: [in, out]`` layout)."""
  dense = [model.cross, *model.mlp.layers]
  src = [params['cross'], *params['mlp']]
  if len(dense) != len(src):
    raise ValueError(f'model has {len(dense)} dense layers, params '
                     f'{len(src)}')
  with torch.no_grad():
    for layer, p in zip(dense, src):
      for key in ('w', 'b'):
        target = getattr(layer, key)
        value = torch.tensor(np.asarray(p[key]), dtype=torch.float32)
        if value.shape != target.shape:
          raise ValueError(f'{key}: {tuple(value.shape)} does not fit '
                           f'{tuple(target.shape)}')
        target.copy_(value)


def from_jax(fx: StackedFeatureExtractor, tables: Mapping[str, np.ndarray],
             accs: Mapping[str, np.ndarray], model: StackedDCNv2,
             dense_params: Mapping[str, Any],
             dense_optimizer: OptimizerFactory) -> SparseTrainState:
  """The port's state from a JAX ``SparseTrainState`` given as numpy.

  Args:
    tables: ``state.tables``, one array per stack name.
    accs: each stack's Adagrad accumulator, ``state.table_opt[name].acc[0]``.
    model: the port's tower, loaded in place from ``dense_params``, the
      JAX ``stacked_dcn_v2`` params.
    dense_optimizer: builds the tower's optimizer. Its slots start empty,
      as the JAX ones are at step 0; moments of a later step are not
      carried over.
  """
  load_dcn_v2(model, dense_params)
  model.to(fx.ctx.device)
  return SparseTrainState(
      step=0, dense=model, tables=_logical(fx, tables),
      table_opt={name: SparseOptState(acc=(acc,))
                 for name, acc in _logical(fx, accs).items()},
      dense_opt=dense_optimizer(model.parameters()))


__all__ = ['from_jax', 'load_dcn_v2']
