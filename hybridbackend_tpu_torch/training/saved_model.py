"""Serving export: one bundle that a cold process loads and serves.

Counterpart of ``hybridbackend_tpu/training/saved_model.py:21-184``.
The JAX package serializes the serving function with ``jax.export``
(StableHLO) beside an orbax checkpoint; the port records it with
``torch.export`` beside a ``torch.save`` of the parameters. The bundle
is the port's own: it does not read a JAX bundle.

Layout of ``<path>``:

* ``serving_fn.pt2``: ``serving_fn(flat_params, batch)`` recorded by
  ``torch.export`` on the CPU, the parameters as a flat list of tensor
  inputs (as JAX's ``flat_fn`` takes them) and ``batch`` a dict of
  tensors. The graph holds no device: it serves on the card and on the
  CPU alike. Kernel 5 is one node of it, the op ``hbtpu::gather_rows``,
  which must be registered (``import hybridbackend_tpu_torch.ops.gather``)
  before the program is loaded; :func:`load` does that.
* ``params.pt``: the flat parameter list.
* ``signature.json``: the JAX package's schema, ``inputs`` (each
  column's shape, ``'b'`` for the batch dimension under ``poly_batch``,
  and numpy dtype), ``poly_batch``, ``ragged`` (columns served as padded
  ids plus ``<col>_mask``) and ``id_mapped`` (the columns of the bundled
  id mappers).
* ``id_mappers.npz`` and ``id_mappers.json``, with ``id_mappers``: each
  ``IdMapper``'s ``state_dict`` under ``<column>/<key>``, and its
  ``capacity`` and ``min_count``, the JAX package's keys. ``Served`` maps
  those columns' raw ids to rows with them, read-only, before the call.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

# Registers hbtpu::gather_rows, which the exported graphs call.
from hybridbackend_tpu_torch.ops import gather as _gather  # noqa: F401

Batch = Dict[str, torch.Tensor]


class _Flat(nn.Module):
  """``serving_fn`` over the flat parameter list, as ``torch.export``
  takes a module."""

  def __init__(self, serving_fn, treespec):
    super().__init__()
    self.serving_fn = serving_fn
    self.treespec = treespec

  def forward(self, leaves, batch):
    return self.serving_fn(pytree.tree_unflatten(leaves, self.treespec),
                           batch)


def _host(v) -> np.ndarray:
  return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else (
      np.asarray(v))


def _strip_device_asserts(program) -> None:
  """Drops the ``_assert_tensor_metadata`` checks that tracing adds
  beside each ``.to(dtype)``: they hold the tracing device (the CPU),
  and would refuse the same graph's inputs on the card."""
  graph = program.graph_module.graph
  for node in list(graph.nodes):
    if (node.op == 'call_function'
        and node.target == torch.ops.aten._assert_tensor_metadata.default):
      graph.erase_node(node)
  program.graph_module.recompile()


def export(serving_fn: Callable[[Any, Batch], torch.Tensor], params: Any,
           example_batch: Dict[str, Any], path: str,
           id_mappers: Optional[Dict[str, Any]] = None,
           poly_batch: bool = False) -> str:
  """Record ``serving_fn(params, batch)`` and ``params`` under ``path``.

  ``params`` is a tree of tensors (dicts, lists, tuples,
  ``QuantizedTable``); its leaves are copied to the CPU and become the
  graph's inputs. ``example_batch`` maps columns to numpy arrays or
  tensors; every column the function reads must be there (a label
  too, if the function computes a loss). ``poly_batch=True`` makes
  dimension 0 of every batch input one symbolic size (``torch.export.
  Dim``), so one bundle serves any batch size. ``id_mappers`` (``{column:
  IdMapper}``) are saved beside the graph; ``example_batch`` then holds
  those columns' rows (what the function reads), and ``Served`` maps raw
  ids to them."""
  os.makedirs(path, exist_ok=True)
  leaves, treespec = pytree.tree_flatten(params)
  # A copy of exactly the leaf's rows: a view would save its whole base.
  leaves = [leaf.detach().cpu().clone() for leaf in leaves]
  host_batch = {k: _host(v) for k, v in example_batch.items()}
  batch = {k: torch.from_numpy(np.array(v)) for k, v in host_batch.items()}
  dynamic = None
  if poly_batch:
    b = torch.export.Dim('b')
    dynamic = ([None] * len(leaves),
               {k: {0: b} if v.ndim else None for k, v in batch.items()})
  with torch.no_grad():
    program = torch.export.export(_Flat(serving_fn, treespec),
                                  (leaves, batch), dynamic_shapes=dynamic,
                                  strict=False)
  _strip_device_asserts(program)
  # The program would carry its example inputs, the parameters among
  # them: they are saved once, in params.pt.
  program.example_inputs = None
  torch.export.save(program, os.path.join(path, 'serving_fn.pt2'))
  torch.save(leaves, os.path.join(path, 'params.pt'))
  if id_mappers:
    blobs, meta = {}, {}
    for col, mapper in id_mappers.items():
      for k, v in mapper.state_dict().items():
        blobs[f'{col}/{k}'] = np.asarray(v)
      meta[col] = {'capacity': mapper.capacity,
                   'min_count': mapper.min_count}
    np.savez(os.path.join(path, 'id_mappers.npz'), **blobs)
    with open(os.path.join(path, 'id_mappers.json'), 'w') as f:
      json.dump(meta, f)
  keys = set(host_batch)
  signature = {
      'inputs': {k: {'shape': (['b'] + list(v.shape[1:])
                               if poly_batch and v.ndim else list(v.shape)),
                     'dtype': str(v.dtype)}
                 for k, v in host_batch.items()},
      'poly_batch': bool(poly_batch),
      'ragged': sorted(k for k in keys
                       if not k.endswith('_mask') and f'{k}_mask' in keys),
      'id_mapped': sorted(id_mappers) if id_mappers else [],
  }
  with open(os.path.join(path, 'signature.json'), 'w') as f:
    json.dump(signature, f, indent=2)
  return path


def load(path: str, device='cuda'):
  """Load a bundle: returns ``(call(params, batch), params)``, ``params``
  the flat list the export saved, placed on ``device``."""
  program = torch.export.load(os.path.join(path, 'serving_fn.pt2'))
  params = torch.load(os.path.join(path, 'params.pt'),
                      map_location=torch.device(device), weights_only=True)
  return program.module(), params


def load_id_mappers(path: str) -> Dict[str, Any]:
  """The bundle's id mappers, ``{column: IdMapper}`` (none when it has
  none)."""
  from hybridbackend_tpu_torch.embedding.dynamic import IdMapper
  meta_path = os.path.join(path, 'id_mappers.json')
  if not os.path.exists(meta_path):
    return {}
  with open(meta_path) as f:
    meta = json.load(f)
  with np.load(os.path.join(path, 'id_mappers.npz')) as blobs:
    return {col: IdMapper.from_state_dict(
        m['capacity'], {k.split('/', 1)[1]: blobs[k] for k in blobs.files
                        if k.startswith(col + '/')},
        min_count=m['min_count'])
            for col, m in meta.items()}


class Served:
  """A loaded bundle, ready to serve host batches on ``device`` (the card
  unless the caller asks for the CPU). The parameters are placed once,
  here. Bundled id mappers (in the native map) translate their columns'
  raw ids to table rows in :meth:`stage`, the serving half of
  ``DynamicEmbedding.transform``."""

  def __init__(self, path: str, device='cuda'):
    self.device = torch.device(device)
    self._call, self._params = load(path, self.device)
    with open(os.path.join(path, 'signature.json')) as f:
      self.signature = json.load(f)
    self.id_mappers = load_id_mappers(path)

  def stage(self, batch: Dict[str, Any]) -> Batch:
    """The signature's columns of a host batch, raw ids mapped by the
    bundled id mappers (read-only), cast to their dtypes and placed on
    the device: the input half of :meth:`predict`. A server that keeps
    request buffers on the device stages once and calls
    :meth:`predict_staged` per dispatch."""
    batch = dict(batch)
    for col, mapper in self.id_mappers.items():
      batch[col] = mapper.map_ids(_host(batch[col]), train=False)
    return {k: torch.from_numpy(np.ascontiguousarray(
        _host(batch[k]).astype(spec['dtype']))).to(self.device)
            for k, spec in self.signature['inputs'].items()}

  def predict_staged(self, staged: Batch) -> torch.Tensor:
    """The serving function on :meth:`stage`-d inputs; returns the device
    tensor without waiting for it."""
    with torch.no_grad():
      return self._call(self._params, staged)

  def predict(self, batch: Dict[str, Any]) -> np.ndarray:
    return self.predict_staged(self.stage(batch)).cpu().numpy()


__all__ = ['Served', 'export', 'load', 'load_id_mappers']
