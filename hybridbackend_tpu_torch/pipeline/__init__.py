"""Micro-batch pipelining (gradient accumulation).

Counterpart of ``hybridbackend_tpu/pipeline/__init__.py:25-83``
(``accumulate_gradients``, ``make_pipelined_train_step``), the
reference's ``compute_pipeline`` and ``PipelinedOptimizer``: each step's
batch is cut into ``num_microbatches`` contiguous slices of its leading
dimension, each slice's loss is differentiated, the gradients are summed
and scaled by ``1 / num_microbatches``, and the optimizer applies once.
The JAX step does this in a ``lax.scan``; here it is a Python loop over
views of the batch, with ``torch.utils.checkpoint`` in place of
``jax.checkpoint``.

``num_microbatches`` is an argument: the JAX option ``data_batch_count``
is not ported (the port takes explicit arguments). Where the JAX slicing
silently drops a remainder (``x.shape[0] // num_microbatches`` rows a
slice), the port raises ``ValueError`` on a leading dimension that does
not divide, as the JAX interleaved step does.

``make_interleaved_train_step`` (``pipeline/interleave.py``) is the
sparse counterpart: the tables' lookups of the micro-batches overlap the
tower on a side CUDA stream, and one row-sparse update a stack applies
the whole step's embedding gradients.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hybridbackend_tpu_torch.training.train import (
    Batch, LossFn, TrainState, _detached)


def _microbatches(batch: Batch, num_microbatches: int) -> List[Batch]:
  """``batch`` cut into ``num_microbatches`` contiguous slices of the
  leading dimension of every tensor column (views; a 0-d tensor or a
  non-tensor value goes to every slice unchanged). Raises ``ValueError``
  when a leading dimension does not divide."""
  k = num_microbatches
  if k < 1:
    raise ValueError(f'num_microbatches must be at least 1, got {k}')
  for key, col in batch.items():
    if isinstance(col, torch.Tensor) and col.dim() and col.shape[0] % k:
      raise ValueError(
          f'Batch column {key!r} has leading dim {col.shape[0]}, '
          f'not divisible by num_microbatches={k}')

  def part(col, i):
    if not isinstance(col, torch.Tensor) or not col.dim():
      return col
    m = col.shape[0] // k
    return col[i * m:(i + 1) * m]

  return [{key: part(col, i) for key, col in batch.items()}
          for i in range(k)]


def _stitch(auxs: List[Dict[str, Any]]) -> Dict[str, Any]:
  """The micro-batches' aux values as JAX stacks them out of its scan
  (``:59-60``): a tensor of rank 1 or more concatenated back along the
  batch axis, a scalar as the vector of the micro-batches' values."""
  out = {}
  for key in auxs[0]:
    vals = [a[key] for a in auxs]
    if not isinstance(vals[0], torch.Tensor):
      out[key] = vals
    elif vals[0].dim():
      out[key] = torch.cat(vals)
    else:
      out[key] = torch.stack(vals)
  return out


def accumulate_gradients(loss_fn: LossFn, num_microbatches: int,
                         remat: bool = True
                         ) -> Callable[[nn.Module, Batch],
                                       Tuple[Tuple[torch.Tensor, Dict],
                                             Dict[str, torch.Tensor]]]:
  """``grad_fn(params, batch) -> ((loss, aux), grads)``, gradients
  averaged over ``num_microbatches`` slices of the batch.

  ``loss_fn(params, batch) -> (scalar_loss, aux)`` is the port's loss
  (``training/train.py``), ``params`` an ``nn.Module``. Each slice's loss
  is differentiated into the parameters' ``.grad`` (cleared first), so
  the gradients sum in the slices' order as JAX's scan adds them; then
  they are scaled by ``1 / num_microbatches`` in place. ``grads`` is
  ``{name: p.grad}`` for every parameter the loss reached: the very
  tensors an optimizer's ``step()`` reads, so a caller may step at once.
  The loss is the slices' mean (left on the device, detached) and ``aux``
  is stitched as :func:`_stitch` says. With ``remat`` each slice's
  activations are recomputed in its backward
  (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``
  does: the values are the same either way.
  """
  k = num_microbatches

  def forward(params, mb):
    if remat:
      return checkpoint(loss_fn, params, mb, use_reentrant=False)
    return loss_fn(params, mb)

  def grad_fn(params: nn.Module, batch: Batch):
    named = [(n, p) for n, p in params.named_parameters() if p.requires_grad]
    for _, p in named:
      p.grad = None
    total, auxs = None, []
    for mb in _microbatches(batch, k):
      loss, aux = forward(params, mb)
      loss.backward()
      total = loss.detach() if total is None else total + loss.detach()
      auxs.append(_detached(aux))
    scale = 1.0 / k
    grads = {}
    for n, p in named:
      if p.grad is not None:
        grads[n] = p.grad.mul_(scale)
    return (total * scale, _stitch(auxs)), grads

  return grad_fn


def make_pipelined_train_step(loss_fn: LossFn, num_microbatches: int,
                              remat: bool = True
                              ) -> Callable[[TrainState, Batch],
                                            Tuple[TrainState,
                                                  Dict[str, Any]]]:
  """``make_train_step`` with micro-batch accumulation (the reference's
  ``PipelinedOptimizer.minimize``): ``step(state, batch) -> (state,
  metrics)``. The optimizer is part of the state, as in
  ``make_train_step``, and applies once a step to the averaged
  gradients; ``metrics`` holds the stitched aux and ``'loss'``, the
  slices' mean, all left on the device."""
  grad_fn = accumulate_gradients(loss_fn, num_microbatches, remat)

  def step(state: TrainState, batch: Batch):
    (loss, aux), _ = grad_fn(state.params, batch)
    state.optimizer.step()
    state.step += 1
    metrics = dict(aux)
    metrics['loss'] = loss
    return state, metrics

  return step


from hybridbackend_tpu_torch.pipeline.interleave import (  # noqa: E402
    make_interleaved_train_step)

__all__ = ['accumulate_gradients', 'make_interleaved_train_step',
           'make_pipelined_train_step']
