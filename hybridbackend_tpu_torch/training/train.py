"""The dense-gradient train step and the eval step.

Counterpart of ``hybridbackend_tpu/training/train.py:36-51,160-219,
259-269`` (``TrainState``, ``make_train_step``, ``make_eval_step``) at a
world of one device. The parameters are one ``nn.Module`` that holds the
tables and the tower; the loss is differentiated with respect to all of
them, so each table gets a dense ``[V, d]`` gradient (the backward of the
lookup's ``index_select`` is an ``index_add_``), and one optimizer,
typically ``multi_optimizer(Adagrad, Adam)``, updates everything in
place. The JAX step returns a new state; this one updates the state it is
given and returns it. The gradient's wire dtype (JAX
``comm_gradient_wire_dtype``, ``train.py:72-158``) needs this step in a
world of more than one rank, ROADMAP item 15b (5), and raises until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from hybridbackend_tpu_torch.distribute.collective import (
    WireDtype, wire_dtype_of)
from hybridbackend_tpu_torch.training.optimizer import init_state

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[nn.Module, Batch], Tuple[torch.Tensor, Dict[str, Any]]]


@dataclasses.dataclass
class TrainState:
  """Carried training state: the step count (on the host), the
  parameters and their optimizer."""
  step: int
  params: nn.Module
  optimizer: Any

  @classmethod
  def create(cls, params: nn.Module, optimizer) -> 'TrainState':
    """``optimizer`` is built on ``params`` (for example
    ``multi_optimizer(...)(params)``); its state is made now, as optax's
    ``init`` does."""
    init_state(optimizer)
    return cls(step=0, params=params, optimizer=optimizer)


def _detached(aux: Dict[str, Any]) -> Dict[str, Any]:
  return {k: v.detach() if isinstance(v, torch.Tensor) else v
          for k, v in aux.items()}


def make_train_step(loss_fn: LossFn, gradient_wire_dtype: WireDtype = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, Any]]]:
  """Build ``step(state, batch) -> (state, metrics)``.

  ``loss_fn(params, batch) -> (scalar_loss, aux)``, the loss a mean over
  the batch. ``metrics`` holds ``aux`` and ``'loss'``, all left on the
  device. The optimizer is part of the state, so unlike the JAX function
  this one takes none. A ``gradient_wire_dtype`` other than float32
  raises: ROADMAP item 15b (5)."""
  if wire_dtype_of(gradient_wire_dtype) is not None:
    raise NotImplementedError(
        f'the dense step\'s gradient wire ({gradient_wire_dtype}) runs in a '
        'world of more than one rank, which is ROADMAP item 15b (5)')

  def step(state: TrainState, batch: Batch):
    loss, aux = loss_fn(state.params, batch)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    metrics = _detached(aux)
    metrics['loss'] = loss.detach()
    return state, metrics

  return step


def make_eval_step(eval_fn: Callable[[Any, Batch], Any]
                   ) -> Callable[[Any, Batch], Any]:
  """``eval_fn(params, batch)`` run under ``torch.no_grad()``."""

  def evaluate(params, batch: Batch):
    with torch.no_grad():
      return eval_fn(params, batch)

  return evaluate


__all__ = ['TrainState', 'make_eval_step', 'make_train_step']
