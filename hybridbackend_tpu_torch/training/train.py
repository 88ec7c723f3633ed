"""The dense-gradient train step and the eval step.

Counterpart of ``hybridbackend_tpu/training/train.py:36-51,72-219,
259-269`` (``TrainState``, ``make_wire_grad_fn``, ``make_train_step``,
``make_eval_step``). The parameters are one ``nn.Module`` that holds the
tables and the tower; the loss is differentiated with respect to all of
them, so each table gets a dense ``[V, d]`` gradient (the lookup's
backward, ``ops.scatter.dense_row_totals``: each row's gradients summed
in list order by kernel 4, JAX's bits for an f32 table and the same bits
on every call on a card), and one optimizer,
typically ``multi_optimizer(Adagrad, Adam)``, updates everything in
place. The JAX step returns a new state; this one updates the state it is
given and returns it.

In a world of more than one rank (``ctx``) the step is data-parallel, as
the JAX step is over the mesh: each rank runs it on its rows of the
global batch, with its loss a mean over those rows. Every gradient of a
replicated parameter is summed over the ranks in one flat all-reduce and
divided by the world. A sharded table's parameter, its rows or (with
``partition='column'``) its columns (marked by ``init_tables(...,
ctx=ctx)``, ``embedding/table.py``'s ``TableShard``) gets its gradient
from the sharded lookup's backward, whichever its exchange: the sum of every
rank's gradients of its rows, which the step divides by the world once,
so that it carries the global batch's ``1/B`` as in JAX; it is never
all-reduced (``train.py:102-104``). ``TrainState.create`` makes every
rank's replicated parameters and buffers rank 0's. Scalar metrics are
means over the ranks; per-example ones stay the rank's own.

``gradient_wire_dtype`` (JAX ``comm_gradient_wire_dtype``, ``:72-158``)
casts the all-reduce's payload (the sum of the gradients cast to the
wire dtype, cast back, then divided by the world) when no parameter is a
shard. With a shard among the parameters the JAX step cannot run its
wire path and reduces in f32 with a warning; so does this one. At a
world of more than one rank a wire that was asked for is reported as
``metrics['wire_grad']``, 1.0 when it cast and 0.0 when it fell back. At
a world of one there is no wire, as in JAX (``want_wire``, ``:188``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.distribute.collective import (
    WireDtype, wire_dtype_of)
from hybridbackend_tpu_torch.embedding.table import table_shard
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.training.optimizer import init_state

LOG = logging.getLogger('hybridbackend_tpu_torch')
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
  def create(cls, params: nn.Module, optimizer,
             ctx: Optional[Context] = None) -> 'TrainState':
    """``optimizer`` is built on ``params`` (for example
    ``multi_optimizer(...)(params)``); its state is made now, as optax's
    ``init`` does. In a world of more than one rank (``ctx``) every
    rank's replicated parameters and buffers become rank 0's."""
    if ctx is not None and ctx.world_size > 1:
      broadcast_replicated(params, ctx)
    init_state(optimizer)
    return cls(step=0, params=params, optimizer=optimizer)


def broadcast_replicated(module: nn.Module, ctx: Context) -> None:
  """Rank 0's values of ``module``'s parameters and buffers on every
  rank, in place; a table shard keeps its own rows."""
  with torch.no_grad():
    for t in [*module.parameters(), *module.buffers()]:
      if table_shard(t) is None:
        t.copy_(collective.broadcast(t, 0, ctx=ctx))


def _detached(aux: Dict[str, Any]) -> Dict[str, Any]:
  return {k: v.detach() if isinstance(v, torch.Tensor) else v
          for k, v in aux.items()}


def _reduce_grads(params: nn.Module, ctx: Context,
                  wire: Optional[torch.dtype]) -> bool:
  """The data-parallel gradients, in place: each replicated parameter's
  the mean over the ranks (one flat all-reduce, in ``wire`` when it is
  given and no parameter is a shard), each shard's divided by the world.
  Returns whether the all-reduce ran on the wire."""
  world = ctx.world_size
  replicated, shards = [], []
  for p in params.parameters():
    if p.grad is not None:
      (replicated if table_shard(p) is None else shards).append(p.grad)
  on_wire = wire is not None and not any(
      table_shard(p) is not None for p in params.parameters())
  if replicated:
    flat = collective.allreduce(
        torch.cat([g.reshape(-1) for g in replicated]), ctx=ctx,
        wire_dtype=wire if on_wire else None)
    flat /= world
    pos = 0
    for g in replicated:
      g.copy_(flat[pos:pos + g.numel()].view_as(g))
      pos += g.numel()
  for g in shards:
    g /= world
  return on_wire


def make_train_step(loss_fn: LossFn, gradient_wire_dtype: WireDtype = None,
                    ctx: Optional[Context] = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, Any]]]:
  """Build ``step(state, batch) -> (state, metrics)``.

  ``loss_fn(params, batch) -> (scalar_loss, aux)``, the loss a mean over
  the batch (in a world, the rank's rows). ``metrics`` holds ``aux`` and
  ``'loss'``, all left on the device (scalars the means over the ranks).
  The optimizer is part of the state, so unlike the JAX function this
  one takes none. ``gradient_wire_dtype``: ``None`` or ``'float32'``,
  ``'bfloat16'`` or ``'float16'``, used at a world of more than one rank
  only (see the module docstring)."""
  wire = wire_dtype_of(gradient_wire_dtype)
  world = ctx.world_size if ctx is not None else 1
  want_wire = wire is not None and world > 1
  warned = []

  def step(state: TrainState, batch: Batch):
    loss, aux = loss_fn(state.params, batch)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    on_wire = False
    if world > 1:
      on_wire = _reduce_grads(state.params, ctx, wire if want_wire else None)
      if want_wire and not on_wire and not warned:
        warned.append(True)
        LOG.warning(
            'gradient_wire_dtype: params contain row-sharded tables; '
            'dense-grad wire compression disabled for this step (use the '
            'sparse-update path for sharded tables).')
    state.optimizer.step()
    state.step += 1
    metrics = _detached(aux)
    metrics['loss'] = loss.detach()
    if world > 1:
      metrics = {k: (collective.allreduce(v, 'mean', ctx=ctx)
                     if isinstance(v, torch.Tensor) and v.dim() == 0 else v)
                 for k, v in metrics.items()}
    if want_wire:
      metrics['wire_grad'] = torch.tensor(1.0 if on_wire else 0.0,
                                          device=loss.device)
    return state, metrics

  return step


def make_eval_step(eval_fn: Callable[[Any, Batch], Any]
                   ) -> Callable[[Any, Batch], Any]:
  """``eval_fn(params, batch)`` run under ``torch.no_grad()``."""

  def evaluate(params, batch: Batch):
    with torch.no_grad():
      return eval_fn(params, batch)

  return evaluate


__all__ = ['TrainState', 'broadcast_replicated', 'make_eval_step',
           'make_train_step']
