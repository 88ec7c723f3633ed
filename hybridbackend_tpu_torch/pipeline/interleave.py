"""Interleaved sparse and dense execution (PICASSO packing and interleaving).

Counterpart of ``hybridbackend_tpu/pipeline/interleave.py:32-171``
(``make_interleaved_train_step``) at a world of one device. The PICASSO
paper's second pillar overlaps one micro-batch's embedding lookup with
the previous micro-batch's dense compute; the reference does it with
separate CUDA streams, the JAX step by leaving two independent subgraphs
of one ``lax.scan`` to XLA's scheduler. Here it is streams again: on a
CUDA device micro-batch ``i+1``'s lookup is enqueued on a side stream of
the step's own, then micro-batch ``i``'s tower on the current stream.

The semantics are JAX's, exact accumulate-then-apply: every micro-batch
looks up the same table version; the tower's gradients are summed over
the micro-batches and scaled by ``1 / num_microbatches``, and its
optimizer steps once; the micro-batches' embedding gradients are
concatenated along the batch axis, scaled the same way, and go with the
whole batch's packed ids into ONE row-sparse update a stack (kernel 1
for Adagrad, kernel 3 for LazyAdam), the same update list as the plain
step's.

The streams' hazards, each handled where it arises:

* the previous step's table update writes the tables in place on the
  current stream (``ops/build.py`` launches every kernel there), so the
  side stream waits for the current stream before its first lookup;
* the current stream waits for a lookup's event before the tower reads
  its embeddings (an event per lookup, so the wait does not take in the
  next lookup, which is already queued behind it);
* the lookups' outputs, allocated on the side stream and read on the
  current one, are marked with ``record_stream`` for the caching
  allocator;
* the table updates stay on the current stream, after every lookup's
  event.

On the CPU the same code runs in order. The order of the streams changes
no bit of the result: the same operations read the same inputs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from hybridbackend_tpu_torch.embedding.sparse_update import (
    sparse_adagrad_apply, sparse_adam_apply)
from hybridbackend_tpu_torch.models.feature import (
    Batch, StackedFeatureExtractor)
from hybridbackend_tpu_torch.pipeline import _microbatches
from hybridbackend_tpu_torch.training.sparse_step import (
    ModelLoss, RawModelLoss, SparseTrainState, loss_from_raw)

_TABLE_OPTIMIZERS = ('adagrad', 'adam')


def _side_stream(device: torch.device) -> torch.cuda.Stream:
  """The stream the step's lookups run on."""
  return torch.cuda.Stream(device)


def _stitch(auxs):
  """JAX's stitch of the micro-batches' aux values (``:135-147``): a
  tensor of rank 1 or more concatenated along the batch axis, a scalar
  averaged (the first ``k - 1`` summed, the last added, then scaled)."""
  k = len(auxs)
  out = {}
  for key in auxs[-1]:
    vals = [a[key] for a in auxs]
    last = vals[-1]
    if not isinstance(last, torch.Tensor):
      out[key] = last
    elif last.dim():
      out[key] = torch.cat(vals)
    elif k == 1:
      out[key] = last
    else:
      out[key] = (torch.stack(vals[:-1]).sum() + last) * (1.0 / k)
  return out


def make_interleaved_train_step(
    fx: StackedFeatureExtractor, model_loss: Optional[ModelLoss],
    num_microbatches: int, table_lr: float = 0.05, *,
    table_optimizer: str = 'adagrad',
    raw_model_loss: Optional[RawModelLoss] = None
) -> Callable[[SparseTrainState, Batch], Tuple[SparseTrainState, Dict]]:
  """The pipelined ``make_sparse_train_step``: ``step(state, batch) ->
  (state, metrics)``, updating ``state`` in place.

  The batch splits into ``num_microbatches`` contiguous slices; every
  tensor column's leading dimension must divide by it (``ValueError``
  otherwise, as in JAX). ``model_loss`` and ``raw_model_loss`` are the
  two model hooks of ``make_sparse_train_step`` (pass one), both through
  ``loss_from_raw``. ``table_optimizer`` is ``'adagrad'`` (exact, with
  duplicate combining) or ``'adam'`` (LazyAdam; the state made with
  ``adam=True``). ``metrics['loss']`` is the micro-batches' mean, left on
  the device, with the ``model_loss`` aux values stitched as JAX does.
  Like the port's plain step this one takes no dense optimizer: the
  tower's optimizer is part of the state.
  """
  if table_optimizer not in _TABLE_OPTIMIZERS:
    raise ValueError(f'Unknown table_optimizer {table_optimizer!r}; '
                     f'expected one of {_TABLE_OPTIMIZERS}')
  if num_microbatches < 1:
    raise ValueError(
        f'num_microbatches must be at least 1, got {num_microbatches}')
  if fx.ctx.world_size > 1:
    raise NotImplementedError('the interleaved step in a world of more '
                              'than one rank is ROADMAP item 15b (7)')
  k = num_microbatches
  stacks_by_name = {s.stacked.name: s for s in fx.stacks}
  loss_of = loss_from_raw(fx, model_loss, raw_model_loss)
  streams: Dict[torch.device, torch.cuda.Stream] = {}

  def step(state: SparseTrainState, batch: Batch):
    mbs = _microbatches(batch, k)
    device = next(iter(state.tables.values())).device
    if device.type == 'cuda':
      current = torch.cuda.current_stream(device)
      side = streams.get(device)
      if side is None:
        side = streams[device] = _side_stream(device)
      # The previous step's updates wrote the tables on `current`.
      side.wait_stream(current)
    else:
      current = side = None

    def lookup(i):
      """Micro-batch ``i``'s lookup, enqueued on the side stream, and
      the event after it (None on the CPU)."""
      if side is None:
        return fx.lookup_raw(state.tables, mbs[i]) + (None,)
      with torch.cuda.stream(side):
        raw, ids, layouts = fx.lookup_raw(state.tables, mbs[i])
        done = torch.cuda.Event()
        done.record(side)
      return raw, ids, layouts, done

    state.dense_opt.zero_grad(set_to_none=True)
    pending = lookup(0)
    total, grads, ids_parts, auxs = None, [], [], []
    for i in range(k):
      raw, ids, layouts, done = pending
      if i + 1 < k:
        pending = lookup(i + 1)       # overlaps the tower below
      if done is not None:
        current.wait_event(done)
        for t in (*raw.values(), *ids.values()):
          t.record_stream(current)
      raw = {name: emb.detach().requires_grad_() for name, emb in raw.items()}
      loss, aux = loss_of(state.dense, raw, layouts, mbs[i])
      loss.backward()                 # tower gradients add up in .grad
      total = loss.detach() if total is None else total + loss.detach()
      grads.append({name: emb.grad if emb.grad is not None
                    else torch.zeros_like(emb) for name, emb in raw.items()})
      ids_parts.append(ids)
      auxs.append({key: v.detach() if isinstance(v, torch.Tensor) else v
                   for key, v in aux.items()})

    scale = 1.0 / k
    for p in state.dense.parameters():
      if p.grad is not None:
        p.grad.mul_(scale)
    state.dense_opt.step()

    # One row-sparse update a stack for the whole step: the slices are
    # contiguous, so their packed ids end to end are the batch's.
    for name in grads[-1]:
      ids = torch.cat([part[name] for part in ids_parts])
      demb = torch.cat([g[name] for g in grads]) * scale
      args = (state.tables[name], state.table_opt[name], ids, demb,
              stacks_by_name[name].stacked, table_lr)
      if table_optimizer == 'adam':
        sparse_adam_apply(*args, step=state.step + 1)
      else:
        sparse_adagrad_apply(*args)

    state.step += 1
    metrics = _stitch(auxs)
    metrics['loss'] = total * scale
    return state, metrics

  return step


__all__ = ['make_interleaved_train_step']
