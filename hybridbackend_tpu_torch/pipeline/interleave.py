"""Interleaved sparse and dense execution (PICASSO packing and interleaving).

Counterpart of ``hybridbackend_tpu/pipeline/interleave.py:32-171``
(``make_interleaved_train_step``), at a world of one device or of N
ranks. The PICASSO paper's second pillar overlaps one micro-batch's
embedding lookup with the previous micro-batch's dense compute; the
reference does it with separate CUDA streams, the JAX step by leaving
two independent subgraphs of one ``lax.scan`` to XLA's scheduler. Here
it is streams again: on a CUDA device every micro-batch's lookup is
enqueued on a side stream of the step's own, and the towers on the
current stream.

The semantics are JAX's, exact accumulate-then-apply: every micro-batch
looks up the same table version; the tower's gradients are summed over
the micro-batches and scaled by ``1 / num_microbatches``, and its
optimizer steps once; the micro-batches' embedding gradients are
concatenated along the batch axis, scaled the same way, and go with the
whole batch's packed ids into ONE row-sparse update a stack (kernel 1
for Adagrad, kernel 3 for LazyAdam), the same update list as the plain
step's.

In a world of N ranks (the feature extractor's context) each rank runs
the step on its rows ``[r·B/W, (r+1)·B/W)`` of the global batch, as the
plain step does (``training/sparse_step.py``), and cuts them into the
``k`` micro-batches; each micro-batch is looked up through the sharded
exchange that ``lookup_strategy`` names. The tower's gradients, summed
over the micro-batches, go through one all-reduce in
``gradient_wire_dtype`` to their mean over the ranks, then are scaled by
``1/k``; the embeddings' gradients are scaled by ``1/(W·k)`` and routed
to the owners by ``update_exchange``, once a step a stack, as JAX's
``sparse_*_apply(..., ctx=ctx)`` at ``:152-177``. The scalar metrics are
means over the ranks; per-example aux values come back in each rank's
order. JAX slices the global batch into ``k`` contiguous parts and
shards each over the devices (``:69-73``), where the port slices each
rank's rows: both are exact accumulate-then-apply over one table
version, so the steps agree up to the order of summation, not bit for
bit.

The streams' hazards, each handled where it arises:

* the previous step's table update writes the tables in place on the
  current stream (``ops/build.py`` launches every kernel there), so the
  side stream waits for the current stream before its first lookup;
* the current stream waits for a lookup's event before the tower reads
  its embeddings (an event per lookup, so the wait does not take in the
  next lookup, which may already be queued behind it);
* the lookups' outputs, allocated on the side stream and read on the
  current one, are marked with ``record_stream`` for the caching
  allocator;
* the table updates and the tower's all-reduce stay on the current
  stream, after every lookup's event;
* in a world, a lookup's collectives are called with the side stream
  current (NCCL waits on the stream that is current at the call, and
  gloo's copies of a CUDA tensor follow it too), and every rank issues
  the same collectives in the same order, since every rank runs the same
  loop;
* in a world a lookup may block the host: the ``alltoall`` and
  ``hierarchical`` exchanges and ``unique_ratio < 1`` read an
  all-reduced overflow predicate there (``lookup._global_any``), and a
  gloo collective (called synchronously) returns when it has run. So in
  a world micro-batch ``i``'s forward and backward are enqueued first
  and micro-batch ``i + 1``'s lookup after them: the device runs the
  tower while the host waits. At a world of one no lookup blocks the
  host, and micro-batch ``i + 1``'s lookup is enqueued before micro-batch
  ``i``'s tower, so that the device may run both at once.

On the CPU the same code runs in order. The order of the streams changes
no bit of the result: the same operations read the same inputs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.models.feature import (
    Batch, StackedFeatureExtractor)
from hybridbackend_tpu_torch.pipeline import _microbatches
from hybridbackend_tpu_torch.training.sparse_step import (
    ModelLoss, RawModelLoss, SparseTrainState, _detached_metrics,
    _exchange_options, _mean_tower_grads, _table_grad, _update_tables,
    loss_from_raw)

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
    raw_model_loss: Optional[RawModelLoss] = None,
    lookup_strategy: str = 'allgather',
    lookup_bucket_ratio: float = 2.0,
    update_exchange: str = 'alltoall',
    update_bucket_ratio: float = 2.0,
    overflow_fallback: bool = True,
    unique_ratio: float = 1.0,
    wire_dtype: collective.WireDtype = None,
    gradient_wire_dtype: collective.WireDtype = None
) -> Callable[[SparseTrainState, Batch], Tuple[SparseTrainState, Dict]]:
  """The pipelined ``make_sparse_train_step``: ``step(state, batch) ->
  (state, metrics)``, updating ``state`` in place.

  The batch (in a world, the rank's rows) splits into
  ``num_microbatches`` contiguous slices; every tensor column's leading
  dimension must divide by it (``ValueError`` otherwise, as in JAX; in a
  world the error names the rank's rows). ``model_loss`` and
  ``raw_model_loss`` are the two model hooks of ``make_sparse_train_step``
  (pass one), both through ``loss_from_raw``. ``table_optimizer`` is
  ``'adagrad'`` (exact, with duplicate combining) or ``'adam'``
  (LazyAdam; the state made with ``adam=True``). ``lookup_strategy`` and
  the other exchange keywords are ``make_sparse_train_step``'s, used in a
  world of more than one rank only (JAX reads the same values from
  ``OPTIONS``). ``metrics['loss']`` is the micro-batches' mean (in a
  world, the ranks' mean), left on the device, with the ``model_loss``
  aux values stitched as JAX does. Like the port's plain step this one
  takes no dense optimizer: the tower's optimizer is part of the state.
  """
  if table_optimizer not in _TABLE_OPTIMIZERS:
    raise ValueError(f'Unknown table_optimizer {table_optimizer!r}; '
                     f'expected one of {_TABLE_OPTIMIZERS}')
  if num_microbatches < 1:
    raise ValueError(
        f'num_microbatches must be at least 1, got {num_microbatches}')
  k = num_microbatches
  ctx = fx.ctx
  world = ctx.world_size
  stacks_by_name = {s.stacked.name: s for s in fx.stacks}
  loss_of = loss_from_raw(fx, model_loss, raw_model_loss)
  exchange, update = _exchange_options(
      ctx, lookup_bucket_ratio=lookup_bucket_ratio,
      update_exchange=update_exchange,
      update_bucket_ratio=update_bucket_ratio,
      overflow_fallback=overflow_fallback, unique_ratio=unique_ratio,
      wire_dtype=wire_dtype, gradient_wire_dtype=gradient_wire_dtype)
  streams: Dict[torch.device, torch.cuda.Stream] = {}
  # Whether micro-batch i + 1's lookup is enqueued before micro-batch i's
  # tower (at a world of one) or after it (in a world; see above).
  early = world == 1

  def step(state: SparseTrainState, batch: Batch):
    if world > 1:
      for key, col in batch.items():
        if isinstance(col, torch.Tensor) and col.dim() and col.shape[0] % k:
          raise ValueError(
              f'Batch column {key!r}: rank {ctx.rank}\'s {col.shape[0]} '
              f'rows do not divide by num_microbatches={k}')
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
      """Micro-batch ``i``'s lookup, enqueued on the side stream (the
      current stream inside it, for the exchange's collectives), and the
      event after it (None on the CPU)."""
      if side is None:
        return fx.lookup_raw(state.tables, mbs[i], lookup_strategy,
                             **exchange) + (None,)
      with torch.cuda.stream(side):
        raw, ids, layouts = fx.lookup_raw(state.tables, mbs[i],
                                          lookup_strategy, **exchange)
        done = torch.cuda.Event()
        done.record(side)
      return raw, ids, layouts, done

    state.dense_opt.zero_grad(set_to_none=True)
    pending = lookup(0)
    total, grads, ids_parts, auxs = None, [], [], []
    for i in range(k):
      raw, ids, layouts, done = pending
      if early and i + 1 < k:
        pending = lookup(i + 1)       # overlaps the tower below
      if done is not None:
        current.wait_event(done)
        for t in (*raw.values(), *ids.values()):
          t.record_stream(current)
      raw = {name: emb.detach().requires_grad_() for name, emb in raw.items()}
      loss, aux = loss_of(state.dense, raw, layouts, mbs[i])
      loss.backward()                 # tower gradients add up in .grad
      if not early and i + 1 < k:
        # After the tower is enqueued: the lookup may wait on the host
        # for its exchange, while the device runs the tower.
        pending = lookup(i + 1)
      total = loss.detach() if total is None else total + loss.detach()
      grads.append({name: emb.grad if emb.grad is not None
                    else torch.zeros_like(emb) for name, emb in raw.items()})
      ids_parts.append(ids)
      auxs.append({key: v.detach() if isinstance(v, torch.Tensor) else v
                   for key, v in aux.items()})

    scale = 1.0 / k
    if world > 1:
      _mean_tower_grads(state.dense, ctx, gradient_wire_dtype)
    for p in state.dense.parameters():
      if p.grad is not None:
        p.grad.mul_(scale)
    state.dense_opt.step()

    # One row-sparse update a stack for the whole step: the slices are
    # contiguous, so their packed ids end to end are the batch's.
    _update_tables(
        state,
        {name: _table_grad(torch.cat([g[name] for g in grads]) * scale, world)
         for name in grads[-1]},
        {name: torch.cat([part[name] for part in ids_parts])
         for name in grads[-1]},
        stacks_by_name, table_lr, table_optimizer, update)

    state.step += 1
    return state, _detached_metrics(_stitch(auxs), total * scale, ctx)

  return step


__all__ = ['make_interleaved_train_step']
