"""Cost-model sharding planner for embedding tables.

Counterpart of ``hybridbackend_tpu/embedding/planner.py:58-247``: a
per-table analytic model of the bytes that each placement moves per step
and holds per rank, and a plan of the cheapest placement per table
(``plan_sharding``), which :func:`plan_options` turns into the port's
explicit arguments: ``TableConfig(sharded=...)`` and the stacks' lookup
``strategy`` (``StackedFeatureExtractor.lookup_raw(strategy={...})``,
``SparseTrainer(lookup_strategy=...)``); a column partition is reported
for the caller to set on the config (``partition='column'``).

The byte formulas are re-derived from the port's own exchanges
(``embedding/lookup.py``, ``embedding/sparse_update.py:
_rowsharded_update``), per rank and step. ``W`` is the world, ``B`` the
global batch's flat ids, ``b = B/W`` a rank's, ``D`` the dim, ``V`` the
vocab, ``r = D·itemsize`` a row's bytes in the table's dtype (the port's
tables are logical ``[V, D]``: no 128-lane padding, which JAX counts for
an unpacked TPU table, ``_phys_row_bytes``), an id 4 bytes (int32 on the
wire), ``s`` the bucket slack (``bucket_ratio``) and ``f = (W-1)/W``, the
share of a ring collective's payload that leaves a rank
(``benchmarks/collective_benchmark.py:wire_bytes``):

* replicated: holds ``V·r``; the lookup is local; the sparse update
  all-gathers every rank's list ``f·B·(4 + r)``, the dense path
  all-reduces the ``[V, D]`` gradient ``2·f·V·r``; the model takes the
  cheaper;
* row-sharded, allgather: holds ``V·r/W``; the lookup all-gathers the ids
  ``f·B·4`` and reduce-scatters the rows ``f·B·r``, its backward
  all-gathers the gradients ``f·B·r``; the update's alltoall buckets
  (``s·b`` lanes of an id and a gradient row) move ``f·s·b·(4 + r)``;
* row-sharded, alltoall: the ids out ``f·s·b·4``, the rows back
  ``f·s·b·r``, the gradients back ``f·s·b·r``, and the update as above;
* row-sharded, hierarchical: the lookup's two hops, over the ``L``
  ranks of a node and then the ``M = W/L`` nodes, each move the ids out
  and the rows and gradients back at its own ring share, ``(L-1)/L`` and
  ``(M-1)/M``: the first hop ``L`` buckets of ``ceil(s·b/L)`` lanes, the
  second ``M`` of ``ceil(s·b/M)``; a hop whose capacity would reach
  ``b`` takes every lane instead (``lookup._cap``), the second then all
  of the first hop's. The update is the flat alltoall's. With one node
  it is the alltoall strategy's bytes, as JAX models it; the planner
  never picks it on bytes: its gain is that the first hop stays inside a
  node;
* column-sharded: holds ``V·r/W``; the lookup all-gathers the ids
  ``f·B·4`` and all-to-alls each rank's ``D/W`` slice of every row,
  ``f·B·r/W``, its backward the same slices back, and the update
  all-gathers the ids and all-to-alls the gradients' slices:
  ``f·B·(8 + 3·r/W)`` in all. (JAX's ``_cost_column`` counts the whole
  row, ``f·B·D·4``, where the all-to-all moves a ``D/W`` slice.)

The small collectives beside these (the all-to-alls of the bucket sizes,
the all-reduced overflow flag) are not modelled;
``tests/test_torch_planner.py`` counts every byte the port's collectives
put on the wire and holds these formulas within JAX's factor of 1.25.

**The latency floor is an argument.** JAX adds ``HOP = 45·1024`` bytes a
collective (a v5e ICI hop, ``:179-183``). No measurement of NCCL across
H100s exists (the machine this port is measured on has one card), so
``hop_bytes=0`` by default lets the bytes alone decide; pass a floor
measured on the cards at hand (``benchmarks/collective_benchmark.py``
times each collective by size). ``MEM_W``, ``bucket_slack`` and
``column_min_dim`` keep JAX's values. JAX's reason for ``column_min_dim``
(a narrow per-rank slice underfills the TPU's 128 lanes) does not carry
over to the card, and no H100 measurement sets it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence

import torch

from hybridbackend_tpu_torch.framework.context import Context

ID_BYTES = 4     # ids and rows travel as int32
# A byte held costs a hundredth of a byte moved a step (JAX's MEM_W):
# replication does not win on traffic alone for a giant table.
MEM_W = 0.01


@dataclasses.dataclass(frozen=True)
class TablePlan:
  """The placement chosen for one table."""
  sharded: bool
  partition: str          # 'row' or 'column'
  strategy: str           # the lookup's exchange when sharded
  hbm_bytes_per_device: int
  comm_bytes_per_step: int


def _ring(w):
  return (w - 1) / max(w, 1)


def row_bytes(config) -> int:
  """A table row's bytes: ``dim`` times the itemsize of the config's
  ``dtype`` (float32 when it has none)."""
  dtype = getattr(config, 'dtype', torch.float32)
  return config.dim * torch.empty((), dtype=dtype).element_size()


def _cost_replicated(v, r, b, w=1, backward='auto'):
  """``backward``: ``'sparse'``, the sparse update's all-gather of every
  rank's (ids, gradients); ``'dense'``, the dense path's all-reduce of
  the ``[V, D]`` gradient; ``'auto'``, the cheaper."""
  f = _ring(w)
  sparse = f * b * (ID_BYTES + r)
  dense = 2 * f * v * r
  comm = {'sparse': sparse, 'dense': dense,
          'auto': min(sparse, dense)}[backward]
  return v * r, int(comm)


def _update_bytes(b, w, slack, r):
  """The alltoall update's buckets: ``s·b`` lanes of an id and a
  gradient row (``sparse_update._update_bucket_cap``)."""
  return _ring(w) * slack * (b / max(w, 1)) * (ID_BYTES + r)


def _cost_row_allgather(v, r, b, w, slack):
  f = _ring(w)
  lookup = f * (b * ID_BYTES + b * r) + f * b * r
  return v * r // w, int(lookup + _update_bytes(b, w, slack, r))


def _cost_row_alltoall(v, r, b, w, slack):
  lanes = max(1.0, slack * b / max(w, 1))
  lookup = _ring(w) * lanes * (ID_BYTES + 2 * r)
  return v * r // w, int(lookup + _update_bytes(b, w, slack, r))


def _hop_lanes(b_local, slack, local, nodes):
  """The lanes of the hierarchical lookup's two hops, as the port fills
  them (``lookup._lookup_hierarchical``): ``local`` buckets of
  ``ceil(s·b/local)`` ids, or of all ``b`` when that is no fewer, then
  ``nodes`` buckets of ``ceil(s·b/nodes)``, or of all the first hop's
  lanes."""
  def cap(buckets):
    c = math.ceil(slack * b_local / buckets) if slack > 0 else b_local
    return c if c < b_local else None
  first = local * (cap(local) or b_local)
  return first, nodes * (cap(nodes) or first)


def _cost_row_hierarchical(v, r, b, w, slack, nodes=1):
  """Two hops: ``w // nodes`` ranks of a node, then ``nodes``."""
  local = w // nodes
  first, second = _hop_lanes(b / max(w, 1), slack, local, nodes)
  lookup = (_ring(local) * first + _ring(nodes) * second) * (
      ID_BYTES + 2 * r)
  return v * r // w, int(lookup + _update_bytes(b, w, slack, r))


def _cost_column(v, r, b, w):
  f = _ring(w)
  return v * r // w, int(f * b * (2 * ID_BYTES + 3 * r / w))


def plan_sharding(configs: Sequence,
                  global_batch_ids: Mapping[str, int],
                  unique_fraction: Optional[Mapping[str, float]] = None,
                  hbm_budget_bytes: Optional[int] = None,
                  bucket_slack: float = 2.0,
                  column_min_dim: int = 256,
                  ctx: Optional[Context] = None, *,
                  world_size: Optional[int] = None,
                  hop_bytes: int = 0) -> Dict[str, TablePlan]:
  """The cheapest placement of each table, by the byte model above.

  Args:
    configs: ``TableConfig``s (``name``, ``vocab_size``, ``dim`` and
      ``dtype`` are read).
    global_batch_ids: each table's flat ids per global step (the batch
      times the column's mean length).
    unique_fraction: accepted as in JAX and not used: the buckets'
      capacities are fixed, so the bytes do not depend on how many ids
      are distinct (JAX ``:104-109``).
    hbm_budget_bytes: a rank's budget for replicated tables: a replica
      that does not fit what is left of it is sharded.
    bucket_slack: the alltoall buckets' slack (``bucket_ratio``).
    column_min_dim: column sharding is considered from this dim up.
    ctx, world_size: the world (``world_size`` wins; a world of one when
      neither is given): at a world of one nothing is sharded.
    hop_bytes: a latency floor, in bytes, added for each collective a
      placement runs (JAX counts 1 for a replica, 4 for allgather, 8 for
      alltoall and 3 for a column table); 0 by default (see above).

  Returns ``{table name: TablePlan}``; :func:`plan_options` turns it into
  the port's arguments.
  """
  del unique_fraction
  w = world_size or (ctx.world_size if ctx is not None else 1)
  plans: Dict[str, TablePlan] = {}
  budget = hbm_budget_bytes
  # The smallest tables first, so that the replicas' budget goes to the
  # small hot tables, which gain the most a byte.
  for cfg in sorted(configs, key=lambda c: c.vocab_size * c.dim):
    v, r = cfg.vocab_size, row_bytes(cfg)
    b = int(global_batch_ids.get(cfg.name, 0)) or 1
    if w <= 1:
      plans[cfg.name] = TablePlan(False, 'row', 'allgather', v * r, 0)
      continue
    candidates = {}
    mem, comm = _cost_replicated(v, r, b, w)
    if budget is None or mem <= budget:
      candidates[('replicated', 'row', 'allgather')] = (mem,
                                                        comm + hop_bytes)
    mem, comm = _cost_row_allgather(v, r, b, w, bucket_slack)
    candidates[('sharded', 'row', 'allgather')] = (mem, comm + 4 * hop_bytes)
    mem, comm = _cost_row_alltoall(v, r, b, w, bucket_slack)
    candidates[('sharded', 'row', 'alltoall')] = (mem, comm + 8 * hop_bytes)
    if cfg.dim >= column_min_dim:
      mem, comm = _cost_column(v, r, b, w)
      candidates[('sharded', 'column', 'allgather')] = (
          mem, comm + 3 * hop_bytes)
    (kind, part, strategy), (mem, comm) = min(
        candidates.items(), key=lambda kv: kv[1][1] + MEM_W * kv[1][0])
    if kind == 'replicated' and budget is not None:
      budget -= mem
    plans[cfg.name] = TablePlan(kind == 'sharded', part, strategy, mem, comm)
  return plans


def plan_options(plans: Mapping[str, TablePlan]) -> Dict[str, Dict]:
  """A plan as the port's explicit arguments (JAX
  ``plan_scope_options``)::

      opts = plan_options(plans)
      configs = [dataclasses.replace(c, sharded=opts['sharded'][c.name],
                                     partition=opts['partition'][c.name])
                 for c in configs]
      fx = StackedFeatureExtractor(specs_of(configs), ctx=ctx)
      fx.lookup_raw(tables, batch, strategy={stack.stacked.name:
          opts['strategy'][stack.configs[0].name] for stack in fx.stacks})

  ``'sharded'`` is each table's ``TableConfig(sharded=...)``,
  ``'strategy'`` its lookup's exchange, by table name (a stack's
  members share one exchange: key it by the stack's name), and
  ``'partition'`` the partition the plan chose, reported for the caller
  to set on the config, as JAX reports it."""
  return {'sharded': {name: p.sharded for name, p in plans.items()},
          'strategy': {name: p.strategy for name, p in plans.items()},
          'partition': {name: p.partition for name, p in plans.items()}}


__all__ = ['TablePlan', 'plan_options', 'plan_sharding', 'row_bytes']
