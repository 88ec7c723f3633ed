"""Feature extraction: batch columns to embedding and dense features.

Counterpart of ``hybridbackend_tpu/models/feature.py:24-204``:
``init_tables`` and ``extract_features``, one table per column (the
dense-gradient path), and ``EmbeddingSpec`` and
``StackedFeatureExtractor``, where all same-dim tables share one physical
table and one gather per step (the sparse path).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from hybridbackend_tpu_torch.embedding.lookup import (
    Table, lookup, lookup_sparse)
from hybridbackend_tpu_torch.embedding.stack import (
    TableStack, build_stacks, create_stacked_tables, pack_ids,
    unpack_embeddings)
from hybridbackend_tpu_torch.embedding.table import TableConfig, create_table
from hybridbackend_tpu_torch.framework.context import Context

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
  """One categorical feature backed by an embedding table.

  ``column`` is the batch key holding ids; multivalent columns may carry
  a validity mask under ``column + '_mask'``, combined by
  ``config.combiner``."""
  config: TableConfig
  column: Optional[str] = None

  @property
  def name(self) -> str:
    return self.config.name

  @property
  def key(self) -> str:
    return self.column or self.config.name


def init_tables(specs: Sequence[EmbeddingSpec], generator: torch.Generator,
                device: torch.device) -> nn.ParameterDict:
  """One ``[padded_vocab, dim]`` table per spec, drawn in spec order from
  ``generator``, as the parameters of a module keyed by table name (the
  JAX function's params subtree)."""
  return nn.ParameterDict({
      spec.name: nn.Parameter(create_table(spec.config, generator, device))
      for spec in specs})


def extract_features(tables: Mapping[str, Table], batch: Batch,
                     specs: Sequence[EmbeddingSpec],
                     dense_columns: Sequence[str] = (),
                     serving: bool = False
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
  """``(embedding features, each [B, dim]; dense features, each [B, 1]
  float32)``. A ragged column (padded ids with ``<key>_mask`` in the
  batch) goes through ``lookup_sparse`` and its table's combiner; a
  fixed-width multivalent column without a mask is combined by mean.
  ``serving=True`` (the exported serving function) gathers through
  kernel 5, as ``lookup`` says; a table may be a ``QuantizedTable``."""
  emb_features = []
  for spec in specs:
    ids = batch[spec.key]
    table = tables[spec.name]
    mask_key = spec.key + '_mask'
    if ids.dim() >= 2 and mask_key in batch:
      emb = lookup_sparse(table, ids, batch[mask_key], spec.config,
                          serving=serving)
    else:
      emb = lookup(table, ids, spec.config, serving)
      if emb.dim() > 2:
        emb = torch.mean(emb, dim=-2)
    emb_features.append(emb)
  dense_features = []
  for col in dense_columns:
    v = batch[col]
    if v.dim() == 1:
      v = v[:, None]
    dense_features.append(v.to(torch.float32))
  return emb_features, dense_features


class StackedFeatureExtractor:
  """Batch columns to embedding and dense features, one fused lookup per
  stack of same-dim tables.

  In a world of more than one rank (``ctx``) a stack is row-sharded or
  replicated by the tables' shard policy, with ``min_shard_rows`` (the
  JAX option ``emb_min_shard_rows``); the tables are then each rank's
  shards, and a batch is the rank's rows of the global batch."""

  def __init__(self, specs: Sequence[EmbeddingSpec],
               dense_columns: Sequence[str] = (), *, ctx: Context,
               min_shard_rows: int = 0):
    self.specs = list(specs)
    self.dense_columns = list(dense_columns)
    self.ctx = ctx
    self.stacks = build_stacks([s.config for s in self.specs], ctx,
                               min_shard_rows)
    self._stack_of = {cfg.name: stack for stack in self.stacks
                      for cfg in stack.configs}

  def stack_of(self, name: str) -> TableStack:
    """The stack that holds the member table ``name``."""
    return self._stack_of[name]

  def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One physical table per stack, on the context's device: this
    rank's shard of a sharded stack."""
    return create_stacked_tables(self.stacks, generator, self.ctx.device,
                                 self.ctx)

  def member_ids(self, batch: Batch) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-stack ``{member_name: ids}`` present in the batch."""
    by_name = {s.config.name: s for s in self.specs}
    out = {}
    for stack in self.stacks:
      ids_by_name = {cfg.name: batch[by_name[cfg.name].key]
                     for cfg in stack.configs
                     if by_name[cfg.name].key in batch}
      if ids_by_name:
        out[stack.stacked.name] = ids_by_name
    return out

  def lookup_raw(self, tables: Dict[str, torch.Tensor], batch: Batch,
                 strategy: Union[str, Mapping[str, str]] = 'allgather',
                 **exchange):
    """One lookup per stack; returns the uncombined embeddings and the
    packed ids (the sparse update needs both).

    A sharded stack is looked up through the exchange ``strategy``
    names: one for all stacks, or ``{stack name: strategy}`` (the JAX
    per-table ``emb_lookup_strategy``; a stack it leaves out takes
    ``'allgather'``); ``exchange`` holds ``lookup``'s other options
    (``bucket_ratio``, ``overflow_fallback``, ``unique_ratio``).

    Returns ``(raw_by_stack {stack: [B, K, D]}, ids_by_stack {stack:
    [B, K]}, layouts {stack: layout})``."""
    raw, ids_out, layouts = {}, {}, {}
    member_ids = self.member_ids(batch)
    for stack in self.stacks:
      name = stack.stacked.name
      if name not in member_ids:
        continue
      all_ids, layout = pack_ids(stack, member_ids[name])
      strat = (strategy if isinstance(strategy, str)
               else strategy.get(name, 'allgather'))
      raw[name] = lookup(tables[name], all_ids, stack.stacked, ctx=self.ctx,
                         strategy=strat, **exchange)
      ids_out[name] = all_ids
      layouts[name] = layout
    return raw, ids_out, layouts

  def members_from_raw(self, raw_by_stack, layouts
                       ) -> Dict[str, torch.Tensor]:
    """The uncombined embeddings of each member table, ``{name: [B, ...,
    D]}`` in its id column's shape (a ``[B]`` column gives ``[B, D]``):
    views of the stacks' raw ``[B, K, D]`` embeddings, so gradients flow
    back to them."""
    members: Dict[str, torch.Tensor] = {}
    for stack in self.stacks:
      name = stack.stacked.name
      if name in raw_by_stack:
        members.update(unpack_embeddings(stack, raw_by_stack[name],
                                         layouts[name]))
    return members

  def combine_from_raw(self, raw_by_stack, layouts, batch: Batch
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Differentiable combine: raw embeddings to per-spec features
    (multivalent columns go through their combiner), plus the dense
    columns as ``[B, 1]`` float32 features."""
    raw = self.members_from_raw(raw_by_stack, layouts)
    emb_features = []
    for spec in self.specs:
      emb = raw[spec.config.name]
      if emb.dim() == 3:
        mask = batch.get(spec.key + '_mask')
        m = (torch.ones(emb.shape[:2], dtype=emb.dtype, device=emb.device)
             if mask is None else mask.to(emb.dtype))
        total = torch.sum(emb * m.unsqueeze(-1), dim=-2)
        count = torch.clamp(torch.sum(m, dim=-1, keepdim=True), min=1e-9)
        combiner = spec.config.combiner
        if combiner == 'sum':
          emb = total
        elif combiner == 'mean':
          emb = total / count
        elif combiner == 'sqrtn':
          emb = total / torch.sqrt(count)
        else:
          raise ValueError(f'Unknown combiner: {combiner!r}')
      emb_features.append(emb)
    dense_features = []
    for col in self.dense_columns:
      v = batch[col]
      if v.dim() == 1:
        v = v.unsqueeze(1)
      dense_features.append(v.to(torch.float32))
    return emb_features, dense_features

  def __call__(self, tables: Dict[str, torch.Tensor], batch: Batch
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    raw, _, layouts = self.lookup_raw(tables, batch)
    return self.combine_from_raw(raw, layouts, batch)


__all__ = ['EmbeddingSpec', 'StackedFeatureExtractor', 'extract_features',
           'init_tables']
