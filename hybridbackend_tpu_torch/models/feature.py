"""Feature extraction: batch columns to embedding and dense features.

Counterpart of ``hybridbackend_tpu/models/feature.py:24-204``:
``init_tables`` and ``extract_features``, one table per column (the
dense-gradient path), and ``EmbeddingSpec`` and
``StackedFeatureExtractor``, where all same-dim tables share one physical
table and one gather per step (the sparse path).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from hybridbackend_tpu_torch.embedding.lookup import lookup, lookup_sparse
from hybridbackend_tpu_torch.embedding.stack import (
    build_stacks, create_stacked_tables, pack_ids, unpack_embeddings)
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


def extract_features(tables: Mapping[str, torch.Tensor], batch: Batch,
                     specs: Sequence[EmbeddingSpec],
                     dense_columns: Sequence[str] = ()
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
  """``(embedding features, each [B, dim]; dense features, each [B, 1]
  float32)``. A ragged column (padded ids with ``<key>_mask`` in the
  batch) goes through ``lookup_sparse`` and its table's combiner; a
  fixed-width multivalent column without a mask is combined by mean."""
  emb_features = []
  for spec in specs:
    ids = batch[spec.key]
    table = tables[spec.name]
    mask_key = spec.key + '_mask'
    if ids.dim() >= 2 and mask_key in batch:
      emb = lookup_sparse(table, ids, batch[mask_key], spec.config)
    else:
      emb = lookup(table, ids, spec.config)
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
  stack of same-dim tables."""

  def __init__(self, specs: Sequence[EmbeddingSpec],
               dense_columns: Sequence[str] = (), *, ctx: Context):
    self.specs = list(specs)
    self.dense_columns = list(dense_columns)
    self.ctx = ctx
    self.stacks = build_stacks([s.config for s in self.specs])

  def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One physical table per stack, on the context's device."""
    return create_stacked_tables(self.stacks, generator, self.ctx.device)

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

  def lookup_raw(self, tables: Dict[str, torch.Tensor], batch: Batch):
    """One lookup per stack; returns the uncombined embeddings and the
    packed ids (the sparse update needs both).

    Returns ``(raw_by_stack {stack: [B, K, D]}, ids_by_stack {stack:
    [B, K]}, layouts {stack: layout})``."""
    raw, ids_out, layouts = {}, {}, {}
    member_ids = self.member_ids(batch)
    for stack in self.stacks:
      name = stack.stacked.name
      if name not in member_ids:
        continue
      all_ids, layout = pack_ids(stack, member_ids[name])
      raw[name] = lookup(tables[name], all_ids, stack.stacked)
      ids_out[name] = all_ids
      layouts[name] = layout
    return raw, ids_out, layouts

  def combine_from_raw(self, raw_by_stack, layouts, batch: Batch
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Differentiable combine: raw embeddings to per-spec features
    (multivalent columns go through their combiner), plus the dense
    columns as ``[B, 1]`` float32 features."""
    raw: Dict[str, torch.Tensor] = {}
    for stack in self.stacks:
      name = stack.stacked.name
      if name in raw_by_stack:
        raw.update(unpack_embeddings(stack, raw_by_stack[name],
                                     layouts[name]))
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
