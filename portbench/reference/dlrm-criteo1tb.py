"""Plain reference of ``dlrm-criteo1tb``: DLRM (Naumov et al., 2019) as
facebookresearch/dlrm's Criteo Terabyte script defines it.

Bottom MLP over ``log1p(max(x, 0))`` of the 13 dense features (relu
throughout, ending at the embedding width), the dot interaction of the
27 vectors (the bottom output and the 26 embeddings: every pair ``i <
j``, row-major, after the bottom output), the top MLP (relu, a sigmoid
on its one output) and the mean binary cross-entropy. Parameter names
are the benchmark's (``<layer>.w: [in, out]``, ``<layer>.b``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import common


def members(cfg: dict):
  return [(f'c{i}', i) for i in range(len(cfg['table_rows']))]


def member_ids(cfg: dict):
  def ids(b):
    return {f'c{i}': b[f'c{i}'] for i in range(len(cfg['table_rows']))}
  return ids


def forward(cfg: dict):
  n_tables = len(cfg['table_rows'])
  n_bottom = len(cfg['bottom_mlp'])
  n_top = len(cfg['top_mlp'])

  def loss(ops: common.Ops, p: Dict[str, torch.Tensor],
           emb: Dict[str, torch.Tensor], b) -> torch.Tensor:
    x = torch.stack([b[f'i{j}'] for j in range(cfg['num_dense_features'])],
                    dim=1).float()
    x = torch.log1p(torch.clamp(x, min=0.0))
    for i in range(n_bottom - 1):
      x = common.dense(ops, p, f'bottom_mlp.layers.{i}', x, torch.relu)
    bottom = common.dense(ops, p, 'bottom_out', x, torch.relu)
    s = torch.stack([bottom] + [emb[f'c{i}'] for i in range(n_tables)], 1)
    z = ops.bmm(s, s.transpose(1, 2))
    n = n_tables + 1
    iu, ju = torch.triu_indices(n, n, offset=1, device=z.device)
    y = torch.cat([bottom, z[:, iu, ju]], dim=1)
    for i in range(n_top):
      act = torch.sigmoid if i == n_top - 1 else torch.relu
      y = common.dense(ops, p, f'top_mlp.layers.{i}', y, act)
    return common.bce(y[:, 0], b['label'])

  return loss


def run(cfg: dict, seed: int, batches: List[dict],
        tower0: Dict[str, torch.Tensor], precision: str = 'f32',
        half_batch: bool = False) -> dict:
  """The snapshot of three steps from the benchmark's inputs
  (``common.train3``)."""
  return common.train3(cfg, seed, batches, tower0, members(cfg),
                       member_ids(cfg), forward(cfg), precision, half_batch)
