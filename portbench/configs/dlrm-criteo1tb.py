"""``dlrm-criteo1tb``: the port's DLRM over 26 stacked tables.

Builds the port's model and sparse step for the sizes and settings in
``dlrm-criteo1tb.json`` and counts the matmul FLOPs a step requires.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import tower as tw
from portbench import train


def columns(cfg: dict) -> List[dict]:
  cols = [{'name': f'c{i}', 'kind': 'categorical', 'rows': rows,
           'dist': 'categorical'} for i, rows in enumerate(cfg['table_rows'])]
  cols += [{'name': f'i{j}', 'kind': 'dense', 'dist': 'dense'}
           for j in range(cfg['num_dense_features'])]
  return cols + [{'name': 'label', 'kind': 'label', 'dist': 'label'}]


def members(cfg: dict):
  """``[(name, rows)]`` in the stack's order."""
  return [(f'c{i}', rows) for i, rows in enumerate(cfg['table_rows'])]


def tower_layers(cfg: dict) -> List[tw.Layer]:
  bottom, top = cfg['bottom_mlp'], cfg['top_mlp']
  n = len(cfg['table_rows']) + 1
  layers = tw.mlp('bottom_mlp', cfg['num_dense_features'], bottom[:-1])
  layers.append(('bottom_out', bottom[-2], bottom[-1], None))
  return layers + tw.mlp('top_mlp', bottom[-1] + n * (n - 1) // 2, top)


def build(cfg: dict, ctx, fill, tower0: Dict[str, torch.Tensor]) -> dict:
  """The port's feature extractor, model and sparse step by the
  configuration's settings (``train.settings``): ``fill(fx, dtype)``
  makes the stacked tables, ``tower0`` the tower's weights."""
  import hybridbackend_tpu_torch as hbt
  s = train.settings(cfg)
  dim = cfg['embedding_dim']
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(name, rows, dim))
           for name, rows in members(cfg)]
  fx = hbt.StackedFeatureExtractor(
      specs, dense_columns=[f'i{j}' for j in range(cfg['num_dense_features'])],
      ctx=ctx)
  bottom = cfg['bottom_mlp']
  model = hbt.DLRM(cfg['num_dense_features'], len(specs), bottom[:-1],
                   bottom[-1], cfg['top_mlp'], device=ctx.device)
  tw.load(model, tower0)

  def model_loss(t, emb_f, dense_f, batch):
    p = torch.clamp(t(dense_f, emb_f), 1e-6, 1 - 1e-6)
    y = batch['label']
    return torch.mean(-(y * torch.log(p) + (1 - y) * torch.log(1 - p))), {}

  state, step = train.state_and_step(s, fx, model, fill(fx, s.table_dtype),
                                     ctx, model_loss=model_loss)
  return {'fx': fx, 'state': state, 'step': step}


def flops(cfg: dict, batch: Dict[str, torch.Tensor]) -> float:
  """Matmul and bmm FLOPs that a step's forward and backward require:
  each layer's forward, its weights' gradient and its input's gradient,
  but for the first bottom layer, whose input (the dense features)
  needs none; the interaction's bmm and the two of its backward."""
  b = batch['label'].shape[0]
  fwd = sum(2 * i * o for _, i, o, _ in tower_layers(cfg))
  first = 2 * cfg['num_dense_features'] * cfg['bottom_mlp'][0]
  n = len(cfg['table_rows']) + 1
  bmm = 2 * n * n * cfg['embedding_dim']
  return float(b * (3 * fwd - first + 3 * bmm))

