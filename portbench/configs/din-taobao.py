"""``din-taobao``: the port's DIN in the sparse step's raw mode.

Builds the port's model and sparse step for the sizes and settings in
``din-taobao.json`` and counts the matmul FLOPs a step requires, over
the valid history positions only. The candidate and each history entry
are their item's embedding beside their category's (DeepCTR's
``history_feature_list``), so the attention and the pooled history are
``2 * embedding_dim`` wide.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import tower as tw
from portbench import train

# What the port's DIN implements (``models/ranking.py``).
_IMPLEMENTED = {'history_features': ['item', 'category'],
                'attention_activation': 'sigmoid', 'dnn_activation': 'relu',
                'dnn_use_bn': False}


def columns(cfg: dict) -> List[dict]:
  return [
      {'name': 'cand_hist', 'kind': 'sequence', 'rows': cfg['item_rows'],
       'dist': 'item', 'length': 'history', 'mask': 'hist_mask'},
      {'name': 'cate_hist', 'kind': 'mapped', 'of': 'cand_hist',
       'of_rows': cfg['item_rows'], 'rows': cfg['category_rows'],
       'dist': 'category'},
      {'name': 'user', 'kind': 'categorical', 'rows': cfg['user_rows'],
       'dist': 'user'},
      {'name': 'label', 'kind': 'label', 'dist': 'label'}]


def members(cfg: dict):
  """``[(name, rows)]`` in the stack's order."""
  return [('item', cfg['item_rows']), ('category', cfg['category_rows']),
          ('user', cfg['user_rows'])]


def _query_dim(cfg: dict) -> int:
  return cfg['embedding_dim'] * len(cfg['history_features'])


def _dnn_in(cfg: dict) -> int:
  # The candidate, the pooled history and the user's embedding.
  return 2 * _query_dim(cfg) + cfg['embedding_dim']


def tower_layers(cfg: dict) -> List[tw.Layer]:
  layers = tw.mlp('attention.mlp', 4 * _query_dim(cfg),
                  [*cfg['attention_mlp'], 1])
  layers += tw.mlp('dnn', _dnn_in(cfg), cfg['dnn'])
  return layers + [('head', cfg['dnn'][-1], 1, 0.0)]


def build(cfg: dict, ctx, fill, tower0: Dict[str, torch.Tensor]) -> dict:
  """The port's feature extractor, DIN and raw-mode sparse step by the
  configuration's settings (``train.settings``): ``fill(fx, dtype)``
  makes the stacked table, ``tower0`` the tower's weights."""
  import hybridbackend_tpu_torch as hbt
  for key, want in _IMPLEMENTED.items():
    if cfg[key] != want:
      raise ValueError(f'{key} = {cfg[key]!r}: the port\'s DIN implements '
                       f'only {want!r}')
  s = train.settings(cfg)
  dim = cfg['embedding_dim']
  item = hbt.TableConfig('item', cfg['item_rows'], dim)
  category = hbt.TableConfig('category', cfg['category_rows'], dim)
  user = hbt.TableConfig('user', cfg['user_rows'], dim)
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(item, column='cand_hist'),
       hbt.EmbeddingSpec(category, column='cate_hist'),
       hbt.EmbeddingSpec(user)], ctx=ctx)
  # The user's embedding joins the DNN's input after the candidate and
  # the pooled history, through the slot the port's DIN gives dense
  # features: its profile slot is as wide as the query.
  model = hbt.DIN(_query_dim(cfg), 0, dim, cfg['dnn'], cfg['attention_mlp'],
                  device=ctx.device)
  tw.load(model, tower0)
  normalize = cfg['attention_weight_normalization']

  def raw_model_loss(t, members, batch):
    x = torch.cat([members['item'], members['category']], dim=-1)
    p = t(x[:, 0], x[:, 1:], batch['hist_mask'], [], [members['user']],
          att_weight_normalization=normalize)
    p = torch.clamp(p, 1e-6, 1 - 1e-6)
    y = batch['label']
    return torch.mean(-(y * torch.log(p) + (1 - y) * torch.log(1 - p))), {}

  state, step = train.state_and_step(s, fx, model, fill(fx, s.table_dtype),
                                     ctx, raw_model_loss=raw_model_loss)
  return {'fx': fx, 'state': state, 'step': step}


def flops(cfg: dict, batch: Dict[str, torch.Tensor]) -> float:
  """Matmul FLOPs that a step's forward and backward require (3x the
  forward: every layer's input needs its gradient, as the embeddings
  do): the DNN and head per example, the attention MLP and the pooling
  per valid history position."""
  b = batch['label'].shape[0]
  dnn = sum(2 * i * o for n, i, o, _ in tower_layers(cfg)
            if not n.startswith('attention'))
  att = sum(2 * i * o for n, i, o, _ in tower_layers(cfg)
            if n.startswith('attention')) + 2 * _query_dim(cfg)
  valid = int(batch['hist_mask'].sum())
  return float(3 * (b * dnn + valid * att))
