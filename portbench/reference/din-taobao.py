"""Plain reference of ``din-taobao``: DIN (Zhou et al., KDD 2018,
arXiv:1706.06978) over one behaviour sequence, as DeepCTR's ``DIN``
builds it with ``history_feature_list = [item, category]``.

The candidate and each history entry are their item's embedding beside
their category's (an id ``< 0``, a hole past the history's length, reads
zeros and is masked). The candidate is the query, the history's entries
the keys. The local activation unit scores each key with an MLP over
``[q, k, q - k, q * k]`` (sigmoid hidden layers, a linear one-unit
output); a masked key's score is 0 and the pooled history is the keys
summed with their scores (no softmax: ``att_weight_normalization`` is
off). The DNN takes ``[query, pooled history, user embedding]`` (relu
throughout), a linear one-unit head and a sigmoid, then the mean binary
cross-entropy. Parameter names are the benchmark's.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import common


def members(cfg: dict):
  return [('item', 0), ('category', 1), ('user', 2)]


def member_ids(cfg: dict):
  def ids(b):
    return {'item': b['cand_hist'], 'category': b['cate_hist'],
            'user': b['user']}
  return ids


def forward(cfg: dict):
  n_att = len(cfg['attention_mlp'])
  n_dnn = len(cfg['dnn'])

  def loss(ops: common.Ops, p: Dict[str, torch.Tensor],
           emb: Dict[str, torch.Tensor], b) -> torch.Tensor:
    seq = torch.cat([emb['item'], emb['category']], dim=-1)
    q, k = seq[:, 0], seq[:, 1:]
    qe = q.unsqueeze(1).expand_as(k)
    h = torch.cat([qe, k, qe - k, qe * k], dim=-1)
    for i in range(n_att + 1):
      act = torch.sigmoid if i < n_att else None
      h = common.dense(ops, p, f'attention.mlp.layers.{i}', h, act)
    scores = torch.where(b['hist_mask'], h[..., 0], 0.0)
    pooled = ops.einsum('bl,bld->bd', scores, k)
    x = torch.cat([q, pooled, emb['user']], dim=-1)
    for i in range(n_dnn):
      x = common.dense(ops, p, f'dnn.layers.{i}', x, torch.relu)
    y = torch.sigmoid(common.dense(ops, p, 'head', x))
    return common.bce(y[:, 0], b['label'])

  return loss


def run(cfg: dict, seed: int, batches: List[dict],
        tower0: Dict[str, torch.Tensor], precision: str = 'f32',
        half_batch: bool = False) -> dict:
  """The snapshot of three steps from the benchmark's inputs
  (``common.train3``)."""
  return common.train3(cfg, seed, batches, tower0, members(cfg),
                       member_ids(cfg), forward(cfg), precision, half_batch)
