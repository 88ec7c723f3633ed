"""Stacked DCNv2 ranking tower.

Counterpart of ``hybridbackend_tpu/models/ranking.py:26-44``
(``stacked_dcn_v2_init`` / ``stacked_dcn_v2_apply``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from hybridbackend_tpu_torch.models.layers import MLP, Dense


class StackedDCNv2(nn.Module):
  """Cross layer ``x * relu(x @ w + b) + x`` then an MLP with a sigmoid
  head; returns ``[B]`` predictions."""

  def __init__(self, feature_dims: Sequence[int], mlp_dims: Sequence[int],
               compute_dtype: Optional[torch.dtype] = None,
               generator: Optional[torch.Generator] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    total = sum(feature_dims)
    self.cross = Dense(total, total, torch.relu, w_stddev=1.0,
                       b_stddev=0.0, compute_dtype=compute_dtype,
                       generator=generator, device=device)
    self.mlp = MLP(total, mlp_dims, final_activation=torch.sigmoid,
                   compute_dtype=compute_dtype, generator=generator,
                   device=device)

  def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
    x = torch.cat(list(features), dim=-1)
    return self.mlp(x * self.cross(x) + x)[..., 0]


__all__ = ['StackedDCNv2']
