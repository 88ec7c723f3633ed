"""Ranking towers: stacked DCNv2 and DLRM.

Counterparts of ``hybridbackend_tpu/models/ranking.py:26-44``
(``stacked_dcn_v2_init`` / ``stacked_dcn_v2_apply``) and ``:51-85``
(``dlrm_init`` / ``dlrm_apply``).
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


class DLRM(nn.Module):
  """Bottom MLP over ``log1p(max(x, 0))`` of the dense (wide) features,
  a pairwise dot interaction of its output with the embedding (deep)
  features (upper triangle, diagonal excluded), then a top MLP with a
  sigmoid head; returns ``[B]`` predictions.

  Args:
    num_wide: width of the concatenated dense features.
    num_deep: number of embedding features, each ``[B, dot_interact_dim]``.
    bottom_mlp_dims: the bottom MLP, relu throughout.
    dot_interact_dim: width of ``bottom_out`` (a Dense with relu) and of
      every embedding feature.
    top_mlp_dims: the top MLP over ``dot_interact_dim + n(n-1)/2`` inputs,
      ``n = num_deep + 1``.
  """

  def __init__(self, num_wide: int, num_deep: int,
               bottom_mlp_dims: Sequence[int], dot_interact_dim: int,
               top_mlp_dims: Sequence[int],
               compute_dtype: Optional[torch.dtype] = None,
               generator: Optional[torch.Generator] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    n = num_deep + 1
    kw = dict(compute_dtype=compute_dtype, generator=generator,
              device=device)
    self.bottom_mlp = MLP(num_wide, bottom_mlp_dims,
                          final_activation=torch.relu, **kw)
    self.bottom_out = Dense(bottom_mlp_dims[-1], dot_interact_dim,
                            torch.relu, **kw)
    self.top_mlp = MLP(dot_interact_dim + n * (n - 1) // 2, top_mlp_dims,
                       final_activation=torch.sigmoid, **kw)
    # Flat indices of the strict upper triangle of an [n, n] matrix, in
    # the row-major order of ``jnp.triu_indices(n, k=1)``.
    iu, ju = torch.triu_indices(n, n, offset=1, device=device)
    self.register_buffer('triu', iu * n + ju, persistent=False)

  def forward(self, wide_features: Sequence[torch.Tensor],
              deep_features: Sequence[torch.Tensor]) -> torch.Tensor:
    wide = torch.cat(list(wide_features), dim=-1).to(torch.float32)
    wide = torch.log1p(torch.clamp(wide, min=0.0))
    bottom = self.bottom_out(self.bottom_mlp(wide))
    stack = torch.stack([bottom, *deep_features], dim=1)     # [B, n, d]
    x2 = torch.bmm(stack, stack.transpose(1, 2))              # [B, n, n]
    interactions = x2.flatten(1).index_select(1, self.triu)
    top_in = torch.cat([bottom, interactions], dim=-1)
    return self.top_mlp(top_in)[..., 0]


__all__ = ['DLRM', 'StackedDCNv2']
