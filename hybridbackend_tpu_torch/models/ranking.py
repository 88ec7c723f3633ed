"""Ranking towers: stacked DCNv2, DLRM and DIN.

Counterparts of ``hybridbackend_tpu/models/ranking.py:26-44``
(``stacked_dcn_v2_init`` / ``stacked_dcn_v2_apply``), ``:51-85``
(``dlrm_init`` / ``dlrm_apply``) and ``:92-164`` (``din_*`` and
``din_session_*``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from hybridbackend_tpu_torch.models.layers import (
    MLP, Dense, LocalActivationUnit, attention_sequence_pooling)


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


class DIN(nn.Module):
  """DIN over one behaviour sequence: the history's embeddings pooled by
  attention keyed on the candidate item's (``LocalActivationUnit`` under
  ``attention``), concatenated with the candidate, the profile
  embeddings and the dense features into a DNN (relu throughout, under
  ``dnn``) and a one-unit linear ``head`` (bias drawn with std 0);
  returns ``[B]`` sigmoid predictions.

  Args:
    emb_dim: ``D``, the width of every embedding.
    num_profile_features, num_dense: the profile embeddings ``[B, D]`` and
      dense features ``[B, 1]`` that ``forward`` takes; the DNN is
      ``D * (num_profile_features + 2) + num_dense`` wide.
    dnn_hidden_units, att_hidden_size: the DNN's and the attention MLP's
      hidden widths.
  """

  def __init__(self, emb_dim: int, num_profile_features: int,
               num_dense: int,
               dnn_hidden_units: Sequence[int] = (256, 128, 64),
               att_hidden_size: Sequence[int] = (80, 40),
               generator: Optional[torch.Generator] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.attention = LocalActivationUnit(emb_dim, att_hidden_size, **kw)
    self.dnn = MLP(emb_dim * (num_profile_features + 2) + num_dense,
                   dnn_hidden_units, final_activation=torch.relu, **kw)
    self.head = Dense(dnn_hidden_units[-1], 1, b_stddev=0.0, **kw)

  def _predict(self, query: torch.Tensor, hist: torch.Tensor,
               profile_embs: Sequence[torch.Tensor],
               dense_features: Sequence[torch.Tensor]) -> torch.Tensor:
    x = torch.cat([query, hist, *profile_embs,
                   *(f.to(torch.float32) for f in dense_features)], dim=-1)
    return torch.sigmoid(self.head(self.dnn(x)))[..., 0]

  def forward(self, query_emb: torch.Tensor, keys_emb: torch.Tensor,
              keys_mask: torch.Tensor,
              profile_embs: Sequence[torch.Tensor],
              dense_features: Sequence[torch.Tensor] = (),
              att_weight_normalization: bool = False) -> torch.Tensor:
    """``query_emb [B, D]`` the candidate item; ``keys_emb [B, L, D]``
    the history, ``keys_mask [B, L]`` its valid positions."""
    hist = attention_sequence_pooling(self.attention, query_emb, keys_emb,
                                      keys_mask, att_weight_normalization)
    return self._predict(query_emb, hist, profile_embs, dense_features)


class DINSession(DIN):
  """Session-grouped DIN (JAX ``din_session_*``), with :class:`DIN`'s
  parameters: the history arrives as ``[B, S, L]`` sessions of events
  (the device layout of a ``ragged_rank=2`` column). Each session pools
  its events by a masked mean (the count floored at 1), a session is
  valid where any of its events is, and attention keyed on the candidate
  pools the session vectors."""

  def forward(self, query_emb: torch.Tensor, sess_keys_emb: torch.Tensor,
              sess_mask: torch.Tensor,
              profile_embs: Sequence[torch.Tensor],
              dense_features: Sequence[torch.Tensor] = (),
              att_weight_normalization: bool = False) -> torch.Tensor:
    """``sess_keys_emb [B, S, L, D]``, ``sess_mask [B, S, L]``."""
    m = sess_mask.to(torch.float32)
    denom = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    sess_vec = (sess_keys_emb * m.unsqueeze(-1)).sum(dim=-2) / denom
    hist = attention_sequence_pooling(
        self.attention, query_emb, sess_vec, sess_mask.bool().any(dim=-1),
        att_weight_normalization)
    return self._predict(query_emb, hist, profile_embs, dense_features)


__all__ = ['DIN', 'DINSession', 'DLRM', 'StackedDCNv2']
