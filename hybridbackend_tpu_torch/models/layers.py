"""Dense layers of the ranking towers, and DIN's attention layers.

Counterpart of ``hybridbackend_tpu/models/layers.py:27-78`` (dense and
MLP) and ``:85-138`` (the Dice activation, the local activation unit and
the attention pooling of a behaviour sequence). Weights keep the JAX
layout, ``w: [in, out]`` and ``y = x @ w + b``, so converted JAX weights
map one to one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]


class Dense(nn.Module):
  """``activation(x @ w + b)``; weights drawn as the reference does
  (``model.py:58-80``): normal(0, sqrt(2/(in+out))) weights and
  normal(0, sqrt(1/out)) bias, unless the stddevs are given.

  ``compute_dtype`` (for example ``torch.bfloat16``) rounds the matmul's
  operands to it and multiplies them with a float32 result, as the JAX
  package's ``preferred_element_type=float32`` does: the operands are
  cast back to float32 before the product, so with TF32 off it is the
  exact product of the rounded operands with f32 accumulation, on every
  device. The backward of the casts rounds the input and weight
  gradients to ``compute_dtype``, as JAX's transpose does. Parameters and
  the output stay float32."""

  def __init__(self, in_dim: int, out_dim: int,
               activation: Activation = None,
               w_stddev: Optional[float] = None,
               b_stddev: Optional[float] = None,
               compute_dtype: Optional[torch.dtype] = None,
               generator: Optional[torch.Generator] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    if w_stddev is None:
      w_stddev = math.sqrt(2.0 / (in_dim + out_dim))
    if b_stddev is None:
      b_stddev = math.sqrt(1.0 / out_dim)
    # Drawn on the generator's device, then moved: one seeded CPU
    # generator gives the same tower on every device.
    gdev = None if generator is None else generator.device
    w = torch.randn((in_dim, out_dim), generator=generator,
                    device=gdev) * w_stddev
    b = torch.randn((out_dim,), generator=generator, device=gdev) * b_stddev
    self.w = nn.Parameter(w.to(device))
    self.b = nn.Parameter(b.to(device))
    self.activation = activation
    self.compute_dtype = compute_dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x, w = x.to(torch.float32), self.w
    if self.compute_dtype is not None:
      x = x.to(self.compute_dtype).to(torch.float32)
      w = w.to(self.compute_dtype).to(torch.float32)
    y = torch.matmul(x, w) + self.b
    return y if self.activation is None else self.activation(y)


class MLP(nn.Module):
  """Dense layers with ``hidden_activation`` between them and
  ``final_activation`` after the last."""

  def __init__(self, in_dim: int, dims: Sequence[int],
               hidden_activation: Activation = torch.relu,
               final_activation: Activation = None,
               compute_dtype: Optional[torch.dtype] = None,
               generator: Optional[torch.Generator] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    layers, prev = [], in_dim
    for i, d in enumerate(dims):
      act = final_activation if i == len(dims) - 1 else hidden_activation
      layers.append(Dense(prev, d, act, compute_dtype=compute_dtype,
                          generator=generator, device=device))
      prev = d
    self.layers = nn.ModuleList(layers)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for layer in self.layers:
      x = layer(x)
    return x


class Dice(nn.Module):
  """The Dice activation (JAX ``dice_apply``): ``x`` standardized by its
  batch statistics over dimension 0 (the population variance, ``eps``
  inside the root), ``p = sigmoid`` of that, and ``alpha * (1 - p) * x +
  p * x`` with a learned ``alpha`` of ``[dim]``, zero at the start."""

  def __init__(self, dim: int, eps: float = 1e-9,
               device: Optional[torch.device] = None):
    super().__init__()
    self.alpha = nn.Parameter(torch.zeros(dim, device=device))
    self.eps = eps

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    mean = torch.mean(x, dim=0, keepdim=True)
    var = torch.var(x, dim=0, keepdim=True, correction=0)
    p = torch.sigmoid((x - mean) * torch.rsqrt(var + self.eps))
    return self.alpha * (1.0 - p) * x + p * x


class LocalActivationUnit(nn.Module):
  """DIN's attention scorer (JAX ``local_activation_unit_*``): an MLP over
  ``[q, k, q - k, q * k]`` (``4 * emb_dim`` wide) with sigmoid hidden
  activations and a linear last layer of one unit. ``query [B, D]``,
  ``keys [B, L, D]`` give scores ``[B, L]``."""

  def __init__(self, emb_dim: int, hidden_units: Sequence[int] = (80, 40),
               generator: Optional[torch.Generator] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    self.mlp = MLP(4 * emb_dim, [*hidden_units, 1],
                   hidden_activation=torch.sigmoid, generator=generator,
                   device=device)

  def forward(self, query: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    # A broadcast view of the query: [B, L, D] without a copy.
    q = query.unsqueeze(1).expand_as(keys)
    att_in = torch.cat([q, keys, q - keys, q * keys], dim=-1)
    return self.mlp(att_in)[..., 0]


# The score of a masked key before the softmax: finite, so that a row
# whose keys are all masked gets uniform weights, as in the JAX package.
MASKED_SCORE = -2.0 ** 31


def attention_sequence_pooling(unit: LocalActivationUnit, query: torch.Tensor,
                               keys: torch.Tensor, mask: torch.Tensor,
                               weight_normalization: bool = False
                               ) -> torch.Tensor:
  """DIN's attention pooling (JAX ``attention_sequence_pooling``): the
  keys ``[B, L, D]`` summed with the unit's scores as weights, ``[B, D]``.
  ``mask [B, L]`` (bool, or nonzero where valid) zeroes the masked
  scores, or with ``weight_normalization`` takes a softmax over the
  valid keys (masked scores set to ``MASKED_SCORE``)."""
  scores = unit(query, keys)
  valid = mask.bool()
  if weight_normalization:
    weights = torch.softmax(torch.where(valid, scores, MASKED_SCORE), dim=-1)
  else:
    weights = torch.where(valid, scores, 0.0)
  # bf16 keys meet the f32 weights in f32, as jnp.einsum promotes them.
  return torch.einsum('bl,bld->bd', weights, keys.to(weights.dtype))


__all__ = ['Dense', 'Dice', 'LocalActivationUnit', 'MLP',
           'attention_sequence_pooling']
