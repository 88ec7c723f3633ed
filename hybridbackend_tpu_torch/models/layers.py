"""Dense layers of the ranking towers.

Counterpart of ``hybridbackend_tpu/models/layers.py:27-78``. Weights keep
the JAX layout, ``w: [in, out]`` and ``y = x @ w + b``, so converted JAX
weights map one to one.
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


__all__ = ['Dense', 'MLP']
