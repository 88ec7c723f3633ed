"""Initial tower weights, made by the benchmark from the seed.

The port's ``Dense`` layers draw ``w: [in, out]`` from normal(0,
sqrt(2/(in+out))) and ``b`` from normal(0, sqrt(1/out)) unless told
otherwise. The benchmark draws the same distributions itself, in one
call on the device, copies them into the port's module, and hands the
same tensors to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from portbench import initfn

# (parameter prefix, in, out, bias stddev or None for sqrt(1/out))
Layer = Tuple[str, int, int, Optional[float]]


def draw(layers: List[Layer], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
  """``{prefix.w, prefix.b}`` for every layer, from one draw."""
  total = sum(i * o + o for _, i, o, _ in layers)
  z = torch.randn(total, generator=initfn.generator(seed, 'tower', device),
                  device=device)
  out, pos = {}, 0
  for name, i, o, b_std in layers:
    w = z[pos:pos + i * o].view(i, o) * math.sqrt(2.0 / (i + o))
    pos += i * o
    b = z[pos:pos + o] * (math.sqrt(1.0 / o) if b_std is None else b_std)
    pos += o
    out[name + '.w'], out[name + '.b'] = w, b
  return out


def mlp(prefix: str, in_dim: int, dims: List[int]) -> List[Layer]:
  """The layers of the port's ``MLP(in_dim, dims)`` under ``prefix``."""
  layers, prev = [], in_dim
  for i, d in enumerate(dims):
    layers.append((f'{prefix}.layers.{i}', prev, d, None))
    prev = d
  return layers


def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
  """Copies ``weights`` into ``module``'s parameters, every one."""
  params = dict(module.named_parameters())
  if set(params) != set(weights):
    raise ValueError(f'tower parameters {sorted(params)} differ from the '
                     f'benchmark\'s {sorted(weights)}')
  with torch.no_grad():
    for k, p in params.items():
      p.copy_(weights[k])


__all__ = ['draw', 'load', 'mlp']
