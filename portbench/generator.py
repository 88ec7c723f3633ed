"""The one traffic generator: a seeded pool of batches made on the device.

A traffic mix is a data file, ``traffic/<mix>.json``:

  {"batch_per_chip": 8192, "pool_batches": 64,
   "dists": {"<key>": {"dist": ..., ...}, ...}}

and a configuration declares its columns (``configs/<config>.py``'s
``columns``), each naming the key of ``dists`` it draws from:

* ``categorical``: ids ``[B]`` in ``[0, rows)``;
* ``sequence``: ``[B, 1 + max]`` ids, a candidate and then a history of a
  drawn length with ``-1`` holes past it, and its ``[B, max]`` mask
  (the column's ``mask``), the length drawn from the column's ``length``
  key of ``dists``;
* ``mapped``: the ids of the column ``of`` (its ``of_rows`` rows) mapped
  to ``[0, rows)`` by a table drawn once, one id a row of ``of`` (an
  item's category), holes kept;
* ``dense``: float32 ``[B]`` (or ``[B, 1]`` with ``"shape": [1]``);
* ``label``: float32 ``[B]``.

Distributions: ``zipf`` (``alpha``; rank ``k`` has weight ``k**-alpha``
over the column's whole range, no folding of a tail; ``permute`` maps
ranks to rows by a seeded permutation, so hot rows are scattered),
``uniform``, ``geometric`` (``mean``, cut at ``max``), ``exponential``
(``scale``) and ``bernoulli`` (``p``). Every draw comes from one
generator seeded from ``--seed``, in the columns' order, so a seed gives
the same pool on a given device. The pool is ``pool_batches`` batches,
cycled by the run.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench import initfn

# Draws per searchsorted call, to bound the float64 temporaries.
_CHUNK = 1 << 24


def _zipf(spec: dict, rows: int, n: int, gen: torch.Generator,
          device: torch.device) -> torch.Tensor:
  weights = torch.arange(1, rows + 1, dtype=torch.float64,
                         device=device).pow_(-float(spec['alpha']))
  cdf = torch.cumsum(weights, 0)
  del weights
  total = float(cdf[-1])
  out = torch.empty(n, dtype=torch.int64, device=device)
  for lo in range(0, n, _CHUNK):
    hi = min(n, lo + _CHUNK)
    u = torch.rand(hi - lo, dtype=torch.float64, generator=gen,
                   device=device) * total
    out[lo:hi] = torch.searchsorted(cdf, u, right=True).clamp_(max=rows - 1)
  del cdf
  if spec.get('permute', False):
    perm = torch.randperm(rows, generator=gen, device=device)
    out = perm[out]
  return out


def ids(spec: dict, rows: int, n: int, gen: torch.Generator,
        device: torch.device) -> torch.Tensor:
  """``n`` int64 ids in ``[0, rows)`` drawn by ``spec``."""
  kind = spec['dist']
  if kind == 'zipf':
    return _zipf(spec, rows, n, gen, device)
  if kind == 'uniform':
    return torch.randint(0, rows, (n,), generator=gen, device=device)
  raise ValueError(f'unknown id distribution {kind!r}')


def lengths(spec: dict, n: int, gen: torch.Generator,
            device: torch.device) -> torch.Tensor:
  """``n`` int64 lengths in ``[1, max]``: geometric with ``mean`` (the
  number of trials to the first success, ``p = 1/mean``), cut at
  ``max``."""
  if spec['dist'] != 'geometric':
    raise ValueError(f'unknown length distribution {spec["dist"]!r}')
  u = 1.0 - torch.rand(n, dtype=torch.float64, generator=gen,
                       device=device)                     # (0, 1]
  k = torch.floor(torch.log(u) / math.log1p(-1.0 / spec['mean'])) + 1
  return k.clamp_(1, spec['max']).to(torch.int64)


def values(spec: dict, shape, gen: torch.Generator,
           device: torch.device) -> torch.Tensor:
  """float32 values of ``shape`` drawn by ``spec``."""
  kind = spec['dist']
  if kind == 'exponential':
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.exponential_(1.0 / spec['scale'], generator=gen)
  if kind == 'bernoulli':
    return (torch.rand(shape, generator=gen, device=device)
            < spec['p']).to(torch.float32)
  raise ValueError(f'unknown value distribution {kind!r}')


def make_pool(traffic: dict, columns: List[dict], batch: int, seed: int,
              device: torch.device) -> Dict[str, torch.Tensor]:
  """The pool: each column as one ``[P, B, ...]`` tensor on ``device``."""
  pool = traffic['pool_batches']
  dists = traffic['dists']
  gen = initfn.generator(seed, 'traffic', device)
  out = {}
  for col in columns:
    spec = dists[col['dist']]
    kind = col['kind']
    if kind == 'categorical':
      out[col['name']] = ids(spec, col['rows'], pool * batch, gen,
                             device).to(torch.int32).view(pool, batch)
    elif kind == 'sequence':
      lspec = dists[col['length']]
      width = lspec['max']
      drawn = ids(spec, col['rows'], pool * batch * (1 + width), gen,
                  device).view(pool, batch, 1 + width)
      n = lengths(lspec, pool * batch, gen, device).view(pool, batch, 1)
      mask = torch.arange(width, device=device) < n
      drawn[..., 1:].masked_fill_(~mask, -1)
      out[col['name']] = drawn.to(torch.int32)
      out[col['mask']] = mask
    elif kind == 'mapped':
      table = ids(spec, col['rows'], col['of_rows'], gen, device)
      src = out[col['of']].to(torch.int64)
      out[col['name']] = torch.where(src >= 0, table[src.clamp(min=0)],
                                     -1).to(torch.int32)
    elif kind in ('dense', 'label'):
      out[col['name']] = values(spec, (pool, batch, *col.get('shape', ())),
                                gen, device)
    else:
      raise ValueError(f'unknown column kind {kind!r}')
  return out


def batch(pool: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
  """Batch ``i`` of the pool (cycled): views, no copy."""
  n = next(iter(pool.values())).shape[0]
  return {k: v[i % n] for k, v in pool.items()}


__all__ = ['batch', 'ids', 'lengths', 'make_pool', 'values']
