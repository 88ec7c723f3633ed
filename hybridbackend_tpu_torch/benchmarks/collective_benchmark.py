"""Collective benchmark of the port: all-reduce, all-to-all, all-gather and
reduce-scatter swept by message size, with the bytes on the wire.

Counterpart of ``benchmarks/collective_benchmark.py``, the JAX package's
harness (its flags ``--sizes-mb``, ``--collectives`` and ``--steps``, its
columns ``Collective``, ``Size(MB)``, ``ms`` and ``GB/s(algo)``). Each
size is a float32 array of that many MB (rounded down to a multiple of
128 elements a rank), split over the world as JAX's ``P(axes)`` splits
it: each rank holds its ``1/N``. Each collective runs through
``distribute/collective.py`` on the world's process group:

* ``allreduce``: the sum of the ranks' parts, on every rank;
* ``alltoall``: block ``i`` of each rank's part to rank ``i``;
* ``allgather``: the ranks' parts joined, on every rank;
* ``reducescatter``: block ``r`` of the sum, on rank ``r``.

``ms`` is the host clock around ``--steps`` calls after one untimed
(on a card, from an idle device to a synchronize after the last), over
``--steps``; ``GB/s(algo)`` the array's float32 bytes over that time, as
the JAX harness reports it. The JAX harness reads the wire dtype from
``HB_COMM_WIRE_DTYPE``; here ``--wire-dtype`` casts the payload before
each call and back after it (``collective.py``'s ``wire_dtype``), and
``wire MB`` is the bytes each rank puts on the wire, counted from the
shapes and the wire dtype (not timed) for the bandwidth-optimal ring
algorithms: ``2(N-1)/N`` of its part for all-reduce, ``(N-1)/N`` for
all-to-all and reduce-scatter, ``N-1`` parts for all-gather. A bf16 or
fp16 wire halves it.

Run under the port's launcher, one rank a process (``--simulate N`` on
one card or the CPU runs gloo ranks, whose times are host copies, not
NCCL's); rank 0 alone prints. Without the launcher it is a world of one,
where every collective is a copy and nothing goes on a wire:

  python -m hybridbackend_tpu_torch.run --simulate 2 --device cpu -m \\
      hybridbackend_tpu_torch.benchmarks.collective_benchmark --device cpu \\
      --sizes-mb 1 4 --steps 3 [--wire-dtype bfloat16] [--json]

``--cpu N`` (a mesh of N host devices in one process) is refused: the
port's ranks are processes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb

COLLECTIVES = ('allreduce', 'alltoall', 'allgather', 'reducescatter')


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--sizes-mb', type=float, nargs='+', default=[1, 4, 16, 64])
  p.add_argument('--collectives', nargs='+', default=list(COLLECTIVES),
                 choices=COLLECTIVES)
  p.add_argument('--steps', type=int, default=20)
  p.add_argument('--wire-dtype', default='float32',
                 choices=['float32', 'bfloat16', 'float16'])
  p.add_argument('--device', default='cuda',
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--cpu', type=int, default=0,
                 help='devices of a host mesh (not ported: start ranks '
                      'with python -m hybridbackend_tpu_torch.run)')
  p.add_argument('--json', action='store_true')
  return p.parse_args(argv)


def unsupported(args: argparse.Namespace) -> Optional[str]:
  """Why these flags cannot run, or None."""
  if args.cpu:
    return tb.cpu_refused(
        'hybridbackend_tpu_torch.benchmarks.collective_benchmark')
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def wire_bytes(name: str, part_elems: int, world: int,
               itemsize: int) -> float:
  """The bytes a rank sends for ``name`` on a part of ``part_elems``
  elements of ``itemsize`` bytes, by the ring algorithms' counts."""
  part = part_elems * itemsize
  return {'allreduce': 2 * (world - 1) / world * part,
          'alltoall': (world - 1) / world * part,
          'allgather': (world - 1) * part,
          'reducescatter': (world - 1) / world * part}[name]


def _ops(ctx, wire: str):
  from hybridbackend_tpu_torch.distribute import collective as c
  w = ctx.world_size
  return {
      'allreduce': lambda x: c.allreduce(x, ctx=ctx, wire_dtype=wire),
      'alltoall': lambda x: c.alltoall(x, ctx=ctx, wire_dtype=wire),
      'allgather': lambda x: c.allgather(x, ctx=ctx, wire_dtype=wire),
      'reducescatter': lambda x: c.reduce_scatter(
          x.view(w, -1), ctx=ctx, wire_dtype=wire),
  }


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def run(args: argparse.Namespace, ctx) -> Dict:
  """Times every collective at every size; returns the report."""
  from hybridbackend_tpu_torch.distribute import collective
  device, world = ctx.device, ctx.world_size
  itemsize = (torch.finfo(getattr(torch, args.wire_dtype)).bits // 8)
  ops = _ops(ctx, args.wire_dtype)
  rows = []
  for size_mb in args.sizes_mb:
    n = int(size_mb * 1e6 / 4)
    n = (n // (world * 128)) * world * 128
    x = torch.ones(n // world, dtype=torch.float32, device=device)
    for name in args.collectives:
      fn = ops[name]
      fn(x)
      _sync(device)
      # Start together: a rank that is late is not the collective's time.
      collective.allreduce(torch.zeros(1, device=device), ctx=ctx)
      _sync(device)
      t0 = time.perf_counter()
      for _ in range(args.steps):
        r = fn(x)
      _sync(device)
      dt = (time.perf_counter() - t0) / args.steps
      if not bool(torch.isfinite(r).all()):
        raise RuntimeError(f'{name}: non-finite result')
      rows.append({'collective': name, 'size_mb': size_mb, 'elements': n,
                   'ms': dt * 1e3, 'gb_s_algo': n * 4 / dt / 1e9,
                   'wire_mb': wire_bytes(name, n // world, world,
                                         itemsize) / 1e6})
  on_card = device.type == 'cuda'
  backend = (torch.distributed.get_backend(ctx.group)
             if ctx.group is not None else None)
  return {'metric': 'collective_ms', 'world': world, 'backend': backend,
          'wire_dtype': args.wire_dtype, 'steps': args.steps, 'rows': rows,
          'device': str(device),
          'device_name': (torch.cuda.get_device_name(device) if on_card
                          else 'cpu'),
          'card': tb.card() if on_card and ctx.is_chief else None,
          'timing': 'host clock' + (', gloo through the host'
                                    if backend == 'gloo' and on_card
                                    else '')}


def main(argv: Optional[List[str]] = None) -> int:
  import hybridbackend_tpu_torch as hbt
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'collective_benchmark: {why}', file=sys.stderr)
    return 1
  result, chief = tb.in_world(args.device, lambda ctx: run(
      args, ctx or hbt.Context(torch.device(args.device))))
  if not chief:
    return 0
  if args.json:
    print(json.dumps(result))
    return 0
  print(f'world={result["world"]} backend={result["backend"]} '
        f'wire={args.wire_dtype} ({result["timing"]})')
  print(f'{"Collective":<14}{"Size(MB)":<10}{"ms":<10}{"GB/s(algo)":<12}'
        f'{"wire MB":<10}')
  for r in result['rows']:
    print(f'{r["collective"]:<14}{r["size_mb"]:<10}{r["ms"]:<10.3f}'
          f'{r["gb_s_algo"]:<12.2f}{r["wire_mb"]:<10.3f}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
