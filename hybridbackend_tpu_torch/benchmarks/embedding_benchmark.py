"""Embedding lookup benchmark of the port: each strategy's sharded lookup,
forward and forward+backward, and ``partition_by_modulo``.

Counterpart of ``benchmarks/embedding_benchmark.py``, the JAX package's
harness (its flags ``--vocab``, ``--dim``, ``--batch`` and ``--steps``,
its columns ``Strategy``, ``Mode``, ``ms`` and ``GB/s``). One ``[--vocab,
--dim]`` float32 table, drawn on the CPU from seed 0, is row-sharded over
the world; ``--batch`` ids from ``RandomState(0)`` are the global batch,
and each rank looks up its rows of it:

* ``fwd``: ``lookup`` of the rank's ids in its shard through the
  strategy's exchange (``allgather``, ``alltoall``, ``gspmd``, and
  ``hierarchical`` when the launcher's ``--nodes`` lays the world out in
  more than one node), as a serving or training forward runs it;
* ``fwd+bwd``: the same through the differentiable sharded lookup, and
  the backward of the sum of its rows into the shard's gradient.

At a world of one only the local lookup runs (``local``), as JAX keeps
only ``gspmd`` there. ``ms`` is the host clock around ``--steps`` calls
after one untimed (on a card, from an idle device to a synchronize after
the last), over ``--steps``; ``GB/s`` the global batch's looked-up rows'
bytes (``batch * dim * 4``) over that time, as JAX reports it. Then
``partition_by_modulo`` of the rank's ids into the world's buckets, in
Mids/s of the rank's ids.

Before any time is taken, each strategy's forward is held against the
world of one's ``index_select`` of the whole table on the rank's ids, bit
for bit, on every rank; a strategy that differs on any rank stops the
run with no time printed.

Run under the port's launcher (``--simulate N`` gloo ranks on one card
or the CPU time host copies, not NCCL's); rank 0 alone prints:

  python -m hybridbackend_tpu_torch.run --simulate 2 --device cpu -m \\
      hybridbackend_tpu_torch.benchmarks.embedding_benchmark --device cpu \\
      --vocab 100000 --dim 16 --batch 4096 --steps 3 [--json]

``--cpu N`` (a mesh of N host devices in one process) is refused: the
port's ranks are processes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--vocab', type=int, default=1_000_000)
  p.add_argument('--dim', type=int, default=64)
  p.add_argument('--batch', type=int, default=8192)
  p.add_argument('--steps', type=int, default=20)
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
        'hybridbackend_tpu_torch.benchmarks.embedding_benchmark')
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def strategies(ctx) -> List[str]:
  """The lookups the world allows."""
  if ctx.world_size == 1:
    return ['local']
  out = ['allgather', 'alltoall', 'gspmd']
  if ctx.num_nodes > 1:
    out.append('hierarchical')
  return out


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _timed(fn: Callable, steps: int, ctx) -> float:
  """Seconds a call of ``fn``, over ``steps`` calls after one untimed."""
  from hybridbackend_tpu_torch.distribute import collective
  fn()
  _sync(ctx.device)
  collective.allreduce(torch.zeros(1, device=ctx.device), ctx=ctx)
  _sync(ctx.device)
  t0 = time.perf_counter()
  for _ in range(steps):
    fn()
  _sync(ctx.device)
  return (time.perf_counter() - t0) / steps


def run(args: argparse.Namespace, ctx) -> Dict:
  """Checks, then times, every strategy and the partition; returns the
  report."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.distribute import collective
  from hybridbackend_tpu_torch.distribute.partition import (
      partition_by_modulo)
  device, world = ctx.device, ctx.world_size
  cfg = hbt.TableConfig('bench', args.vocab, args.dim)
  whole = hbt.create_table(cfg, torch.Generator().manual_seed(tb.SEED),
                           torch.device('cpu'))
  shard = whole[cfg.shard_rows(ctx)].to(device).contiguous()
  ids = torch.from_numpy(np.random.RandomState(tb.SEED).randint(
      0, args.vocab, args.batch).astype(np.int32)[ctx.rows(args.batch)]
  ).to(device)
  want = whole.index_select(0, ids.cpu().long()).to(device)
  names = strategies(ctx)
  kw = lambda s: {} if s == 'local' else dict(ctx=ctx, strategy=s)
  checked = {}
  for s in names:
    with torch.no_grad():
      got = hbt.lookup(shard, ids, cfg, **kw(s))
    ok = collective.allreduce(torch.tensor(
        [float(not torch.equal(got, want))], device=device), ctx=ctx)
    checked[s] = bool(ok.item() == 0)
  if not all(checked.values()):
    raise RuntimeError(f'a strategy\'s forward differs from the world of '
                       f'one\'s index_select: {checked}')
  leaf = shard.clone().requires_grad_()

  def backward(s):
    leaf.grad = None
    hbt.lookup(leaf, ids, cfg, **kw(s)).sum().backward()

  rows = []
  moved = args.batch * args.dim * 4
  for s in names:
    for mode, fn in (('fwd', lambda s=s: hbt.lookup(shard, ids, cfg,
                                                    **kw(s))),
                     ('fwd+bwd', lambda s=s: backward(s))):
      with torch.no_grad() if mode == 'fwd' else torch.enable_grad():
        dt = _timed(fn, args.steps, ctx)
      rows.append({'strategy': s, 'mode': mode, 'ms': dt * 1e3,
                   'gb_s': moved / dt / 1e9})
  dt = _timed(lambda: partition_by_modulo(ids, world), args.steps, ctx)
  on_card = device.type == 'cuda'
  backend = (torch.distributed.get_backend(ctx.group)
             if ctx.group is not None else None)
  return {'metric': 'embedding_lookup_ms', 'world': world,
          'nodes': ctx.num_nodes, 'backend': backend, 'vocab': args.vocab,
          'dim': args.dim, 'batch': args.batch, 'steps': args.steps,
          'checked': checked, 'rows': rows,
          'partition': {'ms': dt * 1e3,
                        'mids_s': len(ids) / dt / 1e6},
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
    print(f'embedding_benchmark: {why}', file=sys.stderr)
    return 1
  result, chief = tb.in_world(args.device, lambda ctx: run(
      args, ctx or hbt.Context(torch.device(args.device))))
  if not chief:
    return 0
  if args.json:
    print(json.dumps(result))
    return 0
  print(f'world={result["world"]} nodes={result["nodes"]} '
        f'backend={result["backend"]} vocab={args.vocab} dim={args.dim} '
        f'batch={args.batch} ({result["timing"]})')
  print(f'{"Strategy":<14}{"Mode":<10}{"ms":<10}{"GB/s":<10}')
  for r in result['rows']:
    print(f'{r["strategy"]:<14}{r["mode"]:<10}{r["ms"]:<10.3f}'
          f'{r["gb_s"]:<10.2f}')
  part = result['partition']
  print(f'{"partition":<14}{"fwd":<10}{part["ms"]:<10.3f}'
        f'{part["mids_s"]:.1f} Mids/s')
  return 0


if __name__ == '__main__':
  sys.exit(main())
