"""Liveness stress of the port's cross-rank evaluation: two ranks, back to
back.

Counterpart of ``benchmarks/stress_sync_eval.py``, the JAX package's
harness. Each iteration starts two ranks with ``python -m
hybridbackend_tpu_torch.run --simulate 2`` over :data:`CHILD`, a script
of the port kept in this module: each rank joins the world and runs two
consecutive ``Trainer.evaluate`` calls (a new ``SyncReplicasIterator``
each, its keys and its clean-up) on uneven data, 24 rows on rank 0 and
13 on rank 1 in batches of 8, so that rank 1's last batch is short and
it runs out a step early; each prints ``STRESS_OK rank <r>``. An
iteration passes when the launch exits 0 within its deadline with both
lines; the first that does not prints its output and ends the run with
exit code 1. A wedge shows as the launch's deadline.

  python -m hybridbackend_tpu_torch.benchmarks.stress_sync_eval [50]
      [--device cuda|cpu] [--timeout 480]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import torch

CHILD = """
import sys

import numpy as np
import torch

import hybridbackend_tpu_torch as hbt

ctx = hbt.Context.join(sys.argv[1])


def batches(rank):
  rng = np.random.RandomState(100 + rank)
  n = 24 if rank == 0 else 13
  x = rng.rand(n, 4).astype(np.float32)
  y = (x.sum(1) > 2.0).astype(np.float32)
  g = (x[:, 0] * 4).astype(np.int64)
  for i in range(0, n, 8):
    yield {'x': x[i:i + 8], 'label': y[i:i + 8], 'g': g[i:i + 8]}


def loss_fn(m, batch):
  preds = torch.sigmoid(m(batch['x'])[:, 0])
  p = torch.clamp(preds, 1e-6, 1 - 1e-6)
  y = batch['label']
  pel = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
  return torch.mean(pel), {'preds': preds, 'per_example_loss': pel}


module = torch.nn.Linear(4, 1, bias=False).to(ctx.device)
with torch.no_grad():
  module.weight.copy_(torch.tensor([[0.9, -0.4, 0.3, 0.7]]))
trainer = hbt.Trainer(loss_fn, module, ctx=ctx, group_key='g')
for _ in range(2):
  got = trainer.evaluate(batches(ctx.rank))
  assert 0.0 < got['auc'] <= 1.0, got
  assert got['batches'] == 3.0, got
print('STRESS_OK rank', ctx.rank, flush=True)
ctx.leave()
"""

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('iterations', type=int, nargs='?', default=50)
  p.add_argument('--device', default='cuda',
                 help="the ranks' device: 'cuda' (default) or 'cpu'")
  p.add_argument('--timeout', type=float, default=480.0,
                 help='seconds an iteration may take')
  return p.parse_args(argv)


def unsupported(args: argparse.Namespace) -> Optional[str]:
  """Why these flags cannot run, or None."""
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'stress_sync_eval: {why}', file=sys.stderr)
    return 1
  times = []
  with tempfile.TemporaryDirectory() as tmp:
    child = os.path.join(tmp, 'stress_child.py')
    with open(child, 'w') as f:
      f.write(CHILD)
    cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
           '2', '--device', args.device, child, args.device]
    for i in range(args.iterations):
      t0 = time.time()
      try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=args.timeout, cwd=ROOT)
      except subprocess.TimeoutExpired as e:
        print(f'ITER {i}: TIMEOUT after {args.timeout:.0f} s')
        print('stdout:', (e.stdout or b'')[-4000:])
        print('stderr:', (e.stderr or b'')[-4000:])
        return 1
      dt = time.time() - t0
      times.append(dt)
      if out.returncode != 0 or out.stdout.count('STRESS_OK') != 2:
        print(f'ITER {i}: FAILED rc={out.returncode}')
        print('stdout:', out.stdout[-4000:])
        print('stderr:', out.stderr[-4000:])
        return 1
      print(f'ITER {i}: ok {dt:.1f}s', flush=True)
  print(f'ALL {args.iterations} CLEAN; median '
        f'{sorted(times)[len(times) // 2]:.1f}s')
  return 0


if __name__ == '__main__':
  sys.exit(main())
