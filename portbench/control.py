"""Readings of the check on many seeds: the port's, the control's and
the faults'.

  python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
      [--program] [--variants tf32,half_batch]

For each seed it prints one JSON line a side: the three numbers of
``check.compare`` for

* ``program``: the port's set-up and check steps (no window), as a run
  takes them: the lower readings that a limit is set from;
* ``tf32``: the control, the plain reference put in the port's place with
  every matmul in TF32 (the precision below the configuration's f32 with
  TF32 off), read through the same snapshot as the port;
* ``half_batch``: the fault of half the batch left out, the mean taken
  over the rest, planted in the reference put in the port's place.

A state left unchanged reads 1 by these numbers' measure and needs no
run. This is not part of a benchmark run; it runs on a CUDA device when there is one, else on the CPU at the
files' sizes.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed, device, variants, program):
  """``[(side, gaps)]`` for one seed."""
  import torch
  from portbench import check, generator, harness
  from portbench import tower as tw
  out = []
  if program:
    prep = harness.prepare(cell, seed, device, warmup=0)
    snap, batches, tower0 = prep.snap, prep.check_batches, prep.tower0
    del prep
    harness._free(device)
    out.append(('program', harness.judge(cell, seed, snap, batches, tower0,
                                         device)))
  if variants:
    pool = generator.make_pool(cell.traffic, cell.mod.columns(cell.cfg),
                               cell.traffic['batch_per_chip'],
                               seed, device)
    batches = [generator.batch(pool, i) for i in range(harness.CHECK_STEPS)]
    tower0 = tw.draw(cell.mod.tower_layers(cell.cfg), seed, device)
    ref = check.observe(cell.ref.run(cell.cfg, seed, batches, tower0),
                        cell.cfg, seed, device)
    for v in variants:
      ctl = cell.ref.run(cell.cfg, seed, batches, tower0,
                         precision='tf32' if v == 'tf32' else 'f32',
                         half_batch=v == 'half_batch')
      out.append((v, check.compare(
          check.observe(ctl, cell.cfg, seed, device), ref)))
    del pool
    harness._free(device)
  return out


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seeds', required=True)
  p.add_argument('--program', action='store_true')
  p.add_argument('--variants', default='')
  args = p.parse_args(argv)
  if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
  import torch
  from portbench import harness
  cell = harness.load_cell(ROOT, args.workload)
  device = torch.device('cuda', 0) if torch.cuda.is_available() else (
      torch.device('cpu'))
  variants = [v for v in args.variants.split(',') if v]
  for seed in (int(s) for s in args.seeds.split(',')):
    t0 = time.perf_counter()
    for side, gaps in readings(cell, seed, device, variants, args.program):
      print(json.dumps({'workload': args.workload, 'seed': seed,
                        'side': side, 'seconds': time.perf_counter() - t0,
                        **{k: v[0] for k, v in gaps.items()},
                        'worst': {k: v[1] for k, v in gaps.items()}}),
            flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
