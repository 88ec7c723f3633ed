"""Load stress of the port's launcher on an end-to-end resume run: two
ranks in a loop, beside a CPU burner.

Counterpart of ``benchmarks/stress_e2e_launch.py``, the JAX package's
harness, which chased a launch that exited 0 but whose output lacked its
``FINAL`` lines. Each iteration starts two ranks with ``python -m
hybridbackend_tpu_torch.run --simulate 2`` over :data:`CHILD`, a script
of the port kept in this module: each rank joins the world, trains a
``SparseTrainer`` (one [256, 8] table, row-sharded, under row-sparse
Adagrad, and a logistic tower) on its part of four Parquet files (its
files ``i ≡ rank (mod 2)``, batches of 16) for 4 steps, which the
trainer checkpoints in its model directory; then a new trainer restores
that checkpoint, trains the rest, prints ``FINAL <rank> <step>
<digest>`` (the md5 of its tower and its shard of the table and the
accumulator) and writes the same line to ``final_<rank>.txt`` in the
model directory, so that "a rank never finished" can be told from "the
output lost lines".

An iteration is anomalous unless the launch exits 0 within its deadline
with both ``FINAL`` lines and both files; its output is kept as
``e2e_anomaly_<i>.out`` and ``.err`` in ``--keep`` (the temporary
directory by default). Two burner processes load the CPU unless
``--no-burner``. The exit code is 1 when any iteration was anomalous.

  python -m hybridbackend_tpu_torch.benchmarks.stress_e2e_launch [30]
      [--no-burner] [--device cuda|cpu] [--timeout 420] [--keep DIR]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
from typing import List, Optional

import torch

CHILD = """
import hashlib
import itertools
import os
import sys

import numpy as np
import torch

import hybridbackend_tpu_torch as hbt

ctx = hbt.Context.join(sys.argv[1])
model_dir, data_dir = os.environ['HB_MODEL_DIR'], os.environ['HB_DATA_DIR']
files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
               if f.endswith('.parquet'))


def batches(skip=0):
  ds = hbt.data.ParquetDataset(files, batch_size=16, drop_remainder=True,
                               partition_index=ctx.rank,
                               partition_count=ctx.world_size,
                               num_parallel_reads=1)
  for b in itertools.islice(iter(ds), skip, None):
    yield {'cat': np.asarray(b['cat'], np.int32),
           'd0': np.asarray(b['d0'], np.float32),
           'label': np.asarray(b['label'], np.float32)}


def model_loss(tower, emb_f, dense_f, batch):
  preds = torch.sigmoid(tower(torch.cat(emb_f + dense_f, -1))[:, 0])
  p = torch.clamp(preds, 1e-6, 1 - 1e-6)
  y = batch['label']
  pel = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
  return torch.mean(pel), {'preds': preds, 'per_example_loss': pel}


def trainer():
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(hbt.TableConfig('cat', 256, 8))],
      dense_columns=['d0'], ctx=ctx)
  tower = torch.nn.Linear(9, 1)
  with torch.no_grad():
    tower.weight.zero_()
    tower.bias.zero_()
  return hbt.SparseTrainer(fx, model_loss, tower, table_lr=0.1,
                           model_dir=model_dir)


first = trainer()
assert first.global_step == 0, first.global_step
first.train(batches(), max_steps=4)
second = trainer()
assert second.global_step == 4, second.global_step
second.train(batches(skip=4))
h = hashlib.md5()
for p in second.state.dense.parameters():
  h.update(p.detach().cpu().numpy().tobytes())
for name in sorted(second.state.tables):
  h.update(second.state.tables[name].detach().cpu().numpy().tobytes())
  for acc in second.state.table_opt[name].acc:
    h.update(acc.detach().cpu().numpy().tobytes())
line = f'FINAL {ctx.rank} {second.global_step} {h.hexdigest()}'
with open(os.path.join(model_dir, f'final_{ctx.rank}.txt'), 'w') as f:
  f.write(line + '\\n')
print(line, flush=True)
ctx.leave()
"""

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def write_data(data_dir: str) -> None:
  """Four Parquet files of 64 rows: ``cat`` ids of a [256] table, ``d0``,
  and a label from both (the JAX harness's draws)."""
  import pandas as pd
  import numpy as np
  rng = np.random.RandomState(42)
  os.makedirs(data_dir, exist_ok=True)
  for i in range(4):
    n = 64
    cat = rng.randint(0, 256, n).astype(np.int64)
    d0 = rng.rand(n).astype(np.float32)
    label = ((cat % 3 == 0) | (d0 > 0.8)).astype(np.float32)
    pd.DataFrame({'cat': cat, 'd0': d0, 'label': label}).to_parquet(
        os.path.join(data_dir, f'part-{i}.parquet'))


def _burn():
  x = 1.0
  while True:
    x = x * 1.0000001 % 1e9


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('iterations', type=int, nargs='?', default=30)
  p.add_argument('--no-burner', action='store_true')
  p.add_argument('--device', default='cuda',
                 help="the ranks' device: 'cuda' (default) or 'cpu'")
  p.add_argument('--timeout', type=float, default=420.0,
                 help='seconds an iteration may take')
  p.add_argument('--keep', default=None,
                 help='directory for the output of anomalous iterations')
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
    print(f'stress_e2e_launch: {why}', file=sys.stderr)
    return 1
  burners = []
  if not args.no_burner:
    for _ in range(2):
      p = multiprocessing.Process(target=_burn, daemon=True)
      p.start()
      burners.append(p)
  bad = 0
  try:
    with tempfile.TemporaryDirectory() as tmp:
      keep = args.keep or tempfile.gettempdir()
      data_dir = os.path.join(tmp, 'data')
      write_data(data_dir)
      script = os.path.join(tmp, 'e2e.py')
      with open(script, 'w') as f:
        f.write(CHILD)
      for i in range(args.iterations):
        model_dir = os.path.join(tmp, f'm{i}')
        env = dict(os.environ, HB_DATA_DIR=data_dir, HB_MODEL_DIR=model_dir)
        cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.run',
               '--simulate', '2', '--device', args.device, script,
               args.device]
        try:
          out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=args.timeout, cwd=ROOT)
          rc, stdout, stderr = out.returncode, out.stdout, out.stderr
        except subprocess.TimeoutExpired as e:
          rc = 'timeout'
          stdout = (e.stdout or b'').decode(errors='replace')
          stderr = (e.stderr or b'').decode(errors='replace')
        finals = re.findall(r'^FINAL (\d+) (\d+) ([0-9a-f]+)$', stdout,
                            re.MULTILINE)
        files = sum(os.path.exists(os.path.join(model_dir, f'final_{r}.txt'))
                    for r in (0, 1))
        ok = rc == 0 and len(finals) == 2 and files == 2
        print(f'iter {i}: rc={rc} finals={len(finals)} files={files}'
              f'{" OK" if ok else "  <-- ANOMALY"}', flush=True)
        if not ok:
          bad += 1
          os.makedirs(keep, exist_ok=True)
          base = os.path.join(keep, f'e2e_anomaly_{i}')
          with open(base + '.out', 'w') as f:
            f.write(stdout)
          with open(base + '.err', 'w') as f:
            f.write(stderr)
          print(f'  saved {base}.out/.err', flush=True)
  finally:
    for p in burners:
      p.terminate()
  print(f'done: {bad}/{args.iterations} anomalous', flush=True)
  return 1 if bad else 0


if __name__ == '__main__':
  sys.exit(main())
