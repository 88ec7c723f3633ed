"""Serving benchmark of the port: export, cold load and predict of the
flagship model and of a DIN bundle.

Counterpart of ``benchmarks/serving_benchmark.py``, the JAX package's
harness, in its three cases (``--cases f32 int8 din``). For the first two
it builds the flagship
``SparseTrainer`` from the train harness's config (``--tables`` tables
of ``[--vocab, --dim]``, ``--dense-features`` dense features, the DCNv2
tower with MLP 1024-512-256-1, weights from seed 0), trains
``--train-steps`` steps on batches of 512 (``benchmarks/synthetic.py``,
as the JAX harness trains on batches of 512), and exports an f32 and an
int8 bundle with ``poly_batch=True``. For each bundle it reports:

* ``export_s`` (``export_saved_model``) and ``bundle_mb``;
* ``cold_load_s``: ``Served(path)`` (the graph, the parameters placed on
  the device) in this process, and the first call at each batch size;
* at each of ``--sizes``: ``amortized_ms``, the best of ``--repeats``
  windows of ``--inner`` ``predict_staged`` calls on inputs staged once,
  between CUDA events (on the CPU, the host clock around the window and
  a last read of the result), over ``--inner``; ``roundtrip_ms``, one
  ``predict`` from a host numpy batch to host numpy (host clock);
* kernel 5's launches per predict, by its own counter, over the timed
  windows;

and the kernel library's build seconds (0 when ``_build/`` held it), the
device, and on a card its name and power limit as ``nvidia-smi`` prints
them.

The ``din`` case is the JAX harness's DIN bundle (``:92-133`` there),
reported as ``din_ragged``: an untrained dense-gradient ``Trainer`` over
an item table of [50000, 16] and a user table of [20000, 16] (one table
per column, weights from seed 0) and a DIN tower (DNN 256-128-64,
attention 80-40, the user embedding as its profile feature), exported
with ``poly_batch=True`` and served with a history of 32 ids, a bool mask
and seeded ids, at the sizes of ``--sizes`` up to 1024 rows. Its lookups
are its loss function's own, ``lookup`` through ``index_select``, as the
``Trainer``'s export documents: a predict launches no kernel 5 (the
``SparseTrainer`` bundles gather every member through it). Run on one
CUDA device:

  python -m hybridbackend_tpu_torch.benchmarks.serving_benchmark [--json]

``--device cpu`` runs at a small shape for the tests (the ``din`` case
keeps its widths).

Under the port's launcher it runs one rank of a world of N: the flagship
trainer's tables row-sharded over the ranks (``--lookup`` their
exchange), trained on the rank's rows of each batch, and exported by
every rank (rank 0 writes the bundle, as a world of one's). Each rank
then predicts its rows of each size of ``--sizes`` (the global batch)
through the sharded serving lookups of its shards, kernel 5 at the
owners: ``lookup(serving=True)`` on the f32 shards and the sharded
``lookup_quantized`` on the int8 ones (``quantize_table`` of each shard,
a whole row's scale as in the bundle). Reported for each case and size:
``sharded_ms``, the best of ``--repeats`` windows of ``--inner`` calls
(the exchanges block each call, so the windows time whole calls), and
``max_abs_vs_bundle``, the world's predictions against rank 0's
``Served`` bundle of the global batch. The ``din`` case (a dense
``Trainer``'s bundle served in one process) runs at a world of one.
Rank 0 alone prints, with the world, the strategy and the backend.

  python -m hybridbackend_tpu_torch.run --simulate 2 -m \\
      hybridbackend_tpu_torch.benchmarks.serving_benchmark --cases f32 int8 \\
      --json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch.benchmarks import synthetic
from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb

TRAIN_BATCH = 512
CASES = {'f32': 'float32', 'int8': 'int8'}
# The DIN bundle: item and user vocabularies, width, history length, and
# the largest batch it is served at.
DIN_ITEMS, DIN_USERS, DIN_DIM = 50_000, 20_000, 16
DIN_HIST, DIN_MAX_ROWS = 32, 1024


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--tables', type=int, default=26)
  p.add_argument('--vocab', type=int, default=100_000)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--dense-features', type=int, default=13)
  p.add_argument('--train-steps', type=int, default=2)
  p.add_argument('--inner', type=int, default=20,
                 help='predict_staged calls per timed window')
  p.add_argument('--repeats', type=int, default=3)
  p.add_argument('--sizes', type=int, nargs='*', default=[128, 1024, 8192])
  p.add_argument('--cases', nargs='*', default=['f32', 'int8', 'din'],
                 choices=['f32', 'int8', 'din'])
  p.add_argument('--device', default='cuda',
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--lookup', default='allgather',
                 choices=['allgather', 'alltoall', 'hierarchical', 'gspmd'],
                 help='the sharded tables\' exchange, under the launcher')
  p.add_argument('--json', action='store_true')
  return p.parse_args(argv)


def unsupported(args: argparse.Namespace) -> Optional[str]:
  """Why these flags cannot run, or None."""
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def _config(args: argparse.Namespace) -> argparse.Namespace:
  return tb.parse_args(['--sparse', '--tables', str(args.tables), '--vocab',
                        str(args.vocab), '--dim', str(args.dim),
                        '--dense-features', str(args.dense_features),
                        '--device', args.device, '--lookup', args.lookup])


def batches(args: argparse.Namespace, rows: int, count: int,
            seed: int) -> List[Dict[str, np.ndarray]]:
  """Seeded Criteo-like host batches of the config's columns."""
  return synthetic.criteo_batches(rows, count, args.vocab,
                                  tables=args.tables,
                                  dense_features=args.dense_features,
                                  seed=seed)


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _window_ms(served, staged, inner: int, device: torch.device) -> float:
  """ms per call of ``inner`` ``predict_staged`` calls enqueued back to
  back, from an idle device."""
  _sync(device)
  if device.type == 'cuda':
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(inner):
      served.predict_staged(staged)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner
  t0 = time.perf_counter()
  for _ in range(inner):
    out = served.predict_staged(staged)
  float(out[0])
  return (time.perf_counter() - t0) * 1e3 / inner


def din_batch(rows: int, seed: int) -> Dict[str, np.ndarray]:
  """A seeded batch of the DIN bundle's columns (the JAX harness's)."""
  rng = np.random.RandomState(seed)
  return {'item': rng.randint(0, DIN_ITEMS, rows).astype(np.int32),
          'user': rng.randint(0, DIN_USERS, rows).astype(np.int32),
          'hist': rng.randint(0, DIN_ITEMS, (rows, DIN_HIST)).astype(np.int32),
          'hist_mask': rng.rand(rows, DIN_HIST) < 0.6,
          'label': rng.randint(0, 2, rows).astype(np.float32)}


def din_trainer(device: torch.device):
  """The DIN bundle's ``Trainer`` (untrained, as in the JAX harness)."""
  import hybridbackend_tpu_torch as hbt
  item = hbt.TableConfig('item', DIN_ITEMS, DIN_DIM)
  user = hbt.TableConfig('user', DIN_USERS, DIN_DIM)
  gen = torch.Generator().manual_seed(tb.SEED)
  module = nn.ModuleDict({
      'tables': hbt.init_tables([hbt.EmbeddingSpec(item),
                                 hbt.EmbeddingSpec(user)], gen, device),
      'net': hbt.DIN(DIN_DIM, 1, 0, generator=gen, device=device)})

  def loss_fn(m, batch):
    t = m['tables']
    preds = m['net'](hbt.lookup(t['item'], batch['item'], item),
                     hbt.lookup(t['item'], batch['hist'], item),
                     batch['hist_mask'],
                     [hbt.lookup(t['user'], batch['user'], user)])
    return tb.bce(preds, batch['label'])

  return hbt.Trainer(loss_fn, module, ctx=hbt.Context(device))


def bench_bundle(args: argparse.Namespace, path: str, device: torch.device,
                 make_batch, sizes: List[int]) -> dict:
  """Cold load and the per-batch times of one bundle at ``sizes``, on
  ``make_batch(rows, seed)``."""
  import hybridbackend_tpu_torch as hbt
  t0 = time.perf_counter()
  served = hbt.Served(path, device)
  _sync(device)
  report = {'cold_load_s': time.perf_counter() - t0, 'batches': {}}
  calls = launches = 0
  for size in sizes:
    batch = make_batch(size, tb.SEED + size)
    staged = served.stage(batch)
    t0 = time.perf_counter()
    first = served.predict_staged(staged).cpu().numpy()
    first_s = time.perf_counter() - t0
    if first.shape != (size,) or not np.isfinite(first).all():
      raise RuntimeError(f'{path}: batch {size} predicted {first}')
    before = hbt.gather_rows.launches
    windows = [_window_ms(served, staged, args.inner, device)
               for _ in range(args.repeats)]
    launches += hbt.gather_rows.launches - before
    calls += args.repeats * args.inner
    t0 = time.perf_counter()
    served.predict(batch)
    report['batches'][str(size)] = {
        'amortized_ms': min(windows), 'windows_ms': windows,
        'roundtrip_ms': (time.perf_counter() - t0) * 1e3,
        'first_call_s': first_s}
  report['gather_launches_per_predict'] = launches / max(calls, 1)
  return report


def sharded_predict(trainer, tables, batch, strategy: str) -> torch.Tensor:
  """The rank's predictions of its rows ``batch`` (device tensors)
  through the serving lookups of the stacks' shards ``tables`` (f32, or
  ``QuantizedTable`` shards): a collective of the trainer's world."""
  fx = trainer._fx
  with torch.no_grad():
    raw, _, layouts = fx.lookup_raw(tables, batch, strategy, serving=True)
    emb, dense = fx.combine_from_raw(raw, layouts, batch)
    return trainer._model_loss(trainer.state.dense, emb, dense,
                               batch)[1]['preds']


def bench_sharded(args: argparse.Namespace, trainer, case: str, path: str,
                  ctx) -> dict:
  """Each rank's sharded predictions at the sizes of ``--sizes`` (the
  rank's rows of each global batch): the best window's ms a call, kernel
  5's launches a call, and on rank 0 the largest difference of the
  world's predictions from the bundle's."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.distribute import collective
  device = ctx.device
  tables = dict(trainer.state.tables)
  if CASES[case] == 'int8':
    tables = {k: hbt.quantize_table(t) for k, t in tables.items()}
  served = hbt.Served(path, device) if ctx.is_chief else None
  report = {}
  for size in args.sizes:
    whole = batches(args, size, 1, tb.SEED + size)[0]
    mine = hbt.put_batch({k: v[ctx.rows(size)] for k, v in whole.items()},
                         device)
    call = lambda: sharded_predict(trainer, tables, mine, args.lookup)
    preds = call()
    every = collective.allgather(preds.reshape(-1), ctx=ctx).cpu().numpy()
    before = hbt.gather_rows.launches
    windows = []
    for _ in range(args.repeats):
      _sync(device)
      t0 = time.perf_counter()
      for _ in range(args.inner):
        out = call()
      float(out[0])
      windows.append((time.perf_counter() - t0) * 1e3 / args.inner)
    entry = {'sharded_ms': min(windows), 'windows_ms': windows,
             'gather_launches_per_predict': (hbt.gather_rows.launches - before)
                                            / (args.repeats * args.inner)}
    if served is not None:
      want = served.predict(whole)
      entry['max_abs_vs_bundle'] = float(np.abs(every - want).max())
    report[str(size)] = entry
  return report


def run_world(args: argparse.Namespace, ctx) -> dict:
  """The world's flagship cases (see the module docstring); returns this
  rank's report."""
  from hybridbackend_tpu_torch.distribute import collective
  device = ctx.device
  on_card = device.type == 'cuda'
  result = {
      'metric': 'served_sharded_ms', 'world': ctx.world_size,
      'lookup': args.lookup,
      'backend': torch.distributed.get_backend(ctx.group),
      'tables': args.tables, 'vocab': args.vocab, 'dim': args.dim,
      'dense_features': args.dense_features,
      'train_steps': args.train_steps, 'inner': args.inner,
      'repeats': args.repeats, 'sizes': args.sizes, 'device': str(device),
      'device_name': torch.cuda.get_device_name(device) if on_card else 'cpu',
      'card': tb.card() if on_card and ctx.is_chief else None,
      'timing': 'host clock around whole calls'}
  if 'din' in args.cases:
    result['din_ragged'] = ('not run: a dense Trainer\'s bundle, served in '
                            'one process (a world of one)')
  tmp = tempfile.mkdtemp(prefix='hbtpu_torch_serve_') if ctx.is_chief else ''
  # Every rank writes to rank 0's directory name; only rank 0 writes.
  holder = [tmp]
  torch.distributed.broadcast_object_list(holder, src=0, group=ctx.group)
  tmp = holder[0]
  try:
    trainer = tb.sparse_trainer(_config(args), device, ctx=ctx)
    rows = ctx.rows(TRAIN_BATCH)
    trainer.train(iter([{k: v[rows] for k, v in b.items()} for b in batches(
        args, TRAIN_BATCH, args.train_steps, seed=tb.SEED)]))
    example = batches(args, TRAIN_BATCH, 1, seed=tb.SEED + 1)[0]
    for case in [c for c in args.cases if c in CASES]:
      path = os.path.join(tmp, case)
      t0 = time.perf_counter()
      trainer.export_saved_model(path, example, table_dtype=CASES[case],
                                 poly_batch=True)
      collective.allreduce(torch.zeros(1, device=device), ctx=ctx)
      report = {'export_s': time.perf_counter() - t0,
                'batches': bench_sharded(args, trainer, case, path, ctx)}
      if ctx.is_chief:
        report['bundle_mb'] = _bundle_mb(path)
      result[f'flagship_{case}'] = report
  finally:
    collective.allreduce(torch.zeros(1, device=device), ctx=ctx)
    if ctx.is_chief:
      shutil.rmtree(tmp, ignore_errors=True)
  return result


def _bundle_mb(path: str) -> float:
  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(path) for f in files) / 1e6


def run(args: argparse.Namespace) -> dict:
  """Trains, exports and times; returns the report."""
  from hybridbackend_tpu_torch.ops import build
  device = torch.device(args.device)
  on_card = device.type == 'cuda'
  result = {
      'metric': 'served_amortized_ms',
      'tables': args.tables, 'vocab': args.vocab, 'dim': args.dim,
      'dense_features': args.dense_features,
      'train_steps': args.train_steps, 'inner': args.inner,
      'repeats': args.repeats, 'sizes': args.sizes,
      'device': str(device),
      'device_name': torch.cuda.get_device_name(device) if on_card else 'cpu',
      'card': tb.card() if on_card else None,
      'timing': 'cuda events' if on_card else 'host clock'}
  tmp = tempfile.mkdtemp(prefix='hbtpu_torch_serve_')
  try:
    flagship = [case for case in args.cases if case in CASES]
    if flagship:
      trainer = tb.sparse_trainer(_config(args), device)
      trainer.train(iter(batches(args, TRAIN_BATCH, args.train_steps,
                                 seed=tb.SEED)))
      example = batches(args, TRAIN_BATCH, 1, seed=tb.SEED + 1)[0]
    for case in flagship:
      path = os.path.join(tmp, case)
      t0 = time.perf_counter()
      trainer.export_saved_model(path, example, table_dtype=CASES[case],
                                 poly_batch=True)
      export_s = time.perf_counter() - t0
      report = bench_bundle(
          args, path, device,
          lambda rows, seed: batches(args, rows, 1, seed)[0], args.sizes)
      report.update(export_s=export_s, bundle_mb=_bundle_mb(path))
      result[f'flagship_{case}'] = report
    if 'din' in args.cases:
      path = os.path.join(tmp, 'din')
      t0 = time.perf_counter()
      din_trainer(device).export_saved_model(
          path, din_batch(TRAIN_BATCH, tb.SEED), poly_batch=True)
      export_s = time.perf_counter() - t0
      report = bench_bundle(args, path, device, din_batch,
                            [s for s in args.sizes if s <= DIN_MAX_ROWS])
      report.update(export_s=export_s, bundle_mb=_bundle_mb(path))
      result['din_ragged'] = report
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  result['kernel_build_s'] = (build.load('gather_rows').build_seconds
                              if on_card else None)
  return result


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'serving_benchmark: {why}', file=sys.stderr)
    return 1
  result, chief = tb.in_world(args.device, lambda ctx: (
      run(args) if ctx is None else run_world(args, ctx)))
  if not chief:
    return 0
  if args.json:
    print(json.dumps(result))
  else:
    for key, value in result.items():
      print(f'{key:>20}: {value}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
