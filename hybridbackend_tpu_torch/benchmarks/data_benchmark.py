"""Data-loading benchmark of the port (parquet, csv, dedup, transfer).

Counterpart of ``benchmarks/data_benchmark.py``, the JAX package's
harness (the reference's ``data_benchmark_parquet.py``,
``data_benchmark_csv.py``, ``data_benchmark_deduplication.py`` and
``transfer_benchmark.py``), with its modes, flags and defaults: batches
of 20000 rows of 200 int64 columns, 100 steps, the published protocol of
``docs/data.md:265-285``.

* ``parquet``: a snappy Parquet file of 10 row groups of ten batches
  each (``RandomState(0)`` draws in ``[0, 100)``, written once) read
  through the port's ``ParquetDataset`` in batches, the native C++
  reader by default or with ``--python-reader`` the Python one; ms a
  batch and rows/s after the first batch.
* ``csv``: the same shape of rows read through pandas' C engine in
  chunks of a batch (the baseline the published table compares Parquet
  against), and the CSV's bytes a row over the Parquet file's where the
  latter exists.
* ``dedup``: the port's ``data/deduplicate.py`` on a batch whose
  ``user`` key repeats ten times on average: ms to collapse a 64-float
  ``profile`` column, ms to restore it, and the unique ratio.
* ``transfer``: the host-to-device copy of the ``[batch, cols]`` float32
  array through the port's ``put_batch``, from pageable memory and from
  pinned memory, ms a copy and GB/s each; it needs a CUDA device and
  refuses without one.

Each mode prints its line as the JAX harness does and, with ``--json``,
one JSON line after it (the mode's numbers, its configuration, the card's
name and power limit as ``nvidia-smi`` prints them where a card is used).
The files are written under ``--workdir`` (default ``HB_BENCH_CACHE``,
else the temporary directory), named by shape, each under a temporary
name and renamed into place.

  python -m hybridbackend_tpu_torch.benchmarks.data_benchmark \\
      [--mode parquet|csv|dedup|transfer] [--batch 20000] [--cols 200] \\
      [--steps 100] [--threads N] [--python-reader] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--mode', default='parquet',
                 choices=['parquet', 'csv', 'dedup', 'transfer'])
  p.add_argument('--batch', type=int, default=20000)
  p.add_argument('--cols', type=int, default=200)
  p.add_argument('--steps', type=int, default=100)
  p.add_argument('--threads', type=int, default=os.cpu_count() or 1)
  p.add_argument('--python-reader', action='store_true',
                 help='parquet: read through pyarrow in Python, not the '
                      'native reader')
  p.add_argument('--workdir', default=None,
                 help='where the files are written (default: '
                      'HB_BENCH_CACHE, else the temporary directory)')
  p.add_argument('--json', action='store_true')
  return p.parse_args(argv)


def unsupported(args: argparse.Namespace) -> Optional[str]:
  """Why these flags cannot run, or None."""
  if args.mode == 'transfer' and not torch.cuda.is_available():
    return ('--mode transfer times host-to-device copies and needs a CUDA '
            'device; there is none')
  return None


def _rows(args: argparse.Namespace) -> int:
  return args.batch * max(args.steps // 10, 1)


def _written(path: str, write: Callable[[str], None]) -> str:
  """``path``, written by ``write(tmp)`` under a temporary name and
  renamed into place unless it exists."""
  if not os.path.exists(path):
    fd, tmp = tempfile.mkstemp(prefix='.data_bench.', suffix='.tmp',
                               dir=os.path.dirname(path))
    os.close(fd)
    try:
      write(tmp)
      os.replace(tmp, path)
    finally:
      if os.path.exists(tmp):
        os.unlink(tmp)
  return path


def _parquet_path(args: argparse.Namespace) -> str:
  return os.path.join(args.workdir, f'data_bench_{args.batch}x{args.cols}_'
                      f'{args.steps // 10 or 1}.parquet')


def parquet_file(args: argparse.Namespace) -> str:
  """The parquet mode's file: ``steps // 10`` row groups of ten batches,
  the JAX harness's draws."""
  import pyarrow as pa
  import pyarrow.parquet as pq

  def write(tmp):
    rng = np.random.RandomState(0)
    writer = None
    for _ in range(args.steps // 10 or 1):
      tbl = pa.table({f'f{c}': rng.randint(0, 100, args.batch * 10)
                      for c in range(args.cols)})
      if writer is None:
        writer = pq.ParquetWriter(tmp, tbl.schema, compression='snappy')
      writer.write_table(tbl, row_group_size=args.batch)
    writer.close()

  return _written(_parquet_path(args), write)


def bench_parquet(args: argparse.Namespace) -> Dict:
  from hybridbackend_tpu_torch.data import ParquetDataset
  path = parquet_file(args)
  ds = ParquetDataset(path, batch_size=args.batch, drop_remainder=True,
                      num_parallel_reads=args.threads,
                      native=False if args.python_reader else None)
  it = iter(ds)
  try:
    next(it)
    t0 = time.perf_counter()
    count = sum(1 for _ in it)
    dt = (time.perf_counter() - t0) / max(count, 1)
  finally:
    it.close()
  print(f'parquet: {dt * 1e3:.2f} ms/step, {args.batch / dt:,.0f} '
        f'samples/sec ({count} steps, {args.threads} threads, reader '
        f'{it.reader})')
  return {'ms_per_step': dt * 1e3, 'samples_per_s': args.batch / dt,
          'steps_timed': count, 'reader': it.reader,
          'reader_fallback_reason': it.fallback_reason,
          'file_bytes': os.path.getsize(path)}


def bench_csv(args: argparse.Namespace) -> Dict:
  import pandas as pd
  rows = _rows(args)

  def write(tmp):
    rng = np.random.RandomState(0)
    pd.DataFrame({f'f{c}': rng.randint(0, 100, rows)
                  for c in range(args.cols)}).to_csv(tmp, index=False)

  path = _written(os.path.join(
      args.workdir, f'data_bench_{rows}x{args.cols}.csv'), write)
  t0 = time.perf_counter()
  count = 0
  for _ in pd.read_csv(path, chunksize=args.batch, engine='c'):
    count += 1
  dt = (time.perf_counter() - t0) / max(count, 1)
  pq_path = _parquet_path(args)
  ratio, note = None, ''
  if os.path.exists(pq_path):
    import pyarrow.parquet as pq
    pq_rows = pq.ParquetFile(pq_path).metadata.num_rows
    ratio = ((os.path.getsize(path) / rows)
             / (os.path.getsize(pq_path) / pq_rows))
    note = f', csv/parquet bytes-per-row ratio {ratio:.2f}x'
  print(f'csv: {dt * 1e3:.2f} ms/step, {args.batch / dt:,.0f} samples/sec '
        f'({count} steps){note}')
  return {'ms_per_step': dt * 1e3, 'samples_per_s': args.batch / dt,
          'steps_timed': count, 'csv_over_parquet_bytes_per_row': ratio}


def bench_dedup(args: argparse.Namespace) -> Dict:
  from hybridbackend_tpu_torch.data import deduplicate, restore_deduplicated
  rng = np.random.RandomState(0)
  n = args.batch
  batch = {
      'user': rng.randint(0, n // 10, n),
      'profile': rng.rand(n, 64).astype(np.float32),
      'item': rng.randint(0, 100000, n),
  }
  t0 = time.perf_counter()
  for _ in range(args.steps):
    dd = deduplicate(batch, ['profile'], 'user')
  dt = (time.perf_counter() - t0) / args.steps
  ratio = len(dd['profile']) / n
  t0 = time.perf_counter()
  for _ in range(args.steps):
    restored = restore_deduplicated(dd, ['profile'], 'restore_idx')
  dr = (time.perf_counter() - t0) / args.steps
  if restored['profile'].shape != batch['profile'].shape:
    raise RuntimeError(f'dedup: restored {restored["profile"].shape}, '
                       f'expected {batch["profile"].shape}')
  print(f'dedup: {dt * 1e3:.2f} ms, restore: {dr * 1e3:.2f} ms '
        f'({n} rows, unique ratio {ratio:.2f})')
  return {'dedup_ms': dt * 1e3, 'restore_ms': dr * 1e3,
          'unique_ratio': ratio}


def bench_transfer(args: argparse.Namespace) -> Dict:
  from hybridbackend_tpu_torch.data import put_batch
  device = torch.device('cuda', torch.cuda.current_device())
  x = np.random.RandomState(0).rand(args.batch, args.cols).astype(np.float32)
  sources = {'pageable': torch.from_numpy(x),
             'pinned': torch.from_numpy(x).pin_memory()}
  out = {'mb': x.nbytes / 1e6}
  for kind, src in sources.items():
    got = put_batch({'x': src}, device)['x']
    torch.cuda.synchronize(device)
    if not torch.equal(got.cpu(), sources['pageable']):
      raise RuntimeError(f'transfer: the {kind} copy differs from the host')
    t0 = time.perf_counter()
    for _ in range(args.steps):
      got = put_batch({'x': src}, device)['x']
    torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / args.steps
    out[kind] = {'ms': dt * 1e3, 'gb_per_s': x.nbytes / dt / 1e9}
    print(f'h2d transfer ({kind}): {dt * 1e3:.3f} ms/step, '
          f'{x.nbytes / dt / 1e9:.2f} GB/s ({x.nbytes / 1e6:.1f} MB)')
  out['device_name'] = torch.cuda.get_device_name(device)
  out['card'] = tb.card()
  return out


MODES = {'parquet': bench_parquet, 'csv': bench_csv, 'dedup': bench_dedup,
         'transfer': bench_transfer}


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'data_benchmark: {why}', file=sys.stderr)
    return 1
  args.workdir = args.workdir or os.environ.get('HB_BENCH_CACHE') or (
      os.path.join(tempfile.gettempdir(), 'hbtpu_torch_bench'))
  os.makedirs(args.workdir, exist_ok=True)
  result = MODES[args.mode](args)
  if args.json:
    print(json.dumps({'mode': args.mode, **result, 'batch': args.batch,
                      'cols': args.cols, 'steps': args.steps,
                      'threads': args.threads,
                      'python_reader': args.python_reader,
                      'host_cpus': os.cpu_count()}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
