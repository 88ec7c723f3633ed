"""Criteo wide & deep training on the port (stacked DCNv2 or DLRM).

The port of ``examples/criteo/train.py``, the entry point a user runs: 13
dense and 26 categorical Criteo columns read from Parquet by the port's
``ParquetDataset`` (the native reader where it can serve the file, the
Python reader with ``--python-reader``),
shuffled for training and in file order for evaluation; one embedding
table per categorical column, stacked into one physical table; a DCNv2 or
DLRM tower; Adagrad on the tables and Adam on the tower; AUC after each
epoch; checkpoints in ``--model-dir``. With ``--sparse`` the tables
update on the rows each batch touched (``SparseTrainer``, the Hopper
kernels); without it every table takes its dense gradient (``Trainer``).
Runs on one CUDA device unless ``--device cpu`` is given. Weights are
drawn on the CPU from seed 0, so every device starts from one state.

``--cached CAP`` (which implies ``--sparse``) keeps the largest table in
host DRAM with its Adagrad accumulator (values ``0.01 * randn`` from
``RandomState(42)``, accumulator 0.1, as the JAX example draws them),
behind a ``CAP``-row device cache (``EmbeddingCache``); the other tables
stay on the device. ``--export DIR`` writes a serving bundle of the
sparse trainer after training (``--export-poly``: any batch size;
``--export-int8``: per-row int8 tables), from the full host table of a
cached column, and prints its path.

With ``--synthesize`` (or when ``--data`` is not given and the default
file is missing) it first writes a Criteo-shaped Parquet sample, so the
script runs anywhere:

  python -m hybridbackend_tpu_torch.examples.criteo.train --synthesize \\
      --sparse --steps 200

Under the port's launcher it runs one rank of a world of N, as the JAX
example runs one process of a mesh: each rank joins the world
(``Context.join``), reads the file's row groups ``i ≡ rank (mod N)``
(``ParquetDataset``'s ``partition_index`` and ``partition_count``) in
batches of ``--batch-size`` rows (its rows of a global batch of N times
that), and trains the sharded tables through the ``--lookup`` exchange
(``allgather``, ``alltoall``, ``gspmd`` or ``hierarchical``, the JAX
default ``allgather``; at a world of one there is no exchange). A file
with fewer row groups than ranks is refused with both counts; the
sample it synthesizes has at least one row group a rank. Rank 0 alone
prints and writes the sample; ``--export`` is called by every rank and
rank 0 writes the bundle. With ``--cached`` every rank builds the same
host table from the same seed and declares the same cache, whose slot
map the ranks plan together (``embedding/service.py``); its capacity
must hold the distinct ids of the world's batch. For example, on two CPU
ranks:

  python -m hybridbackend_tpu_torch.run --simulate 2 --device cpu \
      -m hybridbackend_tpu_torch.examples.criteo.train --device cpu \
      --synthesize --sparse --cached 256 --lookup alltoall --vocab 1000 \
      --batch-size 64 --steps 8

``--no-shuffle`` trains in file order (with row groups of one rank's
batch, a world of N then trains the batches of a world of one of N
times ``--batch-size``). ``--cpu N`` is refused: it is a mesh of N host
devices in one process, and the port's ranks are processes; start them
with ``python -m hybridbackend_tpu_torch.run --simulate N``.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch.benchmarks.train_benchmark import (
    cpu_refused, in_world, row_group_for)
from hybridbackend_tpu_torch.examples import FileTooSmall, check_row_groups

NUM_DENSE = 13
NUM_CAT = 26
SEED = 0
ROW_GROUP = 8192
CACHE_SEED = 42
STRATEGIES = ('allgather', 'alltoall', 'gspmd', 'hierarchical')


def synthesize(path: str, rows: int, vocabs: List[int],
               dense_features: int = NUM_DENSE,
               row_group: int = ROW_GROUP) -> None:
  """A Criteo-shaped Parquet sample with a planted signal, the JAX
  example's draws from ``RandomState(0)``: for each categorical column
  zipf(1.5) ids modulo its vocab (int64), an id that 5 divides in one of
  the first four adding 0.8 to the signal; exponential(1) dense values
  (float32), ``log1p`` of the first two adding 0.3 times itself; the
  label (float32) 1 with the sigmoid of the signal less its mean over
  the file. Row groups of 8192."""
  import pyarrow as pa
  import pyarrow.parquet as pq
  rng = np.random.RandomState(0)
  cols = {}
  signal = np.zeros(rows)
  for c, vocab in enumerate(vocabs):
    ids = rng.zipf(1.5, rows) % vocab
    cols[f'c{c}'] = ids.astype(np.int64)
    if c < 4:
      signal = signal + (ids % 5 == 0) * 0.8
  for d in range(dense_features):
    v = rng.exponential(1.0, rows).astype(np.float32)
    cols[f'i{d}'] = v
    if d < 2:
      signal = signal + 0.3 * np.log1p(v)
  p = 1.0 / (1.0 + np.exp(-(signal - signal.mean())))
  cols['label'] = (rng.rand(rows) < p).astype(np.float32)
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  pq.write_table(pa.table(cols), path, row_group_size=row_group)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--data', default='')
  p.add_argument('--synthesize', action='store_true')
  p.add_argument('--rows', type=int, default=100_000)
  p.add_argument('--model', default='dcnv2', choices=['dcnv2', 'dlrm'])
  p.add_argument('--model-dir', default='')
  p.add_argument('--batch-size', type=int, default=4096)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--vocab', type=int, default=100_000)
  p.add_argument('--steps', type=int, default=None)
  p.add_argument('--epochs', type=int, default=1)
  p.add_argument('--lr-tables', type=float, default=0.05)
  p.add_argument('--lr-dense', type=float, default=1e-3)
  p.add_argument('--sparse', action='store_true',
                 help='row-sparse table updates (no dense [V,D] grads)')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--python-reader', action='store_true',
                 help='read through pyarrow in Python, not the native '
                      'reader')
  p.add_argument('--export', default=None, metavar='DIR',
                 help='write a serving bundle of the sparse trainer here '
                      'after training')
  p.add_argument('--export-poly', action='store_true',
                 help='export a symbolic batch dimension (any batch size)')
  p.add_argument('--export-int8', action='store_true',
                 help='export per-row int8 tables')
  p.add_argument('--cached', type=int, default=0, metavar='CAP',
                 help='keep the largest table in host DRAM behind a CAP-row '
                      'device cache (implies --sparse)')
  p.add_argument('--lookup', default='allgather', choices=STRATEGIES,
                 help='the sharded tables\' exchange, under the launcher')
  p.add_argument('--no-shuffle', action='store_true',
                 help='train in file order')
  p.add_argument('--cpu', type=int, default=0,
                 help='devices of a host mesh (not ported: start ranks '
                      'with python -m hybridbackend_tpu_torch.run)')
  return p.parse_args(argv)


def unsupported(args: argparse.Namespace) -> Optional[str]:
  """Why these flags cannot run, or None."""
  if args.cpu:
    return cpu_refused('hybridbackend_tpu_torch.examples.criteo.train')
  if (args.export_poly or args.export_int8) and not args.export:
    return '--export-poly and --export-int8 shape the bundle of --export DIR'
  if args.export and not (args.sparse or args.cached):
    return ('--export writes the bundle of the sparse trainer (as the JAX '
            'example does); pass --sparse')
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def vocabs(args: argparse.Namespace) -> List[int]:
  """The per-column vocabularies of the JAX example."""
  return [max(100, args.vocab >> (c % 5)) for c in range(NUM_CAT)]


def _specs(args: argparse.Namespace):
  import hybridbackend_tpu_torch as hbt
  return [hbt.EmbeddingSpec(hbt.TableConfig(f'c{c}', v, args.dim))
          for c, v in enumerate(vocabs(args))]


def _tower(args: argparse.Namespace, device: torch.device,
           gen: torch.Generator):
  """The tower of ``--model`` and ``preds(tower, emb_f, dense_f)``."""
  import hybridbackend_tpu_torch as hbt
  if args.model == 'dcnv2':
    tower = hbt.StackedDCNv2([args.dim] * NUM_CAT + [1] * NUM_DENSE,
                             [1024, 256, 32, 1], generator=gen, device=device)
    return tower, lambda t, emb_f, dense_f: t(emb_f + dense_f)
  tower = hbt.DLRM(NUM_DENSE, NUM_CAT, [512, 256], args.dim, [1024, 256, 1],
                   generator=gen, device=device)
  return tower, lambda t, emb_f, dense_f: t(dense_f, emb_f)


def host_cache(args: argparse.Namespace, device: torch.device, ctx=None):
  """``(column, EmbeddingCache)`` of ``--cached``: the largest table in
  host DRAM, its values and Adagrad accumulator drawn as the JAX example
  draws them, behind ``--cached`` device rows; in the world ``ctx``, the
  same on every rank."""
  import hybridbackend_tpu_torch as hbt
  vocab = vocabs(args)
  big = int(np.argmax(vocab))
  rng = np.random.RandomState(CACHE_SEED)
  host = {'value': (rng.randn(vocab[big], args.dim) * 0.01
                    ).astype(np.float32),
          'slot0': np.full((vocab[big], args.dim), 0.1, np.float32)}
  return f'c{big}', hbt.EmbeddingCache(
      hbt.TableConfig(f'c{big}', vocab[big], args.dim), args.cached,
      host_tables=host, ctx=ctx or hbt.Context(device))


def sparse_trainer(args: argparse.Namespace, device: torch.device,
                   ctx=None):
  """The ``--sparse`` trainer: stacked tables under row-sparse Adagrad
  (accumulator 0.1) at ``--lr-tables``, the tower under Adam at
  ``--lr-dense``, checkpoints in ``--model-dir``; with ``--cached``, the
  largest table behind its host cache (``host_cache``); in the world
  ``ctx`` (a world of one on ``device`` when None), the rank's shards,
  looked up through ``--lookup``."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.benchmarks.train_benchmark import bce
  ctx = ctx or hbt.Context(device)
  specs = _specs(args)
  caches = None
  if args.cached:
    col, cache = host_cache(args, device, ctx)
    caches = {col: cache}
    specs = [hbt.EmbeddingSpec(cache.slot_config(), column=col)
             if s.key == col else s for s in specs]
  fx = hbt.StackedFeatureExtractor(
      specs, dense_columns=[f'i{d}' for d in range(NUM_DENSE)], ctx=ctx)
  gen = torch.Generator().manual_seed(SEED)
  tables = fx.init(gen)
  tower, preds = _tower(args, ctx.device, gen)

  def model_loss(t, emb_f, dense_f, batch):
    return bce(preds(t, emb_f, dense_f), batch['label'])

  return hbt.SparseTrainer(
      fx, model_loss, tower, tables=tables,
      dense_optimizer=functools.partial(torch.optim.Adam, lr=args.lr_dense),
      table_lr=args.lr_tables, model_dir=args.model_dir or None,
      caches=caches, lookup_strategy=args.lookup)


def dense_trainer(args: argparse.Namespace, device: torch.device, ctx=None):
  """The dense-gradient trainer: one table per column under
  ``multi_optimizer(Adagrad(--lr-tables), Adam(--lr-dense))``; in the
  world ``ctx``, data-parallel with the rank's shards of the tables,
  looked up through ``--lookup``."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.benchmarks.train_benchmark import bce
  ctx = ctx or hbt.Context(device)
  specs = _specs(args)
  dense_names = [f'i{d}' for d in range(NUM_DENSE)]
  gen = torch.Generator().manual_seed(SEED)
  tables = hbt.init_tables(specs, gen, ctx.device, ctx)
  tower, preds = _tower(args, ctx.device, gen)
  module = nn.ModuleDict({'tables': tables, 'net': tower})

  def loss_fn(m, batch):
    emb_f, dense_f = hbt.extract_features(m['tables'], batch, specs,
                                          dense_names, ctx=ctx,
                                          strategy=args.lookup)
    return bce(preds(m['net'], emb_f, dense_f), batch['label'])

  optimizer = hbt.multi_optimizer(
      functools.partial(hbt.Adagrad, lr=args.lr_tables),
      functools.partial(torch.optim.Adam, lr=args.lr_dense))(module)
  return hbt.Trainer(loss_fn, module, optimizer,
                     model_dir=args.model_dir or None, ctx=ctx)


def batches(args: argparse.Namespace, shuffle: bool, ctx=None):
  """An iterator over the file's batches of ``--batch-size`` rows: shuffled
  for training (unless ``--no-shuffle``), in file order for evaluation;
  in the world ``ctx``, of the rank's row groups. Its ``reader`` says
  which reader serves it."""
  import hybridbackend_tpu_torch as hbt
  part = {} if ctx is None else dict(partition_index=ctx.rank,
                                     partition_count=ctx.world_size)
  return iter(hbt.data.Dataset.from_parquet(
      args.data, batch_size=args.batch_size, drop_remainder=True,
      shuffle=shuffle and not args.no_shuffle,
      native=False if args.python_reader else None, **part))


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'criteo/train.py: {why}', file=sys.stderr)
    return 1
  try:
    in_world(args.device, lambda ctx: run(args, ctx))
  except FileTooSmall as e:
    print(f'criteo/train.py: {e}', file=sys.stderr)
    return 1
  return 0


def run(args: argparse.Namespace, ctx=None):
  """Trains (and exports) as the flags say; returns the trainer. In the
  world ``ctx`` (a joined context), this rank's trainer."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.distribute import collective
  world = ctx.world_size if ctx is not None else 1
  chief = ctx is None or ctx.is_chief
  say = print if chief else (lambda *a, **k: None)
  if args.cached:
    args.sparse = True
  if not args.data:
    args.data = os.path.join(tempfile.gettempdir(), 'criteo_sample.parquet')
    args.synthesize = not os.path.exists(args.data)
  if args.synthesize and chief:
    say(f'synthesizing {args.rows} rows → {args.data}')
    synthesize(args.data, args.rows, vocabs(args),
               row_group=row_group_for(args.rows, ROW_GROUP, world))
  if world > 1:
    # The other ranks wait for the sample.
    collective.allreduce(torch.zeros(1, device=ctx.device), ctx=ctx)
    check_row_groups(args.data, world)
  device = ctx.device if ctx is not None else torch.device(args.device)

  if args.sparse:
    trainer = sparse_trainer(args, device, ctx)
    for epoch in range(args.epochs):
      train_it = batches(args, True, ctx)
      say(f'epoch {epoch}: reading {args.data} through the '
          f'{train_it.reader} reader'
          + (f' ({train_it.fallback_reason})'
             if train_it.fallback_reason else ''))
      t0 = time.time()
      m = trainer.train(train_it, max_steps=args.steps or None)
      if device.type == 'cuda':
        torch.cuda.synchronize(device)
      dt = time.time() - t0
      res = trainer.evaluate(batches(args, False, ctx))
      say(f'epoch {epoch}: loss={m["loss"]:.4f}, auc={res["auc"]:.4f}, '
          f'{dt:.1f}s, step {trainer.global_step}')
    if args.export:
      example = next(batches(args, False, ctx))
      path = trainer.export_saved_model(
          args.export, example,
          table_dtype='int8' if args.export_int8 else 'float32',
          poly_batch=args.export_poly)
      say(f'exported serving bundle → {path}'
          + (' (int8 tables)' if args.export_int8 else ''))
    return trainer

  trainer = dense_trainer(args, device, ctx)
  hooks = [hbt.StepStatHook(batch_size=args.batch_size, every_n_steps=50,
                            log=print),
           hbt.LoggingHook(every_n_steps=50, log=print)]
  for epoch in range(args.epochs):
    trainer.train(batches(args, True, ctx), max_steps=args.steps, hooks=hooks)
    results = trainer.evaluate(batches(args, False, ctx))
    say(f'epoch {epoch}: {results}')
  return trainer


if __name__ == '__main__':
  sys.exit(main())
