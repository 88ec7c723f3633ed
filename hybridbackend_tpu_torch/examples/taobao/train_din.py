"""Taobao DIN training on the port: ragged user-behaviour sequences.

The port of ``examples/taobao/train_din.py``, the entry point a user
runs: the candidate item's embedding queries an attention pool over the
user's click history (a ragged Parquet list column, padded with a mask
on the way in), with the user's embedding as the profile feature, into a
DNN. Read by the port's ``Dataset.from_parquet`` and ``parse`` with
``Field('hist', ragged_rank=1, max_len=--max-hist)``, shuffled for
training and in file order for evaluation; AUC and GAUC (grouped by
``user``) after each epoch; checkpoints in ``--model-dir``. With
``--sparse`` the tables update on the rows each batch touched:
``SparseTrainer`` in raw mode over one stack of the item and user tables,
the candidate and its history in one ``cand_hist`` column, through the
Hopper kernels; without it each table takes its dense gradient
(``Trainer``). ``--sessions`` reads the history as ``list<list<int64>>``
sessions of clicks (``Field('hist', ragged_rank=2, max_len=(
--max-sessions, --max-hist))``, ``[B, S, L]`` with a two-level mask)
through ``DINSession``; with ``--sparse`` its flattened ``cand_hist``
carries ``-1`` where the mask is false, which moves no row. Runs on one
CUDA device unless ``--device cpu`` is given; weights are drawn on the
CPU from seed 0.

With ``--synthesize`` (or when ``--data`` is missing) it first writes a
Taobao-shaped Parquet sample, the JAX example's draws:

  python -m hybridbackend_tpu_torch.examples.taobao.train_din --synthesize \\
      --sparse [--sessions] --steps 200

Under the port's launcher it runs one rank of a world of N, as the JAX
example runs one process of a mesh: each rank joins the world, reads the
file's row groups ``i ≡ rank (mod N)`` in batches of ``--batch-size``
rows, and looks the sharded tables up through ``--lookup`` (with
``--sparse``, the raw-mode sharded step and ``SparseTrainer`` at N; the
dense trainer is data-parallel over the rank's shards). Rank 0 alone
prints and writes the sample, which has at least one row group a rank; a
file with fewer is refused with both counts. ``--no-shuffle`` trains in
file order. ``--cpu N`` (a mesh of N host devices in one process) is
refused: start N ranks with ``python -m hybridbackend_tpu_torch.run
--simulate N``.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch.benchmarks.train_benchmark import (
    cpu_refused, in_world, row_group_for)
from hybridbackend_tpu_torch.examples import FileTooSmall, check_row_groups

ITEM_VOCAB = 50_000
USER_VOCAB = 20_000
CATE_VOCAB = 1_000
SEED = 0
ROW_GROUP = 4096


def synthesize(path: str, rows: int, sessions: bool = False,
               row_group: int = ROW_GROUP) -> None:
  """The JAX example's sample, drawn from ``RandomState(0)`` in its order:
  users with a preferred category, half the candidates from it, click
  histories of 1-19 items of that category (split into 1-4 sessions of
  consecutive clicks with ``sessions``), and a label 1 with probability
  0.9 for an in-category candidate and 0.1 for another. Columns ``user``
  and ``item`` (int64), ``hist`` (``list<int64>``, or
  ``list<list<int64>>``) and ``label`` (float32), in row groups of
  ``row_group`` rows (4096)."""
  import pyarrow as pa
  import pyarrow.parquet as pq
  rng = np.random.RandomState(0)
  active_items = min(ITEM_VOCAB, max(2000, rows // 20))
  user = rng.randint(0, min(USER_VOCAB, rows // 10 + 100), rows)
  pref = user % CATE_VOCAB
  in_cate = rng.rand(rows) < 0.5
  rand_item = rng.randint(0, active_items, rows)
  cate_item = pref + CATE_VOCAB * rng.randint(
      0, max(1, active_items // CATE_VOCAB), rows)
  item = np.where(in_cate, cate_item, rand_item)
  hists = []
  for i in range(rows):
    n = rng.randint(1, 20)
    clicks = (pref[i] + CATE_VOCAB * rng.randint(
        0, active_items // CATE_VOCAB, n)).astype(np.int64).tolist()
    if sessions:
      ns = rng.randint(1, 5)
      cuts = sorted(rng.randint(0, n + 1, ns - 1).tolist())
      bounds = [0] + cuts + [n]
      clicks = [clicks[a:b] for a, b in zip(bounds, bounds[1:])]
    hists.append(clicks)
  p = 0.1 + 0.8 * (item % CATE_VOCAB == pref).astype(np.float32)
  label = (rng.rand(rows) < p).astype(np.float32)
  hist_type = pa.list_(pa.int64())
  if sessions:
    hist_type = pa.list_(hist_type)
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  pq.write_table(pa.table({
      'user': pa.array(user.astype(np.int64)),
      'item': pa.array(item.astype(np.int64)),
      'hist': pa.array(hists, type=hist_type),
      'label': pa.array(label)}), path, row_group_size=row_group)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--data', default='')
  p.add_argument('--synthesize', action='store_true')
  p.add_argument('--rows', type=int, default=50_000)
  p.add_argument('--batch-size', type=int, default=512)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--max-hist', type=int, default=32)
  p.add_argument('--steps', type=int, default=None)
  p.add_argument('--epochs', type=int, default=1)
  p.add_argument('--model-dir', default='')
  p.add_argument('--sparse', action='store_true',
                 help='row-sparse table updates: SparseTrainer in raw mode')
  p.add_argument('--sessions', action='store_true',
                 help='session-grouped history: a list<list<int64>> column '
                      'padded to [B, S, L] with a two-level mask, through '
                      'DINSession')
  p.add_argument('--max-sessions', type=int, default=4)
  p.add_argument('--device', default='cuda',
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--lookup', default='allgather',
                 choices=['allgather', 'alltoall', 'gspmd', 'hierarchical'],
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
    return cpu_refused('hybridbackend_tpu_torch.examples.taobao.train_din')
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def _configs(args: argparse.Namespace):
  import hybridbackend_tpu_torch as hbt
  return (hbt.TableConfig('item', ITEM_VOCAB, args.dim),
          hbt.TableConfig('user', USER_VOCAB, args.dim))


def _tower(args: argparse.Namespace, device: torch.device,
           gen: torch.Generator) -> nn.Module:
  import hybridbackend_tpu_torch as hbt
  return (hbt.DINSession if args.sessions else hbt.DIN)(
      args.dim, 1, 0, generator=gen, device=device)


def _loss(tower, query, keys, profile, batch):
  """DIN or DINSession (by the mask's rank) with BCE, the predictions and
  per-example losses in aux."""
  from hybridbackend_tpu_torch.benchmarks.train_benchmark import bce
  return bce(tower(query, keys, batch['hist_mask'], [profile]),
             batch['label'])


def sparse_trainer(args: argparse.Namespace, device: torch.device,
                   ctx=None):
  """``--sparse``: the item and user tables in one stack under row-sparse
  Adagrad 0.1 (accumulator 0.1), the tower under Adam 1e-3, GAUC by
  ``user``, in raw mode: the model reads ``cand_hist``'s uncombined
  ``[B, 1 + L, D]`` embeddings (the sessions restored from the mask's
  shape). In the world ``ctx`` (a world of one on ``device`` when None),
  the rank's shard of the stack, looked up through ``--lookup``."""
  import hybridbackend_tpu_torch as hbt
  ctx = ctx or hbt.Context(device)
  item, user = _configs(args)
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(item, column='cand_hist'), hbt.EmbeddingSpec(user)],
      ctx=ctx)
  gen = torch.Generator().manual_seed(SEED)
  tables = fx.init(gen)
  tower = _tower(args, ctx.device, gen)

  def raw_loss(t, members, batch):
    emb, mask = members['item'], batch['hist_mask']
    keys = emb[:, 1:].reshape(emb.shape[0], *mask.shape[1:], emb.shape[-1])
    return _loss(t, emb[:, 0], keys, members['user'], batch)

  return hbt.SparseTrainer(fx, None, tower, tables=tables,
                           raw_model_loss=raw_loss, table_lr=0.1,
                           model_dir=args.model_dir or None,
                           group_key='user', lookup_strategy=args.lookup)


def dense_trainer(args: argparse.Namespace, device: torch.device, ctx=None):
  """Without ``--sparse``: one table per column under
  ``multi_optimizer(Adagrad 0.1, Adam 1e-3)``, GAUC by ``user``; in the
  world ``ctx``, data-parallel over the rank's shards of the tables,
  looked up through ``--lookup``."""
  import hybridbackend_tpu_torch as hbt
  ctx = ctx or hbt.Context(device)
  item, user = _configs(args)
  gen = torch.Generator().manual_seed(SEED)
  module = nn.ModuleDict({
      'tables': hbt.init_tables([hbt.EmbeddingSpec(item),
                                 hbt.EmbeddingSpec(user)], gen, ctx.device,
                                ctx),
      'net': _tower(args, ctx.device, gen)})

  def loss_fn(m, batch):
    t = m['tables']
    look = lambda name, col, cfg: hbt.lookup(t[name], batch[col], cfg,
                                             ctx=ctx, strategy=args.lookup)
    return _loss(m['net'], look('item', 'item', item),
                 look('item', 'hist', item), look('user', 'user', user),
                 batch)

  optimizer = hbt.multi_optimizer(
      functools.partial(hbt.Adagrad, lr=0.1),
      functools.partial(torch.optim.Adam, lr=1e-3))(module)
  return hbt.Trainer(loss_fn, module, optimizer,
                     model_dir=args.model_dir or None, ctx=ctx,
                     group_key='user')


def fields(args: argparse.Namespace):
  import hybridbackend_tpu_torch as hbt
  if args.sessions:
    return [hbt.Field('hist', ragged_rank=2,
                      max_len=(args.max_sessions, args.max_hist))]
  return [hbt.Field('hist', ragged_rank=1, max_len=args.max_hist)]


def add_cand_hist(args: argparse.Namespace,
                  b: Dict[str, Any]) -> Dict[str, Any]:
  """With ``--sparse``, the ``cand_hist`` column (JAX ``:199-212``): the
  candidate, then the history, flattened from ``[B, S, L]`` with ``-1``
  where the mask is false under ``--sessions``."""
  if not args.sparse:
    return b
  b = dict(b)
  hist = np.asarray(b['hist'])
  if args.sessions:
    mask = np.asarray(b['hist_mask']).reshape(hist.shape[0], -1)
    hist = np.where(mask.astype(bool), hist.reshape(hist.shape[0], -1), -1)
  b['cand_hist'] = np.concatenate([np.asarray(b['item'])[:, None], hist],
                                  axis=1)
  return b


def batches(args: argparse.Namespace, shuffle: bool, ctx=None):
  """The file's parsed batches of ``--batch-size`` rows: shuffled for
  training (unless ``--no-shuffle``), in file order for evaluation; in
  the world ``ctx``, of the rank's row groups."""
  import hybridbackend_tpu_torch as hbt
  part = {} if ctx is None else dict(partition_index=ctx.rank,
                                     partition_count=ctx.world_size)
  ds = hbt.data.Dataset.from_parquet(args.data, batch_size=args.batch_size,
                                     drop_remainder=True,
                                     shuffle=shuffle and not args.no_shuffle,
                                     **part)
  f = fields(args)
  return (add_cand_hist(args, hbt.data.parse(b, f)) for b in ds)


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'taobao/train_din.py: {why}', file=sys.stderr)
    return 1
  try:
    in_world(args.device, lambda ctx: run(args, ctx))
  except FileTooSmall as e:
    print(f'taobao/train_din.py: {e}', file=sys.stderr)
    return 1
  return 0


def run(args: argparse.Namespace, ctx=None):
  """Trains and evaluates as the flags say; returns the trainer. In the
  world ``ctx`` (a joined context), this rank's trainer."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.distribute import collective
  world = ctx.world_size if ctx is not None else 1
  chief = ctx is None or ctx.is_chief
  say = print if chief else (lambda *a, **k: None)
  if not args.data:
    name = 'taobao_sessions.parquet' if args.sessions else (
        'taobao_sample.parquet')
    args.data = os.path.join(tempfile.gettempdir(), name)
  if (args.synthesize or not os.path.exists(args.data)) and chief:
    say(f'synthesizing {args.rows} rows → {args.data}')
    synthesize(args.data, args.rows, sessions=args.sessions,
               row_group=row_group_for(args.rows, ROW_GROUP, world))
  if world > 1:
    # The other ranks wait for the sample.
    collective.allreduce(torch.zeros(1, device=ctx.device), ctx=ctx)
    check_row_groups(args.data, world)
  device = ctx.device if ctx is not None else torch.device(args.device)
  trainer = (sparse_trainer if args.sparse else dense_trainer)(
      args, device, ctx)
  hooks = [hbt.LoggingHook(every_n_steps=25, log=print)]
  for epoch in range(args.epochs):
    trainer.train(batches(args, True, ctx), max_steps=args.steps,
                  hooks=hooks)
    say(f'epoch {epoch}:', trainer.evaluate(batches(args, False, ctx)))
  return trainer


if __name__ == '__main__':
  sys.exit(main())
