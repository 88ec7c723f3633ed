"""DIN training-step benchmark of the port (ragged behaviour sequences).

Counterpart of ``benchmarks/din_benchmark.py``, the JAX package's
harness, with its flags and defaults: an item table of [``--vocab``,
``--dim``] and a user table of a tenth of its rows, a DIN tower (DNN
256-128-64, attention 80-40, the user embedding as its one profile
feature, 2 dense features), a history of ``--hist`` ids per row with a
mask of seeded lengths, batch ``--batch``, BCE loss, ids moved by one
every step (the ``-1`` holes stay ``-1``). Its modes:

* without ``--sparse``, the dense-gradient step (``Trainer``'s): one
  table per column, the candidate and the history looked up together,
  ``multi_optimizer`` with the optax-equivalent Adagrad (0.05,
  accumulator 0.1) on the tables and Adam (1e-3) on the tower;
* ``--sparse``: the sparse step in raw mode (``raw_model_loss``), both
  tables in one stack, one ``cand_hist`` column ``[B, 1 + hist]`` of the
  candidate and its history, Adagrad 0.05 with the accumulator at 0.1
  through kernel 1 (``adagrad_update_sorted``), Adam 1e-3 on the tower;
* ``--sessions S``: the history as ``[B, S, hist / S]`` with a two-level
  mask, through ``DINSession``; with ``--sparse`` the flattened
  ``cand_hist`` of ``[B, 1 + hist]`` carries ``-1`` where the mask is
  false, and those holes move no row.

Weights and batch are drawn from seed 0 (the batch with the JAX
harness's draws, in its order). Run on one CUDA device:

  python -m hybridbackend_tpu_torch.benchmarks.din_benchmark [--sparse] \\
      [--sessions 4] [--json]

``--sparse`` runs under the port's launcher too, as one rank of a world
of N (the counterpart of the JAX harness's ``--cpu N`` world): the stack
row-sharded over the ranks and looked up through ``--lookup
allgather|alltoall``, the tower data-parallel, ``--wire-dtype`` and
``--gradient-wire-dtype`` on the wire as in ``train_benchmark``.
``--batch`` is the global batch, every rank steps on its rows of it, and
rank 0 alone prints the report, with the world, the strategy and the
backend:

  python -m hybridbackend_tpu_torch.run --simulate 2 -m \\
      hybridbackend_tpu_torch.benchmarks.din_benchmark --sparse \\
      --lookup alltoall --json

The dense mode runs there too, data-parallel: both tables row-sharded
and looked up through the differentiable sharded lookup, each rank on its
rows of the global batch, with ``--gradient-wire-dtype`` (which falls
back to f32 with row-sharded tables, as JAX's does).

Timing is the train harness's (``train_benchmark.time_steps``): 3
untimed steps, then ``--repeats`` windows of ``--inner-steps`` steps
enqueued back to back with a CUDA event before each step and after the
last. As the JAX harness reports them, ``ms_per_step`` is the best
window over its steps and ``din_examples_per_sec`` the batch times the
steps over that window; ``torch_din_step_ms`` is the median of the gaps
between consecutive events over all windows. The JSON line carries the
flags, the device, on a card its name and power limit as ``nvidia-smi``
prints them, and the counted kernels' launches over the timed steps
(kernel 1 once a step with ``--sparse``, none without). ``--device cpu``
runs at a small shape for the tests, on the host clock.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb

NUM_DENSE = 2
DNN = (256, 128, 64)
ATT = (80, 40)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--batch', type=int, default=2048)
  p.add_argument('--dim', type=int, default=32)
  p.add_argument('--hist', type=int, default=64)
  p.add_argument('--vocab', type=int, default=1_000_000)
  p.add_argument('--inner-steps', type=int, default=20,
                 help='timed steps per window')
  p.add_argument('--repeats', type=int, default=3)
  p.add_argument('--sparse', action='store_true',
                 help='row-sparse table updates through the sparse step '
                      'in raw mode')
  p.add_argument('--sessions', type=int, default=0, metavar='S',
                 help='session-grouped history: [B, S, hist/S] and a '
                      'two-level mask through DINSession')
  p.add_argument('--lookup', default='allgather',
                 choices=['allgather', 'alltoall'],
                 help='the sharded stack\'s exchange, under the launcher')
  p.add_argument('--wire-dtype', default='float32',
                 choices=tb.WIRE_DTYPES,
                 help='the alltoall lookup\'s returning rows on the wire, '
                      'under the launcher')
  p.add_argument('--gradient-wire-dtype', default='float32',
                 choices=tb.WIRE_DTYPES,
                 help='the gradients on the wire, under the launcher')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--json', action='store_true')
  return p.parse_args(argv)


def unsupported(args: argparse.Namespace) -> Optional[str]:
  """Why these flags cannot run, or None."""
  if args.sessions and args.hist % args.sessions:
    return '--hist must divide by --sessions'
  if not args.sparse and args.wire_dtype != 'float32':
    return ('--wire-dtype applies to the --sparse step\'s alltoall lookup '
            'only')
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def _configs(args: argparse.Namespace):
  import hybridbackend_tpu_torch as hbt
  return (hbt.TableConfig('item', args.vocab, args.dim),
          hbt.TableConfig('user', args.vocab // 10, args.dim))


def _tower(args: argparse.Namespace, device: torch.device,
           gen: torch.Generator) -> nn.Module:
  import hybridbackend_tpu_torch as hbt
  return (hbt.DINSession if args.sessions else hbt.DIN)(
      args.dim, 1, NUM_DENSE, DNN, ATT, generator=gen, device=device)


def din_loss(args: argparse.Namespace, normalize: bool = False):
  """``loss(tower, item_emb [B, 1 + hist, D], user_emb [B, D], batch)``:
  the candidate first, its history (as sessions with ``--sessions``)
  after it, BCE with the predictions and per-example losses in aux."""
  def loss(tower, emb, user, batch):
    keys, mask = emb[:, 1:], batch['hist_mask']
    if args.sessions:
      keys = keys.reshape(emb.shape[0], *mask.shape[1:], emb.shape[-1])
    preds = tower(emb[:, 0], keys, mask, [user], [batch['d0'], batch['d1']],
                  att_weight_normalization=normalize)
    return tb.bce(preds, batch['label'])
  return loss


def extractor(args: argparse.Namespace, device: torch.device, ctx=None):
  """The ``--sparse`` feature extractor: both tables in one stack,
  ``cand_hist`` on the item table and ``user`` on the user table; in the
  world ``ctx``, the stack row-sharded over it."""
  import hybridbackend_tpu_torch as hbt
  item, user = _configs(args)
  return hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(item, column='cand_hist'), hbt.EmbeddingSpec(user)],
      ctx=ctx or hbt.Context(device))


def sparse_parts(args: argparse.Namespace, device: torch.device,
                 normalize: bool = False, ctx=None):
  """``(fx, tables, tower, raw_model_loss)`` of ``--sparse`` on
  ``device``, drawn on the CPU from ``SEED``; ``normalize`` is the
  attention's weight normalization; in the world ``ctx``, with this
  rank's shard of the stack."""
  fx = extractor(args, device, ctx)
  gen = torch.Generator().manual_seed(tb.SEED)
  tables = fx.init(gen)
  tower = _tower(args, device, gen)
  loss = din_loss(args, normalize)

  def raw_model_loss(t, members, batch):
    return loss(t, members['item'], members['user'], batch)

  return fx, tables, tower, raw_model_loss


def sparse_trainer(args: argparse.Namespace, device: torch.device,
                   model_dir: Optional[str] = None, normalize: bool = False):
  """``--sparse`` as a raw-mode ``SparseTrainer`` on ``device``, with the
  harness's weights, table lr, accumulator and tower Adam."""
  import hybridbackend_tpu_torch as hbt
  fx, tables, tower, raw_model_loss = sparse_parts(args, device, normalize)
  return hbt.SparseTrainer(
      fx, None, tower, tables=tables,
      dense_optimizer=functools.partial(torch.optim.Adam, lr=tb.TOWER_LR),
      table_lr=tb.TABLE_LR, adagrad_init=tb.ADAGRAD_INIT,
      model_dir=model_dir, raw_model_loss=raw_model_loss)


def build(args: argparse.Namespace, device: torch.device, ctx=None):
  """The state and the step of ``args`` on ``device``: the sparse step in
  raw mode with ``--sparse`` (in the world ``ctx``, with the exchange and
  wire flags), the dense-gradient step without (in the world ``ctx``,
  data-parallel with row-sharded tables)."""
  import hybridbackend_tpu_torch as hbt
  if args.sparse:
    fx, tables, tower, raw_model_loss = sparse_parts(args, device, ctx=ctx)
    state = hbt.SparseTrainState.create(
        tower, tables, functools.partial(torch.optim.Adam, lr=tb.TOWER_LR),
        adagrad_init=tb.ADAGRAD_INIT, ctx=ctx)
    return state, hbt.make_sparse_train_step(
        fx, None, table_lr=tb.TABLE_LR, raw_model_loss=raw_model_loss,
        lookup_strategy=args.lookup, update_exchange=args.lookup,
        wire_dtype=args.wire_dtype,
        gradient_wire_dtype=args.gradient_wire_dtype)
  item, user = _configs(args)
  specs = [hbt.EmbeddingSpec(item), hbt.EmbeddingSpec(user)]
  gen = torch.Generator().manual_seed(tb.SEED)
  module = nn.ModuleDict({'tables': hbt.init_tables(specs, gen, device, ctx),
                          'net': _tower(args, device, gen)})
  loss = din_loss(args)

  def loss_fn(m, batch):
    # The candidate and its history in one lookup of the item table.
    ids = torch.cat([batch['item'][:, None], batch['hist']], dim=1)
    return loss(m['net'],
                hbt.lookup(m['tables']['item'], ids, item, ctx=ctx),
                hbt.lookup(m['tables']['user'], batch['user'], user,
                           ctx=ctx), batch)

  optimizer = hbt.multi_optimizer(
      functools.partial(hbt.Adagrad, lr=tb.TABLE_LR,
                        initial_accumulator_value=tb.ADAGRAD_INIT),
      functools.partial(torch.optim.Adam, lr=tb.TOWER_LR))(module)
  return (hbt.TrainState.create(module, optimizer, ctx),
          hbt.make_train_step(loss_fn, args.gradient_wire_dtype, ctx))


def make_batch(args: argparse.Namespace, device: torch.device,
               seed: int = tb.SEED, rows: slice = slice(None)):
  """The JAX harness's draws from ``RandomState(seed)``, in its order:
  the mask's lengths, then item, history, user, the dense features and
  the labels. Returns the columns that do not move, on ``device``; the
  ids that do as one ``[B, 1 + hist]`` tensor (the candidate, then the
  history; with ``--sparse --sessions``, ``-1`` where the mask is false),
  which ``shifted`` moves; and 1 where an id is valid, 0 at a hole; of
  the ``rows`` of the batch (a rank's share)."""
  rng = np.random.RandomState(seed)
  b, h, s = args.batch, args.hist, args.sessions
  if s:
    length = h // s
    slen = rng.randint(0, length + 1, (b, s))
    slen[:, 0] = np.maximum(slen[:, 0], 1)
    mask = np.arange(length)[None, None, :] < slen[:, :, None]
  else:
    mask = np.arange(h)[None, :] < rng.randint(1, h + 1, b)[:, None]
  item = rng.randint(0, args.vocab, b)
  hist = rng.randint(0, args.vocab, (b, h))
  base = {'hist_mask': mask,
          'user': rng.randint(0, args.vocab // 10, b).astype(np.int32),
          'd0': rng.rand(b, 1).astype(np.float32),
          'd1': rng.rand(b, 1).astype(np.float32),
          'label': rng.randint(0, 2, b).astype(np.float32)}
  if s and args.sparse:
    # Mask-derived -1 holes: padding ids must not touch rows.
    hist = np.where(mask.reshape(b, -1), hist, -1)
  ids = np.concatenate([item[:, None], hist], axis=1).astype(np.int32)[rows]
  return ({k: torch.from_numpy(v[rows]).to(device) for k, v in base.items()},
          torch.from_numpy(ids).to(device),
          torch.from_numpy((ids >= 0).astype(np.int32)).to(device))


def shifted(args: argparse.Namespace, base: Dict[str, torch.Tensor],
            ids: torch.Tensor, valid: torch.Tensor,
            i: int) -> Dict[str, torch.Tensor]:
  """The batch of step ``i``: every valid id moved by ``i`` modulo the
  vocab (JAX ``:166-180``), each ``-1`` hole left as it is: two ops on
  one ``[B, 1 + hist]`` tensor, ``ids + i * valid`` and its ``fmod``
  (which keeps a hole's sign). The ``--sparse`` batch holds it as
  ``cand_hist``; the dense one views it as ``item`` and ``hist``."""
  moved = torch.add(ids, valid, alpha=i % args.vocab).fmod_(args.vocab)
  batch = dict(base)
  if args.sparse:
    batch['cand_hist'] = moved
  else:
    batch['item'], batch['hist'] = moved[:, 0], moved[:, 1:]
  return batch


def run(args: argparse.Namespace, ctx=None) -> dict:
  """Builds the config, times it and returns the report; in the world
  ``ctx``, this rank's report."""
  import hybridbackend_tpu_torch as hbt
  device = ctx.device if ctx is not None else torch.device(args.device)
  on_card = device.type == 'cuda'
  state, step = build(args, device, ctx)
  batch = functools.partial(shifted, args, *make_batch(
      args, device, rows=(ctx.rows(args.batch) if ctx is not None
                          else slice(None))))
  state = tb.time_steps(state, step, batch, 0, tb.WARMUP, device).state
  for name in tb.COUNTED:
    getattr(hbt, name).launches = 0
  gaps, windows, losses = [], [], []
  for r in range(args.repeats):
    w = tb.time_steps(state, step, batch,
                      tb.WARMUP + r * args.inner_steps, args.inner_steps,
                      device)
    state = w.state
    losses += w.losses
    gaps += w.gaps
    windows.append(w.ms)
  losses = torch.stack(losses).float().cpu()
  if not bool(torch.isfinite(losses).all()):
    raise RuntimeError(f'non-finite loss: {losses.tolist()}')
  best = min(windows)
  steps = args.inner_steps * args.repeats
  launches = {name: getattr(hbt, name).launches for name in tb.COUNTED}
  return {
      'metric': 'din_examples_per_sec',
      'din_examples_per_sec': args.batch * args.inner_steps / best * 1e3,
      'ms_per_step': best / args.inner_steps,
      'torch_din_step_ms': statistics.median(gaps),
      'ms_per_step_repeats': [w / args.inner_steps for w in windows],
      'timed_steps': steps,
      'final_loss': float(losses[-1]),
      'batch': args.batch, 'hist': args.hist, 'dim': args.dim,
      'vocab': args.vocab, 'sparse': args.sparse, 'sessions': args.sessions,
      'inner_steps': args.inner_steps, 'repeats': args.repeats,
      'device': str(device),
      'world': ctx.world_size if ctx is not None else 1,
      'lookup': args.lookup, 'wire_dtype': args.wire_dtype,
      'gradient_wire_dtype': args.gradient_wire_dtype,
      'backend': (torch.distributed.get_backend(ctx.group)
                  if ctx is not None else None),
      'device_name': torch.cuda.get_device_name(device) if on_card else 'cpu',
      'card': tb.card() if on_card else None,
      'timing': 'cuda events' if on_card else 'host clock',
      'kernel_launches': launches,
      'adagrad_launches_per_step': launches['adagrad_update_sorted'] / steps,
  }


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'din_benchmark: {why}', file=sys.stderr)
    return 1
  result, chief = tb.in_world(args.device, lambda ctx: run(args, ctx))
  if not chief:
    return 0
  if args.json:
    print(json.dumps(result))
  else:
    for key, value in result.items():
      print(f'{key:>28}: {value}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
