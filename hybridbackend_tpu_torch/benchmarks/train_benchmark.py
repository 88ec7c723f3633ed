"""End-to-end train-step benchmark of the port (flagship ranking model).

Counterpart of ``benchmarks/train_benchmark.py``, the JAX package's
harness, in both its modes. With ``--sparse``: stacked embedding tables
updated by row-sparse Adagrad (0.05, accumulator 0.1) through the port's
kernels and a DCNv2 or DLRM tower under Adam (1e-3). Without it, the
dense-gradient path (``:133-145`` there): one table per column, every
table's dense gradient, ``multi_optimizer`` with the optax-equivalent
Adagrad (0.05, accumulator 0.1) on the tables and Adam (1e-3) on the
tower, through ``make_train_step``. BCE loss, batch ids shifted by one
every step. The flags and their defaults are the JAX harness's; weights
and batch are drawn from seed 0, as there. Run on one CUDA device:

  python -m hybridbackend_tpu_torch.benchmarks.train_benchmark [--sparse] \\
      [--table-dtype bfloat16] [--model dlrm] [--bf16] [--no-dedup] \\
      [--interleave K] [--json]

Under the port's launcher the harness runs one rank of a world of N and
takes its world from the process group: ``--sparse`` tables row-sharded
over the ranks and looked up through ``--lookup allgather|alltoall``,
the tower data-parallel. ``--batch`` is the global batch: every rank
draws the same batch from the seed and steps on its rows of it, so a
world of one and one of N consume the same data. Rank 0 alone prints
the report, with the world, the strategy, the backend, and examples/s
of the global batch:

  python -m hybridbackend_tpu_torch.run --simulate 2 -m \
      hybridbackend_tpu_torch.benchmarks.train_benchmark --sparse \
      --lookup alltoall --json

Gloo ranks that share one card (``--simulate N --device cuda``) check
correctness only: their times say nothing of NCCL or of links between
cards.

With ``--sparse --interleave K`` the step is the PICASSO interleaved one
(``pipeline.make_interleaved_train_step``, as the JAX harness builds it
at ``:121-127``): the batch in K micro-batches whose lookups run on a
side stream beside the tower, one table update a step.

Timing: 3 untimed steps, then ``--repeats`` windows (3) of
``--inner-steps`` steps (20, the JAX harness's window) enqueued back to
back, with a CUDA event before each step and after the last. As the JAX harness reports them, ``ms_per_step_best``
is the best window over its steps and ``torch_train_examples_per_sec``
the batch times the steps over that window; ``torch_train_step_ms`` is
the median of the gaps between consecutive events over all windows, and
``ms_per_step_repeats`` each window over its steps. On ``--device cpu``
(for tests at small shapes) a host clock takes the events' place; a step
there runs synchronously. The JSON line carries the flags, the device
and, on a card, its name and power limit as ``nvidia-smi`` prints them,
and the kernel launches of the timed steps. TF32 stays off (PyTorch's
default for matmuls): the tower's f32 matmuls are exact f32.

Refused, each with its reason: a host mesh in one process (``--cpu N``:
the port's ranks are processes, started by the launcher);
``--no-dedup`` or ``--interleave`` without ``--sparse``, as both apply
to the sparse step only; ``--no-dedup`` with ``--interleave``, as the
JAX harness refuses it; in a world of more than one rank, the dense
mode, ``--interleave``, ``--no-dedup`` and bf16 tables (ROADMAP item
15b).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

# The wrappers that count their kernel launches.
COUNTED = ('adagrad_update_sorted', 'scatter_add_sorted', 'adam_update_sorted',
           'gsum_dense_sorted', 'gather_rows', 'stochastic_round_bf16')
SEED = 0
WARMUP = 3
TABLE_LR = 0.05
ADAGRAD_INIT = 0.1
TOWER_LR = 1e-3


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--batch', type=int, default=8192)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--tables', type=int, default=26)
  p.add_argument('--dense-features', type=int, default=13)
  p.add_argument('--vocab', type=int, default=100_000)
  p.add_argument('--inner-steps', type=int, default=20,
                 help='timed steps per repeat (the window of '
                      'ms_per_step_best)')
  p.add_argument('--repeats', type=int, default=3)
  p.add_argument('--model', default='dcnv2', choices=['dcnv2', 'dlrm'])
  p.add_argument('--sparse', action='store_true',
                 help='stacked tables + row-sparse Adagrad (no dense '
                      '[V, D] gradients)')
  p.add_argument('--bf16', action='store_true',
                 help='bfloat16 matmul operands with f32 results (params '
                      'stay f32)')
  p.add_argument('--no-dedup', action='store_true',
                 help='accumulate each occurrence\'s square (TF '
                      'SparseApplyAdagrad)')
  p.add_argument('--interleave', type=int, default=0, metavar='K',
                 help='sparse mode: PICASSO interleaving over K '
                      'micro-batches')
  p.add_argument('--table-dtype', default='float32',
                 choices=['float32', 'bfloat16'],
                 help='embedding table and slot storage dtype')
  p.add_argument('--lookup', default='allgather',
                 choices=['allgather', 'alltoall'],
                 help='the sharded tables\' exchange, under the launcher')
  p.add_argument('--cpu', type=int, default=0,
                 help='devices of a host mesh (not ported: start ranks '
                      'with python -m hybridbackend_tpu_torch.run)')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--json', action='store_true')
  return p.parse_args(argv)


def unsupported(args: argparse.Namespace) -> Optional[str]:
  """Why these flags cannot run, or None."""
  if args.no_dedup and not args.sparse:
    return '--no-dedup applies to the sparse update only; pass --sparse'
  if args.interleave > 0 and not args.sparse:
    return ('--interleave applies to the sparse step only (the micro-'
            'batches\' lookups beside the tower); pass --sparse')
  if args.interleave > 0 and args.no_dedup:
    return '--no-dedup is not supported with --interleave'
  if args.cpu:
    return ('--cpu N (a mesh of N host devices in one process) is not '
            'ported; start N ranks with python -m hybridbackend_tpu_torch.run '
            '--simulate N -m hybridbackend_tpu_torch.benchmarks.'
            'train_benchmark')
  if launched() and int(os.environ['WORLD_SIZE']) > 1:
    if not args.sparse:
      return ('the dense mode in a world of more than one rank is ROADMAP '
              'item 15b (5); pass --sparse')
    if args.interleave > 0:
      return ('--interleave in a world of more than one rank is ROADMAP '
              'item 15b (7)')
    if args.no_dedup:
      return ('--no-dedup in a world of more than one rank is ROADMAP item '
              '15b (1)')
    if args.table_dtype != 'float32':
      return ('bf16 tables in a world of more than one rank are ROADMAP '
              'item 15b (9)')
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def launched() -> bool:
  """Whether this process is a rank started by the port's launcher (or
  another that sets ``WORLD_SIZE``)."""
  return 'WORLD_SIZE' in os.environ


def card() -> Optional[str]:
  """``name, power.limit`` of the first card, as nvidia-smi prints it."""
  out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def _specs(args: argparse.Namespace):
  import hybridbackend_tpu_torch as hbt
  tdt = torch.bfloat16 if args.table_dtype == 'bfloat16' else torch.float32
  return [hbt.EmbeddingSpec(hbt.TableConfig(f'c{i}', args.vocab, args.dim,
                                            dtype=tdt))
          for i in range(args.tables)]


def _tower(args: argparse.Namespace, device: torch.device,
           gen: torch.Generator):
  """The tower of ``--model`` and ``preds(tower, emb_f, dense_f)``."""
  import hybridbackend_tpu_torch as hbt
  cdt = torch.bfloat16 if args.bf16 else None
  if args.model == 'dcnv2':
    tower = hbt.StackedDCNv2(
        [args.dim] * args.tables + [1] * args.dense_features,
        [1024, 512, 256, 1], compute_dtype=cdt, generator=gen, device=device)
    return tower, lambda t, emb_f, dense_f: t(emb_f + dense_f)
  tower = hbt.DLRM(args.dense_features, args.tables, [512, 256], args.dim,
                   [1024, 512, 1], compute_dtype=cdt, generator=gen,
                   device=device)
  return tower, lambda t, emb_f, dense_f: t(dense_f, emb_f)


def bce(preds: torch.Tensor, y: torch.Tensor):
  """The mean binary cross-entropy of clipped predictions, with the
  predictions and per-example losses that the trainers' metrics read."""
  p = torch.clamp(preds, 1e-6, 1 - 1e-6)
  pel = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
  return torch.mean(pel), {'preds': p, 'per_example_loss': pel}


def sparse_parts(args: argparse.Namespace, device: torch.device,
                 ctx=None):
  """``(fx, tables, tower, model_loss)`` of the sparse config ``args`` on
  ``device``, drawn on the CPU from ``SEED`` (so every device starts from
  one state); in the world ``ctx``, with this rank's shards."""
  import hybridbackend_tpu_torch as hbt
  fx = hbt.StackedFeatureExtractor(
      _specs(args),
      dense_columns=[f'i{d}' for d in range(args.dense_features)],
      ctx=ctx or hbt.Context(device))
  gen = torch.Generator().manual_seed(SEED)
  tables = fx.init(gen)
  tower, preds = _tower(args, device, gen)

  def model_loss(t, emb_f, dense_f, batch):
    return bce(preds(t, emb_f, dense_f), batch['label'])

  return fx, tables, tower, model_loss


def sparse_trainer(args: argparse.Namespace, device: torch.device,
                   model_dir: Optional[str] = None,
                   table_optimizer: str = 'adagrad'):
  """The sparse config ``args`` as a ``SparseTrainer`` on ``device`` (the
  weights of :func:`sparse_parts`, the harness's table lr, accumulator
  and tower Adam) with row-sparse ``table_optimizer``, checkpointing
  into ``model_dir``."""
  import hybridbackend_tpu_torch as hbt
  fx, tables, tower, model_loss = sparse_parts(args, device)
  return hbt.SparseTrainer(
      fx, model_loss, tower, tables=tables,
      dense_optimizer=functools.partial(torch.optim.Adam, lr=TOWER_LR),
      table_lr=TABLE_LR, adagrad_init=ADAGRAD_INIT,
      table_optimizer=table_optimizer, model_dir=model_dir)


def dense_parts(args: argparse.Namespace, device: torch.device):
  """``(loss_fn, module, optimizer)`` of the dense-gradient config
  ``args`` on ``device``, in the order ``Trainer`` takes them: the
  ``init_tables`` tables under ``tables``, the tower under ``net``, and
  ``multi_optimizer(Adagrad, Adam)``; drawn on the CPU from ``SEED``."""
  import hybridbackend_tpu_torch as hbt
  specs = _specs(args)
  dense_names = [f'i{d}' for d in range(args.dense_features)]
  gen = torch.Generator().manual_seed(SEED)
  tables = hbt.init_tables(specs, gen, device)
  tower, preds = _tower(args, device, gen)
  module = nn.ModuleDict({'tables': tables, 'net': tower})

  def loss_fn(m, batch):
    emb_f, dense_f = hbt.extract_features(m['tables'], batch, specs,
                                          dense_names)
    return bce(preds(m['net'], emb_f, dense_f), batch['label'])

  optimizer = hbt.multi_optimizer(
      functools.partial(hbt.Adagrad, lr=TABLE_LR,
                        initial_accumulator_value=ADAGRAD_INIT),
      functools.partial(torch.optim.Adam, lr=TOWER_LR))(module)
  return loss_fn, module, optimizer


def build(args: argparse.Namespace, device: torch.device,
          table_optimizer: str = 'adagrad', split_dense: bool = False,
          ctx=None, **exchange):
  """The state and the step of the config ``args`` on ``device``: the
  sparse step with ``--sparse`` (the interleaved one with
  ``--interleave K``), the dense-gradient step without.
  ``table_optimizer`` (``'adam'`` for LazyAdam) and ``split_dense`` are
  sparse-step options beyond the JAX harness's Adagrad. ``ctx`` is the
  world of a rank, and ``exchange`` the sparse step's other exchange
  options (``lookup_bucket_ratio``, ``update_bucket_ratio``, ...); the
  strategy is ``--lookup``."""
  import hybridbackend_tpu_torch as hbt
  if not args.sparse:
    loss_fn, module, optimizer = dense_parts(args, device)
    return (hbt.TrainState.create(module, optimizer),
            hbt.make_train_step(loss_fn))
  fx, tables, tower, model_loss = sparse_parts(args, device, ctx)
  state = hbt.SparseTrainState.create(
      tower, tables, functools.partial(torch.optim.Adam, lr=TOWER_LR),
      adagrad_init=ADAGRAD_INIT, adam=table_optimizer == 'adam', ctx=ctx)
  if args.interleave > 0:
    if split_dense:
      raise ValueError('the interleaved step has no split-dense update')
    return state, hbt.make_interleaved_train_step(
        fx, model_loss, args.interleave, table_lr=TABLE_LR,
        table_optimizer=table_optimizer)
  step = hbt.make_sparse_train_step(fx, model_loss, table_lr=TABLE_LR,
                                    table_dedup=not args.no_dedup,
                                    table_optimizer=table_optimizer,
                                    table_split_dense=split_dense,
                                    lookup_strategy=args.lookup, **exchange)
  return state, step


def make_batch(args: argparse.Namespace, device: torch.device,
               seed: int = SEED, rows: slice = slice(None)):
  """The JAX harness's draws from ``RandomState(seed)``, in its order: ids
  per table, dense features, labels. Returns the dense features and
  labels, and the ids as one [B, tables] tensor whose columns the batch
  views (``shifted``); of the ``rows`` of the batch (a rank's share)."""
  rng = np.random.RandomState(seed)
  ids = np.stack([rng.randint(0, args.vocab, args.batch)
                  for _ in range(args.tables)], axis=1).astype(np.int32)
  base = {f'i{d}': torch.from_numpy(rng.rand(args.batch).astype(
      np.float32)[rows]).to(device) for d in range(args.dense_features)}
  base['label'] = torch.from_numpy(
      rng.randint(0, 2, args.batch).astype(np.float32)[rows]).to(device)
  return base, torch.from_numpy(ids[rows]).to(device)


def shifted(base: Dict[str, torch.Tensor], ids: torch.Tensor, vocab: int,
            i: int) -> Dict[str, torch.Tensor]:
  """The batch of step ``i``: every id moved by ``i`` (``:167`` of the JAX
  harness), one add and one remainder over the [B, tables] ids."""
  moved = (ids + i).remainder_(vocab)
  batch = dict(base)
  batch.update({f'c{t}': moved[:, t] for t in range(ids.shape[1])})
  return batch


class Window(NamedTuple):
  """One window of steps timed by :func:`time_steps`."""
  state: Any
  losses: List[torch.Tensor]
  gaps: List[float]       # ms between the marks after consecutive steps
  ms: float               # ms from the first mark to the last
  wall_ms: float          # host clock, from an idle device to the last step
  fetch_ms: float         # host ms spent in ``batch``


def time_steps(state, step, batch: Callable[[int], Dict[str, torch.Tensor]],
               first: int, steps: int, device: torch.device) -> Window:
  """Steps ``first`` to ``first + steps - 1``, step ``i`` on ``batch(i)``,
  enqueued back to back, with a mark before each step and after the
  last: CUDA events on a card, the host clock on the CPU. The device is
  idle before the first mark and after the last step."""
  on_card = device.type == 'cuda'
  if on_card:
    def mark():
      event = torch.cuda.Event(enable_timing=True)
      event.record()
      return event
    elapsed = lambda a, b: a.elapsed_time(b)
    torch.cuda.synchronize(device)
  else:
    mark = time.perf_counter
    elapsed = lambda a, b: (b - a) * 1e3
  t0 = time.perf_counter()
  losses, marks, fetch_s = [], [mark()], 0.0
  for i in range(first, first + steps):
    f0 = time.perf_counter()
    b = batch(i)
    fetch_s += time.perf_counter() - f0
    state, m = step(state, b)
    marks.append(mark())
    losses.append(m['loss'])
  if on_card:
    torch.cuda.synchronize(device)
  wall_ms = (time.perf_counter() - t0) * 1e3
  gaps = [elapsed(a, b) for a, b in zip(marks, marks[1:])]
  return Window(state, losses, gaps, elapsed(marks[0], marks[-1]), wall_ms,
                fetch_s * 1e3)


def run(args: argparse.Namespace, ctx=None) -> dict:
  """Builds the config, times it and returns the report; in the world
  ``ctx``, this rank's report."""
  import hybridbackend_tpu_torch as hbt
  device = ctx.device if ctx is not None else torch.device(args.device)
  on_card = device.type == 'cuda'
  state, step = build(args, device, ctx=ctx)
  base, ids = make_batch(args, device, rows=(
      ctx.rows(args.batch) if ctx is not None else slice(None)))
  batch = functools.partial(shifted, base, ids, args.vocab)
  state = time_steps(state, step, batch, 0, WARMUP, device).state
  for name in COUNTED:
    getattr(hbt, name).launches = 0
  gaps, windows, losses = [], [], []
  for r in range(args.repeats):
    w = time_steps(state, step, batch, WARMUP + r * args.inner_steps,
                   args.inner_steps, device)
    state = w.state
    losses += w.losses
    gaps += w.gaps
    windows.append(w.ms)
  losses = torch.stack(losses).float().cpu()
  if not bool(torch.isfinite(losses).all()):
    raise RuntimeError(f'non-finite loss: {losses.tolist()}')
  best = min(windows)
  return {
      'metric': 'torch_train_examples_per_sec',
      'torch_train_examples_per_sec': (args.batch * args.inner_steps / best
                                       * 1e3),
      'ms_per_step_best': best / args.inner_steps,
      'torch_train_step_ms': statistics.median(gaps),
      'ms_per_step_repeats': [w / args.inner_steps for w in windows],
      'timed_steps': args.inner_steps * args.repeats,
      'final_loss': float(losses[-1]),
      'model': args.model, 'sparse': args.sparse,
      'interleave': args.interleave, 'bf16': args.bf16,
      'no_dedup': args.no_dedup, 'table_dtype': args.table_dtype,
      'batch': args.batch, 'tables': args.tables, 'dim': args.dim,
      'vocab': args.vocab, 'dense_features': args.dense_features,
      'inner_steps': args.inner_steps, 'repeats': args.repeats,
      'device': str(device),
      'world': ctx.world_size if ctx is not None else 1,
      'lookup': args.lookup,
      'backend': (torch.distributed.get_backend(ctx.group)
                  if ctx is not None else None),
      'device_name': torch.cuda.get_device_name(device) if on_card else 'cpu',
      'card': card() if on_card else None,
      'timing': 'cuda events' if on_card else 'host clock',
      'kernel_launches': {name: getattr(hbt, name).launches
                          for name in COUNTED},
  }


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'train_benchmark: {why}', file=sys.stderr)
    return 1
  ctx = None
  if launched():
    import hybridbackend_tpu_torch as hbt
    ctx = hbt.Context.join(args.device)
  try:
    result = run(args, ctx)
  finally:
    if ctx is not None:
      ctx.leave()
  if ctx is not None and ctx.rank != 0:
    return 0
  if args.json:
    print(json.dumps(result))
  else:
    for key, value in result.items():
      print(f'{key:>30}: {value}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
