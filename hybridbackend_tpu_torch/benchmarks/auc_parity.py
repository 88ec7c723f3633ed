"""Training-quality (AUC-convergence) parity: the exact dense baseline
against the port's fast path, on one CUDA device.

Counterpart of ``benchmarks/auc_parity.py``, the JAX package's harness,
with its data, flags and defaults. Step-level exactness is tested
elsewhere; this trains to the end and compares the eval AUCs:

* a deterministic synthetic CTR set with a planted nonlinear signal (the
  XOR of two per-id latent bits, a marginal bit and a dense term; the
  JAX harness's ``synthesize``, ``_latent_bits`` and ``_VOCAB_SEED``, so
  the same files) is written to Parquet, 1048576 training rows and
  131072 eval rows, 26 id columns of vocab 100000 and 2 dense ones; the
  model must learn embeddings to separate it;
* ``exact``: the dense-gradient ``Trainer`` (the stacked tables as
  parameters, their full ``[V, D]`` gradients, ``multi_optimizer(
  Adagrad(table_lr), Adam(dense_lr))``) at each of ``--exact-seeds`` (0
  and 1), whose spread is the run-to-run noise band;
* ``fast``: ``SparseTrainer``, the row-sparse Adagrad of the touched rows
  through kernel 1 (``adagrad_update_sorted``), from the weights of the
  first exact seed.

Both train DCNv2 (MLP 256-64-1) on batches of 8192 for 2 epochs through
the port's ``ParquetDataset`` (shuffled, seeded per epoch as in JAX) and
evaluate after each epoch. The verdict is JAX's: the band is the larger
of 1.5 times the exact seeds' spread and 0.006, ``parity_ok.fast`` says
whether the fast AUC lies within the band of the exact mean, and the
exit code is 1 when it does not.

* ``fast`` takes the JAX ``FAST_OPTIONS``' wires: ``wire_dtype`` and
  ``gradient_wire_dtype`` ``'bfloat16'`` (the alltoall lookup's returning
  rows, the tower's all-reduce and the routed table gradients), which a
  world of one does not use, as in JAX. Their third option, bf16 one-hot
  update contractions (``emb_update_matmul_precision``), is a TPU knob:
  the port's update kernels contract nothing one-hot, and the JSON says
  so under ``not_ported``;
* ``fast_overflow`` (unless ``--skip-overflow``): ``fast`` with JAX's
  ``OVERFLOW_OPTIONS``, lookup and update bucket ratios of 0.25 and
  ``unique_ratio`` 0.05, capacities far below what a batch needs, so
  that the exact fallbacks carry the steps. The fallbacks are counted
  where they run (``lookup.overflow_fallbacks`` and
  ``sparse_adagrad_apply.overflow_fallbacks``, the host predicates of
  ``embedding/lookup.py`` and ``embedding/sparse_update.py``, summed over
  the ranks), and in a world the verdict needs them to have fired. A
  world of one has no buckets and nothing to fall back from, so there
  the variant runs as JAX runs it on one device: the options change
  nothing, and the JSON reports, as JAX does, whether the first batch
  would overflow its buckets in a world (``overflow_must_fire``, the JAX
  harness's ``_overflow_expected``).

Under the port's launcher every variant runs at a world of N, the tables
row-sharded: each rank reads its part of each file (its row groups
``i ≡ rank (mod N)``) in batches of its ``--batch / N`` rows of the
global batch, and rank 0 alone prints. ``--cpu N`` (a mesh of N host
devices in one process) is refused: start N ranks with ``python -m
hybridbackend_tpu_torch.run --simulate N``.

  python -m hybridbackend_tpu_torch.benchmarks.auc_parity [--rows 1048576]
      [--json] [--device cuda|cpu]
  python -m hybridbackend_tpu_torch.run --simulate 2 --device cpu -m \\
      hybridbackend_tpu_torch.benchmarks.auc_parity --device cpu ...

The files are cached under ``--cache`` (default ``HB_BENCH_CACHE``, else
the temporary directory), named by shape. ``--device cpu`` runs small
shapes for the tests. The JSON line carries each variant's AUC curve,
seconds and kernel launches (by each kernel's own counter: on a card
kernel 1 once a ``fast`` step, none for ``exact``), the device and, on a
card, its name and power limit as ``nvidia-smi`` prints them.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb

_VOCAB_SEED = 1234567
DENSE_COLUMNS = ('i0', 'i1')
MLP = (256, 64, 1)
NOT_PORTED = {
    'emb_update_matmul_precision': 'a TPU knob of FAST_OPTIONS (bf16 '
                                   'one-hot update contractions): the '
                                   'port\'s update kernels contract nothing '
                                   'one-hot',
}
FAST_OPTIONS = {'wire_dtype': 'bfloat16', 'gradient_wire_dtype': 'bfloat16'}
OVERFLOW_OPTIONS = {**FAST_OPTIONS, 'lookup_bucket_ratio': 0.25,
                    'update_bucket_ratio': 0.25, 'unique_ratio': 0.05}
VARIANT_OPTIONS = {'fast': FAST_OPTIONS, 'fast_overflow': OVERFLOW_OPTIONS}


def _latent_bits(vocab: int, col: int) -> np.ndarray:
  """The per-id latent bit of column ``col`` (the signal the embeddings
  must recover): the JAX harness's draw."""
  rng = np.random.RandomState(_VOCAB_SEED + col)
  return rng.rand(vocab) < 0.5


def row_group(rows: int, world: int = 1) -> int:
  """The rows of a row group of a file of ``rows`` rows: the JAX
  harness's, fewer when that leaves a rank of the world none."""
  return tb.row_group_for(rows, max(8192, rows // 64), world)


def synthesize(path: str, rows: int, tables: int, vocab: int,
               seed: int, world: int = 1) -> None:
  """The JAX harness's Parquet CTR sample: zipf(1.3) ids, exponential
  dense columns, the label from XOR(b0, b1) + b2 + tanh(i0 - 1), drawn in
  its order, in row groups of :func:`row_group` rows; written under a
  temporary name and renamed into place."""
  import pandas as pd
  rng = np.random.RandomState(seed)
  cols, bits = {}, {}
  for c in range(tables):
    ids = (rng.zipf(1.3, rows) % vocab).astype(np.int64)
    cols[f'c{c}'] = ids
    if c < 3:
      bits[c] = _latent_bits(vocab, c)[ids]
  i0 = rng.exponential(1.0, rows).astype(np.float32)
  cols['i0'] = i0
  cols['i1'] = rng.exponential(1.0, rows).astype(np.float32)
  signal = (2.2 * (bits[0] ^ bits[1]).astype(np.float32)
            + 0.9 * bits[2].astype(np.float32)
            + 0.6 * np.tanh(i0 - 1.0))
  p = 1.0 / (1.0 + np.exp(-(signal - signal.mean())))
  cols['label'] = (rng.rand(rows) < p).astype(np.float32)
  fd, tmp = tempfile.mkstemp(prefix='.auc_parity.', suffix='.tmp',
                             dir=os.path.dirname(path))
  os.close(fd)
  try:
    pd.DataFrame(cols).to_parquet(tmp, row_group_size=row_group(rows, world))
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.unlink(tmp)


def overflow_expected(train_path: str, tables: int, batch: int, world: int,
                      lookup_ratio: float, update_ratio: float):
  """The JAX harness's ``_overflow_expected``: from the first batch, in
  numpy, whether any device's bucket of its unique ids (owner ``id %
  world``) would hold more than the lookup capacity; and the
  capacities."""
  import pandas as pd
  df = pd.read_parquet(train_path).iloc[:batch]
  lookup_cap = max(1, math.ceil(lookup_ratio * (batch / world) / world))
  update_cap = max(1, math.ceil(update_ratio *
                                math.ceil((batch * tables / world) / world)))
  fired = False
  for c in range(tables):
    ids = df[f'c{c}'].to_numpy()
    for dev in range(world):
      local = np.unique(ids[dev * (batch // world):
                            (dev + 1) * (batch // world)])
      if np.bincount(local % world, minlength=world).max() > lookup_cap:
        fired = True
  return fired, {'lookup_cap': lookup_cap, 'update_cap': update_cap}


def _fallbacks() -> int:
  """The exact fallbacks of the lookups and the Adagrad updates so far."""
  from hybridbackend_tpu_torch.embedding import lookup, sparse_update
  return (lookup.lookup.overflow_fallbacks
          + sparse_update.sparse_adagrad_apply.overflow_fallbacks)


def _bce(preds: torch.Tensor, y: torch.Tensor):
  preds = torch.clamp(preds, 1e-6, 1 - 1e-6)
  pel = -(y * torch.log(preds) + (1 - y) * torch.log(1 - preds))
  return torch.mean(pel), {'preds': preds, 'per_example_loss': pel}


def run_variant(name: str, train_path: str, eval_path: str, *, tables: int,
                vocab: int, dim: int, batch: int, epochs: int,
                steps: Optional[int], seed: int, table_lr: float,
                dense_lr: float, device: torch.device, ctx=None):
  """Trains one variant (``'exact'``, ``'fast'`` or ``'fast_overflow'``)
  to the end, in the world ``ctx`` (a world of one on ``device`` when
  None); returns ``(final_auc, curve)``, the curve a dict an epoch."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.embedding.table import mark_shard, shard_of
  ctx = ctx or hbt.Context(device)
  device = ctx.device
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{c}', vocab, dim))
           for c in range(tables)]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=list(DENSE_COLUMNS),
                                   ctx=ctx)
  gen = torch.Generator().manual_seed(seed)
  stacked = fx.init(gen)
  net = hbt.StackedDCNv2([dim] * tables + [1] * len(DENSE_COLUMNS),
                         list(MLP), generator=gen, device=device)

  def batches(path, shuffle, bseed):
    return iter(hbt.Dataset.from_parquet(
        path, batch_size=batch // ctx.world_size, drop_remainder=True,
        shuffle=shuffle, seed=bseed, partition_index=ctx.rank,
        partition_count=ctx.world_size))

  if name == 'exact':
    # A stack's shard is a parameter of the data-parallel step: marked,
    # so that its gradient comes from the lookup's backward alone.
    shards = {st.stacked.name: shard_of(st.stacked, ctx) for st in fx.stacks}
    module = nn.ModuleDict({
        'tables': nn.ParameterDict({n: mark_shard(nn.Parameter(t), shards[n])
                                    for n, t in stacked.items()}),
        'net': net})

    def loss_fn(m, b):
      emb, dense = fx(m['tables'], b)
      return _bce(m['net'](emb + dense), b['label'])

    optimizer = hbt.multi_optimizer(
        functools.partial(hbt.Adagrad, lr=table_lr),
        functools.partial(torch.optim.Adam, lr=dense_lr))(module)
    trainer = hbt.Trainer(loss_fn, module, optimizer, ctx=ctx)
  else:
    def model_loss(tower, emb_f, dense_f, b):
      return _bce(tower(emb_f + dense_f), b['label'])

    trainer = hbt.SparseTrainer(
        fx, model_loss, net, tables=stacked,
        dense_optimizer=functools.partial(torch.optim.Adam, lr=dense_lr),
        table_lr=table_lr, step_options=VARIANT_OPTIONS[name])
  curve = []
  for epoch in range(epochs):
    m = trainer.train(batches(train_path, True, seed * 100 + epoch),
                      max_steps=steps)
    res = trainer.evaluate(batches(eval_path, False, 0))
    curve.append({'epoch': epoch, 'train_loss': float(m['loss']),
                  'eval_auc': float(res['auc']),
                  'eval_loss': float(res['loss'])})
  return curve[-1]['eval_auc'], curve


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--rows', type=int, default=1 << 20)
  p.add_argument('--eval-rows', type=int, default=1 << 17)
  p.add_argument('--tables', type=int, default=26)
  p.add_argument('--vocab', type=int, default=100_000)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--batch', type=int, default=8192)
  p.add_argument('--epochs', type=int, default=2)
  p.add_argument('--steps', type=int, default=None,
                 help='cap steps per epoch (default: full pass)')
  p.add_argument('--exact-seeds', type=int, nargs='*', default=[0, 1])
  p.add_argument('--table-lr', type=float, default=0.05)
  p.add_argument('--dense-lr', type=float, default=1e-3)
  p.add_argument('--cache', default=None,
                 help='directory of the Parquet files (default: '
                      'HB_BENCH_CACHE, else the temporary directory)')
  p.add_argument('--cpu', type=int, default=0,
                 help='devices of a host mesh (not ported)')
  p.add_argument('--skip-overflow', action='store_true',
                 help='do not run the fast_overflow variant')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--json', action='store_true')
  return p.parse_args(argv)


def unsupported(args: argparse.Namespace) -> Optional[str]:
  """Why these flags cannot run, or None."""
  if args.cpu:
    return tb.cpu_refused('hybridbackend_tpu_torch.benchmarks.auc_parity')
  if not args.exact_seeds:
    return '--exact-seeds needs at least one seed'
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def run(args: argparse.Namespace, ctx=None) -> Dict:
  """Writes the files if they are missing, trains every variant and
  returns the report; in the world ``ctx``, this rank's."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.distribute import collective
  device = ctx.device if ctx is not None else torch.device(args.device)
  on_card = device.type == 'cuda'
  world = ctx.world_size if ctx is not None else 1
  cache = args.cache or os.environ.get('HB_BENCH_CACHE') or os.path.join(
      tempfile.gettempdir(), 'hbtpu_torch_bench')
  os.makedirs(cache, exist_ok=True)
  def name(kind, rows):
    # A world that needs smaller row groups names them.
    groups = row_group(rows, world)
    suffix = '' if groups == row_group(rows) else f'_rg{groups}'
    return os.path.join(cache, f'auc_{kind}_{rows}x{args.tables}'
                        f'v{args.vocab}{suffix}.parquet')

  train_path, eval_path = name('train', args.rows), name('eval',
                                                         args.eval_rows)
  t0 = time.perf_counter()
  if ctx is None or ctx.is_chief:
    if not os.path.exists(train_path):
      synthesize(train_path, args.rows, args.tables, args.vocab, seed=11,
                 world=world)
    if not os.path.exists(eval_path):
      synthesize(eval_path, args.eval_rows, args.tables, args.vocab,
                 seed=999, world=world)
  if ctx is not None:
    # The other ranks wait for the files.
    collective.allreduce(torch.zeros(1, device=device), ctx=ctx)
  synth_s = time.perf_counter() - t0

  kw = dict(tables=args.tables, vocab=args.vocab, dim=args.dim,
            batch=args.batch, epochs=args.epochs, steps=args.steps,
            table_lr=args.table_lr, dense_lr=args.dense_lr)
  results, exact_aucs = {}, []
  variants = [('exact', s) for s in args.exact_seeds]
  variants.append(('fast', args.exact_seeds[0]))
  if not args.skip_overflow:
    variants.append(('fast_overflow', args.exact_seeds[0]))
  say = (lambda *a: None) if ctx is not None and not ctx.is_chief else (
      lambda line: print(line, file=sys.stderr, flush=True))
  for name, seed in variants:
    for kernel in tb.COUNTED:
      getattr(hbt, kernel).launches = 0
    before = _fallbacks()
    t0 = time.perf_counter()
    auc, curve = run_variant(name, train_path, eval_path, seed=seed,
                             device=device, ctx=ctx, **kw)
    key = f'exact_seed{seed}' if name == 'exact' else name
    results[key] = {'auc': auc, 'curve': curve,
                    'secs': time.perf_counter() - t0,
                    'kernel_launches': {k: getattr(hbt, k).launches
                                        for k in tb.COUNTED}}
    if name == 'fast_overflow':
      fired = _fallbacks() - before
      if ctx is not None:
        fired = int(collective.allreduce(torch.tensor(
            [float(fired)], device=device), ctx=ctx).item())
      expected, caps = overflow_expected(
          train_path, args.tables, args.batch, max(world, 1),
          OVERFLOW_OPTIONS['lookup_bucket_ratio'],
          OVERFLOW_OPTIONS['update_bucket_ratio'])
      results[key].update(options=OVERFLOW_OPTIONS, fallbacks=fired,
                          overflow_must_fire=bool(expected), caps=caps)
    elif name == 'fast':
      results[key]['options'] = FAST_OPTIONS
    if name == 'exact':
      exact_aucs.append(auc)
    say(f'{key}: auc={auc:.4f}')

  spread = max(exact_aucs) - min(exact_aucs)
  band = max(spread * 1.5, 0.006)
  mean_exact = sum(exact_aucs) / len(exact_aucs)
  verdicts = {key: abs(results[key]['auc'] - mean_exact) <= band
              for key in ('fast', 'fast_overflow') if key in results}
  if 'fast_overflow' in results and world > 1:
    # In a world the variant exists to carry its steps on the fallbacks.
    verdicts['fast_overflow'] &= results['fast_overflow']['fallbacks'] > 0
  return {
      'config': {**kw, 'rows': args.rows, 'eval_rows': args.eval_rows},
      'results': results,
      'exact_mean_auc': mean_exact, 'exact_spread': spread,
      'parity_band': band,
      'parity_ok': verdicts,
      'not_ported': NOT_PORTED,
      'synthesize_s': synth_s,
      'world': world,
      'backend': (torch.distributed.get_backend(ctx.group)
                  if ctx is not None else None),
      'device': str(device),
      'device_name': torch.cuda.get_device_name(device) if on_card else 'cpu',
      'card': tb.card() if on_card and (ctx is None or ctx.is_chief)
              else None,
  }


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'auc_parity: {why}', file=sys.stderr)
    return 1
  out, chief = tb.in_world(args.device, lambda ctx: run(args, ctx))
  if not chief:
    return 0 if all(out['parity_ok'].values()) else 1
  print(json.dumps(out if args.json else
                   {k: out[k] for k in ('exact_mean_auc', 'exact_spread',
                                        'parity_band', 'parity_ok')}))
  return 0 if all(out['parity_ok'].values()) else 1


if __name__ == '__main__':
  sys.exit(main())
