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

Not here, each with its reason: the JAX ``FAST_OPTIONS`` (a bf16 wire
for the exchanges and bf16 one-hot update contractions) are multi-device
and TPU knobs with no counterpart on one card; ``fast_overflow`` shrinks
the multi-device bucket capacities so their fallbacks fire, which
belongs to the multi-device work (ROADMAP item 15): the JSON names it
under ``not_ported`` and ``--skip-overflow`` is accepted; ``--cpu N``
(a host mesh) is refused.

  python -m hybridbackend_tpu_torch.benchmarks.auc_parity [--rows 1048576]
      [--json] [--device cuda|cpu]

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
    'fast_overflow': 'shrinks the multi-device lookup and update bucket '
                     'capacities so their fallbacks fire; one card has no '
                     'buckets (ROADMAP item 15)',
}


def _latent_bits(vocab: int, col: int) -> np.ndarray:
  """The per-id latent bit of column ``col`` (the signal the embeddings
  must recover): the JAX harness's draw."""
  rng = np.random.RandomState(_VOCAB_SEED + col)
  return rng.rand(vocab) < 0.5


def synthesize(path: str, rows: int, tables: int, vocab: int,
               seed: int) -> None:
  """The JAX harness's Parquet CTR sample: zipf(1.3) ids, exponential
  dense columns, the label from XOR(b0, b1) + b2 + tanh(i0 - 1), drawn in
  its order; written under a temporary name and renamed into place."""
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
    pd.DataFrame(cols).to_parquet(tmp, row_group_size=max(8192, rows // 64))
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.unlink(tmp)


def _bce(preds: torch.Tensor, y: torch.Tensor):
  preds = torch.clamp(preds, 1e-6, 1 - 1e-6)
  pel = -(y * torch.log(preds) + (1 - y) * torch.log(1 - preds))
  return torch.mean(pel), {'preds': preds, 'per_example_loss': pel}


def run_variant(name: str, train_path: str, eval_path: str, *, tables: int,
                vocab: int, dim: int, batch: int, epochs: int,
                steps: Optional[int], seed: int, table_lr: float,
                dense_lr: float, device: torch.device):
  """Trains one variant (``'exact'`` or ``'fast'``) to the end; returns
  ``(final_auc, curve)``, the curve a dict an epoch."""
  import hybridbackend_tpu_torch as hbt
  ctx = hbt.Context(device)
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
        path, batch_size=batch, drop_remainder=True, shuffle=shuffle,
        seed=bseed))

  if name == 'exact':
    module = nn.ModuleDict({
        'tables': nn.ParameterDict({n: nn.Parameter(t)
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
        table_lr=table_lr)
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
                 help='accepted: the fast_overflow variant is not ported')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--json', action='store_true')
  return p.parse_args(argv)


def unsupported(args: argparse.Namespace) -> Optional[str]:
  """Why these flags cannot run, or None."""
  if args.cpu:
    return ('--cpu N (a multi-device host mesh) is not ported; this '
            'harness drives one device')
  if not args.exact_seeds:
    return '--exact-seeds needs at least one seed'
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    return 'no CUDA device; pass --device cpu to run on the CPU'
  return None


def run(args: argparse.Namespace) -> Dict:
  """Writes the files if they are missing, trains every variant and
  returns the report."""
  import hybridbackend_tpu_torch as hbt
  device = torch.device(args.device)
  on_card = device.type == 'cuda'
  cache = args.cache or os.environ.get('HB_BENCH_CACHE') or os.path.join(
      tempfile.gettempdir(), 'hbtpu_torch_bench')
  os.makedirs(cache, exist_ok=True)
  sig = f'{args.rows}x{args.tables}v{args.vocab}'
  train_path = os.path.join(cache, f'auc_train_{sig}.parquet')
  eval_path = os.path.join(cache, f'auc_eval_{args.eval_rows}x'
                           f'{args.tables}v{args.vocab}.parquet')
  t0 = time.perf_counter()
  if not os.path.exists(train_path):
    synthesize(train_path, args.rows, args.tables, args.vocab, seed=11)
  if not os.path.exists(eval_path):
    synthesize(eval_path, args.eval_rows, args.tables, args.vocab, seed=999)
  synth_s = time.perf_counter() - t0

  kw = dict(tables=args.tables, vocab=args.vocab, dim=args.dim,
            batch=args.batch, epochs=args.epochs, steps=args.steps,
            table_lr=args.table_lr, dense_lr=args.dense_lr)
  results, exact_aucs = {}, []
  variants = [('exact', s) for s in args.exact_seeds]
  variants.append(('fast', args.exact_seeds[0]))
  for name, seed in variants:
    for kernel in tb.COUNTED:
      getattr(hbt, kernel).launches = 0
    t0 = time.perf_counter()
    auc, curve = run_variant(name, train_path, eval_path, seed=seed,
                             device=device, **kw)
    key = f'exact_seed{seed}' if name == 'exact' else name
    results[key] = {'auc': auc, 'curve': curve,
                    'secs': time.perf_counter() - t0,
                    'kernel_launches': {k: getattr(hbt, k).launches
                                        for k in tb.COUNTED}}
    if name == 'exact':
      exact_aucs.append(auc)
    print(f'{key}: auc={auc:.4f}', file=sys.stderr, flush=True)

  spread = max(exact_aucs) - min(exact_aucs)
  band = max(spread * 1.5, 0.006)
  mean_exact = sum(exact_aucs) / len(exact_aucs)
  return {
      'config': {**kw, 'rows': args.rows, 'eval_rows': args.eval_rows},
      'results': results,
      'exact_mean_auc': mean_exact, 'exact_spread': spread,
      'parity_band': band,
      'parity_ok': {'fast': abs(results['fast']['auc'] - mean_exact)
                             <= band},
      'not_ported': NOT_PORTED,
      'synthesize_s': synth_s,
      'device': str(device),
      'device_name': torch.cuda.get_device_name(device) if on_card else 'cpu',
      'card': tb.card() if on_card else None,
  }


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  why = unsupported(args)
  if why:
    print(f'auc_parity: {why}', file=sys.stderr)
    return 1
  out = run(args)
  print(json.dumps(out if args.json else
                   {k: out[k] for k in ('exact_mean_auc', 'exact_spread',
                                        'parity_band', 'parity_ok')}))
  return 0 if all(out['parity_ok'].values()) else 1


if __name__ == '__main__':
  sys.exit(main())
