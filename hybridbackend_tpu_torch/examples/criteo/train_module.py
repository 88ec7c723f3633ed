"""Criteo training through the module adapter (``module_support.py``).

The port of ``examples/criteo/train_flax.py``: a stock tower, an
``nn.Sequential`` of ``Linear`` 512-256-64-1 with ReLUs and a sigmoid
over the ``'concat'`` features (26 embeddings of ``--dim`` and 13 dense
features), wrapped by ``wraps_module`` over 26 stacked tables of the
JAX example's vocabularies (``max(100, (7919·(c+1)) % 100000)`` for
column ``c``), trained with Adagrad 0.1 on every parameter (optax's
Adagrad, ``training/optimizer.py``) by the dense ``Trainer``, then
evaluated on the file's first 20 batches. The file is read by the
port's ``ParquetDataset``; ``--synthesize`` first writes a
Criteo-shaped sample (``train.py:synthesize``, ``--rows`` rows). Runs on
one CUDA device unless ``--device cpu`` is given; the weights are drawn
on the CPU from seed 0. With ``--model-dir`` the trainer keeps its
checkpoints and its TensorBoard summaries there (the train metrics every
``--summary-steps``, the evaluation's at its end), and ``--export DIR``
writes the serving bundle, which looks every column up through kernel 5.

  python -m hybridbackend_tpu_torch.examples.criteo.train_module \\
      --synthesize --steps 200

``--vocab-cap N`` caps every vocabulary at ``N`` rows, for a small run
(the JAX example has no such flag).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from hybridbackend_tpu_torch.examples.criteo.train import (
    NUM_CAT, NUM_DENSE, synthesize)

EVAL_BATCHES = 20
SEED = 0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--data', default=None)
  p.add_argument('--synthesize', action='store_true')
  p.add_argument('--rows', type=int, default=200_000,
                 help='rows of the synthesized sample')
  p.add_argument('--steps', type=int, default=200)
  p.add_argument('--batch-size', type=int, default=4096)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--model-dir', default=None)
  p.add_argument('--summary-steps', type=int, default=100,
                 help='with --model-dir, write the train metrics as '
                      'summaries every N steps (0: never)')
  p.add_argument('--vocab-cap', type=int, default=0,
                 help='cap every vocabulary at this many rows (0: none)')
  p.add_argument('--export', default=None, metavar='DIR',
                 help='write the serving bundle here after training')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (default) or 'cpu'")
  return p.parse_args(argv)


def vocabs(args: argparse.Namespace) -> List[int]:
  """The JAX example's vocabularies, capped at ``--vocab-cap``."""
  out = [max(100, (7919 * (c + 1)) % 100000) for c in range(NUM_CAT)]
  return [min(v, args.vocab_cap) for v in out] if args.vocab_cap else out


def tower() -> nn.Module:
  """The stock tower: ``Linear`` 512-256-64-1, ReLUs, a sigmoid, ``[B]``
  out (the input width is shaped by the first batch)."""
  return nn.Sequential(nn.LazyLinear(512), nn.ReLU(), nn.Linear(512, 256),
                       nn.ReLU(), nn.Linear(256, 64), nn.ReLU(),
                       nn.Linear(64, 1), nn.Sigmoid(), nn.Flatten(0))


def wrapped_model(args: argparse.Namespace, device: torch.device):
  """The adapter over the 26 tables and 13 dense columns."""
  import hybridbackend_tpu_torch as hbt
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{c}', v, args.dim))
           for c, v in enumerate(vocabs(args))]
  return hbt.wraps_module(tower(), specs,
                          dense_columns=[f'i{d}' for d in range(NUM_DENSE)],
                          ctx=hbt.Context(device))


def dataset(args: argparse.Namespace):
  """The file's batches of ``--batch-size`` rows, in file order."""
  import hybridbackend_tpu_torch as hbt
  fields = ([hbt.Field(f'c{c}', np.int64) for c in range(NUM_CAT)]
            + [hbt.Field(f'i{d}', np.float32) for d in range(NUM_DENSE)]
            + [hbt.Field('label', np.float32)])
  return hbt.ParquetDataset([args.data], fields=fields,
                            batch_size=args.batch_size)


def run(args: argparse.Namespace):
  """Fits, evaluates (and exports) as the flags say; returns the adapter
  and the train and eval results."""
  import hybridbackend_tpu_torch as hbt
  device = torch.device(args.device)
  if args.synthesize:
    args.data = args.data or os.path.join(tempfile.gettempdir(),
                                          'criteo_module.parquet')
    if not os.path.exists(args.data):
      synthesize(args.data, args.rows, vocabs(args))
  ds = dataset(args)
  wrapped = wrapped_model(args, device)
  example = next(iter(ds))
  params = wrapped.init(torch.Generator().manual_seed(SEED), example)
  wrapped.compile(params, hbt.Adagrad(params.parameters(), lr=0.1),
                  model_dir=args.model_dir, summary_steps=args.summary_steps)
  metrics = wrapped.fit(iter(ds), max_steps=args.steps, sync=False)
  print('train:', metrics)
  results = wrapped.evaluate(iter(ds.take(EVAL_BATCHES)))
  print('eval:', results)
  if args.export:
    path = wrapped.export_saved_model(args.export, example)
    print(f'exported serving bundle → {path}')
  return wrapped, metrics, results


def main(argv: Optional[List[str]] = None) -> int:
  args = parse_args(argv)
  if not (args.data or args.synthesize):
    print('criteo/train_module.py: pass --data FILE or --synthesize',
          file=sys.stderr)
    return 1
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    print('criteo/train_module.py: no CUDA device; pass --device cpu to run '
          'on the CPU', file=sys.stderr)
    return 1
  run(args)
  return 0


if __name__ == '__main__':
  sys.exit(main())
