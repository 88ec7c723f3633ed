"""One rank of the module adapter at a world of N, for the CPU tests.

Run under the launcher, one process per rank:

  python -m hybridbackend_tpu_torch.run --simulate 2 --device cpu \\
      tests/torch_module_worker.py SPEC.pkl OUT_DIR

``SPEC.pkl`` holds the global numpy batches and the directories. Each
rank wraps ``tower()`` over ``specs()`` with the joined context
(``c0`` row-sharded and looked up through the ``alltoall`` exchange,
``c1`` replicated), makes the parameters from seed
0, trains on its rows of each global batch with a summary every 2
steps, evaluates, predicts, saves the weights and exports the bundle
(rank 0 writes it), and writes ``OUT_DIR/<rank>.pkl``. Torch and the
port only: never JAX.
"""

import os
import pickle
import sys

import torch
from torch import nn

import hybridbackend_tpu_torch as hbt

DENSE = ['d0']


def specs():
  return [hbt.EmbeddingSpec(hbt.TableConfig('c0', 256, 8, sharded=True)),
          hbt.EmbeddingSpec(hbt.TableConfig('c1', 64, 4, sharded=False))]


def tower():
  return nn.Sequential(nn.LazyLinear(16), nn.ReLU(), nn.Linear(16, 1),
                       nn.Sigmoid(), nn.Flatten(0))


def rows(batch, ctx):
  n = len(batch['label'])
  return {k: v[ctx.rows(n)] for k, v in batch.items()}


def state(wrapped):
  """The whole tables, the tower and their Adagrad slots, as numpy."""
  tr = wrapped.trainer
  params, opt = tr.state.params, tr.state.optimizer
  fx = wrapped.extractor
  tables = hbt.gather_tables(fx, {n: p.detach()
                                 for n, p in params['tables'].items()})
  slots = hbt.gather_tables(fx, {n: opt.state[p]['sum_of_squares']
                                 for n, p in params['tables'].items()})
  out = {f'tables.{n}': t.detach().numpy().copy() for n, t in tables.items()}
  out.update({f'acc.{n}': t.numpy().copy() for n, t in slots.items()})
  for n, p in params['net'].named_parameters():
    out[f'net.{n}'] = p.detach().numpy().copy()
    out[f'acc.net.{n}'] = opt.state[p]['sum_of_squares'].numpy().copy()
  return out


def run(ctx, spec):
  wrapped = hbt.wraps_module(tower(), specs(), dense_columns=DENSE, ctx=ctx,
                             lookup_strategy='alltoall')
  train = [rows(b, ctx) for b in spec['train']]
  params = wrapped.init(torch.Generator().manual_seed(0), train[0])
  wrapped.compile(params, model_dir=spec['model_dir'], summary_steps=2)
  losses = [wrapped.fit(iter([b]))['loss'] for b in train]
  out = {'losses': losses, 'state': state(wrapped),
         'eval': wrapped.evaluate(iter([rows(b, ctx)
                                        for b in spec['evals']])),
         'preds': [p.numpy() for p in wrapped.predict(
             iter([rows(b, ctx) for b in spec['evals']]))]}
  wrapped.save_weights(spec['weights'])
  wrapped.export_saved_model(spec['bundle'], rows(spec['evals'][0], ctx))
  return out


def main(spec_path, out_dir):
  torch.set_num_threads(1)
  with open(spec_path, 'rb') as f:
    spec = pickle.load(f)
  ctx = hbt.Context.join('cpu')
  out = run(ctx, spec)
  with open(os.path.join(out_dir, f'{ctx.rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)
  ctx.leave()


if __name__ == '__main__':
  main(*sys.argv[1:])
