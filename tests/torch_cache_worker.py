"""One rank of the cached trainers at a world of N, for the CPU parity tests.

Run under the launcher, one process per rank:

  python -m hybridbackend_tpu_torch.run --simulate N --device cpu \\
      tests/torch_cache_worker.py CASES.pkl OUT_DIR

``CASES.pkl`` holds a list of ``(name, kind, spec)`` made by
``test_torch_sharded_cache.py`` from seeded numpy inputs and the JAX
tower's initial weights (numpy arrays). Each rank runs every case in
order, on its rows of each global batch, and writes its results to
``OUT_DIR/<rank>.pkl``: ``{name: result}``, numpy arrays and numbers.
This file imports torch and the port only: never JAX.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import torch

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.distribute import collective
from torch_sharded_worker import _count_calls, _launches, _np, _reset
from torch_trainer_worker import _bce, _rank_rows

CPU = torch.device('cpu')


def _host(spec):
  """The rank's host tables: every rank starts from the same rows."""
  value = spec['value'].copy()
  host = {'value': value}
  if spec['optimizer'] == 'adam':
    host.update(slot0=np.zeros_like(value), slot1=np.zeros_like(value))
  else:
    host['slot0'] = np.full_like(value, 0.1)
  return host


def trainer(ctx, spec, host, model_dir=None):
  """The cached ``SparseTrainer`` of ``test_torch_cached_trainer.py`` in
  the world ``ctx``: the device table ``small`` declared first, so that
  the cached member ``big`` sits at a nonzero offset of the stack and its
  slots straddle the shards' boundaries."""
  vocab, cap, dim = spec['vocab'], spec['cap'], spec['dim']
  small = spec['small']
  cache = hbt.EmbeddingCache(hbt.TableConfig('big', vocab, dim), cap,
                             host_tables=host, ctx=ctx)
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(
               'small', small.shape[0], dim,
               initializer=lambda g, s, d: torch.from_numpy(small.copy())),
               column='small'),
           hbt.EmbeddingSpec(cache.slot_config(), column='big')]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=['d0'], ctx=ctx)
  tower = hbt.StackedDCNv2([dim, dim, 1], spec['mlp'])
  hbt.load_dcn_v2(tower, spec['tower'])
  tr = hbt.SparseTrainer(
      fx, lambda t, e, d, b: _bce(t(e + d), b['label']), tower,
      table_lr=0.05, table_optimizer=spec['optimizer'],
      model_dir=model_dir, caches={'big': cache})
  return fx, tr, cache


def _meta(cache):
  """The cache's slot metadata, copied."""
  return {'slot_to_id': cache._slot_to_id.copy(),
          'last_used': cache._last_used.copy(),
          'free': cache._free[:cache._n_free].copy()}


class _Trace(hbt.Hook):
  def __init__(self, cache):
    self.cache, self.steps = cache, []

  def after_step(self, step, metrics):
    self.steps.append(dict(loss=float(metrics['loss']),
                           **_meta(self.cache)))


def _done(tr, cache, host, trace):
  return {'trace': trace.steps, 'meta': _meta(cache),
          'host': {k: v.copy() for k, v in host.items()},
          'stats': dict(cache.stats), 'step': tr.global_step,
          'tower': {n: _np(p) for n, p in tr.state.dense.named_parameters()}}


def train(ctx, spec):
  """``train`` on the rank's rows of the global batches, then the flush;
  the metadata after each step (with ``prefetch``, the producer's plans
  run ahead, so only the final metadata), the host tables, the kernel
  wrappers' calls, and the export of a bundle when ``spec['bundle']``
  names one."""
  host = _host(spec)
  fx, tr, cache = trainer(ctx, spec, host)
  (stack,) = [s for s in fx.stacks if 'big' in s.stacked.name]
  _reset()
  trace = _Trace(cache)
  tr.train(_rank_rows(ctx, spec['train']), hooks=[trace],
           prefetch=spec['prefetch'])
  calls = _launches()
  tr._cache_runner.flush(tr.state)
  out = _done(tr, cache, host, trace)
  out.update(calls=calls, offset=stack.member('big')[1],
             shard=tuple(stack.stacked.shard_rows(ctx).indices(
                 stack.stacked.padded_vocab(ctx))),
             local_rows=tr.state.tables[stack.stacked.name].shape[0])
  if spec.get('bundle'):
    tr.export_saved_model(spec['bundle'], spec['example'], poly_batch=True)
  return out


def resume(ctx, spec):
  """The first ``spec['split']`` batches with a checkpoint at the end,
  a copy of the checkpoint directory and of the host tables (for a
  world of one to resume), then a fresh cache over the same storage and
  a trainer restored from the directory on the rest."""
  host = _host(spec)
  model_dir, split = spec['model_dir'], spec['split']
  batches = _rank_rows(ctx, spec['train'])
  _, tr, _ = trainer(ctx, spec, host, model_dir)
  tr.train(batches[:split])
  collective.allreduce(torch.zeros(1), ctx=ctx)   # every rank has saved
  mid = None
  if ctx.is_chief:
    shutil.copytree(model_dir, spec['copy_dir'])
    mid = {k: v.copy() for k, v in host.items()}
  _, tr2, cache2 = trainer(ctx, spec, host, model_dir)
  restored = (tr2.global_step, cache2.resident)
  trace = _Trace(cache2)
  tr2.train(batches[split:], hooks=[trace])
  out = _done(tr2, cache2, host, trace)
  out.update(restored=restored, host_mid=mid)
  return out


def eval_pending(ctx, spec):
  """``test_service_dynamic.py``'s eval under pending plans at a world of
  N: each rank maps its rows of the global ids through ``transform`` and
  ``eval_transform``."""
  vocab, cap, dim = spec['vocab'], spec['cap'], spec['dim']
  value = (np.arange(vocab)[:, None] * np.ones((1, dim))).astype(np.float32)
  cache = hbt.EmbeddingCache(
      hbt.TableConfig('big', vocab, dim), cap,
      host_tables={'value': value,
                   'slot0': np.full((vocab, dim), 0.1, np.float32)}, ctx=ctx)
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(cache.slot_config(), column='big')],
      dense_columns=['d0'], ctx=ctx)
  tr = hbt.SparseTrainer(
      fx, lambda t, e, d, b: (torch.cat(e + d, -1).mean() * 0.0, {}),
      torch.nn.Linear(dim + 1, 1), caches={'big': cache})
  runner = tr._cache_runner
  mine = lambda ids: {'big': ids[ctx.rows(len(ids))]}
  ids1 = np.arange(0, cap, dtype=np.int64)           # fills the cache
  ids2 = np.arange(cap, 2 * cap, dtype=np.int64)     # evicts all of ids1
  out = {'b1': runner.transform(mine(ids1))['big']}
  runner.transform(mine(ids2))
  runner.apply_next(tr.state)                         # plan 2 pending
  out['pending2'] = runner.eval_transform(mine(ids2))['big']
  out['pending1'] = runner.eval_transform(mine(ids1))['big']
  out['unseen'] = runner.eval_transform(
      mine(np.full(ctx.world_size, spec['unseen'], np.int64)))['big']
  runner.apply_next(tr.state)
  out['applied2'] = runner.eval_transform(mine(ids2))['big']
  stack = fx.stacks[0].stacked.name
  out['rows'] = _np(hbt.gather_tables(fx, tr.state.tables)[stack])
  return out


def standalone(ctx, spec):
  """A cache of its own arrays in a world: every rank prepares each
  step's ids of the world (the global batch, as JAX's one process), its
  arrays are its shard of the slot rows, and it reads its rows' values
  through ``lookup_embeddings`` (the sharded serving lookup); then the
  flush, a collective."""
  value = spec['value']
  cache = hbt.EmbeddingCache(
      hbt.TableConfig('big', value.shape[0], value.shape[1]), spec['cap'],
      host_tables={'value': value.copy()}, ctx=ctx)
  out = {'rows': cache.device['value'].shape[0], 'emb': []}
  for ids in spec['steps']:
    slots = cache.prepare(ids)
    out['emb'].append(_np(cache.lookup_embeddings(
        slots[ctx.rows(len(slots))])))
  cache.flush()
  out.update(host=cache.host['value'].copy(), stats=dict(cache.stats))
  return out


KINDS = {'train': train, 'resume': resume, 'eval_pending': eval_pending,
         'standalone': standalone}


def main(cases_path, out_dir):
  ctx = hbt.Context.join('cpu')
  torch.set_num_threads(1)
  _count_calls()
  with open(cases_path, 'rb') as f:
    cases = pickle.load(f)
  results = {}
  for name, kind, spec in cases:
    results[name] = KINDS[kind](ctx, spec)
  with open(os.path.join(out_dir, f'{ctx.rank}.pkl'), 'wb') as f:
    pickle.dump(results, f)
  ctx.leave()


if __name__ == '__main__':
  main(*sys.argv[1:])
