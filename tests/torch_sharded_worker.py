"""One rank of the port's sharded paths, for the CPU parity tests.

Run under the launcher, one process per rank:

  python -m hybridbackend_tpu_torch.run --simulate N --device cpu \\
      tests/torch_sharded_worker.py CASES.pkl OUT_DIR

``CASES.pkl`` holds a list of ``(name, kind, spec)`` made by the tests
from seeded numpy inputs (and the JAX package's initial states, as numpy
arrays). Each rank runs every case in order and writes its results to
``OUT_DIR/<rank>.pkl``: ``{name: result}``, numpy arrays and numbers.
This file imports torch and the port only: never JAX.
"""

import functools
import os
import pickle
import sys

import torch

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.embedding import lookup as lookup_mod


def _np(t):
  return t.detach().cpu().numpy().copy()   # the state changes in place


def collectives(ctx, spec):
  """Every collective on rank-made inputs, and ``all_to_all_v`` on the
  rank's block of the test's global buckets and sizes."""
  r = ctx.rank
  x = torch.arange(6, dtype=torch.float32) * (r + 1)
  out = {
      'sum': collective.allreduce(x, ctx=ctx),
      'max': collective.allreduce(x, 'max', ctx=ctx),
      'mean': collective.allreduce(x, 'mean', ctx=ctx),
      'bcast': collective.broadcast(x + 10 * r, 1, ctx=ctx),
      'gather': collective.allgather(x[:2] + r, ctx=ctx),
      'a2a': collective.alltoall(
          torch.arange(2 * ctx.world_size, dtype=torch.int32) + 100 * r,
          ctx=ctx),
      'rs': collective.reduce_scatter(
          torch.arange(3 * ctx.world_size, dtype=torch.float32).reshape(
              ctx.world_size, 3) + r, ctx=ctx),
  }
  recv, sizes = collective.all_to_all_v(
      torch.from_numpy(spec['buckets'][r]), torch.from_numpy(spec['sizes'][r]),
      ctx=ctx)
  out['a2av'] = recv
  out['a2av_sizes'] = sizes
  return {k: _np(v) for k, v in out.items()}


def lookups(ctx, spec):
  """``lookup`` of the rank's part of an id set, for each ``(id set,
  options)`` case."""
  cfg = hbt.TableConfig(spec['name'], spec['vocab'], spec['dim'])
  table = torch.from_numpy(spec['table'][cfg.shard_rows(ctx)].copy())
  out = {}
  for ids_name, opt_name in spec['cases']:
    ids = torch.from_numpy(spec['ids'][ids_name])
    local = (hbt.world_slice(ids, ctx) if ids.dim() == 1
             else ids[ctx.rows(ids.shape[0])])
    before = lookup_mod.lookup.overflow_fallbacks
    emb = hbt.lookup(table, local, cfg, ctx=ctx, **spec['options'][opt_name])
    out[f'{ids_name}/{opt_name}'] = _np(emb)
    out[f'{ids_name}/{opt_name}/fallbacks'] = (
        lookup_mod.lookup.overflow_fallbacks - before)
  return out


def updates(ctx, spec):
  """``sparse_adagrad_apply`` of the rank's rows of the ids and
  gradients, for each exchange, from one table and accumulator."""
  cfg = hbt.TableConfig(spec['name'], spec['vocab'], spec['dim'])
  rows = cfg.shard_rows(ctx)
  ids = torch.from_numpy(spec['ids'])[ctx.rows(spec['ids'].shape[0])]
  demb = torch.from_numpy(spec['demb'])[ctx.rows(spec['ids'].shape[0])]
  out = {}
  for name, opts in spec['options'].items():
    table = torch.from_numpy(spec['table'][rows].copy())
    state = hbt.SparseOptState(acc=(torch.from_numpy(
        spec['acc'][rows].copy()),))
    before = hbt.sparse_adagrad_apply.overflow_fallbacks
    hbt.sparse_adagrad_apply(table, state, ids, demb, cfg, spec['lr'],
                             ctx=ctx, **opts)
    out[name] = (_np(table), _np(state.acc[0]))
    out[f'{name}/fallbacks'] = (hbt.sparse_adagrad_apply.overflow_fallbacks
                                - before)
  return out


def _model_loss(tower, emb_f, dense_f, batch):
  p = torch.clamp(tower(emb_f + dense_f), 1e-6, 1 - 1e-6)
  y = batch['label']
  return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {}


def steps(ctx, spec):
  """The sparse DCNv2 + Adagrad step from the JAX initial state, on the
  rank's rows of each global batch; the loss and the rank's state after
  every step."""
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(*t)) for t in spec['tables']]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=spec['dense'],
                                   ctx=ctx,
                                   min_shard_rows=spec['min_shard_rows'])
  tower = hbt.StackedDCNv2(spec['widths'], spec['mlp'])
  init = spec['init']
  state = hbt.from_jax(fx, init['tables'], init['acc'], tower, init['dense'],
                       functools.partial(torch.optim.Adam, lr=1e-3))
  step = hbt.make_sparse_train_step(fx, _model_loss, table_lr=0.05,
                                    **spec['options'])
  trace = []
  for batch in spec['batches']:
    rows = ctx.rows(batch['label'].shape[0])
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    state, metrics = step(state, local)
    trace.append({
        'loss': float(metrics['loss']),
        'tables': {k: _np(v) for k, v in state.tables.items()},
        'acc': {k: _np(v.acc[0]) for k, v in state.table_opt.items()},
        'tower': {n: _np(p) for n, p in state.dense.named_parameters()},
        'gathered': {k: _np(v) for k, v in
                     hbt.gather_tables(fx, state.tables).items()}})
  return {'trace': trace, 'sharded': {s.stacked.name: s.stacked.should_shard(
      ctx) for s in fx.stacks}, 'launches': hbt.adagrad_update_sorted.launches}


KINDS = {'collectives': collectives, 'lookups': lookups, 'updates': updates,
         'steps': steps}


def main(cases_path, out_dir):
  ctx = hbt.Context.join('cpu')
  torch.set_num_threads(1)
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
