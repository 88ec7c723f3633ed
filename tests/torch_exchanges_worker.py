"""One rank of the node groups and the last three exchanges, for the CPU
parity tests of ``test_torch_exchanges.py``.

Run under the launcher, one process per rank, with the world laid out in
nodes:

  python -m hybridbackend_tpu_torch.run --simulate N --nodes M \\
      --device cpu tests/torch_exchanges_worker.py CASES.pkl OUT_DIR

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

import numpy as np
import torch
from torch import nn

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.embedding import lookup as lookup_mod
from torch_sharded_worker import (
    APPLY, _count_calls, _launches, _np, _reset, _run_steps,
    _tower_and_loss)
from torch_trainer_worker import _Trace, _bce, _rank_rows

TOPOLOGIES = {'all': collective.Topology.ALL,
              'intra': collective.Topology.INTRA_NODE,
              'inter': collective.Topology.INTER_NODE}


def layout(ctx, spec):
  """What the rank knows of its node and what the launcher told it."""
  return {'rank': ctx.rank, 'world': ctx.world_size,
          'local_rank': ctx.local_rank, 'local_world': ctx.local_world_size,
          'node': ctx.node, 'nodes': ctx.num_nodes,
          'env': {k: os.environ[k] for k in (
              'LOCAL_RANK', 'LOCAL_WORLD_SIZE', 'GROUP_RANK')}}


def collectives(ctx, spec):
  """Every collective over each topology on the rank's row of the test's
  payloads: ``x`` (integer-valued floats, so that every sum is exact),
  and per topology the buckets and sizes of ``all_to_all_v``; the data
  movers also through a bf16 wire."""
  r = ctx.rank
  x = torch.from_numpy(spec['x'][r])
  out = {}
  for name, topology in TOPOLOGIES.items():
    size = collective.span(ctx, topology).size
    kw = dict(ctx=ctx, topology=topology)
    recv, sizes = collective.all_to_all_v(
        torch.from_numpy(spec['buckets'][name][r]),
        torch.from_numpy(spec['sizes'][name][r]), **kw)
    out[name] = {k: _np(v) for k, v in {
        'size': torch.tensor(size),
        'sum': collective.allreduce(x, **kw),
        'mean': collective.allreduce(x, 'mean', **kw),
        'max': collective.allreduce(x, 'max', **kw),
        'bcast': collective.broadcast(x, size - 1, **kw),
        'gather': collective.allgather(x, **kw),
        'a2a': collective.alltoall(x, **kw),
        'rs': collective.reduce_scatter(x.reshape(size, -1), **kw),
        'a2av': recv, 'a2av_sizes': sizes,
        'gather_bf16': collective.allgather(x / 3, wire_dtype='bfloat16',
                                            **kw),
        'a2a_bf16': collective.alltoall(x / 3, wire_dtype='bfloat16', **kw),
        'sum_bf16': collective.allreduce(x, wire_dtype='bfloat16', **kw),
    }.items()}
  return out


def _config(t):
  """A ``TableConfig`` from the test's ``(name, vocab, dim, kwargs)``."""
  name, vocab, dim, kw = t
  return hbt.TableConfig(name, vocab, dim, **kw)


def _part(ctx, cfg, array):
  """This rank's rows (or columns) of a global array, a tensor."""
  return torch.from_numpy(
      array[cfg.shard_rows(ctx), cfg.shard_cols(ctx)].copy())


def lookups(ctx, spec):
  """For each case ``(table, ids, options)``: the rank's embeddings of
  its rows of the ids, the gradient of ``sum(emb * w)`` with respect to
  its shard, and the overflow fallbacks it took."""
  out = {}
  for case, (table, ids_name, opts) in spec['cases'].items():
    cfg = _config(spec['tables'][table])
    shard = _part(ctx, cfg, spec['arrays'][table]).requires_grad_()
    ids = spec['ids'][ids_name]
    rows = ctx.rows(ids.shape[0])
    before = lookup_mod.lookup.overflow_fallbacks
    emb = hbt.lookup(shard, torch.from_numpy(ids[rows]), cfg, ctx=ctx,
                     **opts)
    w = torch.from_numpy(spec['w'][ids_name][rows])
    grad, = torch.autograd.grad((emb * w).sum(), shard)
    out[case] = {'emb': _np(emb), 'grad': _np(grad),
                 'fallbacks': lookup_mod.lookup.overflow_fallbacks - before}
  return out


def row_totals(ctx, spec):
  """For each case ``(table, options)``: the rank's embeddings of its rows
  of the ids and the gradient of ``sum(emb * w)`` with respect to its
  shard, cut from the world of one's table with NaN in every row the
  world pads it with."""
  out = {}
  for case, (table, opts) in spec['cases'].items():
    cfg = _config(spec['tables'][table])
    whole = spec['arrays'][table]
    pad = np.full((cfg.padded_vocab(ctx) - whole.shape[0], whole.shape[1]),
                  np.nan, np.float32)
    shard = _part(ctx, cfg, np.concatenate([whole, pad])).requires_grad_()
    rows = ctx.rows(spec['ids'].shape[0])
    emb = hbt.lookup(shard, torch.from_numpy(spec['ids'][rows]), cfg,
                     ctx=ctx, **opts)
    w = torch.from_numpy(spec['w'][rows])
    grad, = torch.autograd.grad((emb * w).sum(), shard)
    out[case] = {'emb': _np(emb), 'grad': _np(grad)}
  return out


def updates(ctx, spec):
  """One optimizer update of a column-sharded table for each case
  ``(optimizer, options)``, on the rank's rows of the ids and gradients:
  the rank's slice of the table and slots after it, and the wrappers'
  calls."""
  cfg = _config(spec['table'])
  ids, demb = spec['ids'], spec['demb']
  rows = ctx.rows(ids.shape[0])
  args = (torch.from_numpy(ids[rows]), torch.from_numpy(demb[rows]), cfg,
          spec['lr'])
  out = {}
  for case, (optimizer, opts) in spec['cases'].items():
    table = _part(ctx, cfg, spec['array'])
    slots = tuple(_part(ctx, cfg, a) for a in spec['slots'][optimizer])
    _reset()
    apply = APPLY[optimizer]
    if optimizer == 'sgd':
      apply(table, *args, ctx=ctx, **opts)
    elif optimizer == 'adam':
      apply(table, hbt.SparseOptState(acc=slots), *args, step=1, ctx=ctx,
            **opts)
    else:
      apply(table, hbt.SparseOptState(acc=slots), *args, ctx=ctx, **opts)
    out[case] = {'state': [_np(table), *(_np(a) for a in slots)],
                 'calls': _launches()}
  return out


def _stacked_fx(ctx, spec):
  specs = [hbt.EmbeddingSpec(_config(t)) for t in spec['tables']]
  return hbt.StackedFeatureExtractor(specs, dense_columns=spec['dense'],
                                     ctx=ctx)


def steps(ctx, spec):
  """The sparse step (DCNv2 + Adagrad, ``spec['options']`` passed to
  ``make_sparse_train_step``) from the JAX initial state, on the rank's
  rows of each global batch (``torch_sharded_worker._run_steps``)."""
  fx = _stacked_fx(ctx, spec)
  tower, model_loss = _tower_and_loss(spec)
  init = spec['init']
  state = hbt.from_jax(fx, init['tables'], init['acc'], tower, init['dense'],
                       functools.partial(torch.optim.Adam, lr=1e-3))
  step = hbt.make_sparse_train_step(fx, model_loss, table_lr=0.05,
                                    **spec['options'])
  return _run_steps(ctx, fx, state, step, spec['batches'])


# -- the trainers --------------------------------------------------------------

def _sparse_trainer(ctx, spec, model_dir):
  """A ``SparseTrainer`` from the JAX initial state ``spec['init']``, or
  from a state of its own when there is none (one that its checkpoint
  replaces)."""
  fx = _stacked_fx(ctx, spec)
  tower = hbt.StackedDCNv2(spec['widths'], spec['mlp'])
  init = spec.get('init')
  tables = None
  if init is not None:
    state = hbt.from_jax(fx, init['tables'], init['acc'], tower,
                         init['dense'],
                         functools.partial(torch.optim.Adam, lr=1e-3))
    tower, tables = state.dense, state.tables

  def model_loss(t, emb_f, dense_f, batch):
    return _bce(t(emb_f + dense_f), batch['label'])

  return fx, hbt.SparseTrainer(
      fx, model_loss, tower, tables=tables, model_dir=model_dir,
      lookup_strategy=spec['strategy'])


def _sparse_snap(fx, tr):
  def snap():
    s = tr.state
    return {'tables': {k: _np(v) for k, v in
                       hbt.gather_tables(fx, s.tables).items()},
            'slots': {k: [_np(a) for a in v] for k, v in
                      hbt.gather_slots(fx, s.table_opt).items()},
            'tower': {n: _np(p) for n, p in s.dense.named_parameters()},
            'step': s.step}
  return snap


def _whole(ctx, t, shard):
  """``t`` of a parameter marked ``shard`` (None: replicated), whole."""
  if shard is None:
    return t
  return collective.allgather(t.detach(), ctx=ctx,
                              axis=int(shard.by_column))


def _dense_trainer(ctx, spec, model_dir):
  specs = [hbt.EmbeddingSpec(_config(t)) for t in spec['tables']]
  module = nn.ModuleDict({
      'tables': hbt.init_tables(specs, torch.Generator().manual_seed(0),
                                torch.device('cpu'), ctx),
      'net': hbt.StackedDCNv2(spec['widths'], spec['mlp'])})

  def loss_fn(m, b):
    emb, dense_f = hbt.extract_features(m['tables'], b, specs, spec['dense'],
                                        ctx=ctx, strategy=spec['strategy'])
    return _bce(m['net'](emb + dense_f), b['label'])

  opt = hbt.multi_optimizer(
      functools.partial(hbt.Adagrad, lr=0.05),
      functools.partial(torch.optim.Adam, lr=1e-3))(module)
  hbt.from_jax_dense(module, specs, spec['init'], opt, ctx=ctx)
  tr = hbt.Trainer(loss_fn, module, opt, model_dir, ctx=ctx)

  def snap():
    out = {'tables': {}, 'slots': {}, 'step': tr.global_step,
           'tower': {n: _np(p) for n, p in module['net'].named_parameters()}}
    for s in specs:
      t = module['tables'][s.name]
      shard = hbt.table_shard(t)
      out['tables'][s.name] = _np(_whole(ctx, t, shard))
      out['slots'][s.name] = _np(_whole(ctx, opt.state[t]['sum_of_squares'],
                                        shard))
    return out

  return tr, snap


def trainer(ctx, spec):
  """A ``SparseTrainer`` (``spec['model'] == 'sparse'``) or ``Trainer``
  from the JAX initial state: ``train`` on the rank's rows of the global
  batches with the state after each step, a checkpoint at the end when
  ``spec['model_dir']`` names a directory, ``predict`` on the rank's
  rows of the eval batch, and the export of a bundle when
  ``spec['bundle']`` names one."""
  if spec['model'] == 'sparse':
    fx, tr = _sparse_trainer(ctx, spec, spec.get('model_dir'))
    snap = _sparse_snap(fx, tr)
  else:
    tr, snap = _dense_trainer(ctx, spec, spec.get('model_dir'))
  _reset()
  trace = _Trace(snap)
  train = _rank_rows(ctx, spec['train'])
  tr.train(train, hooks=[trace], save_checkpoint_steps=len(train))
  out = {'trace': trace.steps, 'calls': _launches(),
         'preds': [_np(p) for p in tr.predict(_rank_rows(
             ctx, [spec['eval']]))]}
  if spec.get('bundle'):
    tr.export_saved_model(spec['bundle'], spec['example'], poly_batch=True)
  return out


def restore(ctx, spec):
  """A ``SparseTrainer`` made on ``spec['model_dir']``: the state it
  restored; then ``spec['more']`` steps more, checkpointed, and the
  state after them."""
  fx, tr = _sparse_trainer(ctx, spec, spec['model_dir'])
  snap = _sparse_snap(fx, tr)
  restored = snap()
  more = _rank_rows(ctx, spec['more'])
  tr.train(more, save_checkpoint_steps=len(more))
  return {'restored': restored, 'after': snap()}


KINDS = {'layout': layout, 'collectives': collectives, 'lookups': lookups,
         'row_totals': row_totals, 'updates': updates, 'steps': steps,
         'trainer': trainer, 'restore': restore}


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
