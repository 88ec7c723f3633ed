"""One rank of the trainers at a world of N, for the CPU parity tests.

Run under the launcher, one process per rank:

  python -m hybridbackend_tpu_torch.run --simulate N --device cpu \\
      tests/torch_trainer_worker.py CASES.pkl OUT_DIR

``CASES.pkl`` holds a list of ``(name, kind, spec)`` made by
``test_torch_sharded_trainer.py`` from seeded numpy inputs and the JAX
package's initial states (as numpy arrays). Each rank runs every case in
order, on its rows of each global train batch and on its own eval
batches, and writes its results to ``OUT_DIR/<rank>.pkl``: ``{name:
result}``, numpy arrays and numbers. This file imports torch and the port
only: never JAX.
"""

import functools
import os
import pickle
import sys

import torch
from torch import nn

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.distribute import collective
from torch_sharded_worker import _count_calls, _launches, _np, _reset

CPU = torch.device('cpu')


def _bce(p, y):
  p = torch.clamp(p, 1e-6, 1 - 1e-6)
  pel = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
  return torch.mean(pel), {'preds': p, 'per_example_loss': pel}


def _rank_rows(ctx, batches):
  """The rank's rows ``[r·B/W, (r+1)·B/W)`` of each global batch."""
  return [{k: v[ctx.rows(len(v))] for k, v in b.items()} for b in batches]


class _Trace(hbt.Hook):
  """After each step: the loss (and ``wire_grad``) and ``snap()``."""

  def __init__(self, snap):
    self.snap, self.steps = snap, []

  def after_step(self, step, metrics):
    rec = {k: float(metrics[k]) for k in ('loss', 'wire_grad')
           if k in metrics}
    rec.update(self.snap())
    self.steps.append(rec)


def _equal_on_every_rank(ctx, tensors):
  """Whether every rank holds rank 0's values of ``tensors``, bit for
  bit."""
  flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
  return bool(torch.equal(flat, collective.broadcast(flat, 0, ctx=ctx)))


# -- SparseTrainer --------------------------------------------------------------

def _sparse_parts(ctx, spec):
  """``(fx, tower, model_loss, raw_model_loss)`` of a sparse case."""
  if spec['model'] == 'din':
    specs = [hbt.EmbeddingSpec(hbt.TableConfig('item', spec['items'],
                                               spec['dim']),
                               column='cand_hist'),
             hbt.EmbeddingSpec(hbt.TableConfig('user', spec['users'],
                                               spec['dim']))]
    fx = hbt.StackedFeatureExtractor(specs, ctx=ctx)
    tower = hbt.DIN(spec['dim'], 1, 2, spec['dnn'], spec['att'])

    def raw_model_loss(t, members, batch):
      emb = members['item']
      return _bce(t(emb[:, 0], emb[:, 1:], batch['hist_mask'],
                    [members['user']], [batch['d0'], batch['d1']]),
                  batch['label'])
    return fx, tower, None, raw_model_loss
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(*t)) for t in spec['tables']]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=spec['dense'],
                                   ctx=ctx)
  tower = hbt.StackedDCNv2(spec['widths'], spec['mlp'])

  def model_loss(t, emb_f, dense_f, batch):
    return _bce(t(emb_f + dense_f), batch['label'])
  return fx, tower, model_loss, None


def _sparse_trainer(ctx, spec, model_dir):
  fx, tower, model_loss, raw_model_loss = _sparse_parts(ctx, spec)
  init = spec['init']
  state = hbt.from_jax(fx, init['tables'], init['acc'], tower, init['dense'],
                       functools.partial(torch.optim.Adam, lr=1e-3))
  return fx, hbt.SparseTrainer(
      fx, model_loss, state.dense, tables=state.tables,
      table_optimizer=spec['optimizer'], model_dir=model_dir,
      raw_model_loss=raw_model_loss, group_key=spec.get('group_key'))


def _sparse_snapshot(fx, tr):
  def snap():
    s = tr.state
    return {'tables': {k: _np(v) for k, v in
                       hbt.gather_tables(fx, s.tables).items()},
            'slots': {k: [_np(a) for a in v] for k, v in
                      hbt.gather_slots(fx, s.table_opt).items()},
            'tower': {n: _np(p) for n, p in s.dense.named_parameters()},
            'step': s.step}
  return snap


def sparse(ctx, spec):
  """A ``SparseTrainer`` from the JAX initial state: ``train`` on the
  rank's rows of the global batches (a checkpoint every ``save_every``
  steps), with the loss, the gathered tables and slots and the tower
  after each step; ``evaluate`` and ``predict`` on the rank's eval
  batches; the export of a bundle when ``spec['bundle']`` names one."""
  fx, tr = _sparse_trainer(ctx, spec, spec.get('model_dir'))
  _reset()
  trace = _Trace(_sparse_snapshot(fx, tr))
  prefetch = spec.get('prefetch', False)
  tr.train(_rank_rows(ctx, spec['train']), hooks=[trace], prefetch=prefetch,
           save_checkpoint_steps=spec.get('save_every', 0))
  evals = spec['evals'][ctx.rank]
  out = {'trace': trace.steps, 'calls': _launches(),
         'sharded': {s.stacked.name: s.stacked.should_shard(ctx)
                     for s in fx.stacks},
         'eval': tr.evaluate(evals, prefetch=prefetch),
         'preds': [_np(p) for p in tr.predict(evals, prefetch=prefetch)],
         'tower_equal': _equal_on_every_rank(
             ctx, list(tr.state.dense.parameters()))}
  if spec.get('bundle'):
    tr.export_saved_model(spec['bundle'], spec['example'], poly_batch=True)
  return out


def restore(ctx, spec):
  """A ``SparseTrainer`` (``spec['model'] != 'dense'``) or ``Trainer``
  made on ``spec['model_dir']``: the state it restored, gathered."""
  if spec['model'] == 'dense':
    tr, snap = _dense_trainer(ctx, spec, spec['model_dir'])
    return snap()
  fx, tr = _sparse_trainer(ctx, spec, spec['model_dir'])
  return _sparse_snapshot(fx, tr)()


def uneven(ctx, spec):
  """``train`` where rank 1's first batch is a row short: what each rank
  raises, before any step."""
  fx, tr = _sparse_trainer(ctx, spec, None)
  batches = _rank_rows(ctx, spec['train'])
  if ctx.rank == 1:
    batches[0] = {k: v[1:] for k, v in batches[0].items()}
  try:
    tr.train(batches)
  except ValueError as e:
    return {'error': str(e), 'step': tr.global_step}
  return {'error': None, 'step': tr.global_step}


# -- the dense Trainer ----------------------------------------------------------

def _dense_trainer(ctx, spec, model_dir):
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(*t, sharded=spec.get('sharded')))
           for t in spec['tables']]
  gen = torch.Generator().manual_seed(0)
  module = nn.ModuleDict({
      'tables': hbt.init_tables(specs, gen, CPU, ctx),
      'net': hbt.StackedDCNv2(spec['widths'], spec['mlp'])})
  dense = spec['dense']

  def loss_fn(m, b):
    emb, dense_f = hbt.extract_features(m['tables'], b, specs, dense,
                                        ctx=ctx)
    return _bce(m['net'](emb + dense_f), b['label'])

  if spec.get('sgd'):
    opt = torch.optim.SGD(module.parameters(), lr=spec['sgd'])
  else:
    opt = hbt.multi_optimizer(
        functools.partial(hbt.Adagrad, lr=0.05),
        functools.partial(torch.optim.Adam, lr=1e-3))(module)
  hbt.from_jax_dense(module, specs, spec['init'], opt, ctx=ctx)
  tr = hbt.Trainer(loss_fn, module, opt, model_dir, ctx=ctx, group_key='g',
                   gradient_wire_dtype=spec.get('wire'))

  def snap():
    tables = module['tables']
    out = {'tables': {}, 'slots': {}, 'step': tr.global_step,
           'tower': {n: _np(p) for n, p in module['net'].named_parameters()}}
    for s in specs:
      t = tables[s.name]
      gather = (lambda x: collective.allgather(x.detach(), ctx=ctx)
                if hbt.table_shard(t) is not None else x)
      out['tables'][s.name] = _np(gather(t))
      slots = opt.state.get(t, {})
      if 'sum_of_squares' in slots:
        out['slots'][s.name] = _np(gather(slots['sum_of_squares']))
    return out

  return tr, snap


def dense(ctx, spec):
  """The dense ``Trainer`` from the JAX initial state, as :func:`sparse`,
  with its tables row-sharded (or replicated, ``spec['sharded']``) and
  the wire ``spec['wire']``; whether every replicated parameter is rank
  0's, bit for bit, after training (ROADMAP F4)."""
  tr, snap = _dense_trainer(ctx, spec, spec.get('model_dir'))
  trace = _Trace(snap)
  tr.train(_rank_rows(ctx, spec['train']), hooks=[trace],
           save_checkpoint_steps=spec.get('save_every', 0))
  evals = spec['evals'][ctx.rank]
  module = tr.state.params
  out = {'trace': trace.steps, 'eval': tr.evaluate(evals),
         'preds': [_np(p) for p in tr.predict(evals)],
         'sharded': {n: hbt.table_shard(p) is not None
                     for n, p in module['tables'].items()},
         'tower_equal': _equal_on_every_rank(
             ctx, [p for p in module.parameters()
                   if hbt.table_shard(p) is None])}
  if spec.get('bundle'):
    tr.export_saved_model(spec['bundle'], spec['example'], poly_batch=True)
  return out


KINDS = {'sparse': sparse, 'dense': dense, 'restore': restore,
         'uneven': uneven}


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
