"""The port's trainers against the JAX package's, on the CPU.

3 tables of [500, 16] (stacked into one for the sparse trainer), 2 dense
features, batch 64 with invalid ids, BCE loss with per-example losses,
Adam 1e-3 on the tower. The JAX trainers run in a one-device context,
the port's on ``torch.device('cpu')`` from the JAX initial state
(``convert.from_jax`` / ``from_jax_dense``), and both train on the same
6 batches through their sync and prefetch iterators, then evaluate 3
batches (the last one short) with a group column, and predict. Cases:

* ``SparseTrainer``: DCNv2 + row-sparse Adagrad 0.05, and DLRM + LazyAdam
  0.05 (the JAX trainer makes LazyAdam tables unpacked);
* the dense ``Trainer``: one table per column, one of them ragged
  (padded ids with a mask, combined by mean), under
  ``multi_optimizer(adagrad 0.05, adam 1e-3)``;
* checkpoint and resume against an uninterrupted run, both trainers,
  bit for bit;
* JAX for 3 steps, carried across with the later-step converters, then
  3 port steps, against JAX for 6 steps;
* ``lookup_sparse`` and ``extract_features`` on ragged columns.

Tolerances: tables, slots, tower weights and Adam moments to ``rtol =
1e-5, atol = 2e-6`` after 6 steps (``test_torch_sparse_step.py``'s: the
same f32 math with matmuls and duplicate-row sums in other orders);
LazyAdam tables to ``atol = 2e-5`` (``test_torch_sparse_step_
optimizers.py`` derives it: an update near a zero gradient moves by up
to ``5e6`` times the gradient's rounding difference), except where the
first moment shows that a row's gradient total cancelled (see
``_assert_sparse_state``). Predictions to
``rtol = 1e-5, atol = 1e-6``, eval and train losses to ``rtol = 1e-5``.
AUC: a prediction within the two packages' prediction gap of one of the
200 thresholds may fall in another bucket, and each such prediction
moves the AUC by at most ``1 / min(positives, negatives)``; the AUC is
held to that many times that, plus 1e-6 for the sum's order. GAUC to
``rtol = 1e-5``.
The lookups to ``rtol = 1e-6, atol = 1e-7`` (f32 sums over a row's ids
in another order).
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hybridbackend_tpu.embedding.lookup import (
    lookup_sparse as jax_lookup_sparse)
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.embedding.table import create_table as jax_create_table
from hybridbackend_tpu.estimator import SparseTrainer as JSparseTrainer
from hybridbackend_tpu.estimator import Trainer as JTrainer
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor,
    extract_features as jax_extract_features,
    init_tables as jax_init_tables)
from hybridbackend_tpu.models.ranking import (
    dlrm_apply, dlrm_init, stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.training.optimizer import (
    multi_optimizer as jax_multi_optimizer)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch import metrics as hbm

TABLES, VOCAB, DIM, DENSE, BATCH, STEPS = 3, 500, 16, 2, 64, 6
MLP = [32, 16, 1]
BOTTOM = [32, 16]
TOL = dict(rtol=1e-5, atol=2e-6)
CPU = torch.device('cpu')
DENSE_NAMES = [f'i{d}' for d in range(DENSE)]


def _batch(rng, rows, ragged=False):
  b = {}
  for t in range(TABLES):
    ids = rng.randint(0, VOCAB, rows).astype(np.int32)
    ids[rng.choice(rows, 3, replace=False)] = -1
    ids[rng.choice(rows, 2, replace=False)] = VOCAB + 7
    b[f'c{t}'] = ids
  if ragged:
    b['tags'] = rng.randint(-1, VOCAB, (rows, 4)).astype(np.int32)
    b['tags_mask'] = rng.rand(rows, 4) < 0.6
  for d in range(DENSE):
    b[f'i{d}'] = rng.rand(rows).astype(np.float32)
  b['label'] = rng.randint(0, 2, rows).astype(np.float32)
  b['g'] = rng.randint(0, 6, rows).astype(np.int32)
  return b


def _data(ragged=False, seed=0):
  rng = np.random.RandomState(seed)
  train = [_batch(rng, BATCH, ragged) for _ in range(STEPS)]
  evals = [_batch(rng, BATCH, ragged), _batch(rng, BATCH, ragged),
           _batch(rng, 37, ragged)]
  return train, evals


def _jctx():
  return JContext(build_mesh(devices=jax.devices()[:1]))


def _jbce(p, y):
  p = jnp.clip(p, 1e-6, 1 - 1e-6)
  pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
  return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}


def _tbce(p, y):
  p = torch.clamp(p, 1e-6, 1 - 1e-6)
  pel = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
  return torch.mean(pel), {'preds': p, 'per_example_loss': pel}


def _towers(model):
  """The JAX tower params and apply, the port's tower and apply."""
  if model == 'dcnv2':
    net = stacked_dcn_v2_init(jax.random.PRNGKey(1),
                              [DIM] * TABLES + [1] * DENSE, MLP)
    return (net, lambda p, e, d: stacked_dcn_v2_apply(p, e + d),
            hbt.StackedDCNv2([DIM] * TABLES + [1] * DENSE, MLP),
            lambda t, e, d: t(e + d))
  net = dlrm_init(jax.random.PRNGKey(1), DENSE, TABLES, BOTTOM, DIM, MLP)
  return (net, lambda p, e, d: dlrm_apply(p, d, e),
          hbt.DLRM(DENSE, TABLES, BOTTOM, DIM, MLP),
          lambda t, e, d: t(d, e))


def _np(tree):
  return jax.tree.map(np.asarray, tree)


def _tensors(b):
  return {k: torch.from_numpy(v) for k, v in b.items()}


# -- the sparse trainer -------------------------------------------------------

def _sparse_pair(model, optimizer, ctx):
  """A JAX SparseTrainer and a port SparseTrainer from its initial state."""
  specs = [JEmbeddingSpec(JTableConfig(f'c{t}', VOCAB, DIM))
           for t in range(TABLES)]
  jfx = JStackedFeatureExtractor(specs, dense_columns=DENSE_NAMES, ctx=ctx)
  net, japply, tower, tapply = _towers(model)
  jtr = JSparseTrainer(
      jfx, lambda p, e, d, b: _jbce(japply(p, e, d), b['label']), net,
      dense_optimizer=optax.adam(1e-3), table_lr=0.05, adagrad_init=0.1,
      table_optimizer=optimizer, ctx=ctx, group_key='g',
      rng=jax.random.PRNGKey(0))
  fx = _port_fx()
  init = _np(jtr.state)
  state = hbt.from_jax(fx, init.tables,
                       {k: v.acc for k, v in init.table_opt.items()},
                       tower, init.dense,
                       functools.partial(torch.optim.Adam, lr=1e-3))
  loss = lambda t, e, d, b: _tbce(tapply(t, e, d), b['label'])
  return jtr, fx, state, loss


def _port_fx():
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{t}', VOCAB, DIM))
           for t in range(TABLES)]
  return hbt.StackedFeatureExtractor(specs, dense_columns=DENSE_NAMES,
                                     ctx=hbt.Context(CPU))


def _assert_sparse_state(state, want, lazy_adam):
  for name, table in state.tables.items():
    rows = table.shape[0]       # the JAX layout's padding rows dropped
    got, w = table.numpy(), want.tables[name].reshape(-1, DIM)[:rows]
    if lazy_adam:
      # Where a row's gradient total cancels to near zero, its rounding is
      # a large share of it: the first moments differ by more than 1e-3
      # of themselves, and the update lr * m / (sqrt(v) + eps), with v far
      # below eps**2, carries that to the table. There an element may be
      # up to STEPS * 2.2 * lr apart (the most LazyAdam moves it), in at
      # most 1% of the elements; elsewhere 2e-5.
      m, wm = (state.table_opt[name].acc[0].numpy(),
               want.table_opt[name].acc[0].reshape(-1, DIM)[:rows])
      moved = np.abs(m - wm) > 1e-3 * np.abs(wm)
      far = np.abs(got - w) > 2e-5 + TOL['rtol'] * np.abs(w)
      assert not (far & ~moved).any() and far.mean() <= 0.01
      assert np.abs(got - w).max() <= STEPS * 2.2 * 0.05
    else:
      np.testing.assert_allclose(got, w, **TOL)
    for got, w in zip(state.table_opt[name].acc, want.table_opt[name].acc):
      np.testing.assert_allclose(got.numpy(), w.reshape(-1, DIM)[:rows],
                                 **TOL)
  for p, w in hbt.convert._pairs(state.dense, want.dense):
    np.testing.assert_allclose(p.detach().numpy(), w.numpy(), **TOL)
  assert state.step == int(want.step)


def _assert_eval(got, want, preds, jpreds):
  assert set(got) == set(want) == {'auc', 'loss', 'batches', 'gauc'}
  assert got['batches'] == want['batches'] == 3
  labels = np.concatenate([np.asarray(p) for p in jpreds[1]])
  p_port = np.concatenate([p.numpy() for p in preds])
  p_jax = np.concatenate([np.asarray(p) for p in jpreds[0]])
  np.testing.assert_allclose(p_port, p_jax, rtol=1e-5, atol=1e-6)
  limit, _, _ = hbm.auc_limit(p_port, p_jax, labels)
  assert abs(got['auc'] - want['auc']) <= limit
  np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
  np.testing.assert_allclose(got['gauc'], want['gauc'], rtol=1e-5)


@pytest.mark.parametrize('model,optimizer', [('dcnv2', 'adagrad'),
                                             ('dlrm', 'adam')])
def test_sparse_trainer_matches_jax(model, optimizer):
  train, evals = _data()
  ctx = _jctx()
  with context_scope(ctx):
    jtr, fx, state, loss = _sparse_pair(model, optimizer, ctx)
    jm = jtr.train(iter(train))
    want = _np(jtr.state)
    jres = jtr.evaluate(iter(evals))
    jpreds = (list(jtr.predict(iter(evals))),
              [b['label'] for b in evals])
  tr = hbt.SparseTrainer(fx, loss, state.dense, tables=state.tables,
                         table_optimizer=optimizer, group_key='g')
  m = tr.train(iter(train), prefetch=True)
  assert tr.global_step == STEPS
  np.testing.assert_allclose(m['loss'], jm['loss'], rtol=1e-5)
  _assert_sparse_state(tr.state, want, optimizer == 'adam')
  _assert_eval(tr.evaluate(iter(evals), prefetch=True), jres,
               list(tr.predict(iter(evals), prefetch=True)), jpreds)


# -- the dense trainer --------------------------------------------------------

def _dense_specs(pkg):
  Spec, Config = ((JEmbeddingSpec, JTableConfig) if pkg == 'jax'
                  else (hbt.EmbeddingSpec, hbt.TableConfig))
  return ([Spec(Config(f'c{t}', VOCAB, DIM)) for t in range(TABLES)]
          + [Spec(Config('tags', VOCAB, DIM, combiner='mean'))])


def _dense_pair(ctx):
  jspecs, specs = _dense_specs('jax'), _dense_specs('port')
  net = stacked_dcn_v2_init(jax.random.PRNGKey(1),
                            [DIM] * (TABLES + 1) + [1] * DENSE, MLP)
  params = {'tables': jax_init_tables(jspecs, jax.random.PRNGKey(0), ctx),
            'net': net}

  def jloss(p, b):
    emb, dense = jax_extract_features(p['tables'], b, jspecs, DENSE_NAMES,
                                      ctx=ctx)
    return _jbce(stacked_dcn_v2_apply(p['net'], emb + dense), b['label'])

  jtr = JTrainer(jloss, params,
                 jax_multi_optimizer(optax.adagrad(0.05),
                                     optax.adam(1e-3))(params),
                 ctx=ctx, group_key='g')
  module = nn.ModuleDict({
      'tables': hbt.init_tables(specs, torch.Generator().manual_seed(0), CPU),
      'net': hbt.StackedDCNv2([DIM] * (TABLES + 1) + [1] * DENSE, MLP)})

  def loss(m, b):
    emb, dense = hbt.extract_features(m['tables'], b, specs, DENSE_NAMES)
    return _tbce(m['net'](emb + dense), b['label'])

  return jtr, specs, module, loss


def _port_optimizer(module):
  return hbt.multi_optimizer(
      functools.partial(hbt.Adagrad, lr=0.05),
      functools.partial(torch.optim.Adam, lr=1e-3))(module)


def _jax_slots(opt_state):
  """optax multi_optimizer(adagrad, adam) state: the tables' sums of
  squares and the tower's Adam state."""
  sos = opt_state[0].inner_state[0].sum_of_squares['tables']
  adam = opt_state[1].inner_state[0]
  return sos, (adam.mu['net'], adam.nu['net'], int(adam.count))


def _assert_dense_state(tr, want, specs):
  sos, (mu, _, count) = _jax_slots(want.opt_state)
  tables = tr.state.params['tables']
  opt = tr.state.optimizer
  for s in specs:
    np.testing.assert_allclose(
        tables[s.name].detach().numpy(),
        want.params['tables'][s.name].reshape(-1, DIM)[:VOCAB], **TOL)
    np.testing.assert_allclose(
        opt.state[tables[s.name]]['sum_of_squares'].numpy(),
        sos[s.name].reshape(-1, DIM)[:VOCAB], **TOL)
  net = tr.state.params['net']
  for (p, w), (_, m) in zip(hbt.convert._pairs(net, want.params['net']),
                            hbt.convert._pairs(net, mu)):
    np.testing.assert_allclose(p.detach().numpy(), w.numpy(), **TOL)
    np.testing.assert_allclose(opt.state[p]['exp_avg'].numpy(), m.numpy(),
                               **TOL)
    assert float(opt.state[p]['step']) == count
  assert tr.global_step == int(want.step)


def test_dense_trainer_matches_jax():
  train, evals = _data(ragged=True)
  ctx = _jctx()
  with context_scope(ctx):
    jtr, specs, module, loss = _dense_pair(ctx)
    init = _np(jtr.state)
    jm = jtr.train(iter(train))
    want = _np(jtr.state)
    jres = jtr.evaluate(iter(evals))
    jpreds = (list(jtr.predict(iter(evals))),
              [b['label'] for b in evals])
  opt = _port_optimizer(module)
  hbt.from_jax_dense(module, specs, init.params, opt)
  tr = hbt.Trainer(loss, module, opt, ctx=hbt.Context(CPU), group_key='g')
  m = tr.train(iter(train), prefetch=True)
  np.testing.assert_allclose(m['loss'], jm['loss'], rtol=1e-5)
  _assert_dense_state(tr, want, specs)
  _assert_eval(tr.evaluate(iter(evals), prefetch=True), jres,
               list(tr.predict(iter(evals), prefetch=True)), jpreds)


# -- carrying a later step across ---------------------------------------------

@pytest.mark.parametrize('kind', ['sparse', 'dense'])
def test_later_step_carries_across(kind):
  """JAX for 3 steps, the state carried into the port, 3 port steps;
  against JAX for all 6."""
  train, _ = _data(ragged=kind == 'dense', seed=1)
  ctx = _jctx()
  with context_scope(ctx):
    if kind == 'sparse':
      jtr, fx, _, loss = _sparse_pair('dcnv2', 'adagrad', ctx)
    else:
      jtr, specs, module, loss = _dense_pair(ctx)
    jtr.train(iter(train[:3]))
    mid = _np(jtr.state)
    jtr.train(iter(train[3:]))
    want = _np(jtr.state)
  if kind == 'sparse':
    adam = mid.dense_opt[0]
    tower = _towers('dcnv2')[2]
    tr = hbt.SparseTrainer(fx, loss, tower)
    tr.state = hbt.from_jax(
        fx, mid.tables, {k: v.acc for k, v in mid.table_opt.items()},
        tower, mid.dense, functools.partial(torch.optim.Adam, lr=1e-3),
        step=int(mid.step), adam=(adam.mu, adam.nu, int(adam.count)))
    assert tr.global_step == 3
    tr.train(iter(train[3:]))
    _assert_sparse_state(tr.state, want, lazy_adam=False)
  else:
    opt = _port_optimizer(module)
    tr = hbt.Trainer(loss, module, opt, ctx=hbt.Context(CPU))
    sos, adam = _jax_slots(mid.opt_state)
    tr.state = hbt.from_jax_dense(module, specs, mid.params, opt,
                                  step=int(mid.step), sum_of_squares=sos,
                                  adam=adam)
    assert tr.global_step == 3
    tr.train(iter(train[3:]))
    _assert_dense_state(tr, want, specs)


# -- checkpoint and resume ------------------------------------------------------

def _port_trainer(kind, model_dir):
  if kind == 'sparse':
    fx = _port_fx()
    tower = hbt.StackedDCNv2([DIM] * TABLES + [1] * DENSE, MLP,
                             generator=torch.Generator().manual_seed(1))
    return hbt.SparseTrainer(
        fx, lambda t, e, d, b: _tbce(t(e + d), b['label']), tower,
        model_dir=model_dir)
  specs = _dense_specs('port')
  gen = torch.Generator().manual_seed(0)
  module = nn.ModuleDict({
      'tables': hbt.init_tables(specs, gen, CPU),
      'net': hbt.StackedDCNv2([DIM] * (TABLES + 1) + [1] * DENSE, MLP,
                              generator=gen)})

  def loss(m, b):
    emb, dense = hbt.extract_features(m['tables'], b, specs, DENSE_NAMES)
    return _tbce(m['net'](emb + dense), b['label'])

  return hbt.Trainer(loss, module, _port_optimizer(module), model_dir,
                     ctx=hbt.Context(CPU))


def _assert_states_equal(a, b):
  sa, sb = a._checkpoint_state(), b._checkpoint_state()
  flat_a = jax.tree_util.tree_flatten_with_path(sa)[0]
  flat_b = dict(jax.tree_util.tree_flatten_with_path(sb)[0])
  assert len(flat_a) == len(flat_b)
  for path, x in flat_a:
    y = flat_b[path]
    if isinstance(x, torch.Tensor):
      assert torch.equal(x, y), jax.tree_util.keystr(path)
    else:
      assert x == y, jax.tree_util.keystr(path)


@pytest.mark.parametrize('kind', ['sparse', 'dense'])
def test_resume_equals_an_uninterrupted_run(tmp_path, kind):
  train, _ = _data(ragged=kind == 'dense', seed=2)
  live = _port_trainer(kind, str(tmp_path / 'a'))
  live.train(iter(train), save_checkpoint_steps=3)
  assert live._ckpt.all_steps() == [3, 6]
  restored = _port_trainer(kind, str(tmp_path / 'a'))
  assert restored.global_step == STEPS
  _assert_states_equal(restored, live)
  os.makedirs(tmp_path / 'b')
  shutil.copy(tmp_path / 'a' / 'checkpoint-3.pt', tmp_path / 'b')
  resumed = _port_trainer(kind, str(tmp_path / 'b'))
  assert resumed.global_step == 3
  resumed.train(iter(train[3:]))
  _assert_states_equal(resumed, live)


# -- the trainer's loop ----------------------------------------------------------

def test_train_options_and_eval_flags(tmp_path):
  train, evals = _data(seed=3)
  tr = _port_trainer('sparse', None)
  seen = []
  hook = hbt.StepStatHook(batch_size=BATCH, every_n_steps=2,
                          sync_every_n=2, log=seen.append)
  tr.train(iter(train), max_steps=4, hooks=[hook], eval_every_n_steps=2,
           eval_batches_fn=lambda: iter(evals[:1]), prefetch=True)
  assert tr.global_step == 4
  assert len(hook.synced_secs_per_step) == 1  # step 1 is warmup
  # 4 steps, the batch that ends the loop, and the one placed after it.
  assert hook.input_stall_stats['gets'] == 6
  assert all('since the last report' in line for line in seen)
  tr.train(iter(train), prefetch=False, sync=False, max_steps=1)
  assert tr.global_step == 5
  plain = lambda t, e, d, b: (_tbce(t(e + d), b['label'])[0],
                              {'preds': t(e + d)})
  scalar = hbt.SparseTrainer(_port_fx(), plain, tr.state.dense,
                             tables=tr.state.tables)
  res = scalar.evaluate(iter(evals), prefetch=False)
  assert res['loss_exact'] == 0.0 and 'gauc' not in res
  both = tr.train_and_evaluate(lambda: iter(train[:2]),
                               lambda: iter(evals), epochs=2)
  assert tr.global_step == 9 and both['batches'] == 3


def test_stall_report_counts_per_window():
  class It:
    stall_stats = {'gets': 10, 'stalls': 4, 'stall_s': 1.0,
                   'stall_fraction': 0.4}
  lines = []
  hook = hbt.StepStatHook(every_n_steps=1, warmup_steps=0, log=lines.append)
  it = It()
  hook.set_input_iterator(it)
  hook.before_step(0)
  hook.after_step(1, {})
  it.stall_stats = {'gets': 30, 'stalls': 5, 'stall_s': 1.5,
                    'stall_fraction': 5 / 30}
  hook.before_step(1)
  hook.after_step(2, {})
  assert 'input stalls 4/10 (40.0%' in lines[0]
  assert 'input stalls 1/20 (5.0%, 0.50s waited)' in lines[1]


def test_trainer_refuses_params_off_its_device():
  module = nn.Linear(2, 1)
  with pytest.raises(ValueError, match='context'):
    hbt.Trainer(lambda m, b: (m(b['x']).sum(), {}), module,
                ctx=hbt.Context('meta'))


# -- the dense path's lookups ------------------------------------------------------

@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('combiner', ['sum', 'mean', 'sqrtn'])
def test_lookup_sparse_matches_jax(combiner, weighted):
  rng = np.random.RandomState(4)
  ids = rng.randint(-2, VOCAB + 3, (32, 5)).astype(np.int32)
  mask = rng.rand(32, 5) < 0.6
  mask[0] = False                            # an empty row
  w = rng.rand(32, 5).astype(np.float32) if weighted else None
  ctx = _jctx()
  with context_scope(ctx):
    cfg = JTableConfig('t', VOCAB, DIM, combiner=combiner)
    table = jax_create_table(cfg, jax.random.PRNGKey(0), ctx)
    want = jax_lookup_sparse(table, jnp.asarray(ids), jnp.asarray(mask), cfg,
                             None if w is None else jnp.asarray(w), ctx=ctx)
  logical = torch.tensor(np.asarray(table).reshape(-1, DIM)[:VOCAB])
  got = hbt.lookup_sparse(
      logical, torch.from_numpy(ids), torch.from_numpy(mask),
      hbt.TableConfig('t', VOCAB, DIM, combiner=combiner),
      None if w is None else torch.from_numpy(w))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-7)
  assert not got[0].any()


def test_extract_features_matches_jax():
  rng = np.random.RandomState(5)
  batch = _batch(rng, 32, ragged=True)
  batch['multi'] = rng.randint(0, VOCAB, (32, 3)).astype(np.int32)
  batch['wide'] = rng.rand(32, 2).astype(np.float32)
  ctx = _jctx()
  jspecs = _dense_specs('jax') + [JEmbeddingSpec(JTableConfig('m', VOCAB,
                                                              DIM),
                                                 column='multi')]
  specs = _dense_specs('port') + [hbt.EmbeddingSpec(
      hbt.TableConfig('m', VOCAB, DIM), column='multi')]
  with context_scope(ctx):
    tables = jax_init_tables(jspecs, jax.random.PRNGKey(0), ctx)
    want = jax_extract_features(
        tables, {k: jnp.asarray(v) for k, v in batch.items()}, jspecs,
        DENSE_NAMES + ['wide'], ctx=ctx)
  ptables = {k: torch.tensor(np.asarray(v).reshape(-1, DIM)[:VOCAB])
             for k, v in tables.items()}
  got = hbt.extract_features(ptables, _tensors(batch), specs,
                             DENSE_NAMES + ['wide'])
  for g_list, w_list in zip(got, want):
    assert len(g_list) == len(w_list)
    for g, w in zip(g_list, w_list):
      assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
      np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                 atol=1e-7)
