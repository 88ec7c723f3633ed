"""The port's trainers at a world of N ranks against the JAX trainers on N
devices, on the CPU.

The port runs N gloo CPU ranks started by its launcher (``run.py
--simulate N --device cpu``), each a process of
``torch_trainer_worker.py`` that imports no JAX; all cases of one world
go in one launch, N = 2 and then N = 4. The JAX trainers run on a
sub-mesh of N of the suite's 8 virtual CPU devices
(``Context(build_mesh(devices=jax.devices()[:N]))``, as
``test_torch_trainer.py`` drives them on one) on the global batches;
their initial states reach the ranks through ``convert.from_jax`` and
``from_jax_dense``, and each rank trains on its rows ``[r·B/N,
(r+1)·B/N)`` of each global batch of 32. Cases:

* ``SparseTrainer``: DCNv2 + Adagrad 0.05 (3 tables of [300, 8] stacked
  and row-sharded, 2 dense features, a group column, fed through
  ``DeviceIterator``: ``prefetch=True`` at every N), DCNv2 + LazyAdam,
  and DIN in raw mode (``test_torch_sharded_din.py``'s shapes);
* the dense ``Trainer``: one table per column, row-sharded
  (``init_tables(..., ctx=ctx)``) and looked up through the
  differentiable sharded lookup, ``multi_optimizer(Adagrad 0.05, Adam
  1e-3)``; the same with ``gradient_wire_dtype='bfloat16'``, which falls
  back to f32 (``wire_grad`` 0.0) and gives the same bits; and with
  replicated tables (``sharded=False``) on a bf16 wire (``wire_grad``
  1.0) against JAX's wire path, everything under SGD 0.1 on both sides
  as in ``test_torch_wire.py``;
* 4 steps, a checkpoint every 2; per-step loss, the tower, the gathered
  tables and slots against JAX's state after each step;
* ``evaluate`` over eval batches of other row counts on each rank: the
  last one uneven across the ranks, and a rank (rank 1, and at N = 4
  rank 3 too) that runs out a batch early. JAX evaluates the global
  batches, each the ranks' batches of a step concatenated in rank order;
* the checkpoints written at N = 2 restored bit for bit at N = 1 (in
  this process) and at N = 4 (in the N = 4 launch);
* the SparseTrainer's and the dense Trainer's bundles exported at N = 2
  (rank 0 writes them), served by ``Served`` in this process against
  JAX's predictions;
* ROADMAP F4: every rank's replicated parameters bit for bit rank 0's
  after training;
* a rank whose train batch is a row short: every rank raises before
  any step.

Tolerances, ``test_torch_sharded_step.py``'s: per-step loss ``rtol =
1e-5``; tower, gathered tables and slots ``STATE_TOL`` (``rtol = 1e-5,
atol = 2e-6``: the same f32 math, with the tower's gradients, duplicate
rows and the dense tables' gradients summed over the ranks in other
orders). LazyAdam's tables by ``test_torch_trainer.py``'s rule (an
update near a cancelled gradient total moves by up to 2.2·lr, in at most
1% of the elements, where the first moments show it). The bf16 wire by
``test_torch_wire.py``'s bands (see its test). Predictions ``rtol =
1e-5, atol = 1e-6``; eval loss and GAUC ``rtol = 1e-5``; AUC within
``metrics.auc_limit`` of JAX's (a prediction that close to one of the
200 thresholds may fall in the other bucket).

The sync iterator's liveness (a dead peer, ``close()``, its keys) and its
padding are held in this process, two ranks as two threads over one
in-memory store.
"""

import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hybridbackend_tpu.data.sync import (
    SyncReplicasIterator as JSyncReplicasIterator, _pad_column as jpad)
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.estimator import SparseTrainer as JSparseTrainer
from hybridbackend_tpu.estimator import Trainer as JTrainer
from hybridbackend_tpu.framework.context import context_scope
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor,
    extract_features as jax_extract_features,
    init_tables as jax_init_tables)
from hybridbackend_tpu.models.ranking import (
    din_apply, din_init, stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.training.optimizer import (
    multi_optimizer as jax_multi_optimizer)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch import metrics as hbm
from hybridbackend_tpu_torch.data import sync as psync
from test_torch_distribute import LAUNCH_S, jctx, launched, start_launch

TABLES = [('c0', 300, 8), ('c1', 301, 8), ('c2', 302, 8)]
DENSE = ['i0', 'i1']
WIDTHS = [8, 8, 8, 1, 1]
MLP = [16, 8, 1]
ITEMS, USERS, DIM, HIST = 300, 100, 8, 6
DNN, ATT = (16, 8), (8, 4)
BATCH, STEPS, SAVE_EVERY = 32, 4, 2
# Each rank's eval batches, by their rows.
EVAL_ROWS = {2: [[16, 16, 6], [16, 11]],
             4: [[8, 8, 5], [8, 8], [8, 3, 2], [8, 8]]}
STATE_TOL = dict(rtol=1e-5, atol=2e-6)
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
TOWER_BAND = dict(rtol=5e-2, atol=1e-4)
SPARSE = ('adagrad', 'adam', 'din')
DENSE_CASES = ('dense', 'dense_wire_shard', 'dense_wire')


# -- data ----------------------------------------------------------------------

def _ctr_batch(rng, rows):
  b = {}
  for name, vocab, _ in TABLES:
    ids = rng.randint(0, vocab, rows).astype(np.int32)
    ids[rng.choice(rows, max(1, rows // 10), replace=False)] = -1
    ids[rng.choice(rows, max(1, rows // 16), replace=False)] = vocab + 7
    b[name] = ids
  for d in DENSE:
    b[d] = rng.rand(rows).astype(np.float32)
  b['label'] = rng.randint(0, 2, rows).astype(np.float32)
  b['g'] = rng.randint(0, 6, rows).astype(np.int32)
  return b


def _din_batch(rng, rows):
  item = rng.randint(0, ITEMS, rows)
  hist = rng.randint(0, ITEMS, (rows, HIST))
  hist[:2, 1] = item[:2]                   # the candidate in its history
  hist[2:4, 5] = ITEMS + 7                 # invalid: reads zeros
  mask = np.arange(HIST)[None] < rng.randint(1, HIST + 1, rows)[:, None]
  hist = np.where(mask, hist, -1)          # holes behind the mask
  return {'cand_hist': np.concatenate([item[:, None], hist], 1).astype(
              np.int32),
          'hist_mask': mask,
          'user': rng.randint(0, USERS, rows).astype(np.int32),
          'd0': rng.rand(rows, 1).astype(np.float32),
          'd1': rng.rand(rows, 1).astype(np.float32),
          'label': rng.randint(0, 2, rows).astype(np.float32)}


def _data(world, make, seed):
  """The global train batches; each rank's eval batches; the global eval
  batches (the ranks' of each step in rank order); and all eval rows in
  rank order (the predictions' order)."""
  rng = np.random.RandomState(seed)
  train = [make(rng, BATCH) for _ in range(STEPS)]
  evals = [[make(rng, n) for n in rows] for rows in EVAL_ROWS[world]]
  steps = max(len(e) for e in evals)
  cat = lambda bs: {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
  global_evals = [cat([e[k] for e in evals if k < len(e)])
                  for k in range(steps)]
  return train, evals, global_evals, cat([b for e in evals for b in e])


def _padded(batch, world):
  """``batch`` padded with zero rows to a multiple of the world (a JAX
  predict batch splits over the mesh)."""
  n = len(batch['label'])
  return psync._padded(batch, -(-n // world) * world), n


# -- the JAX trainers -----------------------------------------------------------

def _jbce(p, y):
  p = jnp.clip(p, 1e-6, 1 - 1e-6)
  pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
  return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}


def _np(tree):
  return jax.tree.map(np.asarray, tree)


def _jax_sparse(case, jc):
  if case == 'din':
    fx = JStackedFeatureExtractor(
        [JEmbeddingSpec(JTableConfig('item', ITEMS, DIM), column='cand_hist'),
         JEmbeddingSpec(JTableConfig('user', USERS, DIM))], ctx=jc)
    net = din_init(jax.random.PRNGKey(1), DIM, num_profile_features=1,
                   num_dense=2, dnn_hidden_units=DNN, att_hidden_size=ATT)

    def raw_loss(p, members, b):
      emb = members['item']
      return _jbce(din_apply(p, emb[:, 0], emb[:, 1:], b['hist_mask'],
                             [members['user']], [b['d0'], b['d1']]),
                   b['label'])
    return JSparseTrainer(fx, None, net, raw_model_loss=raw_loss,
                          dense_optimizer=optax.adam(1e-3), table_lr=0.05,
                          adagrad_init=0.1, ctx=jc,
                          rng=jax.random.PRNGKey(0))
  fx = JStackedFeatureExtractor([JEmbeddingSpec(JTableConfig(*t))
                                 for t in TABLES], dense_columns=DENSE,
                                ctx=jc)
  net = stacked_dcn_v2_init(jax.random.PRNGKey(1), WIDTHS, MLP)
  return JSparseTrainer(
      fx, lambda p, e, d, b: _jbce(stacked_dcn_v2_apply(p, e + d),
                                   b['label']),
      net, dense_optimizer=optax.adam(1e-3), table_lr=0.05, adagrad_init=0.1,
      table_optimizer='adam' if case == 'adam' else 'adagrad', ctx=jc,
      group_key='g', rng=jax.random.PRNGKey(0))


def _jax_dense(case, jc):
  sharded = None if case != 'dense_wire' else False
  specs = [JEmbeddingSpec(JTableConfig(*t, sharded=sharded))
           for t in TABLES]
  params = {'tables': jax_init_tables(specs, jax.random.PRNGKey(0), jc),
            'net': stacked_dcn_v2_init(jax.random.PRNGKey(1), WIDTHS, MLP)}

  def loss(p, b):
    emb, dense = jax_extract_features(p['tables'], b, specs, DENSE, ctx=jc)
    return _jbce(stacked_dcn_v2_apply(p['net'], emb + dense), b['label'])

  opt = (optax.sgd(0.1) if case == 'dense_wire' else
         jax_multi_optimizer(optax.adagrad(0.05), optax.adam(1e-3))(params))
  return JTrainer(loss, params, opt, ctx=jc, group_key='g')


def _jax_state(case, jtr):
  """The JAX state as the worker's snapshot: whole tables and slots by
  stack (or table) name, and the tower's params."""
  s = _np(jtr.state)
  if case in DENSE_CASES:
    slots = ({} if case == 'dense_wire' else
             s.opt_state[0].inner_state[0].sum_of_squares['tables'])
    return {'tables': dict(s.params['tables']), 'slots': dict(slots),
            'tower': s.params['net'], 'step': int(s.step)}
  return {'tables': dict(s.tables),
          'slots': {k: list(v.acc) for k, v in s.table_opt.items()},
          'tower': s.dense, 'step': int(s.step)}


def _jax_trainer(case, world):
  """A JAX trainer of ``case`` on an N-device mesh, and its initial
  state."""
  jc = jctx(world)
  with context_scope(jc):
    jtr = (_jax_dense if case in DENSE_CASES else _jax_sparse)(case, jc)
  return jtr, _np(jtr.state)


def _jax_run(case, world, jtr, data):
  """JAX's state and loss after each step, its eval results and its
  predictions of every eval row."""
  train, _, global_evals, rows = data
  wire = 'bfloat16' if case == 'dense_wire' else 'float32'
  with context_scope(jctx(world)), OPTIONS.override(
      comm_gradient_wire_dtype=wire):
    trace = []
    for b in train:
      m = jtr.train(iter([b]))
      trace.append((m['loss'], _jax_state(case, jtr)))
    res = jtr.evaluate(iter(global_evals))
    padded, n = _padded(rows, world)
    preds = np.concatenate([np.asarray(p).reshape(-1) for p in
                            jtr.predict(iter([padded]))])[:n]
  return trace, res, preds


# -- the ranks ------------------------------------------------------------------

def _case(case, world, data, init, tmp):
  train, evals, _, rows = data
  kind = 'dense' if case in DENSE_CASES else 'sparse'
  spec = dict(train=train, evals=evals, save_every=SAVE_EVERY,
              model_dir=str(tmp / 'ckpt' / case))
  if kind == 'dense':
    spec.update(tables=TABLES, dense=DENSE, widths=WIDTHS, mlp=MLP,
                init={'tables': init.params['tables'],
                      'net': init.params['net']},
                sharded=False if case == 'dense_wire' else None,
                wire=None if case == 'dense' else 'bfloat16',
                sgd=0.1 if case == 'dense_wire' else None)
  elif case == 'din':
    spec.update(model='din', items=ITEMS, users=USERS, dim=DIM, dnn=DNN,
                att=ATT, optimizer='adagrad')
  else:
    spec.update(model='dcnv2', tables=TABLES, dense=DENSE, widths=WIDTHS,
                mlp=MLP, optimizer=case, group_key='g', prefetch=True)
  if kind == 'sparse':
    spec['init'] = {'tables': init.tables, 'dense': init.dense,
                    'acc': {k: v.acc for k, v in init.table_opt.items()}}
  if world == 2 and case in ('adagrad', 'dense'):
    spec.update(bundle=str(tmp / 'bundle' / case),
                example={k: v[:4] for k, v in rows.items()})
  return case, kind, spec


# The JAX runs: 'dense_wire_shard' falls back to 'dense' in JAX, so its
# ranks are held against 'dense''s (``test_dense_wire_falls_back_with_
# shards``).
JAX_CASES = SPARSE + ('dense', 'dense_wire')


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
  """Both worlds' launches (N = 2, then N = 4, which restores N = 2's
  checkpoints) and JAX's runs, made while the ranks run, by world."""
  out = {}
  saved = None
  for world in (2, 4):
    tmp = tmp_path_factory.mktemp(f'trainers{world}')
    data = {case: _data(world, _din_batch if case == 'din' else _ctr_batch,
                        seed=world) for case in SPARSE + DENSE_CASES}
    trainers = {case: _jax_trainer(case, world) for case in JAX_CASES}
    cases = [_case(c, world, data[c],
                   trainers['dense' if c == 'dense_wire_shard' else c][1],
                   tmp) for c in SPARSE + DENSE_CASES]
    if world == 2:
      cases.append(('uneven', 'uneven', cases[0][2]))
    else:
      for case in ('adagrad', 'dense'):
        spec = dict(cases[SPARSE.index(case) if case in SPARSE
                          else len(SPARSE)][2])
        spec['model'] = spec.get('model', 'dense')
        # A copy: the N = 2 directory stays as N = 2 wrote it.
        spec['model_dir'] = str(tmp / 'restored' / case)
        shutil.copytree(os.path.join(saved, case), spec['model_dir'])
        cases.append((f'restore_{case}', 'restore', spec))
    proc = start_launch(world, cases, tmp, worker=WORKER)
    jax_runs = {case: (trainers[case][1], *_jax_run(
        case, world, trainers[case][0], data[case])) for case in JAX_CASES}
    ranks = launched(proc, world, tmp)
    out[world] = dict(data=data, jax=jax_runs, ranks=ranks, tmp=tmp,
                      specs={name: spec for name, _, spec in cases})
    saved = str(tmp / 'ckpt')
  return out


WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_trainer_worker.py')


def _assert_state(got, want, case, label):
  """A snapshot against JAX's state: tables and slots by name (whole, the
  JAX layout's padding rows dropped), the tower."""
  for name, table in want['tables'].items():
    dim = got['tables'][name].shape[1]
    rows = got['tables'][name].shape[0]
    w = np.asarray(table).reshape(-1, dim)[:rows]
    if case == 'adam':
      m = got['slots'][name][0]
      wm = np.asarray(want['slots'][name][0]).reshape(-1, dim)[:rows]
      moved = np.abs(m - wm) > 1e-3 * np.abs(wm)
      far = np.abs(got['tables'][name] - w) > 2e-5 + 1e-5 * np.abs(w)
      assert not (far & ~moved).any() and far.mean() <= 0.01, label
      assert np.abs(got['tables'][name] - w).max() <= STEPS * 2.2 * 0.05
    else:
      np.testing.assert_allclose(got['tables'][name], w, err_msg=label,
                                 **STATE_TOL)
  for name, slots in want['slots'].items():
    got_slots = got['slots'][name]
    if not isinstance(got_slots, list):
      got_slots, slots = [got_slots], [slots]
    for g, w in zip(got_slots, slots):
      np.testing.assert_allclose(
          g, np.asarray(w).reshape(-1, g.shape[1])[:g.shape[0]],
          err_msg=f'{label} {name} slot', **STATE_TOL)
  tower = (hbt.DIN(DIM, 1, 2, DNN, ATT) if case == 'din'
           else hbt.StackedDCNv2(WIDTHS, MLP))
  names = [n for n, _ in tower.named_parameters()]
  for n, (_, w) in zip(names, hbt.convert._pairs(tower, want['tower'])):
    np.testing.assert_allclose(got['tower'][n], w.numpy(),
                               err_msg=f'{label} {n}', **STATE_TOL)


def _assert_eval(got, want, preds, jpreds, labels, label):
  assert got['batches'] == want['batches'], label
  limit, _, _ = hbm.auc_limit(preds, jpreds, labels)
  assert abs(got['auc'] - want['auc']) <= limit, (label, got, want)
  np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5,
                             err_msg=label)
  if 'gauc' in want:
    np.testing.assert_allclose(got['gauc'], want['gauc'], rtol=1e-5,
                               err_msg=label)


@pytest.mark.timeout(2 * LAUNCH_S + 300)
@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('case', SPARSE + ('dense',))
def test_trainer_matches_jax(worlds, world, case):
  """Per-step loss and state, eval metrics and predictions against the
  JAX trainer on an N-device mesh; every rank returns the same eval."""
  run = worlds[world]
  ranks = [r[case] for r in run['ranks']]
  _, trace, jres, jpreds = run['jax'][case]
  for i, (loss, want) in enumerate(trace):
    for r, rank in enumerate(ranks):
      got = rank['trace'][i]
      np.testing.assert_allclose(got['loss'], loss, rtol=1e-5,
                                 err_msg=f'{case} step {i}')
      assert got['step'] == want['step'] == i + 1
      _assert_state(got, want, case, f'{case} rank {r} step {i}')
  assert all(r['tower_equal'] for r in ranks)
  for r in ranks[1:]:
    assert r['eval'] == ranks[0]['eval']
  _, evals, _, rows = run['data'][case]
  preds = np.concatenate([p.reshape(-1) for r in ranks for p in r['preds']])
  np.testing.assert_allclose(preds, jpreds, **PRED_TOL)
  assert [len(p) for r in ranks for p in r['preds']] == [
      n for e in EVAL_ROWS[world] for n in e]
  _assert_eval(ranks[0]['eval'], jres, preds, jpreds, rows['label'], case)
  assert set(ranks[0]['eval']) == set(jres)
  if case in ('adagrad', 'adam', 'dense'):
    assert 'gauc' in ranks[0]['eval']
  sharded = ranks[0]['sharded']
  assert sharded and all(sharded.values()), sharded


@pytest.mark.timeout(2 * LAUNCH_S + 300)
@pytest.mark.parametrize('world', [2, 4])
def test_sparse_trainer_launches_its_update_on_each_rank(worlds, world):
  """Kernel 1's wrapper (Adagrad, DIN) and kernel 3's (LazyAdam) are
  called once a step on every rank (on the CPU a wrapper counts calls,
  not launches)."""
  for case, kernel in (('adagrad', 'adagrad_update_sorted'),
                       ('din', 'adagrad_update_sorted'),
                       ('adam', 'adam_update_sorted')):
    for r in worlds[world]['ranks']:
      calls = r[case]['calls']
      assert calls[kernel] == STEPS, (case, calls)
      assert sum(calls.values()) == STEPS, (case, calls)


@pytest.mark.timeout(2 * LAUNCH_S + 300)
@pytest.mark.parametrize('world', [2, 4])
def test_dense_wire_falls_back_with_shards(worlds, world):
  """``gradient_wire_dtype='bfloat16'`` with row-sharded tables: JAX's
  fallback, ``wire_grad`` 0.0 and the f32 reduction, the same bits as no
  wire; the dense step reports no ``wire_grad`` without a wire."""
  for r in worlds[world]['ranks']:
    for got, want in zip(r['dense_wire_shard']['trace'], r['dense']['trace']):
      assert got['wire_grad'] == 0.0 and 'wire_grad' not in want
      assert got['loss'] == want['loss']
      for key in ('tables', 'slots', 'tower'):
        for name, value in want[key].items():
          np.testing.assert_array_equal(got[key][name], value)
    assert r['dense_wire_shard']['eval'] == r['dense']['eval']


@pytest.mark.timeout(2 * LAUNCH_S + 300)
@pytest.mark.parametrize('world', [2, 4])
def test_dense_wire_matches_jax_wire_path(worlds, world):
  """Replicated tables on a bf16 wire (``wire_grad`` 1.0) against JAX's
  wire path, SGD 0.1 on both sides, by ``test_torch_wire.py``'s bands at
  every N. A gradient is cast to bf16 before the sum: where the two
  packages' f32 gradients (the ranks' rows through other GEMM shapes than
  JAX's devices) differ in their last bits across a bf16 rounding
  boundary, they round to neighbouring bf16 values, and SGD moves the
  weight by lr times that ulp (6.8e-6 seen in 0.3% of a table's elements
  at N = 2). At N = 4 gloo also sums four bf16 values one rank at a time,
  rounding each partial sum, where XLA adds them in f32 and rounds once.
  Every weight here, the tables' too, takes its all-reduced gradient
  under SGD 0.1 (the sparse steps of ``test_torch_wire.py`` route their
  tables' gradients unsummed), so a weight may sit lr times a bf16 ulp of
  its gradient apart (2e-4 seen at N = 4), and the loss follows: to
  ``rtol = 2e-4`` (1.2e-4 seen)."""
  run = worlds[world]
  _, trace, jres, jpreds = run['jax']['dense_wire']
  loss_tol, tol = dict(rtol=2e-4), TOWER_BAND
  for r in run['ranks']:
    rank = r['dense_wire']
    assert not any(rank['sharded'].values())
    assert rank['tower_equal']
    for i, (loss, want) in enumerate(trace):
      got = rank['trace'][i]
      assert got['wire_grad'] == 1.0
      np.testing.assert_allclose(got['loss'], loss, **loss_tol)
      for name, table in want['tables'].items():
        np.testing.assert_allclose(got['tables'][name],
                                   np.asarray(table).reshape(-1, 8)[
                                       :got['tables'][name].shape[0]],
                                   err_msg=f'{name} step {i}', **tol)
      tower = hbt.StackedDCNv2(WIDTHS, MLP)
      names = [n for n, _ in tower.named_parameters()]
      for n, (_, w) in zip(names, hbt.convert._pairs(tower, want['tower'])):
        np.testing.assert_allclose(got['tower'][n], w.numpy(), err_msg=n,
                                   **tol)
  preds = np.concatenate([p.reshape(-1) for r in run['ranks']
                          for p in r['dense_wire']['preds']])
  np.testing.assert_allclose(preds, jpreds, **TOWER_BAND)


@pytest.mark.timeout(2 * LAUNCH_S + 300)
@pytest.mark.parametrize('case', ['adagrad', 'dense'])
def test_checkpoint_restores_at_one_and_four(worlds, case):
  """N = 2's checkpoints: each rank wrote its rows under the step, rank 0
  the replicated leaves, the manifest and the summaries; the latest
  restores at N = 4
  (that launch) and at N = 1 (here) to the state N = 2 ended with, bit
  for bit."""
  two = worlds[2]
  want = two['ranks'][0][case]['trace'][-1]
  steps = os.path.join(str(two['tmp']), 'ckpt', case)
  # The checkpoints, and the summaries of rank 0 alone (one file).
  saved = sorted(os.listdir(steps))
  assert [n for n in saved if not n.startswith('events.out.tfevents.')] == [
      'checkpoint-2', 'checkpoint-4'] and len(saved) == 3, saved
  for step in ('checkpoint-2', 'checkpoint-4'):
    assert sorted(os.listdir(os.path.join(steps, step))) == [
        'manifest.json', 'rank-0.pt', 'rank-1.pt', 'replicated.pt']
  got4 = [r[f'restore_{case}'] for r in worlds[4]['ranks']]
  spec = dict(two['specs'][case], model_dir=None)
  with torch.no_grad():
    one = _restored_at_one(case, spec, steps)
  for world, got in [*((4, g) for g in got4), (1, one)]:
    assert got['step'] == STEPS
    for key in ('tables', 'slots', 'tower'):
      for name, value in want[key].items():
        for g, w in zip(*(v if isinstance(v, list) else [v]
                          for v in (got[key][name], value))):
          if key != 'tower':
            g, w = _logical(name, g, world), _logical(name, w, 2)
          np.testing.assert_array_equal(g, w, err_msg=f'{key} {name}')


def _logical(name, rows, world):
  """A table's (or a stack's) logical rows: without the rows a world pads
  it, and each member of a stack, with."""
  ctx = hbt.Context('cpu', rank=0, world_size=world)
  (stack,) = hbt.build_stacks([hbt.TableConfig(*t) for t in TABLES], ctx)
  if name != stack.stacked.name:
    return rows[:dict((t[0], t[1]) for t in TABLES)[name]]
  return np.concatenate([rows[off:off + cfg.vocab_size] for cfg, off in
                         zip(stack.configs, stack.offsets)])


def _restored_at_one(case, spec, steps):
  """A world-of-one trainer made on a copy of ``steps``: its state."""
  import torch_trainer_worker as worker
  ctx = hbt.Context(torch.device('cpu'))
  model_dir = os.path.join(os.path.dirname(steps), f'one_{case}')
  shutil.copytree(steps, model_dir)
  if case == 'dense':
    _, snap = worker._dense_trainer(ctx, dict(spec, model='dense'),
                                    model_dir)
    return snap()
  fx, tr = worker._sparse_trainer(ctx, spec, model_dir)
  return worker._sparse_snapshot(fx, tr)()


@pytest.mark.timeout(2 * LAUNCH_S + 300)
@pytest.mark.parametrize('case', ['adagrad', 'dense'])
def test_bundle_of_a_world_serves_jax_predictions(worlds, case):
  """The bundle a world of two exports (rank 0 alone writes it), loaded
  cold by ``Served``, predicts every eval row as the JAX trainer does."""
  two = worlds[2]
  path = two['specs'][case]['bundle']
  assert os.path.exists(os.path.join(path, 'serving_fn.pt2'))
  _, _, _, rows = two['data'][case]
  got = hbt.Served(path, 'cpu').predict(rows)
  np.testing.assert_allclose(got.reshape(-1), two['jax'][case][3],
                             **PRED_TOL)


@pytest.mark.timeout(2 * LAUNCH_S + 300)
def test_uneven_train_batches_raise_on_every_rank(worlds):
  for rank, r in enumerate(worlds[2]['ranks']):
    got = r['uneven']
    assert got['step'] == 0
    assert got['error'] and '32' not in got['error']
    assert '16 rows on rank 0' in got['error'], got['error']
    assert '15 rows on rank 1' in got['error'], got['error']


# -- the sync iterator, two ranks as threads over one store ----------------------

def _pair():
  """Two ranks' contexts over one new store, their iterator ids counted
  from 0 (as in two fresh processes)."""
  psync._SYNC_IDS.clear()
  store = torch.distributed.HashStore()
  return [hbt.Context('cpu', rank=r, world_size=2, store=store)
          for r in range(2)]


def _run_ranks(fns):
  """Each ``fn()`` on its own thread; their results (or what they
  raised)."""
  out = [None, None]

  def run(i):
    try:
      out[i] = fns[i]()
    except BaseException as e:  # noqa: BLE001 — the result
      out[i] = e
  threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(30)
  return out


def _rows_batches(rows, seed):
  rng = np.random.RandomState(seed)
  return [{'x': rng.rand(n, 3).astype(np.float32),
           'ids_mask': rng.rand(n, 2) < 0.5,
           'r': hbt.Value(np.arange(2 * n, dtype=np.int32),
                          [np.arange(0, 2 * n + 1, 2)])} for n in rows]


def test_sync_eval_pads_as_jax_and_stops_together():
  """Eval mode: every rank gets one batch a step until all have run out,
  padded to the step's largest rows, an exhausted rank's batch all
  padding from its last batch's schema, each as JAX pads it."""
  ctxs = _pair()
  data = [_rows_batches([5, 4, 3], 0), _rows_batches([5, 6], 1)]
  got = _run_ranks([
      lambda c=c, d=d: list(psync.SyncReplicasIterator(
          iter(d), drop_remainder=False, ctx=c)) for c, d in zip(ctxs, data)])
  assert [len(g) for g in got] == [3, 3]
  want_rows = [5, 6, 3]
  jsync = JSyncReplicasIterator(iter([]), drop_remainder=False)
  for r in range(2):
    for k, batch in enumerate(got[r]):
      n = want_rows[k]
      assert batch[psync.SYNC_VALID_KEY].shape == (n,)
      if k < len(data[r]):
        want = jsync._padded(_jax_value(data[r][k]), n)
      else:
        want = jsync._empty_like(_jax_value(data[r][-1]), n)
      assert set(batch) == set(want)
      for key in want:
        a, b = batch[key], want[key]
        if isinstance(a, hbt.Value):
          np.testing.assert_array_equal(a.values, b.values)
          for sa, sb in zip(a.row_splits, b.row_splits):
            np.testing.assert_array_equal(sa, sb)
        else:
          np.testing.assert_array_equal(a, b)
          assert np.asarray(a).dtype == np.asarray(b).dtype, key
  np.testing.assert_array_equal(psync._pad_column(data[0][0]['x'], 7),
                                jpad(data[0][0]['x'], 7))


def _jax_value(batch):
  from hybridbackend_tpu.data.dataframe import Value as JValue
  return {k: (JValue(v.values, v.row_splits) if isinstance(v, hbt.Value)
              else v) for k, v in batch.items()}


def test_sync_train_stops_when_any_rank_runs_out():
  ctxs = _pair()
  data = [_rows_batches([4, 4, 4], 0), _rows_batches([4, 4], 1)]
  got = _run_ranks([lambda c=c, d=d: list(psync.SyncReplicasIterator(
      iter(d), ctx=c)) for c, d in zip(ctxs, data)])
  assert [len(g) for g in got] == [2, 2]
  assert got[0][1] is data[0][1]


def test_sync_a_dead_peer_raises_within_its_deadline_naming_it():
  ctx, _ = _pair()
  it = psync.SyncReplicasIterator(iter(_rows_batches([4], 0)), ctx=ctx,
                                  timeout_ms=500)
  t0 = time.monotonic()
  with pytest.raises(RuntimeError, match='rank 1 did not reach sync step 0'):
    next(it)
  assert 0.5 <= time.monotonic() - t0 < 5.0


def test_sync_close_cancels_a_pending_wait():
  ctx, _ = _pair()
  it = psync.SyncReplicasIterator(iter(_rows_batches([4], 0)), ctx=ctx,
                                  timeout_ms=60_000)
  got = []
  t = threading.Thread(target=lambda: got.append(next(it, 'stopped')))
  t.start()
  time.sleep(0.2)
  t0 = time.monotonic()
  it.close()
  t.join(5)
  assert got == ['stopped'] and time.monotonic() - t0 < 1.0
  assert not ctx.store.check(['hb_sync/' + '/'.join(
      map(str, (it._sid, 0, 0)))])


def test_sync_keys_are_deleted_when_iteration_ends():
  ctxs = _pair()
  its = [psync.SyncReplicasIterator(iter(_rows_batches([3] * 5, r)),
                                    drop_remainder=False, ctx=c)
         for r, c in enumerate(ctxs)]
  got = _run_ranks([lambda i=i: list(i) for i in its])
  assert [len(g) for g in got] == [5, 5]
  store = ctxs[0].store
  assert its[0]._sid == its[1]._sid   # one counter per rank
  for it in its[:1]:
    keys = [f'hb_sync/{it._sid}/{s}/{r}' for s in range(7) for r in (0, 1)]
    keys += [f'hb_sync/{it._sid}/end/{k}' for k in ('done', 'left')]
    assert not any(store.check([k]) for k in keys)


def test_sync_refuses_a_0d_column_in_a_world():
  """ADVICE r5 of the JAX package: a 0-d column has no batch axis; in a
  world the sync, ``put_batch`` and ``DeviceIterator`` refuse it by
  name."""
  ctx, _ = _pair()
  batch = {'x': np.zeros((4, 3), np.float32), 'epoch': np.float32(3)}
  with pytest.raises(ValueError, match="'epoch' is 0-d"):
    next(psync.SyncReplicasIterator(iter([batch]), ctx=ctx))
  with pytest.raises(ValueError, match="'epoch' is 0-d"):
    hbt.data.put_batch(batch, torch.device('cpu'), world_size=2)
  it = hbt.data.DeviceIterator(iter([batch]), torch.device('cpu'),
                               world_size=2)
  with pytest.raises(ValueError, match="'epoch' is 0-d"):
    next(it)
  it.close()
  # A world of one takes it, as before.
  assert hbt.data.put_batch(batch, torch.device('cpu'))['epoch'].numel() == 1


def test_sync_needs_a_store_in_a_world():
  with pytest.raises(ValueError, match='store of a joined context'):
    psync.SyncReplicasIterator(iter([]), ctx=hbt.Context(
        'cpu', rank=0, world_size=2))


def test_caches_in_a_world_keep_the_sync_liveness_rules():
  """Host-backed tables in a world (once refused as ROADMAP item 15b
  (10)) exchange each batch's ids as the sync iterator exchanges its
  counts: a peer that posts nothing raises within the deadline, naming
  it; ``cancel`` ends a pending wait (``SyncCancelled``) until ``open``;
  a cache made in another world than its runner's is refused."""
  from test_torch_distribute import _cache_ranks
  store = torch.distributed.HashStore()
  (cache, runner), _ = _cache_ranks(2, store)
  runner._timeout_s = 0.5
  ids = {'t': np.arange(8, dtype=np.int64)}
  t0 = time.monotonic()
  with pytest.raises(RuntimeError, match='rank 1 posted no ids for step 0'):
    runner.transform(ids)
  assert 0.5 <= time.monotonic() - t0 < 5.0
  runner._timeout_s = 60.0
  got = []
  t = threading.Thread(target=lambda: got.append(
      _raised(lambda: runner.transform(ids))))
  t.start()
  time.sleep(0.2)
  runner.cancel()
  t.join(5)
  assert got and isinstance(got[0], psync.SyncCancelled)
  assert not runner._plans and cache.resident == 0
  runner.open()
  assert not runner._cancel.is_set()
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(cache.slot_config(), column='t')],
      ctx=hbt.Context('cpu'))
  with pytest.raises(ValueError, match='give both the same context'):
    hbt.embedding.service.CacheRunner({'t': cache}, fx)


def _raised(fn):
  try:
    return fn()
  except BaseException as e:  # noqa: BLE001 — the result
    return e
