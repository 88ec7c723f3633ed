"""``SparseTrainer`` in raw mode (DIN) of the port against the JAX one.

The DIN config of ``test_torch_din_step.py`` (item [300, 8] and user
[100, 8] stacked into one, DIN with DNN 16-8 and attention 8-4, one
profile embedding, 2 dense features, batch 32, history 6 or 2 sessions
of 3 with ``-1`` holes), as JAX ``tests/test_trainer.py:324`` and
``tests/test_export.py:24`` drive it: ``SparseTrainer(fx, None, tower,
raw_model_loss=...)`` trains 6 batches, evaluates 3 (the last one short)
with GAUC over ``user``, and predicts, in each package (the port from the
JAX initial state, ``convert.from_jax``); a port trainer resumes from a
checkpoint bit for bit; and both packages export bundles with
``poly_batch=True`` that are served on the CPU, the port's also by a
cold process that imports no JAX. The mask is bool, float32 (as JAX
``test_export.py`` feeds it) or ``[B, S, L]`` (sessions).

Tolerances are ``test_torch_trainer.py``'s: tables, slots and tower to
``rtol = 1e-5, atol = 2e-6``; predictions and served predictions to
``rtol = 1e-5, atol = 1e-6``; losses and GAUC to ``rtol = 1e-5``; AUC by
``metrics.auc_limit``. The port's f32 bundle gives its trainer's
predictions bit for bit (kernel 5's op on the member tables gathers the
rows the stacked lookup does); int8 within 2e-2 of f32 and not all within
1e-7 (JAX ``tests/test_quant.py:124-126``).
"""

import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.estimator import SparseTrainer as JSparseTrainer
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import (
    din_apply, din_init, din_session_apply)
from hybridbackend_tpu.training.saved_model import Served as JServed

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch import metrics as hbm
from test_torch_din_step import (
    ATT, DIM, DNN, ITEMS, USERS, _preds, batches, port_fx, port_raw_loss)
from test_torch_trainer import _assert_states_equal

TOL = dict(rtol=1e-5, atol=2e-6)
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device('cpu')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6


def _data(sessions, float_mask=False):
  train = batches(sessions, seed=0, steps=STEPS)
  evals = (batches(sessions, seed=1, steps=2)
           + batches(sessions, seed=2, steps=1, rows=19))
  if float_mask:
    for b in train + evals:
      b['hist_mask'] = b['hist_mask'].astype(np.float32)
  return train, evals


def _jax_trainer(sessions, ctx):
  fx = JStackedFeatureExtractor(
      [JEmbeddingSpec(JTableConfig('item', ITEMS, DIM), column='cand_hist'),
       JEmbeddingSpec(JTableConfig('user', USERS, DIM))], ctx=ctx)
  net = din_init(jax.random.PRNGKey(1), DIM, num_profile_features=1,
                 num_dense=2, dnn_hidden_units=DNN, att_hidden_size=ATT)

  def raw_loss(p, members, batch):
    preds = jnp.clip(_preds(
        lambda *a: din_apply(p, *a[:5], att_weight_normalization=a[5]),
        lambda *a: din_session_apply(p, *a[:5],
                                     att_weight_normalization=a[5]),
        members, batch, sessions, False), 1e-6, 1 - 1e-6)
    y = batch['label']
    pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
    return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}

  return JSparseTrainer(fx, None, net, raw_model_loss=raw_loss,
                        dense_optimizer=optax.adam(1e-3), table_lr=0.05,
                        adagrad_init=0.1, ctx=ctx, group_key='user',
                        rng=jax.random.PRNGKey(0))


def _port_trainer(sessions, init=None, model_dir=None):
  """The port's raw-mode trainer: from a JAX state given as numpy, or from
  seed 0."""
  case = 'sessions' if sessions else 'adagrad'
  fx = port_fx()
  gen = torch.Generator().manual_seed(0)
  tower = (hbt.DINSession if sessions else hbt.DIN)(DIM, 1, 2, DNN, ATT,
                                                    generator=gen)
  tables = None
  if init is not None:
    state = hbt.from_jax(fx, init.tables,
                         {k: v.acc for k, v in init.table_opt.items()},
                         tower, init.dense,
                         functools.partial(torch.optim.Adam, lr=1e-3))
    tables = state.tables
  return hbt.SparseTrainer(fx, None, tower, tables=tables,
                           raw_model_loss=port_raw_loss(case),
                           model_dir=model_dir, group_key='user',
                           generator=gen)


@pytest.fixture(autouse=True)
def one_thread():
  """One CPU thread, as in ``test_torch_sparse_step.py``."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.mark.parametrize('sessions', [False, True])
def test_raw_mode_trainer_matches_jax(sessions):
  train, evals = _data(sessions)
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  with context_scope(ctx):
    jtr = _jax_trainer(sessions, ctx)
    init = jax.tree.map(np.asarray, jtr.state)
    jm = jtr.train(iter(train))
    want = jax.tree.map(np.asarray, jtr.state)
    jres = jtr.evaluate(iter(evals))
    jpreds = np.concatenate([np.asarray(p)
                             for p in jtr.predict(iter(evals))])
  tr = _port_trainer(sessions, init)
  m = tr.train(iter(train), prefetch=True)
  assert tr.global_step == STEPS
  np.testing.assert_allclose(m['loss'], jm['loss'], rtol=1e-5)
  (name,) = tr.state.tables
  np.testing.assert_allclose(tr.state.tables[name].numpy(),
                             want.tables[name].reshape(-1, DIM), **TOL)
  np.testing.assert_allclose(tr.state.table_opt[name].acc[0].numpy(),
                             want.table_opt[name].acc[0].reshape(-1, DIM),
                             **TOL)
  for p, w in hbt.convert._pairs(tr.state.dense, want.dense):
    np.testing.assert_allclose(p.detach().numpy(), w.numpy(), **TOL)
  res = tr.evaluate(iter(evals), prefetch=True)
  preds = torch.cat(list(tr.predict(iter(evals)))).numpy()
  np.testing.assert_allclose(preds, jpreds, **PRED_TOL)
  labels = np.concatenate([b['label'] for b in evals])
  limit, _, _ = hbm.auc_limit(preds, jpreds, labels)
  assert set(res) == set(jres) == {'auc', 'loss', 'batches', 'gauc'}
  assert res['batches'] == jres['batches'] == 3
  assert abs(res['auc'] - jres['auc']) <= limit
  np.testing.assert_allclose(res['loss'], jres['loss'], rtol=1e-5)
  np.testing.assert_allclose(res['gauc'], jres['gauc'], rtol=1e-5)


def test_raw_mode_resume_is_bitwise(tmp_path):
  train, _ = _data(True)
  live = _port_trainer(True, model_dir=str(tmp_path / 'a'))
  live.train(iter(train), save_checkpoint_steps=3)
  assert live._ckpt.all_steps() == [3, 6]
  restored = _port_trainer(True, model_dir=str(tmp_path / 'a'))
  _assert_states_equal(restored, live)
  os.makedirs(tmp_path / 'b')
  shutil.copy(tmp_path / 'a' / 'checkpoint-3.pt', tmp_path / 'b')
  resumed = _port_trainer(True, model_dir=str(tmp_path / 'b'))
  assert resumed.global_step == 3
  resumed.train(iter(train[3:]))
  _assert_states_equal(resumed, live)


# mask kind -> (sessions, float mask)
MASKS = {'bool': (False, False), 'float': (False, True),
         'sessions': (True, False)}


@pytest.fixture(scope='module')
def bundles(tmp_path_factory):
  """For each mask kind: JAX's f32 bundle and the port's f32 and int8
  bundles of one state (3 JAX steps carried across), and the port's
  trainer."""
  out = {}
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    for kind, (sessions, float_mask) in MASKS.items():
      tmp = tmp_path_factory.mktemp(f'din_{kind}')
      train, evals = _data(sessions, float_mask)
      ctx = JContext(build_mesh(devices=jax.devices()[:1]))
      with context_scope(ctx):
        jtr = _jax_trainer(sessions, ctx)
        jtr.train(iter(train[:3]))
        jpath = jtr.export_saved_model(str(tmp / 'jax'), evals[0],
                                       poly_batch=True)
        state = jax.tree.map(np.asarray, jtr.state)
      tr = _port_trainer(sessions)
      tr.state = hbt.from_jax(
          tr._fx, state.tables, {k: v.acc for k, v in state.table_opt.items()},
          tr.state.dense, state.dense,
          functools.partial(torch.optim.Adam, lr=1e-3), step=int(state.step))
      paths = {'jax': jpath}
      for dtype in ('float32', 'int8'):
        paths[dtype] = tr.export_saved_model(
            str(tmp / dtype), evals[0], table_dtype=dtype, poly_batch=True)
      out[kind] = dict(paths=paths, trainer=tr, evals=evals)
  finally:
    torch.set_num_threads(threads)
  return out


@pytest.mark.parametrize('kind', list(MASKS))
def test_raw_mode_bundle_matches_jax_and_the_trainer(bundles, kind):
  b = bundles[kind]
  with open(os.path.join(b['paths']['float32'], 'signature.json')) as f:
    sig = json.load(f)
  with open(os.path.join(b['paths']['jax'], 'signature.json')) as f:
    assert sig == json.load(f)
  dims = [2, 3] if kind == 'sessions' else [6]
  assert sig['inputs']['hist_mask'] == {
      'shape': ['b', *dims],
      'dtype': 'float32' if kind == 'float' else 'bool'}
  assert sig['inputs']['cand_hist']['shape'][0] == 'b'
  served = hbt.Served(b['paths']['float32'], CPU)
  jserved = JServed(b['paths']['jax'])
  int8 = hbt.Served(b['paths']['int8'], CPU)
  for batch in b['evals']:
    got = served.predict(batch)
    assert got.shape == (batch['label'].shape[0],)
    np.testing.assert_allclose(got, np.asarray(jserved.predict(batch)),
                               **PRED_TOL)
    np.testing.assert_array_equal(
        got, next(b['trainer'].predict(iter([batch]))).numpy())
    q = int8.predict(batch)
    np.testing.assert_allclose(q, got, atol=2e-2)
    assert not np.allclose(q, got, atol=1e-7)
  one = {k: v[:1] for k, v in b['evals'][0].items()}
  assert served.predict(one).shape == (1,)


@pytest.mark.parametrize('dtype,gathers', [('float32', 2), ('int8', 4)])
def test_raw_mode_graph_gathers_each_member_through_kernel_5(
    bundles, dtype, gathers):
  program = torch.export.load(os.path.join(
      bundles['bool']['paths'][dtype], 'serving_fn.pt2'))
  nodes = list(program.graph.nodes)
  assert sum(n.target == torch.ops.hbtpu.gather_rows.default
             for n in nodes) == gathers
  assert not [n for n in nodes if 'device' in n.kwargs]


def test_raw_mode_bundle_serves_in_a_cold_process(bundles, tmp_path):
  b = bundles['sessions']
  batch = b['evals'][2]
  np.savez(tmp_path / 'batch.npz', **batch)
  code = textwrap.dedent(f"""
      import sys
      import numpy as np
      from hybridbackend_tpu_torch.training.saved_model import Served
      batch = dict(np.load({str(tmp_path / 'batch.npz')!r}))
      for dtype in ('float32', 'int8'):
        served = Served({os.path.dirname(b['paths']['float32'])!r}
                        + '/' + dtype, 'cpu')
        np.save({str(tmp_path)!r} + f'/{{dtype}}.npy', served.predict(batch))
      print(sorted(m for m in sys.modules
                   if m.split('.')[0] in ('jax', 'hybridbackend_tpu')))
  """)
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, check=True,
                       timeout=120)
  assert out.stdout.strip() == '[]', out.stdout
  for dtype in ('float32', 'int8'):
    np.testing.assert_array_equal(
        np.load(tmp_path / f'{dtype}.npy'),
        hbt.Served(b['paths'][dtype], CPU).predict(batch))


def test_a_cuda_context_names_its_device_index(monkeypatch):
  """``Context('cuda')`` is the current card, as a tensor moved with
  ``.to('cuda')`` reports its device: a ``Trainer`` over parameters on
  ``cuda:0`` takes it (the DIN bundle of the serving harness is one)."""
  monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
  assert hbt.Context('cuda').device == torch.device('cuda', 0)
  assert hbt.Context('cuda:1').device == torch.device('cuda', 1)
  assert hbt.Context('cpu').device == CPU
