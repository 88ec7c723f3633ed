"""The port's module adapter against the JAX flax adapter, on the CPU.

The JAX ``wraps_flax_module`` runs in a one-device context (its tables
lane-packed, as ``test_torch_trainer.py`` drives the JAX trainers); the
port's ``wraps_module`` on ``torch.device('cpu')``, from the JAX
parameters carried across by ``convert.from_jax_module`` (the stacked
tables reshaped to ``[V, d]``, each flax ``Dense`` kernel transposed into
an ``nn.Linear``). For each input convention, with the towers of
``tests/test_flax_support.py``:

* ``'concat'``: ``Dense(32)``, ReLU, ``Dense(1)``, sigmoid over one
  ``[B, 9]`` tensor (a ``[200, 8]`` table and a dense feature); the
  layers matched in order;
* ``'features'``: two tables and a dense feature routed by name into
  ``Dense(16)`` and ``Dense(1)``; the layers matched in order;
* ``'raw'``: DIN-style attention over the uncombined ``[B, 8, 8]``
  history and its mask; the layers matched by an explicit name map;

the same seeded numpy batches give the predictions and the loss (f32,
``rtol = 1e-5``), then 3 ``fit`` steps under Adagrad 0.1 on both sides
give the same tables, tower and accumulators at the sparse-step tests'
``STATE_TOL`` (``rtol = 1e-5, atol = 2e-6``: the same f32 math, sums in
other orders) and the same losses (``rtol = 1e-5``). Then, on the port:
``save_weights`` and ``load_weights`` into a fresh adapter give every
parameter, slot and the step back bit for bit; the exported bundle,
served on the CPU, predicts the wrapped model's ``predict`` to 1e-6,
every column through kernel 5's op (its plain version here); the
summaries land in ``model_dir``.

At a world of 2 gloo ranks (``tests/torch_module_worker.py`` under the
launcher; one table row-sharded under the ``alltoall`` exchange, one
replicated) the adapter trains,
evaluates and predicts as the world of one on the global batches
(losses ``rtol = 1e-5``, gathered state ``STATE_TOL``, predictions
``rtol = 1e-5, atol = 1e-6``); rank 0 alone writes the summaries; the
weights saved at 2 load at 1 bit for bit; the world's bundle serves the
world of one's predictions.

The Criteo entry point, ``examples/criteo/train_module.py --device cpu
--synthesize``, runs at a tiny shape in a subprocess.
"""

import glob
import os
import pickle
import re
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hybridbackend_tpu.embedding import TableConfig as JTableConfig
from hybridbackend_tpu.flax_support import wraps_flax_module
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.models import EmbeddingSpec as JEmbeddingSpec

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.utils.summary import read_event_scalars

import torch_module_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
STATE_TOL = dict(rtol=1e-5, atol=2e-6)
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 3
LAUNCH_S = 150


@pytest.fixture(autouse=True)
def one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


# -- the towers of tests/test_flax_support.py, in both packages ---------------

class FlaxTower(fnn.Module):

  @fnn.compact
  def __call__(self, x):
    x = fnn.relu(fnn.Dense(32)(x))
    return fnn.sigmoid(fnn.Dense(1)(x))[..., 0]


class FlaxMultiInput(fnn.Module):

  @fnn.compact
  def __call__(self, emb, dense):
    x = jnp.concatenate([emb['cat0'], emb['cat1'] * 2.0, dense['dense0']],
                        axis=-1)
    x = fnn.relu(fnn.Dense(16)(x))
    return fnn.sigmoid(fnn.Dense(1)(x))[..., 0]


class FlaxDIN(fnn.Module):

  @fnn.compact
  def __call__(self, members, batch):
    hist, target = members['seq'], members['cat']
    mask = batch['seq_mask'].astype(jnp.float32)
    att_in = jnp.concatenate(
        [hist, jnp.broadcast_to(target[:, None, :], hist.shape),
         hist * target[:, None, :]], axis=-1)
    scores = fnn.Dense(1)(fnn.relu(fnn.Dense(8)(att_in)))[..., 0]
    scores = jnp.where(mask > 0, scores, -1e9)
    att = jax.nn.softmax(scores, axis=-1) * mask
    pooled = jnp.einsum('bl,bld->bd', att, hist)
    x = jnp.concatenate([pooled, target, batch['d0'][:, None]], axis=-1)
    x = fnn.relu(fnn.Dense(16)(x))
    return fnn.sigmoid(fnn.Dense(1)(x))[..., 0]


def tower():
  return nn.Sequential(nn.Linear(9, 32), nn.ReLU(), nn.Linear(32, 1),
                       nn.Sigmoid(), nn.Flatten(0))


class MultiInput(nn.Module):

  def __init__(self):
    super().__init__()
    self.hidden, self.out = nn.Linear(17, 16), nn.Linear(16, 1)

  def forward(self, emb, dense):
    x = torch.cat([emb['cat0'], emb['cat1'] * 2.0, dense['dense0']], -1)
    return torch.sigmoid(self.out(torch.relu(self.hidden(x))))[..., 0]


class DIN(nn.Module):

  def __init__(self):
    super().__init__()
    self.att, self.score = nn.Linear(24, 8), nn.Linear(8, 1)
    self.hidden, self.out = nn.Linear(17, 16), nn.Linear(16, 1)

  def forward(self, members, batch):
    hist, target = members['seq'], members['cat']
    mask = batch['seq_mask'].to(torch.float32)
    att_in = torch.cat([hist, target[:, None, :].expand_as(hist),
                        hist * target[:, None, :]], -1)
    scores = self.score(torch.relu(self.att(att_in)))[..., 0]
    scores = torch.where(mask > 0, scores, -1e9)
    att = torch.softmax(scores, -1) * mask
    pooled = torch.einsum('bl,bld->bd', att, hist)
    x = torch.cat([pooled, target, batch['d0'][:, None]], -1)
    return torch.sigmoid(self.out(torch.relu(self.hidden(x))))[..., 0]


# flax names its Dense layers in the order they are made: in DIN the
# score's Dense(1) before the Dense(8) inside it.
DIN_LAYERS = {'Dense_1': 'att', 'Dense_0': 'score', 'Dense_2': 'hidden',
              'Dense_3': 'out'}


def _concat_batch(rng, n=64):
  cat0 = rng.randint(0, 200, n).astype(np.int32)
  return {'cat0': cat0, 'dense0': rng.rand(n).astype(np.float32),
          'label': (cat0 % 4 == 0).astype(np.float32)}


def _features_batch(rng, n=64):
  c0, c1 = rng.randint(0, 200, n), rng.randint(0, 100, n)
  return {'cat0': c0.astype(np.int32), 'cat1': c1.astype(np.int32),
          'dense0': rng.rand(n).astype(np.float32),
          'label': ((c0 + c1) % 4 == 0).astype(np.float32)}


def _raw_batch(rng, n=64, length=8):
  seq = rng.randint(0, 120, (n, length)).astype(np.int32)
  cat = rng.randint(0, 60, n).astype(np.int32)
  return {'seq': seq, 'seq_mask': rng.rand(n, length) < 0.8, 'cat': cat,
          'd0': rng.rand(n).astype(np.float32),
          'label': ((cat % 3 == 0) & (seq[:, 0] % 2 == 0)).astype(
              np.float32)}


def _specs(pkg, conv):
  Spec, Config = ((JEmbeddingSpec, JTableConfig) if pkg == 'jax'
                  else (hbt.EmbeddingSpec, hbt.TableConfig))
  if conv == 'concat':
    return [Spec(Config('cat0', 200, 8))], ['dense0']
  if conv == 'features':
    return [Spec(Config('cat0', 200, 8)),
            Spec(Config('cat1', 100, 8))], ['dense0']
  return [Spec(Config('seq', 120, 8, combiner='sum'), column='seq'),
          Spec(Config('cat', 60, 8))], []


CONVENTIONS = {
    'concat': (FlaxTower, tower, _concat_batch, None),
    'features': (FlaxMultiInput, MultiInput, _features_batch, None),
    'raw': (FlaxDIN, DIN, _raw_batch, DIN_LAYERS),
}


def _jctx():
  return JContext(build_mesh(devices=jax.devices()[:1]))


def _tensors(b):
  return {k: torch.from_numpy(v) for k, v in b.items()}


def _np(tree):
  return jax.tree.map(np.asarray, tree)


def _port(conv, jax_params=None, seed=0, model_dir=None):
  """The port's adapter of ``conv``, its parameters carried from
  ``jax_params`` (made from ``seed`` when None), compiled."""
  _, make, batch, layers = CONVENTIONS[conv]
  specs, dense = _specs('port', conv)
  wrapped = hbt.wraps_module(make(), specs, dense_columns=dense,
                             inputs=conv, ctx=hbt.Context(CPU))
  params = wrapped.init(torch.Generator().manual_seed(seed),
                        batch(np.random.RandomState(99)))
  if jax_params is not None:
    hbt.from_jax_module(params, wrapped.extractor, jax_params,
                        layers=layers)
  wrapped.compile(params, model_dir=model_dir, summary_steps=1)
  return wrapped


def _jax_run(conv, batches):
  flax, _, _, _ = CONVENTIONS[conv]
  specs, dense = _specs('jax', conv)
  with context_scope(_jctx()):
    wrapped = wraps_flax_module(flax(), specs, dense_columns=dense,
                                inputs=conv)
    params = wrapped.init(jax.random.PRNGKey(0), batches[0])
    init = _np(params)
    preds = np.asarray(wrapped.apply(params, batches[0]))
    loss, _ = wrapped.loss_fn(params, batches[0])
    wrapped.compile(params, optax.adagrad(0.1))
    losses = [wrapped.fit(iter([b]), sync=False)['loss']
              for b in batches[1:]]
    state = _np(wrapped.trainer.state)
  return init, preds, float(loss), losses, state


def _assert_state(wrapped, jstate, layers):
  tr = wrapped.trainer
  params, opt = tr.state.params, tr.state.optimizer
  sos = jstate.opt_state[0].sum_of_squares
  for name, t in params['tables'].items():
    rows, d = t.shape
    np.testing.assert_allclose(
        t.detach().numpy(),
        jstate.params['tables'][name].reshape(-1, d)[:rows], **STATE_TOL)
    np.testing.assert_allclose(
        opt.state[t]['sum_of_squares'].numpy(),
        sos['tables'][name].reshape(-1, d)[:rows], **STATE_TOL)
  pairs = hbt.convert._flax_dense(jstate.params['net'], layers,
                                  params['net'])
  acc = hbt.convert._flax_dense(sos['net'], layers, params['net'])
  for (linear, p), (_, a) in zip(pairs, acc):
    for target, want, slot in ((linear.weight, p['kernel'].T, a['kernel'].T),
                               (linear.bias, p['bias'], a['bias'])):
      np.testing.assert_allclose(target.detach().numpy(), want, **STATE_TOL)
      np.testing.assert_allclose(opt.state[target]['sum_of_squares'].numpy(),
                                 slot, **STATE_TOL)
  assert tr.global_step == int(jstate.step) == STEPS


@pytest.mark.parametrize('conv', sorted(CONVENTIONS))
def test_adapter_matches_jax(conv, tmp_path):
  batch = CONVENTIONS[conv][2]
  rng = np.random.RandomState(1)
  batches = [batch(rng) for _ in range(STEPS + 1)]
  init, jpreds, jloss, jlosses, jstate = _jax_run(conv, batches)
  wrapped = _port(conv, init, model_dir=str(tmp_path / 'm'))
  first = _tensors(batches[0])
  with torch.no_grad():
    preds = wrapped.apply(wrapped.params, first)
    loss, _ = wrapped.loss_fn(wrapped.params, first)
  np.testing.assert_allclose(preds.numpy(), jpreds, rtol=1e-5, atol=1e-7)
  np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
  losses = [wrapped.fit(iter([b]), sync=False)['loss'] for b in batches[1:]]
  np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
  _assert_state(wrapped, jstate, CONVENTIONS[conv][3])
  # One summary a step (summary_steps=1).
  (events,) = glob.glob(str(tmp_path / 'm' / 'events.out.tfevents.*'))
  assert [s for s, t, _ in read_event_scalars(events)
          if t == 'train/loss'] == [1, 2, 3]


def _flat(wrapped):
  tr = wrapped.trainer
  out = {k: v.detach().clone() for k, v in tr.state.params.state_dict(
  ).items()}
  for name, p in tr.state.params.named_parameters():
    out['acc.' + name] = tr.state.optimizer.state[p][
        'sum_of_squares'].clone()
  return out


@pytest.mark.parametrize('conv', sorted(CONVENTIONS))
def test_save_load_and_the_served_bundle(conv, tmp_path):
  batch = CONVENTIONS[conv][2]
  rng = np.random.RandomState(2)
  wrapped = _port(conv)
  wrapped.fit(iter([batch(rng) for _ in range(STEPS)]), sync=False)
  wrapped.save_weights(str(tmp_path / 'w'))
  fresh = _port(conv, seed=5)
  assert not all(torch.equal(a, b) for a, b in zip(
      _flat(fresh).values(), _flat(wrapped).values()))
  fresh.load_weights(str(tmp_path / 'w'))
  want, got = _flat(wrapped), _flat(fresh)
  assert sorted(got) == sorted(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k
  assert fresh.trainer.global_step == wrapped.trainer.global_step == STEPS
  with pytest.raises(FileNotFoundError):
    fresh.load_weights(str(tmp_path / 'nothing'))

  example = batch(rng)
  wrapped.export_saved_model(str(tmp_path / 'b'), example)
  calls = []
  real = hbt.ops.gather.gather_rows_reference

  def spy(*args):
    calls.append(1)
    return real(*args)

  served = hbt.Served(str(tmp_path / 'b'), CPU)
  try:
    hbt.ops.gather.gather_rows_reference = spy
    got = served.predict(example)
  finally:
    hbt.ops.gather.gather_rows_reference = real
  live = next(wrapped.predict(iter([example]))).numpy()
  assert np.abs(got - live).max() <= 1e-6
  # Every column through kernel 5's op, once a predict.
  assert len(calls) == len(wrapped.extractor.specs)


def test_wraps_routes_a_module():
  specs, dense = _specs('port', 'concat')
  made = hbt.wraps(tower())(specs, dense_columns=dense,
                            ctx=hbt.Context(CPU))
  assert isinstance(made, hbt.WrappedModel)
  assert hbt.wraps(3) == 3
  with pytest.raises(ValueError, match='inputs'):
    hbt.wraps_module(tower(), specs, inputs='nope', ctx=hbt.Context(CPU))


# -- a world of two ranks ------------------------------------------------------

def _world_batches():
  rng = np.random.RandomState(7)

  def one(n):
    c0 = rng.randint(-1, 260, n).astype(np.int32)
    return {'c0': c0, 'c1': rng.randint(0, 64, n).astype(np.int32),
            'd0': rng.rand(n).astype(np.float32),
            'label': (c0 % 3 == 0).astype(np.float32)}
  return [one(32) for _ in range(4)], [one(32), one(16)]


@pytest.fixture(scope='module')
def world(tmp_path_factory):
  """The world of two's results (each rank's), and its directories."""
  tmp = tmp_path_factory.mktemp('module_world')
  train, evals = _world_batches()
  spec = {'train': train, 'evals': evals, 'model_dir': str(tmp / 'm'),
          'weights': str(tmp / 'w'), 'bundle': str(tmp / 'b')}
  with open(tmp / 'spec.pkl', 'wb') as f:
    pickle.dump(spec, f)
  out = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
       '2', '--device', 'cpu', '--timeout', str(LAUNCH_S - 10),
       '--collective-timeout', '60',
       os.path.join(ROOT, 'tests', 'torch_module_worker.py'),
       str(tmp / 'spec.pkl'), str(tmp)], cwd=ROOT,
      env=dict(os.environ, OMP_NUM_THREADS='1'), capture_output=True,
      text=True, timeout=LAUNCH_S)
  assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
  ranks = []
  for r in range(2):
    with open(tmp / f'{r}.pkl', 'rb') as f:
      ranks.append(pickle.load(f))
  return ranks, spec


def test_world_of_two_trains_as_the_world_of_one(world, tmp_path):
  ranks, spec = world
  one = hbt.wraps_module(worker.tower(), worker.specs(),
                         dense_columns=worker.DENSE, ctx=hbt.Context(CPU))
  params = one.init(torch.Generator().manual_seed(0), spec['train'][0])
  one.compile(params, model_dir=str(tmp_path / 'm'), summary_steps=2)
  losses = [one.fit(iter([b]))['loss'] for b in spec['train']]
  want = worker.state(one)
  for r, res in enumerate(ranks):
    np.testing.assert_allclose(res['losses'], losses, rtol=1e-5)
    assert sorted(res['state']) == sorted(want)
    for k, v in want.items():
      np.testing.assert_allclose(res['state'][k], v, err_msg=f'{r} {k}',
                                 **STATE_TOL)
  ev = one.evaluate(iter(spec['evals']))
  for res in ranks:
    np.testing.assert_allclose(res['eval']['loss'], ev['loss'], rtol=1e-5)
    assert abs(res['eval']['auc'] - ev['auc']) <= 1e-6
  preds = [p.numpy() for p in one.predict(iter(spec['evals']))]
  for i, p in enumerate(preds):
    n = len(p) // 2
    np.testing.assert_allclose(ranks[0]['preds'][i], p[:n], **PRED_TOL)
    np.testing.assert_allclose(ranks[1]['preds'][i], p[n:], **PRED_TOL)
  # Rank 0 alone writes the summaries: one file, the world of one's tags.
  (events,) = glob.glob(os.path.join(spec['model_dir'],
                                     'events.out.tfevents.*'))
  got = read_event_scalars(events)
  assert [s for s, t, _ in got if t == 'train/loss'] == [2, 4]
  assert {'eval/auc', 'eval/loss'} <= {t for _, t, _ in got}

  # The weights saved by the world load at a world of one, bit for bit.
  fresh = hbt.wraps_module(worker.tower(), worker.specs(),
                           dense_columns=worker.DENSE, ctx=hbt.Context(CPU))
  fresh.compile(fresh.init(torch.Generator().manual_seed(3),
                           spec['train'][0]))
  fresh.load_weights(spec['weights'])
  saved = ranks[0]['state']
  for k, v in worker.state(fresh).items():
    np.testing.assert_array_equal(v, saved[k], err_msg=k)
  # The world's bundle, exported by every rank on its rows and written by
  # rank 0, serves the world of one's predictions of rank 0's rows.
  served = hbt.Served(spec['bundle'], CPU)
  n = len(preds[0]) // 2
  np.testing.assert_allclose(
      served.predict({k: v[:n] for k, v in spec['evals'][0].items()}),
      preds[0][:n], **PRED_TOL)


# -- the entry point -----------------------------------------------------------

def test_criteo_entry_point_on_the_cpu(tmp_path):
  data, model_dir = tmp_path / 'c.parquet', tmp_path / 'm'
  out = subprocess.run(
      [sys.executable, '-m',
       'hybridbackend_tpu_torch.examples.criteo.train_module',
       '--device', 'cpu', '--synthesize', '--data', str(data), '--rows',
       '512', '--vocab-cap', '1000', '--batch-size', '64', '--dim', '4',
       '--steps', '4', '--model-dir', str(model_dir)],
      cwd=ROOT, capture_output=True, text=True, timeout=300,
      env=dict(os.environ, OMP_NUM_THREADS='1'))
  assert out.returncode == 0, out.stderr[-3000:]
  m = re.search(r"train: \{'loss': (\S+)\}", out.stdout)
  assert m and np.isfinite(float(m[1].rstrip('}'))), out.stdout
  m = re.search(r"eval: \{'auc': (\S+), 'loss': (\S+), 'batches': (\S+)\}",
                out.stdout)
  assert m and 0 <= float(m[1].rstrip(',')) <= 1, out.stdout
  assert float(m[3]) == 8.0           # 512 rows: 8 batches of the 20
  names = sorted(os.listdir(model_dir))
  assert names[0] == 'checkpoint-4.pt' and len(names) == 2, names
  assert names[1].startswith('events.out.tfevents.')
