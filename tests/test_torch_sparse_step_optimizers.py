"""The sparse train step with LazyAdam, no-dedup Adagrad and DLRM.

The step of ``test_torch_sparse_step.py`` (3 tables of [1000, 16]
stacked into one, 2 dense features, batch 64 with invalid ids, BCE loss,
Adam 1e-3 on the tower, table lr 0.05), 3 steps against the JAX step in
a one-device context, in these variants:
  * DCNv2 with LazyAdam tables, under ``emb_update_impl='auto'`` (the XLA
    path on the CPU) and ``'stream'`` (the Pallas kernel, interpret mode);
  * DCNv2 with no-dedup Adagrad, ``'auto'`` only (the stream kernel
    ignores ``dedup=False``);
  * DLRM (bottom 32-16, top 64-32-1) with Adagrad and with LazyAdam.
LazyAdam tables are made under ``emb_lane_pack='off'``, as
``SparseTrainer`` makes them: the JAX package refuses LazyAdam on
lane-packed tables.

Tolerances: the per-step loss to ``rtol = 1e-5``; tables, slots and tower
params to ``rtol = 1e-5, atol = 2e-6``, as in ``test_torch_sparse_step``.
Against the Pallas LazyAdam kernel ``v`` gets ``rtol = 3e-5``, because
that kernel rounds ``1 - b2`` in f32, 1.3e-5 relative away from the
double's rounding that the port and the XLA path use. LazyAdam tables get
``atol = 2e-5``: an update is ``lr·m̂/(sqrt(v̂)+eps)``, which for a
gradient near zero moves by up to ``lr·Δs/eps = 5e6·Δs`` when the
gradient moves by ``Δs``; the two packages' gradients differ by their f32
rounding, about 1e-12 for the DLRM's embedding gradients (sums of terms
near 1e-5), so up to 5e-6 (4.8e-6 seen), and 2e-5 leaves a fourfold
margin.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import (
    dlrm_apply, dlrm_init, stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState,
    make_sparse_train_step as jax_make_sparse_train_step)

import hybridbackend_tpu_torch as hbt

TABLES, VOCAB, DIM, DENSE, BATCH, STEPS = 3, 1000, 16, 2, 64, 3
MLP = [64, 32, 1]
BOTTOM = [32, 16]
STATE_TOL = dict(rtol=1e-5, atol=2e-6)


def _batches(seed=0):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(STEPS):
    b = {}
    for t in range(TABLES):
      ids = rng.randint(0, VOCAB, BATCH).astype(np.int32)
      ids[rng.choice(BATCH, 4, replace=False)] = -1
      ids[rng.choice(BATCH, 3, replace=False)] = VOCAB + 7
      b[f'c{t}'] = ids
    for d in range(DENSE):
      b[f'i{d}'] = rng.rand(BATCH).astype(np.float32)
    b['label'] = rng.randint(0, 2, BATCH).astype(np.float32)
    out.append(b)
  return out


def _bce(p, y, clip, log):
  p = clip(p, 1e-6, 1 - 1e-6)
  return -(y * log(p) + (1 - y) * log(1 - p)).mean()


def _jax_run(model, optimizer, dedup, impl, batches):
  """Initial state and per-step (loss, state) of the JAX step."""
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  adam = optimizer == 'adam'
  overrides = dict(emb_update_impl=impl)
  if adam:
    overrides['emb_lane_pack'] = 'off'
  with context_scope(ctx), OPTIONS.override(**overrides):
    specs = [JEmbeddingSpec(JTableConfig(f'c{t}', VOCAB, DIM))
             for t in range(TABLES)]
    fx = JStackedFeatureExtractor(
        specs, dense_columns=[f'i{d}' for d in range(DENSE)], ctx=ctx)
    if model == 'dcnv2':
      net = stacked_dcn_v2_init(jax.random.PRNGKey(1),
                                [DIM] * TABLES + [1] * DENSE, MLP)
      preds = lambda p, emb_f, dense_f: stacked_dcn_v2_apply(p, emb_f
                                                             + dense_f)
    else:
      net = dlrm_init(jax.random.PRNGKey(1), DENSE, TABLES, BOTTOM, DIM, MLP)
      preds = lambda p, emb_f, dense_f: dlrm_apply(p, dense_f, emb_f)

    def model_loss(dense, emb_f, dense_f, batch):
      return _bce(preds(dense, emb_f, dense_f), batch['label'], jnp.clip,
                  jnp.log), {}

    state = JSparseTrainState.create(net, fx.init(jax.random.PRNGKey(0)),
                                     optax.adam(1e-3), adagrad_init=0.1,
                                     ctx=ctx, adam=adam)
    init = jax.tree.map(np.asarray, state)
    step = jax_make_sparse_train_step(
        fx, model_loss, optax.adam(1e-3), table_lr=0.05, ctx=ctx,
        table_dedup=dedup, table_optimizer=optimizer, donate_state=False)
    trace = []
    for b in batches:
      state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(m['loss']), jax.tree.map(np.asarray, state)))
  return init, trace


def _port(model, optimizer, dedup, init):
  ctx = hbt.Context(torch.device('cpu'))
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{t}', VOCAB, DIM))
           for t in range(TABLES)]
  fx = hbt.StackedFeatureExtractor(
      specs, dense_columns=[f'i{d}' for d in range(DENSE)], ctx=ctx)
  if model == 'dcnv2':
    tower = hbt.StackedDCNv2([DIM] * TABLES + [1] * DENSE, MLP)
    preds = lambda t, emb_f, dense_f: t(emb_f + dense_f)
  else:
    tower = hbt.DLRM(DENSE, TABLES, BOTTOM, DIM, MLP)
    preds = lambda t, emb_f, dense_f: t(dense_f, emb_f)

  def model_loss(t, emb_f, dense_f, batch):
    return _bce(preds(t, emb_f, dense_f), batch['label'], torch.clamp,
                torch.log), {}

  state = hbt.from_jax(
      fx, init.tables, {k: v.acc for k, v in init.table_opt.items()},
      tower, init.dense, functools.partial(torch.optim.Adam, lr=1e-3))
  step = hbt.make_sparse_train_step(fx, model_loss, table_lr=0.05,
                                    table_dedup=dedup,
                                    table_optimizer=optimizer)
  return state, step


def _dense_layers(tower, params):
  if isinstance(tower, hbt.DLRM):
    return ([*tower.bottom_mlp.layers, tower.bottom_out,
             *tower.top_mlp.layers],
            [*params['bottom_mlp'], params['bottom_out'],
             *params['top_mlp']])
  return [tower.cross, *tower.mlp.layers], [params['cross'], *params['mlp']]


def _assert_state_close(state, want, v_rtol):
  for name, table in state.tables.items():
    slots = state.table_opt[name].acc
    table_tol = dict(STATE_TOL, atol=2e-5) if len(slots) == 2 else STATE_TOL
    np.testing.assert_allclose(table.numpy(),
                               want.tables[name].reshape(-1, DIM),
                               **table_tol)
    assert len(slots) == len(want.table_opt[name].acc)
    for i, (got, w) in enumerate(zip(slots, want.table_opt[name].acc)):
      tol = dict(STATE_TOL, rtol=v_rtol) if i == 1 else STATE_TOL
      np.testing.assert_allclose(got.numpy(), w.reshape(-1, DIM), **tol)
  for layer, p in zip(*_dense_layers(state.dense, want.dense)):
    np.testing.assert_allclose(layer.w.detach().numpy(), p['w'],
                               **STATE_TOL)
    np.testing.assert_allclose(layer.b.detach().numpy(), p['b'],
                               **STATE_TOL)


@pytest.mark.parametrize('model,optimizer,dedup,impl', [
    ('dcnv2', 'adam', True, 'auto'),
    ('dcnv2', 'adam', True, 'stream'),
    ('dcnv2', 'adagrad', False, 'auto'),
    ('dlrm', 'adagrad', True, 'auto'),
    ('dlrm', 'adam', True, 'auto'),
])
def test_sparse_step_variant_matches_jax(model, optimizer, dedup, impl):
  batches = _batches()
  init, trace = _jax_run(model, optimizer, dedup, impl, batches)
  state, step = _port(model, optimizer, dedup, init)
  (name,) = state.tables
  before = state.tables[name].clone()
  v_rtol = 3e-5 if (optimizer, impl) == ('adam', 'stream') else 1e-5
  for i, b in enumerate(batches):
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    want_loss, want_state = trace[i]
    assert state.step == i + 1
    np.testing.assert_allclose(float(metrics['loss']), want_loss, rtol=1e-5)
    _assert_state_close(state, want_state, v_rtol)
  # Rows no valid id of any batch touched are unchanged, bit for bit;
  # under LazyAdam their moments stay zero.
  touched = torch.zeros(before.shape[0], dtype=torch.bool)
  for b in batches:
    for t in range(TABLES):
      ids = b[f'c{t}']
      touched[ids[(ids >= 0) & (ids < VOCAB)] + t * VOCAB] = True
  assert torch.equal(state.tables[name][~touched], before[~touched])
  assert not torch.equal(state.tables[name][touched], before[touched])
  if optimizer == 'adam':
    m, v = state.table_opt[name].acc
    assert not m[~touched].any() and not v[~touched].any()
    assert bool((v[touched] > 0).any())


def test_unknown_table_optimizer_is_refused():
  ctx = hbt.Context(torch.device('cpu'))
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(hbt.TableConfig('c0', 10, 4))], ctx=ctx)
  with pytest.raises(ValueError, match='table_optimizer'):
    hbt.make_sparse_train_step(fx, None, table_optimizer='sgd')


def test_create_makes_lazy_adam_slots():
  tables = {'s': torch.randn(10, 4)}
  tower = torch.nn.Linear(4, 1)
  state = hbt.SparseTrainState.create(
      tower, tables, lambda p: torch.optim.SGD(p, lr=0.1), adam=True)
  m, v = state.table_opt['s'].acc
  assert m.shape == v.shape == (10, 4) and not m.any() and not v.any()
  (acc,) = hbt.SparseTrainState.create(
      tower, tables, lambda p: torch.optim.SGD(p, lr=0.1),
      adagrad_init=0.3).table_opt['s'].acc
  assert torch.equal(acc, torch.full((10, 4), 0.3))
