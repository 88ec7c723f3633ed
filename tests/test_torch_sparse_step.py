"""The flagship sparse train step of the PyTorch port against JAX.

3 tables of [1000, 16] stacked into one, 2 dense features, a stacked
DCNv2 tower with MLP [64, 32, 1], batch 64 with invalid ids, BCE loss,
Adam 1e-3 on the tower and row-sparse Adagrad 0.05 on the table. The JAX
step runs in a one-device context, under both update implementations:
``'auto'`` (the XLA dedup path on the CPU) and ``'stream'`` (the Pallas
kernel in interpret mode), and in the dense-split form (``'split'``:
``emb_update_split_dense='on'`` on the stream path, the Pallas
``gsum_dense_sorted`` in interpret mode, against the port's
``table_split_dense=True``). The port starts from the JAX state through
``convert.from_jax`` and runs on the CPU.

Tolerances: the per-step loss to ``rtol = 1e-5``; tables, accumulators
and tower params to ``rtol = 1e-5, atol = 2e-6``. The two sides run the
same f32 math with matmuls and duplicate-row sums in different orders;
Adam's first steps divide each gradient by its own size, which turns a
1e-7 relative gradient difference into at most about 1e-6 in a weight.
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
    stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.ops.pallas import scatter as jscatter
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState,
    make_sparse_train_step as jax_make_sparse_train_step)

import hybridbackend_tpu_torch as hbt

TABLES, VOCAB, DIM, DENSE, BATCH, STEPS = 3, 1000, 16, 2, 64, 3
MLP = [64, 32, 1]
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


def _jax_run(impl, batches):
  """Initial state and per-step (loss, state) of the JAX step."""
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  overrides = dict(emb_update_impl=impl)
  if impl == 'split':
    overrides = dict(emb_update_impl='stream', emb_update_split_dense='on',
                     emb_update_touched_blocks=-1)
  with context_scope(ctx), OPTIONS.override(**overrides):
    specs = [JEmbeddingSpec(JTableConfig(f'c{t}', VOCAB, DIM))
             for t in range(TABLES)]
    fx = JStackedFeatureExtractor(
        specs, dense_columns=[f'i{d}' for d in range(DENSE)], ctx=ctx)
    net = stacked_dcn_v2_init(jax.random.PRNGKey(1),
                              [DIM] * TABLES + [1] * DENSE, MLP)

    def model_loss(dense, emb_f, dense_f, batch):
      p = jnp.clip(stacked_dcn_v2_apply(dense, emb_f + dense_f),
                   1e-6, 1 - 1e-6)
      y = batch['label']
      return -jnp.mean(y * jnp.log(p) + (1 - y) * jnp.log(1 - p)), {}

    state = JSparseTrainState.create(net, fx.init(jax.random.PRNGKey(0)),
                                     optax.adam(1e-3), adagrad_init=0.1,
                                     ctx=ctx)
    init = jax.tree.map(np.asarray, state)
    step = jax_make_sparse_train_step(fx, model_loss, optax.adam(1e-3),
                                      table_lr=0.05, ctx=ctx,
                                      donate_state=False)
    trace = []
    for b in batches:
      state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(m['loss']), jax.tree.map(np.asarray, state)))
  return init, trace


def _port_model_loss(tower, emb_f, dense_f, batch):
  p = torch.clamp(tower(emb_f + dense_f), 1e-6, 1 - 1e-6)
  y = batch['label']
  return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {}


def _port(init, split=False):
  ctx = hbt.Context(torch.device('cpu'))
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{t}', VOCAB, DIM))
           for t in range(TABLES)]
  fx = hbt.StackedFeatureExtractor(
      specs, dense_columns=[f'i{d}' for d in range(DENSE)], ctx=ctx)
  model = hbt.StackedDCNv2([DIM] * TABLES + [1] * DENSE, MLP)
  state = hbt.from_jax(
      fx, init.tables, {k: v.acc[0] for k, v in init.table_opt.items()},
      model, init.dense, functools.partial(torch.optim.Adam, lr=1e-3))
  step = hbt.make_sparse_train_step(fx, _port_model_loss, table_lr=0.05,
                                    table_split_dense=split)
  return fx, state, step


def _assert_state_close(state, want):
  for name, table in state.tables.items():
    np.testing.assert_allclose(table.numpy(),
                               want.tables[name].reshape(-1, DIM),
                               **STATE_TOL)
    np.testing.assert_allclose(
        state.table_opt[name].acc[0].numpy(),
        want.table_opt[name].acc[0].reshape(-1, DIM), **STATE_TOL)
  layers = [state.dense.cross, *state.dense.mlp.layers]
  for layer, p in zip(layers, [want.dense['cross'], *want.dense['mlp']]):
    np.testing.assert_allclose(layer.w.detach().numpy(), p['w'],
                               **STATE_TOL)
    np.testing.assert_allclose(layer.b.detach().numpy(), p['b'],
                               **STATE_TOL)


@pytest.fixture(autouse=True)
def one_thread():
  """The port's CPU math on one thread: the dense-split update's
  whole-table square root, split across torch worker threads, once came
  out 6.6e-5 relative off in one worker's block under a loaded test run
  (``test_torch_gsum.py``)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.mark.parametrize('impl', ['auto', 'stream', 'split'])
def test_sparse_step_matches_jax(monkeypatch, impl):
  gsum_calls = []
  real_gsum = jscatter.gsum_dense_sorted

  def spy(*args, **kwargs):
    gsum_calls.append(args)
    return real_gsum(*args, **kwargs)

  monkeypatch.setattr(jscatter, 'gsum_dense_sorted', spy)
  batches = _batches()
  init, trace = _jax_run(impl, batches)
  # The JAX step traces its update once; only the split form reaches it.
  assert len(gsum_calls) == (impl == 'split')
  fx, state, step = _port(init, split=impl == 'split')
  (name,) = [s.stacked.name for s in fx.stacks]
  assert name == 'stack/c0/c1/c2' and name in init.tables
  before = state.tables[name].clone()
  for i, b in enumerate(batches):
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    state, metrics = step(state, tb)
    want_loss, want_state = trace[i]
    assert state.step == i + 1
    np.testing.assert_allclose(float(metrics['loss']), want_loss, rtol=1e-5)
    _assert_state_close(state, want_state)
  # Rows no valid id of any batch touched are unchanged, bit for bit.
  touched = torch.zeros(before.shape[0], dtype=torch.bool)
  for b in batches:
    for t in range(TABLES):
      ids = b[f'c{t}']
      touched[ids[(ids >= 0) & (ids < VOCAB)] + t * VOCAB] = True
  assert torch.equal(state.tables[name][~touched], before[~touched])
  assert not torch.equal(state.tables[name][touched], before[touched])


@pytest.mark.parametrize('optimizer,dedup', [('adam', True),
                                             ('adagrad', False)])
def test_split_dense_step_takes_only_dedup_adagrad(optimizer, dedup):
  ctx = hbt.Context(torch.device('cpu'))
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(hbt.TableConfig('c0', 10, 4))], ctx=ctx)
  with pytest.raises(ValueError, match='table_split_dense'):
    hbt.make_sparse_train_step(fx, _port_model_loss, table_dedup=dedup,
                               table_optimizer=optimizer,
                               table_split_dense=True)
