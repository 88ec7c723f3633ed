"""The port's interleaved sparse step against the JAX package's, on the CPU.

Four tables in two stacks (``c0``-``c2`` of [400, 16] and ``t3`` of
[300, 8]), 2 dense features, batch 64 with invalid ids, DCNv2 (MLP
32-16-1) under Adam 1e-3, BCE averaged over the micro-batch, table lr
0.05. The JAX step runs in a one-device context; the port's starts from
its initial state (``convert.from_jax``). Cases:

* 3 steps at ``num_microbatches=4`` against JAX's
  ``make_interleaved_train_step``, with Adagrad and LazyAdam tables in
  f32 and bf16 (LazyAdam tables made under ``emb_lane_pack='off'``, bf16
  ones against the Pallas kernels under ``emb_update_impl='stream'``, as
  in ``test_torch_bf16_tables.py``);
* against the port's own plain step from one state, at ``k`` = 1, 2, 4;
* the row-sparse update's plain version called once per stack per step,
  whatever ``k`` is, and the model hook ``raw_model_loss``;
* the refusals.

Tolerances. Against JAX, the existing sparse-step limits: the loss to
``rtol = 1e-5``; f32 tables, slots and the tower to ``rtol = 1e-5, atol
= 2e-6`` (``test_torch_sparse_step.py``), LazyAdam tables to ``atol =
2e-5`` (``test_torch_sparse_step_optimizers.py`` derives it: an update
near a zero gradient moves by up to 5e6 times the gradient's rounding
difference); bf16 tables and slots at most 1 bf16 ulp an element, or
within 1e-6 (4e-4 for a LazyAdam table), 0.5% of the elements apart at
most (``test_torch_bf16_tables.py``). Against the plain step, the JAX
test's (``tests/test_trainer.py:250-257``): the loss to ``rtol = 1e-5``,
tables, slots and tower to ``rtol = 1e-4, atol = 1e-6`` (LazyAdam tables
to the ``atol = 2e-5`` above): the micro-batches sum a gradient's terms
in another order than the whole batch does.
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
from hybridbackend_tpu.pipeline.interleave import (
    make_interleaved_train_step as jax_make_interleaved_train_step)
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.ops import scatter as port_scatter
from hybridbackend_tpu_torch.pipeline import interleave

from test_torch_cuda import assert_within_an_ulp

TABLES = {'c0': (400, 16), 'c1': (400, 16), 'c2': (400, 16), 't3': (300, 8)}
DENSE, BATCH, STEPS, K = 2, 64, 3, 4
MLP = [32, 16, 1]
DIMS = [d for _, d in TABLES.values()] + [1] * DENSE
TOL = dict(rtol=1e-5, atol=2e-6)
PLAIN_TOL = dict(rtol=1e-4, atol=1e-6)
ADAM_TABLE_ATOL = 2e-5
CPU = torch.device('cpu')
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _batches(seed=0, steps=STEPS, batch=BATCH):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(steps):
    b = {}
    for name, (vocab, _) in TABLES.items():
      ids = rng.randint(0, vocab, batch).astype(np.int32)
      ids[rng.choice(batch, 4, replace=False)] = -1
      ids[rng.choice(batch, 3, replace=False)] = vocab + 7
      b[name] = ids
    for d in range(DENSE):
      b[f'i{d}'] = rng.rand(batch).astype(np.float32)
    b['label'] = rng.randint(0, 2, batch).astype(np.float32)
    out.append(b)
  return out


def _torch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_run(optimizer, dtype, batches, k=K):
  """Initial state and per-step (loss, state) of the JAX interleaved
  step."""
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  overrides = {}
  if optimizer == 'adam':
    overrides['emb_lane_pack'] = 'off'
  if dtype == 'bfloat16':
    overrides['emb_update_impl'] = 'stream'
  jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
  with context_scope(ctx), OPTIONS.override(**overrides):
    specs = [JEmbeddingSpec(JTableConfig(n, v, d, dtype=jdt))
             for n, (v, d) in TABLES.items()]
    fx = JStackedFeatureExtractor(
        specs, dense_columns=[f'i{d}' for d in range(DENSE)], ctx=ctx)
    net = stacked_dcn_v2_init(jax.random.PRNGKey(1), DIMS, MLP)

    def model_loss(dense, emb_f, dense_f, batch):
      p = jnp.clip(stacked_dcn_v2_apply(dense, emb_f + dense_f), 1e-6,
                   1 - 1e-6)
      y = batch['label']
      return -jnp.mean(y * jnp.log(p) + (1 - y) * jnp.log(1 - p)), {
          'preds': p, 'mean_pred': jnp.mean(p)}

    state = JSparseTrainState.create(net, fx.init(jax.random.PRNGKey(0)),
                                     optax.adam(1e-3), adagrad_init=0.1,
                                     ctx=ctx, adam=optimizer == 'adam')
    init = jax.tree.map(np.asarray, state)
    step = jax_make_interleaved_train_step(
        fx, model_loss, optax.adam(1e-3), k, table_lr=0.05, ctx=ctx,
        table_optimizer=optimizer, donate_state=False)
    trace = []
    for b in batches:
      state, m = step(state, {key: jnp.asarray(v) for key, v in b.items()})
      trace.append(({key: np.asarray(v) for key, v in m.items()},
                    jax.tree.map(np.asarray, state)))
  return init, trace


def _fx(dtype):
  tdt = BF16 if dtype == 'bfloat16' else torch.float32
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(n, v, d, dtype=tdt))
           for n, (v, d) in TABLES.items()]
  return hbt.StackedFeatureExtractor(
      specs, dense_columns=[f'i{d}' for d in range(DENSE)],
      ctx=hbt.Context(CPU))


def _model_loss(t, emb_f, dense_f, batch):
  p = torch.clamp(t(emb_f + dense_f), 1e-6, 1 - 1e-6)
  y = batch['label']
  return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {
      'preds': p, 'mean_pred': torch.mean(p)}


def _port_state(fx, init):
  return hbt.from_jax(
      fx, init.tables, {n: s.acc for n, s in init.table_opt.items()},
      hbt.StackedDCNv2(DIMS, MLP), init.dense,
      functools.partial(torch.optim.Adam, lr=1e-3))


def _tower_pairs(tower, params):
  layers = [tower.cross, *tower.mlp.layers]
  for layer, p in zip(layers, [params['cross'], *params['mlp']]):
    yield layer.w, p['w']
    yield layer.b, p['b']


def _assert_tables(state, want, optimizer, dtype, fx):
  for stack in fx.stacks:
    name, dim = stack.stacked.name, stack.stacked.dim
    pairs = [(state.tables[name], want.tables[name])] + list(zip(
        state.table_opt[name].acc, want.table_opt[name].acc))
    for i, (got, w) in enumerate(pairs):
      w = hbt.convert._tensor(w, got.dtype, CPU).reshape(-1, dim)[
          :got.shape[0]]
      table_atol = ADAM_TABLE_ATOL if optimizer == 'adam' and i == 0 else None
      if dtype == 'bfloat16':
        assert got.dtype == BF16
        assert_within_an_ulp(got, w, share=0.005,
                             atol=4e-4 if table_atol else 1e-6)
      else:
        np.testing.assert_allclose(
            got.numpy(), w.numpy(),
            **(dict(TOL, atol=table_atol) if table_atol else TOL))


CASES = [('adagrad', 'float32'), ('adam', 'float32'),
         ('adagrad', 'bfloat16'), ('adam', 'bfloat16')]


@pytest.mark.parametrize('optimizer,dtype', CASES,
                         ids=[f'{o}-{d}' for o, d in CASES])
def test_interleaved_step_matches_jax(optimizer, dtype):
  batches = _batches()
  init, trace = _jax_run(optimizer, dtype, batches)
  fx = _fx(dtype)
  assert len(fx.stacks) == 2
  state = _port_state(fx, init)
  step = hbt.make_interleaved_train_step(fx, _model_loss, K, table_lr=0.05,
                                         table_optimizer=optimizer)
  for b, (jm, want) in zip(batches, trace):
    state, m = step(state, _torch(b))
    np.testing.assert_allclose(float(m['loss']), jm['loss'], rtol=1e-5)
    # The aux stitched as JAX stitches it: predictions back to [B], a
    # scalar averaged over the micro-batches.
    assert m['preds'].shape == jm['preds'].shape == (BATCH,)
    np.testing.assert_allclose(m['preds'].numpy(), jm['preds'], **TOL)
    assert m['mean_pred'].shape == jm['mean_pred'].shape == ()
    np.testing.assert_allclose(float(m['mean_pred']), jm['mean_pred'],
                               rtol=1e-5)
    _assert_tables(state, want, optimizer, dtype, fx)
    for p, w in _tower_pairs(state.dense, want.dense):
      np.testing.assert_allclose(p.detach().numpy(), w, **TOL)
  assert state.step == STEPS


def _fresh(optimizer, seed=3):
  fx = _fx('float32')
  gen = torch.Generator().manual_seed(seed)
  tables = fx.init(gen)
  tower = hbt.StackedDCNv2(DIMS, MLP, generator=gen)
  return fx, hbt.SparseTrainState.create(
      tower, tables, functools.partial(torch.optim.Adam, lr=1e-3),
      adagrad_init=0.1, adam=optimizer == 'adam')


@pytest.mark.parametrize('optimizer', ['adagrad', 'adam'])
@pytest.mark.parametrize('k', [1, 2, 4])
def test_interleaved_step_matches_the_plain_step(optimizer, k):
  """PICASSO interleaving is exact accumulate-then-apply over one table
  version: the plain step's result, up to the order of the sums."""
  fx, plain_state = _fresh(optimizer)
  _, inter_state = _fresh(optimizer)
  plain = hbt.make_sparse_train_step(fx, _model_loss, table_lr=0.05,
                                     table_optimizer=optimizer)
  inter = hbt.make_interleaved_train_step(fx, _model_loss, k, table_lr=0.05,
                                          table_optimizer=optimizer)
  for b in _batches(seed=5):
    plain_state, pm = plain(plain_state, _torch(b))
    inter_state, im = inter(inter_state, _torch(b))
    np.testing.assert_allclose(float(im['loss']), float(pm['loss']),
                               rtol=1e-5)
    for name in plain_state.tables:
      pairs = [(inter_state.tables[name], plain_state.tables[name])] + list(
          zip(inter_state.table_opt[name].acc,
              plain_state.table_opt[name].acc))
      for i, (got, want) in enumerate(pairs):
        tol = (dict(PLAIN_TOL, atol=ADAM_TABLE_ATOL)
               if optimizer == 'adam' and i == 0 else PLAIN_TOL)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    for (n, p), q in zip(inter_state.dense.named_parameters(),
                         plain_state.dense.parameters()):
      np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                 err_msg=n, **PLAIN_TOL)


@pytest.mark.parametrize('optimizer', ['adagrad', 'adam'])
@pytest.mark.parametrize('k', [1, 2, 4])
def test_one_update_per_stack_per_step(monkeypatch, optimizer, k):
  """The whole batch's list goes to one update a stack: the kernel's
  plain version (what its wrapper runs on a CPU tensor) is called once
  per stack per step, on as many rows as the plain step's list."""
  name = f'{optimizer}_update_sorted_reference'
  rows_at = 3 if optimizer == 'adam' else 2
  calls = []
  real = getattr(port_scatter, name)

  def spy(*args, **kwargs):
    calls.append((tuple(args[0].shape), int(args[rows_at].shape[0])))
    return real(*args, **kwargs)

  monkeypatch.setattr(port_scatter, name, spy)
  seen = {}
  for kind in ('plain', 'interleaved'):
    fx, state = _fresh(optimizer)
    step = (hbt.make_interleaved_train_step(fx, _model_loss, k,
                                            table_optimizer=optimizer)
            if kind == 'interleaved' else
            hbt.make_sparse_train_step(fx, _model_loss,
                                       table_optimizer=optimizer))
    seen[kind] = []
    for b in _batches(seed=6, steps=2):
      calls.clear()
      state, _ = step(state, _torch(b))
      assert len(calls) == len(fx.stacks) == 2, calls
      seen[kind].append(sorted(calls))
  assert seen['interleaved'] == seen['plain']


def test_raw_model_loss_hook():
  """``raw_model_loss`` (the members' uncombined embeddings) trains as
  ``model_loss`` does when it computes the same loss."""
  def raw_loss(t, members, batch):
    emb_f = [members[n] for n in TABLES]
    dense_f = [batch[f'i{d}'].reshape(-1, 1) for d in range(DENSE)]
    return _model_loss(t, emb_f, dense_f, batch)

  fx, a = _fresh('adagrad')
  _, b = _fresh('adagrad')
  combined = hbt.make_interleaved_train_step(fx, _model_loss, 2)
  raw = hbt.make_interleaved_train_step(fx, None, 2, raw_model_loss=raw_loss)
  for batch in _batches(seed=7, steps=2):
    a, ma = combined(a, _torch(batch))
    b, mb = raw(b, _torch(batch))
    assert float(ma['loss']) == float(mb['loss'])
  for name in a.tables:
    assert torch.equal(a.tables[name], b.tables[name])


def test_refusals():
  fx, state = _fresh('adagrad')
  with pytest.raises(ValueError, match='table_optimizer'):
    hbt.make_interleaved_train_step(fx, _model_loss, 2,
                                    table_optimizer='sgd')
  with pytest.raises(ValueError, match='at least 1'):
    hbt.make_interleaved_train_step(fx, _model_loss, 0)
  step = hbt.make_interleaved_train_step(fx, _model_loss, 3)
  with pytest.raises(ValueError, match='not divisible by num_microbatches=3'):
    step(state, _torch(_batches(steps=1)[0]))
  assert state.step == 0


def test_the_side_stream_is_made_only_on_a_card(monkeypatch):
  """On the CPU the lookups run in order: no stream is asked for."""
  made = []
  monkeypatch.setattr(interleave, '_side_stream', made.append)
  fx, state = _fresh('adagrad')
  step = hbt.make_interleaved_train_step(fx, _model_loss, 2)
  step(state, _torch(_batches(steps=1)[0]))
  assert made == []
