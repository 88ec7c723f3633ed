"""The port's micro-batch pipelining against the JAX package's, on the CPU.

The dense-gradient model of ``test_torch_trainer.py`` cut down: 3 tables
of [200, 8], one per column, 2 dense features, DCNv2 (MLP 16-1), batch
32 with invalid ids, BCE averaged over the (micro-)batch, with the
predictions and their mean as aux. The JAX functions run in a one-device
context; the port's module takes the JAX initial weights
(``convert.from_jax_dense``). Cases:

* ``accumulate_gradients`` against JAX's at ``k`` = 1, 2, 4, with
  ``remat`` on and off: the loss, every gradient, the stitched aux (a
  ``[B]`` tensor back to ``[B]``, a scalar to the vector of its ``k``
  values); and ``remat`` changing no bit;
* a batch that does not divide: ``ValueError`` (JAX drops the remainder);
* 3 steps of ``make_pipelined_train_step`` against JAX's, under Adagrad
  0.1 on every parameter (optax's and the port's ``Adagrad``) and under
  ``multi_optimizer(adagrad 0.05, adam 1e-3)``.

Tolerances: the JAX test's (``tests/test_trainer.py:137-147``) for the
gradients, ``rtol = 1e-4, atol = 1e-6``, and the loss within 1e-5; after
the steps, tables, accumulators and tower to ``rtol = 1e-5, atol = 2e-6``
(``test_torch_trainer.py``'s dense trainer: the same f32 math with sums
in other orders) and the loss to ``rtol = 1e-5``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    extract_features as jax_extract_features,
    init_tables as jax_init_tables)
from hybridbackend_tpu.models.ranking import (
    stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.pipeline import (
    accumulate_gradients as jax_accumulate_gradients,
    make_pipelined_train_step as jax_make_pipelined_train_step)
from hybridbackend_tpu.training.optimizer import (
    multi_optimizer as jax_multi_optimizer)
from hybridbackend_tpu.training.train import TrainState as JTrainState

import hybridbackend_tpu_torch as hbt

TABLES, VOCAB, DIM, DENSE, BATCH, STEPS = 3, 200, 8, 2, 32, 3
MLP = [16, 1]
DENSE_NAMES = [f'i{d}' for d in range(DENSE)]
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TOL = dict(rtol=1e-5, atol=2e-6)
CPU = torch.device('cpu')


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
    for t in range(TABLES):
      ids = rng.randint(0, VOCAB, batch).astype(np.int32)
      ids[rng.choice(batch, 2, replace=False)] = -1
      b[f'c{t}'] = ids
    for d in range(DENSE):
      b[f'i{d}'] = rng.rand(batch).astype(np.float32)
    b['label'] = rng.randint(0, 2, batch).astype(np.float32)
    out.append(b)
  return out


def _jctx():
  return JContext(build_mesh(devices=jax.devices()[:1]))


def _jax_model(ctx):
  specs = [JEmbeddingSpec(JTableConfig(f'c{t}', VOCAB, DIM))
           for t in range(TABLES)]
  params = {'tables': jax_init_tables(specs, jax.random.PRNGKey(0), ctx),
            'net': stacked_dcn_v2_init(jax.random.PRNGKey(1),
                                       [DIM] * TABLES + [1] * DENSE, MLP)}

  def loss_fn(p, b):
    emb, dense = jax_extract_features(p['tables'], b, specs, DENSE_NAMES,
                                      ctx=ctx)
    preds = jnp.clip(stacked_dcn_v2_apply(p['net'], emb + dense), 1e-6,
                     1 - 1e-6)
    y = b['label']
    loss = -jnp.mean(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
    return loss, {'preds': preds, 'mean_pred': jnp.mean(preds)}

  return params, loss_fn


def _port_model(params, optimizer=None):
  """The port's module with the JAX weights (``convert.from_jax_dense``),
  its ``TrainState`` under ``optimizer(module)`` (the port's Adagrad 0.1
  by default) and its loss."""
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{t}', VOCAB, DIM))
           for t in range(TABLES)]
  module = nn.ModuleDict({
      'tables': hbt.init_tables(specs, torch.Generator().manual_seed(0), CPU),
      'net': hbt.StackedDCNv2([DIM] * TABLES + [1] * DENSE, MLP)})
  optimizer = optimizer or (lambda m: hbt.Adagrad(m.parameters(), lr=0.1))
  state = hbt.from_jax_dense(module, specs, jax.tree.map(np.asarray, params),
                             optimizer(module))

  def loss_fn(m, b):
    emb, dense = hbt.extract_features(m['tables'], b, specs, DENSE_NAMES)
    preds = torch.clamp(m['net'](emb + dense), 1e-6, 1 - 1e-6)
    y = b['label']
    loss = -torch.mean(y * torch.log(preds) + (1 - y) * torch.log(1 - preds))
    return loss, {'preds': preds, 'mean_pred': torch.mean(preds)}

  return state, loss_fn


def _jax_leaf(jtree, name):
  """The JAX array of the port's parameter ``name`` (``tables.c0``,
  ``net.mlp.layers.0.w``) in the port's layout."""
  if name.startswith('tables.'):
    t = name.split('.', 1)[1]
    return np.asarray(jtree['tables'][t]).reshape(-1, DIM)[:VOCAB]
  raise KeyError(name)


def _tower_pairs(net, jnet):
  """(port parameter, JAX array) of the tower."""
  return [(p, np.asarray(w)) for p, w in hbt.convert._pairs(net, jnet)]


def _torch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads(module, grads, jgrads):
  assert set(grads) == {n for n, _ in module.named_parameters()}
  for t in range(TABLES):
    name = f'tables.c{t}'
    np.testing.assert_allclose(grads[name].numpy(), _jax_leaf(jgrads, name),
                               **GRAD_TOL)
  tower = dict(module.named_parameters())
  for p, w in _tower_pairs(module['net'], jgrads['net']):
    (name,) = [n for n, q in tower.items() if q is p]
    assert grads[name] is p.grad
    np.testing.assert_allclose(grads[name].numpy(), w, err_msg=name,
                               **GRAD_TOL)


@pytest.mark.parametrize('remat', [True, False])
@pytest.mark.parametrize('k', [1, 2, 4])
def test_accumulate_gradients_matches_jax(k, remat):
  b = _batches(seed=1, steps=1)[0]
  ctx = _jctx()
  with context_scope(ctx):
    params, jloss = _jax_model(ctx)
    (jl, jaux), jgrads = jax_accumulate_gradients(jloss, k, remat)(
        params, {key: jnp.asarray(v) for key, v in b.items()})
  state, loss = _port_model(params)
  module = state.params
  (l, aux), grads = hbt.accumulate_gradients(loss, k, remat)(module,
                                                            _torch(b))
  assert abs(float(l) - float(jl)) < 1e-5
  _assert_grads(module, grads, jgrads)
  # The aux stitched as JAX stacks it: [B] back to [B], a scalar to [k].
  assert aux['preds'].shape == jaux['preds'].shape == (BATCH,)
  np.testing.assert_allclose(aux['preds'].numpy(), jaux['preds'], **TOL)
  assert aux['mean_pred'].shape == jaux['mean_pred'].shape == (k,)
  np.testing.assert_allclose(aux['mean_pred'].numpy(), jaux['mean_pred'],
                             **TOL)


def test_accumulated_equals_the_full_batch():
  """The JAX test's own check, on the port: four micro-batches' averaged
  gradients against the whole batch's; ``remat`` changes no bit."""
  b = _torch(_batches(seed=2, steps=1)[0])
  ctx = _jctx()
  with context_scope(ctx):
    params, _ = _jax_model(ctx)
  state, loss = _port_model(params)
  module = state.params
  full_loss, _ = loss(module, b)
  full_loss.backward()
  full_loss = full_loss.detach()
  full = {n: p.grad.clone() for n, p in module.named_parameters()}
  got = {}
  for remat in (True, False):
    (l, _), grads = hbt.accumulate_gradients(loss, 4, remat)(module, b)
    assert abs(float(l) - float(full_loss)) < 1e-5
    for n, g in grads.items():
      np.testing.assert_allclose(g.numpy(), full[n].numpy(), **GRAD_TOL)
    got[remat] = {n: g.clone() for n, g in grads.items()}
  for n in got[True]:
    assert torch.equal(got[True][n], got[False][n]), n


def test_a_batch_that_does_not_divide_is_refused():
  ctx = _jctx()
  with context_scope(ctx):
    params, _ = _jax_model(ctx)
  state, loss = _port_model(params)
  b = _torch(_batches(steps=1, batch=30)[0])
  with pytest.raises(ValueError, match='not divisible by num_microbatches=4'):
    hbt.accumulate_gradients(loss, 4)(state.params, b)
  step = hbt.make_pipelined_train_step(loss, 4)
  with pytest.raises(ValueError, match='leading dim 30'):
    step(state, b)
  assert state.step == 0
  with pytest.raises(ValueError, match='at least 1'):
    hbt.accumulate_gradients(loss, 0)(state.params, b)


# The JAX optimizer and the port's, built on the module.
OPTIMIZERS = {
    'adagrad': (lambda params: optax.adagrad(0.1),
                lambda m: hbt.Adagrad(m.parameters(), lr=0.1)),
    'adagrad+adam': (
        lambda params: jax_multi_optimizer(optax.adagrad(0.05),
                                           optax.adam(1e-3))(params),
        hbt.multi_optimizer(functools.partial(hbt.Adagrad, lr=0.05),
                            functools.partial(torch.optim.Adam, lr=1e-3))),
}


@pytest.mark.parametrize('kind', ['adagrad', 'adagrad+adam'])
def test_pipelined_step_matches_jax(kind):
  batches = _batches(seed=3)
  ctx = _jctx()
  with context_scope(ctx):
    params, jloss = _jax_model(ctx)
    jopt = OPTIMIZERS[kind][0](params)
    jstate = JTrainState.create(params, jopt, ctx)
    jstep = jax_make_pipelined_train_step(jloss, jopt, 4, ctx=ctx,
                                          donate_state=False)
    trace = []
    for b in batches:
      jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(jm['loss']), jax.tree.map(np.asarray,
                                                    jstate.params)))
  state, loss = _port_model(params, OPTIMIZERS[kind][1])
  module = state.params
  step = hbt.make_pipelined_train_step(loss, 4)
  for b, (jl, want) in zip(batches, trace):
    state, m = step(state, _torch(b))
    np.testing.assert_allclose(float(m['loss']), jl, rtol=1e-5)
    assert m['preds'].shape == (BATCH,) and m['mean_pred'].shape == (4,)
    for t in range(TABLES):
      name = f'tables.c{t}'
      np.testing.assert_allclose(
          module['tables'][f'c{t}'].detach().numpy(), _jax_leaf(want, name),
          **TOL)
    for p, w in _tower_pairs(module['net'], want['net']):
      np.testing.assert_allclose(p.detach().numpy(), w, **TOL)
  assert state.step == STEPS
