"""DIN's layers and towers of the PyTorch port against the JAX package.

``Dice``, ``LocalActivationUnit``, ``attention_sequence_pooling`` (with
and without weight normalization, with a row whose mask is all false),
``DIN`` and ``DINSession``, each on the same seeded numpy inputs and
weights (JAX init, carried over with ``convert.load_din`` /
``load_dice``), held against the JAX function in value and in the
gradient of a seeded weighting of the output with respect to every
input and every weight.

Tolerance ``rtol = 1e-5, atol = 1e-6`` in f32: the same f32 operations,
with matmul and reduction sums in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.models import layers as jlayers
from hybridbackend_tpu.models import ranking as jranking

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch import convert

TOL = dict(rtol=1e-5, atol=1e-6)
B, L, S, D = 6, 5, 3, 8


def _np(tree):
  return jax.tree.map(np.asarray, tree)


def _masks(rng, shape):
  """A random bool mask with its first row all false (a user without
  history) and its second all true."""
  m = rng.rand(*shape) < 0.6
  m[0] = False
  m[1] = True
  return m


def _check(jfn, jargs, tfn, targs, cot):
  """``jfn(*jargs)`` against ``tfn(*targs)`` in value, and the gradients
  of ``sum(out * cot)`` with respect to each input that requires one on
  the port's side (by ``jax.grad`` over the same arguments on JAX's)."""
  want = np.asarray(jfn(*jargs))
  got = tfn(*targs)
  np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
  wrt = tuple(i for i, t in enumerate(targs) if t.requires_grad)
  jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot), argnums=wrt)(
      *map(jnp.asarray, jargs))
  (got * torch.from_numpy(cot)).sum().backward()
  for i, g in zip(wrt, jgrads):
    np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(g), **TOL)


def _leaf(a):
  return torch.tensor(a, requires_grad=True)


def test_dice_matches_jax():
  rng = np.random.RandomState(0)
  x = rng.randn(B, 16).astype(np.float32) * 3 + 1
  params = {'alpha': rng.randn(16).astype(np.float32)}
  dice = hbt.Dice(16)
  convert.load_dice(dice, params)
  cot = rng.randn(B, 16).astype(np.float32)
  _check(lambda x: jlayers.dice_apply(params, x), [x], dice, [_leaf(x)], cot)
  jalpha = jax.grad(lambda a: jnp.sum(
      jlayers.dice_apply({'alpha': a}, jnp.asarray(x)) * cot))(
          jnp.asarray(params['alpha']))
  np.testing.assert_allclose(dice.alpha.grad.numpy(), np.asarray(jalpha),
                             **TOL)


def test_dice_uses_the_population_variance():
  """``jnp.var``'s, not torch's default unbiased one: a batch of two
  standardizes to exactly +-1 before the sigmoid."""
  dice = hbt.Dice(1)
  x = torch.tensor([[1.0], [3.0]])
  p = torch.sigmoid(torch.tensor([[-1.0], [1.0]]))
  torch.testing.assert_close(dice(x), p * x, rtol=1e-6, atol=1e-6)


def _unit(rng, hidden=(8, 4)):
  params = jlayers.local_activation_unit_init(
      jax.random.PRNGKey(int(rng.randint(1 << 30))), D, hidden)
  unit = hbt.LocalActivationUnit(D, hidden)
  convert._load_dense(unit.mlp.layers, params['mlp'])
  return _np(params), unit


def test_local_activation_unit_matches_jax():
  rng = np.random.RandomState(1)
  params, unit = _unit(rng)
  q = rng.randn(B, D).astype(np.float32)
  k = rng.randn(B, L, D).astype(np.float32)
  cot = rng.randn(B, L).astype(np.float32)
  _check(lambda q, k: jlayers.local_activation_unit_apply(params, q, k),
         [q, k], unit, [_leaf(q), _leaf(k)], cot)
  # Sigmoid between the layers, none after the last.
  assert unit.mlp.layers[0].activation is torch.sigmoid
  assert unit.mlp.layers[-1].activation is None


@pytest.mark.parametrize('normalize', [False, True])
@pytest.mark.parametrize('mask_dtype', [np.bool_, np.float32])
def test_attention_sequence_pooling_matches_jax(normalize, mask_dtype):
  rng = np.random.RandomState(2)
  params, unit = _unit(rng)
  q = rng.randn(B, D).astype(np.float32)
  k = rng.randn(B, L, D).astype(np.float32)
  mask = _masks(rng, (B, L)).astype(mask_dtype)
  cot = rng.randn(B, D).astype(np.float32)
  _check(lambda q, k, m: jlayers.attention_sequence_pooling(
             params, q, k, m, weight_normalization=normalize),
         [q, k, mask],
         lambda q, k, m: hbt.attention_sequence_pooling(
             unit, q, k, m, weight_normalization=normalize),
         [_leaf(q), _leaf(k), torch.from_numpy(mask)], cot)


def test_an_all_masked_row_pools_uniformly_when_normalized():
  """A row whose mask is all false: with weight normalization the JAX
  fill (-2**31, finite) gives every key the weight 1/L, no NaN; without
  it the row pools to zero."""
  rng = np.random.RandomState(3)
  _, unit = _unit(rng)
  q, k = torch.randn(2, D), torch.randn(2, L, D)
  mask = torch.zeros(2, L, dtype=torch.bool)
  out = hbt.attention_sequence_pooling(unit, q, k, mask, True)
  torch.testing.assert_close(out, k.mean(dim=1), rtol=1e-6, atol=1e-6)
  out = hbt.attention_sequence_pooling(unit, q, k, mask, False)
  assert torch.equal(out, torch.zeros(2, D))


def _din_inputs(rng, session):
  q = rng.randn(B, D).astype(np.float32)
  shape = (B, S, L) if session else (B, L)
  keys = rng.randn(*shape, D).astype(np.float32)
  mask = _masks(rng, shape)
  if session:
    mask[2, 1] = False                  # a session with no events
  prof = rng.randn(B, D).astype(np.float32)
  dense = rng.rand(B, 1).astype(np.float32)
  return q, keys, mask, prof, dense


@pytest.mark.parametrize('session', [False, True])
@pytest.mark.parametrize('normalize', [False, True])
def test_din_matches_jax(session, normalize):
  rng = np.random.RandomState(4 + session)
  init, apply, Tower = (
      (jranking.din_session_init, jranking.din_session_apply,
       hbt.DINSession) if session else
      (jranking.din_init, jranking.din_apply, hbt.DIN))
  params = _np(init(jax.random.PRNGKey(7), D, num_profile_features=1,
                    num_dense=1, dnn_hidden_units=(16, 8),
                    att_hidden_size=(8, 4)))
  tower = Tower(D, 1, 1, (16, 8), (8, 4))
  convert.load_din(tower, params)
  assert tower.dnn.layers[0].w.shape == (D * 3 + 1, 16)
  assert tower.dnn.layers[-1].activation is torch.relu
  q, keys, mask, prof, dense = _din_inputs(rng, session)
  cot = rng.randn(B).astype(np.float32)
  targs = [_leaf(q), _leaf(keys), torch.from_numpy(mask), _leaf(prof),
           _leaf(dense)]
  _check(lambda q, k, m, p, d: apply(params, q, k, m, [p], [d],
                                     att_weight_normalization=normalize),
         [q, keys, mask, prof, dense],
         lambda q, k, m, p, d: tower(q, k, m, [p], [d],
                                     att_weight_normalization=normalize),
         targs, cot)
  # The weights' gradients, through convert's mapping of the JAX tree.
  jgrads = jax.grad(lambda p: jnp.sum(apply(
      p, q, keys, mask, [prof], [dense],
      att_weight_normalization=normalize) * cot))(params)
  for p, g in convert._pairs(tower, _np(jgrads)):
    np.testing.assert_allclose(p.grad.numpy(), g.numpy(), **TOL)


def test_din_moves_with_from_jax_into_a_sparse_state():
  """``from_jax`` takes a DIN tower, and optax Adam's moments of it."""
  params = _np(jranking.din_init(jax.random.PRNGKey(0), D, 0, 0, (8,), (4,)))
  ctx = hbt.Context(torch.device('cpu'))
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(hbt.TableConfig('item', 30, D))], ctx=ctx)
  tables = {fx.stacks[0].stacked.name: np.ones((30, D), np.float32)}
  mu = jax.tree.map(lambda a: np.full_like(a, 0.5), params)
  nu = jax.tree.map(lambda a: np.full_like(a, 0.25), params)
  state = hbt.from_jax(fx, tables, {k: np.zeros_like(v)
                                    for k, v in tables.items()},
                       hbt.DIN(D, 0, 0, (8,), (4,)), params,
                       lambda p: torch.optim.Adam(p, lr=1e-3), step=2,
                       adam=(mu, nu, 2))
  torch.testing.assert_close(state.dense.head.w.detach(),
                             torch.tensor(params['head']['w']))
  for p in state.dense.parameters():
    slots = state.dense_opt.state[p]
    assert float(slots['step']) == 2
    assert torch.equal(slots['exp_avg'], torch.full_like(p, 0.5))
