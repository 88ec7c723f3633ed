"""Stacked DCNv2 tower of the PyTorch port against the JAX package.

Weights come from ``stacked_dcn_v2_init`` and are converted into the
port (``load_dcn_v2``); the two packages' own initialisers draw
different numbers. Forward values and the gradient with respect to the
input features must agree to ``rtol = 1e-5, atol = 1e-6``: both run the
same f32 matmuls on the CPU, summed in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.layers import dense_apply, dense_init
from hybridbackend_tpu.models.ranking import (
    stacked_dcn_v2_apply, stacked_dcn_v2_init)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.convert import _load_dense

TOL = dict(rtol=1e-5, atol=1e-6)
DIMS = [16, 16, 16, 1, 1]
MLP = [64, 32, 1]


def _features(seed, batch=64):
  rng = np.random.RandomState(seed)
  return [(rng.uniform(-0.25, 0.25, (batch, d)) if d > 1
           else rng.rand(batch, d)).astype(np.float32) for d in DIMS]


def _models(seed):
  params = stacked_dcn_v2_init(jax.random.PRNGKey(seed), DIMS, MLP)
  model = hbt.StackedDCNv2(DIMS, MLP)
  hbt.load_dcn_v2(model, jax.tree.map(np.asarray, params))
  return params, model


@pytest.mark.parametrize('seed', [0, 1])
def test_dcn_v2_forward_and_input_grad_match_jax(seed):
  params, model = _models(seed)
  feats = _features(seed + 10)

  def total(fs):
    return jnp.sum(stacked_dcn_v2_apply(params, fs))

  want = np.asarray(stacked_dcn_v2_apply(params,
                                         [jnp.asarray(f) for f in feats]))
  want_g = jax.grad(total)([jnp.asarray(f) for f in feats])

  tfeats = [torch.from_numpy(f).requires_grad_() for f in feats]
  got = model(tfeats)
  got.sum().backward()
  assert got.shape == (64,)
  np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
  for t, g in zip(tfeats, want_g):
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_dcn_v2_param_grads_match_jax():
  params, model = _models(2)
  feats = _features(12)
  want = jax.grad(lambda p: jnp.sum(stacked_dcn_v2_apply(
      p, [jnp.asarray(f) for f in feats])))(params)
  model([torch.from_numpy(f) for f in feats]).sum().backward()
  pairs = [(model.cross, want['cross'])] + list(zip(model.mlp.layers,
                                                    want['mlp']))
  for layer, g in pairs:
    np.testing.assert_allclose(layer.w.grad.numpy(), np.asarray(g['w']),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layer.b.grad.numpy(), np.asarray(g['b']),
                               rtol=1e-5, atol=1e-5)


def test_dcn_v2_init_layout_and_scales():
  model = hbt.StackedDCNv2(DIMS, MLP,
                           generator=torch.Generator().manual_seed(0))
  total = sum(DIMS)
  assert model.cross.w.shape == (total, total)        # w: [in, out]
  assert float(model.cross.w.detach().std()) == pytest.approx(1.0, rel=0.1)
  assert not model.cross.b.detach().any()             # b_stddev = 0
  assert [l.w.shape for l in model.mlp.layers] == [
      (total, 64), (64, 32), (32, 1)]


def test_dense_compute_dtype_keeps_f32_params_and_output():
  """``compute_dtype=bfloat16`` against JAX ``dense_apply(compute_dtype=
  jnp.bfloat16)``: the exact product of the bf16 operands with an f32
  result, and bf16-rounded input and weight gradients. Forward and bias
  gradient to ``TOL`` (f32 sums in another order); the input and weight
  gradients bitwise (each is one f32 sum rounded once to bf16; a sum
  within 1e-7 of a rounding boundary could flip a bf16 ulp, which these
  inputs do not hold)."""
  params = dense_init(jax.random.PRNGKey(0), 40, 24)
  x = np.random.RandomState(0).randn(64, 40).astype(np.float32)
  dense = hbt.Dense(40, 24, torch.relu, compute_dtype=torch.bfloat16)
  _load_dense([dense], [jax.tree.map(np.asarray, params)])

  def total(p, xs):
    return jnp.sum(jnp.sin(dense_apply(p, xs, jax.nn.relu,
                                       compute_dtype=jnp.bfloat16)))

  want = dense_apply(params, jnp.asarray(x), jax.nn.relu,
                     compute_dtype=jnp.bfloat16)
  want_p, want_x = jax.grad(total, argnums=(0, 1))(params, jnp.asarray(x))
  tx = torch.from_numpy(x).requires_grad_()
  y = dense(tx)
  torch.sin(y).sum().backward()
  assert y.dtype == torch.float32 and dense.w.dtype == torch.float32
  np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
  np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_x))
  np.testing.assert_array_equal(dense.w.grad.numpy(), np.asarray(want_p['w']))
  np.testing.assert_allclose(dense.b.grad.numpy(), np.asarray(want_p['b']),
                             **TOL)


def test_dcn_v2_bf16_compute_matches_jax():
  """The stacked DCNv2 with ``compute_dtype=bfloat16`` against JAX's
  under ``OPTIONS['compute_dtype'] = 'bfloat16'``, forward and every
  gradient. Each layer rounds its inputs to bf16, so an f32 difference
  of order 1e-7 in the cross layer's output can move one MLP input by a
  bf16 ulp (2**-8 relative) and its effects on; values and gradients are
  held to ``rtol = 1e-5`` plus 1e-4 of each array's largest value."""
  params = stacked_dcn_v2_init(jax.random.PRNGKey(4), DIMS, MLP)
  model = hbt.StackedDCNv2(DIMS, MLP, compute_dtype=torch.bfloat16)
  hbt.load_dcn_v2(model, jax.tree.map(np.asarray, params))
  feats = _features(14)
  jfeats = [jnp.asarray(f) for f in feats]
  with OPTIONS.override(compute_dtype='bfloat16'):
    want = np.asarray(stacked_dcn_v2_apply(params, jfeats))
    want_p, want_f = jax.grad(
        lambda p, fs: jnp.sum(stacked_dcn_v2_apply(p, fs)),
        argnums=(0, 1))(params, jfeats)
  tfeats = [torch.from_numpy(f).requires_grad_() for f in feats]
  got = model(tfeats)
  got.sum().backward()
  _assert_near(got.detach(), want)
  for t, g in zip(tfeats, want_f):
    _assert_near(t.grad, g)
  pairs = [(model.cross, want_p['cross'])] + list(zip(model.mlp.layers,
                                                      want_p['mlp']))
  for layer, g in pairs:
    _assert_near(layer.w.grad, g['w'])
    _assert_near(layer.b.grad, g['b'])


def _assert_near(got, want):
  want = np.asarray(want)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                             atol=1e-4 * float(np.abs(want).max()))


def test_load_dcn_v2_rejects_a_mismatched_tower():
  params, _ = _models(3)
  other = hbt.StackedDCNv2(DIMS, [64, 1])
  with pytest.raises(ValueError):
    hbt.load_dcn_v2(other, jax.tree.map(np.asarray, params))
  params_np = jax.tree.map(np.asarray, params)
  params_np['mlp'][0] = dict(params_np['mlp'][0],
                             w=np.zeros((5, 64), np.float32))
  with pytest.raises(ValueError):
    hbt.load_dcn_v2(hbt.StackedDCNv2(DIMS, MLP), params_np)
