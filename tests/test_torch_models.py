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

from hybridbackend_tpu.models.ranking import (
    stacked_dcn_v2_apply, stacked_dcn_v2_init)

import hybridbackend_tpu_torch as hbt

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
  dense = hbt.Dense(8, 4, compute_dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0))
  x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
  y = dense(x)
  assert y.dtype == torch.float32 and dense.w.dtype == torch.float32
  np.testing.assert_allclose(y.detach().numpy(),
                             (x @ dense.w + dense.b).detach().numpy(),
                             rtol=2e-2, atol=2e-2)      # bf16 operands


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
