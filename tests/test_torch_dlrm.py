"""DLRM tower of the PyTorch port against the JAX package.

Weights come from ``dlrm_init`` and are converted into the port
(``load_dlrm``); the two packages' own initialisers draw different
numbers. Forward values, the gradients with respect to the dense and the
embedding features, and the parameter gradients must agree to
``rtol = 1e-5, atol = 1e-6`` (parameter gradients ``atol = 1e-5``): both
run the same f32 matmuls and pairwise dots on the CPU, summed in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.ranking import dlrm_apply, dlrm_init

import hybridbackend_tpu_torch as hbt

TOL = dict(rtol=1e-5, atol=1e-6)
WIDE, DEEP, DIM = 3, 4, 8
BOTTOM, TOP = [32, 16], [64, 32, 1]


def _features(seed, batch=64):
  rng = np.random.RandomState(seed)
  # Dense features straddle 0, so log1p(max(x, 0)) clips some of them.
  wide = [(rng.rand(batch, 1) * 4 - 1).astype(np.float32)
          for _ in range(WIDE)]
  deep = [rng.uniform(-0.25, 0.25, (batch, DIM)).astype(np.float32)
          for _ in range(DEEP)]
  return wide, deep


def _models(seed):
  params = dlrm_init(jax.random.PRNGKey(seed), WIDE, DEEP, BOTTOM, DIM, TOP)
  model = hbt.DLRM(WIDE, DEEP, BOTTOM, DIM, TOP)
  hbt.load_dlrm(model, jax.tree.map(np.asarray, params))
  return params, model


@pytest.mark.parametrize('seed', [0, 1])
def test_dlrm_forward_and_feature_grads_match_jax(seed):
  params, model = _models(seed)
  wide, deep = _features(seed + 10)

  def total(w, d):
    return jnp.sum(dlrm_apply(params, w, d))

  jw, jd = [jnp.asarray(f) for f in wide], [jnp.asarray(f) for f in deep]
  want = np.asarray(dlrm_apply(params, jw, jd))
  want_gw, want_gd = jax.grad(total, argnums=(0, 1))(jw, jd)

  tw = [torch.from_numpy(f).requires_grad_() for f in wide]
  td = [torch.from_numpy(f).requires_grad_() for f in deep]
  got = model(tw, td)
  got.sum().backward()
  assert got.shape == (64,)
  np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
  for t, g in zip(tw + td, list(want_gw) + list(want_gd)):
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_dlrm_param_grads_match_jax():
  params, model = _models(2)
  wide, deep = _features(12)
  want = jax.grad(lambda p: jnp.sum(dlrm_apply(
      p, [jnp.asarray(f) for f in wide], [jnp.asarray(f) for f in deep])))(
          params)
  model([torch.from_numpy(f) for f in wide],
        [torch.from_numpy(f) for f in deep]).sum().backward()
  layers = [*model.bottom_mlp.layers, model.bottom_out, *model.top_mlp.layers]
  grads = [*want['bottom_mlp'], want['bottom_out'], *want['top_mlp']]
  for layer, g in zip(layers, grads):
    np.testing.assert_allclose(layer.w.grad.numpy(), np.asarray(g['w']),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layer.b.grad.numpy(), np.asarray(g['b']),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('deep_dtype', ['float32', 'bfloat16'])
def test_dlrm_bf16_compute_matches_jax(deep_dtype):
  """``compute_dtype=bfloat16`` against JAX's DLRM under
  ``OPTIONS['compute_dtype'] = 'bfloat16'``, with embedding features of
  f32 or (as a bf16 table gives them) bf16, which the interaction's
  stack promotes to f32 and whose gradients come back rounded to bf16.
  Values and gradients to ``rtol = 1e-5`` plus 1e-4 of each array's
  largest value: every layer rounds its inputs to bf16, so an f32
  difference of order 1e-7 can move an input by a bf16 ulp."""
  params, model = _models(4)
  for layer in [*model.bottom_mlp.layers, model.bottom_out,
                *model.top_mlp.layers]:
    layer.compute_dtype = torch.bfloat16
  wide, deep = _features(14)
  jw = [jnp.asarray(f) for f in wide]
  jd = [jnp.asarray(f, dtype=deep_dtype) for f in deep]
  with OPTIONS.override(compute_dtype='bfloat16'):
    want = np.asarray(dlrm_apply(params, jw, jd))
    want_p, want_w, want_d = jax.grad(
        lambda p, w, d: jnp.sum(dlrm_apply(p, w, d)),
        argnums=(0, 1, 2))(params, jw, jd)
  tw = [torch.from_numpy(f).requires_grad_() for f in wide]
  td = [torch.from_numpy(np.array(f, np.float32)).to(
      getattr(torch, deep_dtype)).requires_grad_() for f in jd]
  got = model(tw, td)
  got.sum().backward()
  _assert_near(got.detach(), want)
  for t, g in zip(tw + td, list(want_w) + list(want_d)):
    assert t.grad.dtype == t.dtype
    _assert_near(t.grad.float(), np.asarray(g.astype(np.float32)))
  layers = [*model.bottom_mlp.layers, model.bottom_out, *model.top_mlp.layers]
  grads = [*want_p['bottom_mlp'], want_p['bottom_out'], *want_p['top_mlp']]
  for layer, g in zip(layers, grads):
    _assert_near(layer.w.grad, g['w'])
    _assert_near(layer.b.grad, g['b'])


def _assert_near(got, want):
  want = np.asarray(want)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                             atol=1e-4 * float(np.abs(want).max()))


def test_dlrm_shapes_follow_the_flagship_config():
  """``train_benchmark.py --model dlrm``: 13 dense and 26 embedding
  features of 16, bottom 512-256, top 1024-512-1 over 16 + 27·26/2."""
  model = hbt.DLRM(13, 26, [512, 256], 16, [1024, 512, 1],
                   generator=torch.Generator().manual_seed(0))
  assert [l.w.shape for l in model.bottom_mlp.layers] == [(13, 512),
                                                         (512, 256)]
  assert model.bottom_out.w.shape == (256, 16)
  assert model.top_mlp.layers[0].w.shape == (16 + 351, 1024)
  assert model.triu.shape == (351,)
  assert not any(n == 'triu' for n in model.state_dict())


def test_load_dlrm_rejects_a_mismatched_tower():
  params = jax.tree.map(np.asarray, _models(3)[0])
  with pytest.raises(ValueError):
    hbt.load_dlrm(hbt.DLRM(WIDE, DEEP, BOTTOM, DIM, [64, 1]), params)
  with pytest.raises(ValueError):
    hbt.load_dlrm(hbt.DLRM(WIDE, DEEP + 1, BOTTOM, DIM, TOP), params)
  with pytest.raises(TypeError):
    hbt.from_jax(None, {}, {}, torch.nn.Linear(2, 2), params, None)
