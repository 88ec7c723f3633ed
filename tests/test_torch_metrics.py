"""The port's metrics against ``hybridbackend_tpu.metrics`` on seeded
inputs: AUC (ROC and PR; unweighted, weighted, and with ``_sync_valid``
zeros), mean, accuracy, GAUC (groups in runs and shuffled, boundary
groups skipped or kept, tied predictions, soft labels) and the
``Trainer``'s per-batch metric update with the padding sentinel; and
``auc_limit``, the bound of two AUCs over predictions a little apart,
against the JAX thresholds and the JAX AUC of moved predictions.

Tolerances: with 0/1 weights and 0/1 labels every sum is a count below
2**24, exact in f32 in any order, so the confusion matrices and the GAUC
weight totals are held bit for bit and the AUC to 1 f32 ulp (``rtol =
1.2e-7``; its 199-term sum may round in another order). The GAUC
numerator is a sum of per-group AUCs (fractions, each computed alike) in
another order: ``rtol = 1e-6``. With real weights or soft labels every
sum is an f32 sum in two orders: ``rtol = 1e-6``. Predictions include
values equal to thresholds, to hold the strict ``>``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybridbackend_tpu.metrics as jm
from hybridbackend_tpu.estimator import _metrics_step as jax_metrics_step

from hybridbackend_tpu_torch import metrics as tm
from hybridbackend_tpu_torch.estimator import (
    _metrics_step as port_metrics_step)

ULP = 1.2e-7


def _inputs(seed, n=500, ties=False):
  rng = np.random.RandomState(seed)
  preds = rng.rand(n).astype(np.float32)
  if ties:
    preds = np.round(preds * 8) / 8        # many equal predictions
  # Some predictions sit exactly on thresholds (i + 1) / 199.
  on = rng.choice(n, 20, replace=False)
  preds[on] = (np.float32(rng.randint(1, 198, 20) / 199.0)).astype(
      np.float32)
  labels = (rng.rand(n) < preds).astype(np.float32)
  return labels, preds.astype(np.float32), rng


def _t(x):
  return torch.from_numpy(np.asarray(x))


def _same_state(port, want, rtol=0.0):
  for got, w in zip(port, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize('weights', ['none', 'valid', 'real'])
@pytest.mark.parametrize('curve', ['ROC', 'PR'])
def test_auc_matches_jax(curve, weights):
  jstate, pstate = jm.auc_init(), tm.auc_init()
  for seed in range(3):
    labels, preds, rng = _inputs(seed)
    w = None
    if weights == 'valid':
      w = np.ones(labels.shape, np.float32)
      w[-37:] = 0.0                          # padding rows
    elif weights == 'real':
      w = rng.rand(labels.shape[0]).astype(np.float32)
    jstate = jm.auc_update(jstate, jnp.asarray(labels), jnp.asarray(preds),
                           None if w is None else jnp.asarray(w))
    pstate = tm.auc_update(pstate, _t(labels), _t(preds),
                           None if w is None else _t(w))
  rtol = 1e-6 if weights == 'real' else 0.0
  _same_state(pstate, jstate, rtol)
  np.testing.assert_allclose(float(tm.auc_result(pstate, curve)),
                             float(jm.auc_result(jstate, curve)),
                             rtol=1e-6 if weights == 'real' else ULP)


def test_auc_padding_rows_count_nothing():
  labels, preds, _ = _inputs(7)
  w = np.ones(labels.shape, np.float32)
  w[100:] = 0.0
  padded = tm.auc_update(tm.auc_init(), _t(labels), _t(preds), _t(w))
  alone = tm.auc_update(tm.auc_init(), _t(labels[:100]), _t(preds[:100]))
  _same_state(padded, alone)


@pytest.mark.parametrize('shift', [0.0, 1e-6, 3e-3])
def test_auc_limit_bounds_the_auc_of_moved_predictions(shift):
  # Predictions moved by up to ``shift`` (some onto or across the
  # thresholds): the AUCs of the two sets, both by the JAX package's
  # metric, stay within the limit, and the count behind it is that of the
  # reference predictions within the gap of one of the JAX thresholds.
  labels, preds, rng = _inputs(11)
  moved = (preds + rng.uniform(-shift, shift, preds.shape)).astype(
      np.float32)
  limit, near, gap = tm.auc_limit(moved, _t(preds), labels)
  thr = np.asarray(jm._thresholds(200))
  assert gap == float(np.abs(moved - preds).max())
  assert near == int((np.abs(preds[:, None] - thr[None, :]) <= gap)
                     .any(1).sum())
  pos = float(labels.sum())
  assert limit == pytest.approx(near / min(pos, len(labels) - pos) + 1e-6,
                                rel=1e-12)

  def auc(p):
    return float(jm.auc_result(jm.auc_update(
        jm.auc_init(), jnp.asarray(labels), jnp.asarray(p))))

  assert abs(auc(moved) - auc(preds)) <= limit


def test_auc_rejects_an_unknown_curve():
  with pytest.raises(ValueError, match='curve'):
    tm.auc_result(tm.auc_init(), 'DET')


@pytest.mark.parametrize('weighted', [False, True])
def test_mean_and_accuracy_match_jax(weighted):
  rng = np.random.RandomState(3)
  values = rng.randn(300).astype(np.float32)
  w = rng.rand(300).astype(np.float32) if weighted else None
  jw = None if w is None else jnp.asarray(w)
  pw = None if w is None else _t(w)
  js = jm.mean_update(jm.mean_init(), jnp.asarray(values), jw)
  ps = tm.mean_update(tm.mean_init(), _t(values), pw)
  _same_state(ps, js, 1e-6)
  np.testing.assert_allclose(float(tm.mean_result(ps)),
                             float(jm.mean_result(js)), rtol=1e-6)
  labels = rng.randint(0, 2, 300).astype(np.float32)
  guess = rng.randint(0, 2, 300).astype(np.float32)
  ja = jm.accuracy_update(jm.accuracy_init(), jnp.asarray(labels),
                          jnp.asarray(guess), jw)
  pa = tm.accuracy_update(tm.accuracy_init(), _t(labels), _t(guess), pw)
  _same_state(pa, ja, 1e-6)
  np.testing.assert_allclose(float(tm.accuracy_result(pa)),
                             float(jm.accuracy_result(ja)), rtol=1e-6)


def _groups(rng, n, contiguous):
  sizes = rng.randint(1, 30, n)
  ind = np.repeat(np.arange(len(sizes)), sizes)[:n].astype(np.int32)
  ind = ind * 7 + 3                      # ids need not be dense
  if not contiguous:
    ind = ind[rng.permutation(n)]
  return ind


@pytest.mark.parametrize('soft', [False, True])
@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('contiguous,sort_groups,skip', [
    (True, False, True), (True, False, False), (False, True, True)])
def test_gauc_matches_jax(contiguous, sort_groups, skip, ties, soft):
  labels, preds, rng = _inputs(11, n=600, ties=ties)
  if soft:
    labels = np.round(rng.rand(600), 2).astype(np.float32)
  ind = _groups(rng, 600, contiguous)
  want = jm.gauc_batch(jnp.asarray(labels), jnp.asarray(preds),
                       jnp.asarray(ind), skip, sort_groups=sort_groups)
  got = tm.gauc_batch(_t(labels), _t(preds), _t(ind), skip,
                      sort_groups=sort_groups)
  np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
  np.testing.assert_allclose(float(got[1]), float(want[1]),
                             rtol=1e-6 if soft else 0.0)
  assert float(got[1]) > 0                # some groups counted
  js = jm.gauc_update(jm.gauc_init(), jnp.asarray(labels),
                      jnp.asarray(preds), jnp.asarray(ind), skip,
                      sort_groups=sort_groups)
  ps = tm.gauc_update(tm.gauc_init(), _t(labels), _t(preds), _t(ind), skip,
                      sort_groups=sort_groups)
  np.testing.assert_allclose(float(tm.gauc_result(ps)),
                             float(jm.gauc_result(js)), rtol=1e-6)


@pytest.mark.parametrize('with_pel,with_valid,with_group', [
    (True, True, True), (False, True, True), (False, False, False),
    (True, False, True)])
def test_trainer_metric_step_matches_jax(with_pel, with_valid, with_group):
  """The eval loop's per-batch update, the GAUC padding sentinel
  included: padding rows (``_sync_valid`` 0) carry group ids of real
  groups and label 0, and must not join them."""
  labels, preds, rng = _inputs(5, n=400)
  ind = _groups(rng, 400, contiguous=False)
  valid = np.ones(400, np.float32)
  valid[-50:] = 0.0
  labels[-50:] = 0.0
  pel = rng.rand(400).astype(np.float32)
  loss = np.float32(pel.mean())
  zero = jnp.zeros((), jnp.float32)
  jstate = jax_metrics_step(
      jm.auc_init(), jm.mean_init(), jm.gauc_init(), jnp.asarray(labels),
      jnp.asarray(preds), jnp.asarray(pel) if with_pel else zero,
      jnp.asarray(loss), jnp.asarray(valid) if with_valid else zero,
      jnp.asarray(ind) if with_group else zero, has_pel=with_pel,
      has_valid=with_valid, has_group=with_group)
  pstate = port_metrics_step(
      tm.auc_init(), tm.mean_init(), tm.gauc_init(), _t(labels), _t(preds),
      _t(pel) if with_pel else None, torch.tensor(loss),
      _t(valid) if with_valid else None, _t(ind) if with_group else None)
  _same_state(pstate[0], jstate[0])
  for p, j in zip(pstate[1:], jstate[1:]):
    _same_state(p, j, 1e-6)
  if with_group:
    assert float(pstate[2].count) > 0
