"""The plain versions of the add and LazyAdam kernels against the JAX
package's Pallas kernels (interpret mode) on an update list with long runs.

The list is ``LONG_RUNS['three-rows']`` of ``test_torch_cuda.py`` (three
neighbouring rows taking 2000, 1500 and 1000 entries, as a column of a few
rows takes a zipf column's hot ids) cut to the 3000 entries of
``tests/test_pallas_scatter.py``: runs of 1 to 3 entries, a run of 2000
(more than fifteen tiles of 128 entries at d = 16), and the list ending
inside a run of 800. The card's kernels are held bit for bit against these
plain versions on the same lists (``test_torch_cuda.py``).

Two kinds of gradients, from one seed:
  * 'grid': multiples of 2**-10 in [-0.5, 0.5). Every partial sum of a
    run is then exact in f32, so any order of adds gives the same total,
    and the two packages must agree to the kernels' own tolerances: the add
    within ``rtol = atol = 1e-6``, LazyAdam within ``rtol = 1e-5, atol =
    1e-6`` and ``v`` within ``rtol = 3e-5`` (the Pallas kernel rounds ``1 -
    b2`` in f32, ROADMAP "LazyAdam `1 - b` rounding").
  * 'normal': N(0, 1), the hard list's own. The Pallas kernel sums a run
    with one-hot matmuls over three bf16 limbs, in another f32 order than
    the list order of the plain version: on the run of 2000 the two totals
    are up to 5e-5 apart, many times 1e-6 of a total near 45. So here each
    package's run totals (the add on a zero table) are held within the
    bound of any f32 summation of the run, ``(k - 1) * 2**-24 * sum |g|``
    for a run of k entries, of the float64 totals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.ops.pallas.scatter import (
    adam_update_sorted as jax_adam_update_sorted,
    scatter_add_sorted as jax_scatter_add_sorted)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.ops import scatter
from test_torch_cuda import LONG_LISTS, LONG_LIST_IDS, hard_list, hard_slots

NAME, N = 'three-rows', 3000
LR, STEP = 0.05, 3
ADAM_TOL = dict(rtol=1e-5, atol=1e-6)
PALLAS = dict(block_rows=2048, chunk=256, interpret=True)


def long_list(kind):
  """``(v, d, rows, g, table)`` of the cut list as CPU tensors, with
  ``kind`` gradients."""
  spec = LONG_LISTS[LONG_LIST_IDS.index(NAME)]
  v, d, _, rows, g, table = hard_list(spec)
  rows, g = rows[:N], g[:N]
  if kind == 'grid':
    rng = np.random.RandomState(N)
    g = torch.from_numpy(
        (rng.randint(-512, 512, g.shape) / 1024).astype(np.float32))
  return v, d, rows, g.contiguous(), table


def _np(*xs):
  return [jnp.asarray(x.numpy()) for x in xs]


def test_cut_list_keeps_a_run_longer_than_two_tiles():
  v, d, rows, g, _ = long_list('normal')
  r = rows.numpy()
  _, counts = np.unique(r[(r >= 0) & (r < v)], return_counts=True)
  assert counts.max() > 2 * scatter.tile_entries(d)
  assert r[-1] == r[-800] != r[-801]           # it ends inside a run


def test_add_reference_matches_pallas_on_a_long_run_list():
  v, d, rows, g, table = long_list('grid')
  got = hbt.scatter_add_sorted(table.clone(), rows, g).numpy()
  want = jax_scatter_add_sorted(*_np(table, rows, g), **PALLAS)
  np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_adam_reference_matches_pallas_on_a_long_run_list():
  v, d, rows, g, table = long_list('grid')
  spec = LONG_LISTS[LONG_LIST_IDS.index(NAME)]
  m, vv = hard_slots(spec, table)
  got = hbt.adam_update_sorted(table.clone(), m.clone(), vv.clone(), rows, g,
                               LR, STEP)
  want = jax_adam_update_sorted(*_np(table, m, vv, rows, g), lr=LR,
                                step=STEP, interpret=True)
  v_tol = dict(ADAM_TOL, rtol=3e-5)
  for x, w, tol in zip(got, want, (ADAM_TOL, ADAM_TOL, v_tol)):
    np.testing.assert_allclose(x.numpy(), np.asarray(w), **tol)
  untouched = np.setdiff1d(np.arange(v), rows.numpy())
  for x, before in zip(got, (table, m, vv)):
    np.testing.assert_array_equal(x.numpy()[untouched],
                                  before.numpy()[untouched])


@pytest.mark.parametrize('package', ['port', 'pallas'])
def test_long_run_totals_within_the_f32_bound(package):
  v, d, rows, g, _ = long_list('normal')
  zeros = torch.zeros(v, d)
  if package == 'port':
    got = hbt.scatter_add_sorted(zeros, rows, g).numpy()
  else:
    got = np.asarray(jax_scatter_add_sorted(*_np(zeros, rows, g), **PALLAS))
  r, x = rows.numpy(), g.numpy().astype(np.float64)
  ok = (r >= 0) & (r < v)
  exact, mass = np.zeros((v, d)), np.zeros((v, d))
  np.add.at(exact, r[ok], x[ok])
  np.add.at(mass, r[ok], np.abs(x[ok]))
  k = np.bincount(r[ok], minlength=v)[:, None]
  bound = np.maximum(k - 1, 0) * 2.0 ** -24 * mass
  # The f32 total's own rounding of the f64 sum, half an ulp.
  bound += np.abs(exact) * 2.0 ** -24
  err = np.abs(got.astype(np.float64) - exact)
  assert (err <= bound).all(), float((err - bound).max())
  assert err[k[:, 0] > 1000].max() > 0         # the long runs do round
