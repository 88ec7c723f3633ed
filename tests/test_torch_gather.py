"""The port's row gather with clipped ids against the JAX package.

``gather_rows_reference`` and ``gather_rows`` (which on a CPU tensor runs
the plain version) against the JAX Pallas ``gather_rows_pallas`` in interpret mode
(d 128, the widths it takes) and against the JAX ``gather_rows`` (its
``jnp.take`` path) at d 16. Ids run from -5 to V+10: the contract clips
them, so -1 reads row 0 and V+10 reads row V-1. A gather copies values,
so every comparison is bitwise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.ops.pallas import gather as jgather

import hybridbackend_tpu_torch as hbt


def _case(v, d, n, seed):
  rng = np.random.RandomState(seed)
  table = rng.randn(v, d).astype(np.float32)
  ids = rng.randint(-5, v + 11, n).astype(np.int32)
  ids[:3] = [-5, -1, v + 10]
  return table, ids


@functools.cache
def _pallas_case():
  """One interpret-mode run of the Pallas kernel (about 6 s), shared."""
  table, ids = _case(1000, 128, 200, seed=0)          # N not a multiple of 128
  want = np.asarray(jgather.gather_rows_pallas(
      jnp.asarray(table), jnp.asarray(ids), interpret=True))
  return table, ids, want


@pytest.mark.parametrize('use', ['reference', 'kernel_wrapper'])
def test_matches_pallas_kernel(use):
  table, ids, want = _pallas_case()
  fn = hbt.gather_rows_reference if use == 'reference' else hbt.gather_rows
  got = fn(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got[:3], table[[0, 0, 999]])


@pytest.mark.parametrize('use', ['reference', 'kernel_wrapper'])
def test_matches_jax_gather_rows_at_d16(use):
  table, ids = _case(3000, 16, 1001, seed=1)
  want = np.asarray(jgather.gather_rows(jnp.asarray(table), jnp.asarray(ids)))
  fn = hbt.gather_rows_reference if use == 'reference' else hbt.gather_rows
  got = fn(torch.from_numpy(table), torch.from_numpy(ids))
  np.testing.assert_array_equal(got.numpy(), want)


def test_any_id_shape_and_type():
  table, ids = _case(50, 3, 24, seed=2)
  t = torch.from_numpy(table)
  ids2 = torch.from_numpy(ids).reshape(4, 6)
  want = np.asarray(jgather.gather_rows(jnp.asarray(table),
                                        jnp.asarray(ids).reshape(4, 6)))
  for i in (ids2, ids2.long()):
    got = hbt.gather_rows(t, i)
    assert got.shape == (4, 6, 3)
    np.testing.assert_array_equal(got.numpy(), want)
  empty = hbt.gather_rows(t, torch.zeros(0, dtype=torch.int32))
  assert empty.shape == (0, 3)


def test_cpu_wrapper_counts_no_launch():
  table, ids = _case(40, 8, 30, seed=3)
  before = hbt.gather_rows.launches
  hbt.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
  assert hbt.gather_rows.launches == before


@pytest.mark.parametrize('bad', ['float_ids', 'table_1d', 'empty_table'])
def test_rejects_what_the_kernel_does_not_take(bad):
  table, ids = torch.zeros((8, 4)), torch.zeros(3, dtype=torch.int32)
  if bad == 'float_ids':
    ids = ids.float()
  elif bad == 'table_1d':
    table = torch.zeros(8)
  else:
    table = torch.zeros((0, 4))
  with pytest.raises((TypeError, ValueError)):
    hbt.gather_rows(table, ids)
