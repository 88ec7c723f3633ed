"""The port's int8 serving tables against the JAX package's, on the CPU.

Tables of 64 rows with a zero row and rows whose magnitudes span 1e-3 to
1e2, at d = 16 (lane-packed to ``[8, 128]`` by JAX) and d = 12 (not
packed), from seeded numpy. ``quantize_table``, ``dequantize_table`` and
``lookup_quantized`` are held bit for bit: each is the same f32 division,
rounding, clip or single product on both sides (JAX's packed lane select
adds exact zeros to the one product). ``lookup_sparse`` over a quantized
table sums a row's products in its own order: ``rtol = 1e-6, atol =
1e-7``, as ``test_torch_trainer.py`` holds the lookups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.embedding.lookup import lookup as jax_lookup
from hybridbackend_tpu.embedding.lookup import (
    lookup_sparse as jax_lookup_sparse)
from hybridbackend_tpu.embedding.quant import (
    dequantize_table as jax_dequantize, lookup_quantized as jax_lookup_q,
    quantize_table as jax_quantize)
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)

import hybridbackend_tpu_torch as hbt

V = 64
CPU = torch.device('cpu')


def _table(d, seed=0):
  rng = np.random.RandomState(seed)
  t = rng.randn(V, d) * 10.0 ** rng.uniform(-3, 2, (V, 1))
  t[5] = 0.0
  # Scale 0.25 exactly, and values at 63.5 and -2.5 scales: rint's ties
  # go to the even neighbour.
  t[9] = 0.0
  t[9, :3] = [127 * 0.25, 63.5 * 0.25, -2.5 * 0.25]
  return t.astype(np.float32)


def _ids(shape, seed=1):
  rng = np.random.RandomState(seed)
  ids = rng.randint(0, V, shape).astype(np.int32)
  flat = ids.reshape(-1)
  flat[:3] = [-1, V, V + 7]
  return ids


def _jax_ctx():
  return JContext(build_mesh(devices=jax.devices()[:1]))


def _both(d):
  """The JAX QuantizedTable and the port's, from one table."""
  t = _table(d)
  jqt = jax_quantize(t)
  return t, jqt, hbt.quantize_table(torch.from_numpy(t))


@pytest.mark.parametrize('d,packed', [(16, True), (12, False)])
def test_quantize_table_matches_jax(d, packed):
  _, jqt, qt = _both(d)
  assert (jqt.pack > 1) == packed
  assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32
  np.testing.assert_array_equal(qt.q.numpy(),
                                np.asarray(jqt.q).reshape(V, d))
  np.testing.assert_array_equal(qt.scale.numpy().view(np.int32),
                                np.asarray(jqt.scale).view(np.int32))
  assert float(qt.scale[5]) == 1.0 and not qt.q[5].any()
  assert qt.q[9, :3].tolist() == [127, 64, -2]
  assert (qt.vocab, qt.dim) == (V, d)


@pytest.mark.parametrize('d', [16, 12])
def test_dequantize_and_convert_match_jax(d):
  _, jqt, qt = _both(d)
  want = jax_dequantize(jqt)
  np.testing.assert_array_equal(hbt.dequantize_table(qt).numpy(), want)
  carried = hbt.quantized_from_jax(np.asarray(jqt.q), np.asarray(jqt.scale),
                                   d, CPU)
  assert torch.equal(carried.q, qt.q) and torch.equal(carried.scale,
                                                      qt.scale)


@pytest.mark.parametrize('shape', [(40,), (8, 5)])
@pytest.mark.parametrize('d', [16, 12])
def test_lookup_quantized_matches_jax(d, shape):
  _, jqt, qt = _both(d)
  ids = _ids(shape)
  with context_scope(_jax_ctx()):
    want = np.asarray(jax_lookup_q(jqt, jnp.asarray(ids),
                                   JTableConfig('t', V, d)))
  got = hbt.lookup_quantized(qt, torch.from_numpy(ids),
                             hbt.TableConfig('t', V, d))
  assert got.dtype == torch.float32 and got.shape == shape + (d,)
  np.testing.assert_array_equal(got.numpy(), want)
  assert not got.reshape(-1, d)[:3].any()       # -1, V and V + 7


def test_lookup_dispatches_a_quantized_table():
  _, jqt, qt = _both(16)
  ids = _ids((30,))
  cfg = hbt.TableConfig('t', V, 16)
  with context_scope(_jax_ctx()):
    want = np.asarray(jax_lookup(jqt, jnp.asarray(ids),
                                 JTableConfig('t', V, 16)))
  got = hbt.lookup(qt, torch.from_numpy(ids), cfg)
  np.testing.assert_array_equal(got.numpy(), want)
  assert torch.equal(got, hbt.lookup_quantized(qt, torch.from_numpy(ids),
                                               cfg))


@pytest.mark.parametrize('combiner', ['sum', 'mean', 'sqrtn'])
def test_lookup_sparse_over_a_quantized_table(combiner):
  _, jqt, qt = _both(16)
  ids = _ids((12, 4))
  mask = np.random.RandomState(2).rand(12, 4) < 0.6
  with context_scope(_jax_ctx()):
    want = np.asarray(jax_lookup_sparse(
        jqt, jnp.asarray(ids), jnp.asarray(mask),
        JTableConfig('t', V, 16, combiner=combiner)))
  got = hbt.lookup_sparse(qt, torch.from_numpy(ids), torch.from_numpy(mask),
                          hbt.TableConfig('t', V, 16, combiner=combiner))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_quantized_lookup_gathers_through_the_op(monkeypatch):
  """Both gathers, the int8 rows and the [V, 1] scales, go through
  kernel 5's op."""
  _, _, qt = _both(16)
  seen = []
  real = torch.ops.hbtpu.gather_rows

  class Spy:
    def __call__(self, table, ids):
      seen.append((table.dtype, tuple(table.shape)))
      return real(table, ids)

  monkeypatch.setattr(torch.ops.hbtpu, 'gather_rows', Spy())
  hbt.lookup_quantized(qt, torch.from_numpy(_ids((10,))),
                       hbt.TableConfig('t', V, 16))
  assert seen == [(torch.int8, (V, 16)), (torch.float32, (V, 1))]
