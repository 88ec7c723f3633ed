"""``data/dataframe.py``'s row operations through the native helpers,
bit for bit against the numpy plain versions (``native=False``), on
randomized ragged values made from a seed:

* ``Value.to_padded`` of rank-1 values (float32 with NaNs and negative
  zeros, int64, int32; inner shapes; given, bucketed and clipping
  ``max_len``; empty rows and an empty batch) goes through
  ``idmap.ragged_to_padded``; float64 values and rank 2 pad in numpy, as
  in JAX;
* ``take_rows`` of rank-1 ragged columns (every fixed-size dtype) and of
  dense columns (1-d and 2-d, repeated and permuted indices) goes through
  ``idmap.ragged_take_rows`` and ``idmap.take_rows_dense``; rank 2, an
  object column and a column that is not C-contiguous take the rows in
  numpy;
* ``parse`` and a shuffled ``rebatch`` give the JAX package's batches;
* a library that cannot be built raises ``NativeUnavailable``: nothing
  falls back to numpy unasked.
"""

import numpy as np
import pytest

from hybridbackend_tpu.data import dataframe as jdf
from hybridbackend_tpu.data.rebatch import rebatch as jax_rebatch

from hybridbackend_tpu_torch.data import dataframe as df
from hybridbackend_tpu_torch.data.rebatch import rebatch
from hybridbackend_tpu_torch.native import idmap
from hybridbackend_tpu_torch.native.tabular import NativeUnavailable

SEEDS = range(4)
TAKES = {'ragged_to_padded': 0, 'ragged_take_rows': 0, 'take_rows_dense': 0}


@pytest.fixture(autouse=True)
def counted(monkeypatch):
  """Counts the native helpers' calls."""
  for name in TAKES:
    TAKES[name] = 0
    real = getattr(idmap, name)

    def call(*args, _real=real, _name=name):
      TAKES[_name] += 1
      return _real(*args)

    monkeypatch.setattr(idmap, name, call)


def _bitwise(got, want):
  if isinstance(want, tuple):
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
      _bitwise(g, w)
    return
  if isinstance(want, df.Value):
    _bitwise(got.values, want.values)
    assert len(got.row_splits) == len(want.row_splits)
    for g, w in zip(got.row_splits, want.row_splits):
      _bitwise(g, w)
    return
  assert got.dtype == want.dtype and got.shape == want.shape
  assert got.tobytes() == want.tobytes()


def _values(rng, n, dtype, inner=()):
  if np.dtype(dtype).kind == 'f':
    v = rng.randn(n, *inner).astype(dtype)
    flat = v.reshape(-1)
    if flat.size:
      flat[rng.rand(flat.size) < 0.05] = np.nan
      flat[rng.rand(flat.size) < 0.05] = -0.0
    return v
  if np.dtype(dtype).kind == 'b':
    return rng.rand(n, *inner) < 0.5
  info = np.iinfo(dtype)
  return rng.randint(info.min, info.max, (n, *inner), dtype=dtype)


def _ragged(rng, rows, dtype, inner=(), max_len=9):
  lengths = rng.randint(0, max_len, rows)
  lengths[rng.rand(rows) < 0.2] = 0
  splits = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
  return df.Value(_values(rng, int(splits[-1]), dtype, inner), [splits])


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('dtype', ['float32', 'int64', 'int32'])
@pytest.mark.parametrize('inner', [(), (3,)])
@pytest.mark.parametrize('max_len', [None, 4, 16])
def test_to_padded_is_numpys(seed, dtype, inner, max_len):
  rng = np.random.RandomState(seed)
  v = _ragged(rng, 37, dtype, inner)
  want = v.to_padded(max_len, pad_value=-7, native=False)
  assert TAKES['ragged_to_padded'] == 0
  _bitwise(v.to_padded(max_len, pad_value=-7), want)
  assert TAKES['ragged_to_padded'] == 1


def test_to_padded_empty_batch_and_numpy_dtypes():
  empty = df.Value(np.zeros((0,), np.float32), [np.zeros(1, np.int64)])
  _bitwise(empty.to_padded(), empty.to_padded(native=False))
  assert TAKES['ragged_to_padded'] == 1
  rng = np.random.RandomState(0)
  for v in (_ragged(rng, 20, 'float64'),
            df.Value(_values(rng, 9, 'int32'),
                     [np.array([0, 2, 3], np.int64),
                      np.array([0, 4, 4, 9], np.int64)])):
    _bitwise(v.to_padded(), v.to_padded(native=False))
  assert TAKES['ragged_to_padded'] == 1


def _indices(rng, rows):
  return np.concatenate([rng.permutation(rows),
                         rng.randint(0, rows, rows // 2)])


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('dtype', ['float32', 'float64', 'int64', 'int32',
                                   'int8', 'bool'])
def test_ragged_take_rows_is_numpys(seed, dtype):
  rng = np.random.RandomState(seed)
  v = _ragged(rng, 41, dtype)
  idx = _indices(rng, 41)
  want = df.take_rows(v, idx, native=False)
  assert TAKES['ragged_take_rows'] == 0
  _bitwise(df.take_rows(v, idx), want)
  assert TAKES['ragged_take_rows'] == 1


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('shape', [(50,), (50, 3), (50, 2, 5)])
@pytest.mark.parametrize('dtype', ['float32', 'int64', 'int16', 'bool'])
def test_dense_take_rows_is_numpys(seed, shape, dtype):
  rng = np.random.RandomState(seed)
  col = _values(rng, shape[0], dtype, shape[1:])
  idx = _indices(rng, shape[0])
  want = df.take_rows(col, idx, native=False)
  _bitwise(df.take_rows(col, idx), want)
  assert TAKES['take_rows_dense'] == 1


def test_numpy_takes_where_the_helpers_do_not():
  rng = np.random.RandomState(0)
  idx = _indices(rng, 6)
  rank2 = df.Value(_values(rng, 9, 'int32'),
                   [np.array([0, 1, 1, 3, 4, 4, 6], np.int64),
                    np.array([0, 2, 2, 5, 6, 9, 9], np.int64)])
  words = np.array(['a', 'bb', None, 'c', 'dd', 'e'], dtype=object)
  strided = _values(rng, 12, 'float32', (2,))[::2]
  for col in (rank2, words, strided):
    _bitwise(df.take_rows(col, idx), df.take_rows(col, idx, native=False)
             if not isinstance(col, np.ndarray) or col.dtype != object
             else col[idx])
  assert words[idx].tolist() == df.take_rows(words, idx).tolist()
  assert sum(TAKES.values()) == 0


def test_parse_and_shuffled_rebatch_match_jax():
  rng = np.random.RandomState(3)
  fields = [df.Field('tags', np.int64, ragged_rank=1, max_len=8),
            df.Field('w', np.float32, ragged_rank=1),
            df.Field('x', np.float32), df.Field('label', np.float32)]
  jfields = [jdf.Field('tags', np.int64, ragged_rank=1, max_len=8),
             jdf.Field('w', np.float32, ragged_rank=1),
             jdf.Field('x', np.float32), jdf.Field('label', np.float32)]

  def batches(value):
    out = []
    for _ in range(5):
      t, w = _ragged(rng, 24, 'int64'), _ragged(rng, 24, 'float32')
      x, y = _values(rng, 24, 'float32'), _values(rng, 24, 'float32')
      out.append((t, w, x, y))
    return [{'tags': value(t.values, t.row_splits),
             'w': value(w.values, w.row_splits), 'x': x, 'label': y}
            for t, w, x, y in out]

  state = rng.get_state()
  port = batches(df.Value)
  rng.set_state(state)
  jax_batches = batches(jdf.Value)
  got = [df.parse(b, fields) for b in rebatch(iter(port), 16, shuffle=True,
                                              seed=5)]
  want = [jdf.parse(b, jfields) for b in jax_rebatch(
      iter(jax_batches), 16, shuffle=True, seed=5)]
  assert len(got) == len(want) > 0
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w)
    for k in w:
      _bitwise(np.asarray(g[k]), np.asarray(w[k]))
  assert TAKES['ragged_take_rows'] and TAKES['take_rows_dense']
  assert TAKES['ragged_to_padded']


def test_a_library_that_cannot_build_raises(monkeypatch):
  monkeypatch.setattr(idmap, '_LOADED', {'error': 'g++: not found'})
  v = _ragged(np.random.RandomState(0), 5, 'float32')
  with pytest.raises(NativeUnavailable, match='g\\+\\+: not found'):
    v.to_padded()
  with pytest.raises(NativeUnavailable):
    df.take_rows(v, [1, 0])
  with pytest.raises(NativeUnavailable):
    df.take_rows(np.arange(5), [1, 0])
  _bitwise(df.take_rows(np.arange(5), [1, 0], native=False),
           np.array([1, 0]))
