"""The port's host data plane against the JAX package's, on the CPU.

Each case gives both packages the same inputs, made from a numpy seed, and
holds the port's result against the JAX package's bit for bit (values,
dtypes, row splits): the ragged ``Value`` forms, ``parse`` and
``populate_defaults``; ``rebatch`` (plain, the shuffled reservoir and the
shuffled sampled takes); ``deduplicate``/``restore_deduplicated``;
``validate``; and ``ParquetDataset``'s Python reader against the JAX
package's Python reader (its native reader switched off) on the files
and options of ``CASES``. ``tests/test_torch_native_data.py`` holds the
two native readers against each other on the same cases. Also here:
reader batches through ``put_batch`` and ``DeviceIterator`` on the CPU.
"""

import importlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pyarrow.parquet as pq
import pytest
import torch

import hybridbackend_tpu.data as jdata
from hybridbackend_tpu.data import validate as jvalidate
from hybridbackend_tpu.native import tabular as jtabular

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch import data as tdata
from hybridbackend_tpu_torch.data import validate as tvalidate

# The packages export the function ``rebatch`` under its module's name.
jrebatch = importlib.import_module('hybridbackend_tpu.data.rebatch')
trebatch = importlib.import_module('hybridbackend_tpu_torch.data.rebatch')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')


# -- comparison ---------------------------------------------------------------

def assert_column_equal(got, want, where=''):
  """Bitwise: the same type (array or ragged value), dtype, shape, values
  and row splits."""
  if isinstance(want, (jdata.Value, tdata.Value)):
    assert isinstance(got, tdata.Value), where
    assert len(got.row_splits) == len(want.row_splits), where
    for a, b in zip(got.row_splits, want.row_splits):
      assert a.dtype == b.dtype, where
      np.testing.assert_array_equal(a, b, err_msg=where)
    got, want = got.values, want.values
  assert not isinstance(got, tdata.Value), where
  got, want = np.asarray(got), np.asarray(want)
  assert got.dtype == want.dtype and got.shape == want.shape, (
      where, got.dtype, want.dtype, got.shape, want.shape)
  np.testing.assert_array_equal(got, want, err_msg=where)


def assert_batches_equal(got, want):
  assert len(got) == len(want), (len(got), len(want))
  for i, (g, w) in enumerate(zip(got, want)):
    assert list(g) == list(w), (i, list(g), list(w))
    for k in w:
      assert_column_equal(g[k], w[k], f'batch {i}, column {k!r}')


# -- the files ------------------------------------------------------------------

def _lists(rng, n, hi, longest):
  return [rng.randint(0, hi, rng.randint(0, longest)).tolist()
          for _ in range(n)]


def write_files(d):
  """The test files in directory ``d``, by name: every column kind in one
  file with nulls, two files for multi-file and glob reads, an ORC file,
  a file stored deduplicated, a list<list<list>> file, a list<string>
  file, and two files whose string type drifts."""
  rng = np.random.RandomState(0)
  out = {}
  n = 700
  rank2 = [[rng.randint(0, 9, rng.randint(0, 3)).tolist()
            for _ in range(rng.randint(0, 4))] for _ in range(n)]
  strs = [None if i % 11 == 0 else f's{i}-é漢' * (i % 3) for i in range(n)]
  ints = [None if i % 7 == 0 else int(v)
          for i, v in enumerate(rng.randint(-50, 50, n))]
  lists = _lists(rng, n, 50, 6)
  lists[3] = None
  lists[5] = [1, None, 3]
  kinds = pa.table({
      'id': np.arange(n, dtype=np.int64),
      'x': rng.rand(n).astype(np.float32),
      'w': rng.rand(n),                                   # float64
      'small': rng.randint(0, 100, n).astype(np.int16),
      'u': rng.randint(0, 1 << 30, n).astype(np.uint32),
      'ni': pa.array(ints, pa.int64()),
      'seq': pa.array(lists, pa.list_(pa.int64())),
      'fseq': pa.array([[float(v) for v in l]
                        for l in _lists(rng, n, 9, 4)],
                       pa.list_(pa.float32())),
      'sess': pa.array(rank2, pa.list_(pa.list_(pa.int32()))),
      's': pa.array(strs, pa.string()),
  })
  out['kinds'] = os.path.join(d, 'kinds.parquet')
  pq.write_table(kinds, out['kinds'], row_group_size=97)
  for i, (rows, rg) in enumerate([(300, 64), (260, 50)]):
    t = pa.table({
        'a': np.arange(i * 1000, i * 1000 + rows, dtype=np.int64),
        'b': rng.rand(rows).astype(np.float32),
        'c': pa.array(_lists(rng, rows, 50, 5), pa.list_(pa.int64())),
    })
    out[f'part{i}'] = os.path.join(d, f'part-{i}.parquet')
    pq.write_table(t, out[f'part{i}'], row_group_size=rg)
  out['parts'] = [out['part0'], out['part1']]
  out['glob'] = os.path.join(d, 'part-*.parquet')
  orc = pa.table({'a': np.arange(500, dtype=np.int64),
                  'b': rng.rand(500),
                  'r': pa.array(_lists(rng, 500, 9, 5), pa.list_(pa.int64()))})
  out['orc'] = os.path.join(d, 'x.orc')
  po.write_table(orc, out['orc'], stripe_size=4096)
  # Deduplicated storage: per row group, the user columns once per user
  # and an index column.
  writer = None
  path = out['dedup'] = os.path.join(d, 'dedup.parquet')
  for g in range(4):
    users = rng.randint(0, 1000, 7)
    idx = rng.randint(0, 7, 40)
    t = pa.table({
        'item': pa.array(rng.randint(0, 100, 40).astype(np.int64)),
        'user': pa.array(np.concatenate([users, np.zeros(33, np.int64)])),
        'hist': pa.array(_lists(rng, 7, 30, 4) + [[]] * 33,
                         pa.list_(pa.int64())),
        'restore_idx': pa.array(idx.astype(np.int64)),
    })
    if writer is None:
      writer = pq.ParquetWriter(path, t.schema)
    writer.write_table(t)
  writer.close()
  out['rank3'] = os.path.join(d, 'rank3.parquet')
  pq.write_table(pa.table({
      'deep': pa.array([[[[1, 2]], [[3]]], [[[4]]], []] * 20,
                       pa.list_(pa.list_(pa.list_(pa.int64())))),
      'k': np.arange(60, dtype=np.int64)}), out['rank3'], row_group_size=16)
  out['lstr'] = os.path.join(d, 'lstr.parquet')
  pq.write_table(pa.table({'ls': pa.array([['a'], ['b', 'c'], []] * 30),
                           'k': np.arange(90, dtype=np.int64)}), out['lstr'])
  out['drift'] = [os.path.join(d, 'drift0.parquet'),
                  os.path.join(d, 'drift1.parquet')]
  pq.write_table(pa.table({'s': pa.array(['a', 'b', 'c'], pa.string()),
                           'k': np.arange(3, dtype=np.int64)}),
                 out['drift'][0])
  pq.write_table(pa.table({'s': pa.array(['d', 'e'], pa.large_string()),
                           'k': np.arange(3, 5, dtype=np.int64)}),
                 out['drift'][1])
  return out


@pytest.fixture(scope='module')
def files(tmp_path_factory):
  return write_files(str(tmp_path_factory.mktemp('torch_data')))


# (id, file key, ParquetDataset kwargs, combinator chain). The combinator
# chain is applied the same way to both packages' datasets.
_MAP = lambda b: {**b, 'a2': np.asarray(b['a']) * 2}
CASES = [
    ('kinds', 'kinds', dict(batch_size=64), None),
    ('kinds-drop', 'kinds', dict(batch_size=100, drop_remainder=True), None),
    ('kinds-one-batch', 'kinds', dict(batch_size=1000), None),
    ('kinds-columns', 'kinds', dict(batch_size=50, fields=['s', 'id', 'seq']),
     None),
    ('kinds-shuffle', 'kinds',
     dict(batch_size=64, shuffle=True, seed=7, num_parallel_reads=1), None),
    ('kinds-shuffle-window', 'kinds',
     dict(batch_size=32, shuffle=True, shuffle_buffer=300, seed=3), None),
    ('parts', 'parts', dict(batch_size=45), None),
    ('glob', 'glob', dict(batch_size=128, drop_remainder=True), None),
    ('parts-shuffle', 'parts', dict(batch_size=60, shuffle=True, seed=1),
     None),
    ('partition-files', 'parts',
     dict(batch_size=40, partition_index=1, partition_count=2), None),
    ('partition-row-groups', 'kinds',
     dict(batch_size=30, partition_index=2, partition_count=3), None),
    ('orc', 'orc', dict(batch_size=128, format='orc'), None),
    ('orc-shuffle', 'orc',
     dict(batch_size=100, format='orc', shuffle=True, seed=5), None),
    ('restore', 'dedup',
     dict(batch_size=24, restore_columns=['user', 'hist']), None),
    ('map-take', 'parts', dict(batch_size=50),
     lambda ds: ds.map(_MAP).take(3)),
    ('repeat-take', 'parts', dict(batch_size=200),
     lambda ds: ds.repeat(2).take(5)),
    ('repeat-forever', 'part0', dict(batch_size=128),
     lambda ds: ds.repeat().take(7)),
    ('dedup-restore', 'parts', dict(batch_size=64),
     lambda ds: ds.dedup(['c'], 'a').restore(['c'])),
    ('rank3', 'rank3', dict(batch_size=13), None),
    ('list-of-strings', 'lstr', dict(batch_size=20), None),
    ('type-drift', 'drift', dict(batch_size=2), None),
]
CASE_IDS = [c[0] for c in CASES]


def read(pkg, case, files, **extra):
  """All batches of ``case`` through ``pkg``'s ``Dataset.from_parquet``
  (or ``from_orc``) and the case's combinators."""
  _, key, kwargs, chain = case
  kwargs = {**kwargs, **extra}
  fmt = kwargs.pop('format', 'parquet')
  mod = jdata if pkg == 'jax' else tdata
  make = mod.Dataset.from_orc if fmt == 'orc' else mod.Dataset.from_parquet
  ds = make(files[key], **kwargs)
  if chain is not None:
    ds = chain(ds)
  return list(ds)


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
def test_python_reader_matches_jax(files, monkeypatch, case):
  got = read('port', case, files, native=False)
  monkeypatch.setattr(jtabular, 'available', lambda: False)
  want = read('jax', case, files)
  assert want
  assert_batches_equal(got, want)


def test_python_reader_says_what_it_is(files):
  it = iter(tdata.ParquetDataset(files['part0'], batch_size=64,
                                 native=False))
  assert it.reader == 'python' and it.fallback_reason is None
  assert sum(len(b['a']) for b in it) == 300
  it.close()


def test_python_reader_reads_in_one_thread_as_in_many(files):
  one = list(tdata.ParquetDataset(files['kinds'], batch_size=64,
                                  num_parallel_reads=1, native=False))
  many = list(tdata.ParquetDataset(files['kinds'], batch_size=64,
                                   num_parallel_reads=4, native=False))
  assert_batches_equal(one, many)


def test_infer_fields_matches_jax(files):
  for key in ('kinds', 'dedup', 'rank3', 'lstr'):
    got = tdata.infer_fields(files[key])
    want = jdata.infer_fields(files[key])
    assert [(f.name, f.dtype, f.ragged_rank) for f in got] == [
        (f.name, f.dtype, f.ragged_rank) for f in want]


def test_declared_fields_are_checked(files):
  with pytest.raises(ValueError, match='Unknown column'):
    tdata.ParquetDataset(files['part0'], fields=['nope'])
  with pytest.raises(ValueError, match='ragged_rank'):
    tdata.ParquetDataset(files['part0'], fields=[tdata.Field('a',
                                                             ragged_rank=1)])
  with pytest.raises(ValueError, match='No files matched'):
    tdata.ParquetDataset(os.path.join(os.path.dirname(files['part0']),
                                      'none-*.parquet'))


# -- the DataFrame values -------------------------------------------------------

def _values(rng):
  """Ragged values of rank 1 and 2, with empty rows and an inner shape."""
  n = 9
  lens = rng.randint(0, 6, n)
  lens[2] = 0
  r1 = (rng.randint(0, 100, int(lens.sum())).astype(np.int64),
        [np.concatenate([[0], np.cumsum(lens)])])
  outer = rng.randint(0, 4, n)
  inner = rng.randint(0, 5, int(outer.sum()))
  r2 = (rng.rand(int(inner.sum())).astype(np.float32),
        [np.concatenate([[0], np.cumsum(outer)]),
         np.concatenate([[0], np.cumsum(inner)])])
  vec = (rng.rand(int(lens.sum()), 3).astype(np.float32), r1[1])
  i32 = (r1[0].astype(np.int32), r1[1])
  return {'r1': r1, 'r2': r2, 'vec': vec, 'i32': i32}


@pytest.mark.parametrize('name', ['r1', 'r2', 'vec', 'i32'])
def test_value_forms_match_jax(name):
  values, splits = _values(np.random.RandomState(4))[name]
  got, want = tdata.Value(values, splits), jdata.Value(values, splits)
  assert got.batch_size == want.batch_size and len(got) == len(want)
  assert got.ragged_rank == want.ragged_rank
  rank = want.ragged_rank
  lens = [None, 2, 8] if rank == 1 else [None, 3, (2, 3), (None, 2)]
  for max_len in lens:
    for pad in (0, -7):
      for a, b in zip(got.to_padded(max_len=max_len, pad_value=pad),
                      want.to_padded(max_len=max_len, pad_value=pad)):
        assert_column_equal(a, b, f'to_padded({max_len}, {pad})')
  for a, b in zip(got.to_coo()[:2], want.to_coo()[:2]):
    assert_column_equal(a, b, 'to_coo')
  assert got.to_coo()[2] == want.to_coo()[2]
  assert_column_equal(got.flatten_inner(), want.flatten_inner(), 'flatten')
  for start, stop in ((0, 3), (2, 2), (3, 9), (0, 9)):
    assert_column_equal(got.slice_rows(start, stop),
                        want.slice_rows(start, stop), f'slice {start}:{stop}')
  parts = [got.slice_rows(0, 4), got.slice_rows(4, 4), got.slice_rows(4, 9)]
  jparts = [want.slice_rows(0, 4), want.slice_rows(4, 4),
            want.slice_rows(4, 9)]
  assert_column_equal(tdata.Value.concat(parts), jdata.Value.concat(jparts),
                      'concat')
  assert_column_equal(tdata.Value.concat(parts), got, 'concat round trip')
  idx = np.array([8, 0, 2, 2, 5])
  from hybridbackend_tpu.data import dataframe as jdf
  from hybridbackend_tpu_torch.data import dataframe as tdf
  assert_column_equal(tdf.take_rows(got, idx), jdf.take_rows(want, idx),
                      'take_rows')


def test_value_padding_refuses_what_it_cannot_pad():
  values, splits = _values(np.random.RandomState(4))['r2']
  with pytest.raises(ValueError, match='must have 2 entries'):
    tdata.Value(values, splits).to_padded(max_len=(1, 2, 3))
  with pytest.raises(ValueError, match='requires a ragged value'):
    tdata.Value(np.arange(3)).to_padded()


def test_parse_and_populate_defaults_match_jax():
  rng = np.random.RandomState(5)
  vals = _values(rng)
  fields = [('a', dict()), ('r1', dict(ragged_rank=1, max_len=4,
                                       default_value=-1)),
            ('r2', dict(dtype=np.float32, ragged_rank=2, max_len=(2, 3))),
            ('vec', dict(dtype=np.float32, ragged_rank=1)),
            ('missing', dict(dtype=np.float32, default_value=9.5)),
            ('missing_r', dict(ragged_rank=1, default_value=3)),
            ('missing_v', dict(dtype=np.int32, shape=(2,), default_value=1))]
  for pkg in ('port', 'jax'):
    mod = tdata if pkg == 'port' else jdata
    batch = {'a': np.arange(9),
             **{k: mod.Value(*vals[k]) for k in ('r1', 'r2', 'vec')}}
    fs = [mod.Field(name, **kw) for name, kw in fields]
    filled = mod.populate_defaults(batch, fs)
    out = mod.parse(filled, fs)
    if pkg == 'port':
      got_filled, got = filled, out
  assert list(got_filled) == list(filled)
  for k in filled:
    assert_column_equal(got_filled[k], filled[k], k)
  assert list(got) == list(out)
  for k in out:
    assert_column_equal(got[k], out[k], k)
  assert tdata.populate_defaults({}, [tdata.Field('x')]) == {}


def test_from_arrow_matches_jax():
  rng = np.random.RandomState(6)
  arrays = [
      pa.array(rng.rand(5)),
      pa.chunked_array([pa.array([1, 2]), pa.array([3])]),
      pa.array([[1, 2], None, [3]], pa.large_list(pa.int32())),
      pa.array(['x', None, 'zz']),
      pa.array([1, None, 3], pa.int64()),
  ]
  for arr in arrays:
    assert_column_equal(tdata.from_arrow(arr), jdata.from_arrow(arr),
                        str(arr.type))


def test_dataframe_alias():
  assert tdata.DataFrame.Field is tdata.Field is hbt.Field
  assert tdata.DataFrame.Value is tdata.Value is hbt.Value
  assert hbt.DataFrame is tdata.DataFrame and hbt.data is tdata


# -- rebatch --------------------------------------------------------------------

def _micro(rng, sizes, ragged=False, drift_at=None):
  out = []
  for i, n in enumerate(sizes):
    b = {'k': rng.randint(0, 1000, n).astype(np.int64),
         'f': rng.rand(n, 2).astype(np.float32)}
    if drift_at is not None and i >= drift_at:
      b['k'] = b['k'].astype(np.int32)
    if ragged:
      lens = rng.randint(0, 4, n)
      b['r'] = (rng.randint(0, 9, int(lens.sum())).astype(np.int64),
                np.concatenate([[0], np.cumsum(lens)]))
    out.append(b)
  return out


def _as(mod, micro, ragged_from=0):
  """The micro-batches with ``mod``'s ragged values; those before
  ``ragged_from`` without their ragged column (dense micro-batches fill the
  shuffle reservoir, which the first ragged one demotes)."""
  out = []
  for i, b in enumerate(micro):
    c = dict(b)
    if 'r' in c:
      if i >= ragged_from:
        c['r'] = mod.Value(c['r'][0], [c['r'][1]])
      else:
        del c['r']
    out.append(c)
  return out


@pytest.mark.parametrize('kw,ragged,ragged_from,drift_at', [
    (dict(batch_size=16), False, 0, None),
    (dict(batch_size=16, drop_remainder=True), True, 0, None),
    (dict(batch_size=10, shuffle=True, seed=3), False, 0, None),
    (dict(batch_size=10, shuffle=True, seed=3, shuffle_buffer=64), True, 0,
     None),
    (dict(batch_size=12, shuffle=True, seed=9), False, 0, 2),   # drift
    (dict(batch_size=7, shuffle=True, seed=2, drop_remainder=True), True, 3,
     None),                                                     # demotion
], ids=['plain', 'ragged-drop', 'reservoir', 'sampled', 'dtype-drift',
        'reservoir-then-ragged'])
def test_rebatch_matches_jax(kw, ragged, ragged_from, drift_at):
  micro = _micro(np.random.RandomState(11), [5, 30, 1, 17, 40, 9, 23],
                 ragged, drift_at)
  got = list(trebatch.rebatch(iter(_as(tdata, micro, ragged_from)), **kw))
  want = list(jrebatch.rebatch(iter(_as(jdata, micro, ragged_from)), **kw))
  assert_batches_equal(got, want)


def test_rebatch_buffer_takes_match_jax():
  micro = _micro(np.random.RandomState(12), [8, 8, 8], ragged=True)
  for shuffle in (False, True):
    t, j = (trebatch.RebatchBuffer(shuffle=shuffle, seed=4),
            jrebatch.RebatchBuffer(shuffle=shuffle, seed=4))
    for tb_, jb in zip(_as(tdata, micro), _as(jdata, micro)):
      t.put(tb_)
      j.put(jb)
    assert t.rows == j.rows == 24
    for n in (5, 11, 8):
      assert_batches_equal([t.take(n)], [j.take(n)])
    with pytest.raises(ValueError, match='take'):
      t.take(1)
  with pytest.raises(ValueError, match='column sizes differ'):
    trebatch.RebatchBuffer().put({'a': np.arange(3), 'b': np.arange(4)})


# -- dedup ----------------------------------------------------------------------

def test_deduplicate_and_restore_match_jax():
  rng = np.random.RandomState(13)
  n = 50
  lens = rng.randint(0, 4, n)
  keys = rng.randint(0, 12, n)
  vals = rng.randint(0, 9, int(lens.sum())).astype(np.int64)
  splits = np.concatenate([[0], np.cumsum(lens)])
  x = rng.rand(n).astype(np.float32)
  out = {}
  for mod in (tdata, jdata):
    batch = {'key': keys, 'x': x, 'hist': mod.Value(vals, [splits])}
    d = mod.deduplicate(batch, ['x', 'hist'], 'key')
    r = mod.restore_deduplicated(d, ['x', 'hist'], 'restore_idx')
    k = mod.restore_deduplicated(d, ['x'], 'restore_idx', keep_index=True)
    out[mod] = (d, r, k)
  for got, want in zip(out[tdata], out[jdata]):
    assert_batches_equal([got], [want])
  with pytest.raises(KeyError, match='restore_idx'):
    tdata.restore_deduplicated({'x': np.arange(3)}, ['x'], 'restore_idx')


# -- validate -------------------------------------------------------------------

def test_validate_matches_jax(files, tmp_path):
  odd = str(tmp_path / 'odd.parquet')
  pq.write_table(pa.table({'a': np.arange(3, dtype=np.int32),
                           'c': pa.array([[1.0], [], [2.0]]),
                           'z': np.arange(3)}), odd)
  for names in (files['parts'], [files['part0'], odd], [files['glob'], odd]):
    got = tvalidate.validate(names)
    assert got == jvalidate.validate(names)
  assert tvalidate.validate(files['parts']) == []
  assert len(tvalidate.validate([files['part0'], odd])) == 4
  run = lambda *a: subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.data.validate', *a],
      capture_output=True, text=True, timeout=120, cwd=ROOT)
  ok, bad = run(*files['parts']), run(files['part0'], odd)
  assert ok.returncode == 0 and 'OK' in ok.stdout
  assert bad.returncode == 1 and 'INCONSISTENT' in bad.stderr


# -- reader batches into the input paths, on the CPU -------------------------

def test_read_only_batches_place_without_a_warning(files):
  batches = list(tdata.ParquetDataset(files['part0'], fields=['a', 'b'],
                                      batch_size=64, native=False))
  batches[0] = {k: np.asarray(v) for k, v in batches[0].items()}
  for b in batches:
    for v in b.values():
      v.flags.writeable = False
  with warnings.catch_warnings():
    warnings.simplefilter('error')
    placed = [hbt.put_batch(b, CPU) for b in batches]
    staged = list(hbt.DeviceIterator(iter(batches), CPU))
  for p, s, b in zip(placed, staged, batches):
    for k, v in b.items():
      np.testing.assert_array_equal(p[k].numpy(), v)
      np.testing.assert_array_equal(s[k].numpy(), v)


@pytest.mark.parametrize('column', ['ragged', 'strings'])
def test_ragged_or_string_columns_are_refused_naming_parse(files, column):
  fields = ['a', 'c'] if column == 'ragged' else ['id', 's']
  key = 'part0' if column == 'ragged' else 'kinds'
  batch = next(iter(tdata.ParquetDataset(files[key], fields=fields,
                                         batch_size=8, native=False)))
  with pytest.raises(TypeError, match='parse'):
    hbt.put_batch(batch, CPU)
  it = hbt.DeviceIterator(iter([batch]), CPU)
  with pytest.raises(TypeError, match='parse'):
    next(it)
  it.close()
  parsed = tdata.parse({k: v for k, v in batch.items() if k != 's'},
                       tdata.ParquetDataset(files[key]).fields)
  assert all(t.shape[0] == 8 for t in hbt.put_batch(parsed, CPU).values())


def test_prefetch_combinator_places_batches(files):
  ds = tdata.ParquetDataset(files['part1'], fields=['a', 'b'], batch_size=50,
                            native=False)
  got = list(ds.map(lambda b: {**b, 'a': np.asarray(b['a']) + 1})
             .prefetch(CPU, capacity=1))
  want = list(ds)
  assert len(got) == len(want) == 6
  for g, w in zip(got, want):
    assert isinstance(g['a'], torch.Tensor)
    np.testing.assert_array_equal(g['a'].numpy(), np.asarray(w['a']) + 1)
