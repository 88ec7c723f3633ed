"""The port's native Parquet reader against the JAX package's, on the CPU.

Every case of ``tests/test_torch_data.py``'s ``CASES`` (dense, ragged
rank-1 and rank-2, string and null columns; several files and globs;
ORC; ``batch_size`` and ``drop_remainder``; ``shuffle`` with a seed;
file and row-group partitioning; ``restore_columns``; the combinators)
goes through the port's ``ParquetDataset`` with its default reader choice
and through the JAX package's, whose native reader is on: the batches
are held bit for bit, and the port's iterator says which reader served
and, where the native reader cannot, why. Then the native reader's own
cases, as ``tests/test_native_data.py`` checks them for the JAX package:
read-only zero-copy arrays, buffers that outlive the iterator, fallbacks
and the explicit switch; the build under a temporary name of its own
(the JAX package's shared ``.tmp`` name raced between processes); and
the two entry points that read through it by default, the e2e harness
and the Criteo example, at a tiny shape on the CPU.

All of them live in this one file, so that one test process builds the
native library (and the JAX package's, at the same time).
"""

import contextlib
import ctypes
import gc
import io
import json
import logging
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from hybridbackend_tpu.native import tabular as jtabular

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch import data as tdata
from hybridbackend_tpu_torch.benchmarks import e2e_benchmark as e2e
from hybridbackend_tpu_torch.examples.criteo import train as criteo
from hybridbackend_tpu_torch.native import tabular

from test_torch_data import CASE_IDS, CASES, assert_batches_equal, read
from test_torch_data import write_files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The cases the native reader cannot serve, and a word of the reason.
FALLBACKS = {'restore': 'restore_columns', 'rank3': 'ragged rank 3',
             'list-of-strings': 'list of strings', 'type-drift': 'large_string'}


@pytest.fixture(autouse=True)
def one_thread():
  """Torch's CPU math on one thread: the harness's and the example's
  steps are tiny here, and a test run puts several test processes on one
  host, where each process's worker threads would wait on the others'."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
  # Both packages' native libraries build at once, before any case.
  port = threading.Thread(target=tabular.load)
  port.start()
  assert jtabular.available()
  port.join()
  return write_files(str(tmp_path_factory.mktemp('torch_native_data')))


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
def test_native_reader_matches_jax(files, case):
  name, key, kwargs, _ = case
  got = read('port', case, files)
  want = read('jax', case, files)
  assert want
  assert_batches_equal(got, want)
  fmt = kwargs.get('format', 'parquet')
  kw = {k: v for k, v in kwargs.items() if k != 'format'}
  it = iter(tdata.ParquetDataset(files[key], format=fmt, **kw))
  if name in FALLBACKS:
    assert it.reader == 'python'
    assert FALLBACKS[name] in it.fallback_reason
  else:
    assert it.reader == 'native' and it.fallback_reason is None
  it.close()


@pytest.mark.parametrize('name', sorted(FALLBACKS))
def test_fallbacks_are_logged_and_refused_on_request(files, caplog, name):
  _, key, kwargs, _ = CASES[CASE_IDS.index(name)]
  with caplog.at_level(logging.WARNING, 'hybridbackend_tpu_torch'):
    it = iter(tdata.ParquetDataset(files[key], **kwargs))
  assert it.reader == 'python'
  assert any(FALLBACKS[name] in r.getMessage() for r in caplog.records)
  with pytest.raises(ValueError, match=FALLBACKS[name]):
    iter(tdata.ParquetDataset(files[key], native=True, **kwargs))


def test_native_switch(files):
  on = iter(tdata.ParquetDataset(files['part0'], batch_size=64, native=True))
  off = iter(tdata.ParquetDataset(files['part0'], batch_size=64,
                                  native=False))
  assert (on.reader, off.reader) == ('native', 'python')
  assert_batches_equal(list(on), list(off))


def test_zero_copy_arrays_are_read_only(files):
  batch = next(iter(tdata.ParquetDataset(files['part0'], batch_size=64,
                                         native=True)))
  for arr in (batch['a'], batch['c'].values, batch['c'].row_splits[0]):
    with pytest.raises(ValueError):
      arr[0] = 42


def test_buffers_outlive_the_iterator(files):
  ds = tdata.ParquetDataset(files['part0'], batch_size=50,
                            drop_remainder=True, native=True)
  it = iter(ds)
  kept = [next(it) for _ in range(3)]
  snapshot = [(b['a'].copy(), b['c'].values.copy()) for b in kept]
  it.close()
  del it, ds
  gc.collect()
  for b, (a, c) in zip(kept, snapshot):
    np.testing.assert_array_equal(b['a'], a)
    np.testing.assert_array_equal(b['c'].values, c)
    assert b['c'].values.size == b['c'].row_splits[0][-1]
  with pytest.raises(StopIteration):
    closed = iter(tdata.ParquetDataset(files['part0'], batch_size=50,
                                       native=True))
    closed.close()
    next(closed)


def test_native_batches_place_with_their_token_alive(files):
  it = iter(tdata.ParquetDataset(files['part1'], fields=['a', 'b'],
                                 batch_size=64, native=True))
  placed = [hbt.put_batch(b, torch.device('cpu')) for b in it]
  it.close()
  del it
  gc.collect()
  want = np.arange(1000, 1260)
  got = np.concatenate([p['a'].numpy() for p in placed])
  np.testing.assert_array_equal(got, want)


def test_arrow_toolchain_names_what_it_found():
  flags, what = tabular.arrow_toolchain()
  assert flags is not None
  assert 'libarrow' in what and 'libparquet' in what and 'headers' in what


def test_concurrent_builds_each_finish_with_a_whole_library(tmp_path):
  """Eight builds of one library into one file name at once: each writes
  a temporary name of its own, so each finishes and leaves a library that
  loads, and no temporary file stays behind."""
  src = tmp_path / 'f.cc'
  src.write_text('extern "C" int hb_answer() { return 42; }\n')
  out = tmp_path / 'build' / 'libf.so'
  results, errors = [], []

  def one():
    try:
      results.append(tabular.build(src, out, []))
    except Exception as e:  # noqa: BLE001 — reported below
      errors.append(e)
  threads = [threading.Thread(target=one) for _ in range(8)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=120)
    assert not t.is_alive()
  assert not errors and len(results) == 8
  assert ctypes.CDLL(str(out)).hb_answer() == 42
  assert os.listdir(out.parent) == ['libf.so']
  assert tabular.build(src, out, []) == 0.0        # reused, not rebuilt


def test_a_failed_build_says_why(tmp_path):
  src = tmp_path / 'bad.cc'
  src.write_text('this is not C++\n')
  with pytest.raises(tabular.NativeUnavailable, match='g\\+\\+ failed'):
    tabular.build(src, tmp_path / 'libbad.so', [])
  assert os.listdir(tmp_path) == ['bad.cc']


# -- the entry points, through the native reader --------------------------------

TINY = ['--device', 'cpu', '--batch', '64', '--tables', '2', '--vocab',
        '1000', '--dense-features', '3', '--steps', '64', '--json']


@pytest.mark.parametrize('flags', [[], ['--no-prefetch']],
                         ids=['DeviceIterator', 'put_batch'])
def test_e2e_harness_reads_through_the_native_reader(tmp_path, monkeypatch,
                                                     capsys, flags, files):
  monkeypatch.setenv('HB_BENCH_CACHE', str(tmp_path))
  assert e2e.main(TINY + flags) == 0
  (line,) = capsys.readouterr().out.strip().splitlines()
  got = json.loads(line)
  assert got['reader'] == 'native'
  assert got['reader_fallback_reason'] is None
  assert got['fetches'] == 64 and got['steps'] == 64
  assert got['input'] == ('put_batch' if flags else 'DeviceIterator')
  assert (got['stall_fraction'] is None) == bool(flags)
  assert got['epochs_started'] == 2      # 67 fetches from 64 batches
  assert got['file_rows'] == 64 * 64 and got['card'] is None
  assert np.isfinite(got['final_loss'])


def _criteo(argv):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    rc = criteo.main(argv)
  return rc, out.getvalue()


def test_criteo_entry_point_trains_from_its_file(tmp_path, files):
  data = str(tmp_path / 'criteo.parquet')
  tiny = ['--device', 'cpu', '--data', data, '--batch-size', '64',
          '--vocab', '1000', '--dim', '8', '--steps', '4']
  rc, printed = _criteo(tiny + ['--sparse', '--synthesize', '--rows', '512',
                                '--model-dir', str(tmp_path / 'm')])
  assert rc == 0, printed
  assert 'through the native reader' in printed
  m = re.search(r'epoch 0: loss=(\S+), auc=(\S+), (\S+)s, step (\d+)',
                printed)
  assert m and int(m[4]) == 4 and 0 < float(m[2]) <= 1
  assert os.listdir(tmp_path / 'm') == ['checkpoint-4.pt']
  # The file: the JAX example's columns, dtypes and row groups.
  import pyarrow.parquet as pq
  meta = pq.ParquetFile(data)
  assert meta.metadata.num_rows == 512 and meta.num_row_groups == 1
  schema = {f.name: str(f.type) for f in meta.schema_arrow}
  assert schema['c25'] == 'int64' and schema['i12'] == 'float'
  assert schema['label'] == 'float' and len(schema) == 40
  rc, printed = _criteo(tiny + ['--model', 'dlrm'])
  assert rc == 0 and "epoch 0: {'auc':" in printed


@pytest.mark.parametrize('native', [True, False], ids=['native', 'python'])
def test_criteo_file_reads_the_same_through_both_readers(tmp_path, files,
                                                         native):
  """The example's file through each reader: in file order the Python
  reader's batches bit for bit, and a shuffled epoch a permutation of the
  file's rows, each row whole (the check ``chip_smoke.py`` phase 21 makes
  on the card's machine)."""
  data = str(tmp_path / 'criteo.parquet')
  criteo.synthesize(data, 1024, [1000] * 26)

  def rows(shuffle, native):
    it = iter(hbt.ParquetDataset(data, batch_size=128, drop_remainder=True,
                                 shuffle=shuffle, native=native))
    assert it.reader == ('native' if native else 'python')
    batches = list(it)
    names = sorted(batches[0])
    return batches, np.stack([np.concatenate(
        [np.asarray(b[n], np.float64) for b in batches]) for n in names], 1)

  got, _ = rows(False, native)
  want, in_order = rows(False, False)
  assert len(got) == len(want) == 8
  for a, b in zip(got, want):
    assert sorted(a) == sorted(b)
    for k in b:
      assert a[k].dtype == b[k].dtype
      np.testing.assert_array_equal(a[k], b[k])
  _, shuffled = rows(True, native)
  assert not np.array_equal(shuffled, in_order)
  np.testing.assert_array_equal(
      shuffled[np.lexsort(shuffled.T[::-1])],
      in_order[np.lexsort(in_order.T[::-1])])


def test_criteo_entry_point_reads_through_the_python_reader_on_request(
    tmp_path, files):
  data = str(tmp_path / 'criteo.parquet')
  rc, printed = _criteo(['--device', 'cpu', '--data', data, '--batch-size',
                         '64', '--vocab', '1000', '--dim', '8', '--steps',
                         '2', '--sparse', '--synthesize', '--rows', '256',
                         '--python-reader'])
  assert rc == 0, printed
  assert 'through the python reader' in printed
  m = re.search(r'epoch 0: loss=(\S+), auc=(\S+), (\S+)s, step (\d+)',
                printed)
  assert m and int(m[4]) == 2 and 0 < float(m[2]) <= 1


@pytest.mark.parametrize('flag,why', [
    (['--cpu', '4'], 'python -m hybridbackend_tpu_torch.run --simulate N')])
def test_criteo_refuses_what_is_not_ported(capsys, flag, why):
  assert criteo.main(['--device', 'cpu', *flag]) == 1
  err = capsys.readouterr().err
  assert 'not ported' in err and why in err


def test_criteo_takes_a_lookup_strategy_at_a_world_of_one(tmp_path):
  """``--lookup`` (refused until the entry point ran in a world,
  ``test_torch_world_harnesses.py``) is accepted at a world of one,
  where no table is sharded and it changes nothing."""
  data = str(tmp_path / 'criteo.parquet')
  flags = ['--device', 'cpu', '--data', data, '--batch-size', '64',
           '--vocab', '1000', '--dim', '8', '--steps', '2', '--sparse',
           '--rows', '256', '--python-reader']
  rc, printed = _criteo([*flags, '--synthesize', '--lookup', 'alltoall'])
  assert rc == 0, printed
  rc, plain = _criteo(flags)
  line = lambda out: re.search(r'epoch 0: loss=\S+, auc=\S+,', out)[0]
  assert line(printed) == line(plain)


def test_criteo_synthesis_draws_the_jax_example(tmp_path):
  """The file holds the JAX example's draws: its ``synthesize`` (through
  pandas) and the port's (through pyarrow) write the same columns."""
  import importlib.util
  import pyarrow.parquet as pq
  spec = importlib.util.spec_from_file_location(
      'jax_criteo_train', os.path.join(ROOT, 'examples', 'criteo', 'train.py'))
  jax_criteo = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(jax_criteo)
  vocabs = [max(100, 1000 >> (c % 5)) for c in range(26)]
  criteo.synthesize(str(tmp_path / 'port.parquet'), 300, vocabs)
  jax_criteo.synthesize(str(tmp_path / 'jax.parquet'), 300, vocabs)
  got = pq.read_table(tmp_path / 'port.parquet')
  want = pq.read_table(tmp_path / 'jax.parquet')
  assert got.column_names == [n for n in want.column_names
                              if not n.startswith('__')]
  for name in got.column_names:
    assert got.column(name).type == want.column(name).type
    np.testing.assert_array_equal(got.column(name).to_numpy(),
                                  want.column(name).to_numpy())


def test_criteo_runs_as_a_module(tmp_path):
  out = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.examples.criteo.train',
       '--device', 'cpu', '--synthesize', '--data',
       str(tmp_path / 'c.parquet'), '--rows', '256', '--batch-size', '64',
       '--vocab', '500', '--dim', '4', '--steps', '2', '--sparse'],
      capture_output=True, text=True, timeout=300, cwd=ROOT,
      env={**os.environ, 'OMP_NUM_THREADS': '1'})
  assert out.returncode == 0, out.stderr
  assert re.search(r'auc=\S+, \S+s, step 2', out.stdout)
