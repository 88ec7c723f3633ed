"""The slice end to end on the CPU: a Parquet file through each package's
``ParquetDataset`` into its ``SparseTrainer``; and the port's e2e harness.

The slice: one small Criteo-shaped file (the port's
``examples/criteo/train.py`` synthesis at 4 tables of vocab 1000, 13
dense columns, 512 rows) trains DCNv2 (dim 8, MLP 32-16-1) with
row-sparse Adagrad 0.05 for 4 steps of 64 shuffled rows in each package,
each reading through its own ``ParquetDataset`` (the Python readers,
which give the same batches bit for bit, also shuffled), from the JAX
trainer's initial state; then both evaluate the file in order. Tables,
accumulators and tower weights are held at ``tests/test_torch_trainer.py``'s
tolerances (``rtol = 1e-5, atol = 2e-6``: the same f32 math with matmuls
and duplicate-row sums in other orders), the train loss at ``rtol =
1e-5``, and the evaluation AUC must be equal.

The harness: ``python -m hybridbackend_tpu_torch.benchmarks.e2e_benchmark
--python-reader --device cpu`` at a tiny shape, in-process and as a
module, its JSON line parsed; its times here are host-clock CPU times,
which the tests do not read. ``tests/test_torch_native_data.py`` runs it
through the native reader.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow.parquet as pq
import pytest
import torch

from hybridbackend_tpu.data import ParquetDataset as JParquetDataset
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.estimator import SparseTrainer as JSparseTrainer
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import (
    stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.native import tabular as jtabular

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.benchmarks import e2e_benchmark as e2e
from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb
from hybridbackend_tpu_torch.examples.criteo import train as criteo

TABLES, VOCAB, DIM, DENSE, BATCH, STEPS, ROWS = 4, 1000, 8, 13, 64, 4, 512
MLP = [32, 16, 1]
TOL = dict(rtol=1e-5, atol=2e-6)
CPU = torch.device('cpu')
DENSE_NAMES = [f'i{d}' for d in range(DENSE)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def criteo_file(tmp_path_factory):
  path = str(tmp_path_factory.mktemp('torch_e2e') / 'criteo.parquet')
  criteo.synthesize(path, ROWS, [VOCAB] * TABLES, DENSE)
  return path


def _jbce(p, y):
  p = jnp.clip(p, 1e-6, 1 - 1e-6)
  pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
  return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}


def _datasets(path, pkg, shuffle):
  kw = dict(batch_size=BATCH, drop_remainder=True, shuffle=shuffle)
  if pkg == 'jax':
    return JParquetDataset(path, **kw)
  return hbt.ParquetDataset(path, native=False, **kw)


def test_slice_from_a_parquet_file_matches_jax(criteo_file, monkeypatch):
  monkeypatch.setattr(jtabular, 'available', lambda: False)
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  widths = [DIM] * TABLES + [1] * DENSE
  with context_scope(ctx):
    jfx = JStackedFeatureExtractor(
        [JEmbeddingSpec(JTableConfig(f'c{t}', VOCAB, DIM))
         for t in range(TABLES)], dense_columns=DENSE_NAMES, ctx=ctx)
    jtr = JSparseTrainer(
        jfx, lambda p, e, d, b: _jbce(stacked_dcn_v2_apply(p, e + d),
                                      b['label']),
        stacked_dcn_v2_init(jax.random.PRNGKey(1), widths, MLP),
        dense_optimizer=optax.adam(1e-3), table_lr=0.05, adagrad_init=0.1,
        ctx=ctx, rng=jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jtr.state)
    jm = jtr.train(iter(_datasets(criteo_file, 'jax', True)),
                   max_steps=STEPS)
    want = jax.tree.map(np.asarray, jtr.state)
    jres = jtr.evaluate(iter(_datasets(criteo_file, 'jax', False)))

  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(hbt.TableConfig(f'c{t}', VOCAB, DIM))
       for t in range(TABLES)], dense_columns=DENSE_NAMES,
      ctx=hbt.Context(CPU))
  tower = hbt.StackedDCNv2(widths, MLP)
  state = hbt.from_jax(fx, init.tables,
                       {k: v.acc for k, v in init.table_opt.items()},
                       tower, init.dense,
                       functools.partial(torch.optim.Adam, lr=1e-3))
  tr = hbt.SparseTrainer(
      fx, lambda t, e, d, b: tb.bce(
          t(e + d), b['label']), state.dense, tables=state.tables)
  train_it = iter(_datasets(criteo_file, 'port', True))
  assert train_it.reader == 'python'
  m = tr.train(train_it, max_steps=STEPS)
  assert tr.global_step == STEPS == int(want.step)
  np.testing.assert_allclose(m['loss'], jm['loss'], rtol=1e-5)
  for name, table in tr.state.tables.items():
    rows = table.shape[0]        # the JAX layout's padding rows dropped
    np.testing.assert_allclose(table.numpy(),
                               want.tables[name].reshape(-1, DIM)[:rows],
                               **TOL)
    np.testing.assert_allclose(
        tr.state.table_opt[name].acc[0].numpy(),
        want.table_opt[name].acc[0].reshape(-1, DIM)[:rows], **TOL)
    # The file's batches touched the table: it moved.
    assert not np.array_equal(table.numpy(),
                              init.tables[name].reshape(-1, DIM)[:rows])
  for p, w in hbt.convert._pairs(tr.state.dense, want.dense):
    np.testing.assert_allclose(p.detach().numpy(), w.numpy(), **TOL)
  res = tr.evaluate(iter(_datasets(criteo_file, 'port', False)))
  assert res['batches'] == jres['batches'] == ROWS // BATCH
  assert res['auc'] == jres['auc']
  np.testing.assert_allclose(res['loss'], jres['loss'], rtol=1e-5)


def test_the_file_is_the_jax_harness_file(tmp_path, monkeypatch):
  """``ensure_file`` at the JAX harness's widths and a small row count:
  the JAX harness's ``ensure_file`` values, columns and dtypes, the
  dictionary on the dense columns and the label only, snappy, row groups
  of 32768; written once, under one name, and cached."""
  import importlib.util
  monkeypatch.setenv('HB_BENCH_CACHE', str(tmp_path))
  spec = importlib.util.spec_from_file_location(
      'jax_e2e_benchmark', os.path.join(ROOT, 'benchmarks',
                                        'e2e_benchmark.py'))
  jax_e2e = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(jax_e2e)
  path = e2e.ensure_file(40000)
  assert e2e.ensure_file(40000) == path                  # cached
  want = pq.read_table(jax_e2e.ensure_file(40000))
  got = pq.read_table(path)
  assert got.schema.names == want.schema.names
  for name in want.schema.names:
    assert got.column(name).type == want.column(name).type
    np.testing.assert_array_equal(got.column(name).to_numpy(),
                                  want.column(name).to_numpy())
  f = pq.ParquetFile(path)
  assert f.num_row_groups == 2
  rg = f.metadata.row_group(0)
  dict_cols = {rg.column(i).path_in_schema for i in range(rg.num_columns)
               if 'RLE_DICTIONARY' in rg.column(i).encodings
               or 'PLAIN_DICTIONARY' in rg.column(i).encodings}
  assert dict_cols == {f'i{d}' for d in range(13)} | {'label'}
  assert rg.column(0).compression == 'SNAPPY'
  assert sorted(os.listdir(tmp_path)) == sorted(
      [os.path.basename(path), 'e2e_criteo_40000.parquet'])


def test_the_file_is_cached_under_tmpdir_by_shape_seed_and_draws(
    tmp_path, monkeypatch):
  """Without ``HB_BENCH_CACHE`` the file goes to the temporary directory
  (``TMPDIR``), and its name tells apart every input of its values: the
  shape, the seed and the version of the draws."""
  import tempfile
  monkeypatch.delenv('HB_BENCH_CACHE', raising=False)
  monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
  path = e2e.ensure_file(1000, tables=2, dense_features=1, vocab=50)
  assert os.path.dirname(path) == str(tmp_path / 'hbtpu_torch_bench')
  assert os.path.basename(path) == (
      f'e2e_criteo_1000_2c_1i_50_seed0_draws{e2e.DRAWS}.parquet')
  other = e2e.ensure_file(1000, tables=2, dense_features=1, vocab=50, seed=1)
  assert other != path
  assert not np.array_equal(pq.read_table(path).column('c0').to_numpy(),
                            pq.read_table(other).column('c0').to_numpy())
  assert sorted(os.listdir(tmp_path / 'hbtpu_torch_bench')) == sorted(
      os.path.basename(p) for p in (path, other))


SHAPE = ['--device', 'cpu', '--batch', '64', '--tables', '2', '--vocab',
         '1000', '--dense-features', '3', '--steps', '64', '--json']


@pytest.mark.parametrize('flags', [[], ['--no-prefetch']],
                         ids=['DeviceIterator', 'put_batch'])
def test_harness_reports_one_json_line(tmp_path, monkeypatch, capsys, flags):
  monkeypatch.setenv('HB_BENCH_CACHE', str(tmp_path))
  assert e2e.main(SHAPE + ['--python-reader'] + flags) == 0
  (line,) = capsys.readouterr().out.strip().splitlines()
  got = json.loads(line)
  assert got['reader'] == 'python'
  assert got['fetches'] >= e2e.MIN_FETCHES and got['steps'] == 64
  assert got['file_batches'] == 64 and got['file_rows'] == 64 * 64
  assert got['e2e_ms_per_step'] > 0 and got['step_only_ms'] > 0
  assert got['e2e_vs_step_only'] == pytest.approx(
      got['e2e_ms_per_step'] / got['step_only_ms'])
  assert got['e2e_examples_per_s'] == pytest.approx(
      64 / got['e2e_ms_per_step'] * 1e3)
  assert len(got['reader_rows_per_s_epochs']) == 3
  assert got['reader_rows_per_s'] == sorted(
      got['reader_rows_per_s_epochs'])[1]
  if flags:
    assert got['input'] == 'put_batch' and got['stall_fraction'] is None
  else:
    assert got['input'] == 'DeviceIterator' and got['prefetch'] == 2
    assert 0 <= got['stall_fraction'] <= 1
  # On the CPU the step runs no kernel of the port.
  assert set(got['kernel_launches']) == set(
      tb.COUNTED)
  assert not any(got['kernel_launches'].values())
  assert got['card'] is None and got['timing'] == 'host clock'


@pytest.mark.parametrize('flags,why', [
    (['--device', 'cpu', '--steps', '63'], 'at least 64'),
])
def test_harness_refuses_too_few_fetches(capsys, flags, why):
  assert e2e.main(flags) != 0
  assert why in capsys.readouterr().err


def test_harness_needs_a_card_unless_asked_for_the_cpu(capsys, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  assert e2e.main([]) != 0
  assert 'no CUDA device' in capsys.readouterr().err


def test_harness_runs_as_a_module(tmp_path):
  out = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.benchmarks.'
       'e2e_benchmark', *SHAPE, '--python-reader'],
      capture_output=True, text=True, timeout=300, cwd=ROOT,
      env={**os.environ, 'HB_BENCH_CACHE': str(tmp_path),
           'OMP_NUM_THREADS': '1'})
  assert out.returncode == 0, out.stderr
  got = json.loads(out.stdout.strip().splitlines()[-1])
  assert got['reader'] == 'python' and got['steps'] == 64
