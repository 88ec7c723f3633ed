"""The port's DIN harness, its Taobao entry point and the serving
harness's DIN case, on the CPU at tiny shapes.

* ``benchmarks/din_benchmark.py`` in its three modes (dense, ``--sparse``,
  ``--sparse --sessions 2``) and dense with sessions: one JSON line each,
  with the JAX harness's keys; its batch holds the JAX harness's draws,
  and each step moves the valid ids and leaves the ``-1`` holes.
* ``examples/taobao/train_din.py`` with ``--sparse``, ``--sparse
  --sessions`` and without ``--sparse``: trains and evaluates with GAUC
  from the file it writes, which holds the values the JAX example's
  ``synthesize`` writes (the JAX one writes through pandas, the port's
  through pyarrow); its parsed batches carry ``cand_hist`` as the JAX
  example builds it.
* ``serving_benchmark.py --cases din`` as a user runs it, with ``python
  -m``.
Times here are host-clock CPU times, which the tests do not read.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from hybridbackend_tpu_torch.benchmarks import din_benchmark as din
from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb
from hybridbackend_tpu_torch.examples.taobao import train_din as taobao

SHAPE = ['--device', 'cpu', '--batch', '32', '--hist', '8', '--vocab',
         '1000', '--dim', '8', '--inner-steps', '3', '--repeats', '2',
         '--json']
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
  """One CPU thread a test, as the other files that train here."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.mark.parametrize('flags', [[], ['--sparse'],
                                   ['--sparse', '--sessions', '2'],
                                   ['--sessions', '2']],
                         ids=['dense', 'sparse', 'sparse-sessions',
                              'dense-sessions'])
def test_din_harness_reports_one_json_line(capsys, flags):
  assert din.main(SHAPE + flags) == 0
  (line,) = capsys.readouterr().out.strip().splitlines()
  got = json.loads(line)
  sparse = '--sparse' in flags
  assert (got['sparse'], got['sessions'], got['device']) == (
      sparse, 2 if '--sessions' in flags else 0, 'cpu')
  assert got['metric'] == 'din_examples_per_sec' and got['card'] is None
  assert got['ms_per_step'] == min(got['ms_per_step_repeats']) > 0
  assert got['din_examples_per_sec'] == pytest.approx(
      32 / got['ms_per_step'] * 1e3)
  assert got['timed_steps'] == 6 and got['torch_din_step_ms'] > 0
  assert np.isfinite(got['final_loss'])
  assert set(got['kernel_launches']) == set(tb.COUNTED)
  # On the CPU the wrappers run their plain versions and count nothing.
  assert not any(got['kernel_launches'].values())
  assert got['adagrad_launches_per_step'] == 0


def test_din_harness_refuses_sessions_that_do_not_divide(capsys):
  assert din.main(SHAPE + ['--sessions', '3']) == 1
  assert 'divide' in capsys.readouterr().err


@pytest.mark.parametrize('flags,world', [
    ([], '2'), (['--gradient-wire-dtype', 'bfloat16'], None)])
def test_din_harness_refuses_the_dense_mode_in_a_world(capsys, monkeypatch,
                                                        flags, world):
  """The dense mode under the launcher, and its gradient wire anywhere,
  pass the harness's checks now (``test_torch_launcher.py`` runs the
  dense mode as a world of two); only ``--wire-dtype``, the sparse
  alltoall lookup's, is refused without ``--sparse``."""
  if world:
    monkeypatch.setenv('WORLD_SIZE', world)
  assert din.unsupported(din.parse_args(SHAPE + flags)) is None
  assert din.main(SHAPE + ['--wire-dtype', 'bfloat16']) == 1
  assert '--wire-dtype' in capsys.readouterr().err


@pytest.mark.parametrize('sessions', [0, 2])
def test_din_harness_batch_is_the_jax_harness_draws(sessions):
  args = din.parse_args(SHAPE + ['--sparse', '--sessions', str(sessions)])
  base, ids, valid = din.make_batch(args, torch.device('cpu'))
  # The JAX harness's draws (benchmarks/din_benchmark.py:137-154).
  rng = np.random.RandomState(0)
  if sessions:
    slen = rng.randint(0, 5, (32, 2))
    slen[:, 0] = np.maximum(slen[:, 0], 1)
    mask = np.arange(4)[None, None, :] < slen[:, :, None]
  else:
    mask = np.arange(8)[None, :] < rng.randint(1, 9, 32)[:, None]
  item = rng.randint(0, 1000, 32)
  hist = rng.randint(0, 1000, (32, 8))
  user = rng.randint(0, 100, 32)
  np.testing.assert_array_equal(base['hist_mask'].numpy(), mask)
  np.testing.assert_array_equal(base['user'].numpy(), user)
  if sessions:
    hist = np.where(mask.reshape(32, -1), hist, -1)
    assert (ids < 0).any()
  np.testing.assert_array_equal(ids.numpy(),
                                np.concatenate([item[:, None], hist], 1))
  np.testing.assert_array_equal(valid.numpy(), (ids >= 0).numpy())
  for i in (0, 1, 999, 1005):
    moved = din.shifted(args, base, ids, valid, i)['cand_hist']
    want = np.where(ids >= 0, (ids.numpy() + i) % 1000, ids.numpy())
    np.testing.assert_array_equal(moved.numpy(), want)


def test_din_harness_dense_batch_views_the_moved_ids():
  args = din.parse_args(SHAPE)
  base, ids, valid = din.make_batch(args, torch.device('cpu'))
  b = din.shifted(args, base, ids, valid, 7)
  np.testing.assert_array_equal(b['item'].numpy(), (ids[:, 0] + 7) % 1000)
  np.testing.assert_array_equal(b['hist'].numpy(), (ids[:, 1:] + 7) % 1000)
  assert 'cand_hist' not in b


def _jax_synthesize():
  spec = importlib.util.spec_from_file_location(
      'jax_train_din', os.path.join(ROOT, 'examples', 'taobao',
                                    'train_din.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.synthesize


@pytest.mark.parametrize('sessions', [False, True])
def test_taobao_synthesis_writes_the_jax_examples_values(tmp_path, sessions):
  _jax_synthesize()(str(tmp_path / 'jax.parquet'), 300, sessions=sessions)
  taobao.synthesize(str(tmp_path / 'port.parquet'), 300, sessions=sessions)
  want = pq.read_table(tmp_path / 'jax.parquet')
  got = pq.read_table(tmp_path / 'port.parquet')
  assert got.schema.names == want.schema.names
  for name in want.schema.names:
    assert got[name].type == want[name].type, name
    assert got[name].to_pylist() == want[name].to_pylist(), name
  assert got.num_rows == 300


@pytest.mark.parametrize('sessions', [False, True])
def test_taobao_batches_carry_cand_hist(tmp_path, sessions):
  path = str(tmp_path / 't.parquet')
  taobao.synthesize(path, 600, sessions=sessions)
  args = taobao.parse_args(['--data', path, '--batch-size', '64',
                            '--sparse', '--device', 'cpu']
                           + ['--sessions'] * sessions)
  b = next(taobao.batches(args, False))
  shape = (64, 4, 32) if sessions else (64, 32)
  assert b['hist'].shape == b['hist_mask'].shape == shape
  assert b['hist_mask'].dtype == np.bool_
  ch = b['cand_hist']
  assert ch.shape == (64, 1 + int(np.prod(shape[1:])))
  np.testing.assert_array_equal(ch[:, 0], b['item'])
  flat_mask = b['hist_mask'].reshape(64, -1)
  np.testing.assert_array_equal(ch[:, 1:][flat_mask],
                                b['hist'].reshape(64, -1)[flat_mask])
  if sessions:
    assert (ch[:, 1:][~flat_mask] == -1).all()


@pytest.mark.parametrize('flags', [['--sparse'], ['--sparse', '--sessions'],
                                   []], ids=['sparse', 'sparse-sessions',
                                             'dense'])
def test_taobao_entry_point_trains_and_evaluates(tmp_path, flags):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    rc = taobao.main(['--device', 'cpu', '--synthesize', '--data',
                      str(tmp_path / 't.parquet'), '--rows', '1200',
                      '--batch-size', '128', '--steps', '4', '--model-dir',
                      str(tmp_path / 'm')] + flags)
  assert rc == 0
  line = [l for l in out.getvalue().splitlines() if l.startswith('epoch 0:')]
  res = ast.literal_eval(line[0][len('epoch 0: '):])
  assert set(res) == {'auc', 'loss', 'batches', 'gauc'}
  assert res['batches'] == 9 and 0 < res['auc'] < 1 and 0 < res['gauc'] < 1
  # The checkpoint of the last step, which a trainer made again restores.
  args = taobao.parse_args(['--device', 'cpu', '--data',
                            str(tmp_path / 't.parquet'), '--batch-size',
                            '128', '--model-dir', str(tmp_path / 'm')]
                           + flags)
  build = taobao.sparse_trainer if '--sparse' in flags else (
      taobao.dense_trainer)
  assert build(args, torch.device('cpu')).global_step == 4


def test_serving_harness_din_case_as_a_user_runs_it():
  cmd = [sys.executable, '-m',
         'hybridbackend_tpu_torch.benchmarks.serving_benchmark', '--device',
         'cpu', '--cases', 'din', '--sizes', '16', '--inner', '2',
         '--repeats', '2', '--json']
  out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       check=True, timeout=300)
  got = json.loads(out.stdout.strip().splitlines()[-1])
  r = got['din_ragged']
  assert set(r['batches']) == {'16'} and r['export_s'] > 0
  assert r['gather_launches_per_predict'] == 0
