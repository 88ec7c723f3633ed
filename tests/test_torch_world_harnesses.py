"""The entry points and the harnesses at a world of two CPU ranks, each as a
user runs it: ``python -m hybridbackend_tpu_torch.run --simulate 2
--device cpu -m <module> --device cpu ...``, one torch thread a rank, at
tiny shapes. The launches run four at a time while this process makes the
worlds of one they are held against.

* ``examples/criteo/train.py``: ``--sparse --lookup alltoall`` and
  ``--cached 256 --lookup allgather`` from one file in row groups of one
  rank's batch, in file order (``--no-shuffle``), so that the world's
  global batches are a world of one's batches of twice the rows. Its
  printed loss and AUC are the world of one's, and its bundle (rank 0
  writes it; of ``--cached``, from rank 0's storage) serves a batch as
  the world of one's does, to ``test_torch_sharded_trainer.py``'s
  prediction tolerance. A file with fewer row groups than ranks is
  refused, with both counts. The vocabularies divide by the world
  (``--vocab 1024``): a member that a world pads takes more draws of the
  seeded generator, and then the two worlds start from other weights.
* ``examples/taobao/train_din.py --sparse --lookup alltoall``: it trains
  and evaluates on its ranks' row groups.
* ``benchmarks/e2e_benchmark.py`` and ``serving_benchmark.py``: each
  prints one JSON line on rank 0 with the world, the strategy and the
  backend; the served predictions of the world are the bundle's.
* ``benchmarks/embedding_benchmark.py``: every strategy's forward checked
  against the world of one's ``index_select``, the JAX columns, the JSON;
  ``collective_benchmark.py``: the JAX columns, the JSON, and a bf16 wire
  that puts half of float32's bytes on it.
* ``benchmarks/stress_sync_eval.py`` and ``stress_e2e_launch.py``: one
  iteration each, clean. They and the embedding and collective harnesses
  run on the card unless asked, and refuse without one.
* ``benchmarks/auc_parity.py`` at ``test_torch_harnesses.py``'s
  ``AUC_SHAPE`` with ``fast`` and ``fast_overflow``: the fallbacks fire
  and the verdict holds.
"""

import concurrent.futures
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.examples.criteo import train as criteo
from test_torch_harnesses import AUC_SHAPE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_S = 240
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
CRITEO = ['--rows', '1024', '--vocab', '1024', '--dim', '8', '--steps', '6',
          '--no-shuffle', '--python-reader']
TINY = ['--tables', '2', '--vocab', '1000', '--dense-features', '3']


def _module(name):
  return ('hybridbackend_tpu_torch.examples.' + name if '.' in name
          else 'hybridbackend_tpu_torch.benchmarks.' + name)


def _launch(cmd, env):
  try:
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=LAUNCH_S, cwd=ROOT, env=env)
    return out.returncode, out.stdout, out.stderr
  except subprocess.TimeoutExpired as e:
    return 'timeout', str(e.stdout), str(e.stderr)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """Every launch's ``(rc, stdout, stderr)`` by name, and the worlds of
  one."""
  tmp = tmp_path_factory.mktemp('world_harnesses')
  data = str(tmp / 'criteo.parquet')
  vocabs = criteo.vocabs(criteo.parse_args(['--vocab', '1024']))
  criteo.synthesize(data, 1024, vocabs, row_group=32)
  small = str(tmp / 'one_group.parquet')
  criteo.synthesize(small, 256, vocabs)
  world = ['--device', 'cpu']
  launches = {
      'criteo_sparse': ('criteo.train', [
          *world, '--data', data, '--batch-size', '32', '--sparse',
          '--lookup', 'alltoall', '--export', str(tmp / 'w_sparse'),
          '--export-poly', *CRITEO]),
      'criteo_cached': ('criteo.train', [
          *world, '--data', data, '--batch-size', '32', '--cached', '256',
          '--lookup', 'allgather', '--export', str(tmp / 'w_cached'),
          '--export-poly', *CRITEO]),
      'criteo_small': ('criteo.train', [
          *world, '--data', small, '--batch-size', '32', '--sparse',
          *CRITEO]),
      'taobao': ('taobao.train_din', [
          *world, '--synthesize', '--data', str(tmp / 'taobao.parquet'),
          '--rows', '1024', '--batch-size', '32', '--dim', '8', '--steps',
          '4', '--sparse', '--lookup', 'alltoall']),
      'e2e': ('e2e_benchmark', [
          *world, '--batch', '64', *TINY, '--steps', '64', '--json',
          '--python-reader', '--lookup', 'alltoall']),
      'serving': ('serving_benchmark', [
          *world, *TINY, '--sizes', '4', '32', '--inner', '2', '--repeats',
          '2', '--cases', 'f32', 'int8', '--json', '--lookup', 'alltoall']),
      'embedding': ('embedding_benchmark', [
          *world, '--vocab', '10000', '--dim', '16', '--batch', '512',
          '--steps', '3']),
      'embedding_json': ('embedding_benchmark', [
          *world, '--vocab', '10000', '--dim', '16', '--batch', '512',
          '--steps', '3', '--json']),
      'collective': ('collective_benchmark', [
          *world, '--sizes-mb', '1', '4', '--steps', '3']),
      'collective_bf16': ('collective_benchmark', [
          *world, '--sizes-mb', '1', '4', '--steps', '3', '--wire-dtype',
          'bfloat16', '--json']),
      'auc': ('auc_parity', [*world, *AUC_SHAPE, '--json']),
  }
  env = dict(os.environ, OMP_NUM_THREADS='1',
             HB_BENCH_CACHE=str(tmp / 'bench'))
  cmds = {name: [sys.executable, '-m', 'hybridbackend_tpu_torch.run',
                 '--simulate', '2', '--device', 'cpu', '-m', _module(mod),
                 *flags] for name, (mod, flags) in launches.items()}
  cmds['stress_sync'] = [sys.executable, '-m', _module('stress_sync_eval'),
                         '1', '--device', 'cpu', '--timeout',
                         str(LAUNCH_S - 30)]
  cmds['stress_e2e'] = [sys.executable, '-m', _module('stress_e2e_launch'),
                        '1', '--no-burner', '--device', 'cpu', '--timeout',
                        str(LAUNCH_S - 30), '--keep', str(tmp / 'anomalies')]
  with concurrent.futures.ThreadPoolExecutor(4) as pool:
    futures = {name: pool.submit(_launch, cmd, env)
               for name, cmd in cmds.items()}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
      ones = {case: _criteo_one(data, tmp, case) for case in
              ('sparse', 'cached')}
    finally:
      torch.set_num_threads(n)
    out = {name: f.result() for name, f in futures.items()}
  return dict(out=out, ones=ones, tmp=tmp, data=data)


def _criteo_one(data, tmp, case):
  """The world of one of a Criteo launch: batches of two ranks' rows;
  its printed lines and its bundle."""
  flag = ['--sparse'] if case == 'sparse' else ['--cached', '256']
  args = criteo.parse_args(['--device', 'cpu', '--data', data,
                            '--batch-size', '64', '--export',
                            str(tmp / f'one_{case}'), '--export-poly', *flag,
                            *CRITEO])
  import contextlib
  import io
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    criteo.run(args)
  return buf.getvalue()


def _ok(runs, name):
  rc, stdout, stderr = runs['out'][name]
  assert rc == 0, (name, rc, stdout[-2000:], stderr[-3000:])
  return stdout


def _json(stdout):
  return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.timeout(2 * LAUNCH_S + 120)
@pytest.mark.parametrize('case', ['sparse', 'cached'])
def test_criteo_at_two_ranks_is_the_world_of_one(runs, case):
  stdout = _ok(runs, f'criteo_{case}')
  eval_line = re.compile(r'epoch 0: (loss=\S+ auc=\S+),')
  got = eval_line.findall(stdout.replace(', auc', ' auc'))
  want = eval_line.findall(runs['ones'][case].replace(', auc', ' auc'))
  assert got and got == want, (stdout, runs['ones'][case])
  assert stdout.count('exported serving bundle') == 1   # rank 0 alone
  tmp = runs['tmp']
  args = criteo.parse_args(['--device', 'cpu', '--data', runs['data'],
                            '--batch-size', '64', *CRITEO])
  batch = next(criteo.batches(args, False))
  preds = [hbt.Served(str(tmp / f'{w}_{case}'), 'cpu').predict(batch)
           for w in ('w', 'one')]
  np.testing.assert_allclose(preds[0], preds[1], **PRED_TOL)


@pytest.mark.timeout(2 * LAUNCH_S + 120)
def test_criteo_refuses_a_file_with_too_few_row_groups(runs):
  rc, _, stderr = runs['out']['criteo_small']
  assert rc != 0
  assert 'has 1 row groups, fewer than the 2 ranks' in stderr, stderr[-2000:]


@pytest.mark.timeout(2 * LAUNCH_S + 120)
def test_taobao_trains_on_two_ranks(runs):
  stdout = _ok(runs, 'taobao')
  (line,) = [l for l in stdout.splitlines() if l.startswith('epoch 0:')]
  got = eval(line.split(':', 1)[1])          # the dict evaluate returns
  assert 0.0 < got['auc'] < 1.0 and np.isfinite(got['loss'])
  assert got['batches'] == 16.0 and 'gauc' in got


@pytest.mark.timeout(2 * LAUNCH_S + 120)
@pytest.mark.parametrize('name', ['e2e', 'serving'])
def test_harness_reports_its_world(runs, name):
  got = _json(_ok(runs, name))
  assert (got['world'], got['lookup'], got['backend']) == (
      2, 'alltoall', 'gloo')
  if name == 'e2e':
    assert np.isfinite(got['final_loss']) and got['steps'] == 64
    assert got['row_group'] == 64 * 64 // 2
    return
  for case in ('f32', 'int8'):
    for size in ('4', '32'):
      entry = got[f'flagship_{case}']['batches'][size]
      assert entry['max_abs_vs_bundle'] <= 1e-6, (case, size, entry)
      assert entry['sharded_ms'] > 0


@pytest.mark.timeout(2 * LAUNCH_S + 120)
def test_embedding_benchmark_checks_then_times_each_strategy(runs):
  table = _ok(runs, 'embedding').splitlines()
  header = next(i for i, l in enumerate(table) if l.startswith('Strategy'))
  assert table[header].split() == ['Strategy', 'Mode', 'ms', 'GB/s']
  rows = [l.split() for l in table[header + 1:]]
  assert [r[:2] for r in rows[:-1]] == [
      [s, m] for s in ('allgather', 'alltoall', 'gspmd')
      for m in ('fwd', 'fwd+bwd')]
  assert rows[-1][0] == 'partition' and rows[-1][-1] == 'Mids/s'
  got = _json(_ok(runs, 'embedding_json'))
  assert got['checked'] == {'allgather': True, 'alltoall': True,
                            'gspmd': True}
  assert got['world'] == 2 and got['backend'] == 'gloo'
  assert all(r['ms'] > 0 and r['gb_s'] > 0 for r in got['rows'])


@pytest.mark.timeout(2 * LAUNCH_S + 120)
def test_collective_benchmark_counts_the_wire(runs):
  table = _ok(runs, 'collective').splitlines()
  header = next(i for i, l in enumerate(table) if l.startswith('Collective'))
  assert table[header].split() == ['Collective', 'Size(MB)', 'ms',
                                   'GB/s(algo)', 'wire', 'MB']
  f32 = {(r[0], float(r[1])): float(r[4]) for r in
         (l.split() for l in table[header + 1:])}
  got = _json(_ok(runs, 'collective_bf16'))
  assert got['world'] == 2 and got['wire_dtype'] == 'bfloat16'
  assert len(got['rows']) == len(f32) == 8
  for r in got['rows']:
    want = f32[(r['collective'], r['size_mb'])] / 2
    assert r['wire_mb'] == pytest.approx(want, rel=1e-3), r
  one = {r['collective']: r['wire_mb'] for r in got['rows']
         if r['size_mb'] == 4}
  # The ring counts on 4 MB, 2 MB a rank, 1 MB of it in bf16.
  assert one == pytest.approx({'allreduce': 1.0, 'alltoall': 0.5,
                               'allgather': 1.0, 'reducescatter': 0.5},
                              rel=1e-3)


@pytest.mark.timeout(2 * LAUNCH_S + 120)
@pytest.mark.parametrize('name', ['stress_sync', 'stress_e2e'])
def test_stress_harness_runs_one_clean_iteration(runs, name):
  stdout = _ok(runs, name)
  if name == 'stress_sync':
    assert 'ITER 0: ok' in stdout and 'ALL 1 CLEAN' in stdout
  else:
    assert 'iter 0: rc=0 finals=2 files=2 OK' in stdout
    assert 'done: 0/1 anomalous' in stdout


@pytest.mark.parametrize('rows,default,world,want', [
    (4096, 32768, 1, 32768), (4096, 32768, 2, 2048), (9, 8192, 4, 2),
    (100, 40, 3, 40), (1024, 8192, 2, 512)])
def test_row_group_for_leaves_every_rank_a_group(rows, default, world, want):
  from hybridbackend_tpu_torch.benchmarks.train_benchmark import (
      row_group_for)
  got = row_group_for(rows, default, world)
  assert got == want and -(-rows // got) >= world


@pytest.mark.parametrize('name', ['stress_sync_eval', 'stress_e2e_launch',
                                  'embedding_benchmark',
                                  'collective_benchmark'])
def test_harness_runs_on_the_card_unless_asked(name, monkeypatch, capsys):
  import importlib
  harness = importlib.import_module(_module(name))
  assert harness.parse_args([]).device == 'cuda'
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  assert harness.main([]) == 1
  assert 'no CUDA device; pass --device cpu' in capsys.readouterr().err


@pytest.mark.timeout(2 * LAUNCH_S + 120)
def test_auc_parity_overflow_fallbacks_fire_at_two(runs):
  got = _json(_ok(runs, 'auc'))
  assert got['world'] == 2
  assert set(got['results']) == {'exact_seed0', 'exact_seed1', 'fast',
                                 'fast_overflow'}
  assert got['parity_ok'] == {'fast': True, 'fast_overflow': True}
  over = got['results']['fast_overflow']
  assert over['fallbacks'] > 0 and over['overflow_must_fire']
  assert over['options']['unique_ratio'] == 0.05
  assert got['results']['fast']['options'] == {
      'wire_dtype': 'bfloat16', 'gradient_wire_dtype': 'bfloat16'}
