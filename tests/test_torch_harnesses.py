"""The port's single-device harnesses on the CPU at tiny shapes, each as a
user runs it (``python -m``, in a process of its own, one torch thread):

* ``benchmarks/auc_parity.py``: the JAX harness's data (its
  ``synthesize`` draws, the same bytes of every column), the exact dense
  ``Trainer`` at two seeds against the sparse fast path, the verdict and
  the exit code, ``fast_overflow`` named as not ported, ``--cpu N``
  refused;
* ``benchmarks/data_benchmark.py``: ``parquet`` (both readers), ``csv``,
  ``dedup``, each with its line and its JSON line; ``transfer`` refuses
  without a card;
* ``benchmarks/e2e_benchmark.py --profile``: one stderr line a batch
  with the five stages, and their medians in the JSON line.

Their times are host-clock CPU times, which the tests do not read.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'benchmarks'))

import auc_parity as jax_auc_parity  # noqa: E402  the JAX harness

from hybridbackend_tpu_torch.benchmarks import auc_parity  # noqa: E402
from hybridbackend_tpu_torch.benchmarks import data_benchmark  # noqa: E402
from hybridbackend_tpu_torch.benchmarks import e2e_benchmark  # noqa: E402

AUC_SHAPE = ['--rows', '8192', '--eval-rows', '2048', '--tables', '4',
             '--vocab', '2048', '--dim', '8', '--batch', '512']


def _run(module, *flags, cache):
  return subprocess.run(
      [sys.executable, '-m', f'hybridbackend_tpu_torch.benchmarks.{module}',
       *flags], capture_output=True, text=True, timeout=300, cwd=ROOT,
      env={**os.environ, 'HB_BENCH_CACHE': str(cache),
           'OMP_NUM_THREADS': '1'})


def test_synthesize_writes_the_jax_harness_data(tmp_path):
  port, ref = tmp_path / 'port.parquet', tmp_path / 'jax.parquet'
  auc_parity.synthesize(str(port), 3000, 4, 500, seed=11)
  jax_auc_parity.synthesize(str(ref), 3000, 4, 500, seed=11)
  got, want = pd.read_parquet(port), pd.read_parquet(ref)
  assert list(got.columns) == list(want.columns)
  for col in want.columns:
    np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy())
  assert not list(tmp_path.glob('.auc_parity.*'))


def test_auc_parity_reports_the_verdict(tmp_path):
  out = _run('auc_parity', '--device', 'cpu', *AUC_SHAPE, '--skip-overflow',
             '--json', cache=tmp_path)
  assert out.returncode == 0, out.stderr
  got = json.loads(out.stdout.strip().splitlines()[-1])
  assert set(got['results']) == {'exact_seed0', 'exact_seed1', 'fast'}
  assert got['parity_ok'] == {'fast': True}
  assert 'fast_overflow' in got['not_ported']
  aucs = [got['results'][f'exact_seed{s}']['auc'] for s in (0, 1)]
  assert got['exact_spread'] == pytest.approx(max(aucs) - min(aucs))
  assert got['parity_band'] == pytest.approx(
      max(1.5 * got['exact_spread'], 0.006))
  for key, r in got['results'].items():
    assert len(r['curve']) == 2 and r['secs'] > 0, key
    assert 0.5 < r['auc'] < 1.0, key        # the planted signal is learnt
  assert got['card'] is None and got['device'] == 'cpu'


def test_auc_parity_prints_the_short_line(capsys, monkeypatch, tmp_path):
  """Without ``--json`` the JAX harness's short line; one seed gives a
  spread of 0 and the band's floor."""
  monkeypatch.setenv('HB_BENCH_CACHE', str(tmp_path))
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    assert auc_parity.main(['--device', 'cpu', *AUC_SHAPE, '--epochs', '1',
                            '--exact-seeds', '0']) == 0
  finally:
    torch.set_num_threads(n)
  short = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert set(short) == {'exact_mean_auc', 'exact_spread', 'parity_band',
                        'parity_ok'}
  assert short['exact_spread'] == 0.0 and short['parity_band'] == 0.006


def test_auc_parity_refuses_a_host_mesh(tmp_path):
  out = _run('auc_parity', '--device', 'cpu', '--cpu', '8', cache=tmp_path)
  assert out.returncode != 0 and 'not ported' in out.stderr
  assert out.stdout == ''


@pytest.mark.parametrize('flags', [
    ['--mode', 'parquet'], ['--mode', 'parquet', '--python-reader'],
    ['--mode', 'csv'], ['--mode', 'dedup']])
def test_data_benchmark_modes(tmp_path, flags):
  if flags[1] == 'csv':
    # The Parquet file of the same shape, for the storage ratio.
    data_benchmark.parquet_file(data_benchmark.parse_args(
        ['--batch', '200', '--cols', '6', '--steps', '20', '--workdir',
         str(tmp_path)]))
  out = _run('data_benchmark', *flags, '--batch', '200', '--cols', '6',
             '--steps', '20', '--threads', '2', '--json', cache=tmp_path)
  assert out.returncode == 0, out.stderr
  line, js = out.stdout.strip().splitlines()
  got = json.loads(js)
  assert line.startswith(f'{got["mode"]}:') and got['mode'] == flags[1]
  if got['mode'] == 'parquet':
    assert got['reader'] == ('python' if '--python-reader' in flags
                             else 'native')
    assert got['steps_timed'] == 19 and got['samples_per_s'] > 0
  elif got['mode'] == 'csv':
    assert got['steps_timed'] == 2 and got['samples_per_s'] > 0
    assert got['csv_over_parquet_bytes_per_row'] > 0
    assert 'bytes-per-row ratio' in line
  else:
    assert got['unique_ratio'] == pytest.approx(0.1, abs=0.05)
    assert got['dedup_ms'] > 0 and got['restore_ms'] > 0


def test_data_benchmark_transfer_needs_a_card(capsys, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  assert data_benchmark.main(['--mode', 'transfer']) == 1
  out = capsys.readouterr()
  assert 'needs a CUDA device' in out.err and out.out == ''


def test_e2e_profile_times_each_stage(tmp_path):
  out = _run('e2e_benchmark', '--device', 'cpu', '--batch', '64', '--tables',
             '2', '--vocab', '1000', '--dense-features', '3', '--profile',
             '--json', cache=tmp_path)
  assert out.returncode == 0, out.stderr
  lines = [l for l in out.stderr.splitlines() if l.startswith('batch ')]
  assert len(lines) == e2e_benchmark.PROFILE_ROUNDS
  for line in lines:
    for stage in ('decode', 'pack', 'put', 'step-enqueue', 'complete'):
      assert f' {stage} ' in line, line
  got = json.loads(out.stdout.strip().splitlines()[-1])
  assert set(got['profile_ms']) == set(e2e_benchmark.STAGES)
  for stage, rounds in got['profile_rounds_ms'].items():
    assert len(rounds) == e2e_benchmark.PROFILE_ROUNDS
    assert got['profile_ms'][stage] == pytest.approx(float(np.median(rounds)))
  assert got['reader'] == 'native' and got['card'] is None
