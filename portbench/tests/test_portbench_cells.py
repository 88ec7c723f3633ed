"""Each cell at a tiny size through the harness on the CPU, and
``run.py``'s refusals."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import CELLS, ROOT


@pytest.mark.parametrize('name', CELLS)
@pytest.mark.parametrize('trace', [False, True])
def test_cell_on_cpu_refuses_every_device_metric(tiny_cell, name, trace):
  from portbench import check, harness
  out = harness.run_cell(tiny_cell(name), 2**33 + 7, 1.0, trace,
                         torch.device('cpu'), time.perf_counter())
  assert out['metrics'] == {}
  assert 'breakdown' not in out
  assert out['device'] == {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                           'memory_peak_bytes': 0}
  assert list(out)[-1] == 'checks'
  assert set(out['checks']) == set(check.NUMBERS)
  assert out['correct'] is True
  assert out['attempted'] == 2 and out['failed'] == 0


def test_run_refuses_without_a_card():
  if torch.cuda.is_available():
    pytest.skip('this machine has a CUDA device')
  proc = subprocess.run(
      [sys.executable, 'portbench/run.py', '--workload', CELLS[0], '--seed',
       '1', '--seconds', '1', '--trace', '0'], cwd=ROOT, capture_output=True,
      text=True, timeout=300)
  assert proc.returncode != 0
  assert proc.stdout.strip() == ''
  assert 'no CUDA device' in proc.stderr


def test_run_refuses_without_the_port(tmp_path):
  for name in ('BENCHMARK.json', 'portbench'):
    src = os.path.join(ROOT, name)
    dst = tmp_path / name
    if os.path.isdir(src):
      subprocess.run(['cp', '-r', src, str(dst)], check=True)
    else:
      subprocess.run(['cp', src, str(dst)], check=True)
  proc = subprocess.run(
      [sys.executable, 'portbench/run.py', '--workload', CELLS[0], '--seed',
       '1', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
      capture_output=True, text=True, timeout=300,
      env={**os.environ, 'PYTHONPATH': ''})
  assert proc.returncode != 0
  assert not any(line.startswith('{') for line in proc.stdout.splitlines())


def test_benchmark_json_finds_every_file():
  with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
    bench = json.load(f)
  for c in bench['configs']:
    assert os.path.exists(os.path.join(ROOT, c['file']))
    for kind in ('configs', 'reference'):
      assert os.path.exists(os.path.join(ROOT, 'portbench', kind,
                                         c['name'] + '.py'))
  for w in bench['workloads']:
    assert os.path.exists(os.path.join(ROOT, 'portbench', 'traffic',
                                       w['traffic'] + '.json'))
    assert os.path.exists(os.path.join(ROOT, 'portbench', 'limits',
                                       w['name'] + '.json'))
  for m in bench['per_layer']:
    assert os.path.exists(os.path.join(ROOT, 'portbench', 'metrics',
                                       m['name'] + '.py'))
    assert m['moves'] in {e['name'] for e in bench['end_to_end']}


@pytest.mark.parametrize('name', CELLS)
def test_cell_on_the_card(card, name):
  proc = subprocess.run(
      [sys.executable, 'portbench/run.py', '--workload', name, '--seed',
       '5', '--seconds', '2', '--trace', '0'], cwd=ROOT,
      capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert json.loads(proc.stdout.splitlines()[-1])['correct'] is True
