"""The port's train-step harness (``hybridbackend_tpu_torch.benchmarks.
train_benchmark``) on the CPU at a tiny shape: 2 tables of [1000, 16],
batch 64, 2 windows of 3 timed steps. It runs every model and table
dtype through the sparse step and reports one JSON line; the flags it
does not port exit nonzero with their reason. Its times here are host-clock CPU times, which
the tests do not read."""

import json
import os
import subprocess
import sys

import pytest
import torch

from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb

TINY = ['--sparse', '--device', 'cpu', '--tables', '2', '--vocab', '1000',
        '--batch', '64', '--dense-features', '3', '--steps', '3',
        '--repeats', '2', '--json']
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('table_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('model', ['dcnv2', 'dlrm'])
def test_harness_reports_one_json_line(capsys, model, table_dtype):
  assert tb.main(TINY + ['--model', model, '--table-dtype', table_dtype]) == 0
  (line,) = capsys.readouterr().out.strip().splitlines()
  got = json.loads(line)
  assert (got['model'], got['table_dtype'], got['device']) == (
      model, table_dtype, 'cpu')
  assert got['timed_steps'] == 6 and got['card'] is None
  assert got['torch_train_step_ms'] > 0
  # The JAX harness's report: the best window over its steps, and the
  # examples of that window over its time.
  assert got['ms_per_step_best'] == min(got['ms_per_step_repeats']) > 0
  assert got['torch_train_examples_per_sec'] == pytest.approx(
      64 / got['ms_per_step_best'] * 1e3)
  assert got['final_loss'] == got['final_loss']          # not NaN
  assert set(got['kernel_launches']) == set(tb.COUNTED)


def test_harness_steps_follow_the_table_dtype():
  args = tb.parse_args(TINY + ['--table-dtype', 'bfloat16', '--no-dedup'])
  state, step = tb.build(args, torch.device('cpu'))
  base, ids = tb.make_batch(args, torch.device('cpu'))
  (name,) = state.tables
  before = state.tables[name].clone()
  assert before.dtype == torch.bfloat16
  assert state.table_opt[name].acc[0].dtype == torch.bfloat16
  state, metrics = step(state, tb.shifted(base, ids, args.vocab, 1))
  assert bool(torch.isfinite(metrics['loss']))
  assert not torch.equal(state.tables[name], before)
  batch = tb.shifted(base, ids, args.vocab, 999)
  assert torch.equal(batch['c1'], (ids[:, 1] + 999) % 1000)


@pytest.mark.parametrize('flags', [
    ['--device', 'cpu'],                                 # no --sparse
    ['--sparse', '--device', 'cpu', '--interleave', '2'],
    ['--sparse', '--device', 'cpu', '--cpu', '4'],
])
def test_harness_refuses_what_is_not_ported(capsys, flags):
  assert tb.main(flags) != 0
  assert 'not ported' in capsys.readouterr().err


def test_harness_needs_a_card_unless_asked_for_the_cpu(capsys, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  assert tb.main(['--sparse']) != 0
  assert 'no CUDA device' in capsys.readouterr().err


def test_harness_runs_as_a_module():
  out = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.benchmarks.'
       'train_benchmark', *TINY, '--table-dtype', 'bfloat16'],
      capture_output=True, text=True, timeout=300, cwd=ROOT)
  assert out.returncode == 0, out.stderr
  assert json.loads(out.stdout.strip().splitlines()[-1])[
      'table_dtype'] == 'bfloat16'
  refused = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.benchmarks.'
       'train_benchmark', '--device', 'cpu'], capture_output=True,
      text=True, timeout=300, cwd=ROOT)
  assert refused.returncode != 0 and 'not ported' in refused.stderr
