"""The port's train-step harness (``hybridbackend_tpu_torch.benchmarks.
train_benchmark``) on the CPU at a tiny shape: 2 tables of [1000, 16],
batch 64, 2 windows of 3 timed steps. It runs every model and table
dtype through the sparse step, and through the dense-gradient step
without ``--sparse``, and the interleaved sparse step with
``--interleave``, and reports one JSON line; the flags it does not port
or that do not apply exit nonzero with their reason. Its times here are
host-clock CPU times, which the tests do not read."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hybridbackend_tpu_torch.benchmarks import synthetic
from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb

SHAPE = ['--device', 'cpu', '--tables', '2', '--vocab', '1000', '--batch',
         '64', '--dense-features', '3', '--inner-steps', '3', '--repeats', '2',
         '--json']
TINY = ['--sparse'] + SHAPE
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('sparse', [True, False])
@pytest.mark.parametrize('table_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('model', ['dcnv2', 'dlrm'])
def test_harness_reports_one_json_line(capsys, model, table_dtype, sparse):
  flags = ['--sparse'] * sparse + SHAPE
  assert tb.main(flags + ['--model', model, '--table-dtype', table_dtype]) == 0
  (line,) = capsys.readouterr().out.strip().splitlines()
  got = json.loads(line)
  assert (got['model'], got['table_dtype'], got['device'], got['sparse']) == (
      model, table_dtype, 'cpu', sparse)
  assert got['timed_steps'] == 6 and got['card'] is None
  assert got['torch_train_step_ms'] > 0
  # The JAX harness's report: the best window over its steps, and the
  # examples of that window over its time.
  assert got['ms_per_step_best'] == min(got['ms_per_step_repeats']) > 0
  assert got['torch_train_examples_per_sec'] == pytest.approx(
      64 / got['ms_per_step_best'] * 1e3)
  assert got['final_loss'] == got['final_loss']          # not NaN
  assert set(got['kernel_launches']) == set(tb.COUNTED)
  if not sparse:
    # The dense path runs no kernel of the port.
    assert not any(got['kernel_launches'].values())


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


@pytest.mark.parametrize('flags,why', [
    (['--device', 'cpu', '--no-dedup'], 'sparse update only'),
    (['--device', 'cpu', '--interleave', '2'], 'sparse step only'),
    (['--sparse', '--device', 'cpu', '--interleave', '2', '--no-dedup'],
     'not supported with --interleave'),
    (['--sparse', '--device', 'cpu', '--cpu', '4'], 'not ported'),
])
def test_harness_refuses_what_is_not_ported(capsys, flags, why):
  assert tb.main(flags) != 0
  assert why in capsys.readouterr().err


def test_dense_mode_steps_every_table():
  """Without --sparse: one table per column under multi_optimizer, each
  table moved where the batch's ids touched it, its accumulator grown."""
  args = tb.parse_args(SHAPE)
  state, step = tb.build(args, torch.device('cpu'))
  base, ids = tb.make_batch(args, torch.device('cpu'))
  tables = state.params['tables']
  before = {k: t.detach().clone() for k, t in tables.items()}
  state, metrics = step(state, tb.shifted(base, ids, args.vocab, 0))
  assert state.step == 1 and bool(torch.isfinite(metrics['loss']))
  for name in tables:
    touched = torch.zeros(args.vocab, dtype=torch.bool)
    touched[ids[:, int(name[1:])].long()] = True
    after = tables[name].detach()
    assert torch.equal(after[~touched], before[name][~touched])
    assert not torch.equal(after[touched], before[name][touched])
    acc = state.optimizer.state[tables[name]]['sum_of_squares']
    assert bool((acc[touched] > 0.1).any())


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
  interleaved = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.benchmarks.'
       'train_benchmark', *TINY, '--interleave', '2'],
      capture_output=True, text=True, timeout=300, cwd=ROOT)
  assert interleaved.returncode == 0, interleaved.stderr
  got = json.loads(interleaved.stdout.strip().splitlines()[-1])
  # Kernel 1's launches are reported; on the CPU its plain version runs.
  assert got['interleave'] == 2 and got['sparse']
  assert got['kernel_launches']['adagrad_update_sorted'] == 0


@pytest.mark.parametrize('k', [1, 2, 4])
def test_harness_interleaves_with_one_update_per_step(capsys, monkeypatch,
                                                     k):
  """``--sparse --interleave K``: the interleaved step, one Adagrad update
  (the kernel's plain version on the CPU) a step whatever K is."""
  from hybridbackend_tpu_torch.ops import scatter
  calls = []
  real = scatter.adagrad_update_sorted_reference
  monkeypatch.setattr(scatter, 'adagrad_update_sorted_reference',
                      lambda *a, **kw: calls.append(1) or real(*a, **kw))
  assert tb.main(TINY + ['--interleave', str(k)]) == 0
  got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert got['interleave'] == k
  assert len(calls) == tb.WARMUP + got['timed_steps']
  assert got['final_loss'] == got['final_loss']          # not NaN


def test_synthetic_criteo_batches_carry_the_planted_signal():
  batches = synthetic.criteo_batches(4096, 2, vocab=1000, tables=5,
                                     dense_features=3, seed=7)
  again = synthetic.criteo_batches(4096, 2, vocab=1000, tables=5,
                                   dense_features=3, seed=7)
  assert len(batches) == 2
  b = batches[0]
  assert sorted(b) == sorted([f'c{i}' for i in range(5)]
                             + ['i0', 'i1', 'i2', 'label'])
  assert b['c0'].dtype == np.int64 and b['i0'].dtype == np.float32
  assert b['c4'].min() >= 0 and b['c4'].max() < 1000
  assert np.array_equal(b['c3'], again[0]['c3'])
  # zipf(1.5): id 1 is the most common id.
  assert np.bincount(b['c0']).argmax() == 1
  # Ids that 5 divides in c0 raise the label rate; those in c4 do not.
  hit = b['c0'] % 5 == 0
  assert b['label'][hit].mean() > b['label'][~hit].mean() + 0.1
