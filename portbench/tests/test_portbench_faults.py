"""The control and the faults come out not correct; the port does not.

The port runs here on the CPU through its plain versions, at a tiny
size, driven by the harness as a run drives it; each fault is planted
under the step that the harness builds. The control is the reference in
TF32 put in the port's place, read through the same snapshot."""

import copy
import time

import pytest
import torch

from conftest import CELLS
from portbench import check, control, harness


def _run(cell):
  return harness.run_cell(cell, 2**35 + 1, 1.0, False, torch.device('cpu'),
                          time.perf_counter())


def _broken(monkeypatch, fault):
  import hybridbackend_tpu_torch as hbt
  real = hbt.make_sparse_train_step

  def make(*args, **kwargs):
    step = real(*args, **kwargs)

    def unchanged(state, batch):
      # The loss of the step, and the state as it was.
      _, metrics = step(copy.deepcopy(state), batch)
      return state, metrics

    def half_batch(state, batch):
      n = batch['label'].shape[0] // 2
      return step(state, {k: v[:n] for k, v in batch.items()})

    return {'unchanged': unchanged, 'half_batch': half_batch}[fault]

  monkeypatch.setattr(hbt, 'make_sparse_train_step', make)


@pytest.mark.parametrize('name', CELLS)
def test_the_port_is_correct(tiny_cell, name):
  assert _run(tiny_cell(name))['correct'] is True


@pytest.mark.parametrize('name', CELLS)
@pytest.mark.parametrize('fault', ['unchanged', 'half_batch'])
def test_a_fault_is_not_correct(tiny_cell, monkeypatch, name, fault):
  _broken(monkeypatch, fault)
  out = _run(tiny_cell(name))
  assert out['correct'] is False
  if fault == 'unchanged':
    assert out['checks']['grad_gap']['value'] == pytest.approx(1.0)


@pytest.mark.parametrize('name', CELLS)
def test_the_control_is_not_correct(tiny_cell, name):
  cell = tiny_cell(name)
  for seed in (1, 2, 3):
    (side, gaps), = control.readings(cell, seed, torch.device('cpu'),
                                     ['tf32'], program=False)
    assert side == 'tf32'
    assert check.judge(gaps, cell.limits) is False
