"""Tiny cells for the CPU tests: the files' configurations and traffic
mixes cut to a few hundred rows and a batch of 64, widths kept."""

import copy
import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

CELLS = ('dlrm-criteo1tb.zipf', 'din-taobao.zipf', 'dlrm-criteo1tb.uniform')


def tiny(cell):
  """``cell`` at a tiny size: every table's rows cut to a few hundred (the
  1- to 4-row tables stay), batch 64, a pool of 8."""
  cfg, tr = copy.deepcopy(cell.cfg), copy.deepcopy(cell.traffic)
  if 'table_rows' in cfg:
    cfg['table_rows'] = [min(r, 300 + 7 * i)
                         for i, r in enumerate(cfg['table_rows'])]
  else:
    cfg['item_rows'], cfg['category_rows'], cfg['user_rows'] = 700, 40, 90
  tr['batch_per_chip'], tr['pool_batches'] = 64, 8
  return dataclasses.replace(cell, cfg=cfg, traffic=tr)


@pytest.fixture
def tiny_cell():
  from portbench import harness

  def make(name):
    return tiny(harness.load_cell(ROOT, name))
  return make


@pytest.fixture
def card():
  """The CUDA device, or a skip on a machine without one."""
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda', 0)
