"""The FLOP and byte counts against hand counts."""

import os

import pytest
import torch

from conftest import ROOT
from portbench import harness, peaks


def _mod(config):
  return harness.load_module(
      os.path.join(ROOT, 'portbench', 'configs', config + '.py'), 'cfgmod')


def _cfg(config):
  return harness._json(os.path.join(ROOT, 'portbench', 'configs',
                                    config + '.json'))


def test_dlrm_flops_at_8192():
  # Forward per example: bottom 13-512-256-128, the 27 x 27 x 128 bmm,
  # top 479-1024-1024-512-256-1.
  bottom = 2 * (13 * 512 + 512 * 256 + 256 * 128)
  bmm = 2 * 27 * 27 * 128
  top = 2 * (479 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1)
  assert (bottom, bmm, top) == (340992, 186624, 4389376)
  fwd = 8192 * (bottom + bmm + top)
  assert fwd == pytest.approx(40.28e9, rel=1e-3)
  # Three times the forward, less the first layer's input gradient.
  want = 3 * fwd - 8192 * 2 * 13 * 512
  got = _mod('dlrm-criteo1tb').flops(_cfg('dlrm-criteo1tb'),
                                     {'label': torch.zeros(8192)})
  assert got == want
  assert got == pytest.approx(120.73e9, rel=1e-4)
  assert 3 * fwd == pytest.approx(120.8e9, rel=1e-3)


def test_din_flops_counts_valid_positions_only():
  mask = torch.zeros(8192, 100, dtype=torch.bool)
  mask[:, :63] = True
  mask[:100, 63] = True
  valid = 8192 * 63 + 100
  # The query is an item's and its category's embedding, 64 wide; the
  # DNN takes the query, the pooled history and the user's embedding.
  dnn = 2 * (160 * 256 + 256 * 128 + 128 * 64 + 64 * 1)
  att = 2 * (256 * 80 + 80 * 40 + 40 * 1) + 2 * 64
  assert (dnn, att) == (163968, 47568)
  got = _mod('din-taobao').flops(
      _cfg('din-taobao'), {'label': torch.zeros(8192), 'hist_mask': mask})
  assert got == 3 * (8192 * dnn + valid * att)
  assert got == pytest.approx(77.7e9, rel=1e-3)


def test_kernel1_bound_by_hand():
  # The flagship list of the port's chip smoke: 212992 rows, 202738
  # distinct, d = 16: 66.38 MB, 0.0198 ms.
  n, u, d = 212992, 202738, 16
  assert n * (d + 1) * 4 + 4 * u * d * 4 == 66_384_384
  assert peaks.adagrad_bound_s(n, u, d) == pytest.approx(66_384_384 / 3.35e12)
  # Under half an operation a byte: the bytes bound every list.
  for n, u, d in ((10, 1, 10**7), (835584, 400000, 32), (1, 1, 1)):
    assert peaks.adagrad_bound_s(n, u, d) == pytest.approx(
        (n * (d + 1) * 4 + 16 * u * d) / 3.35e12)


def test_kernel1_lists_count_valid_entries_and_distinct_rows(tiny_cell):
  cell = tiny_cell('dlrm-criteo1tb.zipf')
  prep = harness.prepare(cell, 5, torch.device('cpu'), warmup=0)
  b = prep.batch_of(7)
  offsets = [prep.members[f'c{i}'].offset for i in range(26)]
  rows = torch.stack([b[f'c{i}'].long() + off
                      for i, off in enumerate(offsets)], 1)
  assert harness._kernel1_lists(cell, prep, 7) == [
      (rows.numel(), torch.unique(rows).numel())]
  # The few-row tables repeat their rows: fewer distinct rows than ids.
  assert torch.unique(rows).numel() < rows.numel()
