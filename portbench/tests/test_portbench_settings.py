"""The training settings a configuration states are read, and a value
the benchmark does not implement is refused, not run as another."""

import copy
import os

import pytest
import torch

from conftest import ROOT
from portbench import harness, train

CONFIGS = ('dlrm-criteo1tb', 'din-taobao')


def _cfg(config):
  return harness._json(os.path.join(ROOT, 'portbench', 'configs',
                                    config + '.json'))


@pytest.mark.parametrize('config', CONFIGS)
def test_the_files_settings_are_read(config):
  cfg = _cfg(config)
  s = train.settings(cfg)
  assert s.table_dtype == torch.float32 and s.tf32 is False
  assert (s.table_lr, s.table_acc0, s.table_eps, s.table_dedup) == (
      cfg['table_optimizer']['lr'],
      cfg['table_optimizer']['initial_accumulator'],
      cfg['table_optimizer']['eps'], True)
  assert (s.tower_lr, s.tower_betas, s.tower_eps) == (
      cfg['tower_optimizer']['lr'], tuple(cfg['tower_optimizer']['betas']),
      cfg['tower_optimizer']['eps'])


@pytest.mark.parametrize('config', CONFIGS)
@pytest.mark.parametrize('key, value', [
    (('table_dtype',), 'bfloat16'),
    (('tf32',), True),
    (('table_optimizer', 'name'), 'adam'),
    (('table_optimizer', 'eps'), 1e-8),
    (('table_optimizer', 'dedup'), False),
    (('table_optimizer', 'momentum'), 0.9),
    (('tower_optimizer', 'name'), 'sgd'),
])
def test_a_setting_not_implemented_is_refused(config, key, value):
  cfg = copy.deepcopy(_cfg(config))
  where = cfg
  for k in key[:-1]:
    where = where[k]
  where[key[-1]] = value
  with pytest.raises(ValueError, match=key[-1] if len(key) == 1
                     else key[0]):
    train.settings(cfg)


@pytest.mark.parametrize('key, value', [
    ('attention_activation', 'dice'), ('dnn_activation', 'prelu'),
    ('dnn_use_bn', True), ('history_features', ['item'])])
def test_din_refuses_what_the_port_s_din_lacks(tiny_cell, key, value):
  cell = tiny_cell('din-taobao.zipf')
  cell.cfg[key] = value
  with pytest.raises(ValueError, match=key):
    harness.prepare(cell, 3, torch.device('cpu'), warmup=0)
