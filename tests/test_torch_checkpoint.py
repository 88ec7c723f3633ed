"""The port's ``CheckpointManager`` on the CPU: save and restore, the
latest step and all steps, ``max_to_keep``, the template's rules
(missing keys keep the template's value, stored keys the template lacks
are dropped, device and dtype from the template), ``grow_vocab``, the
atomic per-process write, and a trainer's state through a fresh template.
Every comparison is bit for bit."""

import functools
import os

import numpy as np
import pytest
import torch

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.training.checkpoint import CheckpointManager

CPU = torch.device('cpu')


def _state(seed):
  g = torch.Generator().manual_seed(seed)
  return {'step': seed, 'tables': {'t': torch.rand(10, 4, generator=g)},
          'acc': [torch.rand(10, 4, generator=g)],
          'w': torch.rand(3, generator=g)}


def test_save_restore_latest_and_all_steps(tmp_path):
  mgr = CheckpointManager(str(tmp_path), device=CPU)
  assert mgr.latest_step() is None and mgr.all_steps() == []
  template = _state(0)
  assert mgr.restore(template) is template
  for step in (3, 7):
    assert mgr.save(step, _state(step))
  assert mgr.all_steps() == [3, 7] and mgr.latest_step() == 7
  got = mgr.restore(_state(0))
  assert got['step'] == 7
  for key in ('w',):
    assert torch.equal(got[key], _state(7)[key])
  assert torch.equal(got['tables']['t'], _state(7)['tables']['t'])
  assert torch.equal(got['acc'][0], _state(7)['acc'][0])
  assert torch.equal(mgr.restore(_state(0), step=3)['w'], _state(3)['w'])
  # A step at or before the latest is not written again.
  assert not mgr.save(7, _state(1)) and not mgr.save(5, _state(1))
  assert torch.equal(mgr.restore(_state(0))['w'], _state(7)['w'])


@pytest.mark.parametrize('keep', [1, 2])
def test_max_to_keep(tmp_path, keep):
  mgr = CheckpointManager(str(tmp_path), keep, device=CPU)
  for step in range(1, 5):
    mgr.save(step, _state(step))
  assert mgr.all_steps() == list(range(5 - keep, 5))
  assert sorted(os.listdir(tmp_path)) == [f'checkpoint-{s}.pt'
                                          for s in range(5 - keep, 5)]


def test_missing_keys_keep_the_template_and_extra_keys_drop(tmp_path):
  mgr = CheckpointManager(str(tmp_path), device=CPU)
  saved = _state(1)
  saved['old'] = torch.ones(2)
  mgr.save(1, saved)
  template = _state(2)
  template['tables']['new'] = torch.full((5, 4), 0.5)
  got = mgr.restore(template)
  assert 'old' not in got
  assert got['tables']['new'] is template['tables']['new']
  assert torch.equal(got['tables']['t'], saved['tables']['t'])


def test_template_sets_dtype_and_shape_mismatch_raises(tmp_path):
  mgr = CheckpointManager(str(tmp_path), device=CPU)
  mgr.save(1, {'t': torch.arange(6, dtype=torch.float32).reshape(3, 2)})
  got = mgr.restore({'t': torch.zeros(3, 2, dtype=torch.bfloat16)})
  assert got['t'].dtype == torch.bfloat16
  with pytest.raises(ValueError, match='does not fit'):
    mgr.restore({'t': torch.zeros(4, 2)})


def test_grow_vocab_fills_the_row_prefix(tmp_path):
  CheckpointManager(str(tmp_path), device=CPU).save(
      1, {'t': torch.ones(3, 2), 'acc': torch.full((3, 2), 2.0)})
  grow = CheckpointManager(str(tmp_path), device=CPU, grow_vocab=True)
  template = {'t': torch.zeros(5, 2), 'acc': torch.full((5, 2), 0.1)}
  got = grow.restore(template)
  assert torch.equal(got['t'], torch.tensor([[1.0, 1]] * 3 + [[0.0, 0]] * 2))
  assert torch.equal(got['acc'][3:], template['acc'][3:])
  assert torch.equal(got['acc'][:3], torch.full((3, 2), 2.0))
  with pytest.raises(ValueError, match='does not fit'):
    grow.restore({'t': torch.zeros(2, 2), 'acc': torch.zeros(5, 2)})


def test_write_is_atomic_under_a_per_process_name(tmp_path, monkeypatch):
  mgr = CheckpointManager(str(tmp_path), device=CPU)
  names = []
  real_save = torch.save

  def spy(obj, path, *a, **k):
    names.append(os.path.basename(path))
    assert not os.path.exists(tmp_path / 'checkpoint-4.pt')
    return real_save(obj, path, *a, **k)

  monkeypatch.setattr(torch, 'save', spy)
  mgr.save(4, _state(4))
  assert names == [f'.checkpoint-4.pt.{os.getpid()}.tmp']
  assert os.listdir(tmp_path) == ['checkpoint-4.pt']


def _trainer(tmp_path, seed):
  ctx = hbt.Context(CPU)
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{i}', 50, 4))
           for i in range(2)]
  gen = torch.Generator().manual_seed(seed)
  module = torch.nn.ModuleDict({
      'tables': hbt.init_tables(specs, gen, CPU),
      'net': hbt.StackedDCNv2([4, 4, 1], [8, 1], generator=gen)})

  def loss_fn(m, batch):
    emb, dense = hbt.extract_features(m['tables'], batch, specs, ['x'])
    p = torch.clamp(m['net'](emb + dense), 1e-6, 1 - 1e-6)
    y = batch['label']
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {
        'preds': p}

  opt = hbt.multi_optimizer(functools.partial(hbt.Adagrad, lr=0.05),
                            functools.partial(torch.optim.Adam, lr=1e-3))(
                                module)
  return hbt.Trainer(loss_fn, module, opt, str(tmp_path), ctx=ctx)


def test_trainer_state_restores_bitwise_into_a_fresh_template(tmp_path):
  rng = np.random.RandomState(0)
  batches = [{'c0': rng.randint(0, 50, 16), 'c1': rng.randint(0, 50, 16),
              'x': rng.rand(16).astype(np.float32),
              'label': rng.randint(0, 2, 16).astype(np.float32)}
             for _ in range(3)]
  live = _trainer(tmp_path, seed=0)
  live.train(batches)
  assert live.global_step == 3
  fresh = _trainer(tmp_path, seed=1)           # other initial values
  assert fresh.global_step == 3
  want = live._checkpoint_state()
  got = fresh._checkpoint_state()
  for name, t in want['params'].items():
    assert torch.equal(got['params'][name], t), name
  assert set(got['opt_state']) == set(want['opt_state']) and len(
      want['opt_state']) == len(list(live.params.parameters()))
  for name, slots in want['opt_state'].items():
    for slot, t in slots.items():
      assert torch.equal(got['opt_state'][name][slot], t), (name, slot)
