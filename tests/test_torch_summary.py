"""The port's TensorBoard summaries against the JAX package's, on the CPU.

* crc32c's known vectors (RFC 3720).
* The port's event file is byte for byte the JAX writer's for the same
  scalars and steps at a fixed wall time (``time.time`` pinned for
  both), and each package's reader reads the other's file.
* The trainers: a port ``Trainer`` with ``summary_steps=2`` trains 6
  steps and evaluates, and writes the ``train/loss`` scalars at steps 2,
  4, 6 and the ``eval/`` scalars that JAX's
  ``test_train_and_eval_write_events`` expects, with the JAX trainer's
  values from the same weights (Adagrad 0.1 on both; ``rtol = 1e-5``,
  the trainers' tolerance); ``summary_steps=0`` writes no train scalars;
  no ``model_dir``, no file; ``SparseTrainer`` writes them too.
* ``SummaryHook`` from a log directory, and its flush at the end.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hybridbackend_tpu.utils import summary as jax_summary

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.utils import summary

CPU = torch.device('cpu')
SCALARS = [(1, {'loss': 0.5}), (2, {'loss': 0.25, 'auc': 0.75}),
           (100, {'eval/auc': 0.625, 'eval/loss': 1e-7}),
           (2**40, {'train/x': -3.5})]


def test_crc32c_known_vectors():
  assert summary.crc32c(b'') == 0
  assert summary.crc32c(b'a') == 0xC1D04330
  assert summary.crc32c(b'123456789') == 0xE3069283
  assert summary._masked_crc(b'123456789') == jax_summary._masked_crc(
      b'123456789')


def _write(module, logdir):
  w = module.SummaryWriter(str(logdir))
  w.scalar('first', 1.5, step=0)
  for step, values in SCALARS:
    w.scalars(step, values)
  w.scalars(7, {})          # no event
  w.close()
  return w.path


def test_event_files_are_the_jax_writers_byte_for_byte(tmp_path,
                                                       monkeypatch):
  monkeypatch.setattr('time.time', lambda: 1760000000.25)
  port = _write(summary, tmp_path / 'port')
  jax_path = _write(jax_summary, tmp_path / 'jax')
  assert os.path.basename(port) == os.path.basename(jax_path)
  with open(port, 'rb') as a, open(jax_path, 'rb') as b:
    assert a.read() == b.read()
  want = [(0, 'first', 1.5)] + [
      (step, tag, float(np.float32(v)))
      for step, values in SCALARS for tag, v in values.items()]
  assert summary.read_event_scalars(jax_path) == want
  assert jax_summary.read_event_scalars(port) == want


def test_reader_checks_the_crcs(tmp_path):
  path = _write(summary, tmp_path)
  with open(path, 'r+b') as f:
    f.seek(-3, os.SEEK_END)
    f.write(b'\x00')
  with pytest.raises(ValueError, match='crc'):
    summary.read_event_scalars(path)


def _jax_loss(p, b):
  preds = jax.nn.sigmoid(b['x'] @ p)
  pc = jnp.clip(preds, 1e-6, 1 - 1e-6)
  pel = -(b['label'] * jnp.log(pc) + (1 - b['label']) * jnp.log(1 - pc))
  return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}


class _Linear(nn.Module):

  def __init__(self):
    super().__init__()
    self.w = nn.Parameter(torch.tensor([0.5, -0.5]))

  def forward(self, x):
    return torch.sigmoid(x @ self.w)


def _loss(m, b):
  preds = m(b['x'])
  pc = torch.clamp(preds, 1e-6, 1 - 1e-6)
  pel = -(b['label'] * torch.log(pc) + (1 - b['label']) * torch.log(1 - pc))
  return torch.mean(pel), {'preds': preds, 'per_example_loss': pel}


def _batches(n, seed=0):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(n):
    x = rng.rand(16, 2).astype(np.float32)
    out.append({'x': x, 'label': (x.sum(1) > 1).astype(np.float32)})
  return out


def _events(model_dir):
  files = glob.glob(os.path.join(model_dir, 'events.out.tfevents.*'))
  assert len(files) == 1, files
  return summary.read_event_scalars(files[0])


def test_trainer_writes_the_scalars_jax_writes(tmp_path):
  import hybridbackend_tpu as hb
  from hybridbackend_tpu.estimator import Trainer as JTrainer
  train, evals = _batches(6), _batches(2, seed=1)
  jdir, pdir = str(tmp_path / 'jax'), str(tmp_path / 'port')
  with hb.scope(summary_steps=2):
    jtr = JTrainer(_jax_loss, jnp.asarray([0.5, -0.5], jnp.float32),
                   model_dir=jdir)
    jtr.train(iter(train), sync=False)
    jtr.evaluate(iter(evals))
  jtr._summary.close()
  tr = hbt.Trainer(_loss, _Linear(), model_dir=pdir, ctx=hbt.Context(CPU),
                   summary_steps=2)
  tr.train(iter(train), sync=False)
  tr.evaluate(iter(evals))
  tr._summary.close()
  got, want = _events(pdir), _events(jdir)
  assert [s for s, t, _ in got if t == 'train/loss'] == [2, 4, 6]
  assert {t for _, t, _ in got} == {t for _, t, _ in want} >= {
      'train/loss', 'eval/auc', 'eval/loss'}
  assert [(s, t) for s, t, _ in got] == [(s, t) for s, t, _ in want]
  np.testing.assert_allclose([v for *_, v in got], [v for *_, v in want],
                             rtol=1e-5)


def test_summary_steps_zero_and_no_model_dir(tmp_path):
  tr = hbt.Trainer(_loss, _Linear(), model_dir=str(tmp_path),
                   ctx=hbt.Context(CPU), summary_steps=0)
  tr.train(iter(_batches(4)), sync=False)
  assert not glob.glob(str(tmp_path / 'events.out.tfevents.*'))
  tr.evaluate(iter(_batches(1)))
  assert {t for _, t, _ in _events(str(tmp_path))} == {
      'eval/auc', 'eval/loss'}
  bare = hbt.Trainer(_loss, _Linear(), ctx=hbt.Context(CPU))
  bare.train(iter(_batches(4)), sync=False)
  bare.evaluate(iter(_batches(1)))
  assert bare._summary is None


def test_sparse_trainer_writes_summaries(tmp_path):
  from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb
  args = tb.parse_args(['--sparse', '--device', 'cpu', '--tables', '2',
                        '--vocab', '1000', '--batch', '64',
                        '--dense-features', '3'])
  fx, tables, tower, model_loss = tb.sparse_parts(args, CPU)
  tr = hbt.SparseTrainer(fx, model_loss, tower, tables=tables,
                         model_dir=str(tmp_path), summary_steps=2)
  base, ids = tb.make_batch(args, CPU)
  batches = [{k: v.numpy() for k, v in tb.shifted(base, ids, 1000,
                                                  i).items()}
             for i in range(4)]
  tr.train(iter(batches))
  tr.evaluate(iter(batches[:1]))
  tr._summary.flush()
  got = _events(str(tmp_path))
  assert [s for s, t, _ in got if t == 'train/loss'] == [2, 4]
  assert {'eval/auc', 'eval/loss'} <= {t for _, t, _ in got}


def test_summary_hook_opens_a_writer_and_flushes(tmp_path):
  hook = hbt.SummaryHook(str(tmp_path), every_n_steps=3, prefix='t/')
  hook.begin()
  for step in range(1, 7):
    hook.after_step(step, {'loss': torch.tensor(float(step)),
                           'name': 'not a number'})
  hook.end(6)
  assert _events(str(tmp_path)) == [(3, 't/loss', 3.0), (6, 't/loss', 6.0)]
  hook.writer.close()
