"""Host-backed tables in the port's trainer, against the JAX package's.

A table of [10000, 8] in host DRAM behind a 160-row cache (``big``), a
device table of [128, 8] (``small``) and one dense feature, under a DCNv2
tower (``convert.load_dcn_v2`` from the JAX tower's initial weights) and
Adam 1e-3; ids of ``big`` drawn from a sliding window, so most steps
evict and re-pull rows. The JAX cached ``SparseTrainer`` (one-device
context) and the port's (on the CPU) train the same 12 batches; the
flushed host tables (value and each slot) must agree where a batch
touched them to ``rtol = 2e-4, atol = 2e-6`` (the tolerance of the JAX
package's own cached-against-uncached test), with Adagrad and with
LazyAdam, and untouched rows keep their initial bits. The port's two
input orders (each batch mapped in the loop, or ahead in
``DeviceIterator``'s thread) give the same tables bit for bit, and a
checkpoint, a fresh cache over the same storage and a resume give the
uninterrupted run's tables bit for bit.

Serving: a cached trainer's bundle serves from the full host table (the
trainer's predictions on resident ids to ``atol = 1e-6``, and never-cached
ids through their host rows), a dynamic table's bundle maps raw ids with
its bundled ``IdMapper`` (the trainer's predictions to ``atol = 1e-6``),
both on the CPU. The Criteo entry point's ``--export``,
``--export-poly``, ``--export-int8`` and ``--cached`` (the flags that
``test_torch_native_data.py`` refused before they were ported): its
bundles served against its trainer (f32 to ``atol = 1e-6``, int8 to
``atol = 2e-2``, the serving tests' tolerances), and its cached table
moved. Torch runs on one thread.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.embedding.service import EmbeddingCache as JCache
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.estimator import SparseTrainer as JSparseTrainer
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import (
    stacked_dcn_v2_apply, stacked_dcn_v2_init)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.examples.criteo import train as criteo

VOCAB, CAP, DIM, SMALL, BATCH, STEPS = 10_000, 160, 8, 128, 32, 12
MLP = [16, 1]
TOL = dict(rtol=2e-4, atol=2e-6)
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _data(steps, seed=0, vocab=VOCAB):
  """The JAX package's cached-training batches: a sliding window of
  ``big`` ids forces evictions and re-pulls."""
  rng = np.random.RandomState(seed)
  out = []
  for t in range(steps):
    lo = (t * 37) % (vocab - 200)
    big = rng.randint(lo, lo + 120, BATCH).astype(np.int64)
    small = rng.randint(0, SMALL, BATCH).astype(np.int32)
    d0 = rng.rand(BATCH).astype(np.float32)
    label = ((big % 5 == 0) | (d0 > 0.8)).astype(np.float32)
    out.append({'big': big, 'small': small, 'd0': d0, 'label': label})
  return out


def _init():
  rng = np.random.RandomState(1)
  return ((rng.randn(VOCAB, DIM) * 0.01).astype(np.float32),
          (rng.randn(SMALL, DIM) * 0.01).astype(np.float32))


def _host(value, optimizer):
  host = {'value': value.copy()}
  if optimizer == 'adam':
    host.update(slot0=np.zeros_like(value), slot1=np.zeros_like(value))
  else:
    host['slot0'] = np.full_like(value, 0.1)
  return host


def _jbce(p, y):
  p = jnp.clip(p, 1e-6, 1 - 1e-6)
  pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
  return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}


def _tbce(p, y):
  p = torch.clamp(p, 1e-6, 1 - 1e-6)
  pel = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
  return torch.mean(pel), {'preds': p, 'per_example_loss': pel}


def _jax_net():
  return stacked_dcn_v2_init(jax.random.PRNGKey(2), [DIM, DIM, 1], MLP)


def _jax_run(optimizer, batches):
  """The JAX cached trainer's flushed host tables and tower."""
  value, small = _init()
  host = _host(value, optimizer)
  with context_scope(JContext(build_mesh(devices=jax.devices()[:1]))):
    cache = JCache(JTableConfig('big', VOCAB, DIM), CAP, host_tables=host)
    specs = [JEmbeddingSpec(cache.slot_config(), column='big'),
             JEmbeddingSpec(JTableConfig(
                 'small', SMALL, DIM, sharded=False,
                 initializer=lambda k, s: jnp.asarray(small)),
                 column='small')]
    fx = JStackedFeatureExtractor(specs, dense_columns=['d0'])
    tr = JSparseTrainer(
        fx, lambda p, e, d, b: _jbce(stacked_dcn_v2_apply(p, e + d),
                                     b['label']),
        _jax_net(), table_lr=0.05, table_optimizer=optimizer,
        rng=jax.random.PRNGKey(3), caches={'big': cache})
    m = tr.train(iter(batches), sync=False)
    tr._cache_runner.flush(tr.state)
    net = jax.tree.map(np.asarray, tr.state.dense)
  return host, net, m['loss']


def _port_trainer(host, optimizer='adagrad', model_dir=None, native=True):
  _, small = _init()
  ctx = hbt.Context(CPU)
  cache = hbt.EmbeddingCache(hbt.TableConfig('big', VOCAB, DIM), CAP,
                             host_tables=host, ctx=ctx, native=native)
  specs = [hbt.EmbeddingSpec(cache.slot_config(), column='big'),
           hbt.EmbeddingSpec(hbt.TableConfig(
               'small', SMALL, DIM,
               initializer=lambda g, s, d: torch.from_numpy(small.copy())),
               column='small')]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=['d0'], ctx=ctx)
  tower = hbt.StackedDCNv2([DIM, DIM, 1], MLP)
  hbt.load_dcn_v2(tower, jax.tree.map(np.asarray, _jax_net()))
  tr = hbt.SparseTrainer(
      fx, lambda t, e, d, b: _tbce(t(e + d), b['label']), tower,
      table_lr=0.05, table_optimizer=optimizer, model_dir=model_dir,
      caches={'big': cache})
  return tr, cache


def _touched(batches):
  return np.unique(np.concatenate([b['big'] for b in batches]))


@pytest.mark.parametrize('optimizer', ['adagrad', 'adam'])
def test_cached_trainer_matches_jax(optimizer):
  batches = _data(STEPS)
  want, jnet, jloss = _jax_run(optimizer, batches)
  value, _ = _init()
  hosts = {}
  for prefetch in (False, True):
    host = _host(value, optimizer)
    tr, cache = _port_trainer(host, optimizer)
    m = tr.train(iter(batches), sync=False, prefetch=prefetch)
    tr._cache_runner.flush(tr.state)
    hosts[prefetch] = host
    assert cache.stats['evicted'] > 0 and cache.stats['uploaded'] > CAP
  np.testing.assert_allclose(m['loss'], float(jloss), rtol=1e-5)
  for name in want:                       # both input orders, bitwise
    np.testing.assert_array_equal(hosts[True][name], hosts[False][name])
  host = hosts[False]
  touched = _touched(batches)
  for name in want:
    np.testing.assert_allclose(host[name][touched], want[name][touched],
                               **TOL, err_msg=name)
  untouched = np.setdiff1d(np.arange(VOCAB), touched)
  np.testing.assert_array_equal(host['value'][untouched], value[untouched])
  assert np.abs(host['value'][touched] - value[touched]).max() > 1e-4
  for p, w in hbt.convert._pairs(tr.state.dense, jnet):
    np.testing.assert_allclose(p.detach().numpy(), w, **TOL)


def test_cached_trainer_checks_its_cache_tables():
  value, _ = _init()
  with pytest.raises(ValueError, match='slot1'):
    _port_trainer(_host(value, 'adagrad'), 'adam')


def test_cached_checkpoint_resume_matches_uninterrupted(tmp_path):
  """Checkpoints flush the cache, so a fresh cache over the same storage
  and a trainer restored from the checkpoint continue as one run."""
  batches = _data(8, seed=3)
  value, _ = _init()
  host_a = _host(value, 'adagrad')
  tr_a, _ = _port_trainer(host_a)
  tr_a.train(iter(batches), sync=False)
  tr_a._cache_runner.flush(tr_a.state)

  host_b = _host(value, 'adagrad')
  md = str(tmp_path / 'm')
  tr_b1, _ = _port_trainer(host_b, model_dir=md, native=False)
  tr_b1.train(iter(batches[:4]), sync=False, save_checkpoint_steps=2)
  tr_b2, cache_b2 = _port_trainer(host_b, model_dir=md)
  assert tr_b2.global_step == 4 and cache_b2.resident == 0
  tr_b2.train(iter(batches[4:]), sync=False, prefetch=True)
  tr_b2._cache_runner.flush(tr_b2.state)
  for name in host_a:
    np.testing.assert_array_equal(host_b[name], host_a[name])
  for p, q in zip(tr_b2.state.dense.parameters(),
                  tr_a.state.dense.parameters()):
    assert torch.equal(p, q)


def _predict(trainer, batch):
  (preds,) = trainer.predict(iter([batch]))
  return preds.numpy()


def test_cached_export_serves_the_full_host_table(tmp_path):
  value, _ = _init()
  host = _host(value, 'adagrad')
  tr, cache = _port_trainer(host)
  batches = _data(6)
  tr.train(iter(batches), sync=False)
  resident = dict(batches[-1])            # every big id of it is cached
  assert (cache.lookup_slots(resident['big']) >= 0).all()
  rng = np.random.RandomState(9)
  cold = dict(resident, big=rng.randint(0, VOCAB, BATCH).astype(np.int64))
  path = tr.export_saved_model(str(tmp_path / 'cached'), cold,
                               poly_batch=True)
  served = hbt.Served(path, 'cpu')
  assert served.signature['id_mapped'] == []
  np.testing.assert_allclose(served.predict(resident),
                             _predict(tr, resident), rtol=0, atol=1e-6)
  # Never-cached ids serve from their host rows (the flush made the host
  # table whole), as the trainer would once they were uploaded.
  small = hbt.member_tables(tr._fx.stack_of('small'), tr.state.tables[
      tr._fx.stack_of('small').stacked.name])['small']
  emb = [torch.from_numpy(host['value'][cold['big']]),
         small[torch.from_numpy(cold['small']).long()],
         torch.from_numpy(cold['d0'])[:, None]]
  with torch.no_grad():
    want = torch.clamp(tr.state.dense(emb), 1e-6, 1 - 1e-6).numpy()
  np.testing.assert_allclose(served.predict(cold), want, rtol=0, atol=1e-6)


def test_dynamic_export_bundles_the_id_mapper(tmp_path):
  dyn = hbt.DynamicEmbedding('uid', capacity=64, dim=DIM, min_count=2)
  ctx = hbt.Context(CPU)
  fx = hbt.StackedFeatureExtractor([hbt.EmbeddingSpec(dyn.config, 'uid')],
                                   dense_columns=['d0'], ctx=ctx)
  tower = hbt.StackedDCNv2([DIM, 1], MLP,
                           generator=torch.Generator().manual_seed(1))
  tr = hbt.SparseTrainer(fx, lambda t, e, d, b: _tbce(t(e + d), b['label']),
                         tower, table_lr=0.2)
  raw = np.arange(BATCH, dtype=np.int64) * 10**10 + 7
  rng = np.random.RandomState(3)

  def batches(n):
    for _ in range(n):
      yield {'uid': raw, 'd0': rng.rand(BATCH).astype(np.float32),
             'label': (raw % 3 == 0).astype(np.float32)}

  it = hbt.DeviceIterator(batches(6), CPU, transform=dyn.transform('uid'))
  for b in it:                            # admitted at the second sighting
    tr.state, _ = tr._step_fn(tr.state, b)
  assert dyn.mapper.size == BATCH
  example = next(batches(1))
  mapped = dict(example, uid=dyn.mapper.map_ids(raw, train=False))
  path = tr.export_saved_model(str(tmp_path / 'dyn'), mapped,
                               id_mappers={'uid': dyn.mapper})
  served = hbt.Served(path, 'cpu')
  assert served.signature['id_mapped'] == ['uid']
  np.testing.assert_allclose(served.predict(example), _predict(tr, mapped),
                             rtol=0, atol=1e-6)
  unseen = dict(example, uid=np.full((BATCH,), 10**15 + 3, np.int64))
  np.testing.assert_allclose(
      served.predict(unseen), _predict(tr, dict(example, uid=np.full(
          (BATCH,), -1, np.int64))), rtol=0, atol=1e-6)


# -- the Criteo entry point's flags -------------------------------------------

@pytest.fixture(scope='module')
def criteo_file(tmp_path_factory):
  path = str(tmp_path_factory.mktemp('criteo') / 'criteo.parquet')
  criteo.synthesize(path, 512, criteo.vocabs(criteo.parse_args(
      ['--vocab', '1000'])))
  return path


def _criteo(criteo_file, *flags):
  args = criteo.parse_args(['--device', 'cpu', '--data', criteo_file,
                            '--batch-size', '64', '--vocab', '1000',
                            '--dim', '8', '--steps', '4', '--python-reader',
                            *flags])
  assert criteo.unsupported(args) is None
  return args, criteo.run(args)


def _served_against_trainer(args, trainer, sizes, atol):
  served = hbt.Served(args.export, 'cpu')
  for rows in sizes:
    batch = {k: v[:rows] for k, v in next(criteo.batches(args, False)).items()}
    np.testing.assert_allclose(served.predict(batch), _predict(trainer, batch),
                               rtol=0, atol=atol)
  return served


def test_criteo_export_serves_the_trainer(criteo_file, tmp_path, capsys):
  args, trainer = _criteo(criteo_file, '--sparse', '--export',
                          str(tmp_path / 'f32'))
  assert f'exported serving bundle → {args.export}' in capsys.readouterr().out
  served = _served_against_trainer(args, trainer, [64], 1e-6)
  assert served.signature['poly_batch'] is False


def test_criteo_export_poly_serves_two_batch_sizes(criteo_file, tmp_path):
  args, trainer = _criteo(criteo_file, '--sparse', '--export',
                          str(tmp_path / 'poly'), '--export-poly')
  served = _served_against_trainer(args, trainer, [5, 64], 1e-6)
  assert served.signature['poly_batch'] is True


def test_criteo_export_int8_serves_the_trainer(criteo_file, tmp_path,
                                               capsys):
  args, trainer = _criteo(criteo_file, '--sparse', '--export',
                          str(tmp_path / 'int8'), '--export-int8')
  assert '(int8 tables)' in capsys.readouterr().out
  _served_against_trainer(args, trainer, [64], 2e-2)
  params = torch.load(os.path.join(args.export, 'params.pt'))
  assert any(p.dtype == torch.int8 for p in params)


def test_criteo_cached_trains_its_host_table(criteo_file, tmp_path):
  args, trainer = _criteo(criteo_file, '--cached', '64', '--export',
                          str(tmp_path / 'cached'))
  assert args.sparse
  (col, cache), = trainer._caches.items()
  assert col == 'c0' and cache.capacity == 64
  value = criteo.host_cache(args, CPU)[1].host['value']
  moved = np.abs(cache.host['value'] - value).max(axis=1) > 0
  assert 0 < moved.sum() <= cache.stats['uploaded']
  np.testing.assert_array_equal(cache.host['slot0'][~moved], np.float32(0.1))
  # The bundle serves c0 from the whole host table.
  served = hbt.Served(args.export, 'cpu')
  batch = next(criteo.batches(args, False))
  assert np.isfinite(served.predict(batch)).all()


@pytest.mark.parametrize('flags,why', [
    (['--export-int8'], 'shape the bundle of --export'),
    (['--export', 'x'], 'pass --sparse'),
])
def test_criteo_refuses_an_export_it_cannot_write(capsys, flags, why):
  assert criteo.main(['--device', 'cpu', *flags]) == 1
  assert why in capsys.readouterr().err
