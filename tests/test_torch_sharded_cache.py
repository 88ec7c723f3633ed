"""Host-backed tables at a world of N ranks against the JAX package's cached
trainer on N devices, on the CPU.

The port runs N gloo CPU ranks started by its launcher (``run.py
--simulate N --device cpu``), each a process of ``torch_cache_worker.py``
that imports no JAX; all cases of one world go in one launch, N = 2 and
then N = 4. Each rank trains ``test_torch_cached_trainer.py``'s model on
its rows of each global batch (32 rows a rank): a [4000, 8] table in host
DRAM behind a 160-row cache (``big``) and a device table of [128, 8]
(``small``), one stack in which ``big``'s slots sit at offset 128, so
that they straddle every shard boundary of the stack (at 144 of its 288
rows at N = 2; at 144 and 216 at N = 4). The ids of ``big`` come from a
sliding window, so most of the 12 steps evict. The JAX cached
``SparseTrainer`` trains the global batches on a sub-mesh of N of the
suite's 8 virtual CPU devices (``test_torch_cached_trainer.py``'s
``_jax_run`` with ``devices=jax.devices()[:N]``).

Held, with Adagrad and LazyAdam, with and without ``prefetch``:

* the slot metadata (each slot's id, its last use, the free list) bit for
  bit JAX's after the run, and every rank's bit for bit the other ranks'
  after every step (without ``prefetch``; with it, the producer plans
  ahead, so at the end);
* every rank's flushed host tables bit for bit the other ranks', and
  within ``test_torch_cached_trainer.py``'s ``TOL`` of JAX's where a
  batch touched them, the tower too; the two input orders bit for bit;
* kernel 1's wrapper (Adagrad) or kernel 3's (LazyAdam) called once a
  step on every rank, on the cache table's received lists.

A cache of its own arrays (no trainer) holds each rank's shard of the
slot rows and reads its rows of the world's ids through the sharded
lookup. At N = 2 also: a checkpoint after 6 steps resumed by a fresh
cache over the same storage at N = 2 (bit for bit the uninterrupted run)
and at a world of one in this process (within ``TOL``); ``eval_transform`` under
a pending plan (``test_service_dynamic.py``'s case, each rank its rows);
and the bundle the world exports served against a world of one's
bundle of the same training (``atol = 1e-6``). Torch runs on one thread.
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
from hybridbackend_tpu.framework.context import context_scope
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import stacked_dcn_v2_apply

import hybridbackend_tpu_torch as hbt
from test_torch_cached_trainer import MLP, TOL, _jax_net, _jbce
from test_torch_distribute import LAUNCH_S, jctx, launched, start_launch
import torch_cache_worker as worker

VOCAB, CAP, DIM, SMALL, ROWS, STEPS, SPLIT = 4000, 160, 8, 128, 32, 12, 6
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_cache_worker.py')
CASES = [(opt, prefetch) for opt in ('adagrad', 'adam')
         for prefetch in (False, True)]


@pytest.fixture(autouse=True)
def one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _batches(world, seed=0):
  """Global batches of ``ROWS`` rows a rank; ``big`` from a window of
  120 ids sliding by 37 a step."""
  rng = np.random.RandomState(seed)
  n = ROWS * world
  out = []
  for t in range(STEPS):
    lo = (t * 37) % (VOCAB - 200)
    big = rng.randint(lo, lo + 120, n).astype(np.int64)
    small = rng.randint(0, SMALL, n).astype(np.int32)
    d0 = rng.rand(n).astype(np.float32)
    label = ((big % 5 == 0) | (d0 > 0.8)).astype(np.float32)
    out.append({'small': small, 'big': big, 'd0': d0, 'label': label})
  return out


def _init():
  rng = np.random.RandomState(1)
  return ((rng.randn(VOCAB, DIM) * 0.01).astype(np.float32),
          (rng.randn(SMALL, DIM) * 0.01).astype(np.float32))


def _spec(optimizer, prefetch, batches):
  value, small = _init()
  return dict(vocab=VOCAB, cap=CAP, dim=DIM, mlp=MLP, value=value,
              small=small, optimizer=optimizer, prefetch=prefetch,
              tower=jax.tree.map(np.asarray, _jax_net()), train=batches)


def _jax_run(optimizer, batches, world):
  """The JAX cached trainer on an N-device mesh: its flushed host
  tables, slot metadata and tower."""
  spec = _spec(optimizer, False, batches)
  host = worker._host(spec)
  jc = jctx(world)
  with context_scope(jc), OPTIONS.override(emb_lane_pack='off'):
    cache = JCache(JTableConfig('big', VOCAB, DIM), CAP, host_tables=host,
                   ctx=jc)
    specs = [JEmbeddingSpec(JTableConfig(
                 'small', SMALL, DIM,
                 initializer=lambda k, s: jnp.asarray(spec['small'])),
                 column='small'),
             JEmbeddingSpec(cache.slot_config(), column='big')]
    fx = JStackedFeatureExtractor(specs, dense_columns=['d0'], ctx=jc)
    tr = JSparseTrainer(
        fx, lambda p, e, d, b: _jbce(stacked_dcn_v2_apply(p, e + d),
                                     b['label']),
        _jax_net(), table_lr=0.05, table_optimizer=optimizer,
        rng=jax.random.PRNGKey(3), caches={'big': cache}, ctx=jc)
    tr.train(iter(batches), sync=False)
    tr._cache_runner.flush(tr.state)
    return {'host': host, 'meta': worker._meta(cache),
            'tower': jax.tree.map(np.asarray, tr.state.dense)}


def _name(optimizer, prefetch):
  return optimizer + ('_prefetch' if prefetch else '')


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
  """Both worlds' launches and JAX's runs (made while the ranks run), by
  world."""
  out = {}
  for world in (2, 4):
    tmp = tmp_path_factory.mktemp(f'cache{world}')
    batches = _batches(world, seed=world)
    cases = [(_name(o, p), 'train', _spec(o, p, batches)) for o, p in CASES]
    cases.append(('standalone', 'standalone', dict(
        value=_init()[0][:600], cap=64,
        steps=[b['big'][:48] % 600 for b in batches])))
    if world == 2:
      cases[0][2].update(bundle=str(tmp / 'bundle'),
                         example={k: v[:8] for k, v in batches[-1].items()})
      cases.append(('resume', 'resume', dict(
          _spec('adagrad', False, batches), split=SPLIT,
          model_dir=str(tmp / 'ckpt'), copy_dir=str(tmp / 'ckpt_copy'))))
      cases.append(('eval_pending', 'eval_pending',
                    dict(vocab=64, cap=8, dim=DIM, unseen=40)))
    proc = start_launch(world, cases, tmp, worker=WORKER)
    jax_runs = {o: _jax_run(o, batches, world) for o in ('adagrad', 'adam')}
    out[world] = dict(ranks=launched(proc, world, tmp), jax=jax_runs,
                      batches=batches, tmp=tmp,
                      specs={name: spec for name, _, spec in cases})
  return out


def _touched(batches):
  return np.unique(np.concatenate([b['big'] for b in batches]))


def _assert_tower(got, want):
  tower = hbt.StackedDCNv2([DIM, DIM, 1], MLP)
  names = [n for n, _ in tower.named_parameters()]
  for n, (_, w) in zip(names, hbt.convert._pairs(tower, want)):
    np.testing.assert_allclose(got[n], w.numpy(), err_msg=n, **TOL)


@pytest.mark.timeout(2 * LAUNCH_S + 300)
@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('optimizer,prefetch', CASES)
def test_cached_trainer_matches_jax_on_n_devices(worlds, world, optimizer,
                                                 prefetch):
  run = worlds[world]
  ranks = [r[_name(optimizer, prefetch)] for r in run['ranks']]
  want = run['jax'][optimizer]
  for key, value in want['meta'].items():
    for r in ranks:
      np.testing.assert_array_equal(r['meta'][key], value, err_msg=key)
  touched = _touched(run['batches'])
  value = run['specs'][_name(optimizer, prefetch)]['value']
  for r in ranks:
    for name, table in want['host'].items():
      np.testing.assert_array_equal(r['host'][name], ranks[0]['host'][name])
      np.testing.assert_allclose(r['host'][name][touched],
                                 table[touched], err_msg=name, **TOL)
    untouched = np.setdiff1d(np.arange(VOCAB), touched)
    np.testing.assert_array_equal(r['host']['value'][untouched],
                                  value[untouched])
    assert r['stats']['evicted'] > 0 and r['stats']['uploaded'] > CAP
    assert r['step'] == STEPS
    _assert_tower(r['tower'], want['tower'])
  assert np.abs(ranks[0]['host']['value'][touched]
                - value[touched]).max() > 1e-4
  if prefetch:
    plain = [r[_name(optimizer, False)] for r in run['ranks']]
    for got, base in zip(ranks, plain):
      for name in got['host']:
        np.testing.assert_array_equal(got['host'][name], base['host'][name])


@pytest.mark.timeout(2 * LAUNCH_S + 300)
@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('optimizer', ['adagrad', 'adam'])
def test_every_rank_plans_the_same_slots_each_step(worlds, world, optimizer):
  """Without prefetch, the metadata after each step, equal on every
  rank; the cache table's update kernel called once a step on each; the
  cached member's slots straddle the ranks' shards."""
  ranks = [r[optimizer] for r in worlds[world]['ranks']]
  assert len(ranks[0]['trace']) == STEPS
  for step in range(STEPS):
    for r in ranks[1:]:
      for key in ('slot_to_id', 'last_used', 'free'):
        np.testing.assert_array_equal(r['trace'][step][key],
                                      ranks[0]['trace'][step][key])
      assert r['trace'][step]['loss'] == ranks[0]['trace'][step]['loss']
  kernel = ('adam_update_sorted' if optimizer == 'adam'
            else 'adagrad_update_sorted')
  for r in ranks:
    assert r['calls'][kernel] == STEPS and sum(r['calls'].values()) == STEPS
  offset = ranks[0]['offset']
  assert offset == SMALL
  bounds = [r['shard'][0] for r in ranks[1:]]
  assert any(offset < b < offset + CAP for b in bounds), bounds
  assert all(r['local_rows'] * world == (SMALL + CAP) for r in ranks)


@pytest.mark.timeout(2 * LAUNCH_S + 300)
@pytest.mark.parametrize('world', [2, 4])
def test_a_standalone_cache_holds_its_shard_of_the_slots(worlds, world):
  """``EmbeddingCache.device`` at a world of N holds the rank's shard of
  the slot rows; each rank's rows of the world's ids read their host
  rows through ``lookup_embeddings``, bit for bit, while rows are
  evicted and uploaded; the flush writes back rows that nothing
  updated."""
  spec = worlds[world]['specs']['standalone']
  ranks = [r['standalone'] for r in worlds[world]['ranks']]
  assert all(r['rows'] == spec['cap'] // world for r in ranks)
  for step, ids in enumerate(spec['steps']):
    got = np.concatenate([r['emb'][step] for r in ranks])
    np.testing.assert_array_equal(got, spec['value'][ids])
  for r in ranks:
    assert r['stats']['evicted'] > 0
    np.testing.assert_array_equal(r['host'], spec['value'])


@pytest.mark.timeout(2 * LAUNCH_S + 300)
def test_checkpoint_resumes_at_two_and_at_one(worlds):
  """A checkpoint after 6 steps at N = 2: a fresh cache over the same
  storage resumes it at N = 2 as the uninterrupted run, bit for bit; a
  world of one resumes a copy of it, with a copy of the flushed host
  tables, within ``TOL``."""
  two = worlds[2]
  ranks = [r['resume'] for r in two['ranks']]
  full = [r['adagrad'] for r in two['ranks']]
  for r, f in zip(ranks, full):
    assert r['restored'] == (SPLIT, 0)
    for name in f['host']:
      np.testing.assert_array_equal(r['host'][name], f['host'][name])
    for n in f['tower']:
      np.testing.assert_array_equal(r['tower'][n], f['tower'][n])
  spec = dict(two['specs']['resume'])
  host = ranks[0]['host_mid']
  ctx = hbt.Context(torch.device('cpu'))
  _, tr, _ = worker.trainer(ctx, spec, host, spec['copy_dir'])
  assert tr.global_step == SPLIT
  tr.train(iter(two['batches'][SPLIT:]))
  for name in host:
    np.testing.assert_allclose(host[name], full[0]['host'][name],
                               err_msg=name, **TOL)


@pytest.mark.timeout(2 * LAUNCH_S + 300)
def test_eval_transform_under_a_pending_plan_at_two(worlds):
  """Each rank maps its rows: a pending upload reads as a miss, a
  pending eviction reads the slot whose row it still owns, an unseen id
  misses, and once the plan applies eval follows the live map; the
  uploads landed on their owners' shards (value = id)."""
  got = [r['eval_pending'] for r in worlds[2]['ranks']]
  cat = lambda key: np.concatenate([g[key] for g in got])
  np.testing.assert_array_equal(cat('pending2'), -1)
  np.testing.assert_array_equal(np.sort(cat('pending1')), np.sort(cat('b1')))
  np.testing.assert_array_equal(cat('unseen'), -1)
  applied = cat('applied2')
  assert (applied >= 0).all()
  rows = got[0]['rows']
  np.testing.assert_array_equal(rows[applied, 0], np.arange(8, 16))


@pytest.mark.timeout(2 * LAUNCH_S + 300)
def test_bundle_of_a_cached_world_serves_as_a_world_of_one(worlds, tmp_path):
  """The bundle rank 0 writes at N = 2 (from its storage, which holds
  every row) serves a batch as the bundle of the same training at a
  world of one does."""
  two = worlds[2]
  spec = two['specs']['adagrad']
  ctx = hbt.Context(torch.device('cpu'))
  host = worker._host(spec)
  _, tr, _ = worker.trainer(ctx, spec, host)
  tr.train(iter(two['batches']))
  path = tr.export_saved_model(str(tmp_path / 'one'), spec['example'],
                               poly_batch=True)
  rng = np.random.RandomState(5)
  batch = dict(two['batches'][0],
               big=rng.randint(0, VOCAB, ROWS * 2).astype(np.int64))
  want = hbt.Served(path, 'cpu').predict(batch)
  got = hbt.Served(spec['bundle'], 'cpu').predict(batch)
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
