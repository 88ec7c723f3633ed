"""The port's host tables against the JAX package's, on the CPU.

* ``native/idmap.py`` (the port's build of its own ``hbtpu_native.cc``)
  against ``hybridbackend_tpu.native`` on the same id streams: rows,
  ``next_row``, ``lookup``, ``items`` and ``items_all`` (after erases and
  with pending admissions), bitwise; the ragged helpers and
  ``murmur3_mix64`` against the port's NumPy paths (``data/dataframe.py``
  and a NumPy mix), bitwise; a failed build raises with its reason.
* ``IdMapper`` against the JAX ``IdMapper``, native and ``native=False``,
  ``min_count`` 1 and 3, up to a full table: rows and ``state_dict``
  bitwise, and the resume of pending counters.
* ``EmbeddingCache``: its plans against the JAX cache's on one stream,
  bitwise (slots, evictions, misses), with the native map and without;
  hits, eviction and write-back, flush, aux slots, the capacity error and
  a custom ``Storage``. Its arrays live on the CPU here.
* ``CacheRunner``: ``drain``, ``eval_transform`` and ``checkpoint_flush``
  under pending plans (the JAX package's tests of them, on the port).

Everything here is exact: ids, rows, slots and copied rows, compared
bit for bit. Torch runs on one thread.
"""

import jax
import numpy as np
import pytest
import torch

from hybridbackend_tpu import native as jnative
from hybridbackend_tpu.embedding.dynamic import IdMapper as JIdMapper
from hybridbackend_tpu.embedding.service import EmbeddingCache as JCache
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.data.dataframe import Value, take_rows
from hybridbackend_tpu_torch.embedding.service import CachePlan
from hybridbackend_tpu_torch.native import idmap, tabular

CPU = torch.device('cpu')
DIM = 8


@pytest.fixture(autouse=True)
def one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _streams(seed=0, batches=8, n=64, hi=40):
  """Id batches with repeats, negatives and the map's two sentinel ids."""
  rng = np.random.RandomState(seed)
  out = []
  for b in range(batches):
    ids = rng.randint(-3, hi, n).astype(np.int64)
    if b % 3 == 1:
      ids[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).min + 1]
    out.append(ids)
  return out


# -- the native map -----------------------------------------------------------

@pytest.mark.parametrize('min_count', [1, 3])
def test_native_idmap_matches_jax(min_count):
  port, ref = idmap.native_idmap(16), jnative.native_idmap(16)
  assert ref is not None
  nxt_p = nxt_r = 0
  for ids in _streams(min_count):
    got, nxt_p = port.train_lookup(ids, 30, nxt_p, min_count)
    want, nxt_r = ref.train_lookup(ids, 30, nxt_r, min_count)
    np.testing.assert_array_equal(got, want)
    assert nxt_p == nxt_r
  assert nxt_p == 30                      # the table filled up
  probe = np.arange(-5, 60, dtype=np.int64)
  np.testing.assert_array_equal(port.lookup(probe), ref.lookup(probe))
  np.testing.assert_array_equal(port.lookup(probe, missing=-7, nthreads=3),
                                ref.lookup(probe, missing=-7, nthreads=3))
  gone = np.asarray([0, 5, 7, np.iinfo(np.int64).min, 999], np.int64)
  port.erase(gone)
  ref.erase(gone)
  port.set(np.asarray([100, 5], np.int64), np.asarray([3, -2], np.int32))
  ref.set(np.asarray([100, 5], np.int64), np.asarray([3, -2], np.int32))
  assert len(port) == len(ref)
  for got, want in ((port.items(), ref.items()),
                    (port.items_all(), ref.items_all())):
    for g, w in zip(got, want):
      assert g.dtype == w.dtype
      np.testing.assert_array_equal(g, w)
  assert (port.items_all()[1] < 0).any()   # the pending entry is kept


def test_native_idmap_parallel_probe_matches_jax():
  """Above 32768 ids the probe runs on several threads."""
  ids = np.random.RandomState(0).randint(0, 1 << 40, 40000).astype(np.int64)
  port, ref = idmap.native_idmap(1 << 16), jnative.native_idmap(1 << 16)
  rows, _ = port.train_lookup(ids, 1 << 20, 0)
  ref.train_lookup(ids, 1 << 20, 0)
  np.testing.assert_array_equal(port.lookup(ids, nthreads=4), rows)
  np.testing.assert_array_equal(port.lookup(ids, nthreads=4),
                                ref.lookup(ids, nthreads=4))


def test_native_build_failure_raises_its_reason(monkeypatch, tmp_path):
  """No quiet fallback: a source that does not compile raises, and so
  does every later call in the process, with g++'s reason."""
  bad = tmp_path / 'broken.cc'
  bad.write_text('this is not C++\n')
  monkeypatch.setattr(idmap, '_SRC', bad)
  monkeypatch.setattr(idmap, '_BUILD_DIR', tmp_path / 'build')
  monkeypatch.setattr(idmap, '_LOADED', {})
  with pytest.raises(tabular.NativeUnavailable, match='g.. failed'):
    idmap.native_idmap()
  with pytest.raises(tabular.NativeUnavailable, match='g.. failed'):
    idmap.murmur3_mix64(np.arange(3))
  with pytest.raises(tabular.NativeUnavailable):
    hbt.IdMapper(8)
  assert hbt.IdMapper(8, native=False).map_ids(np.asarray([5]))[0] == 0
  assert not list((tmp_path / 'build').glob('*.tmp'))


# -- the ragged helpers and the mix -------------------------------------------

def _ragged(rng, dtype, rows=50, inner=()):
  lengths = rng.randint(0, 7, rows)
  splits = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
  values = (rng.rand(splits[-1], *inner) * 1000).astype(dtype)
  return values, splits


@pytest.mark.parametrize('dtype', [np.float32, np.int64, np.int32])
@pytest.mark.parametrize('inner', [(), (3,)])
def test_ragged_to_padded_matches_numpy(dtype, inner):
  rng = np.random.RandomState(1)
  values, splits = _ragged(rng, dtype, inner=inner)
  for max_len in (4, 8):
    got = idmap.ragged_to_padded(values, splits, max_len, 9)
    want = Value(values, [splits]).to_padded(max_len=max_len, pad_value=9)
    for g, w in zip(got, want):
      assert g.dtype == w.dtype and g.shape == w.shape
      np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('dtype', [np.float32, np.int64, np.int8])
def test_take_rows_match_numpy(dtype):
  rng = np.random.RandomState(2)
  values, splits = _ragged(rng, dtype)
  idx = rng.permutation(50)[:37]
  got_v, got_s = idmap.ragged_take_rows(values, splits, idx)
  want = take_rows(Value(values, [splits]), idx)
  np.testing.assert_array_equal(got_v, want.values)
  np.testing.assert_array_equal(got_s, want.row_splits[0])
  dense = (rng.rand(50, 3, 2) * 100).astype(dtype)
  np.testing.assert_array_equal(idmap.take_rows_dense(dense, idx),
                                take_rows(dense, idx))
  with pytest.raises(TypeError):
    idmap.ragged_to_padded(values.astype(np.float64), splits, 4, 0)
  # Nothing reaches the native loops that would read past a buffer.
  with pytest.raises(IndexError):
    idmap.ragged_take_rows(values, splits, [0, 50])
  with pytest.raises(IndexError):
    idmap.take_rows_dense(dense, [-1])
  with pytest.raises(ValueError):
    idmap.ragged_take_rows(values, splits + 1, [0])


def _mix_numpy(ids, modulo=0):
  k = ids.astype(np.uint64)
  with np.errstate(over='ignore'):
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xff51afd7ed558ccd)
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xc4ceb9fe1a85ec53)
    k ^= k >> np.uint64(33)
  if modulo:
    k = k % np.uint64(modulo)
  return k.view(np.int64)


def test_murmur3_mix64_matches_numpy_and_jax():
  ids = np.concatenate([np.arange(-50, 50),
                        np.random.RandomState(3).randint(
                            np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                            1000, dtype=np.int64)])
  for modulo in (0, 1000, 1 << 40):
    got = idmap.murmur3_mix64(ids, modulo)
    np.testing.assert_array_equal(got, _mix_numpy(ids, modulo))
    np.testing.assert_array_equal(got, jnative.murmur3_mix64(ids, modulo))


# -- IdMapper -----------------------------------------------------------------

@pytest.mark.parametrize('native', [True, False])
@pytest.mark.parametrize('min_count', [1, 3])
def test_id_mapper_matches_jax(native, min_count):
  port = hbt.IdMapper(30, min_count=min_count, native=native)
  ref = JIdMapper(30, min_count=min_count)
  assert ref._native is not None and port.native == native
  streams = _streams(10 + min_count, batches=10)
  for ids in streams[:5]:
    np.testing.assert_array_equal(port.map_ids(ids.reshape(8, 8)),
                                  ref.map_ids(ids.reshape(8, 8)))
    np.testing.assert_array_equal(port.map_ids(ids[:9], train=False),
                                  ref.map_ids(ids[:9], train=False))
  state, want = port.state_dict(), ref.state_dict()
  assert set(state) == set(want)
  for k in want:
    assert state[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(state[k], want[k])
  if min_count > 1:
    assert state['pending_ids'].size      # counters partway to admission
  # Resume both from the state, in both modes, and go on.
  port2 = hbt.IdMapper.from_state_dict(30, state, min_count=min_count,
                                       native=not native)
  ref2 = JIdMapper.from_state_dict(30, want, min_count=min_count)
  for ids in streams[5:]:
    got = port2.map_ids(ids)
    np.testing.assert_array_equal(got, ref2.map_ids(ids))
    np.testing.assert_array_equal(got, port.map_ids(ids))
  assert port2.size == ref2.size == port.size == 30     # full table
  for k, v in ref2.state_dict().items():
    np.testing.assert_array_equal(port2.state_dict()[k], v)


def test_id_mapper_admits_at_the_same_sighting_after_resume():
  """The JAX test_pending_admission_counters_survive_checkpoint, on the
  port, in both modes."""
  for native in (True, False):
    m = hbt.IdMapper(10, min_count=3, native=native)
    assert m.map_ids(np.asarray([9]))[0] == -1
    assert m.map_ids(np.asarray([9]))[0] == -1
    m.map_ids(np.asarray([4]))
    m2 = hbt.IdMapper.from_state_dict(10, m.state_dict(), min_count=3,
                                      native=native)
    assert m2.map_ids(np.asarray([9]))[0] >= 0
    assert m2.map_ids(np.asarray([77]))[0] == -1


def test_dynamic_embedding_transform():
  dyn = hbt.DynamicEmbedding('uid', capacity=8, dim=DIM)
  assert dyn.config.vocab_size == 8 and dyn.config.dim == DIM
  out = dyn.transform('uid')({'uid': np.asarray([123456789, 42, 42]),
                              'x': np.ones(3)})
  np.testing.assert_array_equal(out['uid'], [0, 1, 1])
  np.testing.assert_array_equal(out['x'], np.ones(3))
  cold = dyn.transform('uid', train=False)({'uid': np.asarray([7, 42])})
  np.testing.assert_array_equal(cold['uid'], [-1, 1])
  assert dyn.mapper.size == 2


# -- EmbeddingCache -----------------------------------------------------------

def _host(vocab, seed=0, slots=1):
  rng = np.random.RandomState(seed)
  out = {'value': rng.rand(vocab, DIM).astype(np.float32)}
  for i in range(slots):
    out[f'slot{i}'] = np.full((vocab, DIM), 0.1 * (i + 1), np.float32)
  return out


def _cache(vocab=100, capacity=16, native=True, **kw):
  host = _host(vocab, **kw)
  return hbt.EmbeddingCache(hbt.TableConfig('svc', vocab, DIM), capacity,
                            host, ctx=hbt.Context(CPU), native=native), host


@pytest.mark.parametrize('native', [True, False])
def test_cache_plans_match_jax(native):
  """The same ids give the JAX cache's plans: slots, eviction slots and
  ids, miss slots and ids; and both move the same rows."""
  cache, host = _cache(vocab=300, capacity=48, native=native)
  with context_scope(JContext(build_mesh(devices=jax.devices()[:1]))):
    jcache = JCache(JTableConfig('svc', 300, DIM), 48, _host(300))
    rng = np.random.RandomState(5)
    evicted = 0
    for step in range(12):
      lo = (step * 23) % 250
      ids = rng.randint(lo, lo + 40, (6, 5)).astype(np.int64)
      got, want = cache.prepare_plan(ids), jcache.prepare_plan(ids)
      for g, w, name in zip(got, want, CachePlan._fields):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
      evicted += got.evict_slots.size
      cache.apply_plan(cache.device, got)
      jcache.device = jcache.apply_plan(jcache.device, want)
      for name in host:
        np.testing.assert_array_equal(cache.device[name].numpy(),
                                      np.asarray(jcache.device[name]))
    np.testing.assert_array_equal(cache.lookup_slots(np.arange(300)),
                                  jcache.lookup_slots(np.arange(300)))
  assert evicted > 0
  assert cache.stats['evicted'] == evicted
  assert cache.stats['uploaded'] == cache.stats['misses'] > 0


def test_cache_miss_then_hit():
  cache, host = _cache()
  ids = np.asarray([3, 7, 3, 9])
  slots = cache.prepare(ids)
  assert cache.resident == 3
  np.testing.assert_array_equal(cache.lookup_embeddings(slots).numpy(),
                                host['value'][ids])
  np.testing.assert_array_equal(cache.prepare(ids), slots)
  assert cache.resident == 3
  assert cache.stats['planned'] == 6 and cache.stats['misses'] == 3


def test_cache_eviction_lru_and_writeback():
  cache, host = _cache(capacity=4)
  cache.prepare(np.asarray([0, 1, 2, 3]))
  s0 = cache.prepare(np.asarray([0]))[0]
  cache.device['value'][s0] = 42.0        # a training update, in place
  cache.device['value'][cache.lookup_slots(np.asarray([1]))[0]] = 7.0
  cache.prepare(np.asarray([50, 51, 52]))  # evicts 1, 2, 3 (0 was used)
  assert cache.resident == 4
  np.testing.assert_array_equal(host['value'][1], 7.0)   # written back
  slots = cache.prepare(np.asarray([0]))
  assert float(cache.lookup_embeddings(slots)[0, 0]) == 42.0


def test_cache_flush_writes_back_value_and_aux_slots():
  cache, host = _cache(capacity=8, slots=2)
  slots = cache.prepare(np.asarray([5, 2]))
  cache.device['value'][slots[0]] = 7.0
  cache.device['slot0'][slots[1]] = 1.5
  cache.device['slot1'][slots[0]] = -2.0
  cache.flush()
  np.testing.assert_array_equal(host['value'][5], 7.0)
  np.testing.assert_array_equal(host['slot0'][2], 1.5)
  np.testing.assert_array_equal(host['slot1'][5], -2.0)
  np.testing.assert_array_equal(host['slot1'][2], np.float32(0.2))


def test_cache_capacity_exceeded_raises():
  cache, _ = _cache(capacity=4)
  with pytest.raises(ValueError, match='capacity'):
    cache.prepare(np.arange(5))


def test_cache_custom_storage():
  class CountingStorage(hbt.Storage):
    def __init__(self):
      self.backing = {'value': np.arange(400, dtype=np.float32).reshape(
          100, 4)}
      self.pulls = self.pushes = 0

    def pull(self, name, keys):
      self.pulls += 1
      return self.backing[name][keys]

    def push(self, name, keys, values):
      self.pushes += 1
      self.backing[name][keys] = values

  store = CountingStorage()
  cache = hbt.EmbeddingCache(hbt.TableConfig('s', 100, 4), 8, storage=store,
                             table_shapes={'value': (4,)},
                             ctx=hbt.Context(CPU))
  slots = cache.prepare(np.asarray([1, 2, 3]))
  np.testing.assert_array_equal(cache.lookup_embeddings(slots).numpy(),
                                store.backing['value'][[1, 2, 3]])
  assert store.pulls == 1
  for base in range(0, 96, 8):
    cache.prepare(np.arange(base, base + 8))
  cache.flush()
  assert store.pushes > 0
  np.testing.assert_array_equal(store.backing['value'],
                                np.arange(400).reshape(100, 4))
  with pytest.raises(ValueError, match='table_shapes'):
    hbt.EmbeddingCache(hbt.TableConfig('s', 100, 4), 8, storage=store,
                       ctx=hbt.Context(CPU))


# -- CacheRunner under pending plans ------------------------------------------

def _runner(vocab=64, capacity=8):
  host = {'value': (np.arange(vocab)[:, None]
                    * np.ones((1, DIM))).astype(np.float32),
          'slot0': np.full((vocab, DIM), 0.1, np.float32)}
  cache = hbt.EmbeddingCache(hbt.TableConfig('big', vocab, DIM), capacity,
                             host_tables={k: v.copy()
                                          for k, v in host.items()},
                             ctx=hbt.Context(CPU))
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(hbt.TableConfig('small', 5, DIM), column='small'),
       hbt.EmbeddingSpec(cache.slot_config(), column='big')],
      dense_columns=['d0'], ctx=hbt.Context(CPU))
  tables = fx.init(torch.Generator().manual_seed(0))
  state = hbt.SparseTrainState.create(
      torch.nn.Linear(DIM * 2 + 1, 1), tables,
      lambda p: torch.optim.SGD(p, lr=0.1))
  return hbt.CacheRunner({'big': cache}, fx), cache, host, fx, state


def test_cache_runner_drain_keeps_metadata_consistent():
  runner, cache, host, fx, state = _runner(vocab=500, capacity=64)
  (sname,) = state.tables
  _, off = fx.stack_of('big').member('big')
  assert off == 5                          # behind the 'small' member
  ids1 = np.arange(0, 16, dtype=np.int64)
  ids2 = np.arange(40, 56, dtype=np.int64)
  runner.transform({'big': ids1})
  runner.transform({'big': ids2})
  state = runner.apply_next(state)
  state = runner.drain(state)
  tbl = state.tables[sname].numpy()
  for i in np.concatenate([ids1, ids2]):
    slot = int(cache.lookup_slots(np.asarray([i]))[0])
    assert slot >= 0
    np.testing.assert_array_equal(tbl[off + slot], host['value'][i])
    np.testing.assert_array_equal(
        state.table_opt[sname].acc[0].numpy()[off + slot], np.float32(0.1))


def test_checkpoint_flush_undoes_pending_plans():
  runner, cache, host, fx, state = _runner()
  ids1 = np.arange(0, 8, dtype=np.int64)       # fills the cache
  ids2 = np.arange(8, 16, dtype=np.int64)      # evicts all of ids1
  runner.transform({'big': ids1})
  runner.transform({'big': ids2})
  state = runner.apply_next(state)             # only plan 1 applied
  (sname,) = state.tables
  state.tables[sname] += 1000.0                # a training update
  runner.checkpoint_flush(state)
  stored = cache.storage.tables['value']
  np.testing.assert_array_equal(stored[ids1], host['value'][ids1] + 1000.0)
  np.testing.assert_array_equal(stored[ids2], host['value'][ids2])
  assert len(runner._plans) == 1               # no plan consumed


def test_eval_transform_consistent_under_pending_plans():
  runner, _, _, _, state = _runner()
  ids1 = np.arange(0, 8, dtype=np.int64)
  ids2 = np.arange(8, 16, dtype=np.int64)
  b1 = runner.transform({'big': ids1})
  runner.transform({'big': ids2})
  runner.apply_next(state)                     # plan 2 still queued
  np.testing.assert_array_equal(runner.eval_transform({'big': ids2})['big'],
                                -1)
  out1 = runner.eval_transform({'big': ids1})
  np.testing.assert_array_equal(np.sort(out1['big']), np.sort(b1['big']))
  assert runner.eval_transform({'big': np.asarray([40])})['big'][0] == -1
  runner.apply_next(state)
  assert (runner.eval_transform({'big': ids2})['big'] >= 0).all()


def test_eval_transform_repeated_pending_eviction_keeps_array_slot():
  runner, cache, _, _, _ = _runner()
  a = 7

  def plan(evict_slots, evict_ids, miss_slots, miss_ids):
    return {'big': CachePlan(
        slots=np.zeros((0,), np.int32),
        evict_slots=np.asarray(evict_slots, np.int64),
        evict_ids=np.asarray(evict_ids, np.int64),
        miss_slots=np.asarray(miss_slots, np.int64),
        miss_ids=np.asarray(miss_ids, np.int64))}
  runner._plans.extend([plan([1], [a], [1], [9]), plan([], [], [4], [a]),
                        plan([4], [a], [4], [10])])
  cache._set_slots(np.asarray([9, 10]), np.asarray([1, 4]))
  cache._slot_to_id[1] = 9
  cache._slot_to_id[4] = 10
  out = runner.eval_transform({'big': np.asarray([a, 9, 10], np.int64)})
  np.testing.assert_array_equal(out['big'], [1, -1, -1])


def test_cache_metadata_survives_concurrent_plans_and_reads():
  """A producer thread plans (inserting into and erasing from the native
  hash, which grows) while the consumer thread applies plans, probes
  read-only and takes checkpoint flushes, with a short switch interval:
  every resident slot's owner still maps back to it, and the flushed
  host rows are the rows the arrays hold."""
  import sys
  import threading
  runner, cache, host, fx, state = _runner(vocab=10_000, capacity=160)
  (sname,) = state.tables
  rng = np.random.RandomState(7)
  batches = [rng.randint(lo, lo + 120, 256).astype(np.int64)
             for lo in range(0, 9800, 245)]
  planned = threading.Semaphore(0)
  errors = []

  def produce():
    try:
      for ids in batches:
        runner.transform({'big': ids})
        planned.release()
    except BaseException as e:  # noqa: BLE001 — reported below
      errors.append(e)
      planned.release()

  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    thread = threading.Thread(target=produce)
    thread.start()
    for ids in batches:
      assert planned.acquire(timeout=60)
      assert not errors, errors
      state = runner.apply_next(state)
      runner.eval_transform({'big': ids[:64]})
      runner.checkpoint_flush(state)
    thread.join(timeout=60)
    assert not thread.is_alive()
  finally:
    sys.setswitchinterval(interval)
  assert not errors, errors
  resident = np.nonzero(cache._slot_to_id >= 0)[0]
  owners = cache._slot_to_id[resident]
  np.testing.assert_array_equal(cache.lookup_slots(owners), resident)
  _, off = fx.stack_of('big').member('big')
  runner.flush(state)
  np.testing.assert_array_equal(
      cache.storage.tables['value'][owners],
      state.tables[sname].numpy()[off + resident])
