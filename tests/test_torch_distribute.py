"""The port's world of ranks against the JAX package's mesh, on the CPU.

The partitions, ``unique`` and the update's owner buckets are pure
functions and are held bit for bit against the JAX ones in this process.
The collectives, the sharded lookups and the sharded Adagrad update run
in N gloo CPU ranks started by the port's launcher (``run.py --simulate
N --device cpu``), each rank a process of ``torch_sharded_worker.py``
that imports no JAX; all cases of one world go in one launch (a module
fixture per world, N = 2, 3 and 4). The JAX package computes the same
functions on a sub-mesh of N of the suite's 8 virtual CPU devices
(``Context(build_mesh(jax.devices()[:N]))``) from the same numpy inputs.

The updates and steps that ROADMAP item 15b (1), (4) and (7) ported build
or run at a world of two (one launch), and the dense step's gradient wire
(15b (5)) runs at a world of one as a no-op; the hierarchical and gspmd
lookups, a column-partitioned table and a node topology (15b (3)) give
JAX's values at a world of one (``test_torch_exchanges.py`` runs them at
N); what is still out of scope raises, naming its part of item 15b.

Held bit for bit: the collectives (``all_to_all_v`` against JAX's
``alltoallv``), every lookup (both strategies, a forced bucket overflow
that falls back to the exact exchange, a deduplicated exchange, and a
flat id list that needs the world padding at every N). Held at the
sparse step's ``STATE_TOL`` (``test_torch_sparse_step.py``): the sharded
Adagrad update under each exchange, whose duplicate rows are summed in
other orders on the two sides; and the forced overflow bit for bit
against the allgather route it falls back to.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.distribute import collective as jcollective
from hybridbackend_tpu.distribute import partition as jpartition
from hybridbackend_tpu.embedding import sparse_update as jsparse
from hybridbackend_tpu.embedding.lookup import lookup as jlookup
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.embedding.table import create_table as jcreate_table
from hybridbackend_tpu.embedding.unique import unique as junique
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.framework.options import OPTIONS

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.distribute import partition
from hybridbackend_tpu_torch.embedding import sparse_update
from hybridbackend_tpu_torch.embedding.unique import unique

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_sharded_worker.py')
STATE_TOL = dict(rtol=1e-5, atol=2e-6)
LAUNCH_S = 150            # a launch's deadline; the tests' is longer
VOCAB, DIM, BATCH, K = 1000, 8, 64, 3


def launch(world, cases, tmp, worker=WORKER):
  """Runs ``cases`` in ``world`` gloo CPU ranks, each a process of
  ``worker``; returns each rank's results."""
  return launched(start_launch(world, cases, tmp, worker), world, tmp)


def start_launch(world, cases, tmp, worker=WORKER, nodes=1):
  """Starts :func:`launch`'s ranks, laid out in ``nodes`` nodes, and
  returns the launcher's process (for :func:`launched`), so that this
  process works meanwhile."""
  with open(tmp / 'cases.pkl', 'wb') as f:
    pickle.dump(cases, f)
  env = dict(os.environ, OMP_NUM_THREADS='1')
  return subprocess.Popen(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
       str(world), '--nodes', str(nodes), '--device', 'cpu', '--timeout',
       str(LAUNCH_S - 10), '--collective-timeout', '60', worker,
       str(tmp / 'cases.pkl'), str(tmp)], cwd=ROOT, env=env,
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def launched(proc, world, tmp):
  """The results of each rank of :func:`start_launch`'s ``proc``."""
  try:
    stdout, stderr = proc.communicate(timeout=LAUNCH_S)
  except subprocess.TimeoutExpired:
    proc.kill()
    stdout, stderr = proc.communicate()
  assert proc.returncode == 0, (proc.returncode, stdout[-3000:],
                                stderr[-3000:])
  results = []
  for rank in range(world):
    with open(tmp / f'{rank}.pkl', 'rb') as f:
      results.append(pickle.load(f))
  return results


def jctx(world):
  return JContext(build_mesh(devices=jax.devices()[:world]))


def _ids(rng, n, high=VOCAB):
  ids = rng.randint(0, high, n).astype(np.int32)
  ids[rng.choice(n, max(1, n // 16), replace=False)] = -1
  ids[rng.choice(n, max(1, n // 20), replace=False)] = VOCAB + 7
  return ids


def _spread(rng, n, distinct):
  """``_ids`` with only ``distinct`` valid values, spread over the vocab
  (so over every rank's shard)."""
  hot = rng.choice(VOCAB, distinct, replace=False)
  ids = _ids(rng, n, high=distinct)
  return np.where((ids >= 0) & (ids < distinct),
                  hot[np.clip(ids, 0, distinct - 1)], ids).astype(np.int32)


# ---------------------------------------------------------------------------
# Pure functions, bit for bit in this process.
# ---------------------------------------------------------------------------

def _same(got, want):
  np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_partition(got, want):
  for field in ('buckets', 'sizes', 'restore', 'overflow'):
    _same(getattr(got, field), getattr(want, field))


PARTITIONS = {
    'modulo': dict(num_shards=4),
    'modulo_cap': dict(num_shards=4, capacity=9, fill_value=-1),
    'modulo_negative': dict(num_shards=3, negative=True),
    'fn_valid_cap': dict(num_shards=4, capacity=12, fill_value=-1,
                         valid=True),
    'fn_valid_overflow': dict(num_shards=2, capacity=5, fill_value=-1,
                              valid=True),
}


@pytest.mark.parametrize('case', sorted(PARTITIONS))
def test_partition_matches_jax(case):
  spec = dict(PARTITIONS[case])
  rng = np.random.RandomState(len(case))
  ids = rng.randint(-50 if spec.pop('negative', False) else 0, 200,
                    48).astype(np.int32)
  w = spec.pop('num_shards')
  if spec.pop('valid', False):
    valid = ids % 7 != 0
    fn_j = lambda x: jnp.clip(x // 50, 0, w - 1)
    fn_t = lambda x: torch.div(x, 50, rounding_mode='floor').clamp(0, w - 1)
    want = jpartition.partition_by_fn(jnp.asarray(ids), w, fn_j,
                                      valid=jnp.asarray(valid), **spec)
    got = partition.partition_by_fn(torch.from_numpy(ids), w, fn_t,
                                    valid=torch.from_numpy(valid), **spec)
  else:
    want = jpartition.partition_by_modulo(jnp.asarray(ids), w, **spec)
    got = partition.partition_by_modulo(torch.from_numpy(ids), w, **spec)
  _same_partition(got, want)
  payload = rng.rand(w * got.buckets.shape[1], 3).astype(np.float32)
  _same(partition.unpartition(torch.from_numpy(payload), got.restore),
        jpartition.unpartition(jnp.asarray(payload), want.restore))


def test_dual_modulo_matches_jax():
  ids = np.random.RandomState(3).randint(0, 500, 40).astype(np.int32)
  want, want_keys = jpartition.partition_by_dual_modulo(
      jnp.asarray(ids), 2, 3, capacity=16, fill_value=-1)
  got, got_keys = partition.partition_by_dual_modulo(
      torch.from_numpy(ids), 2, 3, capacity=16, fill_value=-1)
  _same_partition(got, want)
  _same(got_keys, want_keys)


@pytest.mark.parametrize('capacity,fill', [(None, 0), (40, -1), (12, -1),
                                           (1, 5)])
def test_unique_matches_jax(capacity, fill):
  ids = np.random.RandomState(4).randint(-3, 30, 50).astype(np.int32)
  want = junique(jnp.asarray(ids), capacity=capacity, fill_value=fill)
  got = unique(torch.from_numpy(ids), capacity=capacity, fill_value=fill)
  for field in ('values', 'index', 'count', 'overflowed'):
    _same(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize('cap', [3, 8, 40])
def test_owner_buckets_match_jax(cap):
  """``_local_combine`` then ``_bucket_by_owner``: the ids, gradient
  totals, sizes and overflow of every bucket, bit for bit (cap 3
  overflows)."""
  rng = np.random.RandomState(cap)
  rows = rng.randint(-1, 60, 40).astype(np.int32)
  g = rng.randn(40, 4).astype(np.float32)
  want_u = jsparse._local_combine(jnp.asarray(rows), jnp.asarray(g))
  got_u = sparse_update._local_combine(torch.from_numpy(rows),
                                       torch.from_numpy(g))
  for a, b in zip(got_u, want_u):
    _same(a, b)
  want = jsparse._bucket_by_owner(*want_u, 4, 15, cap)
  got = sparse_update._bucket_by_owner(*got_u, 4, 15, cap)
  for a, b in zip(got, want):
    _same(a, b)


@pytest.mark.parametrize('world', [2, 3, 4])
def test_world_slice_pads_as_jax(world):
  """``world_slice`` cuts a flat id list as the JAX lookup pads it to the
  world (with -1) and ``shard_map`` splits it."""
  flat = np.arange(101, dtype=np.int32)
  padded = -(-101 // world) * world
  want = np.concatenate([flat, np.full(padded - 101, -1, np.int32)])
  parts = [hbt.world_slice(torch.from_numpy(flat),
                           hbt.Context('cpu', rank=r, world_size=world))
           for r in range(world)]
  _same(torch.cat(parts), want)


@pytest.mark.parametrize('world', [2, 3, 4])
@pytest.mark.parametrize('min_rows', [0, 999, 2000])
def test_shard_policy_matches_jax(world, min_rows):
  """``should_shard``, ``padded_vocab`` and the stacks' world-aligned
  member offsets (``build_stacks``) follow the JAX package's policy."""
  ctx = hbt.Context('cpu', rank=0, world_size=world)
  jc = jctx(world)
  configs = [(f't{i}', v, 8) for i, v in enumerate((1000, 3, 55, 1001))]
  with context_scope(jc), OPTIONS.override(emb_min_shard_rows=min_rows):
    from hybridbackend_tpu.embedding.stack import build_stacks
    jstacks = build_stacks([JTableConfig(*c) for c in configs], jc)
    for c in configs:
      j, t = JTableConfig(*c), hbt.TableConfig(*c)
      assert t.should_shard(ctx, min_rows) == j.should_shard(jc)
      t = dataclasses.replace(t, sharded=t.should_shard(ctx, min_rows))
      assert t.padded_vocab(ctx) == j.padded_vocab(jc)
  stacks = hbt.build_stacks([hbt.TableConfig(*c) for c in configs], ctx,
                            min_rows)
  assert [(s.stacked.name, s.offsets, s.stacked.vocab_size,
           s.stacked.padded_vocab(ctx)) for s in stacks] == [
               (s.stacked.name, s.offsets, s.stacked.vocab_size,
                s.stacked.padded_vocab(jc)) for s in jstacks]


# ---------------------------------------------------------------------------
# The branches that ROADMAP item 15b (1), (2), (3), (4) and (9) ported run;
# what is still out of scope raises, naming its part of item 15b.
# ---------------------------------------------------------------------------

def _two():
  return hbt.Context('cpu', rank=0, world_size=2)


def _at_one(case):
  """``(port, JAX)`` of a call that raised ROADMAP item 15b (3) at a
  world of two before it was ported, made at a world of one, where every
  table is whole: the hierarchical and gspmd lookups and a
  column-partitioned table's (a JAX table, lane-packed on one device,
  is the port's through ``reshape(-1, dim)``), and an all-reduce over
  one node."""
  jc = jctx(1)
  one = hbt.Context('cpu')
  partition = 'column' if case == 'column_table' else 'row'
  ids = np.random.RandomState(5).randint(-3, 110, (6, 2)).astype(np.int32)
  if case == 'topology':
    x = np.arange(5, dtype=np.float32)
    with context_scope(jc):
      want = jcollective.allreduce(
          jnp.asarray(x), topology=jcollective.Topology.INTRA_NODE, ctx=jc)
    return hbt.distribute.allreduce(
        torch.from_numpy(x), ctx=one,
        topology=hbt.distribute.Topology.INTRA_NODE), want
  strategy = {'lookup_hierarchical': 'hierarchical',
              'lookup_gspmd': 'gspmd'}.get(case, 'allgather')
  with context_scope(jc):
    jcfg = JTableConfig('t', 100, 4, partition=partition)
    table = jcreate_table(jcfg, jax.random.PRNGKey(3), jc)
    want = jlookup(table, jnp.asarray(ids), jcfg, ctx=jc, strategy=strategy)
  cfg = hbt.TableConfig('t', 100, 4, partition=partition)
  made = hbt.create_table(cfg, torch.Generator().manual_seed(0),
                          torch.device('cpu'), one)
  assert made.shape == (cfg.padded_vocab(one), 4) == (100, 4)
  got = hbt.lookup(torch.from_numpy(np.asarray(table).reshape(-1, 4).copy()),
                   torch.from_numpy(ids), cfg, ctx=one, strategy=strategy)
  return got, want


AT_ONE = ('column_table', 'lookup_gspmd', 'lookup_hierarchical', 'topology')


@pytest.mark.parametrize('case', AT_ONE)
def test_ported_branches_match_jax_at_a_world_of_one(case):
  got, want = _at_one(case)
  _same(got, want)


def _fx(world, **kw):
  specs = [hbt.EmbeddingSpec(hbt.TableConfig('t', 100, 4))]
  return hbt.StackedFeatureExtractor(
      specs, ctx=hbt.Context('cpu', rank=0, world_size=world), **kw)


def test_dense_step_wire_is_a_no_op_at_a_world_of_one():
  """``make_train_step(gradient_wire_dtype='bfloat16')`` builds and, at a
  world of one, steps as the f32 step does, bit for bit, with no
  ``wire_grad`` (JAX ``want_wire``); it runs at a world of N in
  ``test_torch_sharded_trainer.py``."""
  states = []
  for wire in (None, 'bfloat16'):
    module = torch.nn.Linear(4, 1)
    with torch.no_grad():
      module.weight.copy_(torch.arange(4.0).reshape(1, 4) / 10)
      module.bias.zero_()
    state = hbt.TrainState.create(
        module, torch.optim.SGD(module.parameters(), lr=0.1))
    step = hbt.make_train_step(
        lambda m, b: (torch.mean((m(b['x']) - 1.0) ** 2), {}),
        gradient_wire_dtype=wire, ctx=hbt.Context('cpu'))
    state, metrics = step(state, {'x': torch.ones(3, 4) / 3})
    assert 'wire_grad' not in metrics
    states.append(module.weight.detach().clone())
  assert torch.equal(*states) and not torch.equal(
      states[0], torch.arange(4.0).reshape(1, 4) / 10)


def _cache_ranks(world, store, vocab=500, cap=64):
  """Each rank's ``(cache, runner)`` of one host table over ``store``,
  their runner ids counted from 0 (as in fresh processes)."""
  from hybridbackend_tpu_torch.embedding import service
  service._RUNNER_IDS.clear()
  out = []
  for r in range(world):
    ctx = hbt.Context('cpu', rank=r, world_size=world, store=store)
    host = {'value': np.arange(vocab * 4, dtype=np.float32).reshape(-1, 4)}
    cache = hbt.EmbeddingCache(hbt.TableConfig('t', vocab, 4), cap,
                               host_tables=host, ctx=ctx)
    fx = hbt.StackedFeatureExtractor(
        [hbt.EmbeddingSpec(cache.slot_config(), column='t')], ctx=ctx)
    out.append((cache, hbt.embedding.service.CacheRunner({'t': cache}, fx,
                                                         timeout_ms=5000)))
  return out


def test_cache_runners_of_a_world_plan_its_batch():
  """Host-backed tables in a world (once refused as ROADMAP item 15b
  (10)): two ranks' runners, threads over one store, exchange their
  rows' ids and plan the world's batch, each getting its rows' slots;
  their slot maps are a world of one's over the global batches, bit for
  bit, and each rank deletes its key of step ``s - 2`` at step ``s``."""
  import threading
  store = torch.distributed.HashStore()
  ranks = _cache_ranks(2, store)
  rng = np.random.RandomState(0)
  steps = [rng.randint(0, 500, 48).astype(np.int64) for _ in range(6)]
  one = hbt.EmbeddingCache(hbt.TableConfig('t', 500, 4), 64, host_tables={
      'value': np.zeros((500, 4), np.float32)}, ctx=hbt.Context('cpu'))
  got = [[], []]

  def run(r):
    _, runner = ranks[r]
    for ids in steps:
      got[r].append(runner.transform({'t': ids[r * 24:(r + 1) * 24]})['t'])

  threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(30)
  for k, ids in enumerate(steps):
    want = one.prepare_plan(ids).slots
    np.testing.assert_array_equal(np.concatenate([got[0][k], got[1][k]]),
                                  want)
  for cache, _ in ranks:
    np.testing.assert_array_equal(cache._slot_to_id, one._slot_to_id)
    np.testing.assert_array_equal(cache._last_used, one._last_used)
  keys = lambda s: [f'hb_cache/0/{s}/{r}' for r in range(2)]
  assert not any(store.check([k]) for s in range(4) for k in keys(s))
  assert all(store.check([k]) for s in (4, 5) for k in keys(s))


@pytest.mark.parametrize('kw', [
    {}, dict(table_optimizer='adam', lookup_strategy='hierarchical',
             gradient_wire_dtype='bfloat16')], ids=['adagrad', 'adam'])
def test_interleaved_step_builds_at_a_world_of_two(kw):
  """The interleaved step, which raised ROADMAP item 15b (7) at a world
  of two, builds there now (``test_torch_sharded_interleave.py`` runs it
  against JAX); a wire dtype it cannot cast to fails at build."""
  loss = lambda *a: (torch.zeros(()), {})
  assert callable(hbt.make_interleaved_train_step(_fx(2), loss, 2, **kw))
  with pytest.raises(ValueError):
    hbt.make_interleaved_train_step(_fx(2), loss, 2, wire_dtype='int8')


@pytest.mark.parametrize('case,kw', [
    ('adam', dict(table_optimizer='adam')),
    ('nodedup', dict(table_dedup=False)),
    ('split', dict(table_split_dense=True)),
    ('raw', dict(raw_model_loss=lambda *a: (torch.zeros(()), {}))),
])
def test_world_steps_build_at_a_world_of_two(case, kw):
  """The steps that raised ROADMAP item 15b (1) and (4) at a world of two
  build there now (``test_torch_sharded_optimizers.py`` and
  ``test_torch_sharded_din.py`` run them against JAX)."""
  loss = None if case == 'raw' else (lambda *a: (torch.zeros(()), {}))
  step = hbt.make_sparse_train_step(_fx(2), loss, **kw)
  assert callable(step)


# The four updates that raised ROADMAP item 15b (1) at a world of two, each
# on the rank's half of a tiny list.
WORLD_CALLS = ('adagrad_nodedup', 'adagrad_split_dense', 'lazy_adam', 'sgd')


@pytest.fixture(scope='module')
def world_calls(tmp_path_factory):
  rng = np.random.RandomState(7)
  ids = rng.randint(0, 100, 8).astype(np.int32)
  demb = rng.randn(8, 4).astype(np.float32)
  table = rng.randn(100, 4).astype(np.float32)
  cases = []
  for case, optimizer, opts in (
      ('adagrad_nodedup', 'adagrad', dict(dedup=False)),
      ('adagrad_split_dense', 'adagrad', dict(split_dense=True)),
      ('lazy_adam', 'adam', {}), ('sgd', 'sgd', {})):
    slots = {'adagrad': [np.full_like(table, 0.1)], 'sgd': [],
             'adam': [np.zeros_like(table)] * 2}[optimizer]
    cases.append((case, 'applies', dict(
        optimizer=optimizer, lr=LR, rounds=[(ids, demb)],
        tables={'t': dict(vocab=100, dim=4, sharded=True, table=table,
                          slots=slots)},
        cases={case: ('t', opts)})))
  return ids, table, launch(2, cases, tmp_path_factory.mktemp('calls'))


@pytest.mark.timeout(LAUNCH_S + 30)
@pytest.mark.parametrize('case', WORLD_CALLS)
def test_world_updates_run_at_a_world_of_two(world_calls, case):
  """Each returns on both ranks, with its shard moved where the list
  touched it and nowhere else."""
  ids, table, ranks = world_calls
  for rank, res in enumerate(ranks):
    rows = slice(50 * rank, 50 * rank + 50)
    got = res[case][case]['trace'][0][0]
    assert got.shape == (50, 4) and np.isfinite(got).all()
    touched = np.zeros(100, bool)
    touched[ids] = True
    moved = (got != table[rows]).any(axis=1)
    np.testing.assert_array_equal(moved, touched[rows])


# ---------------------------------------------------------------------------
# N gloo ranks against N devices of the JAX mesh.
# ---------------------------------------------------------------------------

# (id set, options): both strategies on a flat list that needs the world
# padding and on a block of batch rows, the forced overflow on the block,
# and the dedup on ids with 20 distinct values (which fit its capacity).
LOOKUP_CASES = [('flat', 'allgather'), ('flat', 'alltoall'),
                ('block', 'allgather'), ('block', 'alltoall'),
                ('block', 'alltoall_overflow'), ('dups', 'dedup')]
LOOKUP_OPTIONS = {
    'allgather': (dict(strategy='allgather'),
                  dict(emb_lookup_strategy='allgather')),
    'alltoall': (dict(strategy='alltoall'),
                 dict(emb_lookup_strategy='alltoall')),
    # A bucket of ceil(0.05·n/W) ids overflows on every rank: the exact
    # exchange runs instead.
    'alltoall_overflow': (
        dict(strategy='alltoall', bucket_ratio=0.05),
        dict(emb_lookup_strategy='alltoall', emb_lookup_bucket_ratio=0.05)),
    'dedup': (dict(strategy='alltoall', unique_ratio=0.5),
              dict(emb_lookup_strategy='alltoall', emb_unique_ratio=0.5)),
}
UPDATE_OPTIONS = {
    'alltoall': (dict(exchange='alltoall'),
                 dict(emb_update_exchange='alltoall')),
    'alltoall_overflow': (
        dict(exchange='alltoall', bucket_ratio=0.05),
        dict(emb_update_exchange='alltoall', emb_update_bucket_ratio=0.05)),
    'allgather': (dict(exchange='allgather'),
                  dict(emb_update_exchange='allgather')),
}
LR = 0.05


def _inputs(world):
  """The cases of one world, from seeded numpy draws."""
  rng = np.random.RandomState(world)
  w = world
  buckets = rng.randint(-1, 500, (w, w, 5)).astype(np.int32)
  sizes = rng.randint(0, 6, (w, w)).astype(np.int32)
  vocab = JTableConfig('lk', VOCAB, DIM).padded_vocab(jctx(world))
  table = rng.randn(vocab, DIM).astype(np.float32)
  # A batch of rows that splits over the world.
  batch = BATCH - BATCH % world
  # 'dups' holds 20 distinct ids: their unique share fits the dedup case's
  # capacity, which the others overflow.
  ids = {'flat': _ids(rng, 101), 'block': _ids(rng, batch * K).reshape(
      batch, K), 'dups': _spread(rng, batch * K, 20).reshape(batch, K)}
  cases = [('collectives', 'collectives', dict(buckets=buckets, sizes=sizes)),
           ('lookups', 'lookups', dict(
               name='lk', vocab=VOCAB, dim=DIM, table=table, ids=ids,
               cases=LOOKUP_CASES,
          options={k: v[0] for k, v in LOOKUP_OPTIONS.items()}))]
  upd_ids = _spread(rng, batch * K, 300).reshape(batch, K)
  cases.append(('updates', 'updates', dict(
      name='up', vocab=VOCAB, dim=DIM, lr=LR, table=table,
      acc=np.full_like(table, 0.1) + rng.rand(*table.shape).astype(
          np.float32),
      ids=upd_ids, demb=rng.randn(batch, K, DIM).astype(np.float32) * 0.1,
      options={k: v[0] for k, v in UPDATE_OPTIONS.items()})))
  return cases


@pytest.fixture(scope='module', params=[2, 3, 4])
def world(request, tmp_path_factory):
  w = request.param
  cases = _inputs(w)
  results = launch(w, cases, tmp_path_factory.mktemp(f'world{w}'))
  return w, dict((name, spec) for name, _, spec in cases), results


@pytest.mark.timeout(LAUNCH_S + 60)
def test_collectives_match_jax(world):
  w, specs, ranks = world
  spec = specs['collectives']
  jc = jctx(w)
  recv, rsizes = jcollective.alltoallv(
      jnp.asarray(spec['buckets']), jnp.asarray(spec['sizes']), ctx=jc)
  recv, rsizes = np.asarray(recv), np.asarray(rsizes)
  xs = [np.arange(6, dtype=np.float32) * (r + 1) for r in range(w)]
  for r, res in enumerate(ranks):
    got = res['collectives']
    _same(got['a2av'], recv[r])
    _same(got['a2av_sizes'], rsizes[r])
    _same(got['sum'], np.sum(xs, axis=0))
    _same(got['max'], np.max(xs, axis=0))
    np.testing.assert_allclose(got['mean'], np.mean(xs, axis=0), rtol=1e-6)
    _same(got['bcast'], xs[1] + 10)
    _same(got['gather'], np.concatenate([xs[q][:2] + q for q in range(w)]))
    _same(got['a2a'], np.array([100 * q + 2 * r + i for q in range(w)
                                for i in range(2)], np.int32))
    _same(got['rs'], sum(np.arange(3 * w, dtype=np.float32).reshape(w, 3)
                         + q for q in range(w))[r])


@pytest.mark.timeout(LAUNCH_S + 120)
def test_lookups_match_jax(world):
  w, specs, ranks = world
  spec = specs['lookups']
  jc = jctx(w)
  cfg = JTableConfig('lk', VOCAB, DIM)
  for ids_name, opt_name in LOOKUP_CASES:
    ids = spec['ids'][ids_name]
    # Under jit: one compile, a tenth of the op-by-op time.
    with context_scope(jc), OPTIONS.override(**LOOKUP_OPTIONS[opt_name][1]):
      want = np.asarray(jax.jit(lambda t, i: jlookup(t, i, cfg, ctx=jc))(
          jnp.asarray(spec['table']), jnp.asarray(ids)))
    key = f'{ids_name}/{opt_name}'
    got = np.concatenate([r['lookups'][key] for r in ranks])
    if ids.ndim == 1:
      got = got[:ids.shape[0]]
    _same(got, want)
    fallbacks = [r['lookups'][key + '/fallbacks'] for r in ranks]
    assert len(set(fallbacks)) == 1, fallbacks   # every rank alike
    # The balanced exchanges fit their buckets; the forced one does not.
    assert fallbacks[0] == (opt_name == 'alltoall_overflow'), key


@pytest.mark.timeout(LAUNCH_S + 120)
def test_sharded_adagrad_matches_jax(world):
  w, specs, ranks = world
  spec = specs['updates']
  jc = jctx(w)
  cfg = JTableConfig('up', VOCAB, DIM)
  for name, (_, jopts) in UPDATE_OPTIONS.items():
    with context_scope(jc), OPTIONS.override(**jopts):
      table, state = jax.jit(lambda t, a, i, g: jsparse.sparse_adagrad_apply(
          t, jsparse.SparseOptState(acc=(a,)), i, g, cfg, LR, ctx=jc))(
              jnp.asarray(spec['table']), jnp.asarray(spec['acc']),
              jnp.asarray(spec['ids']), jnp.asarray(spec['demb']))
    got_t = np.concatenate([r['updates'][name][0] for r in ranks])
    got_a = np.concatenate([r['updates'][name][1] for r in ranks])
    np.testing.assert_allclose(got_t, np.asarray(table), **STATE_TOL)
    np.testing.assert_allclose(got_a, np.asarray(state.acc[0]), **STATE_TOL)
    fallbacks = [r['updates'][name + '/fallbacks'] for r in ranks]
    assert fallbacks == [int(name == 'alltoall_overflow')] * w, (name,
                                                                  fallbacks)
  # The forced overflow takes the allgather route: the same bits.
  for r in ranks:
    for a, b in zip(r['updates']['alltoall_overflow'],
                    r['updates']['allgather']):
      _same(a, b)
