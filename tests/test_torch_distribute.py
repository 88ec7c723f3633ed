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


def launch(world, cases, tmp):
  """Runs ``cases`` in ``world`` gloo CPU ranks; returns each rank's
  results."""
  with open(tmp / 'cases.pkl', 'wb') as f:
    pickle.dump(cases, f)
  env = dict(os.environ, OMP_NUM_THREADS='1')
  out = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
       str(world), '--device', 'cpu', '--timeout', str(LAUNCH_S - 10),
       '--collective-timeout', '60', WORKER, str(tmp / 'cases.pkl'),
       str(tmp)], cwd=ROOT, env=env, capture_output=True, text=True,
      timeout=LAUNCH_S)
  assert out.returncode == 0, (out.returncode, out.stdout[-3000:],
                               out.stderr[-3000:])
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
# Out-of-scope branches raise, naming ROADMAP item 15b.
# ---------------------------------------------------------------------------

def _two():
  return hbt.Context('cpu', rank=0, world_size=2)


def _sharded_inputs():
  cfg = hbt.TableConfig('t', 100, 4)
  table = torch.zeros(50, 4)
  return cfg, table, torch.zeros(6, dtype=torch.int32), torch.zeros(6, 4)


RAISES = {
    'lookup_hierarchical': lambda: hbt.lookup(
        *_sharded_inputs()[1:3], _sharded_inputs()[0], ctx=_two(),
        strategy='hierarchical'),
    'lookup_gspmd': lambda: hbt.lookup(
        *_sharded_inputs()[1:3], _sharded_inputs()[0], ctx=_two(),
        strategy='gspmd'),
    'column_table': lambda: hbt.create_table(
        hbt.TableConfig('c', 100, 4, partition='column'),
        torch.Generator(), torch.device('cpu'), _two()),
    'adagrad_nodedup': lambda: hbt.sparse_adagrad_apply(
        _sharded_inputs()[1], hbt.SparseOptState(acc=(torch.zeros(50, 4),)),
        *_sharded_inputs()[2:], _sharded_inputs()[0], 0.1, dedup=False,
        ctx=_two()),
    'adagrad_split_dense': lambda: hbt.sparse_adagrad_apply(
        _sharded_inputs()[1], hbt.SparseOptState(acc=(torch.zeros(50, 4),)),
        *_sharded_inputs()[2:], _sharded_inputs()[0], 0.1, split_dense=True,
        ctx=_two()),
    'lazy_adam': lambda: hbt.sparse_adam_apply(
        _sharded_inputs()[1], hbt.init_adam_state(_sharded_inputs()[1]),
        *_sharded_inputs()[2:], _sharded_inputs()[0], 0.1, 1, ctx=_two()),
    'sgd': lambda: hbt.sparse_sgd_apply(
        _sharded_inputs()[1], *_sharded_inputs()[2:], _sharded_inputs()[0],
        0.1, ctx=_two()),
    'topology': lambda: hbt.distribute.allreduce(
        torch.ones(2), ctx=_two(), topology=hbt.distribute.Topology.INTRA_NODE),
}
ITEMS = {'lookup_hierarchical': '15b (3)', 'lookup_gspmd': '15b (3)',
         'column_table': '15b (3)', 'adagrad_nodedup': '15b (1)',
         'adagrad_split_dense': '15b (1)', 'lazy_adam': '15b (1)',
         'sgd': '15b (1)', 'topology': '15b (3)'}


@pytest.mark.parametrize('case', sorted(RAISES))
def test_out_of_scope_raises_with_its_item(case):
  with pytest.raises(NotImplementedError, match=ITEMS[case].replace(
      '(', r'\(').replace(')', r'\)')):
    RAISES[case]()


def _fx(world, **kw):
  specs = [hbt.EmbeddingSpec(hbt.TableConfig('t', 100, 4))]
  return hbt.StackedFeatureExtractor(
      specs, ctx=hbt.Context('cpu', rank=0, world_size=world), **kw)


@pytest.mark.parametrize('case,item', [
    ('adam', '15b (1)'), ('nodedup', '15b (1)'), ('split', '15b (1)'),
    ('raw', '15b (4)'), ('trainer', '15b (5)'), ('interleave', '15b (7)')])
def test_world_steps_out_of_scope_raise(case, item):
  fx = _fx(2)
  loss = lambda *a: (torch.zeros(()), {})
  build = {
      'adam': lambda: hbt.make_sparse_train_step(fx, loss,
                                                 table_optimizer='adam'),
      'nodedup': lambda: hbt.make_sparse_train_step(fx, loss,
                                                    table_dedup=False),
      'split': lambda: hbt.make_sparse_train_step(fx, loss,
                                                  table_split_dense=True),
      'raw': lambda: hbt.make_sparse_train_step(fx, None,
                                                raw_model_loss=loss),
      'trainer': lambda: hbt.SparseTrainer(fx, loss, torch.nn.Linear(4, 1),
                                           tables={}),
      'interleave': lambda: hbt.make_interleaved_train_step(fx, loss, 2),
  }[case]
  with pytest.raises(NotImplementedError, match=item.replace(
      '(', r'\(').replace(')', r'\)')):
    build()


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
