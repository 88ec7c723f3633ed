"""Sharded serving at a world of N against the JAX package, on the CPU.

The port runs N gloo CPU ranks (``run.py --simulate N --nodes M --device
cpu``; N = 2 in one node, N = 4 in two nodes of two), each a process of
``torch_sharded_worker.py`` that imports no JAX, one launch a world. The
JAX package computes the same functions on ``Mesh(devices[:N].reshape(M,
N/M), ('dcn', 'ici'))`` from the same numpy inputs.

int8 tables, from seeded tables whose row magnitudes span 1e-3 to 1e2:

* ``q512`` ([512, 16]; JAX lane-packs it to [64, 128], which the world
  divides, so the shard bounds agree): ``shard_quantized`` +
  ``lookup_quantized`` against JAX's ``shard_quantized`` +
  ``lookup_quantized``, and ``quantized_from_jax`` of JAX's global
  arrays is the port's shard;
* ``q2408`` ([2408, 16]: 301 packed rows, which the world does not
  divide; JAX pads them, the port's rows divide): against JAX's sharded
  lookup and the replicated one, as ``tests/test_quant.py:155-176``;
* ``q301`` ([301, 12]: not packed by JAX, which refuses it sharded; the
  port pads its rows to the world): against the port's world of one.

Each on a flat id list of 335 (not a multiple of the world: ``world_slice``
pads it with -1) and a [64, 3] block, with invalid and out-of-vocab ids.
Held bit for bit, the bar reached (JAX's own test allows 1e-5): each id's
value is one owner's product plus exact zeros. ``quantize_table`` of a
rank's float shard is ``shard_quantized`` of the quantized whole table,
bit for bit; ``lookup`` of a ``QuantizedTable`` shard under the alltoall
strategy runs the same allgather exchange; a whole quantized table at a
world of N is looked up locally, as at a world of one. Kernel 5 (its
plain version here; the worker counts the calls) runs twice a sharded
int8 lookup, rows and scales.

Float shards of a [300, 8] table served (``serving=True``) under every
row strategy (``allgather``, ``alltoall``, ``hierarchical``, ``gspmd``)
and column-sharded, bit for bit the training lookup's and the whole
table's rows, with no autograd graph and the owners' gathers through
kernel 5; ``extract_features`` over the members' int8 shards against
JAX's over its sharded int8 tables, bit for bit; ``lookup_raw`` over a
quantized stack shard against the world of one's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hybridbackend_tpu.embedding.quant import (
    lookup_quantized as jlookup_quantized, quantize_table as jquantize,
    shard_quantized as jshard_quantized)
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import (
    Context as JContext, context_scope)
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec, extract_features as jextract_features)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.embedding.lookup import STRATEGIES
from test_torch_distribute import LAUNCH_S, launched, start_launch

WORLDS = {2: 1, 4: 2}          # ranks -> nodes
# name -> (vocab, dim, whether JAX serves it sharded)
INT8 = {'q512': (512, 16, True), 'q2408': (2408, 16, True),
        'q301': (301, 12, False)}
# case -> (TableConfig keywords, lookup options)
FLOAT_CASES = {s: ({}, dict(strategy=s)) for s in STRATEGIES}
FLOAT_CASES['column'] = (dict(partition='column'), {})
FEATURES = [('e0', 512, 16), ('e1', 2408, 16)]
N_FLAT, BLOCK = 333, (64, 3)
CPU = torch.device('cpu')


def _table(rng, v, d):
  t = rng.randn(v, d) * 10.0 ** rng.uniform(-3, 2, (v, 1))
  t[3] = 0.0
  return t.astype(np.float32)


def _ids(rng, shape, vocab):
  ids = rng.randint(0, vocab, shape).astype(np.int32)
  flat = ids.reshape(-1)
  flat[rng.choice(flat.size, 8, replace=False)] = -1
  flat[rng.choice(flat.size, 5, replace=False)] = vocab + 7
  return ids


def _jmesh(world):
  devices = np.array(jax.devices()[:world]).reshape(WORLDS[world], -1)
  return JContext(Mesh(devices, ('dcn', 'ici')))


def _inputs(world, rng):
  ctx = hbt.Context('cpu', rank=0, world_size=world)
  int8 = {}
  for name, (v, d, _) in INT8.items():
    rows = hbt.TableConfig(name, v, d).padded_vocab(ctx)
    int8[name] = dict(vocab=v, dim=d, kw={}, whole=_table(rng, rows, d))
  ids = {'flat': np.r_[_ids(rng, (N_FLAT,), 2408), [-1, 9999]].astype(
      np.int32), 'block': _ids(rng, BLOCK, 300)}
  stack_cfg, = hbt.build_stacks([hbt.TableConfig(*t) for t in FEATURES], ctx)
  batch = {n: _ids(rng, (64,), v) for n, v, _ in FEATURES}
  batch['d0'] = rng.rand(64).astype(np.float32)
  return dict(
      int8=int8, ids=ids, float=rng.randn(300, 8).astype(np.float32),
      float_cases=FLOAT_CASES,
      features=dict(tables=FEATURES, batch=batch,
                    arrays={n: _table(rng, hbt.TableConfig(n, v, d)
                                      .padded_vocab(ctx), d)
                            for n, v, d in FEATURES},
                    stack=_table(rng, stack_cfg.stacked.padded_vocab(ctx),
                                 16)))


def _jax_int8(world, spec):
  """JAX's quantized whole tables, their ``shard_quantized`` global
  arrays, and its sharded and replicated lookups of each id set."""
  jc = _jmesh(world)
  out = {}
  for name, (v, d, sharded) in INT8.items():
    if not sharded:
      continue
    qt = jquantize(spec['int8'][name]['whole'][:v])
    assert qt.pack == 128 // d
    cfg = JTableConfig(name, v, d)
    replicated = JTableConfig(name, v, d, sharded=False)
    res = {}
    with context_scope(jc):
      sq = jshard_quantized(qt, jc)
      res['global'] = (np.asarray(sq.q), np.asarray(sq.scale))
      fn = jax.jit(lambda q, i, cfg=cfg: jlookup_quantized(q, i, cfg, ctx=jc))
      for ids_name, ids in spec['ids'].items():
        res[ids_name] = (np.asarray(fn(sq, jnp.asarray(ids))),
                         np.asarray(jlookup_quantized(qt, jnp.asarray(ids),
                                                      replicated)))
    out[name] = res
  return out


def _jax_features(world, fs):
  jc = _jmesh(world)
  specs = [JEmbeddingSpec(JTableConfig(*t)) for t in FEATURES]
  with context_scope(jc):
    tables = {n: jshard_quantized(jquantize(fs['arrays'][n][:v]), jc)
              for n, v, _ in FEATURES}
    emb, dense = jax.jit(lambda t, b: jextract_features(
        t, b, specs, ['d0'], ctx=jc))(
            tables, {k: jnp.asarray(v) for k, v in fs['batch'].items()})
  return [np.asarray(e) for e in emb], [np.asarray(d) for d in dense]


@pytest.fixture(scope='module', params=sorted(WORLDS))
def world(request, tmp_path_factory):
  """One launch a world; JAX's oracles made while its ranks run."""
  w = request.param
  spec = _inputs(w, np.random.RandomState(18 + w))
  jax_int8 = _jax_int8(w, spec)
  for name, t in spec['int8'].items():
    t['jax'] = jax_int8[name]['global'] if name in jax_int8 else None
  tmp = tmp_path_factory.mktemp(f'serving{w}')
  proc = start_launch(w, [('serving', 'serving', spec)], tmp, nodes=WORLDS[w])
  jax_features = _jax_features(w, spec['features'])
  ranks = [r['serving'] for r in launched(proc, w, tmp)]
  return dict(w=w, spec=spec, jax=jax_int8, features=jax_features,
              ranks=ranks)


def _same(got, want, msg=''):
  np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                err_msg=msg)


def _joined(ranks, pick, n):
  """The ranks' results of a global id array, joined back: a flat list's
  first ``n`` (the rest is ``world_slice``'s padding)."""
  got = np.concatenate([pick(r) for r in ranks])
  return got[:n]


def _one(qt, ids, cfg):
  """The world of one's ``lookup_quantized``."""
  return hbt.lookup_quantized(qt, torch.from_numpy(ids), cfg).numpy()


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('name', sorted(INT8))
@pytest.mark.parametrize('ids_name', ['flat', 'block'])
def test_sharded_int8_lookup_matches_jax_and_the_world_of_one(world, name,
                                                              ids_name):
  w, spec = world['w'], world['spec']
  t = spec['int8'][name]
  v, d, sharded = INT8[name]
  ids = spec['ids'][ids_name]
  cfg = hbt.TableConfig(name, v, d)
  want = _one(hbt.quantize_table(torch.from_numpy(t['whole'])), ids, cfg)
  n = ids.shape[0]
  got = _joined(world['ranks'], lambda r: r['int8'][name][ids_name]['emb'], n)
  _same(got, want, f'{name} {ids_name} at {w}')
  for r in world['ranks']:
    res = r['int8'][name][ids_name]
    _same(res['by_lookup'], res['emb'], 'lookup, strategy alltoall')
    assert res['gathers'] == 2
  # A whole quantized table at a world of N is looked up locally.
  whole = _joined(world['ranks'], lambda r: r['int8'][name][ids_name]['whole'],
                  n)
  _same(whole, want, 'the whole table')
  assert np.all(got.reshape(-1, d)[(ids.reshape(-1) < 0)
                                   | (ids.reshape(-1) >= v)] == 0)
  if sharded:
    jsharded, jreplicated = world['jax'][name][ids_name]
    _same(got, jsharded, f'JAX sharded, {name} {ids_name}')
    _same(got, jreplicated, f'JAX replicated, {name} {ids_name}')


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('name', sorted(INT8))
def test_quantized_shard_is_the_shard_of_the_quantized_table(world, name):
  """``quantize_table`` of each rank's float shard is its
  ``shard_quantized`` of the quantized whole table, bit for bit; the
  shards joined are the quantized whole; ``quantized_from_jax`` of JAX's
  global arrays gives the same shard where JAX serves the table."""
  w, spec = world['w'], world['spec']
  t = spec['int8'][name]
  whole = hbt.quantize_table(torch.from_numpy(t['whole']))
  _same(np.concatenate([r['int8'][name]['q'] for r in world['ranks']]),
        whole.q.numpy())
  _same(np.concatenate([r['int8'][name]['scale'] for r in world['ranks']]),
        whole.scale.numpy())
  for r in world['ranks']:
    assert r['int8'][name]['quantized_shard_equal']
    if INT8[name][2]:
      assert r['int8'][name]['from_jax_equal']


def test_shard_quantized_pads_and_refuses_columns():
  """Rows past the whole table's end are ``q = 0``, ``scale = 1``; an
  unsharded config keeps the table; a column config raises."""
  qt = hbt.quantize_table(torch.randn(301, 4))
  ctx = hbt.Context('cpu', rank=1, world_size=2)
  cfg = hbt.TableConfig('t', 301, 4)
  shard = hbt.shard_quantized(qt, cfg, ctx)
  assert shard.q.shape == (151, 4) and cfg.padded_vocab(ctx) == 302
  assert torch.equal(shard.q[:150], qt.q[151:])
  assert torch.equal(shard.q[150], torch.zeros(4, dtype=torch.int8))
  assert float(shard.scale[150]) == 1.0
  assert hbt.shard_quantized(qt, hbt.TableConfig('t', 301, 4, sharded=False),
                             ctx) is qt
  with pytest.raises(ValueError, match='sharded by rows'):
    hbt.shard_quantized(qt, hbt.TableConfig('t', 301, 4, partition='column'),
                        ctx)


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('case', sorted(FLOAT_CASES))
def test_served_float_shards_are_the_training_lookup(world, case):
  """``serving=True`` on each rank's float shard, bit for bit the training
  lookup's and the whole table's rows; no autograd graph; the owners'
  gathers through kernel 5 (none in the training lookup)."""
  spec = world['spec']
  table = spec['float']
  for ids_name, ids in spec['ids'].items():
    n = ids.shape[0]
    valid = (ids >= 0) & (ids < 300)
    want = np.where(valid[..., None], table[np.clip(ids, 0, 299)], 0)
    served = _joined(world['ranks'],
                     lambda r: r['float'][case][ids_name]['served'], n)
    trained = _joined(world['ranks'],
                      lambda r: r['float'][case][ids_name]['trained'], n)
    _same(served, trained, f'{case} {ids_name}')
    _same(served, want, f'{case} {ids_name}')
    for r in world['ranks']:
      res = r['float'][case][ids_name]
      assert res['grad'] == (False, True)
      assert res['gathers'][0] >= 1 and res['gathers'][1] == 0, res


@pytest.mark.timeout(LAUNCH_S + 120)
def test_features_through_int8_shards_match_jax(world):
  """``extract_features`` over each member's int8 shard (``quantize_table``
  of the float shard) against JAX's over its sharded int8 tables, bit for
  bit; two kernel-5 calls a member."""
  jemb, jdense = world['features']
  ranks = world['ranks']
  for i, want in enumerate(jemb):
    _same(np.concatenate([r['features']['emb'][i] for r in ranks]), want,
          FEATURES[i][0])
  for i, want in enumerate(jdense):
    _same(np.concatenate([r['features']['dense'][i] for r in ranks]), want)
  for r in ranks:
    assert r['features']['gathers'] == 2 * len(FEATURES)


@pytest.mark.timeout(LAUNCH_S + 120)
def test_quantized_stack_shards_serve_the_world_of_one(world):
  """``lookup_raw(serving=True)`` over each rank's quantized stack shard
  against the world of one's over the quantized whole stack, bit for
  bit: two kernel-5 calls a stack."""
  fs = world['spec']['features']
  # The world's stack layout (its members' offsets are aligned to the
  # world), looked up at a world of one.
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(hbt.TableConfig(*t)) for t in FEATURES],
      dense_columns=['d0'],
      ctx=hbt.Context('cpu', rank=0, world_size=world['w']))
  (stack,) = fx.stacks
  name = stack.stacked.name
  ids, _ = hbt.pack_ids(stack, fx.member_ids(
      {k: torch.from_numpy(v) for k, v in fs['batch'].items()})[name])
  want = hbt.lookup_quantized(hbt.quantize_table(torch.from_numpy(
      fs['stack'])), ids, stack.stacked)
  got = np.concatenate([r['stack']['raw'] for r in world['ranks']])
  _same(got, want.numpy())
  for r in world['ranks']:
    assert r['stack']['gathers'] == 2
