"""The port's sharding planner against the JAX package's, on the CPU.

* Plans: on the cases of ``tests/test_planner.py`` (8 devices), with
  configs whose JAX row bytes are the logical ones (``lane_pack=True``,
  or a dim that fills whole 128-lane tiles) and JAX's latency floor
  passed explicitly (``hop_bytes=45 * 1024``), the port's plan of every
  table is JAX's: the same placement, partition and strategy, the same
  bytes held, and the bytes moved within one (the same float terms in
  another order). The one exception is a column candidate that wins:
  JAX's column term counts whole rows on the all-to-all, where it moves a
  ``D/W`` slice of each, so the port, counting the slice, takes the
  column partition for the wide table where JAX takes alltoall; with the
  column candidate left out the two plans agree there too.
* Calibration (the counterpart of ``tests/test_planner_calibration.py``):
  4 gloo ranks in 2 nodes (``tests/torch_planner_worker.py``) count the
  bytes that the port's collectives put on the wire in one lookup forward
  and backward and one routed Adagrad update, for a replicated table,
  the allgather, alltoall and hierarchical exchanges and a column table,
  at two shapes each; the planner's bytes are within JAX's factor of 1.25
  of them.
* ``plan_options`` gives the port's arguments, and the latency floor is 0
  unless passed.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from hybridbackend_tpu.embedding import TableConfig as JTableConfig
from hybridbackend_tpu.embedding.planner import plan_sharding as jax_plan
from hybridbackend_tpu.framework.context import Context as JContext

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.embedding import planner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_planner_worker.py')
HOP = 45 * 1024
W = 8
LAUNCH_S = 150

# The cases of tests/test_planner.py and test_planner_calibration.py:
# (tables (name, vocab, dim), ids a step, keywords).
CASES = {
    'small_hot_table_replicates_big_table_shards': (
        [('tiny', 1000, 16), ('huge', 10_000_000, 16)],
        {'tiny': 8192, 'huge': 8192}, {}),
    'hot_skewed_table': ([('hot', 10_000_000, 16)], {'hot': 8192},
                         {'unique_fraction': {'hot': 0.05}}),
    'unskewed_table': ([('hot', 10_000_000, 16)], {'hot': 8192},
                       {'unique_fraction': {'hot': 1.0}}),
    'budget_forces_sharding': (
        [('a', 100_000, 64), ('b', 100_000, 64)], {'a': 4096, 'b': 4096},
        {'hbm_budget_bytes': 30_000_000}),
    'multichip_plan_counts_row_bytes': ([('p16', 100_000, 16)],
                                        {'p16': 8192}, {}),
    'prefers_alltoall_at_scale': ([('big', 10_000_000, 64)], {'big': 8192},
                                  {'unique_fraction': {'big': 0.5}}),
    'replicates_tiny_hot_table': ([('tiny', 512, 8)], {'tiny': 65536}, {}),
}


def _jctx(n=W):
  return JContext(Mesh(np.array(jax.devices()[:n]).reshape(1, n),
                       ('dcn', 'ici')))


def _plans(tables, ids, kw, n=W):
  jcfgs = [JTableConfig(name, v, d, lane_pack=True) for name, v, d in tables]
  cfgs = [hbt.TableConfig(name, v, d) for name, v, d in tables]
  want = jax_plan(jcfgs, ids, ctx=_jctx(n), **kw)
  got = planner.plan_sharding(cfgs, ids, world_size=n, hop_bytes=HOP, **kw)
  return got, want


def _same(got, want):
  assert set(got) == set(want)
  for name, w in want.items():
    g = got[name]
    assert (g.sharded, g.partition, g.strategy, g.hbm_bytes_per_device) == (
        w.sharded, w.partition, w.strategy, w.hbm_bytes_per_device), name
    assert abs(g.comm_bytes_per_step - w.comm_bytes_per_step) <= 1, name


@pytest.mark.parametrize('case', sorted(CASES))
def test_plans_equal_jax(case):
  _same(*_plans(*CASES[case]))


def test_single_device_plans_equal_jax():
  got, want = _plans([('x', 10_000_000, 16)], {'x': 8192}, {}, n=1)
  _same(got, want)
  assert not got['x'].sharded and got['x'].comm_bytes_per_step == 0


def test_wide_table_takes_the_column_partition_jax_overcounts():
  """JAX's column term moves whole rows, the port's the ``D/W`` slices:
  the port shards the wide table by columns, where JAX picks alltoall;
  without the column candidate the plans are the same."""
  tables, ids = [('wide', 1_000_000, 512)], {'wide': 1024}
  got, want = _plans(tables, ids, {'column_min_dim': 256})
  g, w = got['wide'], want['wide']
  assert g.sharded and w.sharded
  assert (w.partition, w.strategy) == ('row', 'alltoall')
  assert g.partition == 'column'
  _, column = planner._cost_column(1_000_000, 2048, 1024, W)
  assert g.comm_bytes_per_step == column + 3 * HOP
  _same(*_plans(tables, ids, {'column_min_dim': 1024}))


def test_latency_floor_is_zero_unless_passed():
  """On bytes alone a [100000, 16] table shards over alltoall; JAX's v5e
  floor, passed, tips it to a replica (one collective against eight)."""
  cfg = hbt.TableConfig('t', 100_000, 16)
  plain = planner.plan_sharding([cfg], {'t': 8192}, world_size=W)['t']
  floor = planner.plan_sharding([cfg], {'t': 8192}, world_size=W,
                                hop_bytes=HOP)['t']
  _, comm = planner._cost_row_alltoall(100_000, 64, 8192, W, 2.0)
  assert (plain.sharded, plain.strategy, plain.comm_bytes_per_step) == (
      True, 'alltoall', comm)
  _, comm = planner._cost_replicated(100_000, 64, 8192, W)
  assert (floor.sharded, floor.comm_bytes_per_step) == (False, comm + HOP)


def test_row_bytes_follow_the_table_dtype():
  import torch
  cfg = hbt.TableConfig('t', 1000, 16, dtype=torch.bfloat16)
  assert planner.row_bytes(cfg) == 32
  plan = planner.plan_sharding([cfg], {'t': 64}, world_size=1)['t']
  assert plan.hbm_bytes_per_device == 1000 * 32


def test_plan_options_are_the_ports_arguments():
  cfgs = [hbt.TableConfig('tiny', 1000, 16),
          hbt.TableConfig('huge', 10_000_000, 16),
          hbt.TableConfig('wide', 1_000_000, 512)]
  plans = planner.plan_sharding(cfgs, {'tiny': 8192, 'huge': 8192,
                                       'wide': 1024}, world_size=W)
  opts = hbt.plan_options(plans)
  assert opts == {
      'sharded': {'tiny': False, 'huge': True, 'wide': True},
      'strategy': {'tiny': 'allgather', 'huge': 'alltoall',
                   'wide': 'allgather'},
      'partition': {'tiny': 'row', 'huge': 'row', 'wide': 'column'}}
  made = [dataclasses.replace(c, sharded=opts['sharded'][c.name],
                              partition=opts['partition'][c.name])
          for c in cfgs]
  assert [c.sharded for c in made] == [False, True, True]
  assert made[2].by_column


@pytest.fixture(scope='module')
def wire(tmp_path_factory):
  """Each rank's counted bytes of the worker's points, 4 ranks in 2
  nodes."""
  tmp = tmp_path_factory.mktemp('planner')
  out = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
       '4', '--nodes', '2', '--device', 'cpu', '--timeout',
       str(LAUNCH_S - 10), '--collective-timeout', '60', WORKER, str(tmp)],
      cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS='1'),
      capture_output=True, text=True, timeout=LAUNCH_S)
  assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
  ranks = []
  for r in range(4):
    with open(tmp / f'{r}.json') as f:
      ranks.append(json.load(f))
  return ranks


def _predicted(placement, n, d):
  v, r, w = 8192, 4 * d, 4
  if placement == 'replicated':
    return planner._cost_replicated(v, r, n, w, backward='sparse')[1]
  if placement == 'column':
    return planner._cost_column(v, r, n, w)[1]
  if placement == 'hierarchical':
    return planner._cost_row_hierarchical(v, r, n, w, 2.0, nodes=2)[1]
  fn = {'allgather': planner._cost_row_allgather,
        'alltoall': planner._cost_row_alltoall}[placement]
  return fn(v, r, n, w, 2.0)[1]


def test_planner_bytes_match_the_wire(wire):
  """Every placement at every point, on every rank: the counted bytes
  within 1.25x of the planner's (they agree to under 0.1%: the
  remainder is the bucket sizes' all-to-alls)."""
  assert len({json.dumps(r, sort_keys=True) for r in wire}) == 1
  for key, measured in wire[0].items():
    placement, n, d = key.split('/')
    predicted = _predicted(placement, int(n), int(d))
    assert 1 / 1.25 < measured / predicted < 1.25, (key, measured,
                                                   predicted)
  assert {k.split('/')[0] for k in wire[0]} == {
      'replicated', 'allgather', 'alltoall', 'hierarchical', 'column'}
