"""The port's sparse step on a world of N ranks against JAX's on N devices.

3 tables of [1000, 8] stacked and row-sharded over the world, one table
of [50, 4] that stays replicated (``min_shard_rows=100``, the JAX option
``emb_min_shard_rows``), 2 dense features, a stacked DCNv2 tower with
MLP [64, 32, 1], a global batch of 64 with invalid ids, BCE loss, Adam
1e-3 on the tower and row-sparse Adagrad 0.05 on the tables: 3 steps,
for each lookup strategy (``allgather``, ``alltoall``, and ``alltoall``
named for the sharded stack alone) at N = 2 and 4.

The JAX step runs on a sub-mesh of N of the suite's 8 virtual CPU
devices under ``shard_map`` (the XLA update path on the CPU), on the
global batch. The port runs N gloo CPU ranks started by its launcher
(``run.py --simulate N --device cpu``), each a process of
``torch_sharded_worker.py`` that imports no JAX, from the JAX initial
state (``from_jax`` hands each rank its rows) and on its rows of each
global batch. All cases of one world go in one launch.

Each step's loss is held to ``rtol = 1e-5``; each rank's shard and
accumulator against its rows of the JAX global arrays, the replicated
table on every rank, the tables gathered back (``gather_tables``) and
the tower to ``STATE_TOL`` of ``test_torch_sparse_step.py``: the same
f32 math with the tower's gradients summed over the ranks, and duplicate
rows over the exchange, in other orders on the two sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import context_scope
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import (
    stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState,
    make_sparse_train_step as jax_make_sparse_train_step)

import hybridbackend_tpu_torch as hbt
from test_torch_distribute import LAUNCH_S, jctx, launch

TABLES = [('c0', 1000, 8), ('c1', 1000, 8), ('c2', 1000, 8),
          ('small', 50, 4)]
MIN_SHARD_ROWS = 100
DENSE = ['i0', 'i1']
WIDTHS = [8, 8, 8, 4, 1, 1]
MLP = [64, 32, 1]
BATCH, STEPS = 64, 3
# The port's strategies: one for every stack, or one per stack (the
# sharded stack's; the replicated one has none). JAX's for each.
STRATEGIES = {'allgather': 'allgather', 'alltoall': 'alltoall',
              'per_stack': {'stack/c0/c1/c2': 'alltoall'}}
JAX_STRATEGY = {'allgather': 'allgather', 'alltoall': 'alltoall',
                'per_stack': 'alltoall'}
STATE_TOL = dict(rtol=1e-5, atol=2e-6)


def _batches(seed=0):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(STEPS):
    b = {}
    for name, vocab, _ in TABLES:
      ids = rng.randint(0, vocab, BATCH).astype(np.int32)
      ids[rng.choice(BATCH, 4, replace=False)] = -1
      ids[rng.choice(BATCH, 3, replace=False)] = vocab + 7
      b[name] = ids
    for d in DENSE:
      b[d] = rng.rand(BATCH).astype(np.float32)
    b['label'] = rng.randint(0, 2, BATCH).astype(np.float32)
    out.append(b)
  return out


def _jax_model_loss(dense, emb_f, dense_f, batch):
  p = jnp.clip(stacked_dcn_v2_apply(dense, emb_f + dense_f), 1e-6, 1 - 1e-6)
  y = batch['label']
  return -jnp.mean(y * jnp.log(p) + (1 - y) * jnp.log(1 - p)), {}


def _jax_fx(jc):
  return JStackedFeatureExtractor(
      [JEmbeddingSpec(JTableConfig(*t)) for t in TABLES], dense_columns=DENSE,
      ctx=jc)


def _jax_init(world):
  jc = jctx(world)
  with context_scope(jc), OPTIONS.override(emb_min_shard_rows=MIN_SHARD_ROWS):
    fx = _jax_fx(jc)
    state = JSparseTrainState.create(
        stacked_dcn_v2_init(jax.random.PRNGKey(1), WIDTHS, MLP),
        fx.init(jax.random.PRNGKey(0)), optax.adam(1e-3), adagrad_init=0.1,
        ctx=jc)
  return state


def _numpy_init(state):
  """The JAX state as plain numpy containers, for a worker without JAX."""
  return {'tables': {k: np.asarray(v) for k, v in state.tables.items()},
          'acc': {k: np.asarray(v.acc[0]) for k, v in state.table_opt.items()},
          'dense': jax.tree.map(np.asarray, state.dense)}


def _jax_trace(world, state, strategy, batches):
  jc = jctx(world)
  trace = []
  with context_scope(jc), OPTIONS.override(emb_min_shard_rows=MIN_SHARD_ROWS,
                                           emb_lookup_strategy=strategy):
    step = jax_make_sparse_train_step(_jax_fx(jc), _jax_model_loss,
                                      optax.adam(1e-3), table_lr=0.05,
                                      ctx=jc, donate_state=False)
    for b in batches:
      state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(m['loss']), jax.tree.map(np.asarray, state)))
  return trace


@pytest.fixture(scope='module', params=[2, 4])
def world(request, tmp_path_factory):
  w = request.param
  state = _jax_init(w)
  batches = _batches()
  cases = [(name, 'steps', dict(
      tables=TABLES, dense=DENSE, widths=WIDTHS, mlp=MLP,
      min_shard_rows=MIN_SHARD_ROWS, init=_numpy_init(state),
      batches=batches, options=dict(lookup_strategy=strategy)))
           for name, strategy in STRATEGIES.items()]
  ranks = launch(w, cases, tmp_path_factory.mktemp(f'steps{w}'))
  return w, state, batches, ranks


def _tower_params(dense):
  tower = hbt.StackedDCNv2(WIDTHS, MLP)
  hbt.load_dcn_v2(tower, dense)
  return {n: p.detach().numpy() for n, p in tower.named_parameters()}


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('strategy', sorted(STRATEGIES))
def test_sharded_steps_match_jax(world, strategy):
  w, state, batches, ranks = world
  trace = _jax_trace(w, state, JAX_STRATEGY[strategy], batches)
  for i, (loss, want) in enumerate(trace):
    got = [r[strategy]['trace'][i] for r in ranks]
    for g in got:
      np.testing.assert_allclose(g['loss'], loss, rtol=1e-5,
                                 err_msg=f'step {i}')
    for name, table in want.tables.items():
      members = name.split('/')[1:]
      sharded = [r[strategy]['sharded'][name] for r in ranks]
      assert sharded == [members != ['small']] * w, (name, sharded)
      acc = want.table_opt[name].acc[0]
      for rank, g in enumerate(got):
        rows = (hbt.TableConfig(name, table.shape[0], table.shape[1])
                .shard_rows(hbt.Context('cpu', rank=rank, world_size=w))
                if sharded[rank] else slice(None))
        np.testing.assert_allclose(g['tables'][name], table[rows],
                                   err_msg=f'{name} rank {rank} step {i}',
                                   **STATE_TOL)
        np.testing.assert_allclose(g['acc'][name], acc[rows],
                                   err_msg=f'{name} acc rank {rank}',
                                   **STATE_TOL)
        np.testing.assert_allclose(g['gathered'][name], table, **STATE_TOL)
    want_tower = _tower_params(want.dense)
    for rank, g in enumerate(got):
      for n, p in want_tower.items():
        np.testing.assert_allclose(g['tower'][n], p, err_msg=f'{n} rank '
                                   f'{rank} step {i}', **STATE_TOL)
        # Every rank holds the same tower, bit for bit.
        np.testing.assert_array_equal(g['tower'][n], got[0]['tower'][n])
