"""The interleaved step at a world of N against the JAX package, on the CPU.

Three tables of about 300 rows and dim 8, stacked and row-sharded, 1
dense feature, a stacked DCNv2 tower (MLP 16-8-1) under Adam 1e-3, BCE a
mean over the rows, table lr 0.05, a global batch of 64 with invalid and
out-of-vocab ids, 3 steps. The port runs N gloo CPU ranks
(``run.py --simulate N --nodes M --device cpu``; N = 2 in one node, N = 4
in two nodes of two), each a process of ``torch_sharded_worker.py``, one
launch a world; each rank steps on its rows of the global batch, cut
into ``k`` micro-batches. JAX's ``make_interleaved_train_step`` with the
context runs sharded on ``Mesh(devices[:N].reshape(M, N/M), ('dcn',
'ici'))`` from the same initial state, its lookups by
``emb_lookup_strategy``.

The cases cover each strategy (``allgather``, ``alltoall``,
``hierarchical``: one node of 2, and 2×2 at N = 4), each table optimizer
(Adagrad; LazyAdam, its JAX tables under ``emb_lane_pack='off'``), each
``k`` (2, 4) and each N, in seven of the combinations rather than all 24:
each JAX oracle costs a compile.

Tolerances. Against JAX: the loss to ``rtol = 1e-5``; the gathered
tables and slots, the tower and the concatenated per-example predictions
to ``STATE_TOL`` of ``test_torch_sharded_step.py`` (``rtol = 1e-5, atol
= 2e-6``), LazyAdam tables to ``atol = 2e-5`` as
``test_torch_sharded_optimizers.py`` holds them (an update near a zero
gradient moves by up to 5e6 times the gradient's rounding difference).
JAX slices the global batch into micro-batches and shards each; the port
slices each rank's rows, so the two sum in other orders (not bitwise).
Against the port's own plain step at world N, JAX's interleave
tolerances (``tests/test_trainer.py:213-255``): the loss to ``rtol =
1e-5``, state ``rtol = 1e-4, atol = 1e-6`` (LazyAdam tables the 2e-5
above). The update kernel's plain version is called once a step on each
rank whatever ``k`` is; a rank's rows that do not divide by ``k`` raise,
naming them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import (
    Context as JContext, context_scope)
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import (
    stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.pipeline.interleave import (
    make_interleaved_train_step as jax_make_interleaved_train_step)
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState)

import hybridbackend_tpu_torch as hbt
from test_torch_distribute import LAUNCH_S, launched, start_launch

WORLDS = {2: 1, 4: 2}          # ranks -> nodes
TABLES = [('c0', 300, 8), ('c1', 301, 8), ('c2', 302, 8)]
DENSE = ['i0']
WIDTHS = [8, 8, 8, 1]
MLP = [16, 8, 1]
BATCH, STEPS = 64, 3
# case -> (world, lookup strategy, table optimizer, k)
CASES = {
    'n2_allgather_adagrad_k2': (2, 'allgather', 'adagrad', 2),
    'n2_alltoall_adam_k4': (2, 'alltoall', 'adam', 4),
    'n2_hierarchical_adagrad_k4': (2, 'hierarchical', 'adagrad', 4),
    'n4_allgather_adam_k2': (4, 'allgather', 'adam', 2),
    'n4_alltoall_adagrad_k4': (4, 'alltoall', 'adagrad', 4),
    'n4_hierarchical_adagrad_k2': (4, 'hierarchical', 'adagrad', 2),
    'n4_hierarchical_adam_k4': (4, 'hierarchical', 'adam', 4),
}
REFUSE_K = {2: 3, 4: 3}        # a k that a rank's rows do not divide
STATE_TOL = dict(rtol=1e-5, atol=2e-6)
ADAM_TABLE_TOL = dict(rtol=1e-5, atol=2e-5)
PLAIN_TOL = dict(rtol=1e-4, atol=1e-6)
ADAM_PLAIN_TABLE_TOL = dict(rtol=1e-4, atol=2e-5)
KERNEL = {'adagrad': 'adagrad_update_sorted', 'adam': 'adam_update_sorted'}


def _batches(seed=18):
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


def _jmesh(world):
  devices = np.array(jax.devices()[:world]).reshape(WORLDS[world], -1)
  return JContext(Mesh(devices, ('dcn', 'ici')))


def _jax_loss(dense, emb_f, dense_f, batch):
  p = jnp.clip(stacked_dcn_v2_apply(dense, emb_f + dense_f), 1e-6, 1 - 1e-6)
  y = batch['label']
  return -jnp.mean(y * jnp.log(p) + (1 - y) * jnp.log(1 - p)), {'preds': p}


def _options(strategy, optimizer):
  return dict(emb_lookup_strategy=strategy,
              **({'emb_lane_pack': 'off'} if optimizer == 'adam' else {}))


def _jax_fx(jc):
  return JStackedFeatureExtractor(
      [JEmbeddingSpec(JTableConfig(*t)) for t in TABLES], dense_columns=DENSE,
      ctx=jc)


def _jax_init(case):
  world, strategy, optimizer, _ = CASES[case]
  jc = _jmesh(world)
  with context_scope(jc), OPTIONS.override(**_options(strategy, optimizer)):
    return JSparseTrainState.create(
        stacked_dcn_v2_init(jax.random.PRNGKey(1), WIDTHS, MLP),
        _jax_fx(jc).init(jax.random.PRNGKey(0)), optax.adam(1e-3),
        adagrad_init=0.1, ctx=jc, adam=optimizer == 'adam')


def _jax_trace(case, state, batches):
  world, strategy, optimizer, k = CASES[case]
  jc = _jmesh(world)
  trace = []
  with context_scope(jc), OPTIONS.override(**_options(strategy, optimizer)):
    step = jax_make_interleaved_train_step(
        _jax_fx(jc), _jax_loss, optax.adam(1e-3), k, table_lr=0.05, ctx=jc,
        table_optimizer=optimizer, donate_state=False)
    for b in batches:
      state, m = step(state, {key: jnp.asarray(v) for key, v in b.items()})
      trace.append((float(m['loss']), np.asarray(m['preds']),
                    jax.tree.map(np.asarray, state)))
  return trace


def _cases(w):
  return sorted(c for c, spec in CASES.items() if spec[0] == w)


def _spec(case, state, batches):
  world, strategy, optimizer, k = CASES[case]
  return dict(
      tables=TABLES, dense=DENSE, widths=WIDTHS, mlp=MLP, preds=True,
      optimizer=optimizer, k=k, batches=batches,
      init={'tables': {n: np.asarray(v) for n, v in state.tables.items()},
            'acc': {n: tuple(np.asarray(a) for a in v.acc)
                    for n, v in state.table_opt.items()},
            'dense': jax.tree.map(np.asarray, state.dense)},
      options=dict(lookup_strategy=strategy, update_exchange='alltoall'),
      refuse_k=REFUSE_K[world])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """Both worlds' launches, started together, every case of a world in
  its launch; JAX's traces made while the ranks run."""
  batches = _batches()
  inits = {c: _jax_init(c) for c in CASES}
  procs = {}
  for w, nodes in WORLDS.items():
    tmp = tmp_path_factory.mktemp(f'interleave{w}')
    procs[w] = (start_launch(w, [(c, 'interleave', _spec(c, inits[c], batches))
                                 for c in _cases(w)], tmp, nodes=nodes), tmp)
  traces = {c: _jax_trace(c, inits[c], batches) for c in CASES}
  ranks = {w: launched(proc, w, tmp) for w, (proc, tmp) in procs.items()}
  return dict(traces=traces, ranks=ranks)


def _tower(dense):
  tower = hbt.StackedDCNv2(WIDTHS, MLP)
  hbt.load_dcn_v2(tower, dense)
  return {n: p.detach().numpy() for n, p in tower.named_parameters()}


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('case', sorted(CASES))
def test_interleaved_step_matches_jax(runs, case):
  """3 steps: each rank's loss, the gathered tables and slots, the tower
  and the ranks' predictions joined, against JAX's sharded interleaved
  step; the update kernel once a step on each rank; no fallback."""
  w, _, optimizer, _ = CASES[case]
  ranks = [r[case]['interleaved'] for r in runs['ranks'][w]]
  table_tol = ADAM_TABLE_TOL if optimizer == 'adam' else STATE_TOL
  for i, (loss, preds, want) in enumerate(runs['traces'][case]):
    label = f'{case} step {i}'
    got = [r['trace'][i] for r in ranks]
    for g in got:
      np.testing.assert_allclose(g['loss'], loss, rtol=1e-5, err_msg=label)
    np.testing.assert_allclose(
        np.concatenate([g['aux']['preds'] for g in got]), preds,
        err_msg=label, **STATE_TOL)
    for name, table in want.tables.items():
      np.testing.assert_allclose(got[0]['gathered'][name], table,
                                 err_msg=f'{label} {name}', **table_tol)
      for a, b in zip(got[0]['gathered_slots'][name],
                      want.table_opt[name].acc):
        np.testing.assert_allclose(a, b, err_msg=f'{label} {name} slot',
                                   **STATE_TOL)
    for n, p in _tower(want.dense).items():
      for r, g in enumerate(got):
        np.testing.assert_allclose(g['tower'][n], p,
                                   err_msg=f'{label} {n} rank {r}',
                                   **STATE_TOL)
        np.testing.assert_array_equal(g['tower'][n], got[0]['tower'][n])
  for r in ranks:
    assert all(r['sharded'].values()), r['sharded']
    assert r['calls'][KERNEL[optimizer]] == STEPS, r['calls']
    assert sum(r['calls'].values()) == STEPS, r['calls']
    assert r['fallbacks'] == dict(lookup=0, adagrad=0, sgd=0, adam=0)


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('case', sorted(CASES))
def test_interleaved_step_matches_the_plain_step(runs, case):
  """3 steps of the interleaved step against the port's plain step at the
  same world, from one state, at JAX's interleave tolerances."""
  w, _, optimizer, _ = CASES[case]
  table_tol = ADAM_PLAIN_TABLE_TOL if optimizer == 'adam' else PLAIN_TOL
  for r, res in enumerate(runs['ranks'][w]):
    inter, plain = res[case]['interleaved'], res[case]['plain']
    assert plain['calls'][KERNEL[optimizer]] == STEPS
    for i, (a, b) in enumerate(zip(inter['trace'], plain['trace'])):
      label = f'{case} rank {r} step {i}'
      np.testing.assert_allclose(a['loss'], b['loss'], rtol=1e-5,
                                 err_msg=label)
      for name, t in b['tables'].items():
        np.testing.assert_allclose(a['tables'][name], t, err_msg=label,
                                   **table_tol)
        for x, y in zip(a['slots'][name], b['slots'][name]):
          np.testing.assert_allclose(x, y, err_msg=label, **PLAIN_TOL)
      for n, p in b['tower'].items():
        np.testing.assert_allclose(a['tower'][n], p, err_msg=f'{label} {n}',
                                   **PLAIN_TOL)


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('w', sorted(WORLDS))
def test_rows_that_do_not_divide_by_k_raise(runs, w):
  """Each rank's rows (64 / N) cut by a ``k`` that does not divide them:
  the error names the rank, its rows and ``k``."""
  k = REFUSE_K[w]
  for r, res in enumerate(runs['ranks'][w]):
    got = res[_cases(w)[0]]['refused']
    assert got is not None
    assert f"rank {r}'s {BATCH // w} rows" in got, got
    assert f'num_microbatches={k}' in got, got
