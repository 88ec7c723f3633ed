"""Every table optimizer of the port's sparse step on a world of N ranks,
against the JAX package's on N devices.

The shapes of ``test_torch_sharded_step.py``: 3 tables of [1024, 8]
stacked and row-sharded over the world, one table of [50, 8] that stays
replicated (``min_shard_rows=100``), 2 dense features, a global batch of
64 with invalid ids, BCE loss (a mean over the batch), Adam 1e-3 on the
tower, table lr 0.05; 3 steps, at N = 2 and 4, under ``allgather`` (the
lookup and the update exchange both) and ``alltoall`` (both), of:

* DLRM (bottom 32-8, top 64-32-1) with LazyAdam tables, against the XLA
  path (JAX tables made under ``emb_lane_pack='off'``: JAX refuses
  LazyAdam on packed tables);
* DCNv2 with ``table_dedup=False`` Adagrad, against the XLA path (the
  stream kernel ignores ``dedup=False``);
* DCNv2 with the dense-split Adagrad update, against the stream path
  under ``emb_update_split_dense='on'`` and ``emb_update_touched_blocks=
  -1`` on lane-packed tables (``emb_lane_pack='on'``: JAX splits only
  128-lane physical rows and otherwise takes the fused kernel without a
  word), with a spy on ``gsum_dense_sorted`` to show that JAX split;
* bf16 tables with DCNv2 + Adagrad and with DLRM + LazyAdam, against the
  stream path (the XLA path adds in bf16 per occurrence, which is not the
  kernels' contract); their loss is the mean times the global batch, so
  that the gradients move most touched bf16 elements.

And 3 rounds of the updates alone on a sharded [1024, 8] table and a
replicated [50, 8] one, each rank's half or quarter of a list of 192
ids: LazyAdam against the XLA path, SGD through ``sparse_sgd_apply``, and
per-occurrence Adagrad with a bucket ratio of 0.05, so that the
occurrence buckets overflow on every rank and every rank falls back to
the allgather route. Plus ``gather_slots`` of a LazyAdam and a bf16
LazyAdam state from ``from_jax(ctx=)``: JAX's global ``(m, v)``.

Tolerances, those of the world-of-one tests for the same update: the
loss to ``rtol = 1e-5``; f32 tables, slots and towers to ``STATE_TOL``
(``rtol = 1e-5, atol = 2e-6``: duplicate rows and the tower's gradients
are summed over the ranks in other orders), LazyAdam tables to ``atol =
2e-5`` in the steps (``test_torch_sparse_step_optimizers.py``: a
gradient near zero moves an update by up to ``lr·Δs/eps``). The LazyAdam
update alone is held to ``test_torch_sparse_optimizers.py``'s
``ADAM_TOL`` (``rtol = 1e-5, atol = 1e-6``) against the XLA path: the
row totals are the same sums in the same rank order, but XLA's CPU
fusion of the moment and table updates rounds some elements one f32 ulp
away (5 of 4096 table elements in the first round at N = 2), so it is
not bitwise. bf16 tables and slots at most 1
bf16 ulp apart (1e-6 where a value cancels; a LazyAdam table 4e-4, as
``test_torch_bf16_tables.py``), in at most 0.5% of the elements of a
step's tables and slots (the small replicated table, touched almost
whole, has more of them: DLRM's embedding gradients may differ by a bf16
ulp before they are summed). From the second step on a bf16 LazyAdam
slot may sit 2 ulps off: ``m = b1·m + (1-b1)·s`` adds this step's ulp of
``s`` to the last step's ulp of ``m`` (1 of the replicated table's 400
``m`` elements at N = 2). SGD moves a row by ``-lr`` times each
gradient on JAX's side and by ``-lr`` times their total here:
``STATE_TOL``. The gathered slots: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hybridbackend_tpu.ops.pallas.scatter as jscatter
from hybridbackend_tpu.embedding import sparse_update as jsparse
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import context_scope
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import (
    dlrm_apply, dlrm_init, stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState,
    make_sparse_train_step as jax_make_sparse_train_step)

import hybridbackend_tpu_torch as hbt
from test_torch_cuda import ulps_apart
from test_torch_distribute import LAUNCH_S, jctx, launch

TABLES = [('c0', 1024, 8), ('c1', 1024, 8), ('c2', 1024, 8),
          ('small', 50, 8)]
MIN_SHARD_ROWS = 100
DENSE = ['i0', 'i1']
WIDTHS = [8, 8, 8, 8, 1, 1]
MLP, BOTTOM = [64, 32, 1], [32, 8]
BATCH, STEPS, LR = 64, 3, 0.05
STATE_TOL = dict(rtol=1e-5, atol=2e-6)
ADAM_TABLE_TOL = dict(rtol=1e-5, atol=2e-5)
ADAM_TOL = dict(rtol=1e-5, atol=1e-6)

# case -> (model, table optimizer, dedup, split, dtype, JAX options). The
# XLA cases take the CPU's 'auto'.
STEP_CASES = {
    'adam': ('dlrm', 'adam', True, False, 'float32',
             dict(emb_lane_pack='off')),
    'nodedup': ('dcnv2', 'adagrad', False, False, 'float32', {}),
    'split': ('dcnv2', 'adagrad', True, True, 'float32', dict(
        emb_update_impl='stream', emb_update_split_dense='on',
        emb_update_touched_blocks=-1, emb_lane_pack='on')),
    'bf16_adagrad': ('dcnv2', 'adagrad', True, False, 'bfloat16',
                     dict(emb_update_impl='stream')),
    'bf16_adam': ('dlrm', 'adam', True, False, 'bfloat16',
                  dict(emb_update_impl='stream', emb_lane_pack='off')),
}
STRATEGIES = ('allgather', 'alltoall')
# The kernel each case's update reaches on every rank, once a step per
# stack (the sharded stack and the replicated one).
KERNEL = {'adam': 'adam_update_sorted', 'nodedup': 'adagrad_update_sorted',
          'split': 'gsum_dense_sorted',
          'bf16_adagrad': 'adagrad_update_sorted',
          'bf16_adam': 'adam_update_sorted'}


def _jdtype(name):
  return jnp.bfloat16 if name == 'bfloat16' else jnp.float32


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


def _scale(case):
  return float(BATCH) if STEP_CASES[case][4] == 'bfloat16' else 1.0


def _jax_fx(jc, dtype):
  return JStackedFeatureExtractor(
      [JEmbeddingSpec(JTableConfig(*t, dtype=_jdtype(dtype))) for t in TABLES],
      dense_columns=DENSE, ctx=jc)


def _jax_loss(model, scale):
  if model == 'dlrm':
    preds = lambda p, e, d: dlrm_apply(p, d, e)
  else:
    preds = lambda p, e, d: stacked_dcn_v2_apply(p, e + d)

  def loss(dense, emb_f, dense_f, batch):
    p = jnp.clip(preds(dense, emb_f, dense_f), 1e-6, 1 - 1e-6)
    y = batch['label']
    return -jnp.mean(y * jnp.log(p) + (1 - y) * jnp.log(1 - p)) * scale, {}
  return loss


def _options(case, strategy, world_options=()):
  return dict(STEP_CASES[case][5], emb_min_shard_rows=MIN_SHARD_ROWS,
              emb_lookup_strategy=strategy, emb_update_exchange=strategy,
              **dict(world_options))


def _jax_init(world, case):
  model, optimizer, _, _, dtype, _ = STEP_CASES[case]
  jc = jctx(world)
  with context_scope(jc), OPTIONS.override(**_options(case, 'allgather')):
    fx = _jax_fx(jc, dtype)
    net = (dlrm_init(jax.random.PRNGKey(1), len(DENSE), len(TABLES), BOTTOM,
                     TABLES[0][2], MLP) if model == 'dlrm' else
           stacked_dcn_v2_init(jax.random.PRNGKey(1), WIDTHS, MLP))
    return JSparseTrainState.create(
        net, fx.init(jax.random.PRNGKey(0)), optax.adam(1e-3),
        adagrad_init=0.1, ctx=jc, adam=optimizer == 'adam')


def _numpy_init(state):
  """The JAX state as plain numpy containers, for a worker without JAX."""
  return {'tables': {k: np.asarray(v) for k, v in state.tables.items()},
          'acc': {k: tuple(np.asarray(a) for a in v.acc)
                  for k, v in state.table_opt.items()},
          'dense': jax.tree.map(np.asarray, state.dense)}


def _jax_trace(world, case, strategy, state, batches):
  model, optimizer, dedup, _, dtype, _ = STEP_CASES[case]
  jc = jctx(world)
  trace = []
  with context_scope(jc), OPTIONS.override(**_options(case, strategy)):
    step = jax_make_sparse_train_step(
        _jax_fx(jc, dtype), _jax_loss(model, _scale(case)), optax.adam(1e-3),
        table_lr=LR, ctx=jc, table_dedup=dedup, table_optimizer=optimizer,
        donate_state=False)
    for b in batches:
      state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(m['loss']), jax.tree.map(np.asarray, state)))
  return trace


def _step_case(world, case, strategy, state, batches):
  model, optimizer, dedup, split, dtype, _ = STEP_CASES[case]
  return (f'{case}/{strategy}', 'steps', dict(
      tables=TABLES, dense=DENSE, widths=WIDTHS, mlp=MLP, bottom=BOTTOM,
      model=model, dtype=dtype, scale=_scale(case),
      min_shard_rows=MIN_SHARD_ROWS, init=_numpy_init(state),
      batches=batches, options=dict(
          table_optimizer=optimizer, table_dedup=dedup,
          table_split_dense=split, lookup_strategy=strategy,
          update_exchange=strategy)))


# ---------------------------------------------------------------------------
# The updates alone: LazyAdam, SGD and per-occurrence Adagrad with a forced
# overflow, on a sharded and a replicated table.
# ---------------------------------------------------------------------------

UPDATE_TABLES = {'big': (1024, True), 'small': (50, False)}
UPDATE_EXCHANGES = {
    'alltoall': (dict(exchange='alltoall'),
                 dict(emb_update_exchange='alltoall')),
    'allgather': (dict(exchange='allgather'),
                  dict(emb_update_exchange='allgather')),
    # ceil(0.05·ceil(n/W)) lanes a bucket: every rank overflows.
    'alltoall_overflow': (
        dict(exchange='alltoall', bucket_ratio=0.05),
        dict(emb_update_exchange='alltoall', emb_update_bucket_ratio=0.05)),
}
# optimizer -> (port options, JAX function's options)
UPDATE_OPTIMIZERS = {'adam': ({}, {}), 'sgd': ({}, {}),
                     'nodedup': (dict(dedup=False), dict(dedup=False))}
ROUND_IDS = 192


def _update_inputs(world):
  rng = np.random.RandomState(100 + world)
  tables = {}
  for name, (vocab, sharded) in UPDATE_TABLES.items():
    table = rng.randn(vocab, 8).astype(np.float32)
    tables[name] = dict(vocab=vocab, dim=8, sharded=sharded, table=table,
                        m=rng.randn(vocab, 8).astype(np.float32) * 0.01,
                        v=rng.rand(vocab, 8).astype(np.float32) * 1e-3,
                        acc=np.full_like(table, 0.1) + rng.rand(
                            vocab, 8).astype(np.float32))
  rounds = []
  for _ in range(STEPS):
    hot = rng.choice(1024, 40, replace=False)
    ids = hot[rng.randint(0, 40, ROUND_IDS)].astype(np.int32)
    ids[rng.choice(ROUND_IDS, 8, replace=False)] = -1
    ids[rng.choice(ROUND_IDS, 6, replace=False)] = 1024 + 7
    rounds.append((ids, rng.randn(ROUND_IDS, 8).astype(np.float32) * 0.1))
  return tables, rounds


def _update_cases(world):
  tables, rounds = _update_inputs(world)
  cases = []
  for opt, (port_opts, _) in UPDATE_OPTIMIZERS.items():
    slot_keys = {'adam': ('m', 'v'), 'sgd': (), 'nodedup': ('acc',)}[opt]
    spec_tables = {name: dict(vocab=t['vocab'], dim=t['dim'],
                              sharded=t['sharded'], table=t['table'],
                              slots=[t[k] for k in slot_keys])
                   for name, t in tables.items()}
    runs = {f'{name}/{ex}': (name, dict(opts, **port_opts))
            for name in UPDATE_TABLES
            for ex, (opts, _) in UPDATE_EXCHANGES.items()
            if UPDATE_TABLES[name][1] or ex == 'alltoall'}
    cases.append((f'update/{opt}', 'applies', dict(
        optimizer='adagrad' if opt == 'nodedup' else opt, lr=LR,
        rounds=rounds, tables=spec_tables, cases=runs)))
  return tables, rounds, cases


def _gather_case(world):
  """A LazyAdam state, f32 and bf16, with random ``(m, v)`` in JAX's
  global layout, for ``from_jax(ctx=)`` and ``gather_slots``."""
  rng = np.random.RandomState(200 + world)
  out = {}
  for dtype in ('float32', 'bfloat16'):
    state = _jax_init(world, 'adam' if dtype == 'float32' else 'bf16_adam')
    init = _numpy_init(state)
    init['acc'] = {k: tuple(
        (rng.randn(*a.shape) * 0.01).astype(np.float32).astype(a.dtype)
        for a in slots) for k, slots in init['acc'].items()}
    out[dtype] = init
  return out


@pytest.fixture(scope='module', params=[2, 4])
def world(request, tmp_path_factory):
  w = request.param
  batches = _batches()
  inits = {case: _jax_init(w, case) for case in STEP_CASES}
  cases = [_step_case(w, case, strategy, inits[case], batches)
           for case in STEP_CASES for strategy in STRATEGIES]
  tables, rounds, update_cases = _update_cases(w)
  gathers = _gather_case(w)
  cases += update_cases
  cases.append(('gathers', 'gathers', dict(
      tables=TABLES, dense=DENSE, widths=WIDTHS, mlp=MLP, bottom=BOTTOM,
      min_shard_rows=MIN_SHARD_ROWS, inits=gathers)))
  ranks = launch(w, cases, tmp_path_factory.mktemp(f'optimizers{w}'))
  return dict(w=w, batches=batches, inits=inits, ranks=ranks,
              tables=tables, rounds=rounds, gathers=gathers)


def _rows(name, table, rank, w, sharded):
  if not sharded:
    return slice(None)
  return hbt.TableConfig(name, table.shape[0], table.shape[1]).shard_rows(
      hbt.Context('cpu', rank=rank, world_size=w))


def _close(got, want, tol, bf16, atol_bf16=1e-6, ulps=1):
  """``got`` (float32 values) against ``want`` by the case's rule;
  returns ``(elements apart, elements)``, which a bf16 case bounds over
  every table and slot of a step. bf16: at most ``ulps`` bf16 ulps apart
  or within ``atol_bf16``."""
  if bf16:
    g = torch.from_numpy(got).to(torch.bfloat16)
    w = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    apart = ulps_apart(g, w)
    far = (apart > ulps) & ((g.float() - w.float()).abs() > atol_bf16)
    assert not bool(far.any()), (
        f'{int(far.sum())} elements more than {ulps} ulp and {atol_bf16} '
        f'apart: {g[far][:4].tolist()} against {w[far][:4].tolist()}')
    return int((apart > 0).sum()), got.size
  np.testing.assert_allclose(got, want, **tol)
  return 0, got.size


def _tower_params(model, dense):
  if model == 'dlrm':
    tower = hbt.DLRM(len(DENSE), len(TABLES), BOTTOM, TABLES[0][2], MLP)
    hbt.load_dlrm(tower, dense)
  else:
    tower = hbt.StackedDCNv2(WIDTHS, MLP)
    hbt.load_dcn_v2(tower, dense)
  return {n: p.detach().numpy() for n, p in tower.named_parameters()}


@pytest.mark.timeout(LAUNCH_S + 240)
@pytest.mark.parametrize('case', list(STEP_CASES))
def test_sharded_optimizer_steps_match_jax(world, case, monkeypatch):
  """3 steps of each case under each strategy: the loss, every rank's
  shards and slots, the gathered tables and slots, and the tower; the
  case's kernel reached on every rank once a step per stack."""
  w = world['w']
  model, optimizer, _, split, dtype, _ = STEP_CASES[case]
  bf16 = dtype == 'bfloat16'
  table_tol = ADAM_TABLE_TOL if optimizer == 'adam' else STATE_TOL
  table_atol = 4e-4 if (bf16 and optimizer == 'adam') else 1e-6
  gsum_calls = []
  if split:
    real = jscatter.gsum_dense_sorted

    def spy(*a, **k):
      gsum_calls.append(1)
      return real(*a, **k)
    monkeypatch.setattr(jscatter, 'gsum_dense_sorted', spy)
  for strategy in STRATEGIES:
    label = f'{case}/{strategy}'
    trace = _jax_trace(w, case, strategy, world['inits'][case],
                       world['batches'])
    ranks = [r[label] for r in world['ranks']]
    for r in ranks:
      assert r['calls'][KERNEL[case]] == 2 * STEPS, (label, r['calls'])
      assert r['fallbacks'] == dict(lookup=0, adagrad=0, sgd=0, adam=0)
    for i, (loss, want) in enumerate(trace):
      got = [r['trace'][i] for r in ranks]
      apart = []
      # LazyAdam's m carries a step's rounding into the next.
      slot_ulps = 2 if (bf16 and optimizer == 'adam' and i > 0) else 1
      for g in got:
        np.testing.assert_allclose(g['loss'], loss, rtol=1e-5,
                                   err_msg=f'{label} step {i}')
      for name, table in want.tables.items():
        sharded = ranks[0]['sharded'][name]
        assert sharded == (name != 'stack/small'), (name, sharded)
        dim = TABLES[0][2]
        table = np.asarray(table, np.float32).reshape(-1, dim)
        slots = [np.asarray(a, np.float32).reshape(-1, dim)
                 for a in want.table_opt[name].acc]
        vocab = got[0]['gathered'][name].shape[0]
        for rank, g in enumerate(got):
          rows = _rows(name, table[:vocab], rank, w, sharded)
          _close(g['tables'][name], table[:vocab][rows], table_tol, bf16,
                 table_atol)
          for s, ws in zip(g['slots'][name], slots):
            _close(s, ws[:vocab][rows], STATE_TOL, bf16, ulps=slot_ulps)
        apart.append(_close(got[0]['gathered'][name], table[:vocab],
                            table_tol, bf16, table_atol))
        for s, ws in zip(got[0]['gathered_slots'][name], slots):
          apart.append(_close(s, ws[:vocab], STATE_TOL, bf16,
                              ulps=slot_ulps))
        for g in got[1:]:
          np.testing.assert_array_equal(g['gathered'][name],
                                        got[0]['gathered'][name])
      differ, total = np.sum(apart, axis=0)
      assert differ <= 0.005 * total, (label, i, apart)
      want_tower = _tower_params(model, want.dense)
      for rank, g in enumerate(got):
        for n, p in want_tower.items():
          np.testing.assert_allclose(g['tower'][n], p, err_msg=f'{n} rank '
                                     f'{rank} step {i}', **STATE_TOL)
          np.testing.assert_array_equal(g['tower'][n], got[0]['tower'][n])
  if split:
    assert gsum_calls, 'the JAX step did not take the dense split'


def _jax_update(w, opt, name, exchange, table, slots, ids, demb, k):
  _, jopts = UPDATE_OPTIMIZERS[opt]
  vocab, sharded = UPDATE_TABLES[name]
  cfg = JTableConfig(name, vocab, 8, sharded=sharded)
  jc = jctx(w)
  with context_scope(jc), OPTIONS.override(
      emb_lane_pack='off', **UPDATE_EXCHANGES[exchange][1]):
    if opt == 'sgd':
      fn = lambda t, i, g: (jsparse.sparse_sgd_apply(t, i, g, cfg, LR,
                                                     ctx=jc),)
      return jax.jit(fn)(table, ids, demb)
    if opt == 'adam':
      fn = lambda t, m, v, i, g: (lambda r: (r[0], *r[1].acc))(
          jsparse.sparse_adam_apply(t, jsparse.SparseOptState(acc=(m, v)),
                                    i, g, cfg, LR, k + 1, ctx=jc))
    else:
      fn = lambda t, a, i, g: (lambda r: (r[0], *r[1].acc))(
          jsparse.sparse_adagrad_apply(t, jsparse.SparseOptState(acc=(a,)),
                                       i, g, cfg, LR, ctx=jc, **jopts))
    return jax.jit(fn)(table, *slots, ids, demb)


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('opt', list(UPDATE_OPTIMIZERS))
def test_sharded_updates_match_jax(world, opt):
  """3 rounds of LazyAdam, SGD and per-occurrence Adagrad on a sharded and a replicated table under each
  exchange; the forced overflow falls back on every rank, every round,
  to the allgather route's bits."""
  w = world['w']
  slot_keys = {'adam': ('m', 'v'), 'sgd': (), 'nodedup': ('acc',)}[opt]
  kernel = {'adam': 'adam_update_sorted', 'sgd': 'scatter_add_sorted',
            'nodedup': 'adagrad_update_sorted'}[opt]
  results = [r[f'update/{opt}'] for r in world['ranks']]
  for run in results[0]:
    name, exchange = run.split('/')
    t = world['tables'][name]
    state = (jnp.asarray(t['table']),
             *(jnp.asarray(t[k]) for k in slot_keys))
    for k, (ids, demb) in enumerate(world['rounds']):
      state = _jax_update(w, opt, name, exchange, state[0], state[1:],
                          jnp.asarray(ids), jnp.asarray(demb), k)
      for rank, res in enumerate(results):
        rows = _rows(name, t['table'], rank, w, t['sharded'])
        for got, want in zip(res[run]['trace'][k], state):
          np.testing.assert_allclose(
              got, np.asarray(want)[rows], err_msg=f'{run} {k}',
              **(ADAM_TOL if opt == 'adam' else STATE_TOL))
    for res in results:
      assert res[run]['calls'][kernel] == STEPS, (run, res[run]['calls'])
      assert res[run]['fallbacks'] == (
          STEPS if exchange == 'alltoall_overflow' else 0), run
      assert res[run]['sharded'] == t['sharded']
  for res in results:
    for a, b in zip(res['big/alltoall_overflow']['trace'][-1],
                    res['big/allgather']['trace'][-1]):
      np.testing.assert_array_equal(a, b)


@pytest.mark.timeout(LAUNCH_S + 60)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gathered_adam_slots_equal_jax_global_arrays(world, dtype):
  """``from_jax(ctx=)`` hands each rank its rows of JAX's global ``(m,
  v)``, f32 or bf16, and ``gather_slots`` puts them back whole on every
  rank, bit for bit."""
  init = world['gathers'][dtype]
  for res in world['ranks']:
    got = res['gathers'][dtype]
    for name, slots in init['acc'].items():
      assert len(got[name]) == 2
      for g, want in zip(got[name], slots):
        want = np.asarray(want, np.float32).reshape(-1, TABLES[0][2])
        np.testing.assert_array_equal(g, want[:g.shape[0]])
