"""bfloat16 embedding tables of the PyTorch port against the JAX package.

A bf16 table keeps bf16 slots (Adagrad's accumulator, LazyAdam's ``m``
and ``v``) and a bf16 gradient list; every update reads its state as f32,
does f32 math with per-row totals summed in list order, and stores each
result rounded to nearest once, as the JAX Pallas kernels do with bf16
operands (``ops/pallas/scatter.py``, ``_scatter_kernel``).

  * The bf16 plain versions of the add, Adagrad and LazyAdam kernels
    against the Pallas kernels in interpret mode, on some of the hard
    update lists of ``test_torch_cuda.py`` (the lists the card's kernels
    are held to these plain versions on), with gradients and ``lr``
    large enough that most touched elements move; and the per-occurrence
    Adagrad mode (the port's own, no Pallas counterpart) on every hard
    list against numpy: f32 totals and f32 squares added in list order,
    f32 math, one rounding.
  * Three steps of DCNv2 + Adagrad, DLRM + LazyAdam and DCNv2 with the
    split-dense Adagrad update, with bf16 tables, against the JAX step
    under ``emb_update_impl='stream'`` (the Pallas kernels; the XLA path
    that ``'auto'`` takes on the CPU adds in bf16 per occurrence, which
    is not the kernels' contract), starting from the JAX state carried
    across by ``from_jax``; and the split-dense step bitwise against the
    fused one.

Tolerances. The two sides sum a row's gradients in different f32 orders
(list order here, a one-hot matmul in Pallas), so a stored value may sit
on the other side of a bf16 rounding boundary: tables and slots are held
to at most 1 bf16 ulp per element (``ulps_apart``) or, where a result cancels
to near zero, 1e-6 absolute (the f32 order error of its terms), and the
share of elements that differ at all is bounded in each test (1% for
the kernels, 0.5% in the steps). In the steps the tower's f32 matmuls
run in another order too, so an embedding gradient may differ by a bf16
ulp before it is summed (DLRM's; the DCNv2 steps come out bitwise equal
to JAX's), and a LazyAdam table takes a looser floor (``STEP_CASES``).
The numpy oracle of the per-occurrence mode performs the same
f32 operations in the same order: bitwise. The loss to ``rtol = 1e-5``
and the tower params to ``rtol = 1e-5, atol = 2e-6`` as in
``test_torch_sparse_step.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hybridbackend_tpu.embedding import sparse_update as jsu
from hybridbackend_tpu.embedding import table as jtable
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import (
    dlrm_apply, dlrm_init, stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.ops.pallas.scatter import (
    adagrad_update_sorted as jax_adagrad_update_sorted,
    adam_update_sorted as jax_adam_update_sorted,
    scatter_add_sorted as jax_scatter_add_sorted)
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState,
    make_sparse_train_step as jax_make_sparse_train_step)

import hybridbackend_tpu_torch as hbt
from test_torch_cuda import (HARD_LISTS, HARD_LIST_IDS, assert_within_an_ulp,
                             hard_list, hard_slots, ulps_apart)

LR, EPS, STEP = 0.05, 1e-7, 3
PALLAS = dict(block_rows=2048, chunk=256, interpret=True)
PALLAS_LISTS = ('random-d16', 'boundary-d16', 'long-d16', 'cancel')
BF16 = torch.bfloat16


def _bf16_state(spec, slots):
  """A hard list with its table (and ``'adagrad'`` or ``'adam'`` slots)
  rounded to bf16; gradients stay f32 (the wrappers round them)."""
  v, d, n, rows, g, table = hard_list(spec)
  state = [table]
  if slots == 'adagrad':
    state.append(torch.full_like(table, 0.1))
  elif slots == 'adam':
    state += list(hard_slots(spec, table))
  return v, d, rows, g, [t.to(BF16) for t in state]


def _jnp(t):
  return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _torch(a):
  return torch.from_numpy(np.asarray(a).astype(np.float32)).to(BF16)


def _moved(before, after, rows, v):
  """The share of the touched rows' elements that the update changed."""
  touched = np.unique(rows[(rows >= 0) & (rows < v)].numpy())
  return float((after[touched] != before[touched]).float().mean())


@pytest.mark.parametrize('kernel', ['add', 'adagrad', 'adam'])
@pytest.mark.parametrize('name', PALLAS_LISTS)
def test_bf16_plain_versions_match_pallas(name, kernel):
  spec = HARD_LISTS[HARD_LIST_IDS.index(name)]
  v, d, rows, g, state = _bf16_state(spec, {'add': None}.get(kernel, kernel))
  got = [t.clone() for t in state]
  jrows, jg = jnp.asarray(rows.numpy()), jnp.asarray(g.numpy())
  if kernel == 'add':
    hbt.scatter_add_sorted(*got, rows, g)
    want = [jax_scatter_add_sorted(_jnp(state[0]), jrows, jg, **PALLAS)]
  elif kernel == 'adagrad':
    hbt.adagrad_update_sorted(*got, rows, g, LR, EPS)
    want = jax_adagrad_update_sorted(*map(_jnp, state), jrows, jg, lr=LR,
                                     eps=EPS, **PALLAS)
  else:
    hbt.adam_update_sorted(*got, rows, g, LR, STEP)
    want = jax_adam_update_sorted(*map(_jnp, state), jrows, jg, LR, STEP,
                                  **PALLAS)
  for x, w, before in zip(got, want, state):
    assert x.dtype == BF16 and np.asarray(w).dtype.name == 'bfloat16'
    assert_within_an_ulp(x, _torch(w), share=0.01)
    assert _moved(before, x, rows, v) >= 0.5
    untouched = np.setdiff1d(np.arange(v), rows.numpy())
    assert torch.equal(x[untouched], before[untouched])


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_bf16_nodedup_matches_numpy(spec):
  """Per occurrence: ``a = f32(acc) + Σ f32(g·g)`` in list order, stored
  once as bf16; the table's step from the unrounded ``a``."""
  v, d, rows, g, (table, acc) = _bf16_state(spec, 'adagrad')
  t, a = hbt.adagrad_update_sorted(table.clone(), acc.clone(), rows, g, LR,
                                   EPS, dedup=False)
  r = rows.numpy()
  ok = (r >= 0) & (r < v)
  g32 = g.to(BF16).float().numpy()[ok]
  s, q = np.zeros((v, d), np.float32), np.zeros((v, d), np.float32)
  np.add.at(s, r[ok], g32)                       # in list order
  np.add.at(q, r[ok], g32 * g32)
  u = np.unique(r[ok])
  want_a, want_t = acc.float().numpy(), table.float().numpy()
  want_a[u] += q[u]
  want_t[u] -= np.float32(LR) * s[u] / (np.sqrt(want_a[u]) + np.float32(EPS))
  assert torch.equal(a, torch.from_numpy(want_a).to(BF16))
  assert torch.equal(t, torch.from_numpy(want_t).to(BF16))
  if u.size:
    assert _moved(table, t, rows, v) >= 0.5 and _moved(acc, a, rows, v) >= 0.5


def test_bf16_nodedup_diverges_from_the_xla_path():
  """The JAX XLA path's per-occurrence mode (``_adagrad_rows``, what
  ``impl='xla'`` and ``'auto'`` on the CPU run) adds each occurrence to
  the bf16 accumulator and table in bf16, rounding every add; the port
  adds in f32 and rounds each store once (the kernels' contract). On 256
  x 8 ids over 300 hot rows (about 7 occurrences a row) with N(0, 0.5)
  gradients the two differ in 2748 of 4800 touched table elements and
  1842 of 4800 accumulator elements, the accumulator by at most 3 bf16
  ulps; pinned here to at least a quarter and at most 4 ulps."""
  d, vocab = 16, 3000
  rng = np.random.RandomState(9)
  ids = rng.randint(0, 300, (256, 8)).astype(np.int32)
  demb = (rng.randn(256, 8, d) * 0.5).astype(np.float32)
  jcfg = JTableConfig('t', vocab, d, dtype=jnp.bfloat16)
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  with context_scope(ctx):
    jt = jtable.create_table(jcfg, jax.random.PRNGKey(0), ctx)
    want_t, want_s = jsu.sparse_adagrad_apply(
        jt, jsu.init_adagrad_state(jt), jnp.asarray(ids), jnp.asarray(demb),
        jcfg, LR, dedup=False, impl='xla', ctx=ctx)
  t = _torch(jt).reshape(-1, d).clone()
  st = hbt.init_adagrad_state(t)
  hbt.sparse_adagrad_apply(t, st, torch.from_numpy(ids),
                           torch.from_numpy(demb),
                           hbt.TableConfig('t', vocab, d, dtype=BF16), LR,
                           dedup=False)
  touched = np.unique(ids)
  for got, want in ((t, want_t), (st.acc[0], want_s.acc[0])):
    ulps = ulps_apart(got, _torch(want).reshape(-1, d))[touched]
    assert float((ulps > 0).float().mean()) >= 0.25
  assert int(ulps.max()) <= 4


@pytest.mark.parametrize('kernel', ['add', 'adam'])
def test_bf16_wrappers_reject_mixed_dtypes(kernel):
  t = torch.zeros((8, 4), dtype=BF16)
  rows, g = torch.zeros(3, dtype=torch.int32), torch.zeros((3, 4))
  with pytest.raises(TypeError):
    if kernel == 'add':
      hbt.scatter_add_sorted(t.half(), rows, g)
    else:
      hbt.adam_update_sorted(t, t.clone(), t.float(), rows, g, LR, 1)


# --------------------------------------------------------------------------
# Three steps against the JAX stream path
# --------------------------------------------------------------------------

TABLES, VOCAB, DIM, DENSE, BATCH, STEPS = 3, 1000, 16, 2, 64, 3
MLP, BOTTOM = [64, 32, 1], [32, 16]
TOWER_TOL = dict(rtol=1e-5, atol=2e-6)


def _batches(seed=0):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(STEPS):
    b = {}
    for t in range(TABLES):
      ids = rng.randint(0, VOCAB, BATCH).astype(np.int32)
      ids[rng.choice(BATCH, 4, replace=False)] = -1
      ids[rng.choice(BATCH, 3, replace=False)] = VOCAB + 7
      b[f'c{t}'] = ids
    for d in range(DENSE):
      b[f'i{d}'] = rng.rand(BATCH).astype(np.float32)
    b['label'] = rng.randint(0, 2, BATCH).astype(np.float32)
    out.append(b)
  return out


def _bce(p, y, clip, log, optimizer):
  """Summed for Adagrad, so that the embedding gradients move most of the
  touched bf16 table and accumulator elements at lr 0.05; averaged for
  LazyAdam, whose step moves every touched element by about lr whatever
  the gradient's scale (and whose tower then stays within
  ``TOWER_TOL``)."""
  p = clip(p, 1e-6, 1 - 1e-6)
  bce = -(y * log(p) + (1 - y) * log(1 - p))
  return bce.sum() if optimizer == 'adagrad' else bce.mean()


def _jax_run(model, optimizer, split, batches):
  """Initial state and per-step (loss, state) of the JAX stream step."""
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  overrides = dict(emb_update_impl='stream')
  if optimizer == 'adam':
    overrides['emb_lane_pack'] = 'off'
  if split:
    overrides.update(emb_update_split_dense='on',
                     emb_update_touched_blocks=-1)
  with context_scope(ctx), OPTIONS.override(**overrides):
    specs = [JEmbeddingSpec(JTableConfig(f'c{t}', VOCAB, DIM,
                                         dtype=jnp.bfloat16))
             for t in range(TABLES)]
    fx = JStackedFeatureExtractor(
        specs, dense_columns=[f'i{d}' for d in range(DENSE)], ctx=ctx)
    if model == 'dcnv2':
      net = stacked_dcn_v2_init(jax.random.PRNGKey(1),
                                [DIM] * TABLES + [1] * DENSE, MLP)
      preds = lambda p, e, d: stacked_dcn_v2_apply(p, e + d)
    else:
      net = dlrm_init(jax.random.PRNGKey(1), DENSE, TABLES, BOTTOM, DIM, MLP)
      preds = lambda p, e, d: dlrm_apply(p, d, e)

    def model_loss(dense, emb_f, dense_f, batch):
      return _bce(preds(dense, emb_f, dense_f), batch['label'], jnp.clip,
                  jnp.log, optimizer), {}

    state = JSparseTrainState.create(net, fx.init(jax.random.PRNGKey(0)),
                                     optax.adam(1e-3), adagrad_init=0.1,
                                     ctx=ctx, adam=optimizer == 'adam')
    init = jax.tree.map(np.asarray, state)
    step = jax_make_sparse_train_step(
        fx, model_loss, optax.adam(1e-3), table_lr=0.05, ctx=ctx,
        table_optimizer=optimizer, donate_state=False)
    trace = []
    for b in batches:
      state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(m['loss']), jax.tree.map(np.asarray, state)))
  return init, trace


def _port(model, optimizer, split, init):
  ctx = hbt.Context(torch.device('cpu'))
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{t}', VOCAB, DIM, dtype=BF16))
           for t in range(TABLES)]
  fx = hbt.StackedFeatureExtractor(
      specs, dense_columns=[f'i{d}' for d in range(DENSE)], ctx=ctx)
  if model == 'dcnv2':
    tower = hbt.StackedDCNv2([DIM] * TABLES + [1] * DENSE, MLP)
    preds = lambda t, e, d: t(e + d)
  else:
    tower = hbt.DLRM(DENSE, TABLES, BOTTOM, DIM, MLP)
    preds = lambda t, e, d: t(d, e)

  def model_loss(t, emb_f, dense_f, batch):
    return _bce(preds(t, emb_f, dense_f), batch['label'], torch.clamp,
                torch.log, optimizer), {}

  state = hbt.from_jax(
      fx, init.tables, {k: v.acc for k, v in init.table_opt.items()},
      tower, init.dense, functools.partial(torch.optim.Adam, lr=1e-3))
  step = hbt.make_sparse_train_step(fx, model_loss, table_lr=0.05,
                                    table_optimizer=optimizer,
                                    table_split_dense=split)
  return state, step


def _tower_layers(tower):
  if isinstance(tower, hbt.StackedDCNv2):
    return [tower.cross, *tower.mlp.layers]
  return [*tower.bottom_mlp.layers, tower.bottom_out, *tower.top_mlp.layers]


def _jax_layers(params):
  if 'cross' in params:
    return [params['cross'], *params['mlp']]
  return [*params['bottom_mlp'], params['bottom_out'], *params['top_mlp']]


@pytest.fixture(autouse=True)
def one_thread():
  """One CPU thread, as in ``test_torch_sparse_step.py`` (the split-dense
  update's whole-table square root)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


# (model, table optimizer, split-dense, the table's absolute floor). A
# LazyAdam table's floor: after the first step its bf16 m and v may each
# sit one ulp from JAX's (2**-8 relative), which moves the next step's
# lr·m̂/(sqrt(v̂)+eps) by up to lr·(2**-8 + 2**-9), about 3e-4.
STEP_CASES = {
    'dcnv2-adagrad': ('dcnv2', 'adagrad', False, 1e-6),
    'dlrm-adam': ('dlrm', 'adam', False, 4e-4),
    'dcnv2-split': ('dcnv2', 'adagrad', True, 1e-6),
}


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_bf16_sparse_step_matches_jax_stream(case):
  model, optimizer, split, table_atol = STEP_CASES[case]
  batches = _batches()
  init, trace = _jax_run(model, optimizer, split, batches)
  state, step = _port(model, optimizer, split, init)
  (name,) = state.tables
  before = state.tables[name].clone()
  assert before.dtype == BF16
  assert all(s.dtype == BF16 for s in state.table_opt[name].acc)
  for i, b in enumerate(batches):
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    want_loss, want = trace[i]
    np.testing.assert_allclose(float(metrics['loss']), want_loss, rtol=1e-5)
    pairs = [(state.tables[name], want.tables[name])] + list(zip(
        state.table_opt[name].acc, want.table_opt[name].acc))
    for k, (got, w) in enumerate(pairs):
      assert got.dtype == BF16
      assert_within_an_ulp(got, _torch(w).reshape(-1, DIM), share=0.005,
                            atol=table_atol if k == 0 else 1e-6)
    for layer, p in zip(_tower_layers(state.dense), _jax_layers(want.dense)):
      np.testing.assert_allclose(layer.w.detach().numpy(), p['w'],
                                 **TOWER_TOL)
      np.testing.assert_allclose(layer.b.detach().numpy(), p['b'],
                                 **TOWER_TOL)
  touched = np.concatenate([
      b[f'c{t}'][(b[f'c{t}'] >= 0) & (b[f'c{t}'] < VOCAB)] + t * VOCAB
      for b in batches for t in range(TABLES)])
  assert _moved(before, state.tables[name], torch.from_numpy(touched),
                before.shape[0]) >= 0.5


def test_bf16_split_dense_step_equals_fused():
  """The split-dense bf16 step and the fused one, from one state, bit for
  bit: the same f32 totals and the same f32 apply, rounded once."""
  init, _ = _jax_run('dcnv2', 'adagrad', False, [])
  out = []
  for split in (False, True):
    state, step = _port('dcnv2', 'adagrad', split, init)
    for b in _batches(1):
      state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    out.append(state)
  (name,) = out[0].tables
  assert torch.equal(out[0].tables[name], out[1].tables[name])
  assert torch.equal(out[0].table_opt[name].acc[0],
                     out[1].table_opt[name].acc[0])
