"""Sparse SGD, LazyAdam and no-dedup Adagrad of the port against JAX.

The plain PyTorch versions of the add kernel (``scatter_add_sorted``),
the LazyAdam kernel (``adam_update_sorted``) and the per-occurrence mode
of the Adagrad kernel are held against the JAX Pallas kernels in
interpret mode and against the JAX XLA paths, on one update list with
duplicates, ``-1`` rows and rows ``>= V``. The entries
``sparse_sgd_apply``, ``sparse_adam_apply`` and
``sparse_adagrad_apply(dedup=False)`` are held against their JAX
functions in a one-device context. On the hard update lists of
``test_torch_cuda.py`` (the lists the card's kernels are checked on) the
plain versions of the per-occurrence Adagrad and LazyAdam updates are
held against numpy (float32 totals added in list order, the apply in
float32, per-occurrence squares in float32 in list order), and on some
of them against ``_adagrad_rows_nodedup`` and the LazyAdam Pallas kernel.

Tolerances, all from f32 rounding:
  * add and Adagrad: ``rtol = atol = 1e-5``; the paths sum a row's
    duplicates in different orders (the XLA no-dedup path also divides
    each occurrence before summing, the port sums and then divides);
  * LazyAdam: ``rtol = 1e-5, atol = 1e-6``, from the summation order and
    from ``b ** step``, which comes from three different ``pow`` routines.
    Against the Pallas kernel ``v`` gets ``rtol = 3e-5``: that kernel
    rounds ``1 - b2`` in f32 (1 - f32(0.999) = 0.00099998713) where the
    port and the XLA path round the double (f32(0.001) = 0.0010000000),
    1.3e-5 apart relative; for ``1 - b1`` the gap is 2.4e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.embedding import sparse_update as jsu
from hybridbackend_tpu.embedding import table as jtable
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.ops.pallas.scatter import (
    adagrad_update_sorted as jax_adagrad_update_sorted,
    adam_update_sorted as jax_adam_update_sorted,
    scatter_add_sorted as jax_scatter_add_sorted)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.ops import scatter
from test_torch_cuda import (HARD_LISTS, HARD_LIST_IDS, cancel_row,
                             hard_list, hard_slots)
from test_torch_scatter import PALLAS_ORACLE, list_totals

V, D, N = 4096, 16, 3000
LR, STEP = 0.05, 3
TOL = dict(rtol=1e-5, atol=1e-5)
ADAM_TOL = dict(rtol=1e-5, atol=1e-6)
ZERO_ROW = 7        # present twice, with gradients that cancel exactly


def _list(seed, unique=False):
  """A sorted update list: hot rows with duplicates (or unique rows),
  60 ``-1`` and 60 ``>= V`` entries, and row ``ZERO_ROW`` twice with a
  zero total."""
  rng = np.random.RandomState(seed)
  if unique:
    rows = rng.choice(np.arange(8, V), N, replace=False).astype(np.int32)
  else:
    hot = rng.choice(np.arange(8, V), 400, replace=False)
    rows = hot[rng.randint(0, 400, N)].astype(np.int32)
    rows[rng.choice(N, 60, replace=False)] = V + rng.randint(0, 100, 60)
  rows[rng.choice(N, 60, replace=False)] = -1
  grads = (rng.randn(N, D) * 3).astype(np.float32)
  if not unique:
    g = (rng.randn(D) * 3).astype(np.float32)
    rows = np.concatenate([rows, [ZERO_ROW, ZERO_ROW]]).astype(np.int32)
    grads = np.concatenate([grads, [g, -g]])
  order = np.argsort(rows, kind='stable')
  return rows[order], grads[order]


def _state(seed, slots):
  rng = np.random.RandomState(seed + 100)
  table = rng.uniform(-0.25, 0.25, (V, D)).astype(np.float32)
  if slots == 'adagrad':
    return table, (np.full((V, D), 0.1, np.float32),)
  m = (rng.randn(V, D) * 0.1).astype(np.float32)
  v = (rng.rand(V, D) * 0.5).astype(np.float32)
  return table, (m, v)


def _t(*arrays):
  return [torch.from_numpy(np.array(a)) for a in arrays]


def _untouched(rows):
  return np.setdiff1d(np.arange(V), rows[(rows >= 0) & (rows < V)])


@pytest.mark.parametrize('oracle', ['pallas', 'xla'])
def test_scatter_add_reference_matches_jax(oracle):
  rows, grads = _list(0)
  table, _ = _state(0, 'adagrad')
  if oracle == 'pallas':
    want = jax_scatter_add_sorted(jnp.asarray(table), jnp.asarray(rows),
                                  jnp.asarray(grads), interpret=True)
  else:
    safe = jnp.where((rows >= 0) & (rows < V), rows, V)
    want = jnp.asarray(table).at[safe].add(jnp.asarray(grads), mode='drop')
  (t,) = _t(table)
  got = hbt.scatter_add_sorted(t, *_t(rows, grads))
  assert got is t
  np.testing.assert_allclose(t.numpy(), np.asarray(want), **TOL)
  untouched = _untouched(rows)
  np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])


@pytest.mark.parametrize('oracle', ['pallas', 'xla'])
def test_adam_reference_matches_jax(oracle):
  rows, grads = _list(1)
  table, (m, v) = _state(1, 'adam')
  if oracle == 'pallas':
    want = jax_adam_update_sorted(
        jnp.asarray(table), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(rows), jnp.asarray(grads), lr=LR, step=STEP,
        interpret=True)
  else:
    urows, gsum = jsu._dedup_grads(jnp.asarray(rows), jnp.asarray(grads),
                                   oob_row=V)
    want = jsu._adam_rows(jnp.asarray(table), jnp.asarray(m),
                          jnp.asarray(v), urows, gsum, LR, STEP, 0.9, 0.999,
                          1e-8)
  t, tm, tv = _t(table, m, v)
  hbt.adam_update_sorted(t, tm, tv, *_t(rows, grads), LR, STEP)
  v_tol = dict(ADAM_TOL, rtol=3e-5) if oracle == 'pallas' else ADAM_TOL
  for got, w, tol in zip((t, tm, tv), want, (ADAM_TOL, ADAM_TOL, v_tol)):
    np.testing.assert_allclose(got.numpy(), np.asarray(w), **tol)
  # The zero-total row is present, so its moments decay and it moves.
  np.testing.assert_allclose(tm.numpy()[ZERO_ROW], 0.9 * m[ZERO_ROW],
                             rtol=1e-6)
  np.testing.assert_allclose(tv.numpy()[ZERO_ROW], 0.999 * v[ZERO_ROW],
                             rtol=1e-6)
  assert (t.numpy()[ZERO_ROW] != table[ZERO_ROW]).all()
  untouched = _untouched(rows)
  for got, before in zip((t, tm, tv), (table, m, v)):
    np.testing.assert_array_equal(got.numpy()[untouched], before[untouched])


def test_adam_reference_takes_unsorted_rows_and_device_scalars():
  rows, grads = _list(2)
  table, (m, v) = _state(2, 'adam')
  want = _t(table, m, v)
  hbt.adam_update_sorted_reference(*want, *_t(rows, grads), LR, STEP)
  perm = np.random.RandomState(3).permutation(len(rows))
  got = _t(table, m, v)
  hbt.adam_update_sorted(*got, *_t(rows[perm], grads[perm]),
                         torch.tensor(LR), torch.tensor(STEP))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), w.numpy(), **ADAM_TOL)


def test_nodedup_reference_matches_xla_path():
  rows, grads = _list(4)
  table, (acc,) = _state(4, 'adagrad')
  want_t, want_a = jsu._adagrad_rows_nodedup(
      jnp.asarray(table), jnp.asarray(acc), jnp.asarray(rows),
      jnp.asarray(grads), LR, 1e-7, oob_row=V)
  t, a = _t(table, acc)
  hbt.adagrad_update_sorted(t, a, *_t(rows, grads), LR, dedup=False)
  np.testing.assert_allclose(a.numpy(), np.asarray(want_a), **TOL)
  np.testing.assert_allclose(t.numpy(), np.asarray(want_t), **TOL)
  # Per-occurrence squares, in float64: acc + sum of g², not (sum g)².
  valid = (rows >= 0) & (rows < V)
  q = np.zeros((V, D))
  np.add.at(q, rows[valid], grads[valid].astype(np.float64) ** 2)
  np.testing.assert_allclose(a.numpy(), acc + q, rtol=1e-6)
  untouched = _untouched(rows)
  np.testing.assert_array_equal(a.numpy()[untouched], acc[untouched])


def test_nodedup_reference_matches_pallas_kernel_on_unique_rows():
  """Without duplicates both semantics agree, so the Pallas kernel (which
  always combines duplicates) is an oracle for the per-occurrence mode."""
  rows, grads = _list(5, unique=True)
  table, (acc,) = _state(5, 'adagrad')
  want_t, want_a = jax_adagrad_update_sorted(
      jnp.asarray(table), jnp.asarray(acc), jnp.asarray(rows),
      jnp.asarray(grads), lr=LR, eps=1e-7, interpret=True)
  t, a = _t(table, acc)
  hbt.adagrad_update_sorted(t, a, *_t(rows, grads), LR, dedup=False)
  np.testing.assert_allclose(a.numpy(), np.asarray(want_a), **TOL)
  np.testing.assert_allclose(t.numpy(), np.asarray(want_t), **TOL)


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_nodedup_reference_on_the_hard_lists(spec):
  v, d, n, rows, g, table = hard_list(spec)
  acc = torch.full_like(table, 0.1)
  t, a = hbt.adagrad_update_sorted(table.clone(), acc.clone(), rows, g, LR,
                                   dedup=False)
  r, gg = rows.numpy(), g.numpy()
  ok, u, s = list_totals(v, d, r, gg)
  # Each square rounded and added in f32 in list order, the contract's
  # sum (a float64 sum drifts past rtol 1e-6 over runs of thousands).
  q = np.zeros((v, d), np.float32)
  np.add.at(q, r[ok], gg[ok] * gg[ok])
  want_a = acc.numpy() + q
  np.testing.assert_allclose(a.numpy(), want_a, rtol=1e-6)
  want_t = table.numpy().copy()
  want_t[u] -= np.float32(LR) * s[u] / (
      np.sqrt(want_a[u].astype(np.float32)) + np.float32(1e-7))
  np.testing.assert_allclose(t.numpy(), want_t, **TOL)
  untouched = np.setdiff1d(np.arange(v), u)
  np.testing.assert_array_equal(t.numpy()[untouched], table.numpy()[untouched])
  np.testing.assert_array_equal(a.numpy()[untouched], acc.numpy()[untouched])
  if spec[0] in PALLAS_ORACLE:
    xt, xa = jsu._adagrad_rows_nodedup(
        jnp.asarray(table.numpy()), jnp.asarray(acc.numpy()), jnp.asarray(r),
        jnp.asarray(gg), LR, 1e-7, oob_row=v)
    np.testing.assert_allclose(a.numpy(), np.asarray(xa), **TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(xt), **TOL)


@pytest.mark.parametrize('dedup', [True, False])
@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_exact_adagrad_rounds_each_operation_once(spec, dedup):
  """``scatter.adagrad_update_sorted_exact`` (what the card's kernel 1 is
  held to bit for bit) on f32 and bf16 tables: bit for bit an apply
  worked in float64 and rounded to f32 after every operation (exact for
  +, -, *, / and sqrt, whose float64 result rounds to the correctly
  rounded f32), then once to the storage dtype."""
  def f32(x):
    return x.astype(np.float32).astype(np.float64)

  for dtype in (torch.float32, torch.bfloat16):
    v, d, n, rows, g, table = hard_list(spec, dtype=dtype)
    acc = torch.full_like(table, 0.1)
    t, a = scatter.adagrad_update_sorted_exact(
        table.clone(), acc.clone(), rows, g, LR, dedup=dedup)
    urows, s, q = scatter._run_totals(table, rows, g, square=not dedup)
    s = s.numpy().astype(np.float64)
    want_a = f32(acc[urows].float().numpy().astype(np.float64)
                 + (f32(s * s) if dedup else q.numpy()))
    den = f32(f32(np.sqrt(want_a)) + f32(np.float64(1e-7)))
    want_t = f32(table[urows].float().numpy().astype(np.float64)
                 - f32(f32(f32(np.float64(LR)) * s) / den))
    for got, want, before in ((a, want_a, acc), (t, want_t, table)):
      expect = before.clone()
      expect[urows] = torch.from_numpy(want.astype(np.float32)).to(dtype)
      assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                         expect.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32)), (spec[0], dtype)


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_adam_reference_on_the_hard_lists(spec):
  v, d, n, rows, g, table = hard_list(spec)
  m, vv = hard_slots(spec, table)
  got = [table.clone(), m.clone(), vv.clone()]
  hbt.adam_update_sorted(*got, rows, g, LR, STEP)
  r, gg = rows.numpy(), g.numpy()
  ok, u, s = list_totals(v, d, r, gg)
  f32 = np.float32
  bc1 = f32(1) - f32(0.9) ** f32(STEP)
  bc2 = f32(1) - f32(0.999) ** f32(STEP)
  want = [x.numpy().copy() for x in (table, m, vv)]
  mn = f32(0.9) * want[1][u] + f32(1 - 0.9) * s[u]
  vn = f32(0.999) * want[2][u] + f32(1 - 0.999) * s[u] * s[u]
  want[1][u], want[2][u] = mn, vn
  want[0][u] -= f32(LR) * (mn / bc1) / (np.sqrt(vn / bc2) + f32(1e-8))
  for x, w in zip(got, want):
    np.testing.assert_allclose(x.numpy(), w, **ADAM_TOL)
  untouched = np.setdiff1d(np.arange(v), u)
  for x, before in zip(got, (table, m, vv)):
    np.testing.assert_array_equal(x.numpy()[untouched],
                                  before.numpy()[untouched])
  if spec[0] == 'cancel':                     # a zero total, still present
    c = cancel_row(spec)
    assert s[c].tolist() == [0.0] * d
    np.testing.assert_allclose(got[1].numpy()[c], 0.9 * m.numpy()[c],
                               rtol=1e-6)
    assert (got[0].numpy()[c] != table.numpy()[c]).all()
  if spec[0] in PALLAS_ORACLE:
    want = jax_adam_update_sorted(
        *(jnp.asarray(x.numpy()) for x in (table, m, vv)), jnp.asarray(r),
        jnp.asarray(gg), lr=LR, step=STEP, interpret=True)
    v_tol = dict(ADAM_TOL, rtol=3e-5)
    for x, w, tol in zip(got, want, (ADAM_TOL, ADAM_TOL, v_tol)):
      np.testing.assert_allclose(x.numpy(), np.asarray(w), **tol)


def _ids_and_grads(seed, vocab):
  rng = np.random.RandomState(seed)
  ids = rng.randint(0, 300, (64, 5)).astype(np.int32)
  ids[::9, 0] = -1
  ids[1::7, 2] = vocab + 3
  return ids, rng.randn(64, 5, D).astype(np.float32)


def _one_device():
  return JContext(build_mesh(devices=jax.devices()[:1]))


@pytest.mark.parametrize('impl', ['xla', 'stream'])
def test_sparse_sgd_apply_matches_jax(impl):
  vocab = 3000
  ids, demb = _ids_and_grads(6, vocab)
  jcfg = jtable.TableConfig('t', vocab, D)
  ctx = _one_device()
  with context_scope(ctx):
    jt = jtable.create_table(jcfg, jax.random.PRNGKey(0), ctx)
    want = jsu.sparse_sgd_apply(jt, jnp.asarray(ids), jnp.asarray(demb),
                                jcfg, LR, impl=impl, ctx=ctx)
  t = torch.from_numpy(np.asarray(jt).reshape(-1, D).copy())
  before = t.clone()
  got = hbt.sparse_sgd_apply(t, *_t(ids, demb), hbt.TableConfig('t', vocab, D),
                             LR)
  assert got is t
  np.testing.assert_allclose(t.numpy(), np.asarray(want).reshape(-1, D),
                             **TOL)
  valid = ids[(ids >= 0) & (ids < vocab)]
  untouched = np.setdiff1d(np.arange(vocab), valid)
  assert torch.equal(t[untouched], before[untouched])


@pytest.mark.parametrize('impl', ['xla', 'stream'])
def test_sparse_adam_apply_matches_jax(impl):
  """Two LazyAdam steps on different ids: rows touched only by the first
  keep their moments through the second."""
  vocab = 3000
  jcfg = jtable.TableConfig('t', vocab, D)
  tcfg = hbt.TableConfig('t', vocab, D)
  ctx = _one_device()
  with context_scope(ctx), OPTIONS.override(emb_lane_pack='off'):
    jt = jtable.create_table(jcfg, jax.random.PRNGKey(0), ctx)
  assert jt.shape == (vocab, D)                 # LazyAdam never packs
  t = torch.from_numpy(np.asarray(jt).copy())
  st = hbt.init_adam_state(t)
  jst = jsu.init_adam_state(jt)
  for step, seed in ((1, 7), (2, 8)):
    ids, demb = _ids_and_grads(seed, vocab)
    with context_scope(ctx):
      jt, jst = jsu.sparse_adam_apply(jt, jst, jnp.asarray(ids),
                                      jnp.asarray(demb), jcfg, LR, step=step,
                                      impl=impl, ctx=ctx)
    got_t, got_s = hbt.sparse_adam_apply(t, st, *_t(ids, demb), tcfg, LR,
                                         step=step)
    assert got_t is t and got_s is st
  np.testing.assert_allclose(t.numpy(), np.asarray(jt), **ADAM_TOL)
  for got, want in zip(st.acc, jst.acc):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ADAM_TOL)


@pytest.mark.parametrize('shuffle', [False, True])
def test_sparse_adagrad_apply_nodedup_matches_jax(shuffle):
  vocab = 3000
  ids, demb = _ids_and_grads(9, vocab)
  jcfg = jtable.TableConfig('t', vocab, D, shuffle_ids=shuffle)
  tcfg = hbt.TableConfig('t', vocab, D, shuffle_ids=shuffle)
  ctx = _one_device()
  with context_scope(ctx):
    jt = jtable.create_table(jcfg, jax.random.PRNGKey(0), ctx)
    want_t, want_s = jsu.sparse_adagrad_apply(
        jt, jsu.init_adagrad_state(jt), jnp.asarray(ids), jnp.asarray(demb),
        jcfg, LR, dedup=False, impl='xla', ctx=ctx)
  t = torch.from_numpy(np.asarray(jt).reshape(-1, D).copy())
  st = hbt.init_adagrad_state(t)
  hbt.sparse_adagrad_apply(t, st, *_t(ids, demb), tcfg, LR, dedup=False)
  np.testing.assert_allclose(st.acc[0].numpy(),
                             np.asarray(want_s.acc[0]).reshape(-1, D), **TOL)
  np.testing.assert_allclose(t.numpy(), np.asarray(want_t).reshape(-1, D),
                             **TOL)


@pytest.mark.parametrize('kernel,bad', [
    ('add', 'float16'), ('add', 'shape'), ('adam', 'int64_rows'),
    ('adam', 'slot_shape'), ('adam', 'devices')])
def test_new_wrappers_reject_what_the_kernels_do_not_take(kernel, bad):
  t, m, v = torch.zeros((8, 4)), torch.zeros((8, 4)), torch.zeros((8, 4))
  rows, g = torch.zeros(3, dtype=torch.int32), torch.zeros((3, 4))
  if bad == 'float16':
    t = t.half()
  elif bad == 'shape':
    g = torch.zeros((3, 5))
  elif bad == 'int64_rows':
    rows = rows.long()
  elif bad == 'slot_shape':
    v = torch.zeros((8, 5))
  else:
    m = torch.zeros((8, 4), device='meta')
  with pytest.raises((TypeError, ValueError)):
    if kernel == 'add':
      hbt.scatter_add_sorted(t, rows, g)
    else:
      hbt.adam_update_sorted(t, m, v, rows, g, LR, 1)


def test_cpu_wrappers_do_not_count_launches():
  t, m, v = torch.zeros((8, 4)), torch.zeros((8, 4)), torch.zeros((8, 4))
  rows = torch.tensor([1, 1, 3], dtype=torch.int32)
  g = torch.ones((3, 4))
  before = (hbt.scatter_add_sorted.launches, hbt.adam_update_sorted.launches)
  hbt.scatter_add_sorted(t, rows, g)
  hbt.adam_update_sorted(t, m, v, rows, g, LR, 1)
  assert (hbt.scatter_add_sorted.launches,
          hbt.adam_update_sorted.launches) == before
  assert bool((m[1] > 0).all()) and not m[0].any()
