"""Sparse Adagrad of the PyTorch port against the JAX package.

(The per-occurrence mode, ``dedup=False``, and the other table
optimizers are held against JAX in ``test_torch_sparse_optimizers.py``.)

The plain PyTorch version of the update kernel is held against the JAX
Pallas kernel (in interpret mode) and against the JAX XLA path
(``_dedup_grads`` + ``_adagrad_rows``), on one update list with
duplicates, ``-1`` rows and rows ``>= V``.

Tolerance ``rtol = atol = 1e-5``: the paths sum a row's duplicate
gradients in different f32 orders. Against a float64 reference the
Pallas kernel strays by at most 2e-5 absolute on accumulators near 100
and 6e-8 on the table, which the relative part covers.

The plain versions of the add and Adagrad kernels are also held on the
hard lists of ``test_torch_cuda.py`` (the lists the card's kernels are
checked on against these plain versions): against the JAX Pallas kernels
in interpret mode on some, and on all against numpy, float32 totals added
in list order and then, for Adagrad, the apply in float32. The add kernel
at ``rtol = atol = 1e-6`` (f32 summation order; the Pallas kernel's
one-hot matmuls stray further on runs of hundreds of entries, so those
lists take numpy only), Adagrad at the file's ``1e-5``.
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
from hybridbackend_tpu.ops.pallas.scatter import (
    adagrad_update_sorted as jax_adagrad_update_sorted,
    scatter_add_sorted as jax_scatter_add_sorted)

import hybridbackend_tpu_torch as hbt
from test_torch_cuda import HARD_LISTS, HARD_LIST_IDS, hard_list

V, D, N = 4096, 16, 3000
LR, EPS = 0.05, 1e-7
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0):
  rng = np.random.RandomState(seed)
  hot = rng.choice(V, 400, replace=False)
  rows = hot[rng.randint(0, 400, N)].astype(np.int32)
  rows[rng.choice(N, 60, replace=False)] = -1
  rows[rng.choice(N, 60, replace=False)] = V + rng.randint(0, 100, 60)
  grads = (rng.randn(N, D) * 3).astype(np.float32)
  table = rng.uniform(-0.25, 0.25, (V, D)).astype(np.float32)
  acc = np.full((V, D), 0.1, np.float32)
  order = np.argsort(rows, kind='stable')
  return table, acc, rows[order], grads[order]


def _port(table, acc, rows, grads):
  t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
  hbt.adagrad_update_sorted_reference(t, a, torch.from_numpy(rows),
                                      torch.from_numpy(grads), LR, EPS)
  return t.numpy(), a.numpy()


def test_reference_matches_pallas_kernel():
  table, acc, rows, grads = _inputs()
  want_t, want_a = jax_adagrad_update_sorted(
      jnp.asarray(table), jnp.asarray(acc), jnp.asarray(rows),
      jnp.asarray(grads), lr=LR, eps=EPS, interpret=True)
  got_t, got_a = _port(table, acc, rows, grads)
  np.testing.assert_allclose(got_a, np.asarray(want_a), **TOL)
  np.testing.assert_allclose(got_t, np.asarray(want_t), **TOL)


def test_reference_matches_xla_path():
  table, acc, rows, grads = _inputs(1)
  urows, gsum = jsu._dedup_grads(jnp.asarray(rows), jnp.asarray(grads),
                                 oob_row=V)
  want_t, want_a = jsu._adagrad_rows(jnp.asarray(table), jnp.asarray(acc),
                                     urows, gsum, LR, EPS)
  got_t, got_a = _port(table, acc, rows, grads)
  np.testing.assert_allclose(got_a, np.asarray(want_a), **TOL)
  np.testing.assert_allclose(got_t, np.asarray(want_t), **TOL)
  touched = np.unique(rows[(rows >= 0) & (rows < V)])
  untouched = np.setdiff1d(np.arange(V), touched)
  np.testing.assert_array_equal(got_t[untouched], table[untouched])
  np.testing.assert_array_equal(got_a[untouched], acc[untouched])


def test_reference_takes_unsorted_rows_and_tensor_lr():
  table, acc, rows, grads = _inputs(2)
  perm = np.random.RandomState(3).permutation(N)
  want_t, want_a = _port(table, acc, rows, grads)
  t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
  hbt.adagrad_update_sorted(t, a, torch.from_numpy(rows[perm]),
                            torch.from_numpy(grads[perm]),
                            torch.tensor(LR), EPS)
  np.testing.assert_allclose(a.numpy(), want_a, **TOL)
  np.testing.assert_allclose(t.numpy(), want_t, **TOL)


@pytest.mark.parametrize('shuffle', [False, True])
def test_sparse_adagrad_apply_matches_jax(shuffle):
  """The port's full update (validity, row mixing, stable sort, kernel)
  against the JAX replicated update, on [B, K] ids that are not sorted."""
  vocab = 3000
  rng = np.random.RandomState(4)
  ids = rng.randint(0, 300, (64, 5)).astype(np.int32)
  ids[::9, 0] = -1
  ids[1::7, 2] = vocab + 3
  demb = rng.randn(64, 5, D).astype(np.float32)
  jcfg = jtable.TableConfig('t', vocab, D, shuffle_ids=shuffle)
  tcfg = hbt.TableConfig('t', vocab, D, shuffle_ids=shuffle)
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  with context_scope(ctx):
    jt = jtable.create_table(jcfg, jax.random.PRNGKey(0), ctx)
    state = jsu.init_adagrad_state(jt)
    want_t, want_s = jsu.sparse_adagrad_apply(
        jt, state, jnp.asarray(ids), jnp.asarray(demb), jcfg, LR, ctx=ctx)
  t = torch.from_numpy(np.asarray(jt).reshape(-1, D).copy())
  st = hbt.init_adagrad_state(t)
  got_t, got_s = hbt.sparse_adagrad_apply(
      t, st, torch.from_numpy(ids), torch.from_numpy(demb), tcfg, LR)
  assert got_t is t and got_s is st            # updated in place
  np.testing.assert_allclose(st.acc[0].numpy(),
                             np.asarray(want_s.acc[0]).reshape(-1, D), **TOL)
  np.testing.assert_allclose(t.numpy(), np.asarray(want_t).reshape(-1, D),
                             **TOL)


PALLAS_ORACLE = ('random-d16', 'boundary-d16', 'n=T+1')


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_add_reference_on_the_hard_lists(spec):
  v, d, n, rows, g, table = hard_list(spec)
  got = hbt.scatter_add_sorted(table.clone(), rows, g).numpy()
  totals = np.zeros((v, d), np.float32)
  ok = ((rows >= 0) & (rows < v)).numpy()
  np.add.at(totals, rows.numpy()[ok], g.numpy()[ok])    # in list order
  np.testing.assert_allclose(got, table.numpy() + totals, rtol=1e-6,
                             atol=1e-6)
  untouched = np.setdiff1d(np.arange(v), rows.numpy())
  np.testing.assert_array_equal(got[untouched], table.numpy()[untouched])
  if spec[0] in PALLAS_ORACLE:
    want = jax_scatter_add_sorted(
        jnp.asarray(table.numpy()), jnp.asarray(rows.numpy()),
        jnp.asarray(g.numpy()), block_rows=2048, chunk=256, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def list_totals(v, d, rows, g):
  """Valid entries of a list, its distinct valid rows, and float32 totals
  added in list order, as numpy arrays."""
  ok = (rows >= 0) & (rows < v)
  s = np.zeros((v, d), np.float32)
  np.add.at(s, rows[ok], g[ok])
  return ok, np.unique(rows[ok]), s


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_adagrad_reference_on_the_hard_lists(spec):
  v, d, n, rows, g, table = hard_list(spec)
  acc = torch.full_like(table, 0.1)
  t, a = hbt.adagrad_update_sorted(table.clone(), acc.clone(), rows, g, LR,
                                   EPS)
  r, gg = rows.numpy(), g.numpy()
  _, u, s = list_totals(v, d, r, gg)
  want_t, want_a = table.numpy().copy(), acc.numpy().copy()
  want_a[u] += s[u] * s[u]
  want_t[u] -= np.float32(LR) * s[u] / (np.sqrt(want_a[u]) + np.float32(EPS))
  np.testing.assert_allclose(a.numpy(), want_a, **TOL)
  np.testing.assert_allclose(t.numpy(), want_t, **TOL)
  untouched = np.setdiff1d(np.arange(v), u)
  np.testing.assert_array_equal(t.numpy()[untouched], table.numpy()[untouched])
  np.testing.assert_array_equal(a.numpy()[untouched], acc.numpy()[untouched])
  if spec[0] in PALLAS_ORACLE:
    pt, pa = jax_adagrad_update_sorted(
        jnp.asarray(table.numpy()), jnp.asarray(acc.numpy()), jnp.asarray(r),
        jnp.asarray(gg), lr=LR, eps=EPS, interpret=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(pa), **TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(pt), **TOL)


def test_nodedup_accumulates_each_occurrence_square():
  """``dedup=False`` is not the dedup update carried over: duplicates
  accumulate each occurrence's square (TF ``SparseApplyAdagrad``), and
  the denominator is read after all of them land."""
  cfg = hbt.TableConfig('t', 8, 4)
  accs = []
  for dedup in (True, False):
    t = torch.zeros((8, 4))
    st = hbt.init_adagrad_state(t)
    hbt.sparse_adagrad_apply(t, st, torch.tensor([1, 9, 1, -1, 3]),
                             torch.ones(5, 4), cfg, LR, dedup=dedup)
    accs.append(st.acc[0])
    a1 = 0.1 + (4.0 if dedup else 2.0)
    torch.testing.assert_close(t[1], torch.full((4,), -LR * 2 / (a1 ** 0.5
                                                               + 1e-7)))
  torch.testing.assert_close(accs[0][1], torch.full((4,), 4.1))
  torch.testing.assert_close(accs[1][1], torch.full((4,), 2.1))
  assert torch.equal(accs[0][[0, 2, 4, 5, 6, 7]], accs[1][[0, 2, 4, 5, 6, 7]])


@pytest.mark.parametrize('bad', ['float16', 'int64_rows', 'shape', 'acc'])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
  t, a = torch.zeros((8, 4)), torch.zeros((8, 4))
  rows, g = torch.zeros(3, dtype=torch.int32), torch.zeros((3, 4))
  if bad == 'float16':
    t, a = t.half(), a.half()
  elif bad == 'int64_rows':
    rows = rows.long()
  elif bad == 'shape':
    g = torch.zeros((3, 5))
  else:
    a = torch.zeros((8, 5))
  with pytest.raises((TypeError, ValueError)):
    hbt.adagrad_update_sorted(t, a, rows, g, LR)
