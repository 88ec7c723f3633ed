"""Dense row totals and the dense-split Adagrad update against JAX.

The plain version of the port's ``gsum_dense_sorted`` is held against
the JAX Pallas kernel in interpret mode at D 128 (the widths that kernel
takes) and against ``np.add.at`` at narrower widths, on update lists
with duplicates, ``-1`` rows and rows ``>= V``. The port's
``sparse_adagrad_apply(split_dense=True)`` is held against the JAX
function under ``emb_update_impl='stream'`` and
``emb_update_split_dense='on'``, with a spy that shows the JAX side ran
its ``gsum_dense_sorted``; and against the port's own fused update, bit
for bit.

Tolerances. Against the Pallas kernel ``rtol = atol = 1e-5``: it sums a
row's duplicates through split-bf16 one-hot matmuls, not in list order
(9.5e-7 at most seen on totals near 10). Against ``np.add.at`` in
float32, which adds in list order as ``index_add_`` does on the CPU:
bitwise. The split update against JAX: ``rtol = atol = 1e-5``, the
tolerance of ``test_torch_scatter.py`` (the same totals, then the JAX
apply rounds through XLA's fused elementwise code). Split against fused
in the port: bitwise.

The plain version is also held on the hard lists of
``test_torch_cuda.py`` (the lists the card's kernel is checked on against
this plain version): bit for bit against ``np.add.at``, and on some
against the JAX package at ``rtol = atol = 1e-6`` (another f32 summation
order): ``sorted_segment_totals``, which sums a run by an associative
scan, and the Pallas kernel at D 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybridbackend_tpu as hb
from hybridbackend_tpu.embedding import sparse_update as jsu
from hybridbackend_tpu.embedding import table as jtable
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.ops.pallas import scatter as jscatter

import hybridbackend_tpu_torch as hbt
from test_torch_cuda import HARD_LISTS, HARD_LIST_IDS, hard_list

TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT_SCOPE = dict(emb_update_impl='stream', emb_update_split_dense='on',
                   emb_update_touched_blocks=-1)


@pytest.fixture(autouse=True)
def one_thread():
  """The port's CPU math on one thread. The dense-split update takes the
  square root of the whole accumulator, which torch splits across worker
  threads; under a loaded test run on an 8-core host, one worker's block
  of about 2600 elements once came out 6.6e-5 relative off the same call
  repeated (as an unrefined approximate square root would), and a
  JAX-parity case once differed by 1.39e-5 in 37 elements the same way.
  The checks here are about the order of operations, which one thread
  tests alone."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _list(v, d, n, hot, seed):
  """A sorted update list with duplicates, ``-1`` rows and rows >= v."""
  rng = np.random.RandomState(seed)
  rows = np.sort(rng.randint(0, hot, n)).astype(np.int32)
  rows[:13] = -1
  rows[-17:] = v + rng.randint(0, 50, 17)
  rows = np.sort(rows)
  g = (rng.randn(n, d) * 3).astype(np.float32)
  return rows, g


def _np_totals(v, rows, g):
  want = np.zeros((v, g.shape[1]), np.float32)
  ok = (rows >= 0) & (rows < v)
  np.add.at(want, rows[ok], g[ok])
  return want


def test_reference_matches_pallas_kernel():
  v = 4096
  rows, g = _list(v, 128, 900, 300, seed=0)
  want = np.asarray(jscatter.gsum_dense_sorted(
      jnp.asarray(rows), jnp.asarray(g), v, block_rows=1024, chunk=128,
      interpret=True))
  got = hbt.gsum_dense_sorted_reference(torch.from_numpy(rows),
                                        torch.from_numpy(g), v).numpy()
  np.testing.assert_allclose(got, want, **TOL)
  untouched = np.setdiff1d(np.arange(v), rows)
  assert not got[untouched].any() and not want[untouched].any()
  assert got.dtype == np.float32 and got.shape == (v, 128)


@pytest.mark.parametrize('d', [16, 17, 1])
def test_reference_matches_numpy_at_any_width(d):
  """JAX refuses widths other than multiples of 128; the port takes any
  ``d``. Against ``np.add.at``, bit for bit."""
  v = 700
  rows, g = _list(v, d, 2000, 150, seed=d)
  got = hbt.gsum_dense_sorted(torch.from_numpy(rows), torch.from_numpy(g), v)
  np.testing.assert_array_equal(got.numpy(), _np_totals(v, rows, g))


SCAN_ORACLE = ('n=T+1',)


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_reference_on_the_hard_lists(spec):
  v, d, n, rows, g, _ = hard_list(spec)
  got = hbt.gsum_dense_sorted(rows, g, v).numpy()
  np.testing.assert_array_equal(got, _np_totals(v, rows.numpy(), g.numpy()))
  if spec[0] in SCAN_ORACLE:
    _, ends, totals = jscatter.sorted_segment_totals(jnp.asarray(rows.numpy()),
                                                     jnp.asarray(g.numpy()))
    ends, totals = np.asarray(ends), np.asarray(totals)
    ok = (ends >= 0) & (ends < v)              # a run's total, at its end
    want = np.zeros((v, d), np.float32)
    want[ends[ok]] = totals[ok]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
  if d % 128 == 0:
    want = jscatter.gsum_dense_sorted(
        jnp.asarray(rows.numpy()), jnp.asarray(g.numpy()), v, block_rows=1024,
        chunk=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_wrapper_on_the_cpu_runs_the_plain_version():
  rows, g = _list(300, 16, 500, 100, seed=5)
  rows_t, g_t = torch.from_numpy(rows), torch.from_numpy(g)
  before = hbt.gsum_dense_sorted.launches
  got = hbt.gsum_dense_sorted(rows_t, g_t.bfloat16(), 300)
  assert hbt.gsum_dense_sorted.launches == before
  want = hbt.gsum_dense_sorted_reference(rows_t, g_t.bfloat16().float(), 300)
  assert got.dtype == torch.float32 and torch.equal(got, want)
  empty = hbt.gsum_dense_sorted(torch.zeros(0, dtype=torch.int32),
                                torch.zeros((0, 8)), 5)
  assert torch.equal(empty, torch.zeros((5, 8)))


def test_contract_is_ascending_rows():
  """The kernel gives each run of equal rows one owner, so it needs rows
  in ascending order. On the CPU the wrapper checks that and raises; the
  plain version sums any order (``rtol = atol = 1e-5``: duplicates in
  another order round differently)."""
  rows, g = _list(300, 16, 500, 100, seed=6)
  perm = np.random.RandomState(6).permutation(rows.shape[0])
  rows_p, g_p = torch.from_numpy(rows[perm]), torch.from_numpy(g[perm])
  with pytest.raises(ValueError, match='ascending'):
    hbt.gsum_dense_sorted(rows_p, g_p, 300)
  want = hbt.gsum_dense_sorted(torch.from_numpy(rows), torch.from_numpy(g),
                               300)
  torch.testing.assert_close(hbt.gsum_dense_sorted_reference(rows_p, g_p, 300),
                             want, **TOL)


@pytest.mark.parametrize('bad', ['int64_rows', 'rows_2d', 'shape'])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
  rows, g = torch.zeros(3, dtype=torch.int32), torch.zeros((3, 4))
  if bad == 'int64_rows':
    rows = rows.long()
  elif bad == 'rows_2d':
    rows = rows.reshape(3, 1)
  else:
    g = torch.zeros((4, 4))
  with pytest.raises((TypeError, ValueError)):
    hbt.gsum_dense_sorted(rows, g, 8)


@pytest.mark.parametrize('vocab,d,blocks,chunk', [
    (100000, 16, 132, 512),     # a dense Trainer's table: every SM
    (65536, 16, 132, 512),
    (1279569, 16, 264, 512),    # phase 36's stack
    (2600000, 16, 396, 512),    # the flagship stack
    (1100000, 32, 396, 256),    # DIN's stack
    (10, 16, 3, 512),           # rows of 4: fewer blocks than SMs
])
def test_gsum_blocking_fills_whole_rounds_of_the_card(vocab, d, blocks,
                                                      chunk):
  """Kernel 4's blocks come to whole rounds of 132 SMs, at least one,
  each a multiple of 4 rows; together they cover the table."""
  from hybridbackend_tpu_torch.ops import scatter
  rows, got_chunk = scatter.gsum_blocking(vocab, d, 132)
  assert rows % 4 == 0 and (rows - 4) * blocks < vocab <= rows * blocks
  assert -(-vocab // rows) == blocks and got_chunk == chunk


def _spy(monkeypatch):
  calls = []
  real = jscatter.gsum_dense_sorted

  def spy(*args, **kwargs):
    calls.append(args[1].shape)
    return real(*args, **kwargs)

  monkeypatch.setattr(jscatter, 'gsum_dense_sorted', spy)
  return calls


@pytest.mark.parametrize('dim', [16, 128])
def test_split_dense_update_matches_jax(monkeypatch, dim):
  """At dim 16 JAX lane-packs the table to [V/8, 128] and splits in that
  geometry; the port compares in the logical layout."""
  calls = _spy(monkeypatch)
  vocab = 2048
  rng = np.random.RandomState(dim)
  ids = rng.randint(0, 400, (64, 5)).astype(np.int32)
  ids[::9, 0] = -1
  ids[1::7, 2] = vocab + 3
  demb = rng.randn(64, 5, dim).astype(np.float32)
  jcfg = jtable.TableConfig('t', vocab, dim)
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  with context_scope(ctx), hb.scope(**SPLIT_SCOPE):
    jt = jtable.create_table(jcfg, jax.random.PRNGKey(0), ctx)
    want_t, want_s = jsu.sparse_adagrad_apply(
        jt, jsu.init_adagrad_state(jt), jnp.asarray(ids), jnp.asarray(demb),
        jcfg, 0.05, ctx=ctx)
  assert len(calls) == 1 and calls[0][1] == 128
  t = torch.from_numpy(np.asarray(jt).reshape(-1, dim)[:vocab].copy())
  st = hbt.init_adagrad_state(t)
  got_t, got_s = hbt.sparse_adagrad_apply(
      t, st, torch.from_numpy(ids), torch.from_numpy(demb),
      hbt.TableConfig('t', vocab, dim), 0.05, split_dense=True)
  assert got_t is t and got_s is st                 # updated in place
  np.testing.assert_allclose(
      st.acc[0].numpy(), np.asarray(want_s.acc[0]).reshape(-1, dim)[:vocab],
      **TOL)
  np.testing.assert_allclose(
      t.numpy(), np.asarray(want_t).reshape(-1, dim)[:vocab], **TOL)


@pytest.mark.parametrize('dim,lr', [(16, 0.05), (33, 0.3),
                                    (16, torch.tensor(0.05))])
def test_split_dense_equals_fused_bit_for_bit(dim, lr):
  vocab = 3000
  rng = np.random.RandomState(dim)
  ids = torch.from_numpy(rng.randint(-3, vocab + 5, (256, 4)))
  demb = torch.from_numpy(rng.randn(256, 4, dim).astype(np.float32))
  cfg = hbt.TableConfig('t', vocab, dim, shuffle_ids=True)
  table = torch.from_numpy(rng.uniform(-0.5, 0.5, (vocab, dim))
                           .astype(np.float32))
  out = []
  for split in (False, True):
    t = table.clone()
    st = hbt.init_adagrad_state(t)
    hbt.sparse_adagrad_apply(t, st, ids, demb, cfg, lr, split_dense=split)
    out.append((t, st.acc[0]))
  assert torch.equal(out[0][0], out[1][0])
  assert torch.equal(out[0][1], out[1][1])
  assert not torch.equal(out[1][0], table)


def test_split_dense_needs_dedup():
  t = torch.zeros((8, 4))
  with pytest.raises(ValueError, match='dedup'):
    hbt.sparse_adagrad_apply(t, hbt.init_adagrad_state(t),
                             torch.tensor([1, 2]), torch.ones((2, 4)),
                             hbt.TableConfig('t', 8, 4), 0.1, dedup=False,
                             split_dense=True)
