"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test skips where no CUDA device is present. On a GPU machine without
JAX, run this file without the suite's conftest (which sets up JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The plain version runs on the CPU copy of the inputs, where
``index_add_`` sums a row's duplicate gradients in list order, as the
kernel does; on the card it adds with atomics in no fixed order, which
rows repeated thousands of times turn into 1e-3 relative differences.
The hard lists include lists with long runs (``LONG_RUNS``: runs of
hundreds to 4096 entries, across tiles and chunks, ending on their
boundaries and at the list's end, beside invalid rows, in the unstaged
layouts). Kernel 1 is held there bit for bit against
``scatter.adagrad_update_sorted_exact``, the plain version's totals with
a correctly rounded apply (torch's CPU ``sqrt`` may differ from it in the
last bit), kernels 2 and 4 bit for bit against their plain versions, and
kernel 3's moments bit for bit, its table to the tolerance below; kernels
1-3 also at tiles of 1, 2 and 16 entries, where nearly every run leaves
its tile: a short tail (at most 8 entries past it) staged with the tile,
a long one streamed through the tail's ring of 16-KB stages.
Tolerance ``rtol = atol = 1e-5``: both sides then round the same f32
operations in the same order (LazyAdam's ``b ** step`` comes from CUDA's
``powf`` on one side and the CPU's ``pow`` on the other, a few ulp). The
update kernels run on the hard update lists (``HARD_LISTS``) that the CPU
tests also hold the plain versions on. The
dense row totals (the same adds in the same order), the row gather (a
copy) and the stochastic round (the same Philox bits) are held bitwise.

The bf16 modes of the add, Adagrad (both modes) and LazyAdam kernels
(bf16 table, slots and gradients) are held to the CPU plain versions on
the same hard lists, laid out in bf16, and at the flagship update list:
each element at most 1 bf16 ulp apart, or 1e-6 apart where a result
cancels to near zero, and at most 1% of the elements apart at all
(``assert_within_an_ulp``): the same f32 math in the same order rounds to
the same bf16 except where ``powf`` and ``pow`` differ in an f32 ulp.

``DeviceIterator``'s staging on the card (pinned buffers, copies on its
own stream, the consumer's stream waiting on them) is held bit for bit
against the source batches while the consumer's stream is kept busy; so
are the native Parquet reader's zero-copy batches, through
``DeviceIterator`` and ``put_batch``.

Host-backed tables: the same cache plans applied in place on the card
(evictions through kernel 5, uploads by ``index_copy_``, at a row offset
inside a stacked table) and on the CPU give the same host and device
rows bit for bit; a cached ``SparseTrainer`` on the card gives the CPU
trainer's flushed host tables to ``rtol = atol = 1e-5``.
"""

import numpy as np
import pytest
import torch

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.ops import scatter

TOL = dict(rtol=1e-5, atol=1e-5)


def _hard_list_specs():
  """``(name, v, d, n, kind, view)`` of the update lists built to hit the
  edges of the kernels on ``csrc/sorted_runs.cuh``: the tile of ``T`` list
  entries of the add, Adagrad and LazyAdam kernels, and the dense-totals
  kernel's block of output rows and chunk of staged entries (both a few
  tiles long at most; the card's tests also run them with small blocks
  and chunks)."""
  T = scatter.tile_entries
  specs = []
  for d in (1, 3, 4, 16, 20, 33, 128):       # every lane layout
    specs.append((f'random-d{d}', 523, d, 2 * T(d) + 1, 'random', None))
  specs.append(('random-v1537', 1537, 16, 5 * T(16), 'random', None))
  for d in (3, 16, 33):                      # a run across a tile boundary
    specs.append((f'boundary-d{d}', 2000, d, 3 * T(d), 'boundary', None))
  for d in (3, 16):                          # a run longer than a tile
    specs.append((f'long-d{d}', 2000, d, 4 * T(d) + 3, 'long', None))
  t = T(16)
  for name, n in (('0', 0), ('1', 1), ('T-1', t - 1), ('T', t),
                  ('T+1', t + 1)):
    specs.append((f'n={name}', 1000, 16, n, 'random', None))
  specs.append(('dense-slice', 300, 16, 1000, 'random', None))
  specs.append(('invalid', 300, 16, t + 9, 'invalid', None))
  # A run across a tile boundary whose gradients cancel exactly: LazyAdam
  # still moves the row (presence is run membership).
  specs.append(('cancel', 1000, 16, 2 * t + 1, 'cancel', None))
  # Views: one entry into the list (12 bytes at d = 3, 64 at d = 16), and
  # one float into the updates' storage (no 16-byte lanes, no bulk copy).
  specs += [('entry-view-d3', 700, 3, 2 * T(3) + 1, 'random', 'entry'),
            ('entry-view-d16', 700, 16, 2 * t + 1, 'random', 'entry'),
            ('float-view-d4', 700, 4, 2 * T(4) + 1, 'random', 'float'),
            ('float-view-d16', 700, 16, 2 * t + 1, 'random', 'float')]
  return specs


# Update lists with long runs: kind 'runs', rows laid out by their
# segments, in ascending rows from row 8 on: ('fill', m) is m entries of
# runs of 1, 2, 3, 1, 2, 3, ... entries on fresh rows, ('run', L) one run of
# L entries on the next fresh row (so consecutive runs lie in neighbouring
# rows, one block's), ('neg', m) m entries of -1, ('over', m) m entries of
# vocab + 3. name -> (vocab, d, segments, view, longest run, runs).
# Tiles are 128 entries at d = 3, 8 and 16, kernel 4's chunks 256 at d = 16
# (48 with small blocks).
LONG_RUNS = {
    'run-4096': (3000, 16, (('fill', 300), ('run', 4096), ('fill', 300)),
                 None, 4096, 401),
    'one-run': (100, 16, (('run', 3000),), None, 3000, 1),
    # Three neighbouring rows taking thousands of entries, as a column of
    # a few rows takes a zipf column's hot ids.
    'three-rows': (3000, 16, (('fill', 200), ('run', 2000), ('run', 1500),
                              ('run', 1000), ('fill', 200)),
                   None, 2000, 204),
    # A run from entry 5 that ends exactly on a tile boundary (768 = 6
    # tiles), and one of a whole tile pair and chunk from entry 0.
    'run-ends-on-tile': (2000, 16, (('fill', 5), ('run', 763), ('fill', 300)),
                         None, 763, 205),
    'run-fills-chunk': (2000, 16, (('run', 256), ('fill', 300)), None, 256,
                        201),
    'run-at-end': (2000, 16, (('fill', 300), ('run', 2000)), None, 2000, 201),
    'run-then-over': (2000, 16, (('fill', 100), ('run', 1500), ('over', 200)),
                      None, 1500, 68),
    'neg-then-run': (2000, 16, (('neg', 300), ('run', 1500), ('fill', 100)),
                     None, 1500, 68),
    # Rows that cannot be staged: d = 3 (scalar lanes), its 12-byte entry
    # view, and a float view at d = 16; and bf16's 16-byte rows at d = 8.
    'run-d3': (2000, 3, (('fill', 100), ('run', 1500), ('fill', 100)), None,
               1500, 135),
    'run-d3-entry-view': (2000, 3, (('fill', 100), ('run', 1500),
                                    ('fill', 100)), 'entry', 1500, 135),
    'run-float-view-d16': (2000, 16, (('fill', 100), ('run', 1500),
                                      ('fill', 100)), 'float', 1500, 135),
    'run-d8': (2000, 8, (('fill', 100), ('run', 2000), ('fill', 100)), None,
               2000, 135),
}


def long_run_rows(name):
  """The ascending int32 rows of a ``LONG_RUNS`` list."""
  v, _, segments, _, _, _ = LONG_RUNS[name]
  out, row = [], 8
  for kind, m in segments:
    if kind == 'neg':
      out += [-1] * m
    elif kind == 'over':
      out += [v + 3] * m
    elif kind == 'run':
      out += [row] * m
      row += 1
    else:
      k = 0
      while k < m:
        take = min(1 + len(out) % 3, m - k)
        out += [row] * take
        row, k = row + 1, k + take
  rows = np.asarray(out, np.int32)
  assert (np.diff(rows) >= 0).all() and rows[rows >= 0].max() <= v + 3
  return rows


HARD_LISTS = _hard_list_specs() + [
    (name, v, d, len(long_run_rows(name)), 'runs', view)
    for name, (v, d, _, view, _, _) in LONG_RUNS.items()]
HARD_LIST_IDS = [spec[0] for spec in HARD_LISTS]
LONG_LISTS = [spec for spec in HARD_LISTS if spec[4] == 'runs']
LONG_LIST_IDS = [spec[0] for spec in LONG_LISTS]

# Unsorted update lists for ``dense_row_totals`` (the lookups' backward):
# (name, vocab, d, n, kind). 'zipf': zipf(1.2) rows spread over the vocab
# by a permutation, about 5% -1 and 5% >= vocab, 2% of the updates -0.0;
# 'one': every entry one row; 'invalid': only -1 and >= vocab; 'columns':
# n/4 examples of 4 columns of 2000 rows each, zipf(1.5) ids, about 5% -1,
# so that each column's first rows take runs of hundreds to about 1600
# entries once sorted, as in phase 36's list.
ROW_TOTAL_LISTS = [('empty', 100, 16, 0, 'zipf'),
                   ('one-row', 100, 16, 3000, 'one'),
                   ('invalid', 100, 16, 500, 'invalid'),
                   ('zipf', 1000, 16, 20000, 'zipf'),
                   ('zipf-d5', 300, 5, 4000, 'zipf'),
                   ('zipf-d128', 500, 128, 3000, 'zipf'),
                   ('columns', 8000, 16, 4 * 4096, 'columns')]
ROW_TOTAL_IDS = [spec[0] for spec in ROW_TOTAL_LISTS]
# Phase 36's list: 4096 examples of 26 columns on the stack of the 26
# Criteo tables of the module entry point.
PHASE36_ROW_TOTALS = ('phase36', 1279569, 16, 4096 * 26, 'zipf')


def row_total_list(spec):
  """``(vocab, d, rows, updates)`` of a ``ROW_TOTAL_LISTS`` spec: numpy
  int64 ``[n]`` rows in no order and float32 ``[n, d]`` updates."""
  name, v, d, n, kind = spec
  rng = np.random.RandomState(sum(map(ord, name)))
  if kind == 'one':
    rows = np.full(n, v // 2, dtype=np.int64)
  elif kind == 'invalid':
    rows = np.where(rng.rand(n) < 0.5, -1, v + rng.randint(0, 9, n))
  elif kind == 'columns':
    rows = ((rng.zipf(1.5, (n // 4, 4)) % 2000) + 2000 * np.arange(4))
    rows = rows.reshape(-1)
    rows[rng.rand(n) < 0.05] = -1
  else:
    rows = rng.permutation(v)[(rng.zipf(1.2, n) - 1) % v]
    rows[rng.rand(n) < 0.05] = -1
    rows[rng.rand(n) < 0.05] = v + 3
  updates = rng.randn(n, d).astype(np.float32)
  updates[rng.rand(n) < 0.02] = -0.0
  return v, d, rows.astype(np.int64), updates


def hard_list(spec, device='cpu', dtype=torch.float32):
  """``(v, d, n, rows, updates, table)`` of one spec, as tensors on
  ``device``; ``rows`` ascending. The same numbers on every device.
  ``dtype`` rounds the updates and the table to it before the spec's
  view is taken (a float view is then one element of ``dtype`` into the
  updates' storage)."""
  name, v, d, n, kind, view = spec
  rng = np.random.RandomState(sum(map(ord, name)))
  tile = scatter.tile_entries(d)
  if kind == 'invalid':
    rows = np.sort(np.where(np.arange(n) < n // 2, -1, v + np.arange(n) % 9))
  elif kind == 'runs':
    rows = long_run_rows(name)
  else:
    hot = rng.choice(v, max(1, min(v, n // 3)), replace=False)
    rows = hot[rng.randint(0, len(hot), n)]
    rows[rng.rand(n) < 0.05] = -1
    rows[rng.rand(n) < 0.05] = v + 3
    rows = np.sort(rows)
    if kind == 'boundary':                   # entries T-3 .. T+2 are one run
      rows[tile - 3:tile + 3] = rows[tile - 3]
      rows[2 * tile - 1:2 * tile + 1] = rows[2 * tile - 1]
    elif kind == 'long':                     # 2T + 7 entries from mid-tile
      rows[tile // 2:tile // 2 + 2 * tile + 7] = rows[tile // 2]
    elif kind == 'cancel':                   # entries T-2 .. T+1 and more
      rows[tile - 2:tile + 2] = rows[tile - 2]
  rows = rows.astype(np.int32)
  assert (np.diff(rows) >= 0).all()
  g = rng.randn(n, d).astype(np.float32)
  if kind == 'cancel':
    r = rows[tile - 2]
    lo, hi = np.searchsorted(rows, r), np.searchsorted(rows, r, 'right')
    g[lo + 1:hi:2] = -g[lo:hi - 1:2]         # pairs that sum to 0.0 exactly
    if (hi - lo) % 2:
      g[hi - 1] = 0.0
  table = torch.from_numpy(rng.uniform(-1, 1, (v, d)).astype(np.float32))
  table = table.to(dtype)
  rows_t, g_t = torch.from_numpy(rows), torch.from_numpy(g).to(dtype)
  if view == 'entry':
    rows_t = torch.cat([rows_t[:1], rows_t]).to(device)[1:]
    g_t = torch.cat([g_t[:1], g_t]).to(device)[1:]
  elif view == 'float':
    g_t = torch.cat([g_t.new_zeros(1), g_t.reshape(-1)]).to(device)[1:].view(
        n, d)
  return v, d, n, rows_t.to(device), g_t.to(device), table.to(device)


def cancel_row(spec):
  """The row of the ``cancel`` spec's run, whose total is exactly 0."""
  tile = scatter.tile_entries(spec[2])
  return int(hard_list(spec)[3][tile - 2])


def hard_slots(spec, table):
  """LazyAdam moments for a spec's ``table``, from the spec's seed: ``m``
  N(0, 0.1), ``v`` U(0, 0.5), on ``table``'s device."""
  rng = np.random.RandomState(sum(map(ord, spec[0])) + 1)
  m = (rng.randn(*table.shape) * 0.1).astype(np.float32)
  v = (rng.rand(*table.shape) * 0.5).astype(np.float32)
  return (torch.from_numpy(m).to(table.device),
          torch.from_numpy(v).to(table.device))


def ulps_apart(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
  """Per element, how many bf16 values lie between ``got`` and ``want``
  (both bf16, one device): the sign-magnitude bits mapped onto one
  integer line."""
  def line(x):
    bits = x.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7fff), bits)
  return (line(got) - line(want)).abs()


def assert_within_an_ulp(got, want, share, atol=1e-6):
  """Each element at most 1 bf16 ulp from ``want``, or within ``atol`` of
  it (a result that cancels to near 0, as ``b1·m + (1-b1)·s`` can, keeps
  the f32 order error of its terms at a magnitude where a bf16 ulp is far
  smaller); at most ``share`` of the elements apart at all. Returns the
  number of elements apart."""
  ulps = ulps_apart(got, want)
  near = (got.float() - want.float()).abs() <= atol
  far = (ulps > 1) & ~near
  assert not bool(far.any()), (
      f'{int(far.sum())} elements more than 1 ulp and {atol} apart, up to '
      f'{float((got.float() - want.float()).abs().max())}')
  differ = int((ulps > 0).sum())
  assert differ <= share * max(ulps.numel(), 1), (
      f'{differ} of {ulps.numel()} elements differ')
  return differ


def update_state(kernel, spec, table):
  """``[table, *slots]`` of an update kernel (``'add'``, ``'adagrad'``,
  ``'nodedup'`` or ``'adam'``) for a hard list, in the table's dtype and
  on its device: Adagrad's accumulator 0.1, LazyAdam's ``hard_slots``."""
  if kernel == 'add':
    return [table]
  if kernel == 'adam':
    return [table] + [s.to(table.dtype) for s in hard_slots(
        spec, table.float())]
  return [table, torch.full_like(table, 0.1)]


def run_update(kernel, state, rows, g, lr=0.05, step=3):
  """Runs one update kernel's wrapper on ``state`` in place (the kernel on
  a CUDA tensor, the plain version on a CPU one)."""
  if kernel == 'add':
    hbt.scatter_add_sorted(*state, rows, g)
  elif kernel == 'adam':
    hbt.adam_update_sorted(*state, rows, g, lr, step)
  else:
    hbt.adagrad_update_sorted(*state, rows, g, lr, dedup=kernel == 'adagrad')


UPDATE_KERNELS = ['add', 'adagrad', 'nodedup', 'adam']


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda', 0)


def _case(dev, v, d, n, distinct, seed):
  rng = np.random.RandomState(seed)
  hot = rng.choice(v, min(distinct, v), replace=False)
  rows = hot[rng.randint(0, len(hot), n)].astype(np.int32)
  if n:
    rows[rng.rand(n) < 0.05] = -1
    rows[rng.rand(n) < 0.05] = v + 3
  rows = torch.from_numpy(np.sort(rows)).to(dev)
  g = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev)
  table = torch.from_numpy(rng.uniform(-1, 1, (v, d)).astype(np.float32))
  return table.to(dev), torch.full((v, d), 0.1, device=dev), rows, g


@pytest.mark.parametrize('v,d,n,distinct', [
    (1000, 16, 5000, 300), (1000, 1, 5000, 300), (997, 33, 4000, 50),
    (4096, 128, 20000, 4000), (64, 16, 20000, 2),   # long runs
    (100, 16, 0, 1), (100, 16, 1, 1)])
def test_kernel_matches_plain_version(dev, v, d, n, distinct):
  table, acc, rows, g = _case(dev, v, d, n, distinct, seed=v + d + n)
  tk, ak = table.clone(), acc.clone()
  before = hbt.adagrad_update_sorted.launches
  hbt.adagrad_update_sorted(tk, ak, rows, g, 0.05)
  assert hbt.adagrad_update_sorted.launches == before + 1
  tr, ar = table.cpu(), acc.cpu()
  hbt.adagrad_update_sorted_reference(tr, ar, rows.cpu(), g.cpu(), 0.05)
  torch.testing.assert_close(ak.cpu(), ar, **TOL)
  torch.testing.assert_close(tk.cpu(), tr, **TOL)
  touched = torch.zeros(v, dtype=torch.bool, device=dev)
  touched[rows[(rows >= 0) & (rows < v)].long()] = True
  assert torch.equal(tk[~touched], table[~touched])
  assert torch.equal(ak[~touched], acc[~touched])


def test_lr_is_read_on_the_device(dev):
  table, acc, rows, g = _case(dev, 500, 16, 2000, 100, seed=1)
  lr = torch.full((), 0.05, device=dev)
  want_t, want_a = table.clone(), acc.clone()
  hbt.adagrad_update_sorted_reference(want_t, want_a, rows, g, 0.2)
  lr.fill_(0.2)                      # a schedule changes the tensor only
  hbt.adagrad_update_sorted(table, acc, rows, g, lr)
  torch.testing.assert_close(table, want_t, **TOL)
  torch.testing.assert_close(acc, want_a, **TOL)


def test_sparse_step_runs_the_kernel_on_the_card(dev):
  ctx = hbt.Context(dev)
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{i}', 500, 16))
           for i in range(3)]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=['i0'], ctx=ctx)
  gen = torch.Generator().manual_seed(0)
  tower = hbt.StackedDCNv2([16] * 3 + [1], [32, 1], generator=gen,
                           device=dev)
  state = hbt.SparseTrainState.create(
      tower, fx.init(gen), lambda p: torch.optim.Adam(p, lr=1e-3))

  def loss_fn(tower, emb_f, dense_f, batch):
    p = torch.clamp(tower(emb_f + dense_f), 1e-6, 1 - 1e-6)
    y = batch['label']
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {}

  step = hbt.make_sparse_train_step(fx, loss_fn)
  rng = np.random.RandomState(0)
  batch = {f'c{i}': torch.from_numpy(
      rng.randint(-5, 520, 64).astype(np.int32)).to(dev) for i in range(3)}
  batch['i0'] = torch.rand(64, device=dev)
  batch['label'] = torch.randint(0, 2, (64,), device=dev).float()
  before = hbt.adagrad_update_sorted.launches
  for _ in range(3):
    state, m = step(state, batch)
  assert hbt.adagrad_update_sorted.launches == before + 3
  assert torch.isfinite(m['loss'])


def test_kernel_rejects_non_contiguous_tables(dev):
  table = torch.zeros((16, 8), device=dev).t()
  acc = torch.zeros((8, 16), device=dev)
  with pytest.raises(ValueError, match='contiguous'):
    hbt.adagrad_update_sorted(table, acc,
                              torch.zeros(2, dtype=torch.int32, device=dev),
                              torch.zeros((2, 16), device=dev), 0.1)


CASES = [(1000, 16, 5000, 300), (1000, 1, 5000, 300), (997, 33, 4000, 50),
         (4096, 128, 20000, 4000), (64, 16, 20000, 2),   # runs of 10000
         (100, 16, 0, 1), (100, 16, 1, 1)]


def _all_invalid(dev, v, d, n=500):
  rows = torch.tensor([-1] * (n // 2) + [v, v + 7] * (n // 4),
                      dtype=torch.int32, device=dev).sort().values
  g = torch.randn(rows.shape[0], d, device=dev)
  table = torch.rand(v, d, device=dev)
  return table, rows, g


def _assert_untouched(rows, v, pairs):
  touched = torch.zeros(v, dtype=torch.bool, device=rows.device)
  touched[rows[(rows >= 0) & (rows < v)].long()] = True
  for got, before in pairs:
    assert torch.equal(got[~touched], before[~touched])


@pytest.mark.parametrize('v,d,n,distinct', CASES)
def test_nodedup_kernel_matches_plain_version(dev, v, d, n, distinct):
  table, acc, rows, g = _case(dev, v, d, n, distinct, seed=v + d + n + 1)
  tk, ak = table.clone(), acc.clone()
  before = hbt.adagrad_update_sorted.launches
  hbt.adagrad_update_sorted(tk, ak, rows, g, 0.05, dedup=False)
  assert hbt.adagrad_update_sorted.launches == before + 1
  tr, ar = table.cpu(), acc.cpu()
  hbt.adagrad_update_sorted_reference(tr, ar, rows.cpu(), g.cpu(), 0.05,
                                      dedup=False)
  torch.testing.assert_close(ak.cpu(), ar, **TOL)
  torch.testing.assert_close(tk.cpu(), tr, **TOL)
  _assert_untouched(rows, v, [(tk, table), (ak, acc)])


@pytest.mark.parametrize('v,d,n,distinct', CASES)
def test_add_kernel_matches_plain_version(dev, v, d, n, distinct):
  table, _, rows, g = _case(dev, v, d, n, distinct, seed=v + d + n + 2)
  tk = table.clone()
  before = hbt.scatter_add_sorted.launches
  hbt.scatter_add_sorted(tk, rows, g)
  assert hbt.scatter_add_sorted.launches == before + 1
  tr = hbt.scatter_add_sorted_reference(table.cpu(), rows.cpu(), g.cpu())
  torch.testing.assert_close(tk.cpu(), tr, **TOL)
  _assert_untouched(rows, v, [(tk, table)])


@pytest.mark.parametrize('v,d,n,distinct', CASES)
def test_adam_kernel_matches_plain_version(dev, v, d, n, distinct):
  table, _, rows, g = _case(dev, v, d, n, distinct, seed=v + d + n + 3)
  gen = torch.Generator().manual_seed(v + n)
  m = (torch.randn(v, d, generator=gen) * 0.1).to(dev)
  vv = (torch.rand(v, d, generator=gen) * 0.5).to(dev)
  tk, mk, vk = table.clone(), m.clone(), vv.clone()
  before = hbt.adam_update_sorted.launches
  hbt.adam_update_sorted(tk, mk, vk, rows, g, 0.05, 3)
  assert hbt.adam_update_sorted.launches == before + 1
  tr, mr, vr = hbt.adam_update_sorted_reference(
      table.cpu(), m.cpu(), vv.cpu(), rows.cpu(), g.cpu(), 0.05, 3)
  for got, want in ((tk, tr), (mk, mr), (vk, vr)):
    torch.testing.assert_close(got.cpu(), want, **TOL)
  _assert_untouched(rows, v, [(tk, table), (mk, m), (vk, vv)])


@pytest.mark.parametrize('kernel', ['adagrad', 'nodedup', 'add', 'adam'])
def test_kernels_skip_an_all_invalid_list(dev, kernel):
  table, rows, g = _all_invalid(dev, 300, 16)
  slots = [torch.rand_like(table), torch.rand_like(table)]
  before = [table.clone(), *(s.clone() for s in slots)]
  if kernel == 'add':
    hbt.scatter_add_sorted(table, rows, g)
  elif kernel == 'adam':
    hbt.adam_update_sorted(table, *slots, rows, g, 0.05, 1)
  else:
    hbt.adagrad_update_sorted(table, slots[0], rows, g, 0.05,
                              dedup=kernel == 'adagrad')
  torch.cuda.synchronize()
  for got, want in zip([table, *slots], before):
    assert torch.equal(got, want)


def test_adam_reads_lr_and_step_on_the_device(dev):
  table, _, rows, g = _case(dev, 500, 16, 2000, 100, seed=2)
  m, v = torch.zeros_like(table), torch.zeros_like(table)
  want = [table.clone(), m.clone(), v.clone()]
  hbt.adam_update_sorted_reference(*want, rows, g, 0.2, 7)
  lr = torch.full((), 0.05, device=dev)
  step = torch.ones((), device=dev)
  lr.fill_(0.2)                      # a schedule changes the tensors only
  step.fill_(7)
  hbt.adam_update_sorted(table, m, v, rows, g, lr, step)
  for got, w in zip((table, m, v), want):
    torch.testing.assert_close(got, w, **TOL)


@pytest.mark.parametrize('model,optimizer,dedup', [
    ('dcnv2', 'adagrad', False), ('dlrm', 'adam', True)])
def test_sparse_step_variants_run_their_kernels_on_the_card(
    dev, model, optimizer, dedup):
  ctx = hbt.Context(dev)
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{i}', 500, 16))
           for i in range(3)]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=['i0'], ctx=ctx)
  gen = torch.Generator().manual_seed(0)
  if model == 'dcnv2':
    tower = hbt.StackedDCNv2([16] * 3 + [1], [32, 1], generator=gen,
                             device=dev)
    preds = lambda t, emb_f, dense_f: t(emb_f + dense_f)
  else:
    tower = hbt.DLRM(1, 3, [16, 8], 16, [32, 1], generator=gen, device=dev)
    preds = lambda t, emb_f, dense_f: t(dense_f, emb_f)
  state = hbt.SparseTrainState.create(
      tower, fx.init(gen), lambda p: torch.optim.Adam(p, lr=1e-3),
      adam=optimizer == 'adam')

  def loss_fn(tower, emb_f, dense_f, batch):
    p = torch.clamp(preds(tower, emb_f, dense_f), 1e-6, 1 - 1e-6)
    y = batch['label']
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {}

  step = hbt.make_sparse_train_step(fx, loss_fn, table_dedup=dedup,
                                    table_optimizer=optimizer)
  rng = np.random.RandomState(0)
  batch = {f'c{i}': torch.from_numpy(
      rng.randint(-5, 520, 64).astype(np.int32)).to(dev) for i in range(3)}
  batch['i0'] = torch.rand(64, device=dev)
  batch['label'] = torch.randint(0, 2, (64,), device=dev).float()
  counter = (hbt.adam_update_sorted if optimizer == 'adam'
             else hbt.adagrad_update_sorted)
  before = counter.launches
  for _ in range(3):
    state, m = step(state, batch)
  assert counter.launches == before + 3
  assert torch.isfinite(m['loss'])


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_add_kernel_on_the_hard_lists(dev, spec):
  v, d, n, rows, g, table = hard_list(spec, dev)
  tk = table.clone()
  before = hbt.scatter_add_sorted.launches
  hbt.scatter_add_sorted(tk, rows, g)
  assert hbt.scatter_add_sorted.launches == before + 1
  tr = hbt.scatter_add_sorted_reference(table.cpu(), rows.cpu(), g.cpu())
  torch.testing.assert_close(tk.cpu(), tr, **TOL)
  _assert_untouched(rows, v, [(tk, table)])


@pytest.mark.parametrize('dedup', [True, False])
@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_adagrad_kernel_on_the_hard_lists(dev, spec, dedup):
  v, d, n, rows, g, table = hard_list(spec, dev)
  acc = torch.full_like(table, 0.1)
  tk, ak = table.clone(), acc.clone()
  before = hbt.adagrad_update_sorted.launches
  hbt.adagrad_update_sorted(tk, ak, rows, g, 0.05, dedup=dedup)
  assert hbt.adagrad_update_sorted.launches == before + 1
  tr, ar = hbt.adagrad_update_sorted_reference(
      table.cpu(), acc.cpu(), rows.cpu(), g.cpu(), 0.05, dedup=dedup)
  torch.testing.assert_close(ak.cpu(), ar, **TOL)
  torch.testing.assert_close(tk.cpu(), tr, **TOL)
  _assert_untouched(rows, v, [(tk, table), (ak, acc)])


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_adam_kernel_on_the_hard_lists(dev, spec):
  v, d, n, rows, g, table = hard_list(spec, dev)
  m, vv = hard_slots(spec, table)
  tk, mk, vk = table.clone(), m.clone(), vv.clone()
  before = hbt.adam_update_sorted.launches
  hbt.adam_update_sorted(tk, mk, vk, rows, g, 0.05, 3)
  assert hbt.adam_update_sorted.launches == before + 1
  tr, mr, vr = hbt.adam_update_sorted_reference(
      table.cpu(), m.cpu(), vv.cpu(), rows.cpu(), g.cpu(), 0.05, 3)
  for got, want in ((tk, tr), (mk, mr), (vk, vr)):
    torch.testing.assert_close(got.cpu(), want, **TOL)
  _assert_untouched(rows, v, [(tk, table), (mk, m), (vk, vv)])
  if spec[0] == 'cancel':                    # a zero total, still present
    r = cancel_row(spec)
    assert not torch.equal(tk[r], table[r]) and not torch.equal(mk[r], m[r])


@pytest.mark.parametrize('name', LONG_RUNS)
def test_long_run_lists_have_their_named_runs(name):
  """On the CPU: each long-run list holds the longest run and the number
  of runs of valid rows that its spec names, in ascending rows, and
  ``hard_list`` lays it out as ``long_run_rows`` does."""
  v, d, _, view, longest, runs = LONG_RUNS[name]
  rows = long_run_rows(name)
  valid = rows[(rows >= 0) & (rows < v)]
  _, counts = np.unique(valid, return_counts=True)
  assert (int(counts.max()), counts.size) == (longest, runs)
  spec = LONG_LISTS[LONG_LIST_IDS.index(name)]
  got = hard_list(spec)
  assert got[:3] == (v, d, rows.size) and np.array_equal(got[3].numpy(), rows)


def test_columns_row_totals_list_has_long_runs():
  """On the CPU: the unsorted ``'columns'`` list, sorted, holds each
  column's first row as a run of more than 1400 entries."""
  v, _, rows, _ = row_total_list(ROW_TOTAL_LISTS[ROW_TOTAL_IDS.index(
      'columns')])
  rows = np.sort(rows[(rows >= 0) & (rows < v)])
  _, counts = np.unique(rows, return_counts=True)
  assert (np.sort(counts)[-4:] > 1400).all()


@pytest.mark.parametrize('small', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('dedup', [True, False])
@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_adagrad_kernel_bits_on_the_hard_lists(dev, spec, dedup, dtype, small,
                                               monkeypatch):
  """Kernel 1 in each mode bit for bit
  ``scatter.adagrad_update_sorted_exact`` (the plain version's totals and
  a correctly rounded apply); ``small``: tiles of 16
  entries, so that runs leave many tiles."""
  if small:
    monkeypatch.setattr(scatter, 'TILE_ENTRIES', 16)
  v, d, n, rows, g, table = hard_list(spec, dev, dtype)
  acc = torch.full_like(table, 0.1)
  tk, ak = table.clone(), acc.clone()
  hbt.adagrad_update_sorted(tk, ak, rows, g, 0.05, dedup=dedup)
  tr, ar = scatter.adagrad_update_sorted_exact(
      table.cpu(), acc.cpu(), rows.cpu(), g.cpu(), 0.05, dedup=dedup)
  assert _same_bits(ak.cpu(), ar) and _same_bits(tk.cpu(), tr)


@pytest.mark.parametrize('small', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('spec', LONG_LISTS, ids=LONG_LIST_IDS)
def test_add_kernel_bits_on_the_long_lists(dev, spec, dtype, small,
                                           monkeypatch):
  """Kernel 2 bit for bit its plain version on the long-run lists, in f32
  and bf16 (the same f32 totals, each row rounded once); ``small``: tiles
  of 16 entries."""
  if small:
    monkeypatch.setattr(scatter, 'TILE_ENTRIES', 16)
  v, d, n, rows, g, table = hard_list(spec, dev, dtype)
  got = hbt.scatter_add_sorted(table.clone(), rows, g)
  assert _same_bits(got.cpu(), hbt.scatter_add_sorted_reference(
      table.cpu(), rows.cpu(), g.cpu()))


def assert_adam_bits(got, want, dtype):
  """Kernel 3's ``(table, m, v)`` against its plain version's: the moments
  bit for bit (no ``powf`` in them); the table within ``TOL`` in f32, or
  by the bf16 rule of ``assert_within_an_ulp`` (``b ** step`` from CUDA's
  ``powf`` against the CPU's ``pow``)."""
  (tk, mk, vk), (tr, mr, vr) = [[x.cpu() for x in xs] for xs in (got, want)]
  assert _same_bits(mk, mr) and _same_bits(vk, vr)
  if dtype == torch.float32:
    torch.testing.assert_close(tk, tr, **TOL)
  else:
    assert_within_an_ulp(tk, tr, share=0.01)


@pytest.mark.parametrize('small', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('spec', LONG_LISTS, ids=LONG_LIST_IDS)
def test_adam_kernel_bits_on_the_long_lists(dev, spec, dtype, small,
                                            monkeypatch):
  """Kernel 3 on the long-run lists (``assert_adam_bits``); ``small``:
  tiles of 16 entries."""
  if small:
    monkeypatch.setattr(scatter, 'TILE_ENTRIES', 16)
  v, d, n, rows, g, table = hard_list(spec, dev, dtype)
  state = update_state('adam', spec, table)
  got = [t.clone() for t in state]
  hbt.adam_update_sorted(*got, rows, g, 0.05, 3)
  want = hbt.adam_update_sorted_reference(
      *(t.cpu() for t in state), rows.cpu(), g.cpu(), 0.05, 3)
  assert_adam_bits(got, want, dtype)
  _assert_untouched(rows, v, list(zip(got, state)))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_adam_kernel_moves_a_tail_whose_total_is_zero(dev, dtype):
  """The run of 4096 of ``run-4096`` leaves its tiles, and its gradients
  cancel in pairs, so that its total is exactly 0 after every pair: the
  tail's row is present all the same, so its moments decay and its table
  row moves, as in the plain version."""
  spec = LONG_LISTS[LONG_LIST_IDS.index('run-4096')]
  v, d, n, rows, g, table = hard_list(spec, 'cpu', dtype)
  r = int(rows[400])
  lo, hi = (int(np.searchsorted(rows.numpy(), r, side))
            for side in ('left', 'right'))
  assert hi - lo == 4096
  g[lo + 1:hi:2] = -g[lo:hi - 1:2]
  state = update_state('adam', spec, table)
  got = [t.to(dev, copy=True) for t in state]
  hbt.adam_update_sorted(*got, rows.to(dev), g.to(dev), 0.05, 3)
  want = hbt.adam_update_sorted_reference(
      *(t.clone() for t in state), rows, g, 0.05, 3)
  assert_adam_bits(got, want, dtype)
  tk, mk = got[0].cpu(), got[1].cpu()
  assert not torch.equal(tk[r], table[r]) and not torch.equal(mk[r],
                                                              state[1][r])


@pytest.mark.parametrize('tile', [1, 2])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kernel', ['add', 'adam', 'adagrad', 'nodedup'])
@pytest.mark.parametrize('spec', LONG_LISTS, ids=LONG_LIST_IDS)
def test_update_kernels_at_a_tile_of_one_and_two(dev, spec, kernel, dtype,
                                                 tile, monkeypatch):
  """Kernels 1-3 with tiles of 1 and 2 entries: every run of two or more
  (three or more) leaves its tile, as a short tail of at most 8 entries
  past it, staged with the tile, or a long one, which the block streams
  through its ring from the next entry on. Bits as on the long lists:
  kernel 2 and kernel 1 (against ``adagrad_update_sorted_exact``)
  bitwise, kernel 3 by ``assert_adam_bits``."""
  monkeypatch.setattr(scatter, 'tile_entries', lambda d: tile)
  v, d, n, rows, g, table = hard_list(spec, dev, dtype)
  state = update_state(kernel, spec, table)
  got = [t.clone() for t in state]
  run_update(kernel, got, rows, g)
  plain = [t.cpu() for t in state]
  if kernel == 'adam':
    want = hbt.adam_update_sorted_reference(*plain, rows.cpu(), g.cpu(),
                                            0.05, 3)
    assert_adam_bits(got, want, dtype)
    return
  if kernel == 'add':
    want = [hbt.scatter_add_sorted_reference(*plain, rows.cpu(), g.cpu())]
  else:
    want = scatter.adagrad_update_sorted_exact(
        *plain, rows.cpu(), g.cpu(), 0.05, dedup=kernel == 'adagrad')
  for x, w in zip(got, want):
    assert _same_bits(x.cpu(), w)


@pytest.mark.parametrize('kernel', ['adagrad', 'nodedup', 'adam'])
@pytest.mark.parametrize('name', ['random-d4', 'boundary-d16', 'long-d16'])
def test_update_kernels_take_state_one_float_into_its_storage(
    dev, name, kernel):
  """Table and slots start one float into their storage: no 16-byte
  lanes for them, while the gradients are still staged."""
  spec = HARD_LISTS[HARD_LIST_IDS.index(name)]
  v, d, n, rows, g, table = hard_list(spec, dev)
  state = [table] + (list(hard_slots(spec, table)) if kernel == 'adam'
                     else [torch.full_like(table, 0.1)])
  shifted = [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(v, d)
             for t in state]
  want = [t.cpu() for t in state]
  if kernel == 'adam':
    hbt.adam_update_sorted(*shifted, rows, g, 0.05, 3)
    hbt.adam_update_sorted_reference(*want, rows.cpu(), g.cpu(), 0.05, 3)
  else:
    hbt.adagrad_update_sorted(*shifted, rows, g, 0.05,
                              dedup=kernel == 'adagrad')
    hbt.adagrad_update_sorted_reference(*want, rows.cpu(), g.cpu(), 0.05,
                                        dedup=kernel == 'adagrad')
  for got, w in zip(shifted, want):
    torch.testing.assert_close(got.cpu(), w, **TOL)
  _assert_untouched(rows, v, list(zip(shifted, state)))


@pytest.mark.parametrize('kernel', ['adagrad', 'nodedup', 'adam'])
def test_update_kernels_take_a_row_too_wide_to_stage(dev, kernel):
  """60000 floats a row: a tile of 16 entries exceeds shared memory, so
  the kernel reads the gradients from global memory."""
  v, d, n = 7, 60000, 40
  gen = torch.Generator().manual_seed(d)
  rows = torch.randint(-1, v + 2, (n,), generator=gen,
                       dtype=torch.int32).sort().values
  g = torch.randn(n, d, generator=gen)
  state = [torch.rand(v, d, generator=gen) for _ in range(3)]
  if kernel != 'adam':
    state = state[:2]
  got = [t.to(dev) for t in state]
  if kernel == 'adam':
    hbt.adam_update_sorted(*got, rows.to(dev), g.to(dev), 0.05, 3)
    hbt.adam_update_sorted_reference(*state, rows, g, 0.05, 3)
  else:
    hbt.adagrad_update_sorted(*got, rows.to(dev), g.to(dev), 0.05,
                              dedup=kernel == 'adagrad')
    hbt.adagrad_update_sorted_reference(*state, rows, g, 0.05,
                                        dedup=kernel == 'adagrad')
  for a, b in zip(got, state):
    torch.testing.assert_close(a.cpu(), b, **TOL)


def test_add_kernel_takes_a_row_too_wide_to_stage(dev):
  """A tile of 16 entries of 60000 floats exceeds shared memory: the
  kernel reads the updates from global memory."""
  v, d, n = 7, 60000, 40
  gen = torch.Generator().manual_seed(d)
  rows = torch.randint(-1, v + 2, (n,), generator=gen,
                       dtype=torch.int32).sort().values
  g, table = torch.randn(n, d, generator=gen), torch.rand(v, d, generator=gen)
  got = hbt.scatter_add_sorted(table.to(dev), rows.to(dev), g.to(dev))
  want = hbt.scatter_add_sorted_reference(table.clone(), rows, g)
  torch.testing.assert_close(got.cpu(), want, **TOL)


# A column-sharded table's slice, ``[V, d/W]`` of a ``[V, 16]`` table (4 or
# 8 wide at W = 4 or 2; the 4-wide one on the kernels' scalar lanes), with
# the whole batch's sorted list every rank updates it with.
@pytest.mark.parametrize('width', [4, 8])
@pytest.mark.parametrize('kernel', [*UPDATE_KERNELS, 'gsum'])
def test_kernels_on_a_column_slice(dev, kernel, width):
  table, _, rows, g16 = _case(dev, 5000, 16, 24576, 3000, seed=width)
  cols = slice(16 - width, 16)
  piece = table[:, cols].contiguous()
  g = g16[:, cols].contiguous()
  if kernel == 'gsum':
    got = hbt.gsum_dense_sorted(rows, g, piece.shape[0])
    want = hbt.gsum_dense_sorted_reference(rows.cpu(), g.cpu(),
                                           piece.shape[0])
    assert torch.equal(got.cpu(), want)
    return
  state = update_state(kernel, None, piece) if kernel != 'adam' else [
      piece, torch.rand_like(piece) * 0.01, torch.rand_like(piece) * 0.01]
  plain = [t.cpu() for t in state]
  name = {'add': 'scatter_add_sorted', 'adam': 'adam_update_sorted'}.get(
      kernel, 'adagrad_update_sorted')
  before = getattr(hbt, name).launches
  run_update(kernel, state, rows, g)
  assert getattr(hbt, name).launches == before + 1
  run_update(kernel, plain, rows.cpu(), g.cpu())
  for got, want in zip(state, plain):
    torch.testing.assert_close(got.cpu(), want, **TOL)


# Kernel 4 and the dense-split update. Bitwise: the kernel sums each run
# in list order from 0, as ``index_add_`` does on the CPU.
@pytest.mark.parametrize('v,d,n,distinct', CASES + [(700, 128, 3000, 200),
                                                    (500, 17, 3000, 100)])
def test_gsum_kernel_matches_plain_version(dev, v, d, n, distinct):
  _, _, rows, g = _case(dev, v, d, n, distinct, seed=v + d + n + 4)
  before = hbt.gsum_dense_sorted.launches
  got = hbt.gsum_dense_sorted(rows, g, v)
  assert hbt.gsum_dense_sorted.launches == before + 1
  want = hbt.gsum_dense_sorted_reference(rows.cpu(), g.cpu(), v)
  assert got.dtype == torch.float32 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize('small_blocks', [False, True])
@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_gsum_kernel_on_the_hard_lists(dev, spec, small_blocks, monkeypatch):
  """``small_blocks``: blocks of 512 bytes of output and chunks of 48
  entries, so that these small lists span many blocks (more than the card
  has SMs, a ragged last one) and slices span several chunks."""
  if small_blocks:
    monkeypatch.setattr(scatter, 'GSUM_BLOCK_BYTES', 512)
    monkeypatch.setattr(scatter, 'GSUM_CHUNK_ENTRIES', 48)
  v, d, n, rows, g, _ = hard_list(spec, dev)
  before = hbt.gsum_dense_sorted.launches
  got = hbt.gsum_dense_sorted(rows, g, v)
  assert hbt.gsum_dense_sorted.launches == before + 1
  want = hbt.gsum_dense_sorted_reference(rows.cpu(), g.cpu(), v)
  assert torch.equal(got.cpu(), want)        # untouched rows exactly 0 too


def test_gsum_kernel_takes_a_row_too_wide_to_stage(dev):
  """60000 floats a row: blocks of 4 rows, and a chunk of 16 entries
  exceeds shared memory, so the kernel reads the updates from global
  memory."""
  v, d, n = 7, 60000, 40
  gen = torch.Generator().manual_seed(d)
  rows = torch.randint(-1, v + 2, (n,), generator=gen,
                       dtype=torch.int32).sort().values
  g = torch.randn(n, d, generator=gen)
  got = hbt.gsum_dense_sorted(rows.to(dev), g.to(dev), v)
  assert torch.equal(got.cpu(), hbt.gsum_dense_sorted_reference(rows, g, v))


def test_gsum_kernel_of_an_all_invalid_list_is_zero(dev):
  _, rows, g = _all_invalid(dev, 300, 16)
  got = hbt.gsum_dense_sorted(rows, g, 300)
  assert torch.equal(got, torch.zeros((300, 16), device=dev))


def _same_bits(a, b):
  """Equal bits of two float32 or two bfloat16 tensors (``-0.0`` is not
  ``0.0``)."""
  bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
  return a.dtype == b.dtype and torch.equal(a.contiguous().view(bits),
                                            b.contiguous().view(bits))


@pytest.mark.parametrize('spec', [*ROW_TOTAL_LISTS, PHASE36_ROW_TOTALS],
                         ids=[*ROW_TOTAL_IDS, 'phase36'])
def test_dense_row_totals_repeat_the_plain_versions_bits(dev, spec):
  """The lookups' backward: an unsorted list sorted stably and summed by
  kernel 4, 5 times, each bit for bit the CPU plain version (list-order
  sums); one launch a call."""
  v, _, rows, updates = row_total_list(spec)
  rows, updates = torch.from_numpy(rows), torch.from_numpy(updates)
  want = hbt.dense_row_totals(rows, updates, v)
  before = hbt.gsum_dense_sorted.launches
  got = [hbt.dense_row_totals(rows.to(dev), updates.to(dev), v)
         for _ in range(5)]
  assert hbt.gsum_dense_sorted.launches == before + 5
  for g in got:
    assert _same_bits(g.cpu(), want)


def shuffled_hard_list(spec, device='cpu'):
  """``(v, rows, updates)`` of a ``HARD_LISTS`` spec in a seeded order of
  its own (the hard lists are sorted; the lookups' backward takes any
  order)."""
  v, _, n, rows, g, _ = hard_list(spec)
  perm = torch.from_numpy(np.random.RandomState(n).permutation(n))
  return v, rows[perm].to(device), g[perm].to(device)


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_dense_row_totals_on_the_hard_lists(dev, spec):
  """Each hard list shuffled: 5 calls bitwise the CPU plain version."""
  v, rows, g = shuffled_hard_list(spec)
  want = hbt.dense_row_totals(rows, g, v)
  for _ in range(5):
    assert _same_bits(hbt.dense_row_totals(rows.to(dev), g.to(dev), v).cpu(),
                      want)


def _stacked_grads(device, passes=1):
  """Through a feature extractor of two stacks (dims 16 and 8) on
  ``device``: zipf ids with invalid ones, seeded gradients of the
  embeddings, ``passes`` backwards. Returns each pass's table gradients
  and the stacks."""
  rng = np.random.RandomState(9)
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'a{i}', 5000, 16))
           for i in range(3)] + [
               hbt.EmbeddingSpec(hbt.TableConfig('b', 3000, 8))]
  fx = hbt.StackedFeatureExtractor(specs, ctx=hbt.Context(device))
  tables = {k: t.requires_grad_()
            for k, t in fx.init(torch.Generator().manual_seed(0)).items()}
  batch = {}
  for s in specs:
    ids = (rng.zipf(1.2, 4096) - 1) % s.config.vocab_size
    ids[rng.rand(4096) < 0.05] = -1
    batch[s.name] = torch.from_numpy(ids.astype(np.int32)).to(device)
  raw, _, _ = fx.lookup_raw(tables, batch)
  grads = [torch.from_numpy(rng.randn(*r.shape).astype(np.float32)).to(
      device) for r in raw.values()]
  out = []
  for i in range(passes):
    got = torch.autograd.grad(list(raw.values()), list(tables.values()),
                              grads, retain_graph=i + 1 < passes)
    out.append(dict(zip(tables, got)))
  return out, fx.stacks


def test_lookup_backward_launches_kernel_4_once_a_stack(dev):
  """Backwards through the stacked lookups: one kernel-4 launch a stack
  and a backward, each table's gradient the CPU's bits, the same bits on
  every backward."""
  before = hbt.gsum_dense_sorted.launches
  got, stacks = _stacked_grads(dev, passes=3)
  assert len(stacks) == 2
  assert hbt.gsum_dense_sorted.launches == before + 3 * len(stacks)
  (want,), _ = _stacked_grads(torch.device('cpu'))
  for grads in got:
    for k, g in grads.items():
      assert _same_bits(g.cpu(), want[k]), k


def test_index_select_backward_witness(dev):
  """The witness that a repeat check can see atomics: the backward of
  ``index_select`` (an ``index_add_``) on phase 36's list, 5 times, whose
  repeats may differ (printed; equal repeats are no failure), beside the
  kernel-4 backward's, which may not."""
  v, d, rows, updates = row_total_list(PHASE36_ROW_TOTALS)
  ok = (rows >= 0) & (rows < v)
  rows_d = torch.from_numpy(np.where(ok, rows, 0)).to(dev)
  updates_d = torch.from_numpy(updates * ok[:, None]).to(dev)
  table = torch.zeros(v, d, device=dev, requires_grad=True)
  old = []
  for _ in range(5):
    (g,) = torch.autograd.grad(table.index_select(0, rows_d), table,
                               updates_d)
    old.append(g)
  differ = sum(not _same_bits(g, old[0]) for g in old[1:])
  new = [hbt.dense_row_totals(rows_d, updates_d, v) for _ in range(5)]
  print(f'index_select backward: {differ} of 4 repeats differ from the '
        'first; dense_row_totals: '
        f'{sum(not _same_bits(g, new[0]) for g in new[1:])} of 4')
  assert all(_same_bits(g, new[0]) for g in new[1:])


SPLIT_LISTS = [spec for spec in HARD_LISTS if spec[2] in (3, 16, 33)]


@pytest.mark.parametrize('spec', SPLIT_LISTS, ids=[s[0] for s in SPLIT_LISTS])
def test_split_dense_update_equals_fused_on_a_hard_list(dev, spec):
  """Each hard list of d = 3, 16 or 33 through both update paths: the
  dense totals carry the fused kernel's bits."""
  v, d, n, rows, g, table = hard_list(spec, dev)
  cfg = hbt.TableConfig('t', v, d)
  out = []
  for split in (False, True):
    t = table.clone()
    st = hbt.init_adagrad_state(t)
    hbt.sparse_adagrad_apply(t, st, rows, g, cfg, 0.05, split_dense=split)
    out.append((t, st.acc[0]))
  assert torch.equal(out[0][0], out[1][0])
  assert torch.equal(out[0][1], out[1][1])
  valid = bool(((rows >= 0) & (rows < v)).any())
  assert torch.equal(out[0][0], table) != valid


@pytest.mark.parametrize('d', [16, 33])
def test_split_dense_update_equals_fused_on_the_card(dev, d):
  vocab = 4000
  rng = np.random.RandomState(d)
  ids = torch.from_numpy(rng.randint(-3, vocab + 5, (512, 8))).to(dev)
  demb = torch.from_numpy(rng.randn(512, 8, d).astype(np.float32)).to(dev)
  cfg = hbt.TableConfig('t', vocab, d)
  table = torch.rand(vocab, d, device=dev)
  out = []
  for split in (False, True):
    t = table.clone()
    st = hbt.init_adagrad_state(t)
    hbt.sparse_adagrad_apply(t, st, ids, demb, cfg, 0.05, split_dense=split)
    out.append((t, st.acc[0]))
  assert torch.equal(out[0][0], out[1][0])
  assert torch.equal(out[0][1], out[1][1])


# Kernel 5: a copy, so bitwise.
@pytest.mark.parametrize('v,d,n,dtype,offset', [
    (1000, 16, 5000, torch.float32, 0), (100000, 128, 16384, torch.float32, 0),
    (1000, 17, 333, torch.float32, 0), (1000, 16, 777, torch.float32, 1),
    (300, 5, 1000, torch.bfloat16, 0), (300, 3, 999, torch.uint8, 1),
    (50, 8, 0, torch.float32, 0)])
def test_gather_kernel_matches_plain_version(dev, v, d, n, dtype, offset):
  """``offset`` starts the table one element into its storage, so the
  kernel cannot take 16-byte chunks."""
  gen = torch.Generator().manual_seed(v + d + n)
  flat = (torch.rand(v * d + offset, generator=gen) * 200).to(dtype).to(dev)
  table = flat[offset:].view(v, d)
  ids = torch.randint(-5, v + 11, (n,), generator=gen, dtype=torch.int32)
  before = hbt.gather_rows.launches
  for i in (ids, ids.long()):
    got = hbt.gather_rows(table, i.to(dev))
    assert got.shape == (n, d) and got.dtype == dtype
    assert torch.equal(got.cpu(), hbt.gather_rows_reference(table.cpu(), i))
  assert hbt.gather_rows.launches == before + 2


def test_gather_kernel_rejects_a_non_contiguous_table(dev):
  table = torch.zeros((16, 8), device=dev).t()
  with pytest.raises(ValueError, match='contiguous'):
    hbt.gather_rows(table, torch.zeros(2, dtype=torch.int32, device=dev))


# Kernel 6: the same Philox bits on both sides, so bitwise.
@pytest.mark.parametrize('shape,offset', [((212992, 16), 0), ((1001,), 0),
                                          ((37, 3), 1), ((5,), 0)])
def test_stochastic_round_kernel_matches_plain_version(dev, shape, offset):
  gen = torch.Generator().manual_seed(sum(shape))
  n = int(np.prod(shape))
  x = torch.randn(n + offset, generator=gen)
  x[offset:offset + 4] = torch.tensor([float('nan'), float('inf'), -0.0,
                                       3.4028235e38])[:min(4, n)]
  x = x.to(dev)[offset:].view(shape)
  state = gen.get_state()
  before = hbt.stochastic_round_bf16.launches
  got = hbt.stochastic_round_bf16(x, gen)
  assert hbt.stochastic_round_bf16.launches == before + 1
  seed = hbt.draw_seed(torch.Generator().set_state(state))
  want = hbt.stochastic_round_bf16_reference(x.cpu(), seed)
  assert got.shape == x.shape and got.dtype == torch.bfloat16
  assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def test_stochastic_round_kernel_differs_between_seeds(dev):
  x = torch.rand(4096, device=dev)
  a = hbt.stochastic_round_bf16(x, torch.Generator().manual_seed(1))
  b = hbt.stochastic_round_bf16(x, torch.Generator().manual_seed(2))
  assert not torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_stochastic_round_kernel_rejects_non_contiguous_input(dev):
  x = torch.rand((16, 8), device=dev).t()
  with pytest.raises(ValueError, match='contiguous'):
    hbt.stochastic_round_bf16(x, torch.Generator().manual_seed(0))


def test_split_dense_step_runs_the_gsum_kernel_on_the_card(dev):
  ctx = hbt.Context(dev)
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{i}', 500, 16))
           for i in range(3)]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=['i0'], ctx=ctx)
  gen = torch.Generator().manual_seed(0)
  tower = hbt.StackedDCNv2([16] * 3 + [1], [32, 1], generator=gen,
                           device=dev)
  state = hbt.SparseTrainState.create(
      tower, fx.init(gen), lambda p: torch.optim.Adam(p, lr=1e-3))

  def loss_fn(tower, emb_f, dense_f, batch):
    p = torch.clamp(tower(emb_f + dense_f), 1e-6, 1 - 1e-6)
    y = batch['label']
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {}

  step = hbt.make_sparse_train_step(fx, loss_fn, table_split_dense=True)
  rng = np.random.RandomState(0)
  batch = {f'c{i}': torch.from_numpy(
      rng.randint(-5, 520, 64).astype(np.int32)).to(dev) for i in range(3)}
  batch['i0'] = torch.rand(64, device=dev)
  batch['label'] = torch.randint(0, 2, (64,), device=dev).float()
  before = (hbt.gsum_dense_sorted.launches, hbt.adagrad_update_sorted.launches)
  for _ in range(3):
    state, m = step(state, batch)
  assert (hbt.gsum_dense_sorted.launches,
          hbt.adagrad_update_sorted.launches) == (before[0] + 3, before[1])
  assert torch.isfinite(m['loss'])


# The bf16 modes of kernels 1-3: bf16 table, slots and gradients.
@pytest.mark.parametrize('kernel', UPDATE_KERNELS)
@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_bf16_update_kernels_on_the_hard_lists(dev, spec, kernel):
  v, d, n, rows, g, table = hard_list(spec, dev, torch.bfloat16)
  state = update_state(kernel, spec, table)
  got = [t.clone() for t in state]
  counter = {'add': hbt.scatter_add_sorted,
             'adam': hbt.adam_update_sorted}.get(kernel,
                                                 hbt.adagrad_update_sorted)
  before = counter.launches
  run_update(kernel, got, rows, g)
  assert counter.launches == before + 1
  want = [t.cpu() for t in state]
  run_update(kernel, want, rows.cpu(), g.cpu())
  for x, w in zip(got, want):
    assert x.dtype == torch.bfloat16
    assert_within_an_ulp(x.cpu(), w, share=0.01)
  _assert_untouched(rows, v, list(zip(got, state)))


@pytest.mark.parametrize('kernel', ['adagrad', 'nodedup', 'adam'])
@pytest.mark.parametrize('name', ['random-d4', 'boundary-d16', 'long-d16'])
def test_bf16_update_kernels_take_state_one_element_into_its_storage(
    dev, name, kernel):
  """bf16 table and slots start 2 bytes into their storage: scalar
  lanes, while the gradients are still staged (d = 16) or read in 8-byte
  lanes (d = 4)."""
  spec = HARD_LISTS[HARD_LIST_IDS.index(name)]
  v, d, n, rows, g, table = hard_list(spec, dev, torch.bfloat16)
  state = update_state(kernel, spec, table)
  shifted = [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(v, d)
             for t in state]
  want = [t.cpu() for t in state]
  run_update(kernel, shifted, rows, g)
  run_update(kernel, want, rows.cpu(), g.cpu())
  for x, w in zip(shifted, want):
    assert_within_an_ulp(x.cpu(), w, share=0.01)
  _assert_untouched(rows, v, list(zip(shifted, state)))


@pytest.mark.parametrize('kernel', UPDATE_KERNELS)
def test_bf16_update_kernels_take_a_row_too_wide_to_stage(dev, kernel):
  """120000 bf16 a row: a tile of 16 entries exceeds shared memory, so
  the kernel reads the gradients from global memory."""
  v, d, n = 7, 120000, 40
  gen = torch.Generator().manual_seed(d)
  rows = torch.randint(-1, v + 2, (n,), generator=gen,
                       dtype=torch.int32).sort().values
  g = torch.randn(n, d, generator=gen).bfloat16()
  state = [torch.rand(v, d, generator=gen).bfloat16() for _ in range(3)]
  state = state[:{'add': 1, 'adam': 3}.get(kernel, 2)]
  got = [t.to(dev, copy=True) for t in state]
  run_update(kernel, got, rows.to(dev), g.to(dev))
  run_update(kernel, state, rows, g)
  for x, w in zip(got, state):
    assert_within_an_ulp(x.cpu(), w, share=0.01)


def flagship_list(seed=0):
  """The update list of one flagship step (``chip_smoke.py``): 26 tables
  of 100000 rows stacked, batch 8192, plus 1000 ``-1`` and 1000 ``>= V``
  ids, sorted, with N(0, 0.01) gradients; ``(v, rows, grads)`` on the
  CPU."""
  rng = np.random.RandomState(seed)
  tables, vocab, batch, d = 26, 100_000, 8192, 16
  ids = np.stack([rng.randint(0, vocab, batch) + t * vocab
                  for t in range(tables)], axis=1).reshape(-1)
  v, n = tables * vocab, ids.shape[0]
  ids[rng.choice(n, 1000, replace=False)] = -1
  ids[rng.choice(n, 1000, replace=False)] = v + rng.randint(0, 5000, 1000)
  rows, order = torch.sort(torch.from_numpy(ids.astype(np.int32)),
                           stable=True)
  g = torch.from_numpy((rng.randn(n, d) * 0.01).astype(np.float32))
  return v, rows, g.index_select(0, order)


@pytest.mark.parametrize('kernel', UPDATE_KERNELS)
def test_bf16_update_kernels_at_the_flagship_list(dev, kernel):
  v, rows, g = flagship_list()
  gen = torch.Generator().manual_seed(1)
  table = (torch.rand(v, 16, generator=gen) * 0.5 - 0.25).bfloat16()
  state = [table]
  if kernel == 'adam':
    state += [(torch.randn(v, 16, generator=gen) * 1e-3).bfloat16(),
              (torch.rand(v, 16, generator=gen) * 1e-4).bfloat16()]
  elif kernel != 'add':
    state.append(torch.full_like(table, 0.1))
  g = g.bfloat16()
  got = [t.to(dev, copy=True) for t in state]
  run_update(kernel, got, rows.to(dev), g.to(dev))
  want = [t.clone() for t in state]
  run_update(kernel, want, rows, g)
  for x, w in zip(got, want):
    assert_within_an_ulp(x.cpu(), w, share=0.01)
  _assert_untouched(rows, v, [(x.cpu(), t) for x, t in zip(got, state)])


def test_device_iterator_stages_exact_batches(dev):
  """Each batch equals its source bit for bit. Before each batch is read
  the consumer's stream is held about a millisecond by a spin kernel,
  and the batch before is dropped: a read that did not wait for its copy,
  or a buffer handed to the next copy while the held stream had still to
  read it, would show."""
  rng = np.random.RandomState(0)
  batches = [{'ids': rng.randint(0, 1 << 40, (4096, 26)),
              'x': rng.rand(4096).astype(np.float32),
              'label': rng.randint(0, 2, 4096).astype(np.float32),
              'mask': rng.rand(4096, 3) < 0.5} for _ in range(40)]
  got = []
  for batch in hbt.DeviceIterator(iter(batches), dev, capacity=2):
    torch.cuda._sleep(2_000_000)
    got.append({k: v.clone() for k, v in batch.items()})
  assert len(got) == len(batches)
  for g, b in zip(got, batches):
    for k, v in b.items():
      assert g[k].device == dev and g[k].shape == v.shape
      np.testing.assert_array_equal(g[k].cpu().numpy(), v)


def test_native_reader_batches_arrive_exactly_on_the_card(dev, tmp_path):
  """Zero-copy batches of the native Parquet reader (read-only views that
  a token keeps alive) through ``DeviceIterator`` and ``put_batch``: each
  column on the card equals the file's rows bit for bit, with no warning,
  also after the reader and its batches are dropped while the consumer's
  stream is held by a spin kernel."""
  import gc
  import warnings

  import pyarrow as pa
  import pyarrow.parquet as pq
  rng = np.random.RandomState(0)
  n = 5000
  cols = {'ids': rng.randint(0, 1 << 30, n).astype(np.int32),
          'big': rng.randint(0, 1 << 40, n),
          'x': rng.rand(n).astype(np.float32),
          'label': rng.randint(0, 2, n)}
  path = str(tmp_path / 'f.parquet')
  pq.write_table(pa.table(cols), path, row_group_size=1024)
  for prefetch in (True, False):
    ds = hbt.ParquetDataset(path, batch_size=512, drop_remainder=True,
                            native=True)
    it = iter(ds)
    assert it.reader == 'native'
    with warnings.catch_warnings():
      warnings.simplefilter('error')
      if prefetch:
        got = []
        for batch in hbt.DeviceIterator(it, dev, capacity=2):
          torch.cuda._sleep(2_000_000)
          got.append({k: v.clone() for k, v in batch.items()})
      else:
        got = [hbt.put_batch(b, dev) for b in it]
    del it, ds
    gc.collect()
    assert len(got) == n // 512
    for i, g in enumerate(got):
      for k, v in cols.items():
        assert g[k].device == dev
        np.testing.assert_array_equal(g[k].cpu().numpy(),
                                      v[i * 512:(i + 1) * 512])


# The serving path: kernel 5 through its op. A lookup copies rows and
# masks, and the int8 lookup multiplies each element once, so bitwise.
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, 'int8'])
def test_serving_lookups_match_the_cpu(dev, dtype):
  cfg = hbt.TableConfig('t', 3000, 16)
  table = (torch.randn(3000, 16, generator=torch.Generator().manual_seed(0))
           * 3)
  ids = torch.randint(-4, 3010, (512, 26),
                      generator=torch.Generator().manual_seed(1),
                      dtype=torch.int32)
  if dtype == 'int8':
    # Quantized on the card, the same bits as on the CPU.
    on_card = hbt.quantize_table(table.to(dev))
    table, per = hbt.quantize_table(table), 2
    assert torch.equal(on_card.q.cpu(), table.q)
    assert torch.equal(on_card.scale.cpu(), table.scale)
    lookup = lambda t, i: hbt.lookup(t, i, cfg)
  else:
    table, per = table.to(dtype), 1
    on_card = table.to(dev)
    lookup = lambda t, i: hbt.lookup(t, i, cfg, serving=True)
  before = hbt.gather_rows.launches
  got = lookup(on_card, ids.to(dev))
  assert hbt.gather_rows.launches == before + per
  assert torch.equal(got.cpu(), lookup(table, ids))


# Kernel 5 as the owner's gather of a sharded int8 table: its [V, 16] int8
# rows and [V, 1] scales at every rank's ids, shifted to the shard, most
# of them outside it (below 0 or past its end), which the kernel clips.
@pytest.mark.parametrize('rank', [0, 3])
def test_gather_kernel_on_an_int8_shard(dev, rank):
  gen = torch.Generator().manual_seed(18 + rank)
  cfg = hbt.TableConfig('t', 40000, 16)
  whole = hbt.quantize_table(torch.randn(40000, 16, generator=gen) * 3)
  shard = hbt.shard_quantized(whole, cfg,
                              hbt.Context('cpu', rank=rank, world_size=4))
  ids = torch.randint(-1, 40000, (4 * 8192,), generator=gen,
                      dtype=torch.int32)
  local = ids - rank * shard.vocab
  assert bool((local < 0).any() or (local >= shard.vocab).any())
  before = hbt.gather_rows.launches
  for table in (shard.q, shard.scale.view(-1, 1)):
    got = hbt.gather_rows(table.to(dev), local.to(dev))
    assert torch.equal(got.cpu(), hbt.gather_rows_reference(table, local))
  assert hbt.gather_rows.launches == before + 2


# Kernel 5 as an owner's read of a cache's evicted rows at a world of N
# (``EmbeddingCache.rows_to_host``): 100 evicted slots of a 160-slot
# member at offset 128 of a 288-row stack, whose two shards meet at row
# 144, read by each owner at their local index ``row - lo`` (from 0 on
# rank 1's shard), from the value table and the accumulator.
@pytest.mark.parametrize('rank', [0, 1])
def test_gather_kernel_on_a_cache_shard(dev, rank):
  gen = torch.Generator().manual_seed(19 + rank)
  rows_per_shard, offset, capacity = 144, 128, 160
  lo = rank * rows_per_shard
  rows = torch.randperm(capacity, generator=gen)[:100] + offset
  local = rows[(rows >= lo) & (rows < lo + rows_per_shard)] - lo
  assert local.numel() > 0
  value = torch.randn(rows_per_shard, 16, generator=gen)
  before = hbt.gather_rows.launches
  for table in (value, value.abs() + 0.1):
    got = hbt.gather_rows(table.to(dev), local.to(dev))
    assert torch.equal(got.cpu(), table.index_select(0, local))
  assert hbt.gather_rows.launches == before + 2


def test_a_bundle_serves_on_the_card_as_on_the_cpu(dev, tmp_path):
  """One poly-batch bundle, exported on the CPU, served on the card and on
  the CPU: kernel 5 once per member lookup (twice in int8), and the
  predictions at the tower's f32 order tolerance."""
  from hybridbackend_tpu_torch.benchmarks import synthetic
  from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb
  cfg = tb.parse_args(['--sparse', '--tables', '3', '--vocab', '500',
                       '--dense-features', '2'])
  trainer = tb.sparse_trainer(cfg, torch.device('cpu'))
  example = synthetic.criteo_batches(64, 1, 500, tables=3,
                                     dense_features=2)[0]
  for dtype, per in (('float32', 3), ('int8', 6)):
    path = trainer.export_saved_model(str(tmp_path / dtype), example,
                                      table_dtype=dtype, poly_batch=True)
    served, on_cpu = hbt.Served(path), hbt.Served(path, 'cpu')
    for rows in (1, 100):
      b = synthetic.criteo_batches(rows, 1, 500, tables=3, dense_features=2,
                                   seed=rows)[0]
      before = hbt.gather_rows.launches
      got = served.predict(b)
      assert hbt.gather_rows.launches == before + per
      np.testing.assert_allclose(got, on_cpu.predict(b), **TOL)


# The module adapter's served path (``module_support.py``): its bundle looks
# every column up through kernel 5 on the member tables split out of the
# stacks, where training and ``predict`` read the stacked tables through
# ``index_select``. The module's inputs both ways are bitwise equal on the
# card; the served bundle launches kernel 5 once a column a predict and
# predicts the trainer's ``predict`` to 1e-6.
@pytest.mark.parametrize('inputs', ['concat', 'features', 'raw'])
def test_module_adapter_serves_through_kernel_5(dev, tmp_path, inputs):
  from torch import nn
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{c}', 300 + 50 * c, 8))
           for c in range(3)]
  tower = (nn.Sequential(nn.LazyLinear(16), nn.ReLU(), nn.Linear(16, 1),
                         nn.Sigmoid(), nn.Flatten(0))
           if inputs == 'concat' else _AnyInputs())
  wrapped = hbt.wraps_module(tower, specs, dense_columns=['d0'],
                             inputs=inputs, ctx=hbt.Context(dev))
  rng = np.random.RandomState(0)
  batch = {**{f'c{c}': rng.randint(-2, 420, 256).astype(np.int32)
              for c in range(3)},
           'd0': rng.rand(256).astype(np.float32),
           'label': rng.randint(0, 2, 256).astype(np.float32)}
  wrapped.compile(wrapped.init(torch.Generator().manual_seed(0), batch))
  placed = hbt.put_batch(batch, dev)
  members, served_specs = wrapped.served_tables()
  before = hbt.gather_rows.launches
  with torch.no_grad():
    served = wrapped._served_inputs(members, placed, served_specs)
    assert hbt.gather_rows.launches == before + 3
    trained = wrapped._module_inputs(wrapped.params['tables'], placed)
  assert hbt.gather_rows.launches == before + 3
  flat = lambda x: [t for t in (x.values() if isinstance(x, dict) else [x])
                    if isinstance(t, torch.Tensor)]
  for s, t in zip(served, trained):
    for a, b in zip(flat(s), flat(t)):
      assert torch.equal(a, b)
  path = wrapped.export_saved_model(str(tmp_path / 'b'), batch)
  bundle = hbt.Served(path, dev)
  before = hbt.gather_rows.launches
  got = bundle.predict(batch)
  assert hbt.gather_rows.launches == before + 3
  live = next(wrapped.predict(iter([batch]))).cpu().numpy()
  assert np.abs(got - live).max() <= 1e-6


class _AnyInputs(torch.nn.Module):
  """A tower over the 'features' or 'raw' inputs: the mean of every
  embedding and dense input, through one Linear."""

  def __init__(self):
    super().__init__()
    self.out = torch.nn.Linear(8, 1)

  def forward(self, first, second):
    parts = [v for v in first.values()] + [
        v.float() for k, v in second.items() if k == 'd0']
    x = sum(p.float().mean(-1, keepdim=True) for p in parts)
    return torch.sigmoid(self.out(x.expand(-1, 8)))[..., 0]


@pytest.mark.parametrize('sessions', [0, 4])
def test_adagrad_kernel_at_the_din_update_list(dev, sessions):
  """Kernel 1 at the DIN step's update list (the DIN harness at its
  defaults: 2048 rows of ``cand_hist`` [1 + 64] and ``user`` packed onto
  the [1100000, 32] stack, 135168 occurrences), with the candidate planted
  in its own history in 256 rows and, with sessions, ``-1`` holes where
  the mask is false, against the plain version on the CPU copy; rows the
  list does not hold stay bitwise."""
  from hybridbackend_tpu_torch.benchmarks import din_benchmark as din
  args = din.parse_args(['--sparse', '--sessions', str(sessions)])
  fx = din.extractor(args, dev)
  base, ids, _ = din.make_batch(args, dev)
  ids = ids.clone()
  ids[:256, 2] = ids[:256, 0]
  ids[256:512, 3:5] = ids[256:512, 1:2]      # a duplicate inside the row
  (stack,) = fx.stacks
  packed, _ = hbt.pack_ids(stack, {'item': ids, 'user': base['user']})
  rows, order = torch.sort(packed.reshape(-1), stable=True)
  assert rows.numel() == 2048 * 66
  assert bool((rows < 0).any()) == bool(sessions)
  v = stack.stacked.vocab_size
  gen = torch.Generator().manual_seed(0)
  g = (torch.randn(rows.numel(), 32, generator=gen) * 0.01).to(dev)[order]
  table = hbt.default_initializer(gen, (v, 32)).to(dev)
  acc = torch.full_like(table, 0.1)
  tk, ak = table.clone(), acc.clone()
  before = hbt.adagrad_update_sorted.launches
  hbt.adagrad_update_sorted(tk, ak, rows, g, 0.05)
  assert hbt.adagrad_update_sorted.launches == before + 1
  tr, ar = table.cpu(), acc.cpu()
  hbt.adagrad_update_sorted_reference(tr, ar, rows.cpu(), g.cpu(), 0.05)
  torch.testing.assert_close(ak.cpu(), ar, **TOL)
  torch.testing.assert_close(tk.cpu(), tr, **TOL)
  touched = torch.zeros(v, dtype=torch.bool, device=dev)
  touched[rows[rows >= 0].long()] = True
  assert torch.equal(tk[~touched], table[~touched])
  assert torch.equal(ak[~touched], acc[~touched])


def _host_cache(device, vocab=3000, capacity=96):
  rng = np.random.RandomState(0)
  host = {'value': rng.rand(vocab, 16).astype(np.float32),
          'slot0': np.full((vocab, 16), 0.1, np.float32)}
  return hbt.EmbeddingCache(hbt.TableConfig('c0', vocab, 16), capacity,
                            host_tables=host, ctx=hbt.Context(device)), host


def test_cache_apply_on_the_card_matches_the_cpu(dev):
  card, card_host = _host_cache(dev)
  cpu, cpu_host = _host_cache(torch.device('cpu'))
  arrays = {'value': torch.zeros(200, 16, device=dev),
            'slot0': torch.zeros(200, 16, device=dev)}
  mirror = {k: v.cpu() for k, v in arrays.items()}
  rng = np.random.RandomState(1)
  before = hbt.gather_rows.launches
  for step in range(10):
    ids = rng.randint(step * 50, step * 50 + 80, 256)
    plan, plan_cpu = card.prepare_plan(ids), cpu.prepare_plan(ids)
    np.testing.assert_array_equal(plan.slots, plan_cpu.slots)
    card.apply_plan(arrays, plan, row_offset=100)
    cpu.apply_plan(mirror, plan_cpu, row_offset=100)
    for k in arrays:                  # a step's update of the rows
      arrays[k][100:] += 0.5
      mirror[k][100:] += 0.5
  assert hbt.gather_rows.launches - before == 2 * card.stats['evict_calls']
  assert card.stats['evict_calls'] > 0
  card.flush(arrays, row_offset=100)
  cpu.flush(mirror, row_offset=100)
  for k in arrays:
    assert torch.equal(arrays[k].cpu(), mirror[k])
    np.testing.assert_array_equal(card_host[k], cpu_host[k])


def test_cached_trainer_on_the_card_matches_the_cpu(dev):
  from hybridbackend_tpu_torch.benchmarks import synthetic
  batches = synthetic.criteo_batches(256, 6, 3000, tables=2,
                                     dense_features=2, seed=4)
  hosts = []
  for device in (dev, torch.device('cpu')):
    cache, host = _host_cache(device, capacity=256)
    ctx = hbt.Context(device)
    fx = hbt.StackedFeatureExtractor(
        [hbt.EmbeddingSpec(cache.slot_config(), column='c0'),
         hbt.EmbeddingSpec(hbt.TableConfig('c1', 3000, 16))],
        dense_columns=['i0', 'i1'], ctx=ctx)
    gen = torch.Generator().manual_seed(0)
    tables = fx.init(gen)
    tower = hbt.StackedDCNv2([16, 16, 1, 1], [32, 1], generator=gen,
                             device=device)

    def loss(t, e, d, b):
      p = torch.clamp(t(e + d), 1e-6, 1 - 1e-6)
      y = b['label']
      return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {
          'preds': p}

    tr = hbt.SparseTrainer(fx, loss, tower, tables=tables,
                           caches={'c0': cache})
    before = hbt.adagrad_update_sorted.launches
    tr.train(iter(batches), prefetch=device.type == 'cuda')
    tr._cache_runner.flush(tr.state)
    if device.type == 'cuda':
      assert hbt.adagrad_update_sorted.launches - before == len(batches)
    hosts.append(host)
  for k in hosts[0]:
    np.testing.assert_allclose(hosts[0][k], hosts[1][k], **TOL)


# Micro-batch pipelining: the interleaved sparse step's side stream, and
# the dense pipelined step.
def _interleave_parts(dev, optimizer, seed=0):
  ctx = hbt.Context(dev)
  specs = ([hbt.EmbeddingSpec(hbt.TableConfig(f'c{i}', 5000, 16))
            for i in range(3)]
           + [hbt.EmbeddingSpec(hbt.TableConfig('t3', 3000, 8))])
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=['i0'], ctx=ctx)
  gen = torch.Generator().manual_seed(seed)
  tables = fx.init(gen)
  tower = hbt.StackedDCNv2([16] * 3 + [8, 1], [64, 32, 1], generator=gen,
                           device=dev)
  state = hbt.SparseTrainState.create(
      tower, tables, lambda p: torch.optim.Adam(p, lr=1e-3),
      adam=optimizer == 'adam')

  def loss_fn(t, emb_f, dense_f, batch):
    p = torch.clamp(t(emb_f + dense_f), 1e-6, 1 - 1e-6)
    y = batch['label']
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {
        'preds': p}

  return fx, state, loss_fn


def _interleave_batches(dev, steps=3, n=4096):
  rng = np.random.RandomState(1)
  out = []
  for _ in range(steps):
    b = {f'c{i}': torch.from_numpy(rng.randint(-5, 5020, n).astype(
        np.int32)).to(dev) for i in range(3)}
    b['t3'] = torch.from_numpy(rng.randint(0, 3000, n).astype(
        np.int32)).to(dev)
    b['i0'] = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
    b['label'] = torch.from_numpy(rng.randint(0, 2, n).astype(
        np.float32)).to(dev)
    out.append(b)
  return out


@pytest.mark.parametrize('optimizer', ['adagrad', 'adam'])
def test_interleaved_side_stream_changes_no_bit(dev, monkeypatch, optimizer):
  """The interleaved step with its lookups on the side stream, bit for bit
  against the same step with every lookup on the current stream (the
  same operations in another stream order), each step queued behind a
  busy current stream so the side stream's lookups run ahead; the update
  kernel once a stack a step; and the card against the CPU."""
  from hybridbackend_tpu_torch.pipeline import interleave
  kernel = getattr(hbt, f'{optimizer}_update_sorted')
  states = {}
  for mode in ('side', 'current', 'cpu'):
    device = torch.device('cpu') if mode == 'cpu' else dev
    if mode == 'current':
      monkeypatch.setattr(interleave, '_side_stream',
                          lambda d: torch.cuda.current_stream(d))
    fx, state, loss_fn = _interleave_parts(device, optimizer)
    step = hbt.make_interleaved_train_step(fx, loss_fn, 4,
                                           table_optimizer=optimizer)
    before = kernel.launches
    for b in _interleave_batches(device):
      if device.type == 'cuda':
        torch.cuda._sleep(2_000_000)
      state, m = step(state, b)
      assert torch.isfinite(m['loss'])
    if device.type == 'cuda':
      torch.cuda.synchronize(dev)
      assert kernel.launches - before == 3 * len(fx.stacks) == 6
    states[mode] = state
  side, current, cpu = states['side'], states['current'], states['cpu']
  for name in side.tables:
    for i, (a, b, c) in enumerate(zip(
        [side.tables[name], *side.table_opt[name].acc],
        [current.tables[name], *current.table_opt[name].acc],
        [cpu.tables[name], *cpu.table_opt[name].acc])):
      assert torch.equal(a, b), name
      # Card against CPU as chip_smoke.py's phases 2 and 5 hold a step: a
      # LazyAdam table element moves by up to lr*ds/eps = 5e6*ds where a
      # gradient total ds near 0 sums in another order; its moments to
      # 1e-3 relative plus 1e-4 of the largest.
      if optimizer == 'adagrad':
        tol = dict(rtol=1e-4, atol=1e-5)
      elif i == 0:
        tol = dict(rtol=0, atol=1e-3)
      else:
        tol = dict(rtol=1e-3, atol=1e-4 * float(c.abs().max()))
      np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), err_msg=name,
                                 **tol)
  for (n, a), b in zip(side.dense.named_parameters(),
                       current.dense.parameters()):
    assert torch.equal(a, b), n


def test_pipelined_step_on_the_card_matches_the_cpu(dev):
  """3 steps of the dense pipelined step (4 micro-batches, Adagrad 0.1 on
  tables and tower) on the card against the CPU from the same weights:
  the tables' gradients sum in atomic order on the card (``index_add_``),
  about 1e-7 relative; 1e-4 holds every value after 3 steps."""
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{i}', 2000, 16))
           for i in range(3)]
  names = ['i0', 'i1']
  states = []
  for device in (dev, torch.device('cpu')):
    gen = torch.Generator().manual_seed(0)
    module = torch.nn.ModuleDict({
        'tables': hbt.init_tables(specs, gen, device),
        'net': hbt.StackedDCNv2([16] * 3 + [1, 1], [64, 1], generator=gen,
                                device=device)})

    def loss(m, b):
      emb, dense = hbt.extract_features(m['tables'], b, specs, names)
      p = torch.clamp(m['net'](emb + dense), 1e-6, 1 - 1e-6)
      y = b['label']
      return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {
          'preds': p}

    state = hbt.TrainState.create(module, hbt.Adagrad(module.parameters(),
                                                      lr=0.1))
    step = hbt.make_pipelined_train_step(loss, 4)
    rng = np.random.RandomState(2)
    for _ in range(3):
      b = {f'c{i}': torch.from_numpy(rng.randint(0, 2000, 1024).astype(
          np.int32)).to(device) for i in range(3)}
      b.update({n: torch.from_numpy(rng.rand(1024).astype(np.float32)).to(
          device) for n in names})
      b['label'] = torch.from_numpy(rng.randint(0, 2, 1024).astype(
          np.float32)).to(device)
      state, m = step(state, b)
      assert m['preds'].shape == (1024,)
    states.append(state)
  for (n, a), b in zip(states[0].params.named_parameters(),
                       states[1].params.parameters()):
    np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().numpy(),
                               rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.fixture
def nccl_world(dev, tmp_path):
  """A joined NCCL world of one rank on the card."""
  ctx = hbt.Context.join('cuda', 'nccl', rank=0, world_size=1,
                         init_method=f'file://{tmp_path}/store',
                         timeout_s=60)
  yield ctx
  ctx.leave()


def test_collectives_on_nccl_at_a_world_of_one(nccl_world):
  from hybridbackend_tpu_torch.distribute import collective
  ctx = nccl_world
  assert ctx.distributed and ctx.device.type == 'cuda'
  x = torch.arange(12, dtype=torch.float32, device=ctx.device)
  for got in (collective.allreduce(x, ctx=ctx),
              collective.allreduce(x, 'mean', ctx=ctx),
              collective.broadcast(x, ctx=ctx),
              collective.allgather(x, ctx=ctx),
              collective.alltoall(x, ctx=ctx),
              collective.reduce_scatter(x[None], ctx=ctx)):
    assert got.device == ctx.device and torch.equal(got, x)
  buckets = x.reshape(1, 4, 3)
  recv, sizes = collective.all_to_all_v(
      buckets, torch.tensor([3], dtype=torch.int32, device=ctx.device),
      ctx=ctx)
  assert torch.equal(recv, buckets) and sizes.tolist() == [3]


def test_adagrad_kernel_on_an_owner_list_from_all_to_all_v(nccl_world):
  """The owner's update of the row-sharded Adagrad: a rank's list summed
  and bucketed by owner, through ``all_to_all_v`` on NCCL, sorted and
  applied by kernel 1, against the plain version on the CPU copy of the
  received list."""
  from hybridbackend_tpu_torch.embedding import sparse_update as su
  ctx = nccl_world
  rng = np.random.RandomState(5)
  v, d, n = 4096, 16, 8192
  rows = torch.from_numpy(rng.randint(-1, v, n).astype(np.int32)).to(
      ctx.device)
  g = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(ctx.device)
  buckets = su._bucket_by_owner(*su._local_combine(rows, g), 1, v, n)
  local, grads = su._route_grads_a2a(buckets, ctx, v)
  local, grads = su._sort(local.to(torch.int32), grads)
  table = torch.from_numpy(rng.randn(v, d).astype(np.float32))
  acc = torch.full((v, d), 0.1)
  want = hbt.adagrad_update_sorted_reference(
      table.clone(), acc.clone(), local.cpu(), grads.cpu(), 0.05)
  before = hbt.adagrad_update_sorted.launches
  got = hbt.adagrad_update_sorted(table.to(ctx.device), acc.to(ctx.device),
                                  local, grads, 0.05)
  assert hbt.adagrad_update_sorted.launches == before + 1
  for a, b in zip(got, want):
    np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                               atol=1e-5)
