"""Table gradients summed in list order, against the JAX package.

The backward of every differentiable table lookup of the port is
``ops.scatter.dense_row_totals``: a stable sort of the rows and kernel 4
(``gsum_dense_sorted``), which on the CPU runs its plain version. JAX
differentiates ``jnp.take(..., mode='fill')`` into a scatter-add, which
the CPU sums from 0.0 in list order and which drops the invalid ids.
Held here, on the CPU:

* ``dense_row_totals`` against ``np.add.at`` in float32 (list order) on
  the unsorted lists of ``test_torch_cuda.py`` and its hard update
  lists shuffled (the lists the card's kernel is held on): bit for bit,
  the sign of a zero included;
* the gradient of ``lookup`` (lane-packed and unpacked JAX tables, an
  id-mixed table, ``[B, K]`` ids) and of ``lookup_sparse`` (each
  combiner, with and without weights) against ``jax.vjp`` of the JAX
  functions with the same cotangent, on a zipf list with invalid ids:
  bit for bit (f32), but for the weighted mean and sqrtn, whose forward
  weight sums differ (see the test);
* a bf16 table: the port's gradient is the f32 list-order total rounded
  once to bf16, bit for bit; JAX adds in bf16, each add rounding to half
  a bf16 ulp of its result, so the two differ by at most ``k + 1`` bf16
  ulps of the row's largest running sum (``k`` the row's ids);
* the dense ``Trainer``'s table gradients after one step against the JAX
  ``Trainer``'s, bit for bit: SGD at lr 1 from zero tables (the tables
  after the step are the gradients' negatives, exactly) and a tower
  linear in the embeddings (``mean((x @ w) * s)``), whose gradient of
  the embeddings is one product a value in both packages, so what is
  held is the tables' sums;
* ``_local_combine`` of the row-sharded update and GAUC's per-group sums
  (against ``jax.ops.segment_sum``): list order, bit for bit;
* a bucket lane of the alltoall and hierarchical transposes takes at
  most one valid id's gradient, so its ``index_add_`` has no order;
* a world's padded draws: at 2 ranks with a vocab of 1001, every table
  drawn for a rank (``create_table``, ``init_tables``, the stacks of
  ``StackedFeatureExtractor``) is the world of one's rows, with zeros in
  the world's padding, and the next draw from the generator (the tower's)
  is the world of one's; the world of one draws what it drew before.
  That no padding row is read is held at 2 and 4 ranks in
  ``test_torch_exchanges.py`` (``row_totals``), where the ranks run.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hybridbackend_tpu.embedding.lookup import lookup as jlookup
from hybridbackend_tpu.embedding.lookup import lookup_sparse as jlookup_sparse
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.embedding.table import create_table as jcreate_table
from hybridbackend_tpu.estimator import Trainer as JTrainer
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    extract_features as jax_extract_features,
    init_tables as jax_init_tables)

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch import convert
from hybridbackend_tpu_torch import metrics as hbm
from hybridbackend_tpu_torch.distribute.partition import partition_by_fn
from hybridbackend_tpu_torch.embedding import lookup as lookup_mod
from hybridbackend_tpu_torch.embedding import sparse_update as su
from test_torch_cuda import (
    HARD_LIST_IDS, HARD_LISTS, ROW_TOTAL_IDS, ROW_TOTAL_LISTS, row_total_list,
    shuffled_hard_list)

CPU = torch.device('cpu')
V, D, B, K = 300, 16, 64, 5


def _bits(a):
  """The float32 bits of ``a``: equal bits, not equal values (``-0.0``
  and ``0.0`` differ)."""
  return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _same_bits(got, want, msg=''):
  np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _list_order(rows, updates, vocab):
  """Float32 sums from 0.0 in list order (``np.add.at`` adds each entry
  in turn), invalid rows dropped."""
  out = np.zeros((vocab, updates.shape[1]), np.float32)
  ok = (rows >= 0) & (rows < vocab)
  np.add.at(out, rows[ok], updates[ok])
  return out


def _jctx():
  return JContext(build_mesh(devices=jax.devices()[:1]))


def _zipf_ids(rng, shape, vocab):
  """Zipf ids over ``vocab`` with about 5% ``-1`` and 5% ``>= vocab``
  (``vocab`` itself among them, the first row a world pads with)."""
  ids = rng.permutation(vocab)[(rng.zipf(1.3, shape) - 1) % vocab]
  ids[rng.rand(*shape) < 0.05] = -1
  ids[rng.rand(*shape) < 0.05] = vocab + rng.randint(0, 3)
  return ids.astype(np.int32)


# -- dense_row_totals ----------------------------------------------------------

@pytest.mark.parametrize('spec', ROW_TOTAL_LISTS, ids=ROW_TOTAL_IDS)
def test_dense_row_totals_is_the_list_order_sum(spec):
  v, d, rows, updates = row_total_list(spec)
  got = hbt.dense_row_totals(torch.from_numpy(rows),
                             torch.from_numpy(updates), v)
  assert got.dtype == torch.float32 and got.shape == (v, d)
  _same_bits(got.numpy(), _list_order(rows, updates, v), spec[0])


@pytest.mark.parametrize('spec', HARD_LISTS, ids=HARD_LIST_IDS)
def test_dense_row_totals_on_the_hard_lists(spec):
  """The update kernels' hard lists (runs across and longer than a tile,
  cancelling runs, invalid rows), shuffled."""
  v, rows, g = shuffled_hard_list(spec)
  got = hbt.dense_row_totals(rows, g, v)
  _same_bits(got.numpy(), _list_order(rows.numpy(), g.numpy(), v), spec[0])


def test_dense_row_totals_skips_what_lies_outside_the_vocab():
  """int64 rows past int32 and below -1 are skipped, none wraps into the
  table; a malformed list raises."""
  rows = torch.tensor([2**32 + 1, -7, 1, 2**31, 1, 3], dtype=torch.int64)
  updates = torch.arange(12, dtype=torch.float32).reshape(6, 2)
  got = hbt.dense_row_totals(rows, updates, 4)
  want = torch.zeros(4, 2)
  want[1] = updates[2] + updates[4]
  want[3] = updates[5]
  assert torch.equal(got, want)
  with pytest.raises(ValueError):
    hbt.dense_row_totals(rows[:5], updates, 4)


# -- the lookups' gradients against JAX ---------------------------------------

def _jax_table_grad(cfg, table, fn, ct, jc, pack):
  """``jax.vjp`` of ``fn(physical table)`` at the cotangent ``ct``, as the
  logical ``[vocab, d]`` gradient; the JAX table is made by
  ``create_table`` (lane-packed in a one-device context unless ``pack``
  is off) and holds ``table``'s rows."""
  with context_scope(jc), OPTIONS.override(emb_lane_pack=pack):
    shape = jcreate_table(cfg, jax.random.PRNGKey(0), jc).shape
    full = np.zeros((shape[0] * shape[1] // cfg.dim, cfg.dim), np.float32)
    full[:table.shape[0]] = table
    phys = jnp.asarray(full.reshape(shape), cfg.dtype)
    _, vjp = jax.vjp(fn, phys)
    (g,) = vjp(jnp.asarray(ct, cfg.dtype))
  return np.asarray(g.astype(jnp.float32)).reshape(-1, cfg.dim)


def _port_table_grad(table, fn, ct, dtype=torch.float32):
  t = torch.from_numpy(table).to(dtype).requires_grad_()
  fn(t).backward(torch.from_numpy(ct).to(dtype))
  return t.grad.float().numpy()


# case -> (TableConfig keywords, JAX emb_lane_pack, ids shape)
LOOKUP_CASES = {'packed': ({}, 'auto', (B * K,)),
                'unpacked': ({}, 'off', (B * K,)),
                'mixed': ({'shuffle_ids': True}, 'auto', (B * K,)),
                'stacked-2d': ({}, 'auto', (B, K))}


@pytest.mark.parametrize('case', sorted(LOOKUP_CASES))
def test_lookup_gradient_matches_jax(case):
  kw, pack, shape = LOOKUP_CASES[case]
  rng = np.random.RandomState(3)
  cfg = hbt.TableConfig('t', V, D, **kw)
  jcfg = JTableConfig('t', V, D, **kw)
  rows = cfg.padded_vocab()
  table = rng.randn(rows, D).astype(np.float32)
  ids = _zipf_ids(rng, shape, V)
  ct = rng.randn(*shape, D).astype(np.float32)
  jc = _jctx()
  want = _jax_table_grad(
      jcfg, table, lambda t: jlookup(t, jnp.asarray(ids), jcfg, ctx=jc), ct,
      jc, pack)
  got = _port_table_grad(
      table, lambda t: hbt.lookup(t, torch.from_numpy(ids), cfg), ct)
  _same_bits(got, want[:rows], case)
  assert np.any(got != 0)


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('combiner', ['sum', 'mean', 'sqrtn'])
def test_lookup_sparse_gradient_matches_jax(combiner, weighted, monkeypatch):
  """Bit for bit against JAX, but for the weighted mean and sqrtn: their
  denominator is a sum of ``K`` float weights, which XLA and torch reduce
  in other orders (a forward difference, held to ``rtol = 1e-6, atol =
  1e-7`` in ``test_torch_trainer.py``), and it scales each id's gradient.
  There each id's gradient is a few ulps from JAX's, and the table's
  gradient is held within 8 ulps of the sum of its terms' magnitudes.
  Every case is
  held bit for bit to the list-order sums of the gradients that reached
  the lookup."""
  rng = np.random.RandomState(4)
  cfg, jcfg = hbt.TableConfig('t', V, D), JTableConfig('t', V, D)
  table = rng.randn(V, D).astype(np.float32)
  ids = _zipf_ids(rng, (B, K), V)
  mask = rng.rand(B, K) < 0.7
  weights = rng.rand(B, K).astype(np.float32) if weighted else None
  ct = rng.randn(B, D).astype(np.float32)
  jc = _jctx()

  def jfn(t):
    return jlookup_sparse(
        t, jnp.asarray(ids), jnp.asarray(mask), jcfg,
        None if weights is None else jnp.asarray(weights), combiner, ctx=jc)

  seen = []

  def spy(*args, _lookup=lookup_mod.lookup, **kw):
    out = _lookup(*args, **kw)
    out.register_hook(seen.append)
    return out

  monkeypatch.setattr(lookup_mod, 'lookup', spy)

  def tfn(t):
    return hbt.lookup_sparse(
        t, torch.from_numpy(ids), torch.from_numpy(mask), cfg,
        None if weights is None else torch.from_numpy(weights), combiner)

  want = _jax_table_grad(jcfg, table, jfn, ct, jc, 'auto')[:V]
  got = _port_table_grad(table, tfn, ct)
  (demb,) = seen
  _same_bits(got, _list_order(ids.reshape(-1),
                              demb.reshape(-1, D).numpy(), V))
  if weighted and combiner != 'sum':
    # Each id's gradient is within a few f32 ulps of JAX's; a row's total
    # within 8 ulps of the sum of its terms' magnitudes.
    scale = _list_order(ids.reshape(-1), demb.abs().reshape(-1, D).numpy(),
                        V)
    assert np.all(np.abs(got - want) <= 2.0**-20 * scale)
  else:
    _same_bits(got, want)


def _bf16_ulp(x):
  """One bf16 ulp at magnitude ``x`` (normal numbers)."""
  e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
  return np.exp2(e - 7)


def test_bf16_table_gradient_is_rounded_once():
  """The port's bf16 gradient is the f32 list-order total rounded once
  to bf16, bit for bit; JAX's, summed in bf16, lies within ``k + 1``
  bf16 ulps of the row's largest running sum (``k`` the row's valid
  ids): each of its adds rounds to half an ulp of a running sum."""
  rng = np.random.RandomState(5)
  cfg = hbt.TableConfig('t', V, D, dtype=torch.bfloat16)
  jcfg = JTableConfig('t', V, D, dtype=jnp.bfloat16)
  table = rng.randn(V, D).astype(np.float32)
  ids = _zipf_ids(rng, (B * K,), V)
  ct = rng.randn(B * K, D).astype(ml_dtypes.bfloat16).astype(np.float32)
  jc = _jctx()
  want = _jax_table_grad(
      jcfg, table, lambda t: jlookup(t, jnp.asarray(ids), jcfg, ctx=jc), ct,
      jc, 'auto')[:V]
  got = _port_table_grad(
      table, lambda t: hbt.lookup(t, torch.from_numpy(ids), cfg), ct,
      torch.bfloat16)
  exact = _list_order(ids, ct, V)
  _same_bits(got, exact.astype(ml_dtypes.bfloat16).astype(np.float32))
  # The band: the largest running sum of each row, in float64.
  ok = (ids >= 0) & (ids < V)
  run = np.zeros((V, D))
  top = np.zeros((V, D))
  for r, g in zip(ids[ok], ct[ok]):
    run[r] += g
    top[r] = np.maximum(top[r], np.abs(run[r]))
  k = np.bincount(ids[ok], minlength=V)[:, None]
  assert np.all(np.abs(got - want) <= (k + 1) * _bf16_ulp(top))
  assert np.any(got != want)               # JAX's bf16 adds do differ


# -- the dense Trainer's step --------------------------------------------------

TRAINER_DENSE = ['i0', 'i1']


def _trainer_batch(rng):
  b = {f'c{t}': _zipf_ids(rng, (B,), V) for t in range(2)}
  b['tags'] = _zipf_ids(rng, (B, 4), V)
  b['tags_mask'] = rng.rand(B, 4) < 0.6
  for name in TRAINER_DENSE:
    b[name] = rng.rand(B).astype(np.float32)
  b['s'] = rng.randn(B).astype(np.float32)
  b['label'] = rng.randint(0, 2, B).astype(np.float32)
  return b


def test_dense_trainer_table_gradients_match_jax():
  """One step of each package's dense ``Trainer`` (SGD at lr 1, zero
  tables, the linear tower of the module docstring): every table after
  the step, ``0.0 - gradient``, bit for bit; the port's ``.grad`` too."""
  rng = np.random.RandomState(6)
  batch = _trainer_batch(rng)
  specs = ([hbt.EmbeddingSpec(hbt.TableConfig(f'c{t}', V, D))
            for t in range(2)]
           + [hbt.EmbeddingSpec(hbt.TableConfig('tags', V, D,
                                                combiner='mean'))])
  jspecs = ([JEmbeddingSpec(JTableConfig(f'c{t}', V, D)) for t in range(2)]
            + [JEmbeddingSpec(JTableConfig('tags', V, D, combiner='mean'))])
  width = D * len(specs) + len(TRAINER_DENSE)
  w = rng.randn(width).astype(np.float32)
  ctx = _jctx()
  with context_scope(ctx):
    tables = jax_init_tables(jspecs, jax.random.PRNGKey(0), ctx)
    params = {'tables': jax.tree.map(jnp.zeros_like, tables),
              'net': {'w': jnp.asarray(w)}}
    zeros = {k: np.asarray(v) for k, v in params['tables'].items()}

    def jloss(p, b):
      emb, dense = jax_extract_features(p['tables'], b, jspecs,
                                        TRAINER_DENSE, ctx=ctx)
      logits = jnp.concatenate(emb + dense, -1) @ p['net']['w']
      return jnp.mean(logits * b['s']), {'preds': jax.nn.sigmoid(logits)}

    jtr = JTrainer(jloss, params, optax.sgd(1.0), ctx=ctx)
    jtr.train(iter([batch]))
    want = {k: np.asarray(v) for k, v in jtr.state.params['tables'].items()}
  module = nn.ModuleDict({
      'tables': hbt.init_tables(specs, torch.Generator().manual_seed(0), CPU),
      'net': nn.ParameterDict({'w': nn.Parameter(torch.from_numpy(w))})})
  with torch.no_grad():
    for s in specs:
      module['tables'][s.name].copy_(convert._logical_table(
          zeros[s.name], s.config, CPU, s.name, None))

  def loss(m, b):
    emb, dense = hbt.extract_features(m['tables'], b, specs, TRAINER_DENSE)
    logits = torch.cat(emb + dense, -1) @ m['net']['w']
    return torch.mean(logits * b['s']), {'preds': torch.sigmoid(logits)}

  tr = hbt.Trainer(loss, module, torch.optim.SGD(module.parameters(), lr=1.0),
                   ctx=hbt.Context(CPU))
  tr.train(iter([batch]))
  for s in specs:
    t = module['tables'][s.name]
    logical = want[s.name].reshape(-1, D)[:V]
    _same_bits(t.detach().numpy(), logical, s.name)
    _same_bits(np.float32(0.0) - t.grad.numpy(), logical, s.name)
    assert np.any(logical != 0)


# -- the row-sharded update's combine and GAUC ---------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_local_combine_sums_in_list_order(dtype):
  """Each distinct row's total: the f32 list-order sum, rounded once to
  the gradients' dtype."""
  _, d, rows, updates = row_total_list(ROW_TOTAL_LISTS[3])
  g = torch.from_numpy(updates).to(dtype)
  urows, gsum = su._local_combine(torch.from_numpy(rows).to(torch.int32), g)
  assert gsum.dtype == dtype
  mine = urows >= 0
  ok = urows[mine].long().numpy()
  assert np.array_equal(ok, np.unique(rows[rows >= 0]))
  sums = _list_order(rows, g.float().numpy(), int(rows.max()) + 1)
  want = torch.from_numpy(sums[ok]).to(dtype).float().numpy()
  _same_bits(gsum[mine].float().numpy(), want)


def test_gauc_group_sums_match_jax():
  rng = np.random.RandomState(7)
  n = 2000
  groups = np.sort(rng.randint(0, 150, n))
  contrib = rng.randn(n).astype(np.float32)
  want = jax.ops.segment_sum(jnp.asarray(contrib), jnp.asarray(groups),
                             num_segments=n)
  got = hbm._segment_total(torch.from_numpy(contrib),
                           torch.from_numpy(groups).long(), n)
  _same_bits(got.numpy(), np.asarray(want))


# -- the transposes' bucket lanes ----------------------------------------------

@pytest.mark.parametrize('capacity', [None, 40])
def test_bucket_lanes_take_one_gradient_each(capacity):
  """The alltoall transpose adds each id's gradient into its bucket lane
  (``partition.restore``): the valid ids kept are on distinct lanes; an
  invalid id (its gradient masked to 0.0) or one that a full bucket left
  out is one past the end, which the transpose clamps to the last
  lane."""
  rng = np.random.RandomState(8)
  ids = torch.from_numpy(_zipf_ids(rng, (256,), V)).long()
  valid = (ids >= 0) & (ids < V)
  part = partition_by_fn(ids, 4, lambda x: (x // 75).clamp(0, 3),
                         capacity=capacity, fill_value=-1, valid=valid)
  end = part.buckets.numel()
  restore = part.restore.long()
  kept = restore < end
  assert torch.equal(kept & ~valid, torch.zeros_like(kept))
  assert restore[kept].unique().numel() == int(kept.sum())
  assert bool(part.overflow) == (capacity is not None)
  if capacity is None:
    assert torch.equal(kept, valid)


# -- a world's padded draws ----------------------------------------------------

ODD = 1001          # a vocab that 2 ranks do not divide


def _worlds():
  return [hbt.Context(CPU, rank=r, world_size=2) for r in range(2)]


def _next_draw(gen):
  return torch.randint(0, 2**62, (4,), generator=gen)


def test_padded_draws_are_the_world_of_ones():
  """``create_table`` and ``init_tables`` at 2 ranks: each rank's shard
  is the world of one's rows, the padding row zeros, and the next draw
  (what a tower draws after the tables) the world of one's; the world of
  one draws ``default_initializer``'s rows as before."""
  specs = [hbt.EmbeddingSpec(hbt.TableConfig('odd', ODD, D)),
           hbt.EmbeddingSpec(hbt.TableConfig('even', 1000, D))]
  gen = torch.Generator().manual_seed(11)
  one = hbt.init_tables(specs, gen, CPU)
  after = _next_draw(gen)
  old = torch.Generator().manual_seed(11)
  for s in specs:
    assert torch.equal(one[s.name].detach(), hbt.default_initializer(
        old, (s.config.vocab_size, D)))
  for ctx in _worlds():
    gen = torch.Generator().manual_seed(11)
    world = hbt.init_tables(specs, gen, CPU, ctx)
    assert torch.equal(_next_draw(gen), after)
    for s in specs:
      rows = s.config.shard_rows(ctx)
      whole = torch.cat([one[s.name].detach(), torch.zeros(
          s.config.padded_vocab(ctx) - s.config.vocab_size, D)])
      assert torch.equal(world[s.name].detach(), whole[rows]), s.name
      assert hbt.table_shard(world[s.name]).start == rows.start
  assert hbt.TableConfig('odd', ODD, D).padded_vocab(_worlds()[0]) == ODD + 1


def test_padded_stack_draws_are_the_world_of_ones():
  """The stacks of ``StackedFeatureExtractor`` at 2 ranks: each member's
  rows are the world of one's, its padding zeros; the next draw is the
  world of one's; the world of one's stack is its members'
  ``default_initializer`` draws in member order."""
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'm{i}', v, D))
           for i, v in enumerate((ODD, 1000, 999))]
  gen = torch.Generator().manual_seed(12)
  one_fx = hbt.StackedFeatureExtractor(specs, ctx=hbt.Context(CPU))
  (one,) = one_fx.init(gen).values()
  after = _next_draw(gen)
  old = torch.Generator().manual_seed(12)
  assert torch.equal(one, torch.cat([hbt.default_initializer(
      old, (s.config.vocab_size, D)) for s in specs]))
  for ctx in _worlds():
    gen = torch.Generator().manual_seed(12)
    fx = hbt.StackedFeatureExtractor(specs, ctx=ctx)
    ((name, shard),) = fx.init(gen).items()
    assert torch.equal(_next_draw(gen), after)
    (stack,) = fx.stacks
    whole = torch.zeros(stack.stacked.padded_vocab(ctx), D)
    pos = 0
    for cfg, off in zip(stack.configs, stack.offsets):
      whole[off:off + cfg.vocab_size] = one[pos:pos + cfg.vocab_size]
      pos += cfg.vocab_size
    assert torch.equal(shard, whole[stack.stacked.shard_rows(ctx)]), name
