"""Embedding layer of the PyTorch port against the JAX package.

Row mixing, the replicated lookup, id packing for stacks and member
splitting take the same numpy inputs in both packages. All of them move
or select values without arithmetic, so they must agree exactly.
The JAX side runs in a one-device context, as the port does; there its
narrow tables are lane-packed, and ``reshape(-1, dim)`` gives the
logical table the port holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.embedding.lookup import lookup as jax_lookup
from hybridbackend_tpu.embedding import stack as jstack
from hybridbackend_tpu.embedding import table as jtable
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)

import hybridbackend_tpu_torch as hbt


@pytest.fixture
def ctx1():
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  with context_scope(ctx):
    yield ctx


def _ids(rng, n, vocab):
  ids = rng.randint(0, vocab, n).astype(np.int32)
  ids[::7] = -1
  ids[3::11] = vocab + rng.randint(0, 50, len(ids[3::11]))
  ids[5::13] = -rng.randint(2, 2**31 - 1, len(ids[5::13]))
  return ids


@pytest.mark.parametrize('vocab', [1000, 4096, 77])
def test_row_index_shuffle_matches_jax(ctx1, vocab):
  rng = np.random.RandomState(vocab)
  ids = _ids(rng, 2000, vocab)
  ids[:4] = [0, vocab - 1, 2**31 - 1, -2**31]
  jcfg = jtable.TableConfig('t', vocab, 16, shuffle_ids=True)
  tcfg = hbt.TableConfig('t', vocab, 16, shuffle_ids=True)
  assert tcfg.padded_vocab() == jcfg.padded_vocab(ctx1)
  want = np.asarray(jcfg.row_index(jnp.asarray(ids), ctx1))
  got = tcfg.row_index(torch.from_numpy(ids))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), want)
  assert (got.numpy()[ids < 0] < 0).all()


@pytest.mark.parametrize('shuffle', [False, True])
def test_lookup_invalid_ids_read_zero(ctx1, shuffle):
  vocab, dim = 1000, 16
  jcfg = jtable.TableConfig('t', vocab, dim, shuffle_ids=shuffle)
  tcfg = hbt.TableConfig('t', vocab, dim, shuffle_ids=shuffle)
  jt = jtable.create_table(jcfg, jax.random.PRNGKey(0), ctx1)
  table = torch.from_numpy(np.asarray(jt).reshape(-1, dim).copy())
  assert table.shape == (tcfg.padded_vocab(), dim)
  ids = _ids(np.random.RandomState(1), 64 * 3, vocab).reshape(64, 3)
  want = np.asarray(jax_lookup(jt, jnp.asarray(ids), jcfg, ctx=ctx1))
  got = hbt.lookup(table, torch.from_numpy(ids), tcfg)
  np.testing.assert_array_equal(got.numpy(), want)
  invalid = (ids < 0) | (ids >= vocab)
  assert invalid.any() and not got.numpy()[invalid].any()


def _configs(mod):
  return [mod.TableConfig('a', 300, 16), mod.TableConfig('b', 1000, 16),
          mod.TableConfig('c', 50, 8), mod.TableConfig('d', 200, 16),
          mod.TableConfig('s', 100, 16, shuffle_ids=True)]


def test_build_stacks_matches_jax(ctx1):
  js = jstack.build_stacks(_configs(jtable), ctx1)
  ts = hbt.build_stacks(_configs(hbt))
  assert [s.stacked.name for s in ts] == [s.stacked.name for s in js]
  for j, t in zip(js, ts):
    assert t.offsets == j.offsets
    assert t.stacked.vocab_size == j.stacked.vocab_size
    assert t.stacked.shuffle_ids == j.stacked.shuffle_ids
    # JAX rounds a lane-packed table up to whole 128-lane rows (128/dim
    # logical rows each); the port's logical table needs no such padding.
    p = 128 // t.dim
    want = -(-t.stacked.padded_vocab() // p) * p
    assert j.stacked.padded_vocab(ctx1) == want


def test_pack_and_unpack_match_jax(ctx1):
  js = jstack.build_stacks(_configs(jtable), ctx1)[0]     # a, b, d
  ts = hbt.build_stacks(_configs(hbt))[0]
  rng = np.random.RandomState(2)
  ids = {'a': _ids(rng, 32, 300),
         'b': _ids(rng, 32 * 4, 1000).reshape(32, 4),
         'd': _ids(rng, 32, 200)}
  jall, jlayout = jstack.pack_ids(js, {k: jnp.asarray(v)
                                       for k, v in ids.items()})
  tall, tlayout = hbt.pack_ids(ts, {k: torch.from_numpy(v)
                                    for k, v in ids.items()})
  assert tall.dtype == torch.int32
  np.testing.assert_array_equal(tall.numpy(), np.asarray(jall))
  assert tlayout == [(n, tuple(s), w) for n, s, w in jlayout]
  # Out-of-range member ids stay invalid in the stacked space.
  assert (tall.numpy()[:, :1][(ids['a'] < 0) | (ids['a'] >= 300)] == -1
          ).all()
  emb = rng.randn(32, tall.shape[1], 16).astype(np.float32)
  want = jstack.unpack_embeddings(js, jnp.asarray(emb), jlayout)
  got = hbt.unpack_embeddings(ts, torch.from_numpy(emb), tlayout)
  assert set(got) == set(want)
  for name in want:
    np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_member_tables_match_jax(ctx1):
  js = jstack.build_stacks(_configs(jtable), ctx1)
  ts = hbt.build_stacks(_configs(hbt))
  jtabs = jstack.create_stacked_tables(js, jax.random.PRNGKey(3), ctx1)
  for j, t in zip(js, ts):
    phys = np.asarray(jtabs[j.stacked.name])
    logical = torch.from_numpy(phys.reshape(-1, t.dim).copy())
    want = jstack.member_tables(j, jtabs[j.stacked.name], ctx1)
    got = hbt.member_tables(t, logical)
    assert set(got) == set(want)
    for name in want:
      np.testing.assert_array_equal(got[name].numpy(), want[name])


def test_create_stacked_tables_shape_and_range():
  stacks = hbt.build_stacks(_configs(hbt))
  gen = torch.Generator().manual_seed(0)
  tabs = hbt.create_stacked_tables(stacks, gen, torch.device('cpu'))
  for s in stacks:
    t = tabs[s.stacked.name]
    assert t.shape == (s.stacked.padded_vocab(), s.dim)
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert float(t.abs().max()) <= 1 / np.sqrt(s.dim)
  again = hbt.create_stacked_tables(stacks, torch.Generator().manual_seed(0),
                                    torch.device('cpu'))
  for name in tabs:
    assert torch.equal(tabs[name], again[name])


def test_pack_ids_tests_int64_ids_before_the_cast():
  """An int64 id past int32 (2**32 + 5 would wrap to 5, 2**31 to -2**31)
  is invalid in every member: it packs to -1, looks up zeros, and a
  train step moves no row because of it."""
  configs = [hbt.TableConfig(f'c{i}', 100, 4) for i in range(3)]
  fx = hbt.StackedFeatureExtractor([hbt.EmbeddingSpec(c) for c in configs],
                                   ctx=hbt.Context('cpu'))
  (stack,) = fx.stacks
  big = [2**32 + 5, 2**31, 2**32 + 99, -2**32 + 7]
  batch = {f'c{i}': torch.tensor([big[i], big[3], 7 + i, big[i + 1]],
                                 dtype=torch.int64) for i in range(3)}
  packed, _ = hbt.pack_ids(stack, batch)
  assert packed.dtype == torch.int32
  assert packed.tolist() == [[-1, -1, -1]] * 2 + [[7, 108, 209]] + [
      [-1, -1, -1]]
  tables = fx.init(torch.Generator().manual_seed(0))
  (name,) = tables
  emb, _ = fx(tables, batch)
  for e in emb:
    assert not e[[0, 1, 3]].any() and e[2].all()
  tower = hbt.StackedDCNv2([4] * 3, [8, 1],
                           generator=torch.Generator().manual_seed(1))
  state = hbt.SparseTrainState.create(
      tower, tables, lambda p: torch.optim.Adam(p, lr=1e-3))
  before = state.tables[name].clone()
  step = hbt.make_sparse_train_step(
      fx, lambda t, emb_f, dense_f, b: (t(emb_f).sum(), {}))
  step(state, batch)
  moved = (state.tables[name] != before).any(dim=1).nonzero().flatten()
  assert moved.tolist() == [7, 108, 209]
