"""DIN through the port's sparse step in raw mode, against the JAX step.

An item table of [300, 8] and a user table of [100, 8], stacked into one
(``build_stacks`` groups them by dim and dtype), a DIN tower (DNN 16-8,
attention 8-4, one profile embedding, 2 dense features), batch 32 with a
history of 6: the ``cand_hist`` column ``[B, 1 + L]`` holds the candidate
and its history, with the candidate repeated in its own history in some
rows, duplicate ids inside rows and ids at ``vocab + 7`` (which read
zeros and move no row). With sessions the history is ``[B, 2, 3]`` with
a ``[B, 2, 3]`` mask, flattened into ``cand_hist`` with ``-1`` where the
mask is false (the holes move no row). The model is ``raw_model_loss``:
it reads the members' uncombined embeddings, ``item`` as ``[B, 1 + L,
D]`` and ``user`` as ``[B, D]``. 3 steps of the JAX step in a one-device
context against 3 of the port's from the JAX state (``convert.from_jax``),
BCE loss, Adam 1e-3 on the tower, table lr 0.05:

* Adagrad, with and without attention weight normalization; no-dedup
  Adagrad; sessions; LazyAdam (JAX tables made under
  ``emb_lane_pack='off'``), all f32, ``emb_update_impl='auto'`` (the XLA
  path on the CPU);
* Adagrad with bf16 tables against the JAX step under
  ``emb_update_impl='stream'`` (the Pallas kernel in interpret mode).

Tolerances are ``test_torch_sparse_step.py``'s and, for LazyAdam and bf16,
``test_torch_sparse_step_optimizers.py``'s and ``test_torch_bf16_tables.py``'s:
the loss to ``rtol = 1e-5``; tables, slots and tower to ``rtol = 1e-5,
atol = 2e-6`` (with weight normalization, the score's bias, whose true
gradient is 0, by ``_assert_tower``'s rule); LazyAdam tables ``atol =
2e-5``; bf16 tables and slots at
most 1 bf16 ulp apart (1e-6 where a value cancels), in at most 0.5% of
the elements. The raw path's lookups equal plain lookups of the member
tables bit for bit (JAX ``tests/test_nested_ragged.py:293``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import (
    din_apply, din_init, din_session_apply)
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState,
    make_sparse_train_step as jax_make_sparse_train_step)

import hybridbackend_tpu_torch as hbt
from test_torch_cuda import assert_within_an_ulp

ITEMS, USERS, DIM, BATCH, HIST, SESSIONS, STEPS = 300, 100, 8, 32, 6, 2, 3
DNN, ATT = (16, 8), (8, 4)
STATE_TOL = dict(rtol=1e-5, atol=2e-6)
BF16 = torch.bfloat16
CPU = torch.device('cpu')

# name -> (table optimizer, dedup, sessions, weight normalization)
CASES = {
    'adagrad': ('adagrad', True, False, False),
    'adagrad-normalized': ('adagrad', True, False, True),
    'nodedup': ('adagrad', False, False, False),
    'sessions': ('adagrad', True, True, False),
    'adam': ('adam', True, False, False),
}


def batches(sessions, seed=0, steps=STEPS, rows=BATCH):
  """Seeded DIN batches: ``cand_hist`` (candidate, then history), its
  mask ``hist_mask``, ``user``, ``d0``, ``d1`` and ``label``."""
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(steps):
    item = rng.randint(0, ITEMS, rows)
    hist = rng.randint(0, ITEMS, (rows, HIST))
    hist[:4, 1] = item[:4]                   # the candidate in its history
    hist[4:8, 2:4] = hist[4:8, :1]           # duplicates inside a row
    hist[8:10, 5] = ITEMS + 7                # invalid: reads zeros
    if sessions:
      shape = (rows, SESSIONS, HIST // SESSIONS)
      mask = rng.rand(*shape) < 0.7
      mask[:, 0, 0] = True
      mask[10] = False                       # no history at all
      hist = np.where(mask.reshape(rows, -1), hist, -1)
    else:
      mask = np.arange(HIST)[None] < rng.randint(1, HIST + 1, rows)[:, None]
      mask[:4, 1] = True                     # the planted candidates count
    out.append({
        'cand_hist': np.concatenate([item[:, None], hist], 1).astype(
            np.int32),
        'hist_mask': mask,
        'user': rng.randint(0, USERS, rows).astype(np.int32),
        'd0': rng.rand(rows, 1).astype(np.float32),
        'd1': rng.rand(rows, 1).astype(np.float32),
        'label': rng.randint(0, 2, rows).astype(np.float32),
    })
  return out


def _preds(apply_din, apply_session, members, batch, sessions, normalize):
  """Both packages' DIN on the members' raw embeddings: the candidate
  first in ``item``, the history (reshaped to sessions) after it."""
  emb, mask = members['item'], batch['hist_mask']
  keys = emb[:, 1:]
  if sessions:
    keys = keys.reshape(emb.shape[0], *mask.shape[1:], emb.shape[-1])
  fn = apply_session if sessions else apply_din
  return fn(emb[:, 0], keys, mask, [members['user']],
            [batch['d0'], batch['d1']], normalize)


def _jax_run(case, batches_, dtype=jnp.float32, impl='auto', reduce='mean'):
  optimizer, dedup, sessions, normalize = CASES[case]
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  overrides = dict(emb_update_impl=impl)
  if optimizer == 'adam':
    overrides['emb_lane_pack'] = 'off'
  with context_scope(ctx), OPTIONS.override(**overrides):
    fx = JStackedFeatureExtractor(
        [JEmbeddingSpec(JTableConfig('item', ITEMS, DIM, dtype=dtype),
                        column='cand_hist'),
         JEmbeddingSpec(JTableConfig('user', USERS, DIM, dtype=dtype))],
        ctx=ctx)
    net = din_init(jax.random.PRNGKey(1), DIM, num_profile_features=1,
                   num_dense=2, dnn_hidden_units=DNN, att_hidden_size=ATT)

    def raw_loss(p, members, batch):
      preds = _preds(
          lambda *a: din_apply(p, *a[:5], att_weight_normalization=a[5]),
          lambda *a: din_session_apply(p, *a[:5],
                                       att_weight_normalization=a[5]),
          members, batch, sessions, normalize)
      preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
      y = batch['label']
      pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
      return getattr(jnp, reduce)(pel), {}

    state = JSparseTrainState.create(net, fx.init(jax.random.PRNGKey(0)),
                                     optax.adam(1e-3), adagrad_init=0.1,
                                     ctx=ctx, adam=optimizer == 'adam')
    init = jax.tree.map(np.asarray, state)
    step = jax_make_sparse_train_step(
        fx, None, optax.adam(1e-3), table_lr=0.05, ctx=ctx,
        table_dedup=dedup, table_optimizer=optimizer,
        raw_model_loss=raw_loss, donate_state=False)
    trace = []
    for b in batches_:
      state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(m['loss']), jax.tree.map(np.asarray, state)))
  return init, trace


def port_fx(dtype=torch.float32, device=CPU):
  return hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(hbt.TableConfig('item', ITEMS, DIM, dtype=dtype),
                         column='cand_hist'),
       hbt.EmbeddingSpec(hbt.TableConfig('user', USERS, DIM, dtype=dtype))],
      ctx=hbt.Context(device))


def port_raw_loss(case, reduce='mean'):
  _, _, sessions, normalize = CASES[case]

  def raw_loss(tower, members, batch):
    preds = torch.clamp(_preds(tower, tower, members, batch, sessions,
                               normalize), 1e-6, 1 - 1e-6)
    y = batch['label']
    pel = -(y * torch.log(preds) + (1 - y) * torch.log(1 - preds))
    return getattr(torch, reduce)(pel), {'preds': preds,
                                         'per_example_loss': pel}
  return raw_loss


def _port(case, init, dtype=torch.float32, reduce='mean'):
  optimizer, dedup, sessions, _ = CASES[case]
  fx = port_fx(dtype)
  tower = (hbt.DINSession if sessions else hbt.DIN)(DIM, 1, 2, DNN, ATT)
  state = hbt.from_jax(
      fx, init.tables, {k: v.acc for k, v in init.table_opt.items()},
      tower, init.dense, functools.partial(torch.optim.Adam, lr=1e-3))
  step = hbt.make_sparse_train_step(
      fx, None, table_lr=0.05, table_dedup=dedup, table_optimizer=optimizer,
      raw_model_loss=port_raw_loss(case, reduce))
  return fx, state, step


def _tensors(b):
  return {k: torch.from_numpy(v) for k, v in b.items()}


def _valid_rows(batches_):
  """The stacked rows a valid id of the batches reads."""
  rows = []
  for b in batches_:
    ids = b['cand_hist']
    rows.append(ids[(ids >= 0) & (ids < ITEMS)])
    rows.append(b['user'] + ITEMS)
  return np.unique(np.concatenate(rows))


def _assert_tower(state, want, normalize):
  """The tower's weights at ``STATE_TOL``. With weight normalization the
  softmax does not see a constant added to every score, so the score's
  bias (the attention MLP's last bias) has a true gradient of 0: both
  packages compute rounding noise for it (Adam's first moment under 1e-9
  on both sides), which Adam's first steps scale up to about lr each, of
  either sign. That bias is held to ``STEPS * 2.2 * lr`` instead."""
  bias = state.dense.attention.mlp.layers[-1].b
  for p, w in hbt.convert._pairs(state.dense, want.dense):
    if normalize and p is bias:
      moment = state.dense_opt.state[p]['exp_avg']
      assert float(moment.abs().max()) < 1e-9
      assert float((p.detach() - w).abs().max()) <= STEPS * 2.2 * 1e-3
      continue
    np.testing.assert_allclose(p.detach().numpy(), w.numpy(), **STATE_TOL)


@pytest.fixture(autouse=True)
def one_thread():
  """One CPU thread, as in ``test_torch_sparse_step.py``."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.mark.parametrize('case', list(CASES))
def test_raw_step_matches_jax(case):
  optimizer, _, sessions, normalize = CASES[case]
  data = batches(sessions)
  init, trace = _jax_run(case, data)
  fx, state, step = _port(case, init)
  (name,) = state.tables
  assert name == 'stack/item/user' and name in init.tables
  before = state.tables[name].clone()
  table_tol = dict(STATE_TOL, atol=2e-5) if optimizer == 'adam' else STATE_TOL
  for i, b in enumerate(data):
    state, metrics = step(state, _tensors(b))
    want_loss, want = trace[i]
    np.testing.assert_allclose(float(metrics['loss']), want_loss, rtol=1e-5)
    np.testing.assert_allclose(state.tables[name].numpy(),
                               want.tables[name].reshape(-1, DIM),
                               **table_tol)
    for got, w in zip(state.table_opt[name].acc, want.table_opt[name].acc):
      np.testing.assert_allclose(got.numpy(), w.reshape(-1, DIM),
                                 **STATE_TOL)
    _assert_tower(state, want, normalize)
  # Both members of the stack moved (not every row: a history key past a
  # row's mask gets no gradient); no row outside the valid ids did (the
  # -1 holes and the ids past the vocab among them).
  touched = np.zeros(before.shape[0], bool)
  touched[_valid_rows(data)] = True
  after = state.tables[name]
  assert torch.equal(after[~touched], before[~touched])
  for lo, hi in ((0, ITEMS), (ITEMS, ITEMS + USERS)):
    rows = np.flatnonzero(touched[lo:hi]) + lo
    assert (after[rows] != before[rows]).any(dim=1).float().mean() > 0.5


def test_raw_step_with_bf16_tables_matches_jax_stream():
  """bf16 tables and accumulator against the Pallas kernel's contract
  (``'stream'``); summed BCE, so that the updates move most touched bf16
  elements."""
  data = batches(False)
  init, trace = _jax_run('adagrad', data, jnp.bfloat16, 'stream', 'sum')
  _, state, step = _port('adagrad', init, BF16, 'sum')
  (name,) = state.tables
  before = state.tables[name].clone()
  for i, b in enumerate(data):
    state, metrics = step(state, _tensors(b))
    want_loss, want = trace[i]
    np.testing.assert_allclose(float(metrics['loss']), want_loss, rtol=1e-5)
    pairs = [(state.tables[name], want.tables[name]),
             (state.table_opt[name].acc[0], want.table_opt[name].acc[0])]
    for got, w in pairs:
      assert got.dtype == BF16
      want_t = torch.from_numpy(np.asarray(w).astype(np.float32)).to(BF16)
      assert_within_an_ulp(got, want_t.reshape(-1, DIM), share=0.005)
    _assert_tower(state, want, False)
  rows = _valid_rows(data)
  moved = (state.tables[name][rows] != before[rows]).float().mean()
  assert float(moved) >= 0.5


@pytest.mark.parametrize('sessions', [False, True])
def test_raw_path_equals_plain_lookups(sessions):
  """The members' raw embeddings (one fused lookup of the stack, unpacked)
  equal plain lookups of the member tables on the batch's columns, the
  ``[B]`` user column as ``[B, D]``; DIN on either gives the same bits."""
  fx = port_fx()
  tables = fx.init(torch.Generator().manual_seed(0))
  (stack,) = fx.stacks
  members = hbt.member_tables(stack, tables[stack.stacked.name])
  b = _tensors(batches(sessions)[0])
  raw, _, layouts = fx.lookup_raw(tables, b)
  got = fx.members_from_raw(raw, layouts)
  assert got['user'].shape == (BATCH, DIM)
  assert got['item'].shape == (BATCH, b['cand_hist'].shape[1], DIM)
  cfgs = {s.name: s.config for s in fx.specs}
  want = {'item': hbt.lookup(members['item'], b['cand_hist'], cfgs['item']),
          'user': hbt.lookup(members['user'], b['user'], cfgs['user'])}
  for k in want:
    assert torch.equal(got[k], want[k])
  tower = (hbt.DINSession if sessions else hbt.DIN)(
      DIM, 1, 2, DNN, ATT, generator=torch.Generator().manual_seed(1))
  assert torch.equal(_preds(tower, tower, got, b, sessions, False),
                     _preds(tower, tower, want, b, sessions, False))


def test_a_stack_the_loss_does_not_read_stays_put():
  """A member the raw loss ignores gets a zero gradient, as in JAX:
  Adagrad leaves its rows as they were."""
  fx = port_fx()
  state = hbt.SparseTrainState.create(
      hbt.DIN(DIM, 0, 0, DNN, ATT), fx.init(torch.Generator().manual_seed(0)),
      functools.partial(torch.optim.Adam, lr=1e-3))
  (name,) = state.tables
  before = state.tables[name].clone()

  def item_only(tower, members, batch):
    emb = members['item']
    p = torch.clamp(tower(emb[:, 0], emb[:, 1:], batch['hist_mask'], []),
                    1e-6, 1 - 1e-6)
    return -torch.mean(torch.log(p)), {}

  step = hbt.make_sparse_train_step(fx, None, raw_model_loss=item_only)
  step(state, _tensors(batches(False)[0]))
  assert torch.equal(state.tables[name][ITEMS:], before[ITEMS:])
  assert not torch.equal(state.tables[name][:ITEMS], before[:ITEMS])
