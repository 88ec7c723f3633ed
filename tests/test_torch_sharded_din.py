"""The DIN sparse step in raw mode on a world of N ranks, against the JAX
package's raw step on N devices.

The shapes of ``test_torch_din_step.py``: an item table of [300, 8] and a
user table of [100, 8] in one stack, row-sharded over the world; a DIN
tower (DNN 16-8, attention 8-4, the user embedding as its one profile
feature, 2 dense features); a global batch of 32 with a history of 6,
whose ``cand_hist`` column ``[B, 1 + L]`` holds the candidate and its
history with ``-1`` where the history's mask is false (the holes read
zeros and move no row), the candidate repeated in its own history in
some rows, duplicate ids inside rows and ids at ``vocab + 7``. The model
is ``raw_model_loss`` on the members' uncombined embeddings (``item`` as
``[B/W, 1 + L, D]``, ``user`` as ``[B/W, D]``: each rank unpacks its own
raw block), BCE loss with the predictions in aux, Adam 1e-3 on the
tower, Adagrad 0.05 on the stack; 3 steps at N = 2 and 4 under
``allgather`` and ``alltoall`` (the lookup and the update exchange
both). The JAX step runs on a sub-mesh of N of the suite's 8 virtual CPU
devices, its XLA update path, on the global batch; the port's ranks run
``torch_sharded_worker.py`` from the JAX state through ``from_jax``.

Tolerances, ``test_torch_din_step.py``'s: the loss (the ranks' mean) to
``rtol = 1e-5``; every rank's shard and accumulator, the gathered table
and the tower to ``rtol = 1e-5, atol = 2e-6`` (the tower's gradients and
duplicate rows are summed over the ranks in other orders); the
predictions, each rank's own rows, to the same. Rows that no valid id of
the three batches reads, those behind the holes among them, keep their
initial bits on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import context_scope
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor)
from hybridbackend_tpu.models.ranking import din_apply, din_init
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState,
    make_sparse_train_step as jax_make_sparse_train_step)

import hybridbackend_tpu_torch as hbt
from test_torch_distribute import LAUNCH_S, jctx, launch

ITEMS, USERS, DIM, BATCH, HIST, STEPS = 300, 100, 8, 32, 6, 3
DNN, ATT = (16, 8), (8, 4)
STATE_TOL = dict(rtol=1e-5, atol=2e-6)
STRATEGIES = ('allgather', 'alltoall')
STACK = 'stack/item/user'


def _batches(seed=0):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(STEPS):
    item = rng.randint(0, ITEMS, BATCH)
    hist = rng.randint(0, ITEMS, (BATCH, HIST))
    hist[:4, 1] = item[:4]                   # the candidate in its history
    hist[4:8, 2:4] = hist[4:8, :1]           # duplicates inside a row
    hist[8:10, 5] = ITEMS + 7                # invalid: reads zeros
    mask = np.arange(HIST)[None] < rng.randint(1, HIST + 1, BATCH)[:, None]
    mask[:4, 1] = True                       # the planted candidates count
    hist = np.where(mask, hist, -1)          # holes behind the mask
    out.append({
        'cand_hist': np.concatenate([item[:, None], hist], 1).astype(
            np.int32),
        'hist_mask': mask,
        'user': rng.randint(0, USERS, BATCH).astype(np.int32),
        'd0': rng.rand(BATCH, 1).astype(np.float32),
        'd1': rng.rand(BATCH, 1).astype(np.float32),
        'label': rng.randint(0, 2, BATCH).astype(np.float32),
    })
  return out


def _jax_fx(jc):
  return JStackedFeatureExtractor(
      [JEmbeddingSpec(JTableConfig('item', ITEMS, DIM), column='cand_hist'),
       JEmbeddingSpec(JTableConfig('user', USERS, DIM))], ctx=jc)


def _jax_raw_loss(p, members, batch):
  emb = members['item']
  preds = din_apply(p, emb[:, 0], emb[:, 1:], batch['hist_mask'],
                    [members['user']], [batch['d0'], batch['d1']])
  preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
  y = batch['label']
  return -jnp.mean(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds)), {
      'preds': preds}


def _jax_init(world):
  jc = jctx(world)
  with context_scope(jc):
    net = din_init(jax.random.PRNGKey(1), DIM, num_profile_features=1,
                   num_dense=2, dnn_hidden_units=DNN, att_hidden_size=ATT)
    return JSparseTrainState.create(net, _jax_fx(jc).init(
        jax.random.PRNGKey(0)), optax.adam(1e-3), adagrad_init=0.1, ctx=jc)


def _jax_trace(world, state, strategy, batches):
  jc = jctx(world)
  trace = []
  with context_scope(jc), OPTIONS.override(emb_lookup_strategy=strategy,
                                           emb_update_exchange=strategy):
    step = jax_make_sparse_train_step(
        _jax_fx(jc), None, optax.adam(1e-3), table_lr=0.05, ctx=jc,
        raw_model_loss=_jax_raw_loss, donate_state=False)
    for b in batches:
      state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(m['loss']), np.asarray(m['preds']),
                    jax.tree.map(np.asarray, state)))
  return trace


@pytest.fixture(scope='module', params=[2, 4])
def world(request, tmp_path_factory):
  w = request.param
  state = _jax_init(w)
  batches = _batches()
  init = {'tables': {k: np.asarray(v) for k, v in state.tables.items()},
          'acc': {k: np.asarray(v.acc[0])
                  for k, v in state.table_opt.items()},
          'dense': jax.tree.map(np.asarray, state.dense)}
  cases = [(strategy, 'din_steps', dict(
      items=ITEMS, users=USERS, dim=DIM, dnn=DNN, att=ATT, init=init,
      batches=batches, options=dict(lookup_strategy=strategy,
                                    update_exchange=strategy)))
           for strategy in STRATEGIES]
  ranks = launch(w, cases, tmp_path_factory.mktemp(f'din{w}'))
  return w, state, batches, ranks


def _tower_params(dense):
  tower = hbt.DIN(DIM, 1, 2, DNN, ATT)
  hbt.load_din(tower, dense)
  return {n: p.detach().numpy() for n, p in tower.named_parameters()}


def _untouched(batches):
  """The stacked rows that no valid id of the batches reads."""
  touched = np.zeros(ITEMS + USERS, bool)
  for b in batches:
    ids = b['cand_hist']
    touched[ids[(ids >= 0) & (ids < ITEMS)]] = True
    touched[b['user'] + ITEMS] = True
  return ~touched


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('strategy', STRATEGIES)
def test_sharded_din_raw_steps_match_jax(world, strategy):
  w, state, batches, ranks = world
  trace = _jax_trace(w, state, strategy, batches)
  got_ranks = [r[strategy] for r in ranks]
  untouched = _untouched(batches)
  initial = np.asarray(state.tables[STACK]).reshape(-1, DIM)
  for r in got_ranks:
    assert r['sharded'] == {STACK: True}
    # Kernel 1's wrapper once a step on every rank, no fallback.
    assert r['calls']['adagrad_update_sorted'] == STEPS, r['calls']
    assert r['fallbacks'] == dict(lookup=0, adagrad=0, sgd=0, adam=0)
  for i, (loss, preds, want) in enumerate(trace):
    got = [r['trace'][i] for r in got_ranks]
    table = want.tables[STACK].reshape(-1, DIM)
    acc = want.table_opt[STACK].acc[0].reshape(-1, DIM)
    per = BATCH // w
    for rank, g in enumerate(got):
      np.testing.assert_allclose(g['loss'], loss, rtol=1e-5,
                                 err_msg=f'step {i}')
      # The predictions are the rank's own rows of the global batch.
      np.testing.assert_allclose(g['aux']['preds'],
                                 preds[rank * per:(rank + 1) * per],
                                 **STATE_TOL)
      rows = hbt.TableConfig(STACK, ITEMS + USERS, DIM).shard_rows(
          hbt.Context('cpu', rank=rank, world_size=w))
      np.testing.assert_allclose(g['tables'][STACK], table[rows],
                                 err_msg=f'rank {rank} step {i}',
                                 **STATE_TOL)
      np.testing.assert_allclose(g['acc'][STACK], acc[rows], **STATE_TOL)
      np.testing.assert_allclose(g['gathered'][STACK], table, **STATE_TOL)
    for n, p in _tower_params(want.dense).items():
      for rank, g in enumerate(got):
        np.testing.assert_allclose(g['tower'][n], p,
                                   err_msg=f'{n} rank {rank} step {i}',
                                   **STATE_TOL)
  final = got[0]['gathered'][STACK]
  np.testing.assert_array_equal(final[untouched], initial[untouched])
  np.testing.assert_array_equal(table[untouched], initial[untouched])
