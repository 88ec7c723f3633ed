"""bf16 and fp16 on the wire: the port's cast collectives, the alltoall
lookup and the sparse step's gradient wire on a world of N ranks,
against the JAX package's on N devices.

The counterpart of ``collective.py``'s ``wire_dtype`` (``_with_wire_cast``,
``:85-95``), ``comm_wire_dtype`` on the alltoall lookup's returning rows
(``lookup.py:199-205``) and ``comm_gradient_wire_dtype`` on the tower's
all-reduce and the routed gradient buckets (``sparse_step.py:128-149``,
``sparse_update.py:474-477``), at N = 2 and 4 gloo CPU ranks (one launch a
world) against a sub-mesh of N of the suite's 8 virtual CPU devices:

* each collective at ``'bfloat16'`` and ``'float16'`` against JAX's
  ``psum_t``, ``pmean_t``, ``all_gather_t``, ``all_to_all_t`` and
  ``alltoallv`` under ``shard_map``. Pure movement (``allgather``,
  ``alltoall``, ``all_to_all_v``) is bitwise. Gloo sums in the wire
  dtype, one rank at a time, rounding each partial sum, where XLA's CPU
  all-reduce adds the wire values in f32 and rounds once: a sum is held
  to one ulp of the wire dtype per rank added, an ulp taken at the
  magnitude of the sum of the inputs' absolute values (a partial sum is
  no larger), ``W - 1`` of them against the f64 sum of the cast inputs
  and ``W`` against JAX (which sits half an ulp from it); and every value
  it returns is one the wire dtype holds (the sum ran there, not in
  f32). An integer payload
  and the sizes are never cast. A wire dtype other than bf16 and fp16
  (``float8_e4m3fn``, ``float64``) is refused before the call; a backend
  that refuses the wire dtype (its call raising gloo's "Invalid scalar
  type") raises and names the dtype and the backend, and its other
  failures (a timeout, a lost peer) come out as it raised them.
* the alltoall lookup at ``wire_dtype='bfloat16'`` and ``'float16'``,
  bitwise against JAX's under ``comm_wire_dtype``; the allgather
  strategy is not cast (its reduce-scatter stays at table precision),
  bitwise against JAX's f32 lookup.
* 3 sparse steps of ``test_torch_sharded_step.py``'s DCNv2 + Adagrad
  (alltoall lookup) at ``gradient_wire_dtype='bfloat16'``, and with
  ``wire_dtype='bfloat16'`` as well; and 3 raw-mode steps of
  ``test_torch_sharded_din.py``'s DIN at ``gradient_wire_dtype=
  'bfloat16'``, with the tower under SGD 0.1 on both sides, as in
  ``tests/test_wire_grad.py`` (Adam's first steps move a weight by about
  lr whatever its gradient's size, so a near-zero gradient that the wire
  flips in sign moves it the other way, outside any relative band).
  Against the same steps on the f32 wire, the bands of
  ``tests/test_wire_grad.py:216`` and ``:271`` (loss ``rtol 1e-4``,
  accumulator ``rtol 2e-2, atol 1e-6``, tower ``rtol 5e-2, atol
  1e-4``). Against JAX's steps at the same wire, at N = 2 the f32
  tolerances (the loss to ``rtol 1e-5``, tables, accumulators and tower
  to ``rtol 1e-5, atol 2e-6``: a sum of two bf16 values is rounded once
  on both sides), and at N = 4 the wire's bands, tables to ``atol
  2e-4``: there gloo's bf16 sum of four gradients may sit a bf16 ulp
  from XLA's (a DIN head bias gradient near 0.25 moved its weight by lr
  times 2e-3), the rounding the bands allow for, and an Adagrad step of
  at most lr moves by at most 2**-8 of it (4.8e-6 seen).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hybridbackend_tpu.distribute import collective as jcollective
from hybridbackend_tpu.embedding.lookup import lookup as jlookup
from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.framework.context import context_scope
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.training.sparse_step import (
    make_sparse_train_step as jax_make_sparse_train_step)

from hybridbackend_tpu_torch.distribute import collective

import test_torch_sharded_din as din
import test_torch_sharded_step as flagship
from test_torch_distribute import LAUNCH_S, jctx, launch

WIRES = ('bfloat16', 'float16')
REFUSED = 'float8_e4m3fn'
N = 8            # each rank's payload
VOCAB, DIM = 1000, 8
STATE_TOL = dict(rtol=1e-5, atol=2e-6)
# Against the f32 wire: tests/test_wire_grad.py's bands.
LOSS_BAND = dict(rtol=1e-4)
ACC_BAND = dict(rtol=2e-2, atol=1e-6)
TOWER_BAND = dict(rtol=5e-2, atol=1e-4)
TOWER_SGD = 0.1
TABLE_BAND = dict(rtol=1e-5, atol=2e-4)
# case -> (port step options, JAX options)
STEP_WIRES = {
    'f32': (dict(lookup_strategy='alltoall'), None),
    'grad': (dict(lookup_strategy='alltoall',
                  gradient_wire_dtype='bfloat16'),
             dict(comm_gradient_wire_dtype='bfloat16')),
    'both': (dict(lookup_strategy='alltoall', wire_dtype='bfloat16',
                  gradient_wire_dtype='bfloat16'),
             dict(comm_gradient_wire_dtype='bfloat16',
                  comm_wire_dtype='bfloat16')),
}
DIN_WIRES = {'f32': dict(), 'grad': dict(gradient_wire_dtype='bfloat16')}
LOOKUP_WIRES = {
    'alltoall/bfloat16': (dict(strategy='alltoall', wire_dtype='bfloat16'),
                          dict(emb_lookup_strategy='alltoall',
                               comm_wire_dtype='bfloat16')),
    'alltoall/float16': (dict(strategy='alltoall', wire_dtype='float16'),
                         dict(emb_lookup_strategy='alltoall',
                              comm_wire_dtype='float16')),
    'allgather/bfloat16': (dict(strategy='allgather', wire_dtype='bfloat16'),
                           dict(emb_lookup_strategy='allgather')),
}


def _sum_ulp(x, wire):
  """One ulp of the 16-bit ``wire`` dtype at the magnitude of the sum of
  the absolute values of ``x`` over its leading dimension."""
  mag = np.abs(x).astype(np.float64).sum(0)
  bits = 7 if wire == 'bfloat16' else 10
  return 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - bits)


def _held_by(x, wire):
  t = torch.from_numpy(np.asarray(x, np.float32))
  return bool(torch.equal(t.to(getattr(torch, wire)).float(), t))


def _sgd(state):
  """A JAX state whose tower steps by SGD."""
  return dataclasses.replace(state,
                             dense_opt=optax.sgd(TOWER_SGD).init(state.dense))


def _inputs(world):
  rng = np.random.RandomState(50 + world)
  x = (rng.randn(world, N) * 3).astype(np.float32)
  buckets = (rng.randn(world, world, 3, 4) * 3).astype(np.float32)
  sizes = rng.randint(0, 4, (world, world)).astype(np.int32)
  table = rng.randn(VOCAB, DIM).astype(np.float32)
  ids = rng.randint(-1, VOCAB + 5, (world * 16, 3)).astype(np.int32)
  return dict(x=x, buckets=buckets, sizes=sizes, table=table, ids=ids)


@pytest.fixture(scope='module', params=[2, 4])
def world(request, tmp_path_factory):
  w = request.param
  inp = _inputs(w)
  state = _sgd(flagship._jax_init(w))
  batches = flagship._batches()
  din_state = _sgd(din._jax_init(w))
  din_batches = din._batches()
  din_init = {'tables': {k: np.asarray(v) for k, v in
                         din_state.tables.items()},
              'acc': {k: np.asarray(v.acc[0])
                      for k, v in din_state.table_opt.items()},
              'dense': jax.tree.map(np.asarray, din_state.dense)}
  cases = [('wire', 'wire', dict(x=inp['x'], buckets=inp['buckets'],
                                 sizes=inp['sizes'], wires=WIRES,
                                 refused=REFUSED)),
           ('lookups', 'lookups', dict(
               name='lk', vocab=VOCAB, dim=DIM, table=inp['table'],
               ids={'block': inp['ids']},
               cases=[('block', k) for k in LOOKUP_WIRES],
               options={k: v[0] for k, v in LOOKUP_WIRES.items()}))]
  cases += [(f'step/{case}', 'steps', dict(
      tables=flagship.TABLES, dense=flagship.DENSE, widths=flagship.WIDTHS,
      mlp=flagship.MLP, min_shard_rows=flagship.MIN_SHARD_ROWS,
      init=flagship._numpy_init(state), batches=batches, options=opts,
      tower_sgd=TOWER_SGD))
            for case, (opts, _) in STEP_WIRES.items()]
  cases += [(f'din/{case}', 'din_steps', dict(
      items=din.ITEMS, users=din.USERS, dim=din.DIM, dnn=din.DNN,
      att=din.ATT, init=din_init, batches=din_batches,
      options=dict(opts, lookup_strategy='alltoall'), tower_sgd=TOWER_SGD))
            for case, opts in DIN_WIRES.items()]
  ranks = launch(w, cases, tmp_path_factory.mktemp(f'wire{w}'))
  return dict(w=w, inp=inp, state=state, batches=batches,
              din_state=din_state, din_batches=din_batches, ranks=ranks)


def _jax_collectives(w, x, wire):
  jc = jctx(w)
  axes = jc.data_axes

  def body(xl):
    v = xl[0]
    return tuple(o[None] for o in (
        jcollective.psum_t(v, axes, wire),
        jcollective.pmean_t(v, axes, wire),
        jcollective.all_gather_t(v, axes, tiled=True, wire_dtype=wire),
        jcollective.all_to_all_t(v, axes, 0, 0, tiled=True,
                                 wire_dtype=wire)))

  fn = jax.jit(jax.shard_map(body, mesh=jc.mesh, in_specs=P(axes),
                             out_specs=P(axes), check_vma=False))
  return dict(zip(('sum', 'mean', 'gather', 'a2a'),
                  (np.asarray(o) for o in fn(jnp.asarray(x)))))


@pytest.mark.timeout(LAUNCH_S + 60)
@pytest.mark.parametrize('wire', WIRES)
def test_wire_collectives_match_jax(world, wire):
  w, inp = world['w'], world['inp']
  want = _jax_collectives(w, inp['x'], wire)
  recv, rsizes = jcollective.alltoallv(
      jnp.asarray(inp['buckets']), jnp.asarray(inp['sizes']), ctx=jctx(w),
      wire_dtype=wire)
  # The f64 sum of the inputs as the wire holds them.
  cast = torch.from_numpy(inp['x']).to(getattr(torch, wire)).double()
  exact = cast.sum(0).numpy()
  ulp = _sum_ulp(cast.numpy(), wire)
  for r, res in enumerate(world['ranks']):
    got = res['wire'][wire]
    for key in ('gather', 'a2a'):
      np.testing.assert_array_equal(got[key], want[key][r], err_msg=key)
    np.testing.assert_array_equal(got['a2av'], np.asarray(recv)[r])
    np.testing.assert_array_equal(got['a2av_sizes'], np.asarray(rsizes)[r])
    assert got['ints'].dtype == np.int32
    np.testing.assert_array_equal(got['ints'], np.array(
        [100 * q + 2 * r + i for q in range(w) for i in range(2)], np.int32))
    for key, scale in (('sum', 1), ('mean', w)):
      assert _held_by(got[key], wire), key        # summed on the wire
      assert (np.abs(got[key] - want[key][r]) <= w * ulp / scale).all(), key
    assert (np.abs(got['sum'] - exact) <= (w - 1) * ulp).all()


def test_a_refused_wire_dtype_names_itself(world):
  for res in world['ranks']:
    got = res['wire']['refused']
    # A dtype that is not a 16-bit float never reaches the backend.
    for case, name in (('name', REFUSED), ('wider', 'float64')):
      assert got[case] is not None and got[case][0] == 'ValueError', got
      assert name in got[case][1], got[case]
    # The backend's refusal names the wire dtype and the backend.
    kind, msg = got['backend']
    assert kind == 'TypeError' and 'bfloat16' in msg and 'gloo' in msg, msg
    # A failure that is not about the dtype comes out as it was raised.
    assert got['timeout'] == ('DistBackendError', 'Timed out waiting 1000ms '
                              'for recv operation to complete'), got
    assert got['peer'] == ('RuntimeError', 'Connection reset by peer'), got


@pytest.mark.parametrize('name,want', [
    (None, None), ('', None), ('float32', None), (torch.float32, None),
    ('bfloat16', torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    ('float16', torch.float16), (torch.float16, torch.float16)])
def test_wire_dtype_of_takes_the_three_wires(name, want):
  assert collective.wire_dtype_of(name) is want


@pytest.mark.parametrize('name', ['float64', torch.float64, REFUSED,
                                  'int32', 'float', 'bf16'])
def test_wire_dtype_of_refuses_every_other_dtype(name):
  with pytest.raises(ValueError, match='is not one of'):
    collective.wire_dtype_of(name)


@pytest.mark.timeout(LAUNCH_S + 60)
@pytest.mark.parametrize('case', list(LOOKUP_WIRES))
def test_wire_lookup_matches_jax(world, case):
  w, inp = world['w'], world['inp']
  jc = jctx(w)
  cfg = JTableConfig('lk', VOCAB, DIM)
  with context_scope(jc), OPTIONS.override(**LOOKUP_WIRES[case][1]):
    want = np.asarray(jax.jit(lambda t, i: jlookup(t, i, cfg, ctx=jc))(
        jnp.asarray(inp['table']), jnp.asarray(inp['ids'])))
  got = np.concatenate([r['lookups'][f'block/{case}'] for r in world['ranks']])
  np.testing.assert_array_equal(got, want)
  strategy, wire = case.split('/')
  # The alltoall strategy's rows came back in the wire dtype; the
  # allgather strategy's did not.
  assert _held_by(got, wire) == (strategy == 'alltoall')


def _jax_wire_trace(w, state, batches, options, din_mode=False):
  jc = jctx(w)
  trace = []
  with context_scope(jc), OPTIONS.override(
      emb_min_shard_rows=flagship.MIN_SHARD_ROWS,
      emb_lookup_strategy='alltoall', **options):
    if din_mode:
      step = jax_make_sparse_train_step(
          din._jax_fx(jc), None, optax.sgd(TOWER_SGD), table_lr=0.05, ctx=jc,
          raw_model_loss=din._jax_raw_loss, donate_state=False)
    else:
      step = jax_make_sparse_train_step(
          flagship._jax_fx(jc), flagship._jax_model_loss, optax.sgd(TOWER_SGD),
          table_lr=0.05, ctx=jc, donate_state=False)
    for b in batches:
      state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(m['loss']), jax.tree.map(np.asarray, state)))
  return trace


def _tower(want, din_mode):
  return (din._tower_params(want.dense) if din_mode
          else flagship._tower_params(want.dense))


@pytest.mark.timeout(LAUNCH_S + 120)
@pytest.mark.parametrize('case', ['grad', 'both', 'din/grad'])
def test_wire_steps_within_the_bands(world, case):
  """The steps at the bf16 wire against the f32 wire by the JAX tests'
  bands, and against JAX's steps at the same wire."""
  w = world['w']
  din_mode = case.startswith('din/')
  mode = case.split('/')[-1]
  prefix = 'din' if din_mode else 'step'
  ranks = [r[f'{prefix}/{mode}'] for r in world['ranks']]
  f32 = [r[f'{prefix}/f32'] for r in world['ranks']]
  jax_opts = (dict(comm_gradient_wire_dtype='bfloat16') if din_mode
              else STEP_WIRES[mode][1])
  trace = _jax_wire_trace(
      w, world['din_state'] if din_mode else world['state'],
      world['din_batches'] if din_mode else world['batches'], jax_opts,
      din_mode)
  # Against JAX at the same wire: (loss, table, accumulator, tower).
  tol = ((dict(rtol=1e-5), STATE_TOL, STATE_TOL, STATE_TOL) if w == 2 else
         (LOSS_BAND, TABLE_BAND, ACC_BAND, TOWER_BAND))
  for i, (loss, want) in enumerate(trace):
    got = [r['trace'][i] for r in ranks]
    ref = f32[0]['trace'][i]
    for g in got:
      np.testing.assert_allclose(g['loss'], loss, **tol[0])
      np.testing.assert_allclose(g['loss'], ref['loss'], **LOSS_BAND)
    for name, table in want.tables.items():
      dim = got[0]['gathered'][name].shape[1]
      table = table.reshape(-1, dim)
      acc = want.table_opt[name].acc[0].reshape(-1, dim)
      vocab = got[0]['gathered'][name].shape[0]
      np.testing.assert_allclose(got[0]['gathered'][name], table[:vocab],
                                 **tol[1])
      np.testing.assert_allclose(got[0]['gathered_slots'][name][0],
                                 acc[:vocab], **tol[2])
      np.testing.assert_allclose(got[0]['gathered_slots'][name][0],
                                 ref['gathered_slots'][name][0], **ACC_BAND)
    for n, p in _tower(want, din_mode).items():
      for g in got:
        np.testing.assert_allclose(g['tower'][n], p, err_msg=n, **tol[3])
        np.testing.assert_allclose(g['tower'][n], ref['tower'][n],
                                   err_msg=n, **TOWER_BAND)
        np.testing.assert_array_equal(g['tower'][n], got[0]['tower'][n])
