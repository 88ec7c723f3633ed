"""Node groups and the last three exchanges at a world of N, against the
JAX package on the CPU.

The port runs N gloo CPU ranks laid out in M nodes by its launcher
(``run.py --simulate N --nodes M --device cpu``), each a process of
``torch_exchanges_worker.py`` that imports no JAX; every case of a
layout goes in one launch: 1 node of 2 ranks (``1x2``), 2 nodes of 1
(``2x1``) and 2 nodes of 2 (``2x2``). The JAX package computes the same
functions on ``Mesh(devices[:N].reshape(M, N/M), ('dcn', 'ici'))``, as
``tests/test_embedding.py:381-382`` builds one, from the same numpy
inputs; its collectives run in ``shard_map`` over ``topology_axes``.

Held bit for bit (pure data movement): each topology's collectives (the
sums of integer-valued floats are exact); every lookup's embeddings: the
hierarchical exchange at bucket ratio 2.0, at 1.5 (both hops bucketed at
``2x2``), with a forced overflow that falls back (once a call, on every
rank), with bf16 rows on both hops and on an id-mixed table; ``gspmd``;
a column-sharded table; the checkpoints of a column-sharded trainer
written by 2 ranks and restored by 4, and written by 4 and restored by
one. Held within ``STATE_TOL`` (``rtol = 1e-5, atol = 2e-6``, the
sharded step's): each lookup's gradient (duplicate ids summed in other
orders); the column-sharded Adagrad (dedup, per occurrence and the split
form), LazyAdam and SGD updates (SGD: JAX routes the rows to row owners,
the port updates the slices); the sparse steps and both trainers over 3 steps,
losses to ``rtol = 1e-5`` and predictions to ``PRED_TOL``. A column
trainer's bundle, exported by 2 ranks, serves JAX's predictions.

Held bit for bit against the port's world of one (``row_totals``, in
the same launches): each exchange's embeddings and shard gradient on a
table of 1001 rows, which 2 and 4 ranks pad, with NaN in the padding
rows (see ``test_shard_gradients_are_the_world_of_ones``).
"""

import os
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from hybridbackend_tpu.distribute import collective as jcollective
from hybridbackend_tpu.embedding import sparse_update as jsparse
from hybridbackend_tpu.embedding.lookup import lookup as jlookup
from hybridbackend_tpu.embedding.stack import build_stacks as jbuild_stacks
from hybridbackend_tpu.embedding.table import (
    TableConfig as JTableConfig, create_table as jcreate_table)
from hybridbackend_tpu.estimator import SparseTrainer as JSparseTrainer
from hybridbackend_tpu.estimator import Trainer as JTrainer
from hybridbackend_tpu.framework.context import (
    Context as JContext, context_scope)
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor,
    extract_features as jax_extract_features,
    init_tables as jax_init_tables)
from hybridbackend_tpu.models.ranking import (
    stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.training.optimizer import (
    multi_optimizer as jax_multi_optimizer)
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState as JSparseTrainState,
    make_sparse_train_step as jax_make_sparse_train_step)

import hybridbackend_tpu_torch as hbt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_exchanges_worker.py')
LAUNCH_S = 150             # a launch's deadline
STATE_TOL = dict(rtol=1e-5, atol=2e-6)
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
# layout -> (ranks, nodes), in launch order: 2x2 restores 1x2's checkpoint.
LAYOUTS = {'1x2': (2, 1), '2x2': (4, 2), '2x1': (2, 2)}
TOPOLOGIES = {'all': jcollective.Topology.ALL,
              'intra': jcollective.Topology.INTRA_NODE,
              'inter': jcollective.Topology.INTER_NODE}
V, D, B, K, LR = 300, 8, 64, 3, 0.05
# name -> (name, vocab, dim, TableConfig keywords)
LOOKUP_TABLES = {'row': ('lk', V, D, {}),
                 'mixed': ('mx', V, D, {'shuffle_ids': True}),
                 'column': ('cl', V, D, {'partition': 'column'})}
# case -> (table, the port's options, the JAX options)
LOOKUP_CASES = {
    'hierarchical': ('row', dict(strategy='hierarchical'),
                     dict(emb_lookup_strategy='hierarchical')),
    'hierarchical_15': ('row', dict(strategy='hierarchical',
                                    bucket_ratio=1.5),
                        dict(emb_lookup_strategy='hierarchical',
                             emb_lookup_bucket_ratio=1.5)),
    'hierarchical_overflow': ('row', dict(strategy='hierarchical',
                                          bucket_ratio=0.01),
                              dict(emb_lookup_strategy='hierarchical',
                                   emb_lookup_bucket_ratio=0.01)),
    'hierarchical_bf16': ('row', dict(strategy='hierarchical',
                                      wire_dtype='bfloat16'),
                          dict(emb_lookup_strategy='hierarchical',
                               comm_wire_dtype='bfloat16')),
    'hierarchical_mixed': ('mixed', dict(strategy='hierarchical'),
                           dict(emb_lookup_strategy='hierarchical')),
    'gspmd': ('row', dict(strategy='gspmd'),
              dict(emb_lookup_strategy='gspmd')),
    'column': ('column', {}, {}),
}
# The shard gradients against the world of one's rows: tables of a vocab
# that 2 and 4 ranks do not divide, NaN in the rows a world pads them
# with. case -> (table, the port's options).
ROW_TOTAL_TABLES = {'row': ('od', 1001, D, {}),
                    'column': ('oc', 1001, D, {'partition': 'column'})}
ROW_TOTAL_CASES = {
    'allgather': ('row', {}),
    'gspmd': ('row', dict(strategy='gspmd')),
    'alltoall': ('row', dict(strategy='alltoall')),
    'alltoall_overflow': ('row', dict(strategy='alltoall',
                                      bucket_ratio=0.01)),
    'hierarchical': ('row', dict(strategy='hierarchical')),
    'hierarchical_overflow': ('row', dict(strategy='hierarchical',
                                          bucket_ratio=0.01)),
    'column': ('column', {}),
}
# case -> (optimizer, the port's options, JAX's keywords, the kernel the
# port calls). The split form against JAX's column Adagrad: JAX never
# splits a slice narrower than 128 lanes, and the split gives the fused
# update's values.
UPDATE_CASES = {
    'adagrad': ('adagrad', {}, {}, 'adagrad_update_sorted'),
    'adagrad_nodedup': ('adagrad', dict(dedup=False), dict(dedup=False),
                        'adagrad_update_sorted'),
    'adagrad_split': ('adagrad', dict(split_dense=True), {},
                      'gsum_dense_sorted'),
    'adam': ('adam', {}, {}, 'adam_update_sorted'),
    'sgd': ('sgd', {}, {}, 'scatter_add_sorted')}
TABLES = [('c0', 300, 8), ('c1', 301, 8), ('c2', 302, 8)]
DENSE = ['i0', 'i1']
WIDTHS = [8, 8, 8, 1, 1]
MLP = [16, 8, 1]
STEPS, BATCH = 3, 32
# case -> (the tables' partition, the port's step options, JAX's options)
STEP_CASES = {
    'column': ('column', dict(lookup_strategy='allgather'), {}),
    'hierarchical': ('row', dict(lookup_strategy='hierarchical',
                                 lookup_bucket_ratio=1.5),
                     dict(emb_lookup_strategy='hierarchical',
                          emb_lookup_bucket_ratio=1.5)),
}
# trainer case -> (layout, kind, strategy, partition of each table)
TRAINERS = {'column_sparse': ('1x2', 'sparse', 'allgather',
                              ('column',) * 3),
            'hierarchical_sparse': ('2x2', 'sparse', 'hierarchical',
                                    ('row',) * 3),
            'mixed_dense': ('2x2', 'dense', 'hierarchical',
                            ('column', 'row', 'row'))}


def jmesh(layout):
  world, nodes = LAYOUTS[layout]
  devices = np.array(jax.devices()[:world]).reshape(nodes, world // nodes)
  return JContext(Mesh(devices, ('dcn', 'ici')))


def _start(layout, cases, tmp):
  world, nodes = LAYOUTS[layout]
  with open(tmp / 'cases.pkl', 'wb') as f:
    pickle.dump(cases, f)
  env = dict(os.environ, OMP_NUM_THREADS='1')
  return subprocess.Popen(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
       str(world), '--nodes', str(nodes), '--device', 'cpu', '--timeout',
       str(LAUNCH_S - 10), '--collective-timeout', '60', WORKER,
       str(tmp / 'cases.pkl'), str(tmp)], cwd=ROOT, env=env,
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _results(proc, layout, tmp):
  try:
    stdout, stderr = proc.communicate(timeout=LAUNCH_S)
  except subprocess.TimeoutExpired:
    proc.kill()
    stdout, stderr = proc.communicate()
  assert proc.returncode == 0, (layout, proc.returncode, stdout[-3000:],
                                stderr[-3000:])
  out = []
  for rank in range(LAYOUTS[layout][0]):
    with open(tmp / f'{rank}.pkl', 'rb') as f:
      out.append(pickle.load(f))
  return out


def _jtable(t, **kw):
  name, vocab, dim, extra = t
  return JTableConfig(name, vocab, dim, **extra, **kw)


def _ids(rng, shape, vocab):
  ids = rng.randint(0, vocab, shape).astype(np.int32)
  flat = ids.reshape(-1)
  flat[rng.choice(flat.size, flat.size // 16, replace=False)] = -1
  flat[rng.choice(flat.size, flat.size // 20, replace=False)] = vocab + 7
  return ids


# -- the inputs ----------------------------------------------------------------

def _collective_inputs(layout, rng):
  world, nodes = LAYOUTS[layout]
  sizes = {'all': world, 'intra': world // nodes, 'inter': nodes}
  return dict(
      x=rng.randint(-50, 50, (world, 12)).astype(np.float32),
      buckets={k: rng.randint(-1, 500, (world, s, 3)).astype(np.int32)
               for k, s in sizes.items()},
      sizes={k: rng.randint(0, 4, (world, s)).astype(np.int32)
             for k, s in sizes.items()})


def _lookup_inputs(layout, rng):
  jc = jmesh(layout)
  arrays = {}
  for name, t in LOOKUP_TABLES.items():
    with context_scope(jc):
      rows = _jtable(t).padded_vocab(jc)
    arrays[name] = rng.randn(rows, D).astype(np.float32)
  return dict(tables=LOOKUP_TABLES, arrays=arrays,
              ids={'block': _ids(rng, (B, K), V)},
              w={'block': rng.randn(B, K, D).astype(np.float32)},
              cases={c: (t, 'block', o) for c, (t, o, _) in
                     LOOKUP_CASES.items()})


def _row_total_inputs():
  """The same ids (zipf, with -1 and ids from the vocab up, the first row
  a world pads with among them) and gradients of the embeddings for
  every layout, from a generator of their own."""
  rng = np.random.RandomState(21)
  ids = rng.permutation(1001)[(rng.zipf(1.3, (B, K)) - 1) % 1001]
  ids[rng.rand(B, K) < 0.05] = -1
  ids[rng.rand(B, K) < 0.05] = 1001 + rng.randint(0, 3)
  return dict(tables=ROW_TOTAL_TABLES,
              arrays={k: rng.randn(t[1], D).astype(np.float32)
                      for k, t in ROW_TOTAL_TABLES.items()},
              ids=ids.astype(np.int32),
              w=rng.randn(B, K, D).astype(np.float32),
              cases=ROW_TOTAL_CASES)


def _update_inputs(rng):
  table = rng.randn(V, D).astype(np.float32)
  v = rng.rand(V, D).astype(np.float32) * 0.01
  return dict(table=('up', V, D, {'partition': 'column'}), array=table,
              ids=_ids(rng, (B, K), V),
              demb=rng.randn(B, K, D).astype(np.float32) * 0.1, lr=LR,
              slots={'adagrad': [np.full_like(table, 0.1) + v * 10],
                     'adam': [rng.randn(V, D).astype(np.float32) * 0.01, v],
                     'sgd': []},
              cases={c: (o, kw) for c, (o, kw, _, _) in UPDATE_CASES.items()})


def _ctr_batch(rng, rows):
  b = {}
  for name, vocab, _ in TABLES:
    b[name] = _ids(rng, rows, vocab)
  for d in DENSE:
    b[d] = rng.rand(rows).astype(np.float32)
  b['label'] = rng.randint(0, 2, rows).astype(np.float32)
  return b


def _specs(partitions, spec_cls=JEmbeddingSpec, config=JTableConfig):
  return [spec_cls(config(*t, partition=p))
          for t, p in zip(TABLES, partitions)]


def _table_spec(partitions):
  return [(*t, {'partition': p}) for t, p in zip(TABLES, partitions)]


def _jax_loss(dense, emb_f, dense_f, batch):
  p = jnp.clip(stacked_dcn_v2_apply(dense, emb_f + dense_f), 1e-6, 1 - 1e-6)
  y = batch['label']
  return -jnp.mean(y * jnp.log(p) + (1 - y) * jnp.log(1 - p)), {}


def _jbce(p, y):
  p = jnp.clip(p, 1e-6, 1 - 1e-6)
  pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
  return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}


def _np(tree):
  return jax.tree.map(np.asarray, tree)


def _step_init(jc, partition):
  with context_scope(jc):
    fx = JStackedFeatureExtractor(_specs((partition,) * 3),
                                  dense_columns=DENSE, ctx=jc)
    state = JSparseTrainState.create(
        stacked_dcn_v2_init(jax.random.PRNGKey(1), WIDTHS, MLP),
        fx.init(jax.random.PRNGKey(0)), optax.adam(1e-3), adagrad_init=0.1,
        ctx=jc)
  return fx, state


def _sparse_init(state):
  return {'tables': {k: np.asarray(v) for k, v in state.tables.items()},
          'acc': {k: np.asarray(v.acc[0]) for k, v in state.table_opt.items()},
          'dense': _np(state.dense)}


def _jax_trainer(case, jc):
  _, kind, _, partitions = TRAINERS[case]
  with context_scope(jc):
    if kind == 'sparse':
      fx = JStackedFeatureExtractor(_specs(partitions), dense_columns=DENSE,
                                    ctx=jc)
      return JSparseTrainer(
          fx, lambda p, e, d, b: _jbce(stacked_dcn_v2_apply(p, e + d),
                                       b['label']),
          stacked_dcn_v2_init(jax.random.PRNGKey(1), WIDTHS, MLP),
          dense_optimizer=optax.adam(1e-3), table_lr=0.05, adagrad_init=0.1,
          ctx=jc, rng=jax.random.PRNGKey(0))
    specs = _specs(partitions)
    params = {'tables': jax_init_tables(specs, jax.random.PRNGKey(0), jc),
              'net': stacked_dcn_v2_init(jax.random.PRNGKey(1), WIDTHS, MLP)}

    def loss(p, b):
      emb, dense = jax_extract_features(p['tables'], b, specs, DENSE, ctx=jc)
      return _jbce(stacked_dcn_v2_apply(p['net'], emb + dense), b['label'])

    return JTrainer(loss, params, jax_multi_optimizer(
        optax.adagrad(0.05), optax.adam(1e-3))(params), ctx=jc)


def _trainer_spec(case, jtr, data, tmp):
  layout, kind, strategy, partitions = TRAINERS[case]
  train, evals = data
  init = _np(jtr.state)
  spec = dict(model=kind, strategy=strategy, tables=_table_spec(partitions),
              dense=DENSE, widths=WIDTHS, mlp=MLP, train=train, eval=evals)
  if kind == 'sparse':
    spec['init'] = _sparse_init(init)
  else:
    spec['init'] = {'tables': init.params['tables'],
                    'net': init.params['net']}
  if case == 'column_sparse':
    spec.update(model_dir=str(tmp / 'ckpt'), bundle=str(tmp / 'bundle'),
                example={k: v[:4] for k, v in evals.items()})
  return spec


def _jax_trainer_run(case, jtr, jc, data):
  """JAX's state after each step and its predictions of the eval
  batch."""
  _, kind, strategy, _ = TRAINERS[case]
  train, evals = data
  trace = []
  with context_scope(jc), OPTIONS.override(emb_lookup_strategy=strategy):
    for b in train:
      m = jtr.train(iter([b]))
      s = _np(jtr.state)
      if kind == 'sparse':
        state = {'tables': dict(s.tables),
                 'slots': {k: list(v.acc) for k, v in s.table_opt.items()},
                 'tower': s.dense}
      else:
        state = {'tables': dict(s.params['tables']),
                 'slots': dict(s.opt_state[0].inner_state[0]
                               .sum_of_squares['tables']),
                 'tower': s.params['net']}
      trace.append((m['loss'], state))
    preds = np.concatenate([np.asarray(p).reshape(-1) for p in
                            jtr.predict(iter([evals]))])
  return trace, preds


# -- the JAX oracles -----------------------------------------------------------

def _jax_collectives(layout, spec):
  jc = jmesh(layout)
  world_axes = jc.data_axes
  out = {}
  for name, topology in TOPOLOGIES.items():
    axes = jcollective.topology_axes(topology, jc)

    def body(x, b, s, axes=axes):
      x, b, s = x[0], b[0], s[0]
      size = jcollective.axis_size_t(axes)
      recv, rs = jcollective.all_to_all_v_t(b, s, axes)
      got = dict(
          size=jnp.asarray(size),
          sum=jcollective.psum_t(x, axes), mean=jcollective.pmean_t(x, axes),
          max=jcollective.pmax_t(x, axes),
          bcast=jcollective.broadcast_t(x, axes, root=size - 1),
          gather=jcollective.all_gather_t(x, axes, tiled=True),
          a2a=jcollective.all_to_all_t(x, axes, tiled=True),
          rs=jcollective.psum_scatter_t(x.reshape(size, -1), axes),
          a2av=recv, a2av_sizes=rs,
          gather_bf16=jcollective.all_gather_t(x / 3, axes, tiled=True,
                                               wire_dtype='bfloat16'),
          a2a_bf16=jcollective.all_to_all_t(x / 3, axes, tiled=True,
                                            wire_dtype='bfloat16'),
          sum_bf16=jcollective.psum_t(x, axes, wire_dtype='bfloat16'))
      return {k: v[None] for k, v in got.items()}

    fn = jax.jit(jax.shard_map(body, mesh=jc.mesh,
                               in_specs=(P(world_axes),) * 3,
                               out_specs=P(world_axes), check_vma=False))
    out[name] = _np(fn(jnp.asarray(spec['x']),
                       jnp.asarray(spec['buckets'][name]),
                       jnp.asarray(spec['sizes'][name])))
  return out


def _jax_lookups(layout, spec):
  jc = jmesh(layout)
  out = {}
  for case, (table, _, jopts) in LOOKUP_CASES.items():
    cfg = _jtable(LOOKUP_TABLES[table])
    ids = jnp.asarray(spec['ids']['block'])
    w = jnp.asarray(spec['w']['block'])
    with context_scope(jc), OPTIONS.override(**jopts):
      fwd = jax.jit(lambda t, i, cfg=cfg: jlookup(t, i, cfg, ctx=jc))
      grad = jax.jit(jax.grad(lambda t, cfg=cfg: jnp.sum(
          jlookup(t, ids, cfg, ctx=jc) * w)))
      t = jnp.asarray(spec['arrays'][table])
      out[case] = {'emb': np.asarray(fwd(t, ids)), 'grad': np.asarray(grad(t))}
  return out


def _jax_updates(layout, spec):
  jc = jmesh(layout)
  cfg = _jtable(spec['table'])
  ids, demb = jnp.asarray(spec['ids']), jnp.asarray(spec['demb'])
  t = jnp.asarray(spec['array'])
  out = {}
  with context_scope(jc):
    for case, (optimizer, _, kw, _) in UPDATE_CASES.items():
      slots = [jnp.asarray(a) for a in spec['slots'][optimizer]]
      if optimizer == 'sgd':
        got = [jax.jit(lambda t, i, g: jsparse.sparse_sgd_apply(
            t, i, g, cfg, LR, ctx=jc))(t, ids, demb)]
      elif optimizer == 'adam':
        t2, s2 = jax.jit(lambda t, m, v, i, g: jsparse.sparse_adam_apply(
            t, jsparse.SparseOptState(acc=(m, v)), i, g, cfg, LR, 1,
            ctx=jc))(t, *slots, ids, demb)
        got = [t2, *s2.acc]
      else:
        t2, s2 = jax.jit(lambda t, a, i, g, kw=kw: jsparse.sparse_adagrad_apply(
            t, jsparse.SparseOptState(acc=(a,)), i, g, cfg, LR, ctx=jc,
            **kw))(t, *slots, ids, demb)
        got = [t2, *s2.acc]
      out[case] = [np.asarray(a) for a in got]
  return out


def _jax_steps(layout, case, fx_state, batches):
  jc = jmesh(layout)
  fx, state = fx_state
  _, _, jopts = STEP_CASES[case]
  trace = []
  with context_scope(jc), OPTIONS.override(**jopts):
    step = jax_make_sparse_train_step(fx, _jax_loss, optax.adam(1e-3),
                                      table_lr=0.05, ctx=jc,
                                      donate_state=False)
    for b in batches:
      state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
      trace.append((float(m['loss']), _np(state)))
  return trace


# -- the launches --------------------------------------------------------------

@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """Every layout's launch, in order, each with JAX's results made while
  its ranks run."""
  rng = np.random.RandomState(17)
  step_batches = [_ctr_batch(rng, BATCH) for _ in range(STEPS)]
  trainer_data = ([_ctr_batch(rng, BATCH) for _ in range(STEPS)],
                  _ctr_batch(rng, BATCH))
  more = [_ctr_batch(rng, BATCH)]
  out = {}
  for layout in LAYOUTS:
    tmp = tmp_path_factory.mktemp(f'exchanges{layout}')
    jc = jmesh(layout)
    inputs = dict(collectives=_collective_inputs(layout, rng),
                  lookups=_lookup_inputs(layout, rng),
                  updates=_update_inputs(rng),
                  row_totals=_row_total_inputs())
    cases = [('layout', 'layout', {}),
             *((k, k, v) for k, v in inputs.items())]
    step_init = {c: _step_init(jc, p) for c, (p, _, _) in STEP_CASES.items()}
    for c, (p, opts, _) in STEP_CASES.items():
      cases.append((f'steps_{c}', 'steps', dict(
          tables=_table_spec((p,) * 3), dense=DENSE, widths=WIDTHS, mlp=MLP,
          init=_sparse_init(step_init[c][1]), batches=step_batches,
          options=opts)))
    trainers = {c: _jax_trainer(c, jc) for c, t in TRAINERS.items()
                if t[0] == layout}
    specs = {c: _trainer_spec(c, jtr, trainer_data, tmp)
             for c, jtr in trainers.items()}
    cases += [(c, 'trainer', s) for c, s in specs.items()]
    if layout == '2x2':
      two = out['1x2']['specs']['column_sparse']
      restored = dict(two, model_dir=str(tmp / 'restored'), more=more,
                      init=None)
      shutil.copytree(two['model_dir'], restored['model_dir'])
      cases.append(('restore', 'restore', restored))
      specs['restore'] = restored
    proc = _start(layout, cases, tmp)
    jax_out = dict(collectives=_jax_collectives(layout, inputs['collectives']),
                   lookups=_jax_lookups(layout, inputs['lookups']),
                   updates=_jax_updates(layout, inputs['updates']),
                   steps={c: _jax_steps(layout, c, step_init[c], step_batches)
                          for c in STEP_CASES},
                   trainers={c: _jax_trainer_run(c, jtr, jc, trainer_data)
                             for c, jtr in trainers.items()})
    ranks = _results(proc, layout, tmp)
    out[layout] = dict(inputs=inputs, jax=jax_out, ranks=ranks, specs=specs,
                       tmp=tmp, trainer_data=trainer_data)
  return out


def _same(got, want, msg=''):
  np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                err_msg=msg)


@pytest.mark.timeout(3 * LAUNCH_S + 200)
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_each_rank_knows_its_node(runs, layout):
  """The launcher's torchrun variables and the context's layout: rank
  ``r`` is local rank ``r % L`` of node ``r // L``."""
  world, nodes = LAYOUTS[layout]
  local = world // nodes
  for r, res in enumerate(runs[layout]['ranks']):
    got = res['layout']
    assert (got['rank'], got['world'], got['local_rank'], got['local_world'],
            got['node'], got['nodes']) == (r, world, r % local, local,
                                           r // local, nodes)
    assert got['env'] == {'LOCAL_RANK': str(r % local),
                          'LOCAL_WORLD_SIZE': str(local),
                          'GROUP_RANK': str(r // local)}


@pytest.mark.timeout(3 * LAUNCH_S + 200)
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('topology', sorted(TOPOLOGIES))
def test_collectives_match_jax(runs, layout, topology):
  run = runs[layout]
  want = run['jax']['collectives'][topology]
  for r, res in enumerate(run['ranks']):
    got = res['collectives'][topology]
    assert set(got) == set(want)
    for op, value in got.items():
      _same(value, want[op][r], f'{layout} {topology} {op} rank {r}')


@pytest.mark.timeout(3 * LAUNCH_S + 200)
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('case', sorted(LOOKUP_CASES))
def test_lookups_match_jax(runs, layout, case):
  """Embeddings bit for bit, shard gradients within ``STATE_TOL``; the
  forced overflow falls back once on every rank, nothing else does."""
  run = runs[layout]
  world = LAYOUTS[layout][0]
  want = run['jax']['lookups'][case]
  ranks = [r['lookups'][case] for r in run['ranks']]
  _same(np.concatenate([g['emb'] for g in ranks]), want['emb'], case)
  table = LOOKUP_CASES[case][0]
  cfg = hbt.TableConfig(*LOOKUP_TABLES[table][:3],
                        **LOOKUP_TABLES[table][3])
  for r, g in enumerate(ranks):
    ctx = hbt.Context('cpu', rank=r, world_size=world)
    np.testing.assert_allclose(
        g['grad'], want['grad'][cfg.shard_rows(ctx), cfg.shard_cols(ctx)],
        err_msg=f'{case} rank {r}', **STATE_TOL)
    assert g['fallbacks'] == int(case == 'hierarchical_overflow'), g


@pytest.mark.timeout(3 * LAUNCH_S + 200)
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('case', sorted(ROW_TOTAL_CASES))
def test_shard_gradients_are_the_world_of_ones(runs, layout, case):
  """Given one gradient of the embeddings, each exchange's shard gradient
  is the world of one's rows bit for bit, the rows the world pads the
  table with get a zero gradient, and the embeddings are the world of
  one's, so no padding row (NaN here) is read.

  Bitwise for every exchange: each owner sums its rows' gradients
  (``dense_row_totals``) in the order it holds them, rank by rank and
  each rank's ids in their order, which is the global batch's order, the
  world of one's. ``allgather`` and ``gspmd`` gather every rank's
  gradients in rank order; ``column`` returns them by the inverse
  all-to-all in rank order; ``alltoall`` buckets each rank's ids by owner
  in their order and the owner receives the buckets in rank order;
  ``hierarchical`` sends them over the node and then across the nodes,
  which at ``M`` nodes of ``L`` ranks is again rank order (rank ``r`` is
  local rank ``r % L`` of node ``r // L``). A bucket lane carries one id's
  gradient. The overflow cases fall back to the exact exchange, so they
  hold too. (Dedup before the exchange, or a bf16 wire, would not: a
  rank's duplicates are summed first, or the gradients rounded.)"""
  run = runs[layout]
  world = LAYOUTS[layout][0]
  spec = run['inputs']['row_totals']
  table = ROW_TOTAL_CASES[case][0]
  cfg = hbt.TableConfig(*ROW_TOTAL_TABLES[table][:3],
                        **ROW_TOTAL_TABLES[table][3])
  whole = torch.from_numpy(spec['arrays'][table]).requires_grad_()
  emb = hbt.lookup(whole, torch.from_numpy(spec['ids']), cfg)
  (want,) = torch.autograd.grad((emb * torch.from_numpy(spec['w'])).sum(),
                                whole)
  ranks = [r['row_totals'][case] for r in run['ranks']]
  _same(np.concatenate([g['emb'] for g in ranks]), emb.detach().numpy(),
        case)
  padded = np.concatenate([want.numpy(), np.zeros(
      (cfg.padded_vocab(hbt.Context('cpu', rank=0, world_size=world))
       - cfg.vocab_size, D), np.float32)])
  for r, g in enumerate(ranks):
    ctx = hbt.Context('cpu', rank=r, world_size=world)
    got = g['grad']
    part = padded[cfg.shard_rows(ctx), cfg.shard_cols(ctx)]
    np.testing.assert_array_equal(got.view(np.int32), part.view(np.int32),
                                  err_msg=f'{case} rank {r}')


@pytest.mark.timeout(3 * LAUNCH_S + 200)
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('case', sorted(UPDATE_CASES))
def test_column_updates_match_jax(runs, layout, case):
  """Each rank's slice of the table and slots after one update, against
  JAX's columns; each rank called its update kernel once on the whole
  batch's list."""
  run = runs[layout]
  world = LAYOUTS[layout][0]
  want = run['jax']['updates'][case]
  kernel = UPDATE_CASES[case][3]
  cfg = hbt.TableConfig('up', V, D, partition='column')
  for r, res in enumerate(run['ranks']):
    got = res['updates'][case]
    cols = cfg.shard_cols(hbt.Context('cpu', rank=r, world_size=world))
    assert cols.stop - cols.start == D // world
    assert len(got['state']) == len(want)
    for k, (g, w) in enumerate(zip(got['state'], want)):
      np.testing.assert_allclose(g, w[:, cols], err_msg=f'{case} {k} rank '
                                 f'{r}', **STATE_TOL)
    assert got['calls'][kernel] == 1, got['calls']
    assert sum(got['calls'].values()) == 1, got['calls']


def _tower(dense):
  tower = hbt.StackedDCNv2(WIDTHS, MLP)
  hbt.load_dcn_v2(tower, dense)
  return {n: p.detach().numpy() for n, p in tower.named_parameters()}


@pytest.mark.timeout(3 * LAUNCH_S + 200)
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_sparse_steps_match_jax(runs, layout, case):
  """Three sparse steps of a column-sharded stack and of hierarchical
  lookups: the loss, the gathered tables and accumulators, the tower."""
  run = runs[layout]
  ranks = [r[f'steps_{case}'] for r in run['ranks']]
  for i, (loss, want) in enumerate(run['jax']['steps'][case]):
    for r, rank in enumerate(ranks):
      got = rank['trace'][i]
      np.testing.assert_allclose(got['loss'], loss, rtol=1e-5)
      for name, table in want.tables.items():
        np.testing.assert_allclose(got['gathered'][name], table,
                                   err_msg=f'{name} rank {r} step {i}',
                                   **STATE_TOL)
        np.testing.assert_allclose(got['gathered_slots'][name][0],
                                   want.table_opt[name].acc[0],
                                   err_msg=f'{name} acc rank {r}',
                                   **STATE_TOL)
      for n, p in _tower(want.dense).items():
        np.testing.assert_allclose(got['tower'][n], p, err_msg=n,
                                   **STATE_TOL)
  for rank in ranks:
    assert all(rank['sharded'].values()), rank['sharded']
    assert rank['calls']['adagrad_update_sorted'] == STEPS, rank['calls']
    assert rank['fallbacks']['lookup'] == 0


@pytest.mark.timeout(3 * LAUNCH_S + 200)
@pytest.mark.parametrize('case', sorted(TRAINERS))
def test_trainer_matches_jax(runs, case):
  """Three steps of each trainer (the column-sharded ``SparseTrainer`` at
  1x2; the hierarchical one and the dense ``Trainer`` with a column and
  two row tables, looked up hierarchically, at 2x2) and its predictions,
  against the JAX trainer."""
  layout = TRAINERS[case][0]
  run = runs[layout]
  trace, jpreds = run['jax']['trainers'][case]
  ranks = [r[case] for r in run['ranks']]
  for i, (loss, want) in enumerate(trace):
    for r, rank in enumerate(ranks):
      got = rank['trace'][i]
      label = f'{case} rank {r} step {i}'
      np.testing.assert_allclose(got['loss'], loss, rtol=1e-5, err_msg=label)
      assert got['step'] == i + 1
      for name, table in want['tables'].items():
        np.testing.assert_allclose(got['tables'][name], np.asarray(table),
                                   err_msg=f'{label} {name}', **STATE_TOL)
      for name, slots in want['slots'].items():
        g = got['slots'][name]
        for a, b in zip(g if isinstance(g, list) else [g],
                        slots if isinstance(slots, list) else [slots]):
          np.testing.assert_allclose(a, np.asarray(b),
                                     err_msg=f'{label} {name} slot',
                                     **STATE_TOL)
      for n, p in _tower(want['tower']).items():
        np.testing.assert_allclose(got['tower'][n], p,
                                   err_msg=f'{label} {n}', **STATE_TOL)
  preds = np.concatenate([p.reshape(-1) for r in ranks for p in r['preds']])
  np.testing.assert_allclose(preds, jpreds, **PRED_TOL)
  if TRAINERS[case][1] == 'sparse':
    for r in ranks:
      assert r['calls']['adagrad_update_sorted'] == STEPS, r['calls']


def _logical(name, rows, world):
  """A column stack's logical rows: without the rows a world pads each
  member with."""
  ctx = hbt.Context('cpu', rank=0, world_size=world)
  (stack,) = hbt.build_stacks([hbt.TableConfig(*t, partition='column')
                               for t in TABLES], ctx)
  assert stack.stacked.name == name
  return np.concatenate([rows[off:off + cfg.vocab_size] for cfg, off in
                         zip(stack.configs, stack.offsets)])


def _same_state(got, got_world, want, want_world, msg):
  assert got['step'] == want['step'], msg
  for key in ('tables', 'slots'):
    for name, value in want[key].items():
      for g, w in zip(*(v if isinstance(v, list) else [v]
                        for v in (got[key][name], value))):
        _same(_logical(name, g, got_world), _logical(name, w, want_world),
              f'{msg} {key} {name}')
  for n, value in want['tower'].items():
    _same(got['tower'][n], value, f'{msg} {n}')


@pytest.mark.timeout(3 * LAUNCH_S + 200)
def test_column_checkpoints_restore_at_four_and_one(runs):
  """The column trainer's checkpoint, written by 2 ranks (each its
  columns), restores at 4 to the state the 2 ended with, bit for bit;
  the 4 take a step more and checkpoint it, which one process restores
  bit for bit."""
  import torch_exchanges_worker as worker
  two = runs['1x2']
  saved = two['ranks'][0]['column_sparse']['trace'][-1]
  four = runs['2x2']
  directory = two['specs']['column_sparse']['model_dir']
  assert sorted(os.listdir(os.path.join(directory, f'checkpoint-{STEPS}'))) \
      == ['manifest.json', 'rank-0.pt', 'rank-1.pt', 'replicated.pt']
  for r, res in enumerate(four['ranks']):
    _same_state(res['restore']['restored'], 4, saved, 2, f'at 4, rank {r}')
  after = four['ranks'][0]['restore']['after']
  assert after['step'] == STEPS + 1
  spec = four['specs']['restore']
  one_dir = str(four['tmp'] / 'one')
  shutil.copytree(spec['model_dir'], one_dir)
  with torch.no_grad():
    fx, tr = worker._sparse_trainer(hbt.Context(torch.device('cpu')), spec,
                                    one_dir)
    got = worker._sparse_snap(fx, tr)()
  _same_state(got, 1, after, 4, 'at 1')


@pytest.mark.timeout(3 * LAUNCH_S + 200)
def test_column_bundle_serves_jax_predictions(runs):
  """The bundle the column trainer's 2 ranks export (rank 0 writes it),
  served cold, predicts the eval batch as the JAX trainer does."""
  two = runs['1x2']
  path = two['specs']['column_sparse']['bundle']
  _, evals = two['trainer_data']
  got = hbt.Served(path, 'cpu').predict(evals)
  np.testing.assert_allclose(got.reshape(-1),
                             two['jax']['trainers']['column_sparse'][1],
                             **PRED_TOL)


# -- in this process -----------------------------------------------------------

@pytest.mark.parametrize('world', [2, 4])
def test_column_policy_matches_jax(world):
  """A column table's padded vocab is not rounded to the world, its
  columns are the rank's ``[r·d/W, (r+1)·d/W)``, and its stacks group
  apart from row tables with world-aligned member offsets, as JAX's."""
  jc = JContext(Mesh(np.array(jax.devices()[:world]).reshape(1, world),
                     ('dcn', 'ici')))
  configs = [('a', 301, 8, 'row'), ('b', 301, 8, 'row'),
             ('c', 301, 8, 'column'), ('d', 257, 8, 'column')]
  with context_scope(jc):
    jstacks = jbuild_stacks([JTableConfig(n, v, d, partition=p)
                             for n, v, d, p in configs], jc)
    jpadded = {n: JTableConfig(n, v, d, partition=p).padded_vocab(jc)
               for n, v, d, p in configs}
  stacks = hbt.build_stacks([hbt.TableConfig(n, v, d, partition=p)
                             for n, v, d, p in configs],
                            hbt.Context('cpu', rank=0, world_size=world))
  for r in range(world):
    ctx = hbt.Context('cpu', rank=r, world_size=world)
    for n, v, d, p in configs:
      cfg = hbt.TableConfig(n, v, d, partition=p)
      assert cfg.padded_vocab(ctx) == jpadded[n]
      if p == 'column':
        assert cfg.shard_cols(ctx) == slice(r * d // world,
                                            (r + 1) * d // world)
        assert cfg.shard_rows(ctx) == slice(0, v)
  assert [(s.stacked.name, s.stacked.partition, s.offsets,
           s.stacked.vocab_size) for s in stacks] == [
               (s.stacked.name, s.stacked.partition, s.offsets,
                s.stacked.vocab_size) for s in jstacks]


def test_column_dim_must_divide_evenly():
  """As JAX's ``create_table``: a dim that the world does not divide."""
  cfg = hbt.TableConfig('bad', V, 12, partition='column')
  with context_scope(JContext(Mesh(np.array(jax.devices()[:8]).reshape(1, 8),
                                   ('dcn', 'ici')))):
    with pytest.raises(ValueError, match='divide evenly'):
      jcreate_table(JTableConfig('bad', V, 12, partition='column'),
                    jax.random.PRNGKey(0))
  with pytest.raises(ValueError, match='divide evenly'):
    hbt.create_table(cfg, torch.Generator(), torch.device('cpu'),
                     hbt.Context('cpu', rank=0, world_size=8))


def test_unknown_partition_raises():
  with pytest.raises(ValueError, match='row or column'):
    hbt.TableConfig('t', V, D, partition='diagonal')


@pytest.mark.parametrize('topology', ['intra', 'inter'])
def test_a_context_made_directly_has_no_subgroups(topology):
  """A world of two made without ``Context.join``: its one node spans
  the world (the default group) and each rank is a node's only rank; a
  subgroup of some ranks needs the joined context."""
  t = TOPOLOGIES[topology]
  one_node = hbt.Context('cpu', rank=1, world_size=2)
  sp = hbt.distribute.collective.span(one_node, t)
  assert (sp.size, sp.index) == ((2, 1) if topology == 'intra' else (1, 0))
  two_nodes = hbt.Context('cpu', rank=1, world_size=4, local_world_size=2)
  with pytest.raises(ValueError, match='Context.join'):
    hbt.distribute.collective.span(two_nodes, t)
