"""The port's serving path against the JAX package's, on the CPU.

A JAX ``SparseTrainer`` (3 tables of [200, 8] stacked into one, a
stacked DCNv2 with MLP 32-16-1, 2 dense features, Adagrad 0.05 on the
table, Adam 1e-3 on the tower) trains 3 steps on seeded numpy batches in
a one-device context; its state is carried into the port's trainer with
``convert.from_jax``, and both packages export f32 and int8 bundles with
``poly_batch=True``. Ids include -2, -1 and ids up to ``vocab + 7``,
which read zeros.

Tolerances: the served predictions of the two packages to ``rtol =
1e-5, atol = 1e-6`` (the trainers' prediction tolerance in
``test_torch_trainer.py``: the same f32 tower with sums in other
orders), in f32 and in int8 (the quantized tables are the same bits,
``test_torch_quant.py``); int8 within 2e-2 of f32 and not all within
1e-7 (JAX ``test_quant.py:124-126``). The port's bundle against the
port's own trainer, and a cold process against this one, bit for bit:
the same ops on the same values. Kernel 5's op against its plain
version, and the serving lookup against ``lookup``, bit for bit.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hybridbackend_tpu.embedding.table import TableConfig as JTableConfig
from hybridbackend_tpu.estimator import SparseTrainer as JSparseTrainer
from hybridbackend_tpu.estimator import Trainer as JTrainer
from hybridbackend_tpu.framework.context import (
    Context as JContext, build_mesh, context_scope)
from hybridbackend_tpu.models.feature import (
    EmbeddingSpec as JEmbeddingSpec,
    StackedFeatureExtractor as JStackedFeatureExtractor,
    extract_features as jax_extract_features,
    init_tables as jax_init_tables)
from hybridbackend_tpu.models.ranking import (
    stacked_dcn_v2_apply, stacked_dcn_v2_init)
from hybridbackend_tpu.training.optimizer import (
    multi_optimizer as jax_multi_optimizer)
from hybridbackend_tpu.training.saved_model import Served as JServed

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.benchmarks import serving_benchmark as sb
from hybridbackend_tpu_torch.training import saved_model

TABLES, VOCAB, DIM, DENSE, BATCH, STEPS = 3, 200, 8, 2, 64, 3
MLP = [32, 16, 1]
SIZES = (1, 16, 48, 100)
TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device('cpu')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE_NAMES = [f'i{d}' for d in range(DENSE)]


def _batch(rows, seed, ragged=False):
  rng = np.random.RandomState(seed)
  b = {f'c{t}': rng.randint(-2, VOCAB + 8, rows).astype(np.int32)
       for t in range(TABLES)}
  if ragged:
    b['tags'] = rng.randint(-1, VOCAB, (rows, 4)).astype(np.int32)
    b['tags_mask'] = rng.rand(rows, 4) < 0.6
  for d in DENSE_NAMES:
    b[d] = rng.rand(rows).astype(np.float32)
  b['label'] = rng.randint(0, 2, rows).astype(np.float32)
  return b


def _jbce(p, y):
  p = jnp.clip(p, 1e-6, 1 - 1e-6)
  pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
  return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}


def _tbce(p, y):
  p = torch.clamp(p, 1e-6, 1 - 1e-6)
  pel = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
  return torch.mean(pel), {'preds': p, 'per_example_loss': pel}


def _jctx():
  return JContext(build_mesh(devices=jax.devices()[:1]))


@pytest.fixture(scope='module')
def sparse(tmp_path_factory):
  """Both packages' f32 and int8 bundles of one trained state, the port's
  trainer, and each bundle served on the CPU."""
  tmp = tmp_path_factory.mktemp('serving')
  ctx = _jctx()
  widths = [DIM] * TABLES + [1] * DENSE
  with context_scope(ctx):
    jfx = JStackedFeatureExtractor(
        [JEmbeddingSpec(JTableConfig(f'c{t}', VOCAB, DIM))
         for t in range(TABLES)], dense_columns=DENSE_NAMES, ctx=ctx)
    jtr = JSparseTrainer(
        jfx, lambda p, e, d, b: _jbce(stacked_dcn_v2_apply(p, e + d),
                                      b['label']),
        stacked_dcn_v2_init(jax.random.PRNGKey(1), widths, MLP),
        dense_optimizer=optax.adam(1e-3), table_lr=0.05, adagrad_init=0.1,
        ctx=ctx, rng=jax.random.PRNGKey(0))
    jtr.train(iter([_batch(BATCH, s) for s in range(STEPS)]))
    example = _batch(BATCH, 99)
    paths = {}
    for dtype in ('float32', 'int8'):
      paths['jax', dtype] = jtr.export_saved_model(
          str(tmp / f'jax_{dtype}'), example, table_dtype=dtype,
          poly_batch=True)
    state = jax.tree.map(np.asarray, jtr.state)
  fx = hbt.StackedFeatureExtractor(
      [hbt.EmbeddingSpec(hbt.TableConfig(f'c{t}', VOCAB, DIM))
       for t in range(TABLES)], dense_columns=DENSE_NAMES,
      ctx=hbt.Context(CPU))
  tower = hbt.StackedDCNv2(widths, MLP)
  tr = hbt.SparseTrainer(fx, lambda t, e, d, b: _tbce(t(e + d), b['label']),
                         tower)
  tr.state = hbt.from_jax(
      fx, state.tables, {k: v.acc for k, v in state.table_opt.items()},
      tower, state.dense, functools.partial(torch.optim.Adam, lr=1e-3),
      step=int(state.step))
  for dtype in ('float32', 'int8'):
    paths['port', dtype] = tr.export_saved_model(
        str(tmp / f'port_{dtype}'), example, table_dtype=dtype,
        poly_batch=True)
  served = {key: (JServed(p) if key[0] == 'jax' else hbt.Served(p, CPU))
            for key, p in paths.items()}
  return dict(paths=paths, served=served, trainer=tr)


@pytest.mark.parametrize('rows', SIZES)
@pytest.mark.parametrize('dtype', ['float32', 'int8'])
def test_served_matches_jax(sparse, dtype, rows):
  b = _batch(rows, 1000 + rows)
  got = sparse['served']['port', dtype].predict(b)
  want = np.asarray(sparse['served']['jax', dtype].predict(b))
  assert got.shape == (rows,) and got.dtype == np.float32
  np.testing.assert_allclose(got, want, **TOL)


def test_int8_is_near_f32_and_quantized(sparse):
  b = _batch(100, 7)
  f32 = sparse['served']['port', 'float32'].predict(b)
  int8 = sparse['served']['port', 'int8'].predict(b)
  np.testing.assert_allclose(int8, f32, atol=2e-2)
  assert not np.allclose(int8, f32, atol=1e-7)


@pytest.mark.parametrize('dtype', ['float32', 'int8'])
def test_signature_equals_jax(sparse, dtype):
  def read(pkg):
    with open(os.path.join(sparse['paths'][pkg, dtype],
                           'signature.json')) as f:
      return json.load(f)
  assert read('port') == read('jax')
  assert read('port')['inputs']['c0'] == {'shape': ['b'], 'dtype': 'int32'}


def test_f32_bundle_serves_the_trainers_predictions(sparse):
  """The per-member lookups through kernel 5's op give the stacked
  training lookup's bits."""
  b = _batch(48, 5)
  want = next(sparse['trainer'].predict(iter([b]))).numpy()
  np.testing.assert_array_equal(
      sparse['served']['port', 'float32'].predict(b), want)


@pytest.mark.parametrize('dtype,gathers', [('float32', TABLES),
                                           ('int8', 2 * TABLES)])
def test_exported_graph_holds_no_device(sparse, dtype, gathers):
  program = torch.export.load(os.path.join(sparse['paths']['port', dtype],
                                           'serving_fn.pt2'))
  nodes = list(program.graph.nodes)
  assert not [n for n in nodes if 'device' in n.kwargs]
  assert not program.constants and not program.state_dict
  assert sum(n.target == torch.ops.hbtpu.gather_rows.default
             for n in nodes) == gathers


def test_a_cold_process_serves_without_jax(sparse, tmp_path):
  b = _batch(16, 3)
  np.savez(tmp_path / 'batch.npz', **b)
  code = textwrap.dedent(f"""
      import sys
      import numpy as np
      from hybridbackend_tpu_torch.training.saved_model import Served
      served = Served({sparse['paths']['port', 'int8']!r}, 'cpu')
      batch = dict(np.load({str(tmp_path / 'batch.npz')!r}))
      np.save({str(tmp_path / 'preds.npy')!r}, served.predict(batch))
      print(sorted(m for m in sys.modules
                   if m.split('.')[0] in ('jax', 'hybridbackend_tpu')))
  """)
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, check=True,
                       timeout=120)
  assert out.stdout.strip() == '[]', out.stdout
  np.testing.assert_array_equal(
      np.load(tmp_path / 'preds.npy'),
      sparse['served']['port', 'int8'].predict(b))


def test_id_mappers_are_not_ported(sparse, tmp_path):
  """Named when the port refused ``id_mappers``; it now bundles them in
  the JAX package's files: ``id_mappers.npz`` holds the JAX ``IdMapper``'s
  ``state_dict`` on the same ids under ``<column>/<key>``, and
  ``id_mappers.json`` its capacity and ``min_count``."""
  from hybridbackend_tpu.embedding.dynamic import IdMapper as JIdMapper
  ids = np.random.RandomState(3).randint(0, 10**12, 300).astype(np.int64)
  mapper, jmapper = hbt.IdMapper(500, min_count=2), JIdMapper(500, 2)
  mapper.map_ids(ids)
  jmapper.map_ids(ids)
  path = sparse['trainer'].export_saved_model(
      str(tmp_path / 'x'), _batch(8, 0), id_mappers={'c0': mapper})
  with np.load(os.path.join(path, 'id_mappers.npz')) as blobs:
    want = {f'c0/{k}': v for k, v in jmapper.state_dict().items()}
    assert set(blobs.files) == set(want)
    for k, v in want.items():
      np.testing.assert_array_equal(blobs[k], v)
  with open(os.path.join(path, 'id_mappers.json')) as f:
    assert json.load(f) == {'c0': {'capacity': 500, 'min_count': 2}}
  served = hbt.Served(path, 'cpu')
  assert served.signature['id_mapped'] == ['c0']
  np.testing.assert_array_equal(
      served.id_mappers['c0'].map_ids(ids, train=False),
      jmapper.map_ids(ids, train=False))


def test_served_needs_a_card_at_its_default(sparse, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    hbt.Served(sparse['paths']['port', 'float32'])


# -- the dense trainer ---------------------------------------------------------

def test_dense_trainer_export_with_a_ragged_column_matches_jax(tmp_path):
  """One table per column, one of them ragged (padded ids with a mask,
  combined by mean), under multi_optimizer(adagrad, adam), 3 JAX steps
  carried across; both bundles with poly_batch=True."""
  ctx = _jctx()

  def specs(Spec, Config):
    return ([Spec(Config(f'c{t}', VOCAB, DIM)) for t in range(TABLES)]
            + [Spec(Config('tags', VOCAB, DIM, combiner='mean'))])

  jspecs = specs(JEmbeddingSpec, JTableConfig)
  pspecs = specs(hbt.EmbeddingSpec, hbt.TableConfig)
  widths = [DIM] * (TABLES + 1) + [1] * DENSE
  example = _batch(BATCH, 99, ragged=True)
  with context_scope(ctx):
    params = {'tables': jax_init_tables(jspecs, jax.random.PRNGKey(0), ctx),
              'net': stacked_dcn_v2_init(jax.random.PRNGKey(1), widths, MLP)}

    def jloss(p, b):
      emb, dense = jax_extract_features(p['tables'], b, jspecs, DENSE_NAMES,
                                        ctx=ctx)
      return _jbce(stacked_dcn_v2_apply(p['net'], emb + dense), b['label'])

    jtr = JTrainer(jloss, params,
                   jax_multi_optimizer(optax.adagrad(0.05),
                                       optax.adam(1e-3))(params), ctx=ctx)
    jtr.train(iter([_batch(BATCH, s, ragged=True) for s in range(STEPS)]))
    jpath = jtr.export_saved_model(str(tmp_path / 'jax'), example,
                                   poly_batch=True)
    trained = jax.tree.map(np.asarray, jtr.state.params)
  module = nn.ModuleDict({
      'tables': hbt.init_tables(pspecs, torch.Generator().manual_seed(0),
                                CPU),
      'net': hbt.StackedDCNv2(widths, MLP)})

  def loss(m, b):
    emb, dense = hbt.extract_features(m['tables'], b, pspecs, DENSE_NAMES)
    return _tbce(m['net'](emb + dense), b['label'])

  opt = hbt.multi_optimizer(functools.partial(hbt.Adagrad, lr=0.05),
                            functools.partial(torch.optim.Adam, lr=1e-3))(
                                module)
  hbt.from_jax_dense(module, pspecs, trained, opt, step=STEPS)
  tr = hbt.Trainer(loss, module, opt, ctx=hbt.Context(CPU))
  path = tr.export_saved_model(str(tmp_path / 'port'), example,
                               poly_batch=True)
  with open(os.path.join(path, 'signature.json')) as f:
    sig = json.load(f)
  with open(os.path.join(jpath, 'signature.json')) as f:
    assert sig == json.load(f)
  assert sig['ragged'] == ['tags']
  assert sig['inputs']['tags'] == {'shape': ['b', 4], 'dtype': 'int32'}
  served, jserved = hbt.Served(path, CPU), JServed(jpath)
  for rows in (1, 48):
    b = _batch(rows, 2000 + rows, ragged=True)
    got = served.predict(b)
    np.testing.assert_allclose(got, np.asarray(jserved.predict(b)), **TOL)
    np.testing.assert_array_equal(got, next(tr.predict(iter([b]))).numpy())


# -- kernel 5 as an op ---------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize('id_dtype', [torch.int32, torch.int64])
def test_gather_op_equals_its_plain_version(dtype, id_dtype):
  gen = torch.Generator().manual_seed(0)
  table = (torch.rand(50, 6, generator=gen) * 100).to(dtype)
  ids = torch.randint(-3, 55, (7, 3), generator=gen).to(id_dtype)
  got = torch.ops.hbtpu.gather_rows(table, ids)
  assert got.dtype == dtype and got.shape == (7, 3, 6)
  assert torch.equal(got, hbt.gather_rows_reference(table, ids))
  assert torch.equal(hbt.gather_rows(table, ids), got)


def test_gather_op_is_one_node_of_an_exported_graph(tmp_path):
  table = torch.rand(20, 4)

  def serve(params, batch):
    return hbt.gather_rows(params[0], batch['ids'])

  path = saved_model.export(serve, [table],
                            {'ids': np.arange(-2, 8, dtype=np.int64)},
                            str(tmp_path), poly_batch=True)
  program = torch.export.load(os.path.join(path, 'serving_fn.pt2'))
  calls = [n for n in program.graph.nodes if n.op == 'call_function']
  assert [n.target for n in calls] == [torch.ops.hbtpu.gather_rows.default]
  assert not [n for n in program.graph.nodes if 'device' in n.kwargs]
  served = hbt.Served(path, CPU)
  ids = np.array([3, -1, 25], np.int64)
  assert torch.equal(served.predict_staged(served.stage({'ids': ids})),
                     table[[3, 0, 19]])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shuffle', [False, True])
def test_serving_lookup_equals_lookup(dtype, shuffle):
  cfg = hbt.TableConfig('t', 100, 8, dtype=dtype, shuffle_ids=shuffle)
  table = hbt.create_table(cfg, torch.Generator().manual_seed(0), CPU)
  ids = torch.from_numpy(
      np.random.RandomState(0).randint(-3, 110, (40, 3)).astype(np.int32))
  want = hbt.lookup(table, ids, cfg)
  got = hbt.lookup(table, ids, cfg, serving=True)
  assert got.dtype == dtype and torch.equal(got, want)
  mask = torch.from_numpy(np.random.RandomState(1).rand(40, 3) < 0.5)
  assert torch.equal(hbt.lookup_sparse(table, ids, mask, cfg, serving=True),
                     hbt.lookup_sparse(table, ids, mask, cfg))


# -- the serving harness ------------------------------------------------------

def test_serving_harness_reports_one_json_line(capsys):
  flags = ['--device', 'cpu', '--tables', '2', '--vocab', '500',
           '--dense-features', '3', '--sizes', '4', '32', '--inner', '2',
           '--repeats', '2', '--json']
  assert sb.main(flags) == 0
  (line,) = capsys.readouterr().out.strip().splitlines()
  got = json.loads(line)
  assert got['device'] == 'cpu' and got['card'] is None
  for case in ('f32', 'int8'):
    r = got[f'flagship_{case}']
    assert set(r['batches']) == {'4', '32'}
    assert all(b['amortized_ms'] == min(b['windows_ms']) > 0
               for b in r['batches'].values())
    assert r['export_s'] > 0 and r['cold_load_s'] > 0 and r['bundle_mb'] > 0
    # On the CPU the op runs the plain version and counts no launch.
    assert r['gather_launches_per_predict'] == 0
  din = got['din_ragged']
  assert set(din['batches']) == {'4', '32'} and din['bundle_mb'] > 0
  # Its lookups are the loss function's own index_select: no kernel 5.
  assert din['gather_launches_per_predict'] == 0
  assert sb.main(['--device', 'cpu', '--sizes', '8', '2048', '--inner', '2',
                  '--repeats', '2', '--cases', 'din', '--json']) == 0
  (line,) = capsys.readouterr().out.strip().splitlines()
  got = json.loads(line)
  assert not any(k.startswith('flagship') for k in got)
  # Served up to 1024 rows, as the JAX harness serves it.
  assert set(got['din_ragged']['batches']) == {'8'}
