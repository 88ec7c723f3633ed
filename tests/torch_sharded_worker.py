"""One rank of the port's sharded paths, for the CPU parity tests.

Run under the launcher, one process per rank:

  python -m hybridbackend_tpu_torch.run --simulate N --device cpu \\
      tests/torch_sharded_worker.py CASES.pkl OUT_DIR

``CASES.pkl`` holds a list of ``(name, kind, spec)`` made by the tests
from seeded numpy inputs (and the JAX package's initial states, as numpy
arrays). Each rank runs every case in order and writes its results to
``OUT_DIR/<rank>.pkl``: ``{name: result}``, numpy arrays and numbers.
This file imports torch and the port only: never JAX.
"""

import functools
import os
import pickle
import sys

import torch

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.embedding import lookup as lookup_mod


def _np(t):
  """A numpy copy (the state changes in place); a bf16 tensor as the
  float32 values it holds."""
  t = t.detach().cpu()
  return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _dtype(name):
  return getattr(torch, name or 'float32')


def collectives(ctx, spec):
  """Every collective on rank-made inputs, and ``all_to_all_v`` on the
  rank's block of the test's global buckets and sizes."""
  r = ctx.rank
  x = torch.arange(6, dtype=torch.float32) * (r + 1)
  out = {
      'sum': collective.allreduce(x, ctx=ctx),
      'max': collective.allreduce(x, 'max', ctx=ctx),
      'mean': collective.allreduce(x, 'mean', ctx=ctx),
      'bcast': collective.broadcast(x + 10 * r, 1, ctx=ctx),
      'gather': collective.allgather(x[:2] + r, ctx=ctx),
      'a2a': collective.alltoall(
          torch.arange(2 * ctx.world_size, dtype=torch.int32) + 100 * r,
          ctx=ctx),
      'rs': collective.reduce_scatter(
          torch.arange(3 * ctx.world_size, dtype=torch.float32).reshape(
              ctx.world_size, 3) + r, ctx=ctx),
  }
  recv, sizes = collective.all_to_all_v(
      torch.from_numpy(spec['buckets'][r]), torch.from_numpy(spec['sizes'][r]),
      ctx=ctx)
  out['a2av'] = recv
  out['a2av_sizes'] = sizes
  return {k: _np(v) for k, v in out.items()}


def wire(ctx, spec):
  """Each cast collective at each wire dtype of ``spec['wires']`` on the
  rank's row of the test's global payloads; and what each of
  ``_refusals`` raises, its class's name and its message."""
  r = ctx.rank
  x = torch.from_numpy(spec['x'][r])
  out = {}
  for w in spec['wires']:
    recv, sizes = collective.all_to_all_v(
        torch.from_numpy(spec['buckets'][r]),
        torch.from_numpy(spec['sizes'][r]), ctx=ctx, wire_dtype=w)
    out[w] = {k: _np(v) for k, v in {
        'sum': collective.allreduce(x, ctx=ctx, wire_dtype=w),
        'mean': collective.allreduce(x, 'mean', ctx=ctx, wire_dtype=w),
        'gather': collective.allgather(x, ctx=ctx, wire_dtype=w),
        'a2a': collective.alltoall(x, ctx=ctx, wire_dtype=w),
        'a2av': recv, 'a2av_sizes': sizes,
        'ints': collective.alltoall(
            torch.arange(2 * ctx.world_size, dtype=torch.int32) + 100 * r,
            ctx=ctx, wire_dtype=w)}.items()}
  out['refused'] = {}
  for case, run in _refusals(x, ctx, spec['refused']).items():
    try:
      run()
      out['refused'][case] = None
    except Exception as e:  # what each raises is the result
      out['refused'][case] = (type(e).__name__, str(e))
  return out


def _refusals(x, ctx, refused):
  """The failures a cast collective meets, each a call: a wire dtype
  that is not a 16-bit float (``refused``, and float64, which would
  widen the wire), the backend refusing the wire dtype (its call raising
  gloo's own words for a dtype it refuses, "Invalid scalar type"), and a
  backend failure that is not about the dtype (a ``DistBackendError``,
  as a timeout raises, and a plain ``RuntimeError`` from a lost peer)."""
  def raising(error):
    def call(v):
      raise error
    return lambda: collective._on_wire(x, 'bfloat16', 'allreduce',
                                       call)
  return {
      'name': lambda: collective.allreduce(x, ctx=ctx, wire_dtype=refused),
      'wider': lambda: collective.allreduce(x, ctx=ctx,
                                            wire_dtype='float64'),
      'backend': raising(RuntimeError('Invalid scalar type')),
      'timeout': raising(torch.distributed.DistBackendError(
          'Timed out waiting 1000ms for recv operation to complete')),
      'peer': raising(RuntimeError('Connection reset by peer'))}


def lookups(ctx, spec):
  """``lookup`` of the rank's part of an id set, for each ``(id set,
  options)`` case."""
  cfg = hbt.TableConfig(spec['name'], spec['vocab'], spec['dim'])
  table = torch.from_numpy(spec['table'][cfg.shard_rows(ctx)].copy())
  out = {}
  for ids_name, opt_name in spec['cases']:
    ids = torch.from_numpy(spec['ids'][ids_name])
    local = (hbt.world_slice(ids, ctx) if ids.dim() == 1
             else ids[ctx.rows(ids.shape[0])])
    before = lookup_mod.lookup.overflow_fallbacks
    emb = hbt.lookup(table, local, cfg, ctx=ctx, **spec['options'][opt_name])
    out[f'{ids_name}/{opt_name}'] = _np(emb)
    out[f'{ids_name}/{opt_name}/fallbacks'] = (
        lookup_mod.lookup.overflow_fallbacks - before)
  return out


def updates(ctx, spec):
  """``sparse_adagrad_apply`` of the rank's rows of the ids and
  gradients, for each exchange, from one table and accumulator."""
  cfg = hbt.TableConfig(spec['name'], spec['vocab'], spec['dim'])
  rows = cfg.shard_rows(ctx)
  ids = torch.from_numpy(spec['ids'])[ctx.rows(spec['ids'].shape[0])]
  demb = torch.from_numpy(spec['demb'])[ctx.rows(spec['ids'].shape[0])]
  out = {}
  for name, opts in spec['options'].items():
    table = torch.from_numpy(spec['table'][rows].copy())
    state = hbt.SparseOptState(acc=(torch.from_numpy(
        spec['acc'][rows].copy()),))
    before = hbt.sparse_adagrad_apply.overflow_fallbacks
    hbt.sparse_adagrad_apply(table, state, ids, demb, cfg, spec['lr'],
                             ctx=ctx, **opts)
    out[name] = (_np(table), _np(state.acc[0]))
    out[f'{name}/fallbacks'] = (hbt.sparse_adagrad_apply.overflow_fallbacks
                                - before)
  return out


APPLY = {'adagrad': hbt.sparse_adagrad_apply, 'sgd': hbt.sparse_sgd_apply,
         'adam': hbt.sparse_adam_apply}


def applies(ctx, spec):
  """Rounds of one table optimizer's update (``spec['optimizer']``:
  ``'adagrad'``, ``'sgd'`` or ``'adam'``) on a table from its global
  array, the rank's rows of each round's ids and gradients, for each
  ``(table, options)`` case; the rank's table and slots after every
  round, the kernel launches and the overflow fallbacks."""
  optimizer = spec['optimizer']
  apply = APPLY[optimizer]
  out = {}
  for case, (table_name, opts) in spec['cases'].items():
    t = spec['tables'][table_name]
    cfg = hbt.TableConfig(table_name, t['vocab'], t['dim'],
                          sharded=t['sharded'])
    rows = cfg.shard_rows(ctx)
    table = torch.from_numpy(t['table'][rows].copy())
    slots = tuple(torch.from_numpy(a[rows].copy()) for a in t['slots'])
    _reset()
    before = apply.overflow_fallbacks
    trace = []
    for k, (ids, demb) in enumerate(spec['rounds']):
      local = ctx.rows(ids.shape[0])
      args = (torch.from_numpy(ids[local]), torch.from_numpy(demb[local]),
              cfg, spec['lr'])
      if optimizer == 'sgd':
        apply(table, *args, ctx=ctx, **opts)
      elif optimizer == 'adam':
        apply(table, hbt.SparseOptState(acc=slots), *args, step=k + 1,
              ctx=ctx, **opts)
      else:
        apply(table, hbt.SparseOptState(acc=slots), *args, ctx=ctx, **opts)
      trace.append([_np(table), *(_np(a) for a in slots)])
    out[case] = {'trace': trace, 'calls': _launches(),
                 'fallbacks': apply.overflow_fallbacks - before,
                 'sharded': cfg.should_shard(ctx)}
  return out


COUNTED = ('adagrad_update_sorted', 'scatter_add_sorted',
           'adam_update_sorted', 'gsum_dense_sorted')
_CALLS = dict.fromkeys(COUNTED, 0)


def _count_calls():
  """Counts the update wrappers' calls where ``sparse_update`` makes
  them: on the CPU a wrapper runs its plain version and counts no
  launch, so the worker counts the calls, to show which kernel each path
  reaches."""
  from hybridbackend_tpu_torch.embedding import sparse_update as su
  for name in COUNTED:
    def counted(*a, _fn=getattr(su, name), _name=name, **k):
      _CALLS[_name] += 1
      return _fn(*a, **k)
    setattr(su, name, counted)


def _reset():
  _CALLS.update(dict.fromkeys(COUNTED, 0))


def _launches():
  """The counted wrappers' calls since ``_reset``."""
  return dict(_CALLS)


def _tower_optimizer(spec):
  """The tower's optimizer: Adam 1e-3, or SGD at ``spec['tower_sgd']``."""
  if spec.get('tower_sgd'):
    return functools.partial(torch.optim.SGD, lr=spec['tower_sgd'])
  return functools.partial(torch.optim.Adam, lr=1e-3)


def _tower_and_loss(spec):
  """The step's tower and its BCE loss, a mean over the rank's rows
  times ``spec['scale']``, with the predictions as its aux ``preds`` when
  ``spec['preds']`` says so."""
  scale = spec.get('scale', 1.0)
  if spec.get('model', 'dcnv2') == 'dlrm':
    tower = hbt.DLRM(len(spec['dense']), len(spec['tables']),
                     spec['bottom'], spec['tables'][0][2], spec['mlp'])
    preds = lambda t, e, d: t(d, e)
  else:
    tower = hbt.StackedDCNv2(spec['widths'], spec['mlp'])
    preds = lambda t, e, d: t(e + d)

  def model_loss(t, emb_f, dense_f, batch):
    p = torch.clamp(preds(t, emb_f, dense_f), 1e-6, 1 - 1e-6)
    y = batch['label']
    pel = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    return torch.mean(pel) * scale, ({'preds': p} if spec.get('preds')
                                     else {})

  return tower, model_loss


def steps(ctx, spec):
  """The sparse step (DCNv2 or DLRM, ``spec['options']`` passed to
  ``make_sparse_train_step``) from the JAX initial state, on the rank's
  rows of each global batch; the loss and the rank's state after every
  step, and the tables and slots gathered whole."""
  dtype = _dtype(spec.get('dtype'))
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(*t, dtype=dtype))
           for t in spec['tables']]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=spec['dense'],
                                   ctx=ctx,
                                   min_shard_rows=spec['min_shard_rows'])
  tower, model_loss = _tower_and_loss(spec)
  init = spec['init']
  state = hbt.from_jax(fx, init['tables'], init['acc'], tower, init['dense'],
                       _tower_optimizer(spec))
  step = hbt.make_sparse_train_step(fx, model_loss, table_lr=0.05,
                                    **spec['options'])
  return _run_steps(ctx, fx, state, step, spec['batches'])


def _run_steps(ctx, fx, state, step, batches):
  _reset()
  fell = (lookup_mod.lookup.overflow_fallbacks,
          *(f.overflow_fallbacks for f in APPLY.values()))
  trace = []
  for batch in batches:
    rows = ctx.rows(batch['label'].shape[0])
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    state, metrics = step(state, local)
    trace.append({
        'loss': float(metrics['loss']),
        'aux': {k: _np(v) for k, v in metrics.items() if k != 'loss'},
        'tables': {k: _np(v) for k, v in state.tables.items()},
        'acc': {k: _np(v.acc[0]) for k, v in state.table_opt.items()},
        'slots': {k: [_np(a) for a in v.acc]
                  for k, v in state.table_opt.items()},
        'tower': {n: _np(p) for n, p in state.dense.named_parameters()},
        'gathered': {k: _np(v) for k, v in
                     hbt.gather_tables(fx, state.tables).items()},
        'gathered_slots': {k: [_np(a) for a in v] for k, v in
                           hbt.gather_slots(fx, state.table_opt).items()}})
  now = (lookup_mod.lookup.overflow_fallbacks,
         *(f.overflow_fallbacks for f in APPLY.values()))
  return {'trace': trace, 'sharded': {s.stacked.name: s.stacked.should_shard(
      ctx) for s in fx.stacks}, 'calls': _launches(),
          'fallbacks': dict(zip(('lookup', *APPLY), (b - a for a, b in zip(
              fell, now))))}


def gathers(ctx, spec):
  """``gather_slots`` of a DLRM + LazyAdam state made by ``from_jax`` from
  JAX's global arrays, for each table dtype in ``spec['inits']``."""
  out = {}
  for dtype, init in spec['inits'].items():
    specs = [hbt.EmbeddingSpec(hbt.TableConfig(*t, dtype=_dtype(dtype)))
             for t in spec['tables']]
    fx = hbt.StackedFeatureExtractor(specs, dense_columns=spec['dense'],
                                     ctx=ctx,
                                     min_shard_rows=spec['min_shard_rows'])
    tower, _ = _tower_and_loss(dict(spec, model='dlrm'))
    state = hbt.from_jax(fx, init['tables'], init['acc'], tower,
                         init['dense'],
                         functools.partial(torch.optim.Adam, lr=1e-3))
    out[dtype] = {k: [_np(a) for a in v] for k, v in
                  hbt.gather_slots(fx, state.table_opt).items()}
  return out


def din_steps(ctx, spec):
  """The DIN sparse step in raw mode from the JAX initial state, on the
  rank's rows of each global batch: the item table (``cand_hist``, the
  candidate then its history) and the user table in one stack."""
  specs = [hbt.EmbeddingSpec(hbt.TableConfig('item', spec['items'],
                                             spec['dim']),
                             column='cand_hist'),
           hbt.EmbeddingSpec(hbt.TableConfig('user', spec['users'],
                                             spec['dim']))]
  fx = hbt.StackedFeatureExtractor(specs, ctx=ctx)
  tower = hbt.DIN(spec['dim'], 1, 2, spec['dnn'], spec['att'])
  init = spec['init']
  state = hbt.from_jax(fx, init['tables'], init['acc'], tower, init['dense'],
                       _tower_optimizer(spec))

  def raw_model_loss(t, members, batch):
    emb = members['item']
    p = t(emb[:, 0], emb[:, 1:], batch['hist_mask'], [members['user']],
          [batch['d0'], batch['d1']])
    p = torch.clamp(p, 1e-6, 1 - 1e-6)
    y = batch['label']
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {
        'preds': p}

  step = hbt.make_sparse_train_step(fx, None, table_lr=0.05,
                                    raw_model_loss=raw_model_loss,
                                    **spec['options'])
  return _run_steps(ctx, fx, state, step, spec['batches'])


def interleave(ctx, spec):
  """The interleaved step (``spec['k']`` micro-batches of the rank's rows,
  ``spec['options']`` passed to it) and the plain step, each from the JAX
  initial state, on the rank's rows of each global batch
  (``_run_steps``); and with ``spec['refuse_k']`` what the interleaved
  step at that ``k`` raises on the first batch."""
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(*t)) for t in spec['tables']]
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=spec['dense'],
                                   ctx=ctx)
  init = spec['init']
  out = {}
  for kind in ('interleaved', 'plain'):
    tower, model_loss = _tower_and_loss(spec)
    state = hbt.from_jax(fx, init['tables'], init['acc'], tower,
                         init['dense'], _tower_optimizer(spec))
    kw = dict(table_lr=0.05, table_optimizer=spec['optimizer'],
              **spec['options'])
    step = (hbt.make_interleaved_train_step(fx, model_loss, spec['k'], **kw)
            if kind == 'interleaved' else
            hbt.make_sparse_train_step(fx, model_loss, **kw))
    out[kind] = _run_steps(ctx, fx, state, step, spec['batches'])
  if spec.get('refuse_k'):
    step = hbt.make_interleaved_train_step(fx, model_loss, spec['refuse_k'],
                                           **kw)
    batch = spec['batches'][0]
    rows = ctx.rows(batch['label'].shape[0])
    try:
      step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()})
      out['refused'] = None
    except ValueError as e:
      out['refused'] = str(e)
  return out


_GATHERS = [0]


def _count_gathers():
  """Counts kernel 5's calls where the sharded lookups make them (the
  served float exchanges and the int8 lookups): on the CPU its wrapper
  runs the plain version and counts no launch."""
  from hybridbackend_tpu_torch.embedding import quant
  for module in (lookup_mod, quant):
    def counted(*a, _fn=module.gather_rows):
      _GATHERS[0] += 1
      return _fn(*a)
    module.gather_rows = counted


def _gathered(run):
  """``run()`` and kernel 5's calls in it."""
  before = _GATHERS[0]
  got = run()
  return got, _GATHERS[0] - before


def _ids_of(ctx, ids):
  """The rank's part of a global id array: of a flat list, as
  ``world_slice`` cuts it (padded with -1); else its rows."""
  ids = torch.from_numpy(ids)
  return (hbt.world_slice(ids, ctx) if ids.dim() == 1
          else ids[ctx.rows(ids.shape[0])])


def serving(ctx, spec):
  """Sharded serving on the rank: for each int8 table, its shard by
  ``shard_quantized`` of the quantized whole table, ``quantize_table`` of
  the float shard and ``quantized_from_jax`` of JAX's global arrays, and
  the lookups of the rank's ids (by ``lookup_quantized``, by ``lookup``
  under the alltoall strategy, and of the whole quantized table); for
  each float case, the served and the training lookup of the shard; the
  features of ``extract_features`` over the members' int8 shards; the
  raw embeddings of ``lookup_raw`` over a quantized stack shard; and
  kernel 5's calls of each."""
  _count_gathers()
  cpu = torch.device('cpu')
  out = {'int8': {}, 'float': {}}
  for name, t in spec['int8'].items():
    cfg = hbt.TableConfig(name, t['vocab'], t['dim'], **t['kw'])
    whole = torch.from_numpy(t['whole'])
    qs = hbt.shard_quantized(hbt.quantize_table(whole), cfg, ctx)
    qf = hbt.quantize_table(whole[cfg.shard_rows(ctx)])
    res = {'q': _np(qs.q), 'scale': _np(qs.scale),
           'quantized_shard_equal': bool(torch.equal(qs.q, qf.q)
                                         and torch.equal(qs.scale, qf.scale))}
    if t.get('jax') is not None:
      qj = hbt.quantized_from_jax(*t['jax'], t['dim'], cpu, cfg, ctx)
      res['from_jax_equal'] = bool(torch.equal(qs.q, qj.q)
                                   and torch.equal(qs.scale, qj.scale))
    for ids_name, ids in spec['ids'].items():
      local = _ids_of(ctx, ids)
      emb, calls = _gathered(lambda: hbt.lookup_quantized(qs, local, cfg, ctx))
      res[ids_name] = {
          'emb': _np(emb), 'gathers': calls,
          'by_lookup': _np(hbt.lookup(qs, local, cfg, ctx=ctx,
                                      strategy='alltoall')),
          'whole': _np(hbt.lookup(hbt.quantize_table(whole), local, cfg,
                                  ctx=ctx))}
    out['int8'][name] = res
  table = spec['float']
  for case, (kw, opts) in spec['float_cases'].items():
    cfg = hbt.TableConfig('f', table.shape[0], table.shape[1], **kw)
    shard = torch.from_numpy(
        table[cfg.shard_rows(ctx), cfg.shard_cols(ctx)].copy()
    ).requires_grad_()
    res = {}
    for ids_name, ids in spec['ids'].items():
      local = _ids_of(ctx, ids)
      served, calls = _gathered(lambda: hbt.lookup(
          shard, local, cfg, True, ctx=ctx, **opts))
      trained, train_calls = _gathered(lambda: hbt.lookup(
          shard, local, cfg, ctx=ctx, **opts))
      res[ids_name] = {'served': _np(served), 'trained': _np(trained),
                       'gathers': (calls, train_calls),
                       'grad': (served.requires_grad, trained.requires_grad)}
    out['float'][case] = res
  fs = spec['features']
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(*t)) for t in fs['tables']]
  rows = ctx.rows(fs['batch']['d0'].shape[0])
  batch = {k: torch.from_numpy(v[rows]) for k, v in fs['batch'].items()}
  members = {s.name: hbt.quantize_table(torch.from_numpy(
      fs['arrays'][s.name][s.config.shard_rows(ctx)].copy())) for s in specs}
  (emb, dense), calls = _gathered(lambda: hbt.extract_features(
      members, batch, specs, ['d0'], ctx=ctx))
  out['features'] = {'emb': [_np(e) for e in emb],
                     'dense': [_np(d) for d in dense], 'gathers': calls}
  fx = hbt.StackedFeatureExtractor(specs, dense_columns=['d0'], ctx=ctx)
  (stack,) = fx.stacks
  whole = torch.from_numpy(fs['stack'])
  q = hbt.quantize_table(whole[stack.stacked.shard_rows(ctx)])
  (raw, _, _), calls = _gathered(lambda: fx.lookup_raw(
      {stack.stacked.name: q}, batch, serving=True))
  out['stack'] = {'raw': _np(raw[stack.stacked.name]), 'gathers': calls}
  return out


KINDS = {'collectives': collectives, 'wire': wire, 'lookups': lookups,
         'updates': updates, 'applies': applies, 'steps': steps,
         'gathers': gathers, 'din_steps': din_steps,
         'interleave': interleave, 'serving': serving}


def main(cases_path, out_dir):
  ctx = hbt.Context.join('cpu')
  torch.set_num_threads(1)
  _count_calls()
  with open(cases_path, 'rb') as f:
    cases = pickle.load(f)
  results = {}
  for name, kind, spec in cases:
    results[name] = KINDS[kind](ctx, spec)
  with open(os.path.join(out_dir, f'{ctx.rank}.pkl'), 'wb') as f:
    pickle.dump(results, f)
  ctx.leave()


if __name__ == '__main__':
  main(*sys.argv[1:])
