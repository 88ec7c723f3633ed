"""One run of one cell: set-up, the check steps, the window, the check.

The cell, its configuration, traffic mix, metrics and limits are found
by name (``BENCHMARK.json`` and the files under ``portbench/``). The run
drives the port's normal sparse path, which the configuration's file
(``configs/<config>.py``: ``build``) puts together by the configuration's
settings (``train.py``): the tables in stacks (``embedding/stack.py``
through ``StackedFeatureExtractor``), the tower of ``models/ranking.py``,
``SparseTrainState`` and the step of
``training/sparse_step.make_sparse_train_step``.

Set-up draws the tower (``tower.py``), has the configuration build the
port's state and step over the stacked tables filled on the device from
the counter function (``initfn``), draws the batch pool
(``generator.py``), runs the first three steps through the window's own
call and feed (the check steps) keeping a snapshot of their state, and
warms the step up on the next batches. The window then steps back to
back for ``--seconds``. Once it has closed and the peak memory is read,
the port's state is freed and the plain reference follows the three
check steps; :mod:`portbench.check` compares the two.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import check, generator, initfn, peaks, tracing, train
from portbench import tower as tw
from portbench import window

HERE = os.path.dirname(os.path.abspath(__file__))
CHECK_STEPS = 3
WARMUP_STEPS = 17
TRACE_STEPS = 40
TRACED_RUN_WINDOW_S = 10.0
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hybridbackend_tpu')


def load_module(path: str, name: str):
  """The Python file at ``path`` as a module named ``name``."""
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  sys.modules[name] = mod
  spec.loader.exec_module(mod)
  return mod


def _json(path: str) -> dict:
  with open(path) as f:
    return json.load(f)


@dataclasses.dataclass
class Cell:
  name: str
  chips: int
  cfg: dict
  traffic: dict
  mod: Any                  # configs/<config>.py
  ref: Any                  # reference/<config>.py
  limits: dict              # limits/<cell>.json ({} when absent)
  end_to_end: List[dict]
  per_layer: List[dict]
  readers: Dict[str, Any]   # metrics/<metric>.py of each per-layer metric


def _reported(metric: dict, cell: str) -> bool:
  return 'workloads' not in metric or cell in metric['workloads']


def load_cell(root: str, workload: str) -> Cell:
  """The cell ``workload`` of ``root/BENCHMARK.json``."""
  bench = _json(os.path.join(root, 'BENCHMARK.json'))
  by_name = {w['name']: w for w in bench['workloads']}
  if workload not in by_name:
    raise KeyError(f'no workload {workload!r} in BENCHMARK.json; have '
                   f'{sorted(by_name)}')
  w = by_name[workload]
  if w['chips'] != 1:
    raise ValueError(f'{workload} asks for {w["chips"]} chips; the harness '
                     'runs cells on one')
  conf = {c['name']: c for c in bench['configs']}[w['config']]
  limits_path = os.path.join(HERE, 'limits', workload + '.json')
  per_layer = [m for m in bench['per_layer'] if _reported(m, workload)]
  return Cell(
      name=workload, chips=w['chips'],
      cfg=_json(os.path.join(root, conf['file'])),
      traffic=_json(os.path.join(HERE, 'traffic', w['traffic'] + '.json')),
      mod=load_module(os.path.join(HERE, 'configs', w['config'] + '.py'),
                      'portbench_config'),
      ref=load_module(os.path.join(HERE, 'reference', w['config'] + '.py'),
                      'portbench_reference'),
      limits=(_json(limits_path) if os.path.exists(limits_path) else {}),
      end_to_end=[m for m in bench['end_to_end']
                  if _reported(m, workload)],
      per_layer=per_layer,
      readers={m['name']: load_module(
          os.path.join(HERE, 'metrics', m['name'] + '.py'),
          'portbench_metric_' + m['name'].replace('.', '_'))
               for m in per_layer})


@dataclasses.dataclass(frozen=True)
class Member:
  """Where a member table's rows live in the port's state."""
  index: int                 # its place in the configuration's members
  stack: str                 # the stacked table's name
  offset: int                # its first row in the stack


@dataclasses.dataclass
class Prepared:
  """The port's state after set-up, and what the check needs."""
  state: Any
  step: Callable
  pool: Dict[str, torch.Tensor]
  members: Dict[str, Member]
  snap: dict = None          # the state around the check steps
  check_batches: List[dict] = None
  tower0: Dict[str, torch.Tensor] = None

  _batches: Dict[int, dict] = dataclasses.field(default_factory=dict)

  def batch_of(self, i: int) -> dict:
    """Batch ``i`` of the pool (cycled): views made once a pool entry,
    so that the window's host time is the step's."""
    i %= next(iter(self.pool.values())).shape[0]
    if i not in self._batches:
      self._batches[i] = generator.batch(self.pool, i)
    return self._batches[i]


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _unique_valid(x: torch.Tensor) -> torch.Tensor:
  x = x.reshape(-1).to(torch.int64)
  return torch.unique(x[x >= 0])


def _filler(cfg: dict, mod, seed: int, device: torch.device,
            members: Dict[str, Member]):
  """``fill(fx, dtype)`` for the configuration's ``build``: each stacked
  table of ``fx`` made on the device from the counter function; where
  each member's rows lie goes into ``members``."""
  index = {name: i for i, (name, _) in enumerate(mod.members(cfg))}
  dim = cfg['embedding_dim']

  def fill(fx, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    tables = {}
    for stack in fx.stacks:
      # Rows past the members' (padding) stay zero.
      table = torch.zeros((stack.stacked.padded_vocab(), dim), dtype=dtype,
                          device=device)
      for tc, off in zip(stack.configs, stack.offsets):
        initfn.fill_member(table[off:off + tc.vocab_size], seed,
                           index[tc.name])
        members[tc.name] = Member(index[tc.name], stack.stacked.name, off)
      tables[stack.stacked.name] = table
    if set(members) != set(index):
      raise ValueError(f'the stacks hold {sorted(members)}, the '
                       f'configuration {sorted(index)}')
    return tables
  return fill


def prepare(cell: Cell, seed: int, device: torch.device,
            warmup: int = WARMUP_STEPS) -> Prepared:
  """Set-up: tower, tables, state and step, pool, the check steps and
  the warm-up."""
  import hybridbackend_tpu_torch as hbt
  cfg, mod = cell.cfg, cell.mod
  s = train.settings(cfg)
  torch.backends.cuda.matmul.allow_tf32 = s.tf32
  torch.backends.cudnn.allow_tf32 = s.tf32
  tower0 = tw.draw(mod.tower_layers(cfg), seed, device)
  members: Dict[str, Member] = {}
  parts = mod.build(cfg, hbt.Context(device),
                    _filler(cfg, mod, seed, device, members), tower0)
  pool = generator.make_pool(cell.traffic, mod.columns(cfg),
                             cell.traffic['batch_per_chip'], seed, device)
  prep = Prepared(parts['state'], parts['step'], pool, members,
                  tower0=tower0)
  prep.snap = _check_steps(prep, cell)
  prep.check_batches = [{k: v.cpu() for k, v in prep.batch_of(i).items()}
                        for i in range(CHECK_STEPS)]
  for i in range(CHECK_STEPS, CHECK_STEPS + warmup):
    prep.state, _ = prep.step(prep.state, prep.batch_of(i))
  _sync(device)
  return prep


def _held(prep: Prepared, name: str, x: torch.Tensor):
  """Member ``name``'s distinct ids among ``x``, and their rows in its
  stack."""
  u = _unique_valid(x)
  return u, u + prep.members[name].offset


def _check_steps(prep: Prepared, cell: Cell) -> dict:
  """The first three steps, and the snapshot of the port's state that
  ``check.observe`` reads: of the tables, the rows the steps touched."""
  state = prep.state
  params = dict(state.dense.named_parameters())
  ref_ids = cell.ref.member_ids(cell.cfg)
  ids = [ref_ids(prep.batch_of(i)) for i in range(CHECK_STEPS)]
  p0 = {k: v.detach().cpu().clone() for k, v in params.items()}
  losses, tables, m1 = [], {}, {}
  for i in range(CHECK_STEPS):
    prep.state, metrics = prep.step(prep.state, prep.batch_of(i))
    losses.append(metrics['loss'])
    if i == 0:
      opt = prep.state.dense_opt.state
      # A parameter the optimizer has not stepped has no moments yet.
      m1 = {k: opt[p]['exp_avg'].cpu().clone() if 'exp_avg' in opt.get(p, {})
            else torch.zeros_like(p, device='cpu')
            for k, p in params.items()}
      for name, m in prep.members.items():
        u0, r0 = _held(prep, name, ids[0][name])
        tables[name] = {'index': m.index, 'u0': u0.cpu(),
                        't1': state.tables[m.stack][r0].cpu(),
                        'a1': state.table_opt[m.stack].acc[0][r0].cpu()}
  for name, m in prep.members.items():
    big, rb = _held(prep, name, torch.cat([x[name].reshape(-1)
                                           for x in ids]))
    tables[name].update(U=big.cpu(), t3=state.tables[m.stack][rb].cpu())
  return {'losses': [float(x) for x in losses], 'm1': m1, 'p0': p0,
          'p3': {k: v.detach().cpu().clone() for k, v in params.items()},
          'tables': tables}


def judge(cell: Cell, seed: int, snap: dict, check_batches: List[dict],
          tower0: Dict[str, torch.Tensor], device: torch.device) -> dict:
  """The reference's three steps from the benchmark's inputs, and the
  numbers of the port's snapshot against them."""
  obs = check.observe(snap, cell.cfg, seed, device)
  batches = [{k: v.to(device) for k, v in b.items()} for b in check_batches]
  ref = cell.ref.run(cell.cfg, seed, batches, tower0)
  return check.compare(obs, check.observe(ref, cell.cfg, seed, device))


def _free(device: torch.device) -> None:
  gc.collect()
  if device.type == 'cuda':
    torch.cuda.empty_cache()


def _kernel1_lists(cell: Cell, prep: Prepared, i: int) -> List[tuple]:
  """``(n, u)`` of each of kernel 1's lists at step ``i``, one a stack:
  its valid entries and their distinct rows."""
  ids = cell.ref.member_ids(cell.cfg)(prep.batch_of(i))
  out = []
  for stack in sorted({m.stack for m in prep.members.values()}):
    rows = []
    for k, m in prep.members.items():
      if m.stack == stack:
        x = ids[k].reshape(-1).to(torch.int64)
        rows.append(x[x >= 0] + m.offset)
    valid = torch.cat(rows)
    out.append((int(valid.numel()), int(torch.unique(valid).numel())))
  return out


@dataclasses.dataclass
class Reading:
  """What a per-layer metric's reader reads (``metrics/<metric>.py``:
  ``read(r) -> float or None``)."""
  trace: Optional[tracing.Trace]
  steps: int                           # traced steps
  enqueue_ms: Optional[List[float]]    # host clock, the untraced window
  flops: List[float]                   # required FLOPs of each traced step
  kernel1: List[tuple]   # (n valid entries, u distinct rows) of each of
                         # kernel 1's lists in the traced steps
  dim: int


def card() -> Optional[str]:
  """``name, power.limit`` of the first card, as nvidia-smi prints it."""
  try:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout
  except (OSError, subprocess.SubprocessError):
    return None
  return out.strip().splitlines()[0] if out.strip() else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float) -> dict:
  """One run: the result line's object (``correct``, ``attempted``,
  ``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and
  ``checks`` last). On a CPU device (the tests) nothing is timed: every
  metric is left out and the rest of the run is driven as on the card."""
  on_card = device.type == 'cuda'
  prep = prepare(cell, seed, device)
  setup_s = time.perf_counter() - t0
  first = CHECK_STEPS + WARMUP_STEPS
  metrics: Dict[str, dict] = {}
  dev_extra: Dict[str, float] = {}
  breakdown = None
  if on_card:
    # The traced run's untraced window only feeds per-layer metrics.
    win = window.run(prep.step, prep.state, prep.batch_of, first,
                     min(seconds, TRACED_RUN_WINDOW_S) if trace else seconds,
                     device)
    attempted, failed = win.steps, win.nonfinite
    print(f'portbench: window {win.steps} steps in {win.seconds:.3f} s; '
          f'step ms p50 {window.percentile(win.gaps_ms, 0.5):.3f} p95 '
          f'{window.percentile(win.gaps_ms, 0.95):.3f} max '
          f'{max(win.gaps_ms):.3f}; enqueue ms p50 '
          f'{window.percentile(win.enqueue_ms, 0.5):.3f} p95 '
          f'{window.percentile(win.enqueue_ms, 0.95):.3f}; gc ms by '
          f'generation {[round(x, 1) for x in win.gc_ms]}; set-up '
          f'{setup_s:.3f} s', file=sys.stderr)
  else:
    win = None
    for i in range(first, first + 2):
      prep.state, _ = prep.step(prep.state, prep.batch_of(i))
    attempted, failed = 2, 0
  if trace:
    start = first + attempted

    def warm():
      for i in range(3):
        prep.state, _ = prep.step(prep.state, prep.batch_of(start + i))
      _sync(device)

    def traced():
      for i in range(TRACE_STEPS):
        prep.state, _ = prep.step(prep.state,
                                  prep.batch_of(start + 3 + i))
      return TRACE_STEPS

    tr = tracing.capture(traced, warm, device)
    if tr is not None and not tr.ops:
      tr = None
    steps = [start + 3 + i for i in range(TRACE_STEPS)]
    r = Reading(tr, TRACE_STEPS, win.enqueue_ms if win else None,
                [cell.mod.flops(cell.cfg, prep.batch_of(i)) for i in steps],
                [nu for i in steps for nu in _kernel1_lists(cell, prep, i)],
                cell.cfg['embedding_dim'])
    for m in cell.per_layer:
      value = cell.readers[m['name']].read(r)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
    if tr is not None:
      dev_extra = {'busy_s': tr.busy_s(), 'window_s': tr.window_s}
      breakdown = {'device_ops': tr.top_ops(), 'idle_gaps': tr.idle_gaps()}
  elif win is not None:
    n = cell.traffic['pool_batches']
    per = [cell.mod.flops(cell.cfg, prep.batch_of(i)) for i in range(n)]
    flops = sum(per[(win.first + i) % n] for i in range(win.steps))
    e2e = {'examples_per_s':
               win.steps * cell.traffic['batch_per_chip'] / win.seconds,
           'mfu': 100.0 * flops / win.seconds / peaks.F32_FLOP_PER_S,
           'setup_s': setup_s}
    for m in cell.end_to_end:
      metrics[m['name']] = {'value': e2e[m['name']], 'unit': m['unit']}
  peak = torch.cuda.max_memory_allocated(device) if on_card else 0
  snap, batches, tower0 = prep.snap, prep.check_batches, prep.tower0
  del prep
  _free(device)
  gaps = judge(cell, seed, snap, batches, tower0, device)
  correct = check.judge(gaps, cell.limits) and failed == 0
  dev = {'platform': 'gpu' if on_card else 'cpu',
         'kind': torch.cuda.get_device_name(device) if on_card else 'cpu',
         'count': cell.chips, 'memory_peak_bytes': peak, **dev_extra}
  out = {'correct': correct, 'attempted': attempted, 'failed': failed,
         'metrics': metrics, 'device': dev}
  if breakdown is not None:
    out['breakdown'] = breakdown
  out['checks'] = {name: {'value': gaps[name][0],
                          'limit': cell.limits.get(name),
                          'worst': gaps[name][1]}
                   for name in check.NUMBERS}
  return out


def forbidden_modules() -> List[str]:
  """The loaded modules whose top-level name is JAX's or the JAX
  package's, compared whole."""
  return sorted({m for m in sys.modules if m.split('.')[0] in FORBIDDEN})


__all__ = ['Cell', 'Prepared', 'Reading', 'card', 'forbidden_modules',
           'judge', 'load_cell', 'prepare', 'run_cell']
