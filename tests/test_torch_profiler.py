"""``utils/profiler.py`` on the CPU: ``profile_trace`` around two sparse
steps writes one Chrome trace into its directory, and the trace holds the
step's ``named_scope`` ranges (``hb/lookup``, ``hb/tower``,
``hb/update``), each once a step as a host range, and the ops inside
them; with ``named_scopes=False`` it holds none; a falsy directory
records nothing.
"""

import collections
import functools
import glob
import json
import os

import torch

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb
from hybridbackend_tpu_torch.utils import profiler

CPU = torch.device('cpu')
SCOPES = ('hb/lookup', 'hb/tower', 'hb/update')


def _traced(logdir, **options):
  args = tb.parse_args(['--sparse', '--device', 'cpu', '--tables', '2',
                        '--vocab', '1000', '--batch', '64',
                        '--dense-features', '3'])
  state, step = tb.build(args, CPU, **options)
  batch = functools.partial(tb.shifted, *tb.make_batch(args, CPU), 1000)
  with profiler.profile_trace(logdir) as prof:
    for i in range(2):
      state, _ = step(state, batch(i))
  (path,) = glob.glob(os.path.join(logdir, '*.pt.trace.json'))
  with open(path) as f:
    events = json.load(f)['traceEvents']
  return prof, collections.Counter(
      e.get('name') for e in events if e.get('cat') == 'user_annotation')


def test_trace_holds_the_steps_ranges(tmp_path):
  prof, names = _traced(str(tmp_path))
  assert prof is not None
  assert all(names[s] == 2 for s in SCOPES), {s: names[s] for s in SCOPES}
  assert 'aten::index_select' in {e.key for e in prof.key_averages()}


def test_ranges_off(tmp_path):
  prof, names = _traced(str(tmp_path), named_scopes=False)
  assert not any(names[s] for s in SCOPES)
  assert 'aten::index_select' in {e.key for e in prof.key_averages()}


def test_named_scope_on_its_own_and_no_logdir(tmp_path):
  with profiler.profile_trace(None) as prof:
    with hbt.named_scope('outer', CPU):
      torch.ones(3).sum()
  assert prof is None and not os.listdir(tmp_path)
  with profiler.profile_trace(str(tmp_path / 't')) as prof:
    with hbt.named_scope('outer', CPU):
      torch.ones(3).sum()
  assert 'outer' in {e.key for e in prof.key_averages()}
