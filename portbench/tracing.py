"""The traced window: a ``torch.profiler`` trace of a few steps, read back.

The steps run between two synchronizes inside the range
``portbench/window``; the profiler's Chrome trace is written to a
temporary directory, parsed and deleted. :class:`Trace` holds the device
operations (kernels, copies, sets) that ran inside that window, the
sparse step's ranges (``hb/lookup``, ``hb/tower``, ``hb/update``, opened
by the port) and the host operations, and answers what the per-layer
readers ask: device time by range, kernels by name, busy time, idle
gaps. A trace with no device operation (a CPU run) answers nothing.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = 'portbench/window'
RANGES = ('hb/lookup', 'hb/tower', 'hb/update')
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


@dataclasses.dataclass
class DeviceOp:
  name: str
  cat: str
  ts: float         # us, on the trace's clock
  dur: float        # us
  range: Optional[str]


@dataclasses.dataclass
class Trace:
  window: Tuple[float, float]          # us
  ops: List[DeviceOp]
  host: List[Tuple[float, float, str, str]]   # (ts, end, cat, name)
  steps: int

  @property
  def window_s(self) -> float:
    return (self.window[1] - self.window[0]) / 1e6

  def kernels(self) -> List[DeviceOp]:
    return [op for op in self.ops if op.cat == 'kernel']

  def busy_intervals(self) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the
    window, in order."""
    lo, hi = self.window
    spans = sorted((max(op.ts, lo), min(op.ts + op.dur, hi))
                   for op in self.ops)
    merged: List[List[float]] = []
    for a, b in spans:
      if b <= a:
        continue
      if merged and a <= merged[-1][1]:
        merged[-1][1] = max(merged[-1][1], b)
      else:
        merged.append([a, b])
    return [(a, b) for a, b in merged]

  def busy_s(self) -> float:
    return sum(b - a for a, b in self.busy_intervals()) / 1e6

  def device_s(self, keep: Callable[[DeviceOp], bool]) -> float:
    return sum(op.dur for op in self.ops if keep(op)) / 1e6

  def top_ops(self, n: int = 10) -> List[list]:
    """The ``n`` device operations that took the most time, by name."""
    total: Dict[str, float] = collections.Counter()
    for op in self.ops:
      total[op.name[:160]] += op.dur / 1e6
    return [[k, v] for k, v in total.most_common(n)]

  def idle_gaps(self, n: int = 10) -> List[list]:
    """The ``n`` longest idle gaps of the device inside the window, each
    named by what the host was doing at its middle: the step's range
    and the innermost host operation."""
    lo, hi = self.window
    edges = [lo]
    for a, b in self.busy_intervals():
      edges += [a, b]
    edges.append(hi)
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:n]
    return [[self._host_at((a + b) / 2), g / 1e6] for g, a, b in gaps]

  def _host_at(self, t: float) -> str:
    rng, op, op_len = 'outside the step', 'host', None
    for ts, end, cat, name in self.host:
      if ts <= t <= end:
        if cat == 'user_annotation' and name in RANGES:
          rng = name
        elif cat == 'cpu_op' and (op_len is None or end - ts < op_len):
          op, op_len = name, end - ts
    return f'{rng}: {op}'


def parse(path: str, steps: int) -> Optional[Trace]:
  """The :class:`Trace` of the Chrome trace at ``path``; None when it
  holds no window."""
  with open(path) as f:
    events = [e for e in json.load(f).get('traceEvents', [])
              if e.get('ph') == 'X']
  windows = [e for e in events if e.get('name') == WINDOW
             and e.get('cat') == 'user_annotation']
  if not windows:
    return None
  w = windows[0]
  lo, hi = float(w['ts']), float(w['ts']) + float(w['dur'])
  ranges = sorted((float(e['ts']), float(e['ts']) + float(e['dur']),
                   e['name']) for e in events
                  if e.get('cat') == 'user_annotation'
                  and e.get('name') in RANGES)
  device_ranges = sorted((float(e['ts']), float(e['ts']) + float(e['dur']),
                          e['name']) for e in events
                         if e.get('cat') == 'gpu_user_annotation'
                         and e.get('name') in RANGES)
  launch = {}
  for e in events:
    if e.get('cat') in ('cuda_runtime', 'cuda_driver'):
      corr = e.get('args', {}).get('correlation')
      if corr is not None:
        launch[corr] = float(e['ts'])

  def within(spans, t):
    i = bisect.bisect_right(spans, (t, float('inf'), '')) - 1
    if i >= 0 and spans[i][0] <= t <= spans[i][1]:
      return spans[i][2]
    return None

  ops = []
  for e in events:
    if e.get('cat') not in _DEVICE_CATS:
      continue
    ts, dur = float(e['ts']), float(e.get('dur', 0.0))
    if ts + dur < lo or ts > hi:
      continue
    corr = e.get('args', {}).get('correlation')
    rng = within(ranges, launch[corr]) if corr in launch else None
    if rng is None:
      rng = within(device_ranges, ts)
    ops.append(DeviceOp(e.get('name', ''), e['cat'], ts, dur, rng))
  host = [(float(e['ts']), float(e['ts']) + float(e['dur']), e['cat'],
           e.get('name', '')) for e in events
          if e.get('cat') in ('cpu_op', 'user_annotation')
          and float(e['ts']) <= hi and float(e['ts']) + float(e['dur']) >= lo]
  return Trace((lo, hi), ops, host, steps)


def capture(run_steps: Callable[[], int], warm: Callable[[], None],
            device: torch.device) -> Optional[Trace]:
  """Runs ``run_steps()`` (which returns how many steps it ran) inside
  the window range under the profiler, after ``warm()`` under a profiler
  of its own, which starts the device tracer, and returns the parsed
  trace."""
  from torch.profiler import ProfilerActivity, profile, record_function
  activities = [ProfilerActivity.CPU]
  if device.type == 'cuda':
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities):
    warm()
  with tempfile.TemporaryDirectory() as tmp:
    with profile(activities=activities) as prof:
      if device.type == 'cuda':
        torch.cuda.synchronize(device)
      with record_function(WINDOW):
        steps = run_steps()
        if device.type == 'cuda':
          torch.cuda.synchronize(device)
    path = os.path.join(tmp, 'trace.json')
    prof.export_chrome_trace(path)
    return parse(path, steps)


__all__ = ['RANGES', 'Trace', 'WINDOW', 'capture', 'parse']
