"""The measured window: steps enqueued back to back between CUDA events.

The event pattern is a frozen copy of the port's
``benchmarks/train_benchmark.py:time_steps``: the device idle before the
first mark, an event recorded after every step, a synchronize after the
last. It reports the whole window (every step, all of its time), not a
best window or a median of windows. The loss is read to the host once
every ``READ_EVERY`` steps, as a logging hook would, and at no other
time.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Callable, List

import torch

READ_EVERY = 100


@dataclasses.dataclass
class Window:
  steps: int
  seconds: float            # host clock, idle device to the last step's end
  gaps_ms: List[float]      # CUDA-event time of each step
  enqueue_ms: List[float]   # host clock around each step(...) call
  first: int                # the pool index of the first step
  nonfinite: int            # losses read that were not finite
  gc_ms: List[float]        # host ms in the collector, by generation


def run(step: Callable, state, batch_of: Callable[[int], dict], first: int,
        seconds: float, device: torch.device) -> Window:
  """Steps on ``batch_of(first)``, ``batch_of(first + 1)``, ... for
  ``seconds`` of host time, then a synchronize."""
  def mark():
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event

  gc_ms = [0.0, 0.0, 0.0]
  gc_t0 = [0.0]

  def on_gc(phase, info):
    if phase == 'start':
      gc_t0[0] = time.perf_counter()
    else:
      gc_ms[info['generation']] += (time.perf_counter() - gc_t0[0]) * 1e3

  torch.cuda.synchronize(device)
  gc.callbacks.append(on_gc)
  marks, enqueue = [mark()], []
  nonfinite = 0
  t0 = time.perf_counter()
  i = 0
  while True:
    b = batch_of(first + i)
    e0 = time.perf_counter()
    state, metrics = step(state, b)
    enqueue.append((time.perf_counter() - e0) * 1e3)
    marks.append(mark())
    i += 1
    done = time.perf_counter() - t0 >= seconds
    if i % READ_EVERY == 0:
      nonfinite += not math.isfinite(float(metrics['loss']))
    if done:
      break
  torch.cuda.synchronize(device)
  wall = time.perf_counter() - t0
  gc.callbacks.remove(on_gc)
  gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
  return Window(i, wall, gaps, enqueue, first, nonfinite, gc_ms)


def percentile(values: List[float], q: float) -> float:
  """The ``q`` quantile (0..1) of ``values``, linear between ranks."""
  s = sorted(values)
  pos = q * (len(s) - 1)
  lo = int(math.floor(pos))
  hi = min(lo + 1, len(s) - 1)
  return s[lo] + (s[hi] - s[lo]) * (pos - lo)


__all__ = ['READ_EVERY', 'Window', 'percentile', 'run']
