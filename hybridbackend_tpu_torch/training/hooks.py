"""Training hooks: step statistics and step- or time-driven callbacks.

Counterpart of ``hybridbackend_tpu/training/hooks.py:21-180`` (``Hook``,
``StepStatHook``, ``Policy``, ``LoggingHook``). Hooks are plain objects
that the ``Trainer`` loop calls around each step. ``SummaryHook`` comes
with ``utils/summary.py`` (ROADMAP).

One change from the reference: ``StepStatHook``'s input-stall part of
each report counts the gets, stalls and waits since the previous report,
not since the start, so a report describes its own window.

In a world of more than one rank (a joined process group) every rank
runs its hooks, and rank 0 alone writes their reports and logs, as the
JAX package's chief does; a ``Policy``'s callback runs on every rank.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

LOG = logging.getLogger('hybridbackend_tpu_torch')


def _chief() -> bool:
  """Whether this process reports: rank 0 of a joined world, or a
  process in no world."""
  import torch.distributed as dist
  return not (dist.is_available() and dist.is_initialized()) or (
      dist.get_rank() == 0)


class Hook:
  """Training-loop hook interface."""

  def begin(self) -> None:
    pass

  def before_step(self, step: int) -> None:
    pass

  def after_step(self, step: int, metrics: Dict[str, Any]) -> None:
    pass

  def end(self, step: int) -> None:
    pass


class StepStatHook(Hook):
  """Step-time and throughput percentiles.

  The step enqueues work on the device and returns: the host clock around
  it measures the enqueue. Every ``sync_every_n`` steps the hook waits
  for the device (``torch.cuda.synchronize`` on a CUDA metric) and
  records the wall time of that window over its steps; the per-step
  enqueue times are kept as well. Warmup steps enter no window.
  """

  def __init__(self, batch_size: Optional[int] = None,
               every_n_steps: int = 100, warmup_steps: int = 1,
               sync_every_n: int = 20,
               log: Callable[[str], None] = LOG.info):
    self._batch_size = batch_size
    self._every_n = every_n_steps
    self._warmup = warmup_steps
    self._sync_n = max(1, sync_every_n)
    self._log = log
    self._durations: list = []
    self._synced: list = []           # secs/step of each synced window
    self._count = 0
    self._prev: Optional[float] = None
    self._window_t0: Optional[float] = None
    self._window_n = 0
    self._input_it = None
    self._stalls_reported: Optional[Dict[str, float]] = None

  def set_input_iterator(self, it) -> None:
    """Attach the feeding ``DeviceIterator``, so reports tell input
    stalls from slow steps."""
    self._input_it = it
    self._stalls_reported = None

  @property
  def synced_secs_per_step(self) -> np.ndarray:
    return np.asarray(self._synced)

  @property
  def input_stall_stats(self) -> Optional[Dict[str, float]]:
    """The attached iterator's ``stall_stats`` (totals), or None."""
    return getattr(self._input_it, 'stall_stats', None)

  def before_step(self, step: int) -> None:
    self._prev = time.perf_counter()
    if self._window_t0 is None:
      self._window_t0 = self._prev

  @staticmethod
  def _sync(metrics: Dict[str, Any]) -> None:
    for v in metrics.values():
      if isinstance(v, torch.Tensor):
        if v.is_cuda:
          torch.cuda.synchronize(v.device)
        return

  def after_step(self, step: int, metrics: Dict[str, Any]) -> None:
    if self._prev is None:
      return
    dt = time.perf_counter() - self._prev  # before any sync wait
    self._count += 1
    if self._count <= self._warmup:
      self._window_t0 = None
      self._window_n = 0
      return
    self._window_n += 1
    if self._window_n >= self._sync_n:
      self._sync(metrics)
      now = time.perf_counter()
      if self._window_t0 is not None:
        self._synced.append((now - self._window_t0) / self._window_n)
      self._window_t0 = None
      self._window_n = 0
    self._durations.append(dt)
    if self._every_n and len(self._durations) % self._every_n == 0:
      self._report()

  def _stall_window(self) -> Optional[Dict[str, float]]:
    """The iterator's counts since the previous report."""
    stats = self.input_stall_stats
    if stats is None:
      return None
    last = self._stalls_reported or {'gets': 0, 'stalls': 0, 'stall_s': 0.0}
    self._stalls_reported = dict(stats)
    window = {k: stats[k] - last[k] for k in ('gets', 'stalls', 'stall_s')}
    window['stall_fraction'] = window['stalls'] / max(window['gets'], 1)
    return window

  def _report(self) -> None:
    if not self._durations or not _chief():
      return
    d = np.asarray(self._durations)
    p10, p50, p90 = np.percentile(d, [10, 50, 90])
    msg = (f'dispatch secs/step: p10={p10:.4f} p50={p50:.4f} '
           f'p90={p90:.4f}')
    if self._synced:
      s = float(np.median(self._synced))
      msg = f'secs/step (synced): {s:.4f}, ' + msg
      if self._batch_size:
        msg += f', samples/sec={self._batch_size / s:,.0f}'
    elif self._batch_size:
      msg += f', samples/sec p50={self._batch_size / p50:,.0f}'
    stats = self._stall_window()
    if stats is not None:
      msg += (f", input stalls {stats['stalls']}/{stats['gets']} "
              f"({100.0 * stats['stall_fraction']:.1f}%, "
              f"{stats['stall_s']:.2f}s waited) since the last report")
    self._log(msg)

  def end(self, step: int) -> None:
    self._report()


class Policy(Hook):
  """Call ``callback(step, metrics)`` every N steps and/or T seconds."""

  def __init__(self, callback: Callable[[int, Dict[str, Any]], None],
               every_n_steps: Optional[int] = None,
               every_n_secs: Optional[float] = None):
    if every_n_steps is None and every_n_secs is None:
      raise ValueError('Policy needs every_n_steps and/or every_n_secs')
    self._cb = callback
    self._every_n = every_n_steps
    self._every_s = every_n_secs
    self._last_t = time.time()

  def after_step(self, step: int, metrics: Dict[str, Any]) -> None:
    fire = False
    if self._every_n and step > 0 and step % self._every_n == 0:
      fire = True
    if self._every_s and (time.time() - self._last_t) >= self._every_s:
      fire = True
    if fire:
      self._last_t = time.time()
      self._cb(step, metrics)


class LoggingHook(Policy):
  """Log the loss and metrics every N steps (a read of the device then)."""

  def __init__(self, every_n_steps: int = 100,
               log: Callable[[str], None] = LOG.info):
    def _cb(step, metrics):
      if not _chief():
        return
      parts = []
      for k, v in sorted(metrics.items()):
        try:
          value = (float(v.detach().to(torch.float32).mean())
                   if isinstance(v, torch.Tensor)
                   else float(np.asarray(v).mean()))
        except (TypeError, ValueError):
          continue
        parts.append(f'{k}={value:.5f}')
      log(f'step {step}: ' + ', '.join(parts))
    super().__init__(_cb, every_n_steps=every_n_steps)


__all__ = ['Hook', 'StepStatHook', 'Policy', 'LoggingHook']
