"""Traces and named ranges: ``torch.profiler`` and NVTX.

Counterpart of ``hybridbackend_tpu/utils/profiler.py:1-48``, whose
``profile_trace`` captures a ``jax.profiler`` trace and whose
``named_scope`` (``jax.named_scope``) names a region of the program, the
analogue of the reference's NVTX ranges (``common/profiler.h:28-41``):

* :func:`profile_trace` records a ``torch.profiler`` trace of the host
  and, on a machine with a card, of its kernels, and writes it into a
  directory as a Chrome trace (``*.pt.trace.json``, TensorBoard's
  profiler plugin reads the directory; Perfetto or ``chrome://tracing``
  open the file). It takes the directory as an argument: the JAX
  package's ``HB_PROFILE_DIR`` option has no counterpart.
* :func:`named_scope` opens a ``torch.profiler.record_function`` range
  (seen in a ``torch.profiler`` trace) and, on a CUDA device, an NVTX
  range (seen by Nsight Systems).

The JAX ``dump_hlo`` has no counterpart: the port compiles no HLO.

The sparse step (``training/sparse_step.py``) opens one range for each
of its phases: ``hb/lookup``, ``hb/tower`` and ``hb/update``. JAX's
``named_scope`` is metadata of the compiled program; here a range is
host work in each step, a few microseconds each (``PERF.md`` says what
the flagship step's time does with the ranges on and off).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def named_scope(name: str,
                device: Optional[torch.device] = None) -> Iterator[None]:
  """A range named ``name`` around the block: a ``record_function``
  range, and an NVTX range as well when ``device`` is a CUDA device."""
  nvtx = device is not None and torch.device(device).type == 'cuda'
  with torch.profiler.record_function(name):
    if nvtx:
      torch.cuda.nvtx.range_push(name)
    try:
      yield
    finally:
      if nvtx:
        torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]
                  ) -> Iterator[Optional[torch.profiler.profile]]:
  """Record a ``torch.profiler`` trace of the block, with the CPU
  activity and, where CUDA is available, the CUDA one, and write it into
  ``logdir`` when the block ends, as one Chrome trace named as
  ``torch.profiler.tensorboard_trace_handler`` names its files
  (``<host>_<pid>.<ns>.pt.trace.json``). A range shows there as a
  ``user_annotation`` event, and on the card once more on the device's
  timeline (``gpu_user_annotation``). Yields the profiler (its
  ``key_averages()`` and ``events()`` are there after the block), or
  ``None``, recording nothing, when ``logdir`` is falsy."""
  if not logdir:
    yield None
    return
  os.makedirs(logdir, exist_ok=True)
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  with torch.profiler.profile(activities=activities) as prof:
    yield prof
  prof.export_chrome_trace(os.path.join(
      logdir, f'{socket.gethostname()}_{os.getpid()}.{time.time_ns()}'
      '.pt.trace.json'))


__all__ = ['named_scope', 'profile_trace']
