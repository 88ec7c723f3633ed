"""Asynchronous host-to-device prefetching.

Counterpart of ``hybridbackend_tpu/data/prefetch.py:35-211``
(``DeviceIterator``, ``_put_batch``) at a world of one device. A
background thread pulls host batches (dicts of numpy arrays or CPU
tensors) from the source iterator into a bounded queue, so reading and
decoding overlap the steps; the consumer places each batch on the device
one step ahead of its use, so the copy overlaps the step before.

Placement runs on the consumer's thread, as the JAX iterator's does with
``producer_put=False``: the step's own enqueue is host-bound, and every
stretch for which a second thread holds the interpreter lock (a numpy
copy of the batch into its staging buffer, the calls around it) is a
stretch the step waits to get it back. The producer only waits on its
source and on the queue.

The columns of one dtype are laid end to end in one host buffer and
copied to the device in one piece; the batch handed out holds views of
the copy, shaped as the columns (26 id columns and 14 float columns are
two copies, not forty). On a CUDA device the host buffers are pinned and
each copy is a ``non_blocking`` one on a side stream of the iterator's
own, followed by an event. The consumer's stream waits on that event
before it uses the batch (a wait on the device, not on the host), and
each device buffer is marked with ``record_stream`` for the consumer's
stream, so the allocator does not hand its memory to the next copy while
a step still reads it. The pinned buffers stay referenced until their
copy's event has completed. On a CPU device the buffers are plain, and
the batch is a copy of the source's arrays, never a view of them.

Batches may come straight from ``ParquetDataset``: numeric columns that
are read-only views of the reader's buffers (the native reader's are
kept alive by a token each array refers to). Both paths only read them:
``DeviceIterator`` copies each into its staging buffer on the host before
any device copy is issued, and ``put_batch``'s ``.to`` of pageable memory
returns once its copy has completed, while the batch is still referenced.
A ragged ``Value`` or a string column has no device layout of its own;
both paths refuse it with an error that points at ``data.parse``. In a
world of more than one rank (``world_size``) both refuse a 0-d column,
which has no batch axis to hold the rank's rows (``data/sync.py``).
"""

from __future__ import annotations

import collections
import contextlib
import queue as _queue
import threading
import time as _time
import warnings
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from hybridbackend_tpu_torch.data.dataframe import Value
from hybridbackend_tpu_torch.data.sync import check_columns

Batch = Dict[str, torch.Tensor]


def _host_array(name: str, value: Any) -> np.ndarray:
  """``value`` as a numeric numpy array; a ragged or string column is
  refused with the way to convert it."""
  if isinstance(value, Value):
    raise TypeError(
        f'column {name!r} is a ragged Value, which no device tensor holds: '
        'convert the batch with hybridbackend_tpu_torch.data.parse(batch, '
        'fields) first (padded values and a mask)')
  a = np.asarray(value)
  if a.dtype == object or a.dtype.kind in 'SU':
    raise TypeError(
        f'column {name!r} holds strings ({a.dtype}), which no device tensor '
        'holds and data.parse passes through unchanged: drop the column or '
        'map it to ids before the batch is placed')
  return a


def _host_tensor(name: str, value: Any) -> torch.Tensor:
  if isinstance(value, torch.Tensor):
    return value
  a = np.ascontiguousarray(_host_array(name, value))
  if a.flags.writeable:
    return torch.from_numpy(a)
  # A read-only view of a reader's buffers: the tensor made here is only
  # read (copied to the device, or on the CPU read by the step), so
  # torch's warning that it could be written through does not apply.
  with warnings.catch_warnings():
    warnings.filterwarnings('ignore', 'The given NumPy array is not writable',
                            UserWarning)
    return torch.from_numpy(a)


def put_batch(batch: Mapping[str, Any], device: torch.device,
              world_size: int = 1) -> Batch:
  """Every column of ``batch`` as a tensor on ``device`` (a plain
  synchronous ``.to``: from pageable host memory it returns once the copy
  has completed). On the CPU the tensors share memory with the batch's
  arrays, and keep them alive. In a world of ``world_size > 1`` ranks a
  0-d column is refused."""
  check_columns(batch, world_size)
  return {k: _host_tensor(k, v).to(device) for k, v in batch.items()}


class _Staged:
  """A batch whose copies were issued: its columns (views of ``bases``,
  one device buffer per dtype), the event recorded after the copies on a
  CUDA device, and the host buffers they were copied from."""

  def __init__(self, tensors: Batch, bases, done, host):
    self.tensors, self.bases, self.done, self.host = (tensors, bases, done,
                                                      host)


class DeviceIterator:
  """Iterates device-resident batches with background prefetch.

  Bounded by ``capacity`` host batches queued ahead of the consumer, and
  one more placed on the device ahead of the one handed out; ``close``
  cancels the producer, also one blocked on a full queue; an exception
  raised by the source iterator in the producer is re-raised at
  ``__next__``. ``stall_stats`` counts the ``__next__`` calls that found
  the queue empty and the seconds they waited.

  ``transform`` (a host batch to a host batch) runs on the producer's
  thread, before the batch is queued, as the JAX iterator's does: for
  example ``DynamicEmbedding.transform`` or ``CacheRunner.transform``,
  which map raw ids to rows or cache slots ahead of the steps. In a
  world of ``world_size > 1`` ranks a 0-d column is refused at
  ``__next__``.
  """

  def __init__(self, host_iterator: Iterator[Mapping[str, Any]],
               device: torch.device, capacity: int = 2,
               transform: Optional[Callable[[Mapping[str, Any]],
                                            Mapping[str, Any]]] = None,
               world_size: int = 1):
    self._device = torch.device(device)
    self._world_size = world_size
    self._capacity = capacity
    self._q: _queue.Queue = _queue.Queue(maxsize=capacity)
    self._stop = threading.Event()
    self._inner = host_iterator
    self._transform = transform
    self._cuda = self._device.type == 'cuda'
    self._stream = torch.cuda.Stream(self._device) if self._cuda else None
    self._ahead: Optional[_Staged] = None   # placed, not yet handed out
    self._ended = False
    self._error: Optional[BaseException] = None
    self._in_flight: collections.deque = collections.deque()
    self.gets = 0
    self.stalls = 0
    self.stall_s = 0.0
    self._thread = threading.Thread(
        target=self._producer, args=(iter(host_iterator),), daemon=True)
    self._thread.start()

  @property
  def stall_stats(self) -> Dict[str, float]:
    """``{'gets', 'stalls', 'stall_s', 'stall_fraction'}`` since the start
    or the last :meth:`reset_stall_stats`."""
    return {'gets': self.gets, 'stalls': self.stalls,
            'stall_s': self.stall_s,
            'stall_fraction': self.stalls / max(self.gets, 1)}

  def reset_stall_stats(self) -> None:
    """Start the stall counts anew (for example after warmup steps)."""
    self.gets, self.stalls, self.stall_s = 0, 0, 0.0

  def _producer(self, it):
    try:
      for batch in it:
        if self._transform is not None:
          batch = self._transform(batch)
        while not self._stop.is_set():
          try:
            self._q.put(batch, timeout=0.1)
            break
          except _queue.Full:
            continue
        if self._stop.is_set():
          return
    except BaseException as e:  # noqa: BLE001 — re-raised at __next__
      self._q.put(e)
      return
    self._q.put(None)

  def _take(self) -> Optional[Mapping[str, Any]]:
    """The next host batch from the queue (None at the end), counted as
    a get, and as a stall when the queue was empty."""
    self.gets += 1
    stalled = False
    waited = 0.0
    try:
      item = self._q.get_nowait()
    except _queue.Empty:
      stalled = True
      t0 = _time.perf_counter()
      item = self._q.get()
      waited = _time.perf_counter() - t0
      self.stalls += 1
      self.stall_s += waited
    if item is None or isinstance(item, BaseException):
      # The end of the stream or a failed producer is no input stall of
      # a step: take the wait back out of the counts.
      self.gets -= 1
      if stalled:
        self.stalls -= 1
        self.stall_s -= waited
      if item is None:
        return None
      raise item
    return item

  def _stage(self, batch: Mapping[str, Any]) -> _Staged:
    check_columns(batch, self._world_size)
    by_dtype: Dict[np.dtype, list] = {}
    for k, v in batch.items():
      a = _host_array(k, v)
      by_dtype.setdefault(a.dtype, []).append((k, a))
    tensors, bases, host, done = {}, [], [], None
    stream = (torch.cuda.stream(self._stream) if self._cuda
              else contextlib.nullcontext())
    with stream:
      for dtype, cols in by_dtype.items():
        sizes = [a.size for _, a in cols]
        buf = torch.empty(sum(sizes), pin_memory=self._cuda,
                          dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
        np.concatenate([a.reshape(-1) for _, a in cols], out=buf.numpy())
        base = buf.to(self._device, non_blocking=self._cuda)
        for (k, a), part in zip(cols, base.split(sizes)):
          tensors[k] = part.view(a.shape)
        bases.append(base)
        host.append(buf)
      if self._cuda:
        done = torch.cuda.Event()
        done.record(self._stream)
    return _Staged(tensors, bases, done, host)

  def __iter__(self):
    return self

  def _place_next(self) -> Optional[_Staged]:
    """The next batch, placed on the device; None at the end. A failure
    of the producer met while looking ahead is raised in its turn."""
    if self._error is not None:
      error, self._error = self._error, None
      raise error
    batch = None if self._ended else self._take()
    if batch is None:
      self._ended = True
      return None
    return self._stage(batch)

  def __next__(self) -> Batch:
    if self._stop.is_set():
      raise StopIteration
    if self._ahead is None:
      self._ahead = self._place_next()
    item = self._ahead
    if item is None:
      raise StopIteration
    # Place the next batch now, so that its copy overlaps this step.
    try:
      self._ahead = self._place_next()
    except BaseException as e:  # noqa: BLE001 — raised at the next call
      self._ahead, self._error = None, e
    if not self._cuda:
      return item.tensors
    stream = torch.cuda.current_stream(self._device)
    stream.wait_event(item.done)
    for base in item.bases:
      base.record_stream(stream)
    # Keep each pinned source alive until its copy has ended.
    self._in_flight.append((item.done, item.host))
    while self._in_flight and self._in_flight[0][0].query():
      self._in_flight.popleft()
    return item.tensors

  def close(self, join: bool = True) -> None:
    """Cancel the producer and drop the queued batches."""
    self._stop.set()
    inner_close = getattr(self._inner, 'close', None)
    if callable(inner_close):
      try:
        inner_close()
      except Exception:  # noqa: BLE001 — teardown is best-effort
        pass
    try:
      while True:
        self._q.get_nowait()
    except _queue.Empty:
      pass
    if join and self._thread.is_alive():
      self._thread.join(timeout=10.0)

  def __del__(self):
    # No join: a finalizer must not wait on a producer blocked in its
    # source iterator.
    try:
      self.close(join=False)
    except Exception:  # noqa: BLE001
      pass


__all__ = ['DeviceIterator', 'put_batch']
