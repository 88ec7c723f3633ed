"""Replica-synchronized stopping and padding across the ranks of a world.

Counterpart of ``hybridbackend_tpu/data/sync.py:49-331``
(``SyncReplicasIterator``, ``SYNC_VALID_KEY``). Every step the ranks
exchange ``(has_data, rows)``, so that all of them stop together and no
collective of a step waits for a rank that has left:

* train mode (``drop_remainder=True``): batches pass through untouched,
  and every rank stops as soon as any rank has run out. A rank whose
  batch has another row count than its peers' raises a ``ValueError``
  that names every rank's rows, on every rank, before the step: the
  sparse step's exchanges need equal row counts, and would hang or fail
  deep in a collective otherwise.
* eval mode (``drop_remainder=False``): the ranks go on until all have
  run out. Every batch is padded to the step's largest row count and
  carries the ``_sync_valid`` float32 column (1.0 for a real row, 0.0
  for padding); a rank that has run out makes an all-padding batch from
  its last batch's schema (``_empty_like`` and ``_padded``, JAX
  ``:248-278``). The trainers' metrics take ``_sync_valid`` as example
  weights, which makes them exact under uneven final batches.

The exchange does not run on the process group: with ``prefetch=True``
this iterator runs on ``DeviceIterator``'s producer thread while the
step issues its collectives on the main thread, and two threads' calls
on one group could be ordered differently on different ranks. It goes
through the key-value store the ranks met through (``Context.store``),
as the JAX iterator goes through the coordination service's KV store
(``:54-158``): each rank sets ``<iterator>/<step>/<rank>`` and polls its
peers' keys. The liveness rules are JAX's: a peer that has not posted
its key within ``timeout_ms`` (the JAX option ``data_sync_timeout_ms``,
120 s) raises a ``RuntimeError`` that names it; ``close()`` cancels a
pending wait; each rank deletes its key of step ``s - 2`` at step ``s``
(every peer has read it by then), and its last keys once every rank has
finished the final exchange. Iterator ids come from a counter of the
rank's, so every rank must make its iterators in the same order (the
trainers do: one per ``train``, ``evaluate`` or ``predict`` call).

A 0-d column has no rows to split, pad or hand to a rank: in a world of
more than one rank it is refused with an error that names it, here and
in ``put_batch`` and ``DeviceIterator``. The JAX iterator would fail to
pad it, and its device placement replicates each process's value,
which may differ between processes (ROADMAP queue 3).

In a world of one there is no peer: train batches pass through, and
eval batches carry ``_sync_valid`` ones, as before.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from hybridbackend_tpu_torch.data.dataframe import Value

SYNC_VALID_KEY = '_sync_valid'
DEFAULT_TIMEOUT_MS = 120_000

# One id per iterator, counted per rank; the ranks agree on it as long as
# each makes its iterators in the same order.
_SYNC_IDS: Dict[int, Iterator[int]] = collections.defaultdict(itertools.count)
_LAST_POLL_S = 0.002        # the longest pause between two polls of a key
_FINAL_WAIT_S = 10.0        # the clean-up's wait for the final exchange


class SyncCancelled(Exception):
  """The iterator was closed while its exchange was in flight."""


def wait_for_key(store, key: str, deadline: float, cancel: threading.Event,
                 error: str) -> None:
  """Poll ``store`` until it holds ``key``: :class:`SyncCancelled` once
  ``cancel`` is set, a ``RuntimeError`` with the message ``error`` past
  ``deadline`` (``time.monotonic()``)."""
  pause = 0.0
  while not store.check([key]):
    if cancel.is_set():
      raise SyncCancelled()
    if time.monotonic() > deadline:
      raise RuntimeError(error)
    time.sleep(pause)
    pause = min(_LAST_POLL_S, 2 * pause + 1e-4)


def _rows(col: Any) -> int:
  if isinstance(col, Value):
    return col.batch_size
  return len(col)


def _batch_rows(batch: Mapping[str, Any]) -> int:
  for col in batch.values():
    return _rows(col)
  return 0


def check_columns(batch: Mapping[str, Any], world_size: int) -> None:
  """Refuse a 0-d column in a world of more than one rank: it carries no
  batch axis, so a rank's value cannot be split, padded or told apart
  from its peers'."""
  if world_size <= 1:
    return
  for k, v in batch.items():
    if not isinstance(v, Value) and getattr(v, 'ndim', np.ndim(v)) == 0:
      raise ValueError(
          f'batch column {k!r} is 0-d: in a world of {world_size} ranks '
          'every column needs a batch axis (each rank holds its own rows); '
          'give it one, or drop it')


def _pad_column(col: Any, target: int) -> Any:
  """``col`` extended to ``target`` rows with empty or zero rows
  (``_pad_column``, JAX ``:161-174``)."""
  extra = target - _rows(col)
  if extra == 0:
    return col
  if isinstance(col, Value):
    splits = list(col.row_splits)
    s0 = splits[0]
    splits[0] = np.concatenate([s0, np.full((extra,), s0[-1], np.int64)])
    return Value(col.values, splits)
  if isinstance(col, torch.Tensor):
    return torch.cat([col, col.new_zeros((extra,) + tuple(col.shape[1:]))])
  arr = np.asarray(col)
  return np.concatenate([arr, np.zeros((extra,) + arr.shape[1:], arr.dtype)])


def _empty_like(template: Mapping[str, Any], target: int) -> Dict[str, Any]:
  """A ``target``-row batch of ``template``'s schema with no valid row:
  ragged columns get empty rows, dense columns zero rows (a ``*_mask``
  column bool), ``_sync_valid`` zeros (JAX ``:248-264``)."""
  out: Dict[str, Any] = {}
  for k, v in template.items():
    if k == SYNC_VALID_KEY:
      continue
    if isinstance(v, Value):
      splits = [np.zeros(target + 1, np.int64)]
      splits += [np.zeros(1, np.int64) for _ in range(v.ragged_rank - 1)]
      out[k] = Value(np.zeros((0,) + v.values.shape[1:], v.values.dtype),
                     splits)
    elif isinstance(v, torch.Tensor):
      dtype = torch.bool if k.endswith('_mask') else v.dtype
      out[k] = torch.zeros((target,) + tuple(v.shape[1:]), dtype=dtype)
    else:
      arr = np.asarray(v)
      dtype = np.bool_ if k.endswith('_mask') else arr.dtype
      out[k] = np.zeros((target,) + arr.shape[1:], dtype)
  out[SYNC_VALID_KEY] = np.zeros((target,), np.float32)
  return out


def _padded(batch: Mapping[str, Any], target: int) -> Dict[str, Any]:
  """``batch`` padded to ``target`` rows, with its ``_sync_valid``
  (JAX ``:266-278``)."""
  out = {k: _pad_column(v, target) for k, v in batch.items()
         if k != SYNC_VALID_KEY}
  valid = np.zeros((target,), np.float32)
  valid[:_batch_rows(batch)] = 1.0
  out[SYNC_VALID_KEY] = valid
  return out


class SyncReplicasIterator:
  """Wraps a rank's host batch iterator with stopping (and, in eval mode,
  padding) agreed with every rank of ``ctx``'s world; see the module
  docstring.

  Args:
    iterator: this rank's host batches (dicts of numpy arrays, CPU
      tensors or ragged ``Value`` columns).
    drop_remainder: ``True`` (train) stops every rank when any runs out;
      ``False`` (eval) goes on until all have, padding.
    ctx: the world; a world of one when None. A world of more than one
      rank needs the store a joined context carries.
    timeout_ms: how long a rank waits for a peer's count before it
      raises an error naming that peer.
  """

  def __init__(self, iterator: Iterator[Mapping[str, Any]],
               drop_remainder: bool = True, ctx=None,
               timeout_ms: int = DEFAULT_TIMEOUT_MS):
    self._it = iter(iterator)
    self._drop_remainder = drop_remainder
    self._rank = ctx.rank if ctx is not None else 0
    self._world = ctx.world_size if ctx is not None else 1
    self._store = None
    if self._world > 1:
      if ctx.store is None:
        raise ValueError('SyncReplicasIterator in a world of '
                         f'{self._world} ranks needs the store of a joined '
                         'context (Context.join)')
      import torch.distributed as dist
      self._store = dist.PrefixStore('hb_sync', ctx.store)
    self._timeout_s = timeout_ms / 1e3
    self._sid = next(_SYNC_IDS[self._rank])
    self._step_no = 0
    self._template: Optional[Mapping[str, Any]] = None
    self._cancel = threading.Event()
    self._done = False

  def __iter__(self):
    return self

  # -- the exchange ------------------------------------------------------------

  def _key(self, step: int, rank: int) -> str:
    return f'{self._sid}/{step}/{rank}'

  def _exchange(self, step: int, has_data: bool,
                rows: int) -> List[Tuple[bool, int]]:
    """Every rank's ``(has_data, rows)`` at ``step``, in rank order."""
    if self._world == 1:
      return [(has_data, rows)]
    store = self._store
    store.set(self._key(step, self._rank), f'{int(has_data)},{rows}')
    deadline = time.monotonic() + self._timeout_s
    out = []
    for r in range(self._world):
      key = self._key(step, r)
      wait_for_key(self._store, key, deadline, self._cancel,
                   f'SyncReplicasIterator: rank {r} did not reach sync step '
                   f'{step} within {self._timeout_s * 1e3:.0f} ms (this is '
                   f'rank {self._rank}; key {key}). The peer is dead or '
                   'stalled.')
      h, n = store.get(key).decode().split(',')
      out.append((bool(int(h)), int(n)))
    if step >= 2:
      # Every peer has posted step - 1, so has read step - 2.
      self._delete(step - 2)
    return out

  def _delete(self, step: int) -> None:
    try:
      self._store.delete_key(self._key(step, self._rank))
    except Exception:  # noqa: BLE001 — clean-up is best-effort
      pass

  def _finalize(self) -> None:
    """At the agreed end: once every rank has finished the final
    exchange, delete this rank's last keys; the last rank to leave
    deletes the counters."""
    self._done = True
    if self._store is None or self._cancel.is_set():
      return
    store, base = self._store, f'{self._sid}/end'
    store.add(f'{base}/done', 1)
    deadline = time.monotonic() + _FINAL_WAIT_S
    while store.add(f'{base}/done', 0) < self._world:
      if time.monotonic() > deadline or self._cancel.is_set():
        return        # a peer took another way out: leave the keys
      time.sleep(_LAST_POLL_S)
    for s in range(max(0, self._step_no - 2), self._step_no):
      self._delete(s)
    if store.add(f'{base}/left', 1) == self._world:
      for k in ('done', 'left'):
        try:
          store.delete_key(f'{base}/{k}')
        except Exception:  # noqa: BLE001 — clean-up is best-effort
          pass

  def close(self) -> None:
    """Cancel a pending wait (the next ``__next__`` raises
    ``StopIteration``) and delete this rank's remaining keys."""
    self._cancel.set()
    if self._store is not None and not self._done:
      for s in range(max(0, self._step_no - 2), self._step_no + 1):
        self._delete(s)

  # -- iteration ---------------------------------------------------------------

  def __next__(self) -> Dict[str, Any]:
    if self._cancel.is_set() or self._done:
      raise StopIteration
    try:
      batch = next(self._it)
    except StopIteration:
      batch = None
    if batch is not None:
      check_columns(batch, self._world)
    rows = 0 if batch is None else _batch_rows(batch)
    step = self._step_no
    self._step_no += 1
    try:
      states = self._exchange(step, batch is not None, rows)
    except SyncCancelled:
      raise StopIteration from None
    if self._drop_remainder:
      if not all(h for h, _ in states):
        self._finalize()
        raise StopIteration
      if len({n for _, n in states}) > 1:
        # Every rank raises here: end the exchange together first, so that
        # no rank deletes a key that a peer has yet to read.
        self._finalize()
        raise ValueError(
            f'SyncReplicasIterator: train step {step} has '
            + ', '.join(f'{n} rows on rank {r}'
                        for r, (_, n) in enumerate(states))
            + '; every rank of a step needs the same number of rows (the '
            "sharded exchanges split the global batch evenly)")
      return batch  # type: ignore[return-value]
    if not any(h for h, _ in states):
      self._finalize()
      raise StopIteration
    target = max(n for _, n in states)
    if batch is None:
      if self._template is None:
        raise RuntimeError(
            'SyncReplicasIterator: this rank ran out before its first '
            'batch while its peers still have data, so it has no schema to '
            'pad from; every rank needs at least one batch')
      return _empty_like(self._template, target)
    self._template = batch
    return _padded(batch, target)


__all__ = ['DEFAULT_TIMEOUT_MS', 'SYNC_VALID_KEY', 'SyncCancelled',
           'SyncReplicasIterator', 'check_columns', 'wait_for_key']
