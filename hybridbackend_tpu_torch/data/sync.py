"""Replica-synchronized stopping, for a world of one replica.

Counterpart of ``hybridbackend_tpu/data/sync.py:177-331``
(``SyncReplicasIterator``, ``SYNC_VALID_KEY``) with one replica, the
port's world: there is no peer to agree with, so no batch is ever padded.
In train mode (``drop_remainder=True``) batches pass through untouched
and iteration stops when the source ends. In eval mode
(``drop_remainder=False``) every batch carries the ``_sync_valid``
float32 column of ones, the weights that make ``Trainer.evaluate``'s
metrics exact under padding. The exchange of ``(has_data, rows)``
between processes, and the padding it brings, come with the multi-device
port (ROADMAP queue 1 item 15).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping

import numpy as np

SYNC_VALID_KEY = '_sync_valid'


def _rows(batch: Mapping[str, Any]) -> int:
  for col in batch.values():
    return len(col)
  return 0


class SyncReplicasIterator:
  """Wraps a host batch iterator of the one replica."""

  def __init__(self, iterator: Iterator[Mapping[str, Any]],
               drop_remainder: bool = True):
    self._it = iter(iterator)
    self._drop_remainder = drop_remainder
    self._closed = False

  def __iter__(self):
    return self

  def close(self) -> None:
    """Stop: the next ``__next__`` raises ``StopIteration``."""
    self._closed = True

  def __next__(self) -> Dict[str, Any]:
    if self._closed:
      raise StopIteration
    batch = next(self._it)
    if self._drop_remainder:
      return batch
    out = {k: v for k, v in batch.items() if k != SYNC_VALID_KEY}
    out[SYNC_VALID_KEY] = np.ones((_rows(batch),), np.float32)
    return out


__all__ = ['SYNC_VALID_KEY', 'SyncReplicasIterator']
