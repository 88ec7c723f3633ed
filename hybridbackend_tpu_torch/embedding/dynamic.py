"""Dynamic (hash-table) embeddings: DeepRec EmbeddingVariable parity.

Counterpart of ``hybridbackend_tpu/embedding/dynamic.py:33-198``. The
device table has a static capacity; the id-to-row map lives on the host,
where the input path touches every id anyway. Raw (unbounded int64) ids
take rows in first-touch order, behind an optional admission filter (an
id must be seen ``min_count`` times before it gets a row); an id without
a row maps to -1, which every lookup reads as zeros and the sparse
update skips.

``map_ids`` runs on host batches, for example as a
``DeviceIterator(transform=...)``; the table itself is an ordinary table
of ``capacity`` rows (``DynamicEmbedding.config``).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import numpy as np

from hybridbackend_tpu_torch.embedding.table import TableConfig
from hybridbackend_tpu_torch.native import idmap


class IdMapper:
  """Host-side growing map from raw int64 ids to dense table rows.

  By default it runs in the port's native hash
  (:class:`hybridbackend_tpu_torch.native.idmap.NativeIdMap`), and raises
  where that library cannot be built. ``native=False`` takes the NumPy
  path, which gives the same rows and state bit for bit: it touches each
  unique id of a batch once.
  """

  def __init__(self, capacity: int, min_count: int = 1, native: bool = True):
    self.capacity = int(capacity)
    self.min_count = int(min_count)
    self._native = (idmap.native_idmap(min(self.capacity, 1 << 20))
                    if native else None)
    self._map: Dict[int, int] = {}      # NumPy path only
    self._counts: Counter = Counter()   # NumPy path only
    self._next = 0

  @property
  def native(self) -> bool:
    return self._native is not None

  @property
  def size(self) -> int:
    """Rows assigned so far."""
    return self._next

  def map_ids(self, ids: np.ndarray, train: bool = True) -> np.ndarray:
    """Raw ids to rows (int64, the ids' shape); an id without a row maps
    to -1. ``train=False`` only reads: it admits nothing and counts no
    sighting."""
    ids = np.asarray(ids)
    if self._native is not None:
      if train:
        rows, self._next = self._native.train_lookup(
            ids.reshape(-1), self.capacity, self._next,
            min_count=self.min_count)
      else:
        rows = self._native.lookup(ids.reshape(-1))
      return rows.astype(np.int64).reshape(ids.shape)
    return self._map_ids_numpy(ids, train)

  def _map_ids_numpy(self, ids: np.ndarray, train: bool) -> np.ndarray:
    """The native map's semantics: rows in first-touch occurrence order
    (not sorted-id order), and with ``min_count`` only the admitting
    occurrence and later ones in the batch take the row. Dict cost is in
    unique ids, not occurrences."""
    shape = ids.shape
    flat = ids.reshape(-1)
    uniq, inverse = np.unique(flat, return_inverse=True)
    inverse = inverse.reshape(-1)
    counts = np.bincount(inverse, minlength=len(uniq))
    order = np.argsort(inverse, kind='stable')
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    known = np.asarray([self._map.get(int(u), -1) for u in uniq], np.int64)
    out = known[inverse]
    if not train:
      return out.reshape(shape)
    # Candidate admissions, in the order of their admitting occurrence
    # (the native map's per-occurrence order).
    events = []
    for j in np.nonzero(known < 0)[0]:
      u = int(uniq[j])
      occ = int(counts[j])
      if self.min_count > 1:
        need = self.min_count - self._counts[u]
        if occ < need:
          self._counts[u] += occ
          continue
        adm_rank = need - 1
      else:
        adm_rank = 0
      events.append((int(order[starts[j] + adm_rank]), j, adm_rank))
    for _, j, adm_rank in sorted(events):
      u = int(uniq[j])
      if self._next >= self.capacity:
        # Full: the id stays cold, its count parked just below the
        # threshold so that its next sighting tries again (as native).
        if self.min_count > 1:
          self._counts[u] = self.min_count - 1
        continue
      row = self._next
      self._next += 1
      self._map[u] = row
      if self.min_count > 1:
        self._counts.pop(u, None)
      grp = order[starts[j]:starts[j] + counts[j]]
      out[grp[adm_rank:]] = row   # the admitting occurrence onward
      out[grp[:adm_rank]] = -1    # earlier occurrences stay cold
    return out.reshape(shape)

  def state_dict(self) -> Dict[str, np.ndarray]:
    """The map as arrays (saved beside the table): admitted ``ids`` and
    ``rows`` sorted by id, the pending admissions' ``pending_ids`` and
    ``pending_counts`` sorted by id, and ``next``. A resumed map admits
    an id at the same sighting as an uninterrupted one."""
    if self._native is not None:
      ids_a, vals_a = self._native.items_all()
      adm = vals_a >= 0
      ids_adm, rows_adm = ids_a[adm], vals_a[adm]
      ids_pen = ids_a[~adm]
      counts_pen = (-1 - vals_a[~adm]).astype(np.int64)
      order = np.argsort(ids_adm)
      po = np.argsort(ids_pen)
      return {'ids': ids_adm[order].astype(np.int64),
              'rows': rows_adm[order].astype(np.int64),
              'pending_ids': ids_pen[po].astype(np.int64),
              'pending_counts': counts_pen[po],
              'next': np.asarray([self._next], np.int64)}
    items = np.asarray(sorted(self._map.items()), np.int64).reshape(-1, 2)
    pend = np.asarray(sorted(self._counts.items()), np.int64).reshape(-1, 2)
    return {'ids': items[:, 0], 'rows': items[:, 1],
            'pending_ids': pend[:, 0], 'pending_counts': pend[:, 1],
            'next': np.asarray([self._next], np.int64)}

  @classmethod
  def from_state_dict(cls, capacity: int, state: Dict[str, np.ndarray],
                      min_count: int = 1, native: bool = True
                      ) -> 'IdMapper':
    m = cls(capacity, min_count, native=native)
    pend_ids = np.asarray(state.get('pending_ids', ()), np.int64)
    pend_counts = np.asarray(state.get('pending_counts', ()), np.int64)
    if m._native is not None:
      m._native.set(np.asarray(state['ids'], np.int64),
                    np.asarray(state['rows'], np.int32))
      if pend_ids.size:
        # The native encoding of a pending count c: -1 - c.
        m._native.set(pend_ids, (-1 - pend_counts).astype(np.int32))
    else:
      m._map = {int(i): int(r) for i, r in zip(state['ids'], state['rows'])}
      m._counts.update({int(i): int(c)
                        for i, c in zip(pend_ids, pend_counts)})
    m._next = int(state['next'][0])
    return m


class DynamicEmbedding:
  """A static-capacity table and a host :class:`IdMapper`: an embedding
  over an open id space. ``config`` declares the table (``capacity``
  rows) to a feature extractor; ``transform(column)`` maps a batch's raw
  ids to its rows::

      dyn = DynamicEmbedding('user_id', capacity=1_000_000, dim=32)
      fx = StackedFeatureExtractor([EmbeddingSpec(dyn.config, 'user_id')],
                                   ctx=ctx)
      it = DeviceIterator(batches, device, transform=dyn.transform(
          'user_id'))
  """

  def __init__(self, name: str, capacity: int, dim: int,
               min_count: int = 1, **config_kwargs):
    self.config = TableConfig(name, capacity, dim, **config_kwargs)
    self.mapper = IdMapper(capacity, min_count=min_count)

  def transform(self, column: str, train: bool = True):
    """A host-batch transform that maps ``column``'s raw ids to rows
    (``train=False``: read-only, for evaluation and prediction)."""
    def _apply(batch):
      batch = dict(batch)
      batch[column] = self.mapper.map_ids(batch[column], train=train)
      return batch
    return _apply


__all__ = ['DynamicEmbedding', 'IdMapper']
