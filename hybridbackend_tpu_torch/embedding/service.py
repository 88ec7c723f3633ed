"""Device-cached embeddings over host-DRAM tables (EmbeddingService parity).

Counterpart of ``hybridbackend_tpu/embedding/service.py:45-493``. A table
too large for device memory lives in host DRAM (or any store behind
:class:`Storage`), with its optimizer slots beside it; the device holds a
cache of ``capacity`` rows. The id-to-slot map is the port's native hash
on the host input path (``native/idmap.py``), so the device only ever
sees dense slot indices and the train step is the ordinary sparse step
over the cache's rows.

The cache works in two phases:

* **plan** (:meth:`EmbeddingCache.prepare_plan`): host metadata only,
  line for line the JAX package's: the batch's unique ids, their slots
  in the hash, LRU eviction by last use (a stable argsort) that spares
  the slots this batch hits, and the new slots of the misses. The same
  ids give the same plan as JAX. It may run ahead of the steps, in a
  ``DeviceIterator``'s producer thread.
* **apply** (:meth:`EmbeddingCache.apply_plan`): the array effects, in
  plan order, before the step that reads them. Here the port differs
  from JAX, which builds new arrays: the port's state tensors are
  updated in place by its kernels and the step keeps references to
  them, so the apply writes in place into the live tensors (the value
  table and each slot) at ``row_offset + slot``, on the current stream.
  Evicted rows are read with the row gather's kernel (kernel 5,
  ``ops/gather.py``) and copied to the host in one copy per array: that
  copy waits for the device, a sync point on every step that evicts.
  Missed rows are pulled from storage into one host array per table,
  staged in pinned memory, copied to the device in one piece without a
  wait, and written with one ``index_copy_``.

``SparseTrainer(caches=...)`` wires caches in through
:class:`CacheRunner`: ``transform`` plans each batch on the host,
``apply_next`` applies the oldest plan to the live state before each
step (plan order is step order, so an evicted row is read after the
last step that updated it), and ``checkpoint_flush`` / ``flush`` write
the resident rows back (the reference's ``before_apply_gradients`` and
``before_save_checkpoints`` hooks, ``service.py:253-324``).

**A world of N ranks.** JAX plans in one process over the global batch,
and its slot table is row-sharded over the mesh (``:133-144``). The
port's ranks are processes, each with its own rows, so they agree on
one slot map instead of keeping one each (an id would otherwise sit in
different slots on different ranks):

* ``CacheRunner.transform`` exchanges each cached column's ids through
  the key-value store the ranks met through (``Context.store``, never
  the process group: it runs on ``DeviceIterator``'s producer thread
  while the step issues its collectives on the main thread), under
  ``data/sync.py``'s rules: a peer's liveness deadline, each rank
  deleting its key of step ``s - 2`` at step ``s``, cancellation. Every
  rank plans the global batch, the ranks' ids in rank order, and keeps
  its own rows' slots. Slot allocation is deterministic (a stable
  argsort of the last uses), so every rank's metadata stays equal, and
  equal to JAX's; the capacity must hold the global batch's distinct ids.
* The array effects address row ``slot + offset`` of the stacked table.
  On a row-sharded stack each rank writes only its shard's rows (a
  cached member's slots may straddle shard boundaries); on a replicated
  one every rank writes all of them.
* The evicted (and flushed) rows are read by their owners through kernel
  5 and all-gathered on the process group (``apply_next``, ``flush`` and
  ``checkpoint_flush`` run on the main thread, which every rank calls in
  the same order), so that every rank's :class:`Storage` receives every
  row; an upload pulls each owner's missed rows from its own storage.
  The slot map is one LRU over the world: an id evicted from a slot that
  rank 1 owns may come back into a slot of rank 2, whose storage must
  hold its latest row. So every rank holds the whole host table, W
  copies of it over the world; a cache per id owner would plan other
  slots than JAX's.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import pickle
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hybridbackend_tpu_torch.data.sync import DEFAULT_TIMEOUT_MS, wait_for_key
from hybridbackend_tpu_torch.distribute import collective
from hybridbackend_tpu_torch.embedding.table import (
    TableConfig, TableShard, shard_of)
from hybridbackend_tpu_torch.framework.context import Context
from hybridbackend_tpu_torch.native import idmap
from hybridbackend_tpu_torch.ops.gather import gather_rows


class Storage:
  """Row storage behind a cache (the reference's
  ``EmbeddingService.pull/push``, ``service.py:143-149``): implement it
  over any key-value store. Rows are keyed by table row; ``name`` is the
  table (``'value'``, ``'slot0'``, ...)."""

  def pull(self, name: str, keys: np.ndarray) -> np.ndarray:
    """Rows ``keys`` of table ``name``: ``[len(keys), ...]``."""
    raise NotImplementedError

  def push(self, name: str, keys: np.ndarray, values: np.ndarray) -> None:
    """Write rows ``keys`` of table ``name``."""
    raise NotImplementedError


class InMemoryStorage(Storage):
  """The default storage: plain host-DRAM numpy arrays, updated in
  place."""

  def __init__(self, tables: Dict[str, np.ndarray]):
    self.tables = tables

  def pull(self, name, keys):
    return self.tables[name][keys]

  def push(self, name, keys, values):
    self.tables[name][keys] = values


class CachePlan(NamedTuple):
  """The metadata of one batch's :meth:`EmbeddingCache.prepare_plan`.

  Attributes:
    slots: the slot of each input id (the ids' shape), int32.
    evict_slots / evict_ids: rows to write back before the upload.
    miss_slots / miss_ids: rows to pull from storage into the cache.
  """
  slots: np.ndarray
  evict_slots: np.ndarray
  evict_ids: np.ndarray
  miss_slots: np.ndarray
  miss_ids: np.ndarray


def _torch_dtype(dtype) -> torch.dtype:
  return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _staged(a: np.ndarray, device: torch.device) -> torch.Tensor:
  """``a`` on ``device`` in one copy. To a card it goes through a pinned
  buffer, without waiting for the device: the caching host allocator
  keeps the buffer until its copy has run."""
  t = torch.from_numpy(np.ascontiguousarray(a))
  if device.type != 'cuda':
    return t.to(device)
  return t.pin_memory().to(device, non_blocking=True)


class EmbeddingCache:
  """A cache of ``capacity`` device rows over one host table, ``'value'``,
  and the tables aligned with it (optimizer slots, ``'slot0'``, ...), all
  under one slot map.

  Args:
    config: the full table (``vocab_size`` rows in storage).
    capacity: the device rows.
    host_tables: ``{name: [vocab, ...] numpy array}``, ``'value'`` among
      them; or ``storage`` with ``table_shapes`` (``{name: row shape}``)
      and optionally ``table_dtypes`` (float32 by default).
    ctx: the device of the cache's own arrays (:attr:`device`), the card
      unless the caller asks for the CPU, and the world: in a world of
      more than one rank every rank makes the same cache (the same host
      tables), and :attr:`device` is this rank's shard of the slot rows
      when the slot table is sharded and the world divides the capacity
      (JAX ``:133-144``), else every slot row.
    native: the slot map in the native hash; ``False`` takes a dict over
      the unique ids (the same plans).

  ``stats`` counts, since construction: ``planned`` unique ids and
  ``misses`` among them, ``evicted`` and ``uploaded`` rows, the applies
  that evicted (``evict_calls``: each gathers every array once), and the
  host seconds of the plans (``plan_s``), of the evictions' gathers and
  copies to the host (``evict_s``, which includes the wait for the
  device) and of the uploads (``upload_s``).
  """

  def __init__(self, config: TableConfig, capacity: int,
               host_tables: Optional[Dict[str, np.ndarray]] = None,
               storage: Optional[Storage] = None,
               table_shapes: Optional[Dict[str, tuple]] = None,
               table_dtypes: Optional[Dict[str, np.dtype]] = None,
               ctx: Optional[Context] = None, native: bool = True):
    self.config = config
    self._ctx = ctx or Context(torch.device('cuda'))
    if host_tables is None and storage is None:
      raise ValueError('pass host_tables or a Storage')
    if host_tables is not None and storage is not None:
      raise ValueError('pass host_tables OR storage, not both (seed a '
                       'custom Storage with the initial rows instead)')
    if host_tables is not None:
      if 'value' not in host_tables:
        raise ValueError("host_tables must include a 'value' table")
      vocab = host_tables['value'].shape[0]
      for name, t in host_tables.items():
        if t.shape[0] != vocab:
          raise ValueError(
              f'host table {name!r} rows {t.shape[0]} != {vocab}')
      storage = InMemoryStorage(host_tables)
      table_shapes = {n: t.shape[1:] for n, t in host_tables.items()}
      table_dtypes = {n: t.dtype for n, t in host_tables.items()}
    else:
      if not table_shapes or 'value' not in table_shapes:
        raise ValueError("storage mode needs table_shapes with 'value'")
      table_dtypes = {**{n: np.dtype(np.float32) for n in table_shapes},
                      **(table_dtypes or {})}
    self.storage = storage
    self.capacity = int(capacity)
    self.host: Dict[str, np.ndarray] = host_tables or {}
    # The cache's own arrays (standalone use); under SparseTrainer the
    # live arrays are the stacked training table and its slots.
    self._device_shard = (
        shard_of(self.slot_config(), self._ctx)
        if self.capacity % self._ctx.world_size == 0 else None)
    rows = (self.slot_config().shard_rows(self._ctx)
            if self._device_shard is not None else slice(0, self.capacity))
    self.device: Dict[str, torch.Tensor] = {
        name: torch.zeros((rows.stop - rows.start,) + tuple(shape),
                          dtype=_torch_dtype(table_dtypes[name]),
                          device=self._ctx.device)
        for name, shape in table_shapes.items()}
    # Guards all slot metadata (the hash, _slot_to_id, _last_used, the
    # free list): plans run in a prefetch producer thread while
    # lookup_slots (eval) and flush (checkpoints) read from others, and a
    # grow of the hash during a concurrent probe would free what the
    # probe reads.
    self._meta_lock = threading.Lock()
    self._slots = (idmap.native_idmap(min(self.capacity, 1 << 20))
                   if native else None)
    self._fallback: Optional[Dict[int, int]] = None if native else {}
    self._slot_to_id = np.full(self.capacity, -1, np.int64)
    self._last_used = np.zeros(self.capacity, np.int64)
    self._n_free = self.capacity          # slots [n_used:] conceptually
    self._free = np.arange(self.capacity - 1, -1, -1, dtype=np.int64)
    self._step = 0
    self.stats = dict(planned=0, misses=0, evicted=0, uploaded=0,
                      evict_calls=0, plan_s=0.0, evict_s=0.0, upload_s=0.0)

  def slot_config(self) -> TableConfig:
    """The config of the slot space: declare the cached table to a
    feature extractor with it (``vocab = capacity``; slots are dense, so
    the ids are not mixed)."""
    return dataclasses.replace(self.config, vocab_size=self.capacity,
                               shuffle_ids=False)

  @property
  def resident(self) -> int:
    return int((self._slot_to_id >= 0).sum())

  # -- the id -> slot map (native hash, or a dict over unique ids) ---------

  def _lookup_slots(self, uniq: np.ndarray) -> np.ndarray:
    if self._slots is not None:
      return self._slots.lookup(uniq).astype(np.int64)
    return np.asarray([self._fallback.get(int(i), -1) for i in uniq],
                      np.int64)

  def _set_slots(self, ids: np.ndarray, slots: np.ndarray) -> None:
    if self._slots is not None:
      self._slots.set(ids, slots.astype(np.int32))
    else:
      for i, s in zip(ids.tolist(), slots.tolist()):
        self._fallback[int(i)] = int(s)

  def _erase_slots(self, ids: np.ndarray) -> None:
    if self._slots is not None:
      self._slots.erase(ids)
    else:
      for i in ids.tolist():
        self._fallback.pop(int(i), None)

  # -- plan / apply ----------------------------------------------------------

  def prepare_plan(self, ids: np.ndarray) -> CachePlan:
    """Assign slots for ``ids`` (metadata only, no array effect). Safe to
    call from a prefetch producer thread; the plans must be applied in
    the order they were made."""
    t0 = time.perf_counter()
    with self._meta_lock:
      plan = self._prepare_plan_locked(ids)
      self.stats['plan_s'] += time.perf_counter() - t0
    return plan

  def _prepare_plan_locked(self, ids: np.ndarray) -> CachePlan:
    shape = np.asarray(ids).shape
    flat = np.asarray(ids).reshape(-1)
    uniq, inverse = np.unique(flat, return_inverse=True)
    inverse = inverse.reshape(-1)
    if len(uniq) > self.capacity:
      raise ValueError(
          f'{self._batch_name()} touches {len(uniq)} unique ids > capacity '
          f'{self.capacity}; raise the cache capacity')
    self._step += 1
    slots_u = self._lookup_slots(uniq)
    miss_mask = slots_u < 0
    misses = uniq[miss_mask]
    evict_slots = np.zeros((0,), np.int64)
    evict_ids = np.zeros((0,), np.int64)
    if misses.size:
      new_slots, evict_slots, evict_ids = self._allocate(
          len(misses), protect_slots=slots_u[~miss_mask])
      self._erase_slots(evict_ids)
      self._set_slots(misses, new_slots)
      self._slot_to_id[new_slots] = misses
      slots_u = slots_u.copy()
      slots_u[miss_mask] = new_slots
    self._last_used[slots_u] = self._step
    self.stats['planned'] += len(uniq)
    self.stats['misses'] += len(misses)
    return CachePlan(
        slots=slots_u[inverse].astype(np.int32).reshape(shape),
        evict_slots=evict_slots, evict_ids=evict_ids,
        miss_slots=slots_u[miss_mask], miss_ids=misses)

  def _allocate(self, n: int, protect_slots: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Take ``n`` slots: free ones first, then the stalest residents (the
    reference's staleness top-k eviction, ``service.py:253-283``)."""
    take = min(self._n_free, n)
    slots = self._free[self._n_free - take:self._n_free].copy()
    self._n_free -= take
    if take == n:
      return slots, np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    need = n - take
    order = np.argsort(self._last_used, kind='stable')
    prot = np.zeros(self.capacity, bool)
    prot[protect_slots] = True
    cand = order[(self._slot_to_id[order] >= 0) & ~prot[order]]
    if len(cand) < need:
      raise ValueError(f'cache thrash: cannot evict enough rows for the '
                       f'{self._batch_name()}')
    evict = cand[:need]
    evict_ids = self._slot_to_id[evict].copy()
    self._slot_to_id[evict] = -1
    return np.concatenate([slots, evict]), evict, evict_ids

  def _batch_name(self) -> str:
    world = self._ctx.world_size
    return ('batch' if world == 1 else
            f'global batch of the world of {world} ranks')

  def _gather_to_host(self, arr: torch.Tensor, slots: np.ndarray
                      ) -> np.ndarray:
    """Rows ``slots`` of ``arr`` through kernel 5, in one copy to the
    host (it waits for the device's pending work on ``arr``)."""
    idx = torch.from_numpy(np.ascontiguousarray(slots, np.int64)).to(
        arr.device)
    return gather_rows(arr, idx).cpu().numpy()

  def rows_to_host(self, arrays: Dict[str, torch.Tensor], rows: np.ndarray,
                   shard: Optional[TableShard] = None
                   ) -> Dict[str, np.ndarray]:
    """Rows ``rows`` (of the whole table) of each array, on the host.

    Whole arrays (``shard`` None) are read here through kernel 5. Of a
    row shard, each owner reads its rows through kernel 5 at their local
    index, and one all-gather of the owners' rows (every array's bytes
    side by side, padded to the most rows a rank owns) gives every rank
    all of them: a collective, which every rank calls with the same
    ``rows``."""
    if shard is None:
      return {name: self._gather_to_host(arr, rows)
              for name, arr in arrays.items()}
    ctx = self._ctx
    local = next(iter(arrays.values())).shape[0]
    owner = rows // local
    counts = np.bincount(owner, minlength=ctx.world_size)
    width = int(counts.max())
    mine = torch.from_numpy(
        np.ascontiguousarray(rows[owner == ctx.rank] - shard.start, np.int64))
    parts = []
    for arr in arrays.values():
      got = (gather_rows(arr, mine.to(arr.device)) if mine.numel()
             else arr.new_empty((0, *arr.shape[1:])))
      parts.append(got.reshape(got.shape[0], arr[0].numel()).view(torch.uint8))
    mine_bytes = torch.cat(parts, dim=1)
    pad = mine_bytes.new_zeros((width - mine_bytes.shape[0],
                                mine_bytes.shape[1]))
    every = collective.allgather(torch.cat([mine_bytes, pad]), ctx=ctx).cpu()
    # Row i of ``rows`` is row k of its owner's block when it is the k-th
    # row that owner holds.
    src = np.empty(len(rows), np.int64)
    for r in range(ctx.world_size):
      at = np.nonzero(owner == r)[0]
      src[at] = r * width + np.arange(len(at))
    got = every[torch.from_numpy(src)]
    out, col = {}, 0
    for (name, arr), part in zip(arrays.items(), parts):
      n = part.shape[1]
      out[name] = got[:, col:col + n].contiguous().view(arr.dtype).reshape(
          len(rows), *arr.shape[1:]).numpy()
      col += n
    return out

  def apply_plan(self, arrays: Dict[str, torch.Tensor], plan: CachePlan,
                 row_offset: int = 0, shard: Optional[TableShard] = None
                 ) -> Dict[str, torch.Tensor]:
    """Execute a plan's array effects in place on ``arrays`` (keyed as
    the cache's tables; ``row_offset`` shifts the slots, for a cached
    table that is a member of a stacked one): write the evicted rows back
    to storage, then upload the missed rows. Returns ``arrays``.

    ``shard`` is the arrays' row shard when they are this rank's rows of
    a row-sharded table (``shard_of``): each rank then uploads only the
    rows it holds, and the evicted rows reach every rank's storage
    through :meth:`rows_to_host`'s all-gather, so every rank calls this
    with the same plan."""
    if plan.evict_slots.size:
      t0 = time.perf_counter()
      rows = self.rows_to_host(arrays, plan.evict_slots + row_offset, shard)
      for name, values in rows.items():
        self.storage.push(name, plan.evict_ids, values)
      self.stats['evicted'] += plan.evict_slots.size
      self.stats['evict_calls'] += 1
      self.stats['evict_s'] += time.perf_counter() - t0
    if plan.miss_slots.size:
      t0 = time.perf_counter()
      rows, ids = plan.miss_slots + row_offset, plan.miss_ids
      if shard is not None:
        lo = shard.start
        hi = lo + next(iter(arrays.values())).shape[0]
        keep = (rows >= lo) & (rows < hi)
        rows, ids = rows[keep] - lo, ids[keep]
      if rows.size:
        with torch.no_grad():
          for name, arr in arrays.items():
            idx = _staged(rows, arr.device)
            values = _staged(self.storage.pull(name, ids), arr.device)
            arr.index_copy_(0, idx, values.to(arr.dtype))
      self.stats['uploaded'] += plan.miss_slots.size
      self.stats['upload_s'] += time.perf_counter() - t0
    return arrays

  # -- standalone use --------------------------------------------------------

  def prepare(self, ids: np.ndarray) -> np.ndarray:
    """Plan and apply against the cache's own arrays; returns the slots.
    Call once per step, before the step; in a world, every rank with the
    same ids (the global batch, as JAX's one process plans it)."""
    plan = self.prepare_plan(ids)
    self.apply_plan(self.device, plan, shard=self._device_shard)
    return plan.slots

  def flush(self, arrays: Optional[Dict[str, torch.Tensor]] = None,
            row_offset: int = 0, shard: Optional[TableShard] = None
            ) -> None:
    """Write every resident row back to storage (the reference's
    ``before_save_checkpoints``, ``service.py:306-324``); of a row shard
    (``shard``, or the cache's own sharded arrays) a collective that
    every rank calls, after which every rank's storage holds every
    row."""
    if arrays is None:
      arrays, shard = self.device, self._device_shard
    with self._meta_lock:
      resident = np.nonzero(self._slot_to_id >= 0)[0]
      if not resident.size:
        return
      owners = self._slot_to_id[resident].copy()
    for name, values in self.rows_to_host(arrays, resident + row_offset,
                                          shard).items():
      self.storage.push(name, owners, values)

  def lookup_slots(self, ids: np.ndarray) -> np.ndarray:
    """Read-only id-to-slot probe (evaluation: a miss is -1, which looks
    up as zeros)."""
    shape = np.asarray(ids).shape
    flat = np.asarray(ids).reshape(-1)
    uniq, inverse = np.unique(flat, return_inverse=True)
    with self._meta_lock:
      slots = self._lookup_slots(uniq)
    return slots[inverse.reshape(-1)].astype(np.int32).reshape(shape)

  def lookup_embeddings(self, slots: np.ndarray) -> torch.Tensor:
    """The cached value rows of prepared slots (kernel 5); of sharded
    arrays, this rank's slots through the sharded serving lookup (a
    collective)."""
    table = self.device['value']
    slots = torch.as_tensor(np.asarray(slots), device=table.device)
    if self._device_shard is not None:
      from hybridbackend_tpu_torch.embedding.lookup import lookup
      return lookup(table, slots, self.slot_config(), serving=True,
                    ctx=self._ctx)
    return gather_rows(table, slots)


# One id per runner, counted per rank; the ranks agree on it as long as
# each makes its runners (its cached trainers) in the same order.
_RUNNER_IDS = collections.defaultdict(itertools.count)


class CacheRunner:
  """Wires :class:`EmbeddingCache` instances into a training loop.

  One runner serves a ``SparseTrainer``: :meth:`transform` (on the
  producer's thread) plans slots and rewrites each cached column's ids to
  slots; the trainer calls :meth:`apply_next` before each step to execute
  the oldest plan against the live state, :meth:`checkpoint_flush` at
  mid-train checkpoints, and :meth:`drain` then :meth:`flush` at the
  end. ``fx`` locates each cached table: its stack, row offset and
  shard.

  In a world of more than one rank (``fx.ctx``, which each cache's
  context must match) every rank plans every batch of the world: see the
  module docstring. Every rank transforms the same batches in the same
  order (the trainer's ``SyncReplicasIterator`` sees to that), and calls
  :meth:`apply_next`, :meth:`drain`, :meth:`flush` and
  :meth:`checkpoint_flush` at the same steps. A peer that posts no ids
  within ``timeout_ms`` raises an error that names it; :meth:`cancel`
  ends a pending wait (the transform raises ``SyncCancelled``) until
  :meth:`open`.
  """

  def __init__(self, caches: Dict[str, EmbeddingCache], fx,
               timeout_ms: int = DEFAULT_TIMEOUT_MS):
    self._caches = dict(caches)
    self._plans: collections.deque = collections.deque()
    # Spans a plan's creation and its queueing, so that checkpoint_flush
    # takes one consistent snapshot of (pending plans, slot metadata)
    # while the producer keeps planning.
    self._runner_lock = threading.Lock()
    self._ctx = ctx = fx.ctx
    self._loc: Dict[str, Tuple[str, int, Optional[TableShard]]] = {}
    for col, cache in self._caches.items():
      if (cache._ctx.world_size, cache._ctx.rank) != (ctx.world_size,
                                                     ctx.rank):
        raise ValueError(
            f'cache for column {col!r} was made in a world of '
            f'{cache._ctx.world_size} ranks (rank {cache._ctx.rank}), the '
            f'feature extractor in one of {ctx.world_size} (rank '
            f'{ctx.rank}); give both the same context')
      name = cache.config.name
      stack = fx.stack_of(name)
      _, off = stack.member(name)
      shard = shard_of(stack.stacked, ctx)
      if shard is not None and shard.by_column:
        raise ValueError(
            f'cached table {name!r} is column-partitioned; a cache in a '
            'world keeps its slots row-sharded (partition="row")')
      self._loc[col] = (stack.stacked.name, off, shard)
    self._store = None
    if ctx.world_size > 1:
      if ctx.store is None:
        raise ValueError('host-backed tables in a world of '
                         f'{ctx.world_size} ranks need the store of a '
                         'joined context (Context.join)')
      import torch.distributed as dist
      self._store = dist.PrefixStore('hb_cache', ctx.store)
    self._rid = next(_RUNNER_IDS[ctx.rank])
    self._xstep = 0
    self._timeout_s = timeout_ms / 1e3
    self._cancel = threading.Event()

  def cancel(self) -> None:
    """End a pending exchange of ids: the transform raises
    ``SyncCancelled``, now and until :meth:`open`."""
    self._cancel.set()

  def open(self) -> None:
    """Let transforms exchange again after :meth:`cancel`."""
    self._cancel.clear()

  def _key(self, step: int, rank: int) -> str:
    return f'{self._rid}/{step}/{rank}'

  def _global_ids(self, ids: Dict[str, np.ndarray]
                  ) -> Tuple[Dict[str, np.ndarray], slice]:
    """The world's ids of each cached column, the ranks' in rank order,
    and this rank's rows among them: one exchange through the store."""
    ctx, store = self._ctx, self._store
    step = self._xstep
    self._xstep += 1
    store.set(self._key(step, ctx.rank), pickle.dumps(ids))
    deadline = time.monotonic() + self._timeout_s
    parts = []
    for r in range(ctx.world_size):
      key = self._key(step, r)
      wait_for_key(store, key, deadline, self._cancel,
                   f'CacheRunner: rank {r} posted no ids for step {step} '
                   f'within {self._timeout_s * 1e3:.0f} ms (this is rank '
                   f'{ctx.rank}; key {key}). The peer is dead or stalled.')
      parts.append(pickle.loads(store.get(key)))
    if step >= 2:
      # Every peer has posted step - 1, so has read step - 2.
      try:
        store.delete_key(self._key(step - 2, ctx.rank))
      except Exception:  # noqa: BLE001 — clean-up is best-effort
        pass
    counts = [len(next(iter(p.values()))) for p in parts]
    lo = sum(counts[:ctx.rank])
    return ({col: np.concatenate([p[col] for p in parts]) for col in ids},
            slice(lo, lo + counts[ctx.rank]))

  def transform(self, batch):
    """Producer side: map the cached columns' ids to slots, queue the
    plan. In a world, the plan is of the world's batch, and the slots
    returned are this rank's rows'."""
    batch = dict(batch)
    ids = {col: np.asarray(batch[col]) for col in self._caches}
    rows = slice(None)
    if self._store is not None:
      ids, rows = self._global_ids(ids)
    with self._runner_lock:
      plans = {}
      for col, cache in self._caches.items():
        plan = cache.prepare_plan(ids[col])
        batch[col] = plan.slots[rows]
        plans[col] = plan
      self._plans.append(plans)
    return batch

  def eval_transform(self, batch):
    """Read-only slot mapping for evaluation and prediction: a miss is
    -1 (zeros). In a world each rank maps its own rows, with no exchange:
    the ranks' metadata, rewound past their pending plans, is the same.

    Mid-train, the live map already holds the queued plans, whose
    uploads have not reached the arrays: resolving against it would read
    slots that still hold the evicted owner's rows. So slots resolve
    against the metadata rewound past every pending plan (the undo of
    :meth:`checkpoint_flush`): an id whose slot is still pending reads as
    a miss, and an id whose eviction is still pending reads its original
    slot, whose row it still owns."""
    batch = dict(batch)
    with self._runner_lock:
      pending = list(self._plans)
      for col, cache in self._caches.items():
        ids = np.asarray(batch[col])
        live = cache.lookup_slots(ids)
        if not pending:
          batch[col] = live
          continue
        # Slots (re)assigned by pending uploads: not in the arrays yet.
        planned = set()
        # The first pending eviction of a slot names its true owner.
        restore: Dict[int, int] = {}
        seen_slots = set()
        for plans in pending:
          plan = plans.get(col)
          if plan is None:
            continue
          for s, i in zip(plan.evict_slots.tolist(),
                          plan.evict_ids.tolist()):
            first_evict_of_slot = s not in seen_slots
            seen_slots.add(s)
            # Only an id's first pending eviction names a slot whose rows
            # it still owns in the arrays; a later one (evict, re-admit,
            # evict again, all pending) refers to a slot that the
            # unapplied re-admission assigned.
            if first_evict_of_slot and int(i) not in restore:
              restore[int(i)] = int(s)
          planned.update(plan.miss_slots.tolist())
        shape = ids.shape
        flat = ids.reshape(-1).astype(np.int64)
        out = live.reshape(-1).astype(np.int32).copy()
        if planned:
          out[np.isin(out, np.fromiter(planned, np.int32))] = -1
        if restore:
          rids = np.fromiter(restore.keys(), np.int64)
          rslots = np.fromiter(restore.values(), np.int32)
          order = np.argsort(rids)
          rids, rslots = rids[order], rslots[order]
          pos = np.clip(np.searchsorted(rids, flat), 0, len(rids) - 1)
          hit = rids[pos] == flat
          out[hit] = rslots[pos[hit]]
        batch[col] = out.reshape(shape)
    return batch

  @staticmethod
  def _arrays_of(state, sname: str) -> Dict[str, torch.Tensor]:
    """The live value table and slots of stack ``sname``, named as the
    cache's tables."""
    arrays = {'value': state.tables[sname]}
    arrays.update({f'slot{i}': a
                   for i, a in enumerate(state.table_opt[sname].acc)})
    return arrays

  def apply_next(self, state):
    """Execute the oldest pending plan, in place, on the train state;
    returns the state."""
    if not self._plans:
      return state
    plans = self._plans.popleft()
    for col, plan in plans.items():
      sname, off, shard = self._loc[col]
      self._caches[col].apply_plan(self._arrays_of(state, sname), plan,
                                   row_offset=off, shard=shard)
    return state

  def drain(self, state):
    """Apply every pending plan. Only at the loop's end (the producer has
    stopped and the drained batches never train); mid-train use
    :meth:`checkpoint_flush`: draining a plan whose batch still trains
    would evict rows before their updates land."""
    while self._plans:
      state = self.apply_next(state)
    return state

  def flush(self, state) -> None:
    """Write every resident row back. Needs a stopped producer (the
    loop's end, after :meth:`drain`); mid-train use
    :meth:`checkpoint_flush`."""
    for col, cache in self._caches.items():
      sname, off, shard = self._loc[col]
      cache.flush(self._arrays_of(state, sname), row_offset=off,
                  shard=shard)

  def checkpoint_flush(self, state) -> None:
    """A flush consistent with the arrays while the producer keeps
    planning: snapshot (pending plans, slot maps) at once, undo the
    pending plans on the snapshot (they have moved the metadata past the
    arrays), and write the rows back under their true current owners. No
    plan is consumed."""
    with self._runner_lock:
      pending = list(self._plans)
      snaps = {}
      for col, cache in self._caches.items():
        with cache._meta_lock:
          snaps[col] = cache._slot_to_id.copy()
    for col, cache in self._caches.items():
      s2id = snaps[col]
      for plans in reversed(pending):
        plan = plans.get(col)
        if plan is None:
          continue
        if plan.miss_slots.size:
          s2id[plan.miss_slots] = -1
        if plan.evict_slots.size:
          s2id[plan.evict_slots] = plan.evict_ids
      resident = np.nonzero(s2id >= 0)[0]
      if not resident.size:
        continue
      owners = s2id[resident]
      sname, off, shard = self._loc[col]
      for name, values in cache.rows_to_host(
          self._arrays_of(state, sname), resident + off, shard).items():
        cache.storage.push(name, owners, values)


__all__ = ['CachePlan', 'CacheRunner', 'EmbeddingCache', 'InMemoryStorage',
           'Storage']
