"""Columnar Parquet/ORC ingest for the port's hosts.

The port's own copy of ``hybridbackend_tpu/data/parquet.py``, the
counterpart of the reference's tabular dataset
(``hybridbackend/tensorflow/data/tabular/``: a C++ dataset op over Arrow,
``dataset.cc:40-303``, ``parquet.cc``, ``orc.cc``). Two readers serve it,
each giving the JAX package's same reader's batches bit for bit:

* the native reader (``native/hbtpu_data.cc``): decode on a C++ thread
  pool without the interpreter lock, ordered emission, rebatch and
  shuffle in C++, zero-copy read-only batches;
* the Python reader: row groups (ORC stripes) decoded through pyarrow on
  a thread pool, emitted in order, rebatched and shuffled by
  ``data/rebatch.py`` with numpy's ``RandomState(seed)``.

The two shuffle differently (C++ against numpy draws), as in the JAX
package. ``native=None`` (the default) takes the native reader where it
can serve the dataset and otherwise reads in Python, with a warning that
says why; ``native=True`` raises instead, and ``native=False`` always
reads in Python. Each iterator says which reader serves it (``.reader``,
``.fallback_reason``).

The rest is the framework around them: schema inference from file
footers, file and row-group partitioning across hosts, in-pipeline
restoration of deduplicated columns, and the map, repeat, take, dedup,
restore and prefetch combinators. Where the JAX package reads
``OPTIONS['data_num_parallel_reads']``, ``num_parallel_reads`` is an
argument with the same default (0: one thread per core, at most 16).
"""

from __future__ import annotations

import collections
import concurrent.futures
import glob as _glob
import itertools
import logging
import os
import threading
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from hybridbackend_tpu_torch.data.dataframe import Batch, Field, from_arrow

LOG = logging.getLogger('hybridbackend_tpu_torch')


def _expand_files(filenames: Union[str, Sequence[str]]) -> List[str]:
  if isinstance(filenames, str):
    filenames = [filenames]
  out: List[str] = []
  for f in filenames:
    if any(c in f for c in '*?['):
      out.extend(sorted(_glob.glob(f)))
    else:
      out.append(f)
  if not out:
    raise ValueError(f'No files matched: {filenames}')
  return out


def _arrow_field_to_field(af) -> Field:
  import pyarrow as pa
  t = af.type
  rank = 0
  while pa.types.is_list(t) or pa.types.is_large_list(t):
    rank += 1
    t = t.value_type
  if pa.types.is_string(t) or pa.types.is_large_string(t):
    dtype = np.dtype(object)
  else:
    dtype = np.dtype(t.to_pandas_dtype())
  return Field(af.name, dtype=dtype, ragged_rank=rank)


def _read_schema(filename: str, format: str):
  if format == 'parquet':
    import pyarrow.parquet as pq
    return pq.read_schema(filename)
  if format == 'orc':
    import pyarrow.orc as po
    return po.ORCFile(filename).schema
  raise ValueError(f'Unknown format: {format}')


def infer_fields(filename: str, format: str = 'parquet') -> List[Field]:
  """Read the schema from a file footer (no data IO)."""
  return [_arrow_field_to_field(f) for f in _read_schema(filename, format)]


def _native_type(t) -> bool:
  """Whether the C++ plane emits an Arrow type: integers and floats,
  lists and lists of lists of them, and flat strings."""
  import pyarrow as pa
  is_list = lambda x: pa.types.is_list(x) or pa.types.is_large_list(x)
  numeric = lambda x: (pa.types.is_integer(x) or pa.types.is_float32(x)
                       or pa.types.is_float64(x))
  if is_list(t):
    t = t.value_type
    if is_list(t):
      t = t.value_type       # rank 2 (list<list<T>>) is native
      if is_list(t):
        return False         # rank >= 3 stays on the Python path
    return numeric(t)
  return pa.types.is_string(t) or pa.types.is_large_string(t) or numeric(t)


class _PythonIterator:
  """The Python reader's batches, with the reader's name and, where the
  native reader was wanted, why it did not serve."""

  reader = 'python'

  def __init__(self, gen: Iterator[Batch], fallback_reason: Optional[str]):
    self._gen = gen
    self.fallback_reason = fallback_reason

  def __iter__(self):
    return self

  def __next__(self) -> Batch:
    return next(self._gen)

  def close(self) -> None:
    """Cancels the decodes still queued."""
    self._gen.close()


class ParquetDataset:
  """Streams batches from Parquet (or ORC) files.

  Python-level parity with ``hb.data.ParquetDataset``
  (``tabular/dataset_v2.py:44-230``): iterating yields dict batches
  ``{name: ndarray | Value}`` of exactly ``batch_size`` rows (except a
  final partial batch unless ``drop_remainder``).

  Args:
    filenames: file paths or glob patterns.
    fields: columns to read; None = infer all from the first file.
    batch_size: rows per emitted batch.
    drop_remainder: drop the final short batch.
    partition_index/partition_count: this host reads files (and, within a
      single shared file, row groups) ``i ≡ partition_index (mod
      partition_count)``.
    shuffle: shuffle rows within a window of ``shuffle_buffer`` rows.
    num_parallel_reads: reader threads (0 = one per core, at most 16).
    format: 'parquet' or 'orc'.
    restore_columns, restore_index: value columns stored deduplicated
      and their index column, re-expanded per row group before rebatch
      (on the Python reader).
    native: the native reader where it can serve (None), always (True:
      raise where it cannot), or never (False).
  """

  def __init__(self,
               filenames: Union[str, Sequence[str]],
               fields: Optional[Sequence[Union[Field, str]]] = None,
               batch_size: int = 1024,
               drop_remainder: bool = False,
               partition_index: int = 0,
               partition_count: int = 1,
               shuffle: bool = False,
               shuffle_buffer: Optional[int] = None,
               seed: int = 0,
               num_parallel_reads: int = 0,
               format: str = 'parquet',
               restore_columns: Sequence[str] = (),
               restore_index: str = 'restore_idx',
               native: Optional[bool] = None):
    self._files = _expand_files(filenames)
    self._format = format
    inferred = {f.name: f for f in infer_fields(self._files[0], format)}
    if fields is None:
      self._fields = list(inferred.values())
    else:
      self._fields = []
      for f in fields:
        if isinstance(f, str):
          if f not in inferred:
            raise ValueError(f'Unknown column {f!r}; file has '
                             f'{sorted(inferred)}')
          self._fields.append(inferred[f])
        else:
          if f.name in inferred:
            got = inferred[f.name]
            if got.ragged_rank != f.ragged_rank:
              raise ValueError(
                  f'Field {f.name!r}: declared ragged_rank '
                  f'{f.ragged_rank} but file has {got.ragged_rank}')
          self._fields.append(f)
    self._batch_size = int(batch_size)
    self._drop_remainder = drop_remainder
    self._partition_index = partition_index
    self._partition_count = partition_count
    self._shuffle = shuffle
    self._shuffle_buffer = shuffle_buffer or (4 * self._batch_size)
    self._seed = seed
    self._threads = num_parallel_reads
    self._native = native
    self._tls = threading.local()
    # In-pipeline dedup restoration (reference: deduplicate applied as
    # a dataset stage inside .batch(), tabular/table.py:218-223): files
    # stored with per-row-group deduplicated value columns + an index
    # column are re-expanded per micro-batch BEFORE rebatch, so every
    # emitted batch has uniform row counts.
    self._restore = (list(restore_columns), restore_index) \
        if restore_columns else None

  @property
  def fields(self) -> List[Field]:
    return list(self._fields)

  @property
  def batch_size(self) -> int:
    return self._batch_size

  # -- reading -------------------------------------------------------------

  def _task_indices(self):
    """Enumerate (file_index, chunk_index) read units: one per Parquet
    row group / ORC stripe, honoring the host partition."""
    partition_groups = (self._partition_count > 1
                        and len(self._files) < self._partition_count)
    if self._partition_count <= 1 or partition_groups:
      my = list(enumerate(self._files))
    else:
      my = list(enumerate(self._files))[
          self._partition_index::self._partition_count]
    for fidx, fname in my:
      if self._format == 'orc':
        import pyarrow.orc as po
        n_chunks = po.ORCFile(fname).nstripes
      else:
        import pyarrow.parquet as pq
        n_chunks = pq.ParquetFile(fname).num_row_groups
      for c in range(n_chunks):
        if partition_groups and (
            c % self._partition_count != self._partition_index):
          continue
        yield fidx, c

  def _read_chunk(self, fname: str, chunk: int, names: List[str]) -> Batch:
    """Read one row group / stripe (pyarrow releases the interpreter
    lock while Arrow's C++ decodes)."""
    reader = self._open_file(fname)
    if self._format == 'orc':
      tbl = reader.read_stripe(chunk, columns=names)
    else:
      tbl = reader.read_row_group(chunk, columns=names,
                                  use_threads=False)
    return {n: from_arrow(tbl.column(n)) for n in names}

  def _open_file(self, fname: str):
    # One reader handle per (thread, file): ParquetFile is not
    # documented thread-safe for concurrent reads.
    cache = getattr(self._tls, 'readers', None)
    if cache is None:
      cache = self._tls.readers = {}
    r = cache.get(fname)
    if r is None:
      if self._format == 'orc':
        import pyarrow.orc as po
        r = po.ORCFile(fname)
      else:
        import pyarrow.parquet as pq
        r = pq.ParquetFile(fname)
      cache[fname] = r
    return r

  def _iter_micro_batches(self) -> Iterator[Batch]:
    """Yield micro-batches (one per row group / stripe), deterministic
    order, decoded by a thread pool (reference: AUTOTUNE thread
    budgeting + parallel interleave, ``table.py:94-178``)."""
    names = [f.name for f in self._fields]
    tasks = ((self._files[fidx], c, names)
             for fidx, c in self._task_indices())
    threads = self._threads or max(1, min((os.cpu_count() or 2), 16))
    if threads <= 1:
      for t in tasks:
        yield self._read_chunk(*t)
      return
    # Ordered pipelined decode: keep up to 2*threads reads in flight,
    # emit strictly in task order (determinism + parallelism).
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
      window: collections.deque = collections.deque()
      try:
        for t in itertools.islice(tasks, 2 * threads):
          window.append(pool.submit(self._read_chunk, *t))
        while window:
          yield window.popleft().result()
          t = next(tasks, None)
          if t is not None:
            window.append(pool.submit(self._read_chunk, *t))
      finally:
        for f in window:
          f.cancel()

  def _native_unsupported(self) -> Optional[str]:
    """Why the native reader cannot serve this dataset, or None. Only
    what the C++ plane emits is native; a type that differs between
    files (string against large_string too) is not, since the plane
    copies with the first file's physical types and the Python reader
    promotes."""
    from hybridbackend_tpu_torch.native import tabular
    if self._restore is not None:
      return ('restore_columns re-expands each row group before rebatch, '
              'which the Python reader does')
    why = tabular.unsupported(self._fields)
    if why:
      return why
    try:
      tabular.load()
    except tabular.NativeUnavailable as e:
      return f'the native reader is unavailable: {e}'
    names = {f.name for f in self._fields}
    types0 = {f.name: f.type for f in _read_schema(self._files[0],
                                                   self._format)
              if f.name in names}
    missing = names - set(types0)
    if missing:
      return f'columns {sorted(missing)} are not in {self._files[0]}'
    for name, t in types0.items():
      if not _native_type(t):
        return f'column {name!r} has Arrow type {t}'
    for fname in self._files[1:]:
      for f in _read_schema(fname, self._format):
        if f.name in types0 and not f.type.equals(types0[f.name]):
          return (f'column {f.name!r} is {types0[f.name]} in '
                  f'{self._files[0]} but {f.type} in {fname}')
    return None

  def _native_iter(self) -> Tuple[Optional[Iterator[Batch]], Optional[str]]:
    """``(iterator, None)`` from the C++ data plane, or ``(None, why
    not)``."""
    why = self._native_unsupported()
    if why:
      return None, why
    from hybridbackend_tpu_torch.native import tabular
    try:
      return tabular.NativeTabularIterator(
          self._files, list(self._task_indices()), self._fields,
          self._batch_size, drop_remainder=self._drop_remainder,
          shuffle=self._shuffle, shuffle_buffer=self._shuffle_buffer,
          seed=self._seed, threads=self._threads,
          format=self._format), None
    except RuntimeError as e:       # the reader failed to open
      return None, f'the native reader failed to open: {e}'

  # -- tf.data-style combinators (reference datasets are tf.data;
  #    adoption parity for map/repeat/take/prefetch chains) -----------
  def map(self, fn):
    """Apply ``fn(batch) -> batch`` to every batch lazily."""
    return _map(self, fn)

  def repeat(self, n: Optional[int] = None):
    """Repeat the dataset ``n`` times (None = forever)."""
    return _repeat(self, n)

  def take(self, n: int):
    return _take(self, n)

  def prefetch(self, device, capacity: int = 2):
    """Chain a ``DeviceIterator`` that places each batch on ``device``
    one step ahead, ``capacity`` host batches queued by its thread."""
    return _prefetch(self, device, capacity)

  def dedup(self, value_columns: Sequence[str], key_column: str,
            index_column: str = 'restore_idx'):
    """Transport dedup stage: collapse rows with equal keys, adding a
    restore index (pair with ``.restore`` after prefetch). Reference:
    ``data/deduplicate/dataset.py:29-67``."""
    from hybridbackend_tpu_torch.data.deduplicate import deduplicate
    cols, key, idx = list(value_columns), key_column, index_column
    return _map(self, lambda b: deduplicate(b, cols, key,
                                            index_column=idx))

  def restore(self, value_columns: Sequence[str],
              index_column: str = 'restore_idx'):
    """Re-expand columns collapsed by ``.dedup`` (or stored
    deduplicated). Reference restore inside ``.batch()``,
    ``tabular/table.py:218-223``."""
    from hybridbackend_tpu_torch.data.deduplicate import restore_deduplicated
    cols, idx = list(value_columns), index_column
    return _map(self, lambda b: restore_deduplicated(b, cols, idx))

  def __iter__(self) -> Iterator[Batch]:
    why = None
    if self._native is not False:
      it, why = self._native_iter()
      if it is not None:
        return it
      if self._native:
        raise ValueError(f'native=True, but the native reader cannot serve '
                         f'{self._files[0]}: {why}')
      LOG.warning('ParquetDataset(%s): reading through the Python reader: '
                  '%s', self._files[0], why)
    from hybridbackend_tpu_torch.data.rebatch import rebatch
    micro = self._iter_micro_batches()
    if self._restore is not None:
      from hybridbackend_tpu_torch.data.deduplicate import (
          restore_deduplicated)
      cols, idx = self._restore
      micro = (restore_deduplicated(b, cols, idx) for b in micro)
    return _PythonIterator(
        rebatch(micro, self._batch_size,
                drop_remainder=self._drop_remainder, shuffle=self._shuffle,
                shuffle_buffer=self._shuffle_buffer, seed=self._seed), why)


class _TransformedDataset:
  """Lazily transformed view of a dataset (tf.data-style combinators)."""

  def __init__(self, source, fn):
    self._source = source
    self._fn = fn

  def __iter__(self):
    return self._fn(self._source)

  # combinators chain on any dataset-like object
  map = ParquetDataset.map
  repeat = ParquetDataset.repeat
  take = ParquetDataset.take
  prefetch = ParquetDataset.prefetch
  dedup = ParquetDataset.dedup
  restore = ParquetDataset.restore


def _map(ds, fn):
  def gen(src):
    return (fn(b) for b in src)
  return _TransformedDataset(ds, gen)


def _repeat(ds, n=None):
  def gen(src):
    count = itertools.count() if n is None else range(n)
    for _ in count:
      yield from iter(src)
  return _TransformedDataset(ds, gen)


def _take(ds, n):
  def gen(src):
    it = iter(src)
    try:
      for _ in range(n):
        try:
          yield next(it)
        except StopIteration:
          return
    finally:
      close = getattr(it, 'close', None)
      if close is not None:
        close()
  return _TransformedDataset(ds, gen)


def _prefetch(ds, device, capacity):
  def gen(src):
    from hybridbackend_tpu_torch.data.prefetch import DeviceIterator
    return DeviceIterator(iter(src), device, capacity=capacity)
  return _TransformedDataset(ds, gen)


class Dataset:
  """Namespace mirroring ``hb.data.Dataset.from_parquet/from_orc``
  (``data/__init__.py:30-46``)."""

  @staticmethod
  def from_parquet(filenames, **kwargs) -> ParquetDataset:
    return ParquetDataset(filenames, format='parquet', **kwargs)

  @staticmethod
  def from_orc(filenames, **kwargs) -> ParquetDataset:
    return ParquetDataset(filenames, format='orc', **kwargs)


__all__ = ['ParquetDataset', 'Dataset', 'infer_fields']
