"""ctypes binding for the port's host library (``hbtpu_native.cc``).

The port's own copy of ``hybridbackend_tpu/native/__init__.py``: the
open-addressing id hash (:class:`NativeIdMap`, int64 ids to int32
values), the ragged-batch helpers and ``murmur3_mix64``, with the JAX
package's results bit for bit.

The library is compiled with ``g++`` at first use (never at import) into
``hybridbackend_tpu_torch/_build/``, under a name hashed from the source
and the flags, by ``tabular.build``: each build writes a temporary name
of its own and renames it into place, so processes that build at once
never share a half-written file (the JAX package shares one ``.tmp``
name between them).

There is no quiet fallback: where the library cannot be built or loaded,
:func:`load` raises :class:`NativeUnavailable` with the reason, and so
does every function here. The NumPy paths that compute the same results
are the callers' (``IdMapper(native=False)``, ``EmbeddingCache(native=
False)``, ``data/dataframe.py``), taken only when asked for.

The map's read probe (``lookup``) runs on several threads above 32768
ids; it must not run while another thread inserts (a grow frees the
arrays it reads), so callers that share a map between threads hold one
lock around every call, as ``EmbeddingCache`` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from hybridbackend_tpu_torch.native.tabular import NativeUnavailable, build

_SRC = Path(__file__).resolve().parent / 'hbtpu_native.cc'
_BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
_FLAGS = ('-pthread',)

_LOADED: Dict[str, object] = {}   # 'lib': ctypes.CDLL, or 'error': reason

_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_SIGNATURES = {
    'hb_idmap_new': (_VP, [_I64]),
    'hb_idmap_free': (None, [_VP]),
    'hb_idmap_size': (_I64, [_VP]),
    'hb_idmap_lookup': (None, [_VP, _VP, _I64, _VP, _I32, _I32]),
    'hb_idmap_train_lookup': (_I64, [_VP, _VP, _I64, _VP, _I64, _I64,
                                     _I32]),
    'hb_idmap_set': (None, [_VP, _VP, _VP, _I64]),
    'hb_idmap_erase': (None, [_VP, _VP, _I64]),
    'hb_idmap_items': (_I64, [_VP, _VP, _VP]),
    'hb_idmap_items_all': (_I64, [_VP, _VP, _VP]),
    'ragged_to_padded_f32': (None, [_VP, _VP, _I64, _I64, _I64, _VP, _VP]),
    'ragged_to_padded_i64': (None, [_VP, _VP, _I64, _I64, _I64, _VP, _VP]),
    'ragged_to_padded_i32': (None, [_VP, _VP, _I64, _I64, _I64, _VP, _VP]),
    'ragged_take_rows': (_I64, [_VP, _VP, _VP, _I64, _I64, _VP, _VP]),
    'take_rows_dense': (None, [_VP, _VP, _I64, _I64, _VP]),
    'murmur3_mix64': (None, [_VP, _I64, ctypes.c_uint64, _VP]),
}


def library_path() -> Path:
  """Where the library of this source and these flags is built."""
  digest = hashlib.sha256(_SRC.read_bytes())
  digest.update(' '.join(_FLAGS).encode())
  return _BUILD_DIR / f'libhbtpu_native_{digest.hexdigest()[:16]}.so'


def load() -> ctypes.CDLL:
  """Builds (if needed) and loads the library, once per process; raises
  :class:`NativeUnavailable` with the reason otherwise (also on later
  calls, without trying again)."""
  if 'lib' in _LOADED:
    return _LOADED['lib']
  if 'error' in _LOADED:
    raise NativeUnavailable(_LOADED['error'])
  try:
    out = library_path()
    build(_SRC, out, _FLAGS)
    try:
      lib = ctypes.CDLL(str(out))
    except OSError as e:
      raise NativeUnavailable(f'cannot load {out.name}: {e}') from e
  except NativeUnavailable as e:
    _LOADED['error'] = str(e)
    raise
  for name, (restype, argtypes) in _SIGNATURES.items():
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = restype, argtypes
  _LOADED['lib'] = lib
  return lib


def _ptr(a: np.ndarray):
  return a.ctypes.data_as(ctypes.c_void_p)


def _checked_splits(splits, num_values: int) -> np.ndarray:
  """Row splits as int64 that the native loops may follow: non-empty,
  non-decreasing, from 0 to at most ``num_values``."""
  splits = np.ascontiguousarray(splits, np.int64)
  if (splits.ndim != 1 or not splits.size or splits[0] != 0
      or splits[-1] > num_values or (np.diff(splits) < 0).any()):
    raise ValueError(f'row splits must rise from 0 to at most {num_values}')
  return splits


def _checked_indices(indices, rows: int) -> np.ndarray:
  """Row indices as int64, each in ``[0, rows)``."""
  indices = np.ascontiguousarray(indices, np.int64).reshape(-1)
  if indices.size and (indices.min() < 0 or indices.max() >= rows):
    raise IndexError(f'row indices must lie in [0, {rows})')
  return indices


_PAD_FNS = {'float32': 'ragged_to_padded_f32',
            'int64': 'ragged_to_padded_i64',
            'int32': 'ragged_to_padded_i32'}


def ragged_to_padded(values: np.ndarray, splits: np.ndarray, max_len: int,
                     pad_value) -> Tuple[np.ndarray, np.ndarray]:
  """Ragged rows to ``(padded [n, max_len, ...], mask [n, max_len])``:
  each row's first ``max_len`` values, ``pad_value`` after them. Takes
  C-contiguous float32, int64 or int32 values."""
  fname = _PAD_FNS.get(values.dtype.name)
  if fname is None or not values.flags.c_contiguous:
    raise TypeError('ragged_to_padded takes C-contiguous float32, int64 or '
                    f'int32 values; got {values.dtype}')
  splits = _checked_splits(splits, values.shape[0])
  lib = load()
  n = len(splits) - 1
  inner = int(np.prod(values.shape[1:], dtype=np.int64))
  out = np.full((n, max_len) + values.shape[1:], pad_value, values.dtype)
  mask = np.zeros((n, max_len), np.uint8)
  getattr(lib, fname)(_ptr(values), _ptr(splits), n, max_len,
                      max(inner, 1), _ptr(out), _ptr(mask))
  return out, mask.astype(bool)


def ragged_take_rows(values: np.ndarray, splits: np.ndarray,
                     indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """Rows ``indices`` of a rank-1 ragged column: ``(values, splits)``."""
  if (not values.flags.c_contiguous or values.ndim != 1
      or values.dtype == object):
    raise TypeError('ragged_take_rows takes C-contiguous rank-1 numeric '
                    f'values; got {values.dtype} of rank {values.ndim}')
  splits = _checked_splits(splits, values.shape[0])
  indices = _checked_indices(indices, len(splits) - 1)
  lib = load()
  total = int(np.diff(splits)[indices].sum())
  out_values = np.empty((total,), values.dtype)
  out_splits = np.empty((len(indices) + 1,), np.int64)
  lib.ragged_take_rows(_ptr(values), _ptr(splits), _ptr(indices),
                       len(indices), values.itemsize, _ptr(out_values),
                       _ptr(out_splits))
  return out_values, out_splits


def take_rows_dense(values: np.ndarray, indices: np.ndarray) -> np.ndarray:
  """``values[indices]`` for C-contiguous numeric values of any shape."""
  if not values.flags.c_contiguous or values.dtype == object:
    raise TypeError('take_rows_dense takes C-contiguous numeric values; '
                    f'got {values.dtype}')
  indices = _checked_indices(indices, values.shape[0])
  lib = load()
  row_bytes = int(values.itemsize * np.prod(values.shape[1:],
                                            dtype=np.int64))
  out = np.empty((len(indices),) + values.shape[1:], values.dtype)
  lib.take_rows_dense(_ptr(values), _ptr(indices), len(indices),
                      max(row_bytes, values.itemsize), _ptr(out))
  return out


def murmur3_mix64(ids: np.ndarray, modulo: int = 0) -> np.ndarray:
  """MurmurHash3's 64-bit finalizer of each id (int64), taken modulo
  ``modulo`` as an unsigned number when it is not 0."""
  lib = load()
  ids = np.ascontiguousarray(ids, np.int64)
  out = np.empty_like(ids)
  lib.murmur3_mix64(_ptr(ids), ids.size, modulo, _ptr(out))
  return out


class NativeIdMap:
  """Open-addressing int64 to int32 map over the C ABI (the host
  counterpart of the reference's device slab hash,
  ``lookup_functors.cu.cc:40-170``). A value ``>= 0`` is an admitted
  row; a pending ``min_count`` admission is stored as ``-1 - count``."""

  def __init__(self, capacity_hint: int = 1024):
    self._lib = load()
    self._h = self._lib.hb_idmap_new(int(capacity_hint))

  def __del__(self):
    h, self._h = getattr(self, '_h', None), None
    if h:
      self._lib.hb_idmap_free(h)

  def __len__(self) -> int:
    return int(self._lib.hb_idmap_size(self._h))

  def lookup(self, ids: np.ndarray, missing: int = -1,
             nthreads: int = 0) -> np.ndarray:
    """Read-only probe (on up to 8 threads above 32768 ids): the
    admitted row of each id, ``missing`` for absent or pending ones."""
    ids = np.ascontiguousarray(ids, np.int64)
    out = np.empty(ids.shape, np.int32)
    if nthreads <= 0:
      nthreads = min(8, os.cpu_count() or 1)
    self._lib.hb_idmap_lookup(self._h, _ptr(ids), ids.size, _ptr(out),
                              missing, nthreads)
    return out

  def train_lookup(self, ids: np.ndarray, max_rows: int, next_row: int,
                   min_count: int = 1) -> Tuple[np.ndarray, int]:
    """Lookup-or-assign in occurrence order: ``(rows, new_next_row)``;
    a new id takes ``next_row`` while it is below ``max_rows`` (else -1,
    cold), after ``min_count`` sightings."""
    ids = np.ascontiguousarray(ids, np.int64)
    out = np.empty(ids.shape, np.int32)
    nxt = self._lib.hb_idmap_train_lookup(
        self._h, _ptr(ids), ids.size, _ptr(out), int(max_rows),
        int(next_row), int(min_count))
    return out, int(nxt)

  def set(self, ids: np.ndarray, rows: np.ndarray) -> None:
    """Insert or overwrite ``ids`` with the raw values ``rows``."""
    ids = np.ascontiguousarray(ids, np.int64)
    rows = np.ascontiguousarray(rows, np.int32)
    self._lib.hb_idmap_set(self._h, _ptr(ids), _ptr(rows), ids.size)

  def erase(self, ids: np.ndarray) -> None:
    ids = np.ascontiguousarray(ids, np.int64)
    self._lib.hb_idmap_erase(self._h, _ptr(ids), ids.size)

  def items(self) -> Tuple[np.ndarray, np.ndarray]:
    """Admitted ``(ids, rows)``, in the map's slot order."""
    n = len(self)
    ids = np.empty((n,), np.int64)
    rows = np.empty((n,), np.int32)
    cnt = int(self._lib.hb_idmap_items(self._h, _ptr(ids), _ptr(rows)))
    return ids[:cnt], rows[:cnt]

  def items_all(self) -> Tuple[np.ndarray, np.ndarray]:
    """Every live ``(ids, raw values)``, pending admissions included (as
    ``-1 - count``), in the map's slot order."""
    n = len(self)
    ids = np.empty((n,), np.int64)
    vals = np.empty((n,), np.int32)
    cnt = int(self._lib.hb_idmap_items_all(self._h, _ptr(ids), _ptr(vals)))
    return ids[:cnt], vals[:cnt]


def native_idmap(capacity_hint: int = 1024) -> NativeIdMap:
  """A new :class:`NativeIdMap`; raises :class:`NativeUnavailable` where
  the library cannot be built."""
  return NativeIdMap(capacity_hint)


__all__ = ['NativeIdMap', 'NativeUnavailable', 'library_path', 'load',
           'murmur3_mix64', 'native_idmap', 'ragged_take_rows',
           'ragged_to_padded', 'take_rows_dense']
