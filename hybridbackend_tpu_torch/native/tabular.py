"""ctypes binding for the port's native tabular data plane (hbtpu_data.cc).

The port's own copy of ``hybridbackend_tpu/native/tabular.py``. The
library is compiled with ``g++`` against the Arrow and Parquet C++ that
ship inside pyarrow, at first use (never at import), into
``hybridbackend_tpu_torch/_build/``. Its file name carries a hash of the
source, the flags and pyarrow's version, so an edited source or another
pyarrow is rebuilt and an unchanged one reused. Each build writes a
temporary name of its own and renames it into place, so processes that
build at once never share a half-written file (the JAX package's
``native/__init__.py`` shares one ``.tmp`` name between them).

Where the toolchain or Arrow's libraries are missing, :func:`load` raises
:class:`NativeUnavailable` with the reason; ``ParquetDataset`` then reads
through pyarrow in Python, and says so (``data/parquet.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hybridbackend_tpu_torch.data.dataframe import Field, Value

_SRC = Path(__file__).resolve().parent / 'hbtpu_data.cc'
_BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
_CXXFLAGS = ('-O3', '-shared', '-fPIC', '-std=c++20')

_DTYPE_CODES = {
    np.dtype(np.int8): 1, np.dtype(np.int16): 2,
    np.dtype(np.int32): 3, np.dtype(np.int64): 4,
    np.dtype(np.uint8): 5, np.dtype(np.uint16): 6,
    np.dtype(np.uint32): 7, np.dtype(np.uint64): 8,
    np.dtype(np.float32): 10, np.dtype(np.float64): 11,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_STRING = 20


class NativeUnavailable(RuntimeError):
  """The native data plane cannot be built or loaded here; the message
  says why."""


class _ColDesc(ctypes.Structure):
  _fields_ = [
      ('values', ctypes.c_void_p),
      ('num_values', ctypes.c_int64),
      ('splits', ctypes.c_void_p),
      ('dtype', ctypes.c_int32),
      ('ragged', ctypes.c_int32),      # 0 dense, 1 list, 2 str, 3 list<list>
      ('splits2', ctypes.c_void_p),    # rank-2 inner splits
      ('num_inner', ctypes.c_int64),   # rank-2 inner-list count
  ]


@dataclasses.dataclass
class NativeLibrary:
  """The loaded data plane and how it was obtained."""
  lib: ctypes.CDLL
  path: Path
  build_seconds: float     # 0.0 when an existing build was reused


def arrow_toolchain() -> Tuple[Optional[List[str]], str]:
  """``(flags, what)``: the compiler flags that build against pyarrow's
  Arrow and Parquet C++ (its headers, ``libarrow.so*`` and
  ``libparquet.so*`` found by glob, whatever their version suffix), or
  None; and a line that says what was found or what is missing."""
  try:
    import pyarrow
  except ImportError:
    return None, 'pyarrow is not installed'
  inc = pyarrow.get_include()
  if not os.path.exists(os.path.join(inc, 'arrow', 'api.h')):
    return None, f'pyarrow {pyarrow.__version__} has no C++ headers ({inc})'
  for libdir in pyarrow.get_library_dirs():
    found = [sorted(glob.glob(os.path.join(libdir, stem + '.so*')))
             for stem in ('libarrow', 'libparquet')]
    if all(found):
      libs = [f[0] for f in found]
      what = (f'pyarrow {pyarrow.__version__}: headers {inc}, '
              + ', '.join(os.path.basename(l) for l in libs))
      return [f'-I{inc}', *libs, f'-Wl,-rpath,{libdir}'], what
  return None, (f'pyarrow {pyarrow.__version__} ships no libarrow.so* and '
                f'libparquet.so* in {pyarrow.get_library_dirs()}')


def build(src: Path, out: Path, flags: Sequence[str]) -> float:
  """Compiles ``src`` into ``out`` with ``g++`` unless ``out`` exists;
  returns the seconds the compiler took (0.0 when reused). The compiler
  writes a temporary file of this call's own beside ``out``, which is
  then renamed onto it: a loader never sees a half-written library, and
  builds that race each finish with a whole one."""
  if out.exists():
    return 0.0
  out.parent.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(prefix=f'.{out.name}.{os.getpid()}.',
                             suffix='.tmp', dir=out.parent)
  os.close(fd)
  t0 = time.perf_counter()
  try:
    try:
      proc = subprocess.run(['g++', *_CXXFLAGS, '-o', tmp, str(src), *flags],
                            capture_output=True, text=True)
    except FileNotFoundError as e:      # no g++
      raise NativeUnavailable(f'cannot run g++: {e}') from e
    if proc.returncode != 0:
      raise NativeUnavailable(f'g++ failed on {src.name}:\n'
                              f'{proc.stderr[-2000:]}')
    os.replace(tmp, out)
  finally:
    if os.path.exists(tmp):
      os.unlink(tmp)
  return time.perf_counter() - t0


_LOADED: Dict[str, object] = {}   # 'lib': NativeLibrary, or 'error': reason


def load() -> NativeLibrary:
  """Builds (if needed) and loads the data plane, once per process;
  raises :class:`NativeUnavailable` with the reason otherwise (also on
  later calls, without trying again)."""
  if 'lib' in _LOADED:
    return _LOADED['lib']
  if 'error' in _LOADED:
    raise NativeUnavailable(_LOADED['error'])
  try:
    flags, what = arrow_toolchain()
    if flags is None:
      raise NativeUnavailable(what)
    import pyarrow
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(' '.join((*_CXXFLAGS, *flags,
                            pyarrow.__version__)).encode())
    out = _BUILD_DIR / f'libhbtpu_data_{digest.hexdigest()[:16]}.so'
    seconds = build(_SRC, out, flags)
    try:
      lib = ctypes.CDLL(str(out))
    except OSError as e:
      raise NativeUnavailable(f'cannot load {out.name}: {e}') from e
  except NativeUnavailable as e:
    _LOADED['error'] = str(e)
    raise
  lib.hb_data_reader_open.restype = ctypes.c_void_p
  lib.hb_data_reader_open.argtypes = [
      ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,      # files
      ctypes.POINTER(ctypes.c_int32),                       # task_file
      ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,       # task_chunk
      ctypes.POINTER(ctypes.c_char_p),                      # cols
      ctypes.POINTER(ctypes.c_double), ctypes.c_int64,      # defaults
      ctypes.c_int64, ctypes.c_int32,                       # batch, drop
      ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,       # shuffle
      ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,       # threads…
      ctypes.c_int32,                                       # mmap
      ctypes.c_char_p, ctypes.c_int64,                      # err
  ]
  lib.hb_data_reader_next.restype = ctypes.c_int64
  lib.hb_data_reader_next.argtypes = [
      ctypes.c_void_p, ctypes.POINTER(_ColDesc),
      ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int64]
  lib.hb_data_batch_free.restype = None
  lib.hb_data_batch_free.argtypes = [ctypes.c_void_p]
  lib.hb_data_reader_close.restype = None
  lib.hb_data_reader_close.argtypes = [ctypes.c_void_p]
  lib.hb_data_abi_version.restype = ctypes.c_int32
  lib.hb_data_abi_version.argtypes = []
  if lib.hb_data_abi_version() != 1:
    _LOADED['error'] = f'{out.name} has another ABI version'
    raise NativeUnavailable(_LOADED['error'])
  _LOADED['lib'] = NativeLibrary(lib, out, seconds)
  return _LOADED['lib']


def unsupported(fields: Sequence[Field]) -> Optional[str]:
  """Why the native plane cannot serve these fields, or None."""
  for f in fields:
    if f.shape:
      return f'column {f.name!r} has an inner shape {f.shape}'
    if np.dtype(f.dtype) == np.dtype(object):
      if f.ragged_rank != 0:
        return f'column {f.name!r} is a list of strings'
      continue  # flat string columns are native
    if f.ragged_rank > 2:
      return (f'column {f.name!r} has ragged rank {f.ragged_rank} (the '
              'native plane decodes up to 2)')
    if np.dtype(f.dtype) not in _DTYPE_CODES:
      return f'column {f.name!r} has dtype {np.dtype(f.dtype)}'
  return None


class _Token:
  """Owns one emitted batch's native buffers; freed on GC."""

  __slots__ = ('_lib', '_ptr')

  def __init__(self, lib: ctypes.CDLL, ptr: int):
    self._lib = lib
    self._ptr = ptr

  def __del__(self):
    if self._ptr:
      self._lib.hb_data_batch_free(self._ptr)
      self._ptr = 0


def _wrap(ptr: int, count: int, dtype: np.dtype, token: _Token) -> np.ndarray:
  if count == 0 or not ptr:
    return np.empty((0,), dtype)
  cbuf = (ctypes.c_char * (count * dtype.itemsize)).from_address(ptr)
  cbuf._hb_token = token  # keepalive: array -> cbuf -> token -> C++ buffers
  arr = np.frombuffer(cbuf, dtype=dtype)
  arr.flags.writeable = False
  return arr


class NativeTabularIterator:
  """Iterates dict batches produced by the C++ pipeline. Numeric columns
  are read-only views of the pipeline's buffers, which each batch's token
  keeps alive for as long as an array of the batch is referenced."""

  reader = 'native'
  fallback_reason = None

  def __init__(self,
               files: Sequence[str],
               tasks: Sequence[Tuple[int, int]],
               fields: Sequence[Field],
               batch_size: int,
               drop_remainder: bool = False,
               shuffle: bool = False,
               shuffle_buffer: int = 0,
               seed: int = 0,
               threads: int = 0,
               prefetch: int = 0,
               format: str = 'parquet',
               mmap: bool = False):
    self._lib = load().lib
    self._fields = list(fields)
    self._ncols = len(self._fields)
    if threads <= 0:
      threads = max(1, min((os.cpu_count() or 2), 16))
    files_c = (ctypes.c_char_p * len(files))(
        *[f.encode() for f in files])
    cols_c = (ctypes.c_char_p * self._ncols)(
        *[f.name.encode() for f in self._fields])
    defaults_c = (ctypes.c_double * self._ncols)(
        *[float(f.default_value) for f in self._fields])
    tf = (ctypes.c_int32 * len(tasks))(*[t[0] for t in tasks])
    tc = (ctypes.c_int32 * len(tasks))(*[t[1] for t in tasks])
    err = ctypes.create_string_buffer(1024)
    self._handle = self._lib.hb_data_reader_open(
        files_c, len(files), tf, tc, len(tasks),
        cols_c, defaults_c, self._ncols,
        batch_size, int(drop_remainder),
        int(shuffle), int(shuffle_buffer), int(seed),
        int(threads), int(prefetch),
        1 if format == 'orc' else 0, int(mmap),
        err, len(err))
    if not self._handle:
      raise RuntimeError(f'native reader open failed: {err.value.decode()}')

  def __iter__(self):
    return self

  def __next__(self) -> Dict[str, object]:
    if not self._handle:
      raise StopIteration
    cols = (_ColDesc * self._ncols)()
    token_ptr = ctypes.c_void_p()
    err = ctypes.create_string_buffer(1024)
    n = self._lib.hb_data_reader_next(
        self._handle, cols, ctypes.byref(token_ptr), err, len(err))
    if n == 0:
      raise StopIteration
    if n < 0:
      raise RuntimeError(f'native read failed: {err.value.decode()}')
    token = _Token(self._lib, token_ptr.value or 0)
    out: Dict[str, object] = {}
    for i, f in enumerate(self._fields):
      c = cols[i]
      if c.dtype == _STRING:  # utf-8 bytes + char offsets
        data = _wrap(c.values, c.num_values, np.dtype(np.uint8), token)
        offs = _wrap(c.splits, n + 1, np.dtype(np.int64), token)
        out[f.name] = np.array(
            [data[offs[j]:offs[j + 1]].tobytes().decode('utf-8',
                                                        'replace')
             for j in range(n)], dtype=object)
        continue
      dtype = _CODE_DTYPES[c.dtype]
      values = _wrap(c.values, c.num_values, dtype, token)
      if c.ragged == 3:   # list<list<T>>: two rebased split levels
        outer = _wrap(c.splits, n + 1, np.dtype(np.int64), token)
        inner = _wrap(c.splits2, c.num_inner + 1, np.dtype(np.int64),
                      token)
        out[f.name] = Value(values, [outer, inner])
      elif c.ragged:
        splits = _wrap(c.splits, n + 1, np.dtype(np.int64), token)
        out[f.name] = Value(values, [splits])
      else:
        out[f.name] = values
    return out

  def close(self):
    """Stops the pipeline's threads; batches already handed out stay
    valid."""
    if getattr(self, '_handle', None):
      self._lib.hb_data_reader_close(self._handle)
      self._handle = None

  def __del__(self):
    self.close()


__all__ = ['NativeLibrary', 'NativeTabularIterator', 'NativeUnavailable',
           'arrow_toolchain', 'build', 'load', 'unsupported']
