"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` into a shared library at first use and loaded with ``ctypes``.
The library's file name carries a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is reused. Libraries go
to ``hybridbackend_tpu_torch/_build/``, which git ignores.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent / 'csrc'
_BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
          '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


@dataclasses.dataclass
class Library:
  """A loaded kernel library and how it was obtained."""
  lib: ctypes.CDLL
  path: Path
  build_seconds: float     # 0.0 when an existing build was reused
  compiler_log: str        # nvcc/ptxas output (registers, spills)


_LOADED: Dict[str, Library] = {}


def nvcc_path() -> str:
  from torch.utils.cpp_extension import CUDA_HOME
  if CUDA_HOME is None:
    raise RuntimeError('no CUDA toolkit found (set CUDA_HOME or put nvcc '
                       'on PATH) to build the port\'s kernels')
  return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def load(name: str) -> Library:
  """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
  if name in _LOADED:
    return _LOADED[name]
  src = _CSRC / f'{name}.cu'
  digest = hashlib.sha256(src.read_bytes() + ' '.join(_FLAGS).encode())
  out = _BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'
  seconds, log = 0.0, ''
  if not out.exists():
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name, then rename: a concurrent loader
    # never sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
      proc = subprocess.run([nvcc_path(), *_FLAGS, '-o', tmp, str(src)],
                            capture_output=True, text=True)
      if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {src}:\n{proc.stdout}'
                           f'{proc.stderr}')
      os.replace(tmp, out)
    finally:
      if os.path.exists(tmp):
        os.unlink(tmp)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
  _LOADED[name] = Library(ctypes.CDLL(str(out)), out, seconds, log)
  return _LOADED[name]


__all__ = ['Library', 'load', 'nvcc_path']
