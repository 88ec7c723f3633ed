"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` into a shared library at first use and loaded with ``ctypes``.
The library's file name carries a hash of the source, of every header
beside it (``csrc/*.cuh``) and of the flags, so an edited source or header
is rebuilt and an unchanged one is reused. Libraries go
to ``hybridbackend_tpu_torch/_build/``, which git ignores.
:func:`load_all` starts one ``nvcc`` per missing library, all at once.
:func:`launch` calls a kernel's C function on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

_CSRC = Path(__file__).resolve().parent / 'csrc'
_BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
          '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
KERNELS = ('adagrad_update', 'scatter_add', 'adam_update', 'gsum_dense',
           'gather_rows', 'stochastic_round')


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


def headers() -> Tuple[Path, ...]:
  """The headers every library is built from and hashed with."""
  return tuple(sorted(_CSRC.glob('*.cuh')))


def _target(name: str) -> Path:
  digest = hashlib.sha256(' '.join(_FLAGS).encode())
  for path in (_CSRC / f'{name}.cu', *headers()):
    digest.update(path.name.encode() + path.read_bytes())
  return _BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'


def load_all(names: Sequence[str] = KERNELS) -> Dict[str, Library]:
  """Build (if needed) and load ``csrc/<name>.cu`` for each name; cached
  per process. Missing libraries are compiled concurrently."""
  builds = {}
  try:
    for name in names:
      out = _target(name)
      if name in _LOADED or out.exists():
        continue
      _BUILD_DIR.mkdir(parents=True, exist_ok=True)
      # Build under a temporary name, then rename: a concurrent loader
      # never sees a half-written library.
      fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
      os.close(fd)
      proc = subprocess.Popen(
          [nvcc_path(), *_FLAGS, '-I', str(_CSRC), '-o', tmp,
           str(_CSRC / f'{name}.cu')],
          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
      builds[name] = (proc, tmp, out, time.perf_counter())
    logs, failed = {}, []
    for name, (proc, tmp, out, t0) in builds.items():
      log = proc.communicate()[0]
      logs[name] = (time.perf_counter() - t0, log)
      if proc.returncode != 0:
        failed.append(f'nvcc failed on {name}.cu:\n{log}')
      else:
        os.replace(tmp, out)
    if failed:
      raise RuntimeError('\n'.join(failed))
  finally:
    for proc, tmp, _, _ in builds.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()
      if os.path.exists(tmp):
        os.unlink(tmp)
  for name in names:
    if name not in _LOADED:
      out = _target(name)
      seconds, log = logs.get(name, (0.0, ''))
      _LOADED[name] = Library(ctypes.CDLL(str(out)), out, seconds, log)
  return {name: _LOADED[name] for name in names}


def load(name: str) -> Library:
  """Build (if needed) and load one ``csrc/<name>.cu``."""
  return load_all((name,))[name]


@functools.cache
def _function(library: str, symbol: str, argtypes):
  fn = getattr(load(library).lib, symbol)
  fn.argtypes = list(argtypes)
  fn.restype = ctypes.c_int
  return fn


def launch(wrapper, library: str, symbol: str, argtypes,
           device: torch.device, *args):
  """Calls ``symbol`` of ``csrc/<library>.cu`` with ``args`` and then the
  current stream of ``device``, raises on a nonzero return (the C
  function returns ``cudaGetLastError()``), and counts the launch on
  ``wrapper.launches``."""
  fn = _function(library, symbol, tuple(argtypes) + (ctypes.c_void_p,))
  with torch.cuda.device(device):
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
  if err != 0:
    raise RuntimeError(f'{wrapper.__name__} kernel launch failed: CUDA '
                       f'error {err}')
  wrapper.launches += 1


__all__ = ['KERNELS', 'Library', 'headers', 'launch', 'load', 'load_all',
           'nvcc_path']
