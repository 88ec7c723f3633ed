"""Fused row-sparse Adagrad over a row-sorted update list.

Counterpart of ``hybridbackend_tpu/ops/pallas/scatter.py:
adagrad_update_sorted``. On a CUDA tensor :func:`adagrad_update_sorted`
launches the hand-written kernel in ``csrc/adagrad_update.cu`` or
raises; on a CPU tensor it runs :func:`adagrad_update_sorted_reference`,
the plain PyTorch version that the tests hold against the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

Lr = Union[float, torch.Tensor]


def _check(table, acc, rows, updates):
  if table.dtype != torch.float32 or acc.dtype != torch.float32:
    raise TypeError('adagrad_update_sorted takes float32 table and acc; '
                    f'got {table.dtype}, {acc.dtype}')
  if table.dim() != 2 or acc.shape != table.shape:
    raise ValueError(f'table {tuple(table.shape)} and acc '
                     f'{tuple(acc.shape)} must be one [V, d] shape')
  if rows.dtype != torch.int32 or rows.dim() != 1:
    raise TypeError(f'rows must be int32 [N]; got {rows.dtype} '
                    f'{tuple(rows.shape)}')
  if updates.shape != (rows.shape[0], table.shape[1]):
    raise ValueError(f'updates {tuple(updates.shape)} must be '
                     f'[{rows.shape[0]}, {table.shape[1]}]')
  devices = {t.device for t in (table, acc, rows, updates)}
  if len(devices) != 1:
    raise ValueError(f'operands lie on several devices: {devices}')


def adagrad_update_sorted_reference(table: torch.Tensor, acc: torch.Tensor,
                                    rows: torch.Tensor,
                                    updates: torch.Tensor, lr: Lr,
                                    eps: float = 1e-7
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version: per-row f32 totals by ``index_add_`` in list
  order, then the Adagrad apply on the distinct rows. Updates ``table``
  and ``acc`` in place and returns them. Rows need not be sorted."""
  valid = (rows >= 0) & (rows < table.shape[0])
  urows, inverse = torch.unique(rows[valid].to(torch.int64),
                                return_inverse=True)
  gsum = torch.zeros((urows.shape[0], table.shape[1]), dtype=torch.float32,
                     device=table.device)
  gsum.index_add_(0, inverse, updates[valid].to(torch.float32))
  a = acc[urows] + gsum * gsum
  acc[urows] = a
  table[urows] = table[urows] - lr * gsum / (torch.sqrt(a) + eps)
  return table, acc


def adagrad_update_sorted(table: torch.Tensor, acc: torch.Tensor,
                          rows: torch.Tensor, updates: torch.Tensor,
                          lr: Lr, eps: float = 1e-7
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Fused sparse Adagrad, in place: for each distinct valid row ``r``
  with gradient total ``s``, ``acc[r] += s²`` and
  ``table[r] -= lr·s/(sqrt(acc[r])+eps)``. Returns ``(table, acc)``.

  Args:
    table, acc: float32 ``[V, d]``, contiguous.
    rows: int32 ``[N]`` in ascending order (the CUDA kernel relies on
      it); entries ``< 0`` or ``>= V`` are skipped.
    updates: ``[N, d]`` gradients, ``updates[i]`` for ``rows[i]``.
    lr: a float or a 0-d float32 tensor (read on the device, so a
      schedule needs no host round trip).
  """
  _check(table, acc, rows, updates)
  if table.device.type == 'cpu':
    return adagrad_update_sorted_reference(table, acc, rows, updates, lr,
                                           eps)
  if table.device.type != 'cuda':
    raise ValueError(f'no kernel for device {table.device}')
  if not (table.is_contiguous() and acc.is_contiguous()):
    raise ValueError('table and acc must be contiguous: the kernel '
                     'updates them in place')
  rows = rows.contiguous()
  updates = updates.to(torch.float32).contiguous()
  if isinstance(lr, torch.Tensor):
    lr_t = lr.to(device=table.device, dtype=torch.float32).reshape(())
  else:
    lr_t = torch.full((), float(lr), dtype=torch.float32,
                      device=table.device)
  fn = _kernel()
  with torch.cuda.device(table.device):
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), acc.data_ptr(), rows.data_ptr(),
             updates.data_ptr(), lr_t.data_ptr(), float(eps),
             rows.shape[0], table.shape[0], table.shape[1], stream)
  if err != 0:
    raise RuntimeError(f'adagrad_update_sorted kernel launch failed: '
                       f'CUDA error {err}')
  adagrad_update_sorted.launches += 1
  return table, acc


adagrad_update_sorted.launches = 0


@functools.cache
def _kernel():
  from hybridbackend_tpu_torch.ops.build import load
  fn = load('adagrad_update').lib.hb_adagrad_update_sorted_f32
  fn.argtypes = [ctypes.c_void_p] * 5 + [
      ctypes.c_float, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
      ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn


__all__ = ['adagrad_update_sorted', 'adagrad_update_sorted_reference']
