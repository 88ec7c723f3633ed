"""Row gather with clipped ids.

Counterpart of ``hybridbackend_tpu/ops/pallas/gather.py``. The contract
is that module's: ``table[clip(ids, 0, V - 1)]``, so an id below 0 reads
row 0 and an id at or above ``V`` reads row ``V - 1``. That differs from
the embedding lookup (``embedding/lookup.py``), where invalid ids read
zeros: the serving lookup (``lookup(..., serving=True)`` and
``lookup_quantized``) gathers through this kernel and then masks them.
The training lookup keeps ``index_select`` in its forward, under a
backward of its own (``dense_row_totals``, kernel 4), which the dense
path needs; this kernel has none.

The kernel is the torch custom op ``hbtpu::gather_rows``, so that
``torch.export`` records it as one node of a graph (a traced program
holds no ``data_ptr``); a program that holds it can be loaded only once
this module is imported. :func:`gather_rows` calls the op, which
launches the hand-written kernel ``csrc/gather_rows.cu`` on a CUDA
tensor, or raises; on a CPU tensor it runs :func:`gather_rows_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from hybridbackend_tpu_torch.ops import build


def _check(table: torch.Tensor, ids: torch.Tensor):
  if table.dim() != 2:
    raise ValueError(f'table must be [V, d]; got {tuple(table.shape)}')
  if ids.dtype not in (torch.int32, torch.int64):
    raise TypeError(f'ids must be int32 or int64; got {ids.dtype}')
  if table.shape[0] == 0 and ids.numel():
    raise ValueError('cannot gather from a table with no rows')
  if table.device != ids.device:
    raise ValueError(f'table on {table.device}, ids on {ids.device}')


def gather_rows_reference(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch version: ``index_select`` of the clamped ids; returns
  ``ids.shape + (d,)``."""
  _check(table, ids)
  rows = ids.reshape(-1).to(torch.int64).clamp(0, max(table.shape[0] - 1,
                                                      0))
  return table.index_select(0, rows).reshape(*ids.shape, table.shape[1])


@torch.library.custom_op('hbtpu::gather_rows', mutates_args=())
def _gather_rows_op(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  if table.device.type == 'cpu':
    return gather_rows_reference(table, ids)
  _check(table, ids)
  if table.device.type != 'cuda':
    raise ValueError(f'gather_rows: no kernel for device {table.device}')
  if not table.is_contiguous():
    raise ValueError('gather_rows: the table must be contiguous')
  flat = ids.reshape(-1).contiguous()
  out = torch.empty((flat.shape[0], table.shape[1]), dtype=table.dtype,
                    device=table.device)
  build.launch(gather_rows, 'gather_rows', 'hb_gather_rows',
               (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64),
               table.device, out.data_ptr(), table.data_ptr(),
               flat.data_ptr(), int(flat.dtype == torch.int64),
               flat.shape[0], table.shape[0],
               table.shape[1] * table.element_size())
  return out.reshape(*ids.shape, table.shape[1])


@_gather_rows_op.register_fake
def _(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  return table.new_empty((*ids.shape, table.shape[1]))


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  """``table[clip(ids, 0, V - 1)]``: a new ``ids.shape + (d,)`` tensor of
  the table's type, through the op ``hbtpu::gather_rows``. Any ``N``, any
  ``d``, any element type; on a CUDA device the table must be contiguous.
  On a CPU tensor it runs :func:`gather_rows_reference`."""
  return torch.ops.hbtpu.gather_rows(table, ids)


gather_rows.launches = 0


__all__ = ['gather_rows', 'gather_rows_reference']
