"""Row-sparse updates over a row-sorted update list.

Counterparts of ``hybridbackend_tpu/ops/pallas/scatter.py``:
``adagrad_update_sorted``, ``scatter_add_sorted``, ``adam_update_sorted``
and ``gsum_dense_sorted``. On a CUDA tensor each wrapper launches its
hand-written kernel (``csrc/adagrad_update.cu``, ``csrc/scatter_add.cu``,
``csrc/adam_update.cu``, ``csrc/gsum_dense.cu``, all four built on
``csrc/sorted_runs.cuh``) or raises; on a CPU
tensor it runs the plain PyTorch version beside it (``*_reference``),
which the tests hold against the JAX package. The three updates work in
place and return their tensors; rows ``< 0`` or ``>= V`` are skipped,
and rows not in the list are neither read nor written.
``gsum_dense_sorted`` returns a new dense tensor of per-row totals;
``dense_row_totals`` gives the same totals of an unsorted list, through a
stable sort and kernel 4: the backward of every differentiable table
lookup (``embedding/lookup.py``), in list order on every device.

The three updates take float32 or bfloat16 tables, with slots of the
table's dtype, as the JAX kernels do. The gradients are rounded to that
dtype, the math is float32 (per-row totals summed in list order), and
each stored result is rounded to the storage dtype once, to nearest. A
bfloat16 table on a CUDA tensor launches the kernel's ``_bf16`` symbol.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from hybridbackend_tpu_torch.ops import build

Lr = Union[float, torch.Tensor]
Step = Union[int, float, torch.Tensor]

# How the kernels on ``csrc/sorted_runs.cuh`` cut their work, chosen by
# measurement at the flagship list (``chip_smoke.py --tune``).
# ``scatter_add_sorted``, ``adagrad_update_sorted`` and
# ``adam_update_sorted``: a block takes a tile of this many list entries,
# fewer for a wide row, so that a tile's updates are at most TILE_BYTES.
TILE_ENTRIES = 128
TILE_BYTES = 32 * 1024
# ``adagrad_update_sorted`` and ``adam_update_sorted``: a thread loads the
# state rows of up to this many run heads (1, 2, 4 or 8) before it waits
# for its tile's gradients. At tiles of 128 entries of d = 16 a thread
# serves 2 entries, so 2 holds them all with the fewest registers.
STATE_BATCH = 2
# ``gsum_dense_sorted``: a block owns about this many bytes of output rows
# and walks its slice of the list in chunks of at most this many entries
# (fewer for a wide row: a chunk's updates are at most TILE_BYTES too);
# twice a chunk's buffer is the ring that streams a long run's tail.
GSUM_BLOCK_BYTES = 512 * 1024
GSUM_CHUNK_ENTRIES = 512
_GSUM_MAX_BLOCK_ROWS = 8192      # one flag byte a row in shared memory


def tile_entries(d: int) -> int:
  """List entries in a tile of ``scatter_add_sorted``,
  ``adagrad_update_sorted`` and ``adam_update_sorted`` at row width
  ``d``."""
  return max(16, min(TILE_ENTRIES, TILE_BYTES // (4 * max(d, 1))))


def gsum_blocking(vocab: int, d: int, sms: int) -> Tuple[int, int]:
  """``(block_rows, chunk)`` of ``gsum_dense_sorted`` for a ``[vocab, d]``
  output on a card of ``sms`` SMs. A block owns ``block_rows`` whole rows,
  about GSUM_BLOCK_BYTES of them, a multiple of 4 (so every block's range
  starts on a 16-byte boundary), and fewer where that brings the number of
  blocks to whole rounds of the SMs, at least one: all blocks are resident
  at once, so the kernel takes as long as the SM with the most blocks, and
  a table smaller than a round of blocks (a dense ``Trainer``'s [100000,
  16]) is spread over every SM."""
  d = max(d, 1)
  rows = max(4, min(_GSUM_MAX_BLOCK_ROWS, GSUM_BLOCK_BYTES // (4 * d)))
  blocks = -(-vocab // rows)
  blocks = -(-blocks // sms) * sms
  rows = -(-vocab // blocks)
  chunk = max(16, min(GSUM_CHUNK_ENTRIES, TILE_BYTES // (4 * d)))
  return max(4, -(-rows // 4) * 4), chunk


_STORAGE = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def _check(name: str, table: torch.Tensor, slots: Sequence[torch.Tensor],
           rows: torch.Tensor, updates: torch.Tensor):
  for t in (table, *slots):
    if t.dtype not in _STORAGE or t.dtype != table.dtype:
      raise TypeError(f'{name} takes a float32 or bfloat16 table and slots '
                      f'of its dtype; got {table.dtype} and '
                      f'{[s.dtype for s in slots]}')
    if t.shape != table.shape or table.dim() != 2:
      raise ValueError(f'{name}: table {tuple(table.shape)} and slots '
                       f'{[tuple(s.shape) for s in slots]} must be one '
                       '[V, d] shape')
  if rows.dtype != torch.int32 or rows.dim() != 1:
    raise TypeError(f'rows must be int32 [N]; got {rows.dtype} '
                    f'{tuple(rows.shape)}')
  if updates.shape != (rows.shape[0], table.shape[1]):
    raise ValueError(f'updates {tuple(updates.shape)} must be '
                     f'[{rows.shape[0]}, {table.shape[1]}]')
  devices = {t.device for t in (table, *slots, rows, updates)}
  if len(devices) != 1:
    raise ValueError(f'operands lie on several devices: {devices}')


def _run_totals(table: torch.Tensor, rows: torch.Tensor,
                updates: torch.Tensor, square: bool = False):
  """Distinct valid rows and the f32 totals of their updates, rounded to
  the table's dtype first, summed by ``index_add_`` in list order (on the
  CPU; atomics on a card). ``square`` adds the per-occurrence sums of
  squares."""
  valid = (rows >= 0) & (rows < table.shape[0])
  urows, inverse = torch.unique(rows[valid].to(torch.int64),
                                return_inverse=True)
  g = updates[valid].to(table.dtype).to(torch.float32)
  shape = (urows.shape[0], table.shape[1])
  gsum = torch.zeros(shape, dtype=torch.float32, device=table.device)
  gsum.index_add_(0, inverse, g)
  if not square:
    return urows, gsum, None
  qsum = torch.zeros(shape, dtype=torch.float32, device=table.device)
  qsum.index_add_(0, inverse, g * g)
  return urows, gsum, qsum


def _device_scalar(x, device: torch.device) -> torch.Tensor:
  """A 0-d float32 tensor on ``device``; a Python number is written there
  without a host sync."""
  if isinstance(x, torch.Tensor):
    return x.to(device=device, dtype=torch.float32).reshape(())
  return torch.full((), float(x), dtype=torch.float32, device=device)


def _launch_target(name: str, *tensors: torch.Tensor) -> torch.device:
  device = tensors[0].device
  if device.type != 'cuda':
    raise ValueError(f'{name}: no kernel for device {device}')
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError(f'{name}: table and slots must be contiguous: the '
                     'kernel updates them in place')
  return device


def _launch(wrapper, library: str, dtype: torch.dtype, argtypes,
            device: torch.device, *args):
  """Calls ``hb_<wrapper>_f32`` or ``_bf16`` (by the storage ``dtype``) of
  ``csrc/<library>.cu`` on the current stream of ``device``
  (:func:`build.launch`)."""
  build.launch(wrapper, library, f'hb_{wrapper.__name__}_{_STORAGE[dtype]}',
               argtypes, device, *args)


# --------------------------------------------------------------------------
# Kernel 1: Adagrad
# --------------------------------------------------------------------------


def adagrad_update_sorted_reference(table: torch.Tensor, acc: torch.Tensor,
                                    rows: torch.Tensor,
                                    updates: torch.Tensor, lr: Lr,
                                    eps: float = 1e-7, dedup: bool = True
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version: per-row f32 totals by ``index_add_`` in list
  order, then the Adagrad apply on the distinct rows: table and acc read
  as f32, f32 math, each result rounded once to the storage dtype (the
  denominator from the unrounded accumulator). ``dedup=False``
  accumulates the per-occurrence squares instead of the total's square.
  Updates ``table`` and ``acc`` in place and returns them. Rows need not
  be sorted."""
  urows, gsum, qsum = _run_totals(table, rows, updates, square=not dedup)
  a = acc[urows].float() + (gsum * gsum if dedup else qsum)
  acc[urows] = a.to(acc.dtype)
  table[urows] = (table[urows].float() - lr * gsum / (torch.sqrt(a) + eps)
                  ).to(table.dtype)
  return table, acc


def adagrad_update_sorted_exact(table: torch.Tensor, acc: torch.Tensor,
                                rows: torch.Tensor, updates: torch.Tensor,
                                lr: float, eps: float = 1e-7,
                                dedup: bool = True
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The CUDA kernel's arithmetic on CPU tensors, in place: the plain
  version's per-row totals (``index_add_`` in list order), then the apply
  in f32 with numpy's correctly rounded square root and quotient, each
  result rounded once to the storage dtype. The kernel's ``sqrtf`` and
  ``__fdiv_rn`` round correctly, and torch's CPU ``sqrt`` need not: torch
  2.13 on an AVX-512 host gave a root one ulp below the correctly rounded
  one at a few elements (against a 60-digit decimal root), so the plain
  version may differ from the kernel in the last bit of a few table
  elements, and this version agrees with it bit for bit. Returns
  ``(table, acc)``."""
  urows, s, q = _run_totals(table, rows, updates, square=not dedup)
  s = s.numpy()
  a = acc[urows].float().numpy() + (s * s if dedup else q.numpy())
  t = table[urows].float().numpy() - np.float32(lr) * s / (
      np.sqrt(a) + np.float32(eps))
  acc[urows] = torch.from_numpy(a).to(acc.dtype)
  table[urows] = torch.from_numpy(t).to(table.dtype)
  return table, acc


def adagrad_update_sorted(table: torch.Tensor, acc: torch.Tensor,
                          rows: torch.Tensor, updates: torch.Tensor,
                          lr: Lr, eps: float = 1e-7, dedup: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Fused sparse Adagrad, in place: for each distinct valid row ``r``
  with gradient total ``s``, ``acc[r] += s²`` (``dedup=False``: the sum
  of each occurrence's square, TF ``SparseApplyAdagrad``) and then
  ``table[r] -= lr·s/(sqrt(acc[r])+eps)``. Returns ``(table, acc)``.

  Args:
    table, acc: float32 or bfloat16 (one dtype) ``[V, d]``, contiguous.
    rows: int32 ``[N]`` in ascending order (the CUDA kernel relies on
      it); entries ``< 0`` or ``>= V`` are skipped.
    updates: ``[N, d]`` gradients, ``updates[i]`` for ``rows[i]``,
      rounded to the table's dtype.
    lr: a float or a 0-d float32 tensor (read on the device, so a
      schedule needs no host round trip).
  """
  _check('adagrad_update_sorted', table, (acc,), rows, updates)
  if table.device.type == 'cpu':
    return adagrad_update_sorted_reference(table, acc, rows, updates, lr,
                                           eps, dedup)
  device = _launch_target('adagrad_update_sorted', table, acc)
  rows = rows.contiguous()
  updates = updates.to(table.dtype).contiguous()
  lr_t = _device_scalar(lr, device)
  _launch(adagrad_update_sorted, 'adagrad_update', table.dtype,
          (ctypes.c_void_p,) * 5 + (ctypes.c_float, ctypes.c_int64,
                                    ctypes.c_int64) + (ctypes.c_int,) * 4,
          device, table.data_ptr(), acc.data_ptr(), rows.data_ptr(),
          updates.data_ptr(), lr_t.data_ptr(), float(eps), rows.shape[0],
          table.shape[0], table.shape[1], int(dedup),
          tile_entries(table.shape[1]), STATE_BATCH)
  return table, acc


adagrad_update_sorted.launches = 0


# --------------------------------------------------------------------------
# Kernel 2: add
# --------------------------------------------------------------------------


def scatter_add_sorted_reference(table: torch.Tensor, rows: torch.Tensor,
                                 updates: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch version: per-row f32 totals by ``index_add_`` in list
  order, each added to its row (read as f32) once and rounded once to the
  table's dtype. Updates ``table`` in place and returns it. Rows need not
  be sorted."""
  urows, gsum, _ = _run_totals(table, rows, updates)
  table[urows] = (table[urows].float() + gsum).to(table.dtype)
  return table


def scatter_add_sorted(table: torch.Tensor, rows: torch.Tensor,
                       updates: torch.Tensor) -> torch.Tensor:
  """``table[r] += Σ updates[i]`` over each run of equal rows, in place;
  returns ``table``. ``table`` float32 or bfloat16 ``[V, d]`` contiguous;
  ``rows`` int32 ``[N]`` ascending (the CUDA kernel relies on it), entries
  ``< 0`` or ``>= V`` skipped; ``updates`` ``[N, d]``, rounded to the
  table's dtype."""
  _check('scatter_add_sorted', table, (), rows, updates)
  if table.device.type == 'cpu':
    return scatter_add_sorted_reference(table, rows, updates)
  device = _launch_target('scatter_add_sorted', table)
  rows = rows.contiguous()
  updates = updates.to(table.dtype).contiguous()
  _launch(scatter_add_sorted, 'scatter_add', table.dtype,
          (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_int),
          device, table.data_ptr(), rows.data_ptr(), updates.data_ptr(),
          rows.shape[0], table.shape[0], table.shape[1],
          tile_entries(table.shape[1]))
  return table


scatter_add_sorted.launches = 0


# --------------------------------------------------------------------------
# Kernel 3: LazyAdam
# --------------------------------------------------------------------------


def adam_update_sorted_reference(table: torch.Tensor, m: torch.Tensor,
                                 v: torch.Tensor, rows: torch.Tensor,
                                 updates: torch.Tensor, lr: Lr, step: Step,
                                 b1: float = 0.9, b2: float = 0.999,
                                 eps: float = 1e-8
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
  """Plain PyTorch version of :func:`adam_update_sorted`: per-row f32
  totals by ``index_add_`` in list order, then LazyAdam on the distinct
  rows present, in the kernel's order of operations: table, m and v read
  as f32, f32 math, each result rounded once to the storage dtype (the
  table's step from the unrounded moments). Rows need not be sorted."""
  urows, s, _ = _run_totals(table, rows, updates)
  t = _device_scalar(step, table.device)
  bc1 = 1 - torch.full_like(t, b1) ** t
  bc2 = 1 - torch.full_like(t, b2) ** t
  mn = b1 * m[urows].float() + (1 - b1) * s
  vn = b2 * v[urows].float() + (1 - b2) * s * s
  m[urows] = mn.to(m.dtype)
  v[urows] = vn.to(v.dtype)
  table[urows] = (table[urows].float() - lr * (mn / bc1) / (
      torch.sqrt(vn / bc2) + eps)).to(table.dtype)
  return table, m, v


def adam_update_sorted(table: torch.Tensor, m: torch.Tensor,
                       v: torch.Tensor, rows: torch.Tensor,
                       updates: torch.Tensor, lr: Lr, step: Step,
                       b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Fused sparse LazyAdam, in place: for each distinct valid row ``r``
  in the list with gradient total ``s`` (``s == 0`` included: TF
  LazyAdam updates every indexed row), ``m[r] = b1·m[r] + (1-b1)·s``,
  ``v[r] = b2·v[r] + (1-b2)·s²`` and ``table[r] -= lr·(m[r]/bc1) /
  (sqrt(v[r]/bc2) + eps)`` with ``bc = 1 - b**step``. Moments of rows not
  in the list do not decay. Returns ``(table, m, v)``.

  Args:
    table, m, v: float32 or bfloat16 (one dtype) ``[V, d]``, contiguous.
    rows: int32 ``[N]`` ascending; entries ``< 0`` or ``>= V`` skipped.
    updates: ``[N, d]`` gradients, rounded to the table's dtype.
    lr: a float or a 0-d float32 tensor, read on the device.
    step: the 1-based step count for bias correction, a number or a 0-d
      tensor, read on the device.
  """
  _check('adam_update_sorted', table, (m, v), rows, updates)
  if table.device.type == 'cpu':
    return adam_update_sorted_reference(table, m, v, rows, updates, lr,
                                        step, b1, b2, eps)
  device = _launch_target('adam_update_sorted', table, m, v)
  rows = rows.contiguous()
  updates = updates.to(table.dtype).contiguous()
  lr_t = _device_scalar(lr, device)
  step_t = _device_scalar(step, device)
  # 1 - b1 and 1 - b2 rounded from Python floats, as the plain version
  # and the JAX package's XLA path (``_adam_rows``) round them.
  _launch(adam_update_sorted, 'adam_update', table.dtype,
          (ctypes.c_void_p,) * 7 + (ctypes.c_float,) * 5 + (
              ctypes.c_int64, ctypes.c_int64) + (ctypes.c_int,) * 3,
          device, table.data_ptr(), m.data_ptr(), v.data_ptr(),
          rows.data_ptr(), updates.data_ptr(), lr_t.data_ptr(),
          step_t.data_ptr(), float(b1), float(b2), 1 - float(b1),
          1 - float(b2), float(eps), rows.shape[0], table.shape[0],
          table.shape[1], tile_entries(table.shape[1]), STATE_BATCH)
  return table, m, v


adam_update_sorted.launches = 0


# --------------------------------------------------------------------------
# Kernel 4: dense per-row totals
# --------------------------------------------------------------------------


def gsum_dense_sorted_reference(rows: torch.Tensor, updates: torch.Tensor,
                                vocab: int) -> torch.Tensor:
  """Plain PyTorch version of :func:`gsum_dense_sorted`: ``zeros`` and
  then ``index_add_`` of the valid entries in list order (on the CPU;
  atomics on a card). The contract is the kernel's, rows ascending; this
  version also sums rows in any order, which the kernel does not."""
  valid = (rows >= 0) & (rows < vocab)
  out = torch.zeros((vocab, updates.shape[1]), dtype=torch.float32,
                    device=updates.device)
  return out.index_add_(0, rows[valid].to(torch.int64),
                        updates[valid].to(torch.float32))


def gsum_dense_sorted(rows: torch.Tensor, updates: torch.Tensor,
                      vocab: int) -> torch.Tensor:
  """Dense per-row totals of a row-sorted update list: a new float32
  ``[vocab, d]`` tensor whose row ``r`` is the f32 sum of
  ``updates[i]`` over the run of ``rows[i] == r``, in list order, and
  whose other rows are exactly 0.0. Any ``d``.

  Args:
    rows: int32 ``[N]`` in ascending order; entries ``< 0`` or
      ``>= vocab`` are skipped. The CUDA kernel gives each run of equal
      rows one owner, so rows out of order there give wrong totals; it
      does not check, since that would wait for the device. On a CPU
      tensor the order is checked and a ValueError raised.
    updates: ``[N, d]``, ``updates[i]`` for ``rows[i]``.
    vocab: rows of the output.
  """
  if rows.dtype != torch.int32 or rows.dim() != 1:
    raise TypeError(f'rows must be int32 [N]; got {rows.dtype} '
                    f'{tuple(rows.shape)}')
  if updates.dim() != 2 or updates.shape[0] != rows.shape[0]:
    raise ValueError(f'updates {tuple(updates.shape)} must be '
                     f'[{rows.shape[0]}, d]')
  if rows.device != updates.device:
    raise ValueError(f'rows on {rows.device}, updates on {updates.device}')
  if updates.device.type == 'cpu':
    if bool((rows[1:] < rows[:-1]).any()):
      raise ValueError('gsum_dense_sorted: rows must be in ascending order')
    return gsum_dense_sorted_reference(rows, updates, vocab)
  rows = rows.contiguous()
  updates = updates.to(torch.float32).contiguous()
  device = _launch_target('gsum_dense_sorted', updates)
  out = torch.empty((vocab, updates.shape[1]), dtype=torch.float32,
                    device=device)
  block_rows, chunk = gsum_blocking(
      vocab, updates.shape[1],
      torch.cuda.get_device_properties(device).multi_processor_count)
  _launch(gsum_dense_sorted, 'gsum_dense', torch.float32,
          (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int64)
          + (ctypes.c_int,) * 3,
          device, out.data_ptr(), rows.data_ptr(), updates.data_ptr(),
          rows.shape[0], vocab, updates.shape[1], block_rows, chunk)
  return out


gsum_dense_sorted.launches = 0


def dense_row_totals(rows: torch.Tensor, updates: torch.Tensor,
                     vocab: int) -> torch.Tensor:
  """Dense per-row totals of an update list in any order: a new float32
  ``[vocab, d]`` tensor whose row ``r`` is the f32 sum, from 0.0 in list
  order, of ``updates[i]`` over every ``rows[i] == r``, and whose other
  rows are exactly 0.0. That is the JAX package's scatter-add (the
  transpose of ``jnp.take``) on the CPU, bit for bit, and the same bits
  on every call on a card, where an ``index_add_`` adds with atomics in
  no fixed order.

  ``rows`` (any integer dtype, ``[N]``) are sorted stably, so each run
  keeps its list order, ``updates`` (``[N, d]``) are permuted alike, and
  the sorted list goes to :func:`gsum_dense_sorted` (kernel 4; its
  launches are counted there). Entries ``< 0`` or ``>= vocab`` are
  skipped. On a CPU tensor the plain version runs on the sorted list."""
  if rows.dim() != 1 or updates.dim() != 2 or (
      updates.shape[0] != rows.shape[0]):
    raise ValueError(f'rows {tuple(rows.shape)} and updates '
                     f'{tuple(updates.shape)} must be [N] and [N, d]')
  if rows.dtype != torch.int32:
    # Clamped before the cast, so that no entry wraps into the table; the
    # kernel skips -1 and vocab.
    rows = rows.clamp(-1, vocab).to(torch.int32)
  rows, order = torch.sort(rows, stable=True)
  updates = updates.index_select(0, order)
  if updates.device.type == 'cpu':
    return gsum_dense_sorted_reference(rows, updates, vocab)
  return gsum_dense_sorted(rows, updates, vocab)


__all__ = ['adagrad_update_sorted', 'adagrad_update_sorted_reference',
           'adam_update_sorted', 'adam_update_sorted_reference',
           'dense_row_totals', 'gsum_dense_sorted',
           'gsum_dense_sorted_reference',
           'scatter_add_sorted', 'scatter_add_sorted_reference']
