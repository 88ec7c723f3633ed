"""Columnar schema: fields and ragged values.

The port's own copy of ``hybridbackend_tpu/data/dataframe.py`` (the
reference's DataFrame layer, ``hybridbackend/tensorflow/data/
dataframe.py:52-779``): ``Field`` declares a column (name, dtype, ragged
rank, inner shape, default value); ``Value`` carries a ragged batch as
flat values plus nested row splits. A ragged column reaches the device as
padded-dense values and a mask (``to_padded``, through ``parse``); COO
export (``to_coo``) is for host-side interop and tests.

The rank-1 padding (``Value.to_padded``) and the row takes of a rank-1
ragged column and of a dense one (``take_rows``) go through the port's
native helpers (``native/idmap.py``: ``ragged_to_padded``,
``ragged_take_rows``, ``take_rows_dense``, its copy of the JAX package's
``hbtpu_native.cc``), where the JAX package sends them to its own
(``hybridbackend_tpu/data/dataframe.py:179,326,337``), for the values
those helpers take: C-contiguous ``float32``, ``int64`` or ``int32``
values for the padding, C-contiguous values of any fixed-size dtype for
the takes (a rank-1 ragged column's flat values). Other values, and
deeper ragged ranks, take the numpy paths, as in JAX. The library is
built at first use; where it cannot be built, the helpers raise
``NativeUnavailable`` with the reason, and nothing falls back to numpy
unasked. ``native=False`` takes the numpy paths: the plain versions that
the helpers are held against, bit for bit
(``tests/test_torch_dataframe.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Field:
  """Declares one column of a tabular dataset.

  Mirrors reference ``DataFrame.Field`` (``dataframe.py:54-280``).

  Attributes:
    name: column name.
    dtype: numpy dtype of the values.
    ragged_rank: 0 = dense scalar/vector column; 1 = list column;
      2 = list<list> column, etc.
    shape: inner dense shape of each element (after ragged nesting).
    default_value: fill value used by ``populate_defaults`` and padding.
    max_len: static padded length per ragged dimension on device
      (None = derive from data, rounded up to a power of two). For
      ragged_rank >= 2 a tuple gives one entry per ragged level
      (an int applies to the innermost level only).
  """
  name: str
  dtype: Any = np.int64
  ragged_rank: int = 0
  shape: Tuple[int, ...] = ()
  default_value: Any = 0
  max_len: Union[int, Tuple[int, ...], None] = None

  def __post_init__(self):
    object.__setattr__(self, 'dtype', np.dtype(self.dtype))
    object.__setattr__(self, 'shape', tuple(self.shape))

  @property
  def ragged(self) -> bool:
    return self.ragged_rank > 0


class Value:
  """A ragged batch: flat values + nested row splits (outermost first).

  ``row_splits[0]`` partitions rows of the batch; deeper splits partition
  the level above. A dense batch has ``row_splits == ()``.
  Reference: ``DataFrame.Value`` (``dataframe.py:282-396``).
  """

  __slots__ = ('values', 'row_splits')

  def __init__(self, values: np.ndarray,
               row_splits: Sequence[np.ndarray] = ()):
    self.values = np.asarray(values)
    self.row_splits = tuple(np.asarray(s, dtype=np.int64)
                            for s in row_splits)

  @property
  def ragged_rank(self) -> int:
    return len(self.row_splits)

  @property
  def batch_size(self) -> int:
    if self.row_splits:
      return len(self.row_splits[0]) - 1
    return len(self.values)

  def __len__(self) -> int:
    return self.batch_size

  def __repr__(self) -> str:
    return (f'Value(values={self.values.shape}@{self.values.dtype}, '
            f'ragged_rank={self.ragged_rank}, batch={self.batch_size})')

  # -- conversions --------------------------------------------------------

  def to_list(self) -> List:
    """Nested python lists (for tests / parity with pandas)."""
    def expand(values, splits):
      if not splits:
        return list(values)
      s = splits[0]
      inner = expand(values, splits[1:])
      return [inner[s[i]:s[i + 1]] for i in range(len(s) - 1)]
    return expand(self.values, self.row_splits)

  def _coords(self) -> List[np.ndarray]:
    """Nested coordinates of every flat value: ``[row, p_1, ..., p_r]``
    where ``p_k`` is the value's position within its level-``k``
    segment. Vectorized bottom-up walk over the split levels."""
    splits = self.row_splits
    r = len(splits)
    level = []   # (parent_of_element, pos_within_parent) per level
    for s in splits:
      lens = np.diff(s)
      parent = np.repeat(np.arange(len(lens)), lens)
      pos = np.arange(int(s[-1])) - np.repeat(s[:-1], lens)
      level.append((parent, pos))
    coords = []
    cur = np.arange(int(splits[-1][-1]), dtype=np.int64)
    for k in range(r - 1, -1, -1):
      parent, pos = level[k]
      coords.append(pos[cur])
      cur = parent[cur]
    coords.append(cur)
    return coords[::-1]

  def _level_max_lens(self) -> List[int]:
    return [int(np.diff(s).max()) if len(s) > 1 else 0
            for s in self.row_splits]

  def to_padded(self, max_len=None, pad_value=0,
                native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a ragged value to the static device layout.

    rank 1 → ``[batch, L] (+inner shape)``; rank 2 → ``[batch, S, L]``
    (grouped sequences: S groups of up to L events each) —
    and so on for deeper nesting. ``max_len`` may be an int (innermost
    level; other levels derive from data) or a tuple with one entry per
    ragged level. Returns ``(padded, mask)`` with ``mask`` bool of the
    padded shape (a rank-2 outer mask is ``mask.any(-1)``). This is the
    canonical device layout (static shapes; the reference's nested
    SparseTensor path, ``dataframe.py:282-396``, maps here). A rank-1
    value pads through the native helper where it takes the values;
    ``native=False`` pads in numpy.
    """
    if self.ragged_rank == 0:
      raise ValueError('to_padded requires a ragged value')
    if self.ragged_rank > 1:
      r = self.ragged_rank
      if max_len is None:
        lens = (None,) * r
      elif np.ndim(max_len) == 0:
        lens = (None,) * (r - 1) + (int(max_len),)
      else:
        lens = tuple(max_len)
        if len(lens) != r:
          raise ValueError(
              f'max_len tuple must have {r} entries, got {lens}')
      dims = []
      for ml, m in zip(lens, self._level_max_lens()):
        if ml is None:
          ml = 1 << max(0, (max(m, 1) - 1)).bit_length()   # pow2 bucket
        dims.append(int(ml))
      n = self.batch_size
      coords = self._coords()
      inner = self.values.shape[1:]
      padded = np.full((n, *dims) + inner, pad_value, self.values.dtype)
      mask = np.zeros((n, *dims), np.bool_)
      ok = np.ones(len(coords[0]), np.bool_)
      for c, ml in zip(coords[1:], dims):
        ok &= c < ml
      sel = tuple(c[ok] for c in coords)
      padded[sel] = self.values[ok]
      mask[sel] = True
      return padded, mask
    splits = self.row_splits[0]
    lengths = np.diff(splits)
    n = len(lengths)
    if max_len is None:
      m = int(lengths.max()) if n else 1
      max_len = 1 << max(0, (m - 1)).bit_length()  # pow2 bucket
    if native and _pads_natively(self.values):
      from hybridbackend_tpu_torch.native import idmap
      return idmap.ragged_to_padded(self.values, splits, max_len, pad_value)
    inner = self.values.shape[1:]
    padded = np.full((n, max_len) + inner, pad_value, self.values.dtype)
    mask = np.zeros((n, max_len), np.bool_)
    clipped = np.minimum(lengths, max_len)
    # Vectorized ragged→padded scatter.
    row_idx = np.repeat(np.arange(n), clipped)
    col_idx = np.concatenate([np.arange(c) for c in clipped]) if n else \
        np.zeros((0,), np.int64)
    src_idx = np.concatenate(
        [np.arange(splits[i], splits[i] + clipped[i]) for i in range(n)]
    ) if n else np.zeros((0,), np.int64)
    padded[row_idx, col_idx] = self.values[src_idx]
    mask[row_idx, col_idx] = True
    return padded, mask

  def to_coo(self) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...]]:
    """COO export ``(indices [nnz, rank+1], values, dense_shape)`` —
    parity with the reference's ``.to_sparse()`` for any ragged rank
    (``dataframe.py:282-396``)."""
    if self.ragged_rank == 0:
      raise ValueError('to_coo requires a ragged value')
    coords = self._coords()
    indices = np.stack(coords, axis=1).astype(np.int64)
    dense_shape = (self.batch_size, *self._level_max_lens())
    return indices, self.values, dense_shape

  def flatten_inner(self) -> 'Value':
    """Merge the two innermost ragged levels."""
    if self.ragged_rank < 2:
      return self
    outer = self.row_splits[:-2]
    # compose: outer splits now index flat values via inner splits
    composed = self.row_splits[-1][self.row_splits[-2]]
    return Value(self.values, tuple(outer) + (composed,))

  # -- row ops (used by rebatch) ------------------------------------------

  def slice_rows(self, start: int, stop: int) -> 'Value':
    if not self.row_splits:
      return Value(self.values[start:stop])
    out_splits = []
    lo, hi = start, stop
    splits = self.row_splits
    for level in splits:
      seg = level[lo:hi + 1]
      out_splits.append(seg - seg[0])
      lo, hi = int(level[lo]), int(level[hi])
    return Value(self.values[lo:hi], out_splits)

  @staticmethod
  def concat(values: Sequence['Value']) -> 'Value':
    values = list(values)
    if not values:
      raise ValueError('concat of zero values')
    rank = values[0].ragged_rank
    if any(v.ragged_rank != rank for v in values):
      raise ValueError('mismatched ragged ranks')
    flat = np.concatenate([v.values for v in values])
    out_splits = []
    for lvl in range(rank):
      parts = [values[0].row_splits[lvl]]
      offset = values[0].row_splits[lvl][-1]
      for v in values[1:]:
        parts.append(v.row_splits[lvl][1:] + offset)
        offset = offset + v.row_splits[lvl][-1]
      out_splits.append(np.concatenate(parts))
    return Value(flat, out_splits)


Column = Union[np.ndarray, Value]
Batch = Dict[str, Column]


def from_arrow(array) -> Column:
  """Convert a pyarrow (Chunked)Array column to ndarray or ragged Value.

  This is the host analogue of the reference's zero-copy
  Arrow→Tensor conversion (``tensorflow/common/arrow.cc:44-97``): for
  primitive columns pyarrow hands back a NumPy view of the Arrow buffer
  without a copy (``zero_copy_only`` path); list columns decompose into
  offsets + flat values, again as buffer views.
  """
  import pyarrow as pa
  if isinstance(array, pa.ChunkedArray):
    array = array.combine_chunks()
  splits = []
  while pa.types.is_list(array.type) or pa.types.is_large_list(array.type):
    offset_view = array.offsets.to_numpy(zero_copy_only=False)
    splits.append(offset_view.astype(np.int64, copy=False))
    array = array.flatten()
  if pa.types.is_string(array.type) or pa.types.is_large_string(array.type):
    if array.null_count:
      array = array.fill_null('')  # null strings are empty (both paths)
    values = array.to_numpy(zero_copy_only=False)
  else:
    try:
      values = array.to_numpy(zero_copy_only=True)
    except pa.ArrowInvalid:
      values = array.to_numpy(zero_copy_only=False)
  if splits:
    return Value(values, splits)
  return values


def slice_rows(col: Column, start: int, stop: int) -> Column:
  if isinstance(col, Value):
    return col.slice_rows(start, stop)
  return col[start:stop]


def num_rows(col: Column) -> int:
  if isinstance(col, Value):
    return col.batch_size
  return len(col)


def concat_columns(cols: Sequence[Column]) -> Column:
  if isinstance(cols[0], Value):
    return Value.concat(cols)  # type: ignore[arg-type]
  return np.concatenate(cols)


def _gather_segments(splits: np.ndarray, seg_idx: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
  """Select segments ``seg_idx`` of a split level: returns the flat
  element indices of the chosen segments (in order) and the new
  splits."""
  starts = splits[:-1][seg_idx]
  lens = np.diff(splits)[seg_idx]
  new_splits = np.zeros(len(seg_idx) + 1, np.int64)
  np.cumsum(lens, out=new_splits[1:])
  total = int(new_splits[-1])
  src = (np.repeat(starts, lens)
         + (np.arange(total) - np.repeat(new_splits[:-1], lens)))
  return src, new_splits


def _pads_natively(values: np.ndarray) -> bool:
  """Whether ``native/idmap.py:ragged_to_padded`` takes ``values``."""
  return (values.dtype.name in ('float32', 'int64', 'int32')
          and values.flags.c_contiguous)


def _takes_natively(values: np.ndarray) -> bool:
  """Whether the native row takes take ``values``."""
  return values.flags.c_contiguous and values.dtype != object


def take_rows(col: Column, indices: np.ndarray,
              native: bool = True) -> Column:
  """Row-permute a column (used by shuffled rebatch). Works at any
  ragged rank: each split level gathers the segments its parent level
  selected. A rank-1 ragged column and a dense one go through the native
  row takes where they take the values; ``native=False`` takes the rows
  in numpy."""
  from hybridbackend_tpu_torch.native import idmap
  if isinstance(col, Value):
    if (native and col.ragged_rank == 1 and col.values.ndim == 1
        and _takes_natively(col.values)):
      values, splits = idmap.ragged_take_rows(col.values, col.row_splits[0],
                                              np.asarray(indices))
      return Value(values, [splits])
    seg = np.asarray(indices)
    out_splits = []
    for level in col.row_splits:
      seg, new_splits = _gather_segments(np.asarray(level), seg)
      out_splits.append(new_splits)
    return Value(col.values[seg], out_splits)
  arr = np.asarray(col)
  if native and _takes_natively(arr):
    return idmap.take_rows_dense(arr, np.asarray(indices))
  return arr[indices]


def parse(batch: Batch, fields: Sequence[Field]) -> Dict[str, Any]:
  """Convert a host batch to the device layout (reference
  ``DataFrame.parse`` ``dataframe.py:399-460``): dense columns pass
  through; ragged columns become ``name`` (padded) + ``name_mask``."""
  out: Dict[str, Any] = {}
  by_name = {f.name: f for f in fields}
  for name, col in batch.items():
    field = by_name.get(name)
    if isinstance(col, Value):
      pad = field.default_value if field else 0
      max_len = field.max_len if field else None
      padded, mask = col.to_padded(max_len=max_len, pad_value=pad)
      out[name] = padded
      out[name + '_mask'] = mask
    else:
      out[name] = col
  return out


def populate_defaults(batch: Batch, fields: Sequence[Field]) -> Batch:
  """Fill missing columns with their default value (reference
  ``dataframe.py:462+``)."""
  n = None
  for col in batch.values():
    n = num_rows(col)
    break
  if n is None:
    return batch
  out = dict(batch)
  for f in fields:
    if f.name not in out:
      if f.ragged:
        out[f.name] = Value(
            np.full((n,) + f.shape, f.default_value, f.dtype),
            [np.arange(n + 1, dtype=np.int64)])
      else:
        out[f.name] = np.full((n,) + f.shape, f.default_value, f.dtype)
  return out


__all__ = ['Field', 'Value', 'Batch', 'from_arrow', 'parse',
           'populate_defaults', 'slice_rows', 'num_rows', 'concat_columns',
           'take_rows']
