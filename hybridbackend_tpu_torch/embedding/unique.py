"""Fixed-capacity unique.

Counterpart of ``hybridbackend_tpu/embedding/unique.py:22-71``, bit for
bit: a sort-based unique whose output has a fixed ``capacity`` (the
input length by default, always enough), so that a deduplicated exchange
has a fixed size. ``torch.unique`` has a data-dependent size; this one
does not, and reports when the true count exceeded the capacity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class UniqueResult(NamedTuple):
  """Attributes:
    values: ``[capacity]`` unique ids in ascending order, padded with
      ``fill_value``.
    index: ``[n]`` int32 with ``values[index] == ids`` (``tf.unique``'s
      ``idx``).
    count: 0-d int32, the valid entries of ``values``.
    overflowed: 0-d bool, whether the true unique count exceeded
      ``capacity``; then the surplus ids share slot ``capacity - 1``,
      which holds the largest of them, and ``values[index]`` is not
      ``ids``. A caller with a reduced capacity must branch on it.
  """
  values: torch.Tensor
  index: torch.Tensor
  count: torch.Tensor
  overflowed: torch.Tensor


def unique(ids: torch.Tensor, capacity: Optional[int] = None,
           fill_value: int = 0) -> UniqueResult:
  """Sort-based unique of the ``[n]`` ids with a static output size."""
  n = ids.shape[0]
  if capacity is None:
    capacity = n
  order = torch.argsort(ids, stable=True)
  sorted_ids = ids[order]
  is_first = torch.ones(n, dtype=torch.bool, device=ids.device)
  is_first[1:] = sorted_ids[1:] != sorted_ids[:-1]
  uidx = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
  count = uidx[-1] + 1
  uidx_c = torch.clamp(uidx, max=capacity - 1)
  # Each slot holds the last id written to it in sorted order, as the
  # JAX scatter leaves it: the one before the next slot starts.
  is_last = torch.ones(n, dtype=torch.bool, device=ids.device)
  is_last[:-1] = uidx_c[1:] != uidx_c[:-1]
  # The others write into a spare slot past the end.
  values = torch.full((capacity + 1,), fill_value, dtype=ids.dtype,
                      device=ids.device)
  values[torch.where(is_last, uidx_c, capacity).long()] = sorted_ids
  values = values[:capacity]
  index = torch.empty(n, dtype=torch.int32, device=ids.device)
  index[order] = uidx_c
  return UniqueResult(values, index, torch.clamp(count, max=capacity),
                      count > capacity)


__all__ = ['UniqueResult', 'unique']
