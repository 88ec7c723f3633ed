"""Embedding table configuration and creation.

Counterpart of ``hybridbackend_tpu/embedding/table.py:91-253`` at a
world of one. Tables are stored in their logical ``[vocab, dim]`` layout:
the JAX package's lane packing (``[V/p, 128]`` physical arrays) exists
for the TPU's 128-lane tiles and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

# Knuth's multiplicative-hash constant, odd so that the mix is a bijection
# modulo any power of two (``hybridbackend_tpu/embedding/table.py:85-88``).
_MIX_CONSTANT = 0x9E3779B1 | 1
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class TableConfig:
  """Declarative embedding table spec (logical layout, world of one)."""
  name: str
  vocab_size: int
  dim: int
  # ``(generator, shape, dtype) -> tensor`` on the generator's device.
  initializer: Optional[Callable[[torch.Generator, Tuple[int, int],
                                  torch.dtype], torch.Tensor]] = None
  combiner: str = 'sum'            # for multivalent lookups
  dtype: torch.dtype = torch.float32   # or torch.bfloat16
  shuffle_ids: bool = False        # spread hot ids with an invertible mix

  def padded_vocab(self) -> int:
    """Rows of the table: the vocab, or its next power of two when the
    ids are mixed (the mix is invertible modulo a power of two)."""
    if self.shuffle_ids:
      return 1 << (self.vocab_size - 1).bit_length()
    return self.vocab_size

  def row_index(self, ids: torch.Tensor) -> torch.Tensor:
    """Map feature ids to table rows (identity unless shuffled).

    The JAX package mixes in uint32 with wraparound; torch has no uint32
    arithmetic, so the mix runs in int64 (a non-negative int32 id times
    the 32-bit constant fits) masked to 32 bits. Negative (invalid) ids
    stay negative."""
    if not self.shuffle_ids:
      return ids
    n = self.padded_vocab()
    mixed = ((ids.to(torch.int64) * _MIX_CONSTANT) & _U32) % n
    return torch.where(ids >= 0, mixed.to(ids.dtype), ids)


def default_initializer(generator: torch.Generator, shape: Tuple[int, int],
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """Uniform in ``[-1/sqrt(dim), 1/sqrt(dim)]``, as the JAX package's
  ``default_initializer``."""
  scale = 1.0 / math.sqrt(shape[1])
  out = torch.empty(shape, dtype=torch.float32, device=generator.device)
  return out.uniform_(-scale, scale, generator=generator).to(dtype)


def create_table(config: TableConfig, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
  """Materialize a ``[padded_vocab, dim]`` table on ``device``.

  The values are drawn on the generator's device and then moved, so one
  seeded CPU generator gives the same table on every device."""
  init = config.initializer or default_initializer
  out = init(generator, (config.padded_vocab(), config.dim), config.dtype)
  return out.to(device=device, dtype=config.dtype).contiguous()


__all__ = ['TableConfig', 'create_table', 'default_initializer']
