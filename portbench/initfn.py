"""Seeds, and the counter-based initial table rows.

Row ``r`` of member table ``m`` is a pure function of ``(seed, m, r)``:
integer hashing of each element's index, then one float product. The
benchmark fills the port's tables with it on the card, and the reference
rebuilds any row it needs from it, bit for bit, on any device, without a
second copy of a table that fills half the card. Plain PyTorch.
"""

from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
# Below 2**27, so that a product with a 32-bit value fits an int64.
_MUL = 0x45D9F3B
_MEMBER_MUL = 0x1000193
# Rows filled per call: each int64 temporary of a [rows, 128] chunk is
# then 1 GiB.
CHUNK_ELEMENTS = 1 << 27


def subseed(seed: int, salt: str) -> int:
  """A 63-bit seed for one use (``salt``) of the run's ``--seed``:
  splitmix64 of the seed and the salt's bytes. Any whole number works,
  however large."""
  x = (seed ^ int.from_bytes(salt.encode()[:8].ljust(8, b'\0'), 'little')
       ) & _MASK64
  for _ in range(2):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
  return x >> 1


def generator(seed: int, salt: str, device: torch.device) -> torch.Generator:
  """A ``torch.Generator`` on ``device`` seeded for ``salt``."""
  return torch.Generator(device=device).manual_seed(subseed(seed, salt))


def _mix32(x: torch.Tensor) -> torch.Tensor:
  """A 32-bit integer hash of int64 values in ``[0, 2**32)``."""
  x = x ^ (x >> 16)
  x = (x * _MUL) & _MASK32
  x = x ^ (x >> 16)
  x = (x * _MUL) & _MASK32
  return x ^ (x >> 16)


def table_rows(seed: int, member: int, rows: torch.Tensor, dim: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """The initial values of ``rows`` (int64 ``[n]``) of member table
  ``member``: ``[n, dim]``, uniform in ``[-1/sqrt(dim), 1/sqrt(dim))`` (the
  port's default initializer's range), on ``rows``' device."""
  key = subseed(seed, 'tables')
  k0, k1 = key & _MASK32, (key >> 32) & _MASK32
  e = rows.to(torch.int64)[:, None] * dim + torch.arange(
      dim, dtype=torch.int64, device=rows.device)
  x = _mix32((e & _MASK32) ^ k0)
  x = _mix32(x ^ (((e >> 32) + member * _MEMBER_MUL) & _MASK32) ^ k1)
  u = (x >> 8).to(torch.float32) * (2.0 ** -24)
  return ((u * 2 - 1) * (1.0 / math.sqrt(dim))).to(dtype)


def fill_member(out: torch.Tensor, seed: int, member: int) -> None:
  """Writes member ``member``'s rows into ``out`` (``[rows, dim]``, its
  view of the stacked table), in chunks."""
  n, dim = out.shape
  step = max(1, CHUNK_ELEMENTS // dim)
  for lo in range(0, n, step):
    hi = min(n, lo + step)
    out[lo:hi] = table_rows(seed, member, torch.arange(
        lo, hi, dtype=torch.int64, device=out.device), dim, out.dtype)


__all__ = ['fill_member', 'generator', 'subseed', 'table_rows']
