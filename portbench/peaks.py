"""Peaks of one NVIDIA H100 SXM and kernel 1's bound.

A frozen copy of ``chip_smoke.py``'s ``_bound`` (its peaks) and of the
bytes and operations it counts for kernel 1 (``adagrad_update_sorted``):
the list (rows and gradients) read once, each distinct row of the table
and of the accumulator read and written once; the list's sums, then per
distinct element a square, an add, a root, an add, a product, a quotient
and a difference. The f32 rate is the one outside the tensor cores: the
benchmark keeps TF32 off.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def adagrad_bound_s(n: int, u: int, d: int) -> float:
  """The least time kernel 1 can take on a list of ``n`` valid entries
  over ``u`` distinct rows of width ``d`` (f32 table and accumulator)."""
  nbytes = n * (d + 1) * 4 + 4 * u * d * 4
  ops = n * d + 7 * u * d
  return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S)


__all__ = ['F32_FLOP_PER_S', 'HBM_BYTES_PER_S', 'adagrad_bound_s']
