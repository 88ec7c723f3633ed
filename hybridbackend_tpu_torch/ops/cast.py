"""f32 -> bf16 casts with stochastic rounding.

Counterpart of ``hybridbackend_tpu/ops/pallas/cast.py``. The arithmetic is
that of the JAX function's portable path: with ``bits`` the f32 bit
pattern and ``noise`` uniform in ``[0, 2^16)``, the result has the bf16
bits ``((bits + noise) & 0xFFFF0000) >> 16``, the sum wrapping in uint32.
It truncates toward zero or rounds one bf16 ulp up in magnitude, with the
probability of the dropped fraction: unbiased, and exact on values bf16
represents. :func:`round_with_noise` holds that arithmetic alone.

The noise comes from Philox4x32-10, keyed by a 64-bit seed that
:func:`stochastic_round_bf16` draws on the host from the caller's
``torch.Generator``. The CUDA kernel (``csrc/stochastic_round.cu``) and
the plain version here make the same bits, in this layout:

* key = ``(seed & 0xFFFFFFFF, seed >> 32)``;
* group ``g`` holds elements ``8g .. 8g+7`` of the flattened input;
  counter = ``(g & 0xFFFFFFFF, g >> 32, 0, 0)``, one Philox call a group;
* element ``8g + e`` takes 16 bits of output word ``e // 2``: the low
  half for even ``e``, the high half for odd ``e``.

Torch has no full uint32 arithmetic, so the plain version works in int64:
every 32x32-bit product is split at 16 bits of one factor, and sums are
masked to 32 bits.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from hybridbackend_tpu_torch.ops import build

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """High and low 32-bit words of ``m * x`` for ``x`` in ``[0, 2^32)``
  (int64), without overflowing int64."""
  a = m * (x & 0xFFFF)
  b = m * (x >> 16)
  s = a + ((b & 0xFFFF) << 16)
  return (s >> 32) + (b >> 16), s & _MASK


def philox4x32_10(counter: Sequence[torch.Tensor],
                  key: Tuple[int, int]) -> Tuple[torch.Tensor, ...]:
  """Philox4x32-10 of the four 32-bit counter words (int64 tensors of one
  shape, each in ``[0, 2^32)``) under the two-word ``key``; returns the
  four output words as int64 tensors."""
  c0, c1, c2, c3 = counter
  k0, k1 = key
  for r in range(10):
    if r:
      k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    hi0, lo0 = _mulhilo(_M0, c0)
    hi1, lo1 = _mulhilo(_M1, c2)
    c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
  return c0, c1, c2, c3


def _philox_noise(n: int, seed: int, device: torch.device) -> torch.Tensor:
  """The kernel's noise for ``n`` elements: int64 ``[n]`` in
  ``[0, 2^16)``, in the layout of the module docstring."""
  g = torch.arange((n + 7) // 8, dtype=torch.int64, device=device)
  zero = torch.zeros_like(g)
  words = torch.stack(philox4x32_10((g & _MASK, g >> 32, zero, zero),
                                    (seed & _MASK, seed >> 32)), dim=1)
  halves = torch.stack((words & 0xFFFF, words >> 16), dim=2)
  return halves.reshape(-1)[:n]


def round_with_noise(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
  """bf16 of float32 ``x`` with the bits ``((bits + noise) & 0xFFFF0000)
  >> 16``, the sum wrapping in uint32; ``noise`` is an integer tensor of
  ``x``'s shape with values in ``[0, 2^16)``."""
  bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK
  top = ((bits + noise.to(torch.int64)) & 0xFFFF0000) >> 16
  top = torch.where(top >= 0x8000, top - 0x10000, top)
  return top.to(torch.int16).view(torch.bfloat16)


def stochastic_round_bf16_reference(x: torch.Tensor,
                                    seed: int) -> torch.Tensor:
  """Plain PyTorch version of the kernel: the same Philox noise for
  ``seed`` (a 64-bit integer), then :func:`round_with_noise`."""
  noise = _philox_noise(x.numel(), seed, x.device).reshape(x.shape)
  return round_with_noise(x, noise)


def draw_seed(generator: torch.Generator) -> int:
  """The 63-bit seed :func:`stochastic_round_bf16` draws from
  ``generator`` (a CPU generator, so no device is waited for)."""
  return int(torch.randint(0, 2**63 - 1, (), generator=generator))


def stochastic_round_bf16(x: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
  """float32 -> bfloat16 with stochastic rounding, any shape. Another
  input type is rounded to nearest (``x.to(torch.bfloat16)``), as the JAX
  function does.

  Args:
    x: the tensor to round; on a CUDA device it must be contiguous.
    generator: a CPU ``torch.Generator``; :func:`draw_seed` takes a seed
      from it on the host, so the call never waits for the device.
  """
  if x.dtype != torch.float32:
    return x.to(torch.bfloat16)
  seed = draw_seed(generator)
  if x.device.type == 'cpu':
    return stochastic_round_bf16_reference(x, seed)
  if x.device.type != 'cuda':
    raise ValueError(f'stochastic_round_bf16: no kernel for device '
                     f'{x.device}')
  if not x.is_contiguous():
    raise ValueError('stochastic_round_bf16: x must be contiguous')
  out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
  build.launch(stochastic_round_bf16, 'stochastic_round',
               'hb_stochastic_round_bf16',
               (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_uint64),
               x.device, out.data_ptr(), x.data_ptr(), x.numel(), seed)
  return out


stochastic_round_bf16.launches = 0


__all__ = ['draw_seed', 'philox4x32_10', 'round_with_noise',
           'stochastic_round_bf16', 'stochastic_round_bf16_reference']
