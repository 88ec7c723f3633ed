"""The port's stochastically rounded bf16 cast against the JAX package.

``round_with_noise`` holds the rounding arithmetic; it is held bit for
bit against the JAX ``stochastic_round_bf16`` (its portable path, the
one that runs on the CPU) with the noise redrawn from the same key as
that function draws it. The inputs cover ±0, subnormals, ±inf, NaN, the
largest finite floats and values bf16 represents. NaNs are compared by
``isnan``: the JAX cast may quiet a NaN's payload.

The port draws its noise from Philox4x32-10 in int64 torch ops; that is
held against a Philox written here with Python integers and against the
known-answer vectors of Random123 (``kat_vectors``). The layout of the
noise (8 elements per Philox call) is held against the same Python
Philox. Every comparison here is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridbackend_tpu.ops.pallas import cast as jcast

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.ops import cast

M32 = 0xFFFFFFFF


def _philox_int(c, k):
  """Philox4x32-10 on Python integers."""
  c, (k0, k1) = list(c), k
  for r in range(10):
    if r:
      k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
    c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1, p0 & M32]
  return c


@pytest.mark.parametrize('counter,key,want', [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32,) * 4, (M32, M32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
  got = cast.philox4x32_10([torch.tensor([c]) for c in counter], key)
  assert [int(w) for w in got] == list(want)
  assert _philox_int(counter, key) == list(want)


def test_philox_matches_python_integers():
  rng = np.random.RandomState(0)
  counters = rng.randint(0, 2**32, (4, 200), dtype=np.uint64).astype(np.int64)
  key = (int(rng.randint(0, 2**32, dtype=np.uint64)),
         int(rng.randint(0, 2**32, dtype=np.uint64)))
  got = cast.philox4x32_10([torch.from_numpy(c) for c in counters], key)
  got = torch.stack(got, 1).tolist()
  want = [_philox_int([int(c) for c in counters[:, i]], key)
          for i in range(200)]
  assert got == want


@pytest.mark.parametrize('n', [37, 8, 1])
def test_noise_layout(n):
  """Element 8g+e takes the low (even e) or high (odd e) half of output
  word e//2 of the Philox call on counter (g, 0, 0, 0)."""
  seed = 0x1234_5678_9ABC_DEF0 >> 1
  key = (seed & M32, seed >> 32)
  noise = []
  for g in range((n + 7) // 8):
    for w in _philox_int((g, 0, 0, 0), key):
      noise += [w & 0xFFFF, w >> 16]
  x = torch.from_numpy(np.random.RandomState(n).randn(n).astype(np.float32))
  got = hbt.stochastic_round_bf16_reference(x, seed)
  want = hbt.round_with_noise(x, torch.tensor(noise[:n]))
  assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _special_values():
  f32 = np.finfo(np.float32)
  vals = [0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, f32.tiny, np.inf,
          -np.inf, np.nan, f32.max, -f32.max, np.float32(3.3e38), 1.0, -2.0,
          0.5, 1.5, 3.140625, -0.0078125]
  rng = np.random.RandomState(7)
  rest = rng.randn(16 * 8 - len(vals)) * 10.0 ** rng.randint(-30, 30, 16 * 8
                                                             - len(vals))
  return np.concatenate([np.array(vals, np.float32),
                         rest.astype(np.float32)]).reshape(16, 8)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_round_with_noise_matches_jax(seed):
  x = _special_values()
  key = jax.random.PRNGKey(seed)
  want = np.asarray(jcast.stochastic_round_bf16(jnp.asarray(x), key)
                    .astype(jnp.float32))
  noise = np.asarray(jax.random.randint(key, x.shape, 0, 1 << 16,
                                        dtype=jnp.uint32)).astype(np.int64)
  got = hbt.round_with_noise(torch.from_numpy(x), torch.from_numpy(noise))
  assert got.dtype == torch.bfloat16 and got.shape == x.shape
  got = got.float().numpy()
  nan = np.isnan(want)
  np.testing.assert_array_equal(np.isnan(got), nan)
  np.testing.assert_array_equal(got[~nan].view(np.int32),
                                want[~nan].view(np.int32))
  # bf16 values pass through; the largest floats may carry into inf.
  exact = np.isin(x, [0.0, 1.0, -2.0, 0.5, 1.5, 3.140625, -0.0078125])
  np.testing.assert_array_equal(got[exact].view(np.int32),
                                x[exact].view(np.int32))


def test_result_is_truncation_or_one_ulp_up():
  x = torch.from_numpy(np.random.RandomState(3).randn(4096)
                       .astype(np.float32) * 100)
  out = hbt.stochastic_round_bf16(x, torch.Generator().manual_seed(3))
  trunc = (x.view(torch.int32) >> 16).to(torch.int16)
  step = out.view(torch.int16).to(torch.int32) - trunc.to(torch.int32)
  assert bool(((step == 0) | (step == 1)).all())
  assert 0 < int(step.sum()) < 4096


def test_unbiased_over_seeds():
  """Mean rounding error over 64 seeds and 1024 values in [1, 2) (one
  ulp, 2^-7, for all) within 4 standard deviations of zero, each
  value's variance being ulp²·p·(1-p) for its dropped fraction p. Always
  truncating would miss by about 314 deviations."""
  x = torch.from_numpy(np.random.RandomState(4).uniform(1, 2, 1024)
                       .astype(np.float32))
  gen = torch.Generator().manual_seed(4)
  err = torch.stack([hbt.stochastic_round_bf16(x, gen).double() - x.double()
                     for _ in range(64)])
  ulp = 2.0 ** -7
  p = (x.double() - x.bfloat16().double()).remainder(ulp) / ulp
  sigma = float(torch.sqrt((ulp ** 2 * p * (1 - p)).sum() * 64)) / err.numel()
  assert abs(float(err.mean())) <= 4 * sigma
  assert float(err.abs().max()) < ulp


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float64,
                                   torch.float16])
def test_other_types_round_to_nearest(dtype):
  x = torch.from_numpy(np.random.RandomState(5).randn(64)).to(dtype)
  before = hbt.stochastic_round_bf16.launches
  got = hbt.stochastic_round_bf16(x, torch.Generator().manual_seed(0))
  assert got.dtype == torch.bfloat16 and torch.equal(got, x.to(torch.bfloat16))
  assert hbt.stochastic_round_bf16.launches == before


def test_cpu_wrapper_follows_its_generator_and_counts_no_launch():
  x = torch.randn(3, 100, generator=torch.Generator().manual_seed(9))
  before = hbt.stochastic_round_bf16.launches
  gen = torch.Generator().manual_seed(11)
  first = hbt.stochastic_round_bf16(x, gen)
  second = hbt.stochastic_round_bf16(x, gen)
  again = hbt.stochastic_round_bf16(x, torch.Generator().manual_seed(11))
  assert hbt.stochastic_round_bf16.launches == before
  seed = hbt.draw_seed(torch.Generator().manual_seed(11))
  assert 0 <= seed < 2**63
  assert torch.equal(first.view(torch.int16), again.view(torch.int16))
  assert torch.equal(first.view(torch.int16),
                     hbt.stochastic_round_bf16_reference(x, seed)
                     .view(torch.int16))
  assert not torch.equal(first.view(torch.int16), second.view(torch.int16))
