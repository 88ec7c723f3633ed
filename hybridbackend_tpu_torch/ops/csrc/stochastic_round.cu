// f32 -> bf16 with stochastic rounding, for Hopper (sm_90a).
//
// Replaces the TPU kernel hybridbackend_tpu/ops/pallas/cast.py:
// stochastic_round_bf16_pallas (body _sr_kernel), which draws its noise
// from the TPU core's own generator (pltpu.prng_random_bits). This card
// has no such generator, so the noise comes from Philox4x32-10 (Salmon et
// al., SC 2011; Random123), a counter-based generator written out below:
// every element's noise is a pure function of (seed, element index), so
// any thread can make its own and a plain PyTorch version
// (ops/cast.py:_philox_noise) can make the same bits.
//
// Contract, the arithmetic of the JAX function's portable path
// (cast.py:stochastic_round_bf16): with bits = bitcast_u32(x[i]) and noise
// uniform in [0, 2^16),
//   out[i] = bf16 with the bits ((bits + noise) & 0xFFFF0000) >> 16,
// the sum wrapping in uint32. The result is x truncated toward zero to
// bf16, or one bf16 ulp above it in magnitude with probability equal to
// the dropped fraction of an ulp: unbiased, and exact on values that bf16
// represents.
//
// Noise layout (ops/cast.py:_philox_noise makes the same bits):
//   key     = (seed & 0xFFFFFFFF, seed >> 32), a 64-bit seed;
//   group g = elements 8g .. 8g+7 of the flattened input, row-major;
//   counter = (g & 0xFFFFFFFF, g >> 32, 0, 0), one Philox call per group;
//   element 8g + e takes 16 bits of output word e / 2: the low half for
//   even e, the high half for odd e.
//
// Design. One thread per group of 8 elements: one Philox call, two 16-byte
// loads of x and one 16-byte store of 8 bf16 when both pointers are 16-byte
// aligned and the group is whole; element by element otherwise. A grid
// stride covers any n.
//
// What bounds it: bytes. It reads 4 and writes 2 bytes per element; the
// Philox call is ten rounds of two 32x32 -> 64-bit products per 8
// elements, far below the card's integer rate for the bytes it moves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint16_t round_bits(uint32_t bits,
                                               uint32_t noise16) {
  return static_cast<uint16_t>((bits + noise16) >> 16);
}

__global__ void __launch_bounds__(kThreads)
stochastic_round_bf16_kernel(uint16_t* __restrict__ out,
                             const uint32_t* __restrict__ x, int64_t n,
                             uint32_t k0, uint32_t k1, bool vector) {
  const int64_t groups = (n + 7) / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(g),
                   static_cast<uint32_t>(static_cast<uint64_t>(g) >> 32), 0u,
                   0u),
        k0, k1);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    const int64_t base = g * 8;
    if (vector && base + 8 <= n) {
      const uint4 a = reinterpret_cast<const uint4*>(x + base)[0];
      const uint4 b = reinterpret_cast<const uint4*>(x + base)[1];
      const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const uint32_t lo = round_bits(v[e], words[e / 2] & 0xFFFFu);
        const uint32_t hi = round_bits(v[e + 1], words[e / 2] >> 16);
        packed[e / 2] = lo | (hi << 16);
      }
      reinterpret_cast<uint4*>(out + base)[0] =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    } else {
      for (int e = 0; e < 8 && base + e < n; ++e) {
        const uint32_t noise =
            (e & 1) ? words[e / 2] >> 16 : words[e / 2] & 0xFFFFu;
        out[base + e] = round_bits(x[base + e], noise);
      }
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
// `out` is bf16 [n], `x` f32 [n], both contiguous.
extern "C" int hb_stochastic_round_bf16(void* out, const void* x, int64_t n,
                                        uint64_t seed, void* stream) {
  if (n > 0) {
    const int64_t groups = (n + 7) / 8;
    int64_t blocks = (groups + kThreads - 1) / kThreads;
    if (blocks > (1 << 20)) blocks = 1 << 20;
    const bool vector = ((reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(x)) % 16) == 0;
    stochastic_round_bf16_kernel<<<static_cast<unsigned int>(blocks),
                                   kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint16_t*>(out), static_cast<const uint32_t*>(x), n,
        static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32),
        vector);
  }
  return static_cast<int>(cudaGetLastError());
}
