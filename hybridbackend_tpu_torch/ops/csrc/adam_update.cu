// Fused row-sparse LazyAdam over a row-sorted update list, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel hybridbackend_tpu/ops/pallas/scatter.py:
// adam_update_sorted (mode 'adam' of _scatter_kernel). The TPU version
// streams the whole table, m and v through VMEM, sums duplicates with a
// one-hot matmul, and carries row presence in an extra lane of the updates
// (an occurrence count), because a streamed block cannot otherwise tell a
// row with a zero gradient total from an absent one. Here presence is run
// membership: a row is updated exactly when it has a run in the list.
//
// Contract (the same as the TPU kernel's):
//   rows     int32 [n], ascending; entries < 0 or >= vocab are skipped;
//   grads    f32 [n, d], grads[i] belongs to rows[i];
//   table, m, v  f32 [vocab, d], updated in place;
//   lr, step f32 scalars in device memory (step is 1-based), so neither a
//            schedule nor the step count waits on the host.
// For every distinct valid row r in the list, with gradient total s (even
// when s == 0: TF LazyAdam updates every indexed row), and
// bc1 = 1 - b1^step, bc2 = 1 - b2^step:
//   m[r] = b1 * m[r] + (1 - b1) * s
//   v[r] = b2 * v[r] + (1 - b2) * s * s
//   table[r] -= lr * (m[r] / bc1) / (sqrt(v[r] / bc2) + eps)
// Moments of rows not in the list do not decay. `omb1` and `omb2` are
// 1 - b1 and 1 - b2 as the caller rounds them.
//
// Design: one warp owns each run of equal rows (as in adagrad_update.cu),
// sums it in list order in f32 without atomics, then applies the update;
// lanes stride over d.
//
// What bounds it: bytes. It reads n*(d+1)*4 bytes of gradients and row
// ids and reads and writes 6*u*d*4 bytes of table, m and v for the u
// distinct rows; a dozen flops per element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
adam_update_sorted_kernel(float* __restrict__ table, float* __restrict__ m,
                          float* __restrict__ v,
                          const int32_t* __restrict__ rows,
                          const float* __restrict__ grads,
                          const float* __restrict__ lr_ptr,
                          const float* __restrict__ step_ptr, float b1,
                          float b2, float omb1, float omb2, float eps,
                          int64_t n, int64_t vocab, int d) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int32_t r = rows[i];
  if (r < 0 || r >= vocab) return;
  if (i > 0 && rows[i - 1] == r) return;  // another warp owns this run
  int64_t end = i + 1;
  while (end < n && rows[end] == r) ++end;
  const float lr = *lr_ptr;
  const float t = *step_ptr;
  const float bc1 = __fsub_rn(1.f, powf(b1, t));
  const float bc2 = __fsub_rn(1.f, powf(b2, t));
  const int64_t base = static_cast<int64_t>(r) * d;
  for (int c = lane; c < d; c += 32) {
    float s = 0.f;
    for (int64_t j = i; j < end; ++j) s = __fadd_rn(s, grads[j * d + c]);
    // Explicitly rounded operations keep nvcc from contracting them into
    // FMAs, so each step rounds as in the plain PyTorch version.
    const float mn = __fadd_rn(__fmul_rn(b1, m[base + c]),
                               __fmul_rn(omb1, s));
    const float vn = __fadd_rn(__fmul_rn(b2, v[base + c]),
                               __fmul_rn(__fmul_rn(omb2, s), s));
    m[base + c] = mn;
    v[base + c] = vn;
    const float upd =
        __fdiv_rn(__fmul_rn(lr, __fdiv_rn(mn, bc1)),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), eps));
    table[base + c] = __fsub_rn(table[base + c], upd);
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
extern "C" int hb_adam_update_sorted_f32(void* table, void* m, void* v,
                                         const void* rows, const void* grads,
                                         const void* lr, const void* step,
                                         float b1, float b2, float omb1,
                                         float omb2, float eps, int64_t n,
                                         int64_t vocab, int d, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    adam_update_sorted_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(table), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<const int32_t*>(rows),
        static_cast<const float*>(grads), static_cast<const float*>(lr),
        static_cast<const float*>(step), b1, b2, omb1, omb2, eps, n, vocab,
        d);
  }
  return static_cast<int>(cudaGetLastError());
}
