// Fused row-sparse Adagrad over a row-sorted update list, for Hopper (sm_90a).
//
// Replaces the TPU kernel hybridbackend_tpu/ops/pallas/scatter.py:
// adagrad_update_sorted. That kernel streams the whole table through VMEM
// and sums duplicate rows with a one-hot matmul, because the TPU has no
// atomics and no cheap dynamic row read-modify-write. This card has both
// cheap row access and many independent warps, so the kernel touches only
// the rows in the list and never passes over the whole table.
//
// Contract (the same as the TPU kernel's):
//   rows     int32 [n], ascending; entries < 0 or >= vocab are skipped;
//   grads    f32 [n, d], grads[i] belongs to rows[i];
//   table    f32 [vocab, d], updated in place;
//   acc      f32 [vocab, d], updated in place;
//   lr       f32 scalar in device memory (a schedule or a captured graph
//            can change it without a host round trip).
// For every distinct valid row r with per-row gradient total s = sum(g)
// and, per occurrence, q = sum(g * g):
//   dedup:     acc[r] += s * s;  table[r] -= lr * s / (sqrt(acc[r]) + eps)
//   per-occurrence (TF SparseApplyAdagrad, the JAX package's XLA path
//   _adagrad_rows_nodedup; its TPU kernel has no such mode):
//              acc[r] += q;      table[r] -= lr * s / (sqrt(acc[r]) + eps)
// In both, the denominator is read after all of the run's squares land.
//
// Design. Each run of equal rows is owned by exactly one warp: warp i
// looks at entry i and does the work only if entry i starts its run
// (i == 0 or rows[i] != rows[i-1]). The owner sums the run's gradients in
// ascending order in f32, so the result does not depend on scheduling and
// needs no float atomics; then it applies the update. Lanes stride over d.
//
// What bounds it: bytes. Per call it reads n*(d+1)*4 bytes of gradients
// and row ids, and reads and writes the table and accumulator rows of the
// u distinct rows, 4*u*d*4 bytes; there is almost no arithmetic. The
// design moves only those bytes: no pass over the [vocab, d] arrays and
// no staging of per-row totals in device memory. Lanes of a warp read
// neighbouring floats of one row, so each row read is one coalesced
// transaction of d*4 bytes. At d = 16 half of each warp idles; packing two
// entries per warp is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

template <bool kDedup>
__global__ void __launch_bounds__(kThreads)
adagrad_update_sorted_kernel(float* __restrict__ table,
                             float* __restrict__ acc,
                             const int32_t* __restrict__ rows,
                             const float* __restrict__ grads,
                             const float* __restrict__ lr_ptr, float eps,
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
  float* trow = table + static_cast<int64_t>(r) * d;
  float* arow = acc + static_cast<int64_t>(r) * d;
  for (int c = lane; c < d; c += 32) {
    // Explicitly rounded operations keep nvcc from contracting them into
    // FMAs, so each step rounds as in the plain PyTorch version.
    float s = 0.f, q = 0.f;
    for (int64_t j = i; j < end; ++j) {
      const float g = grads[j * d + c];
      s = __fadd_rn(s, g);
      if (!kDedup) q = __fadd_rn(q, __fmul_rn(g, g));
    }
    if (kDedup) q = __fmul_rn(s, s);
    const float a = __fadd_rn(arow[c], q);
    arow[c] = a;
    trow[c] = __fsub_rn(trow[c], __fdiv_rn(__fmul_rn(lr, s),
                                           __fadd_rn(sqrtf(a), eps)));
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
// `dedup` != 0 squares per-row totals; 0 sums per-occurrence squares.
extern "C" int hb_adagrad_update_sorted_f32(void* table, void* acc,
                                            const void* rows,
                                            const void* grads,
                                            const void* lr, float eps,
                                            int64_t n, int64_t vocab, int d,
                                            int dedup, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const auto kernel = dedup ? adagrad_update_sorted_kernel<true>
                              : adagrad_update_sorted_kernel<false>;
    kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(table), static_cast<float*>(acc),
        static_cast<const int32_t*>(rows), static_cast<const float*>(grads),
        static_cast<const float*>(lr), eps, n, vocab, d);
  }
  return static_cast<int>(cudaGetLastError());
}
