// Row-sparse add over a row-sorted update list, for Hopper (sm_90a).
//
// Replaces the TPU kernel hybridbackend_tpu/ops/pallas/scatter.py:
// scatter_add_sorted (mode 'add' of _scatter_kernel). Like the Adagrad
// kernel beside it (adagrad_update.cu), the TPU version streams the whole
// table and sums duplicates with a one-hot matmul; here only the rows in
// the list are read and written.
//
// Contract (the same as the TPU kernel's):
//   rows     int32 [n], ascending; entries < 0 or >= vocab are skipped;
//   updates  f32 [n, d], updates[i] belongs to rows[i];
//   table    f32 [vocab, d], updated in place:
//            table[r] += sum of updates[i] over the i with rows[i] == r.
// The sum of a run is formed first, in list order, and then added to the
// row once, as the TPU kernel adds its per-row totals.
//
// Design: one warp owns each run of equal rows (the warp whose entry
// starts the run), so the result is deterministic without float atomics;
// lanes stride over d.
//
// What bounds it: bytes. It reads n*(d+1)*4 bytes of updates and row ids
// and reads and writes 2*u*d*4 bytes of the u distinct rows; one add per
// element. At d = 16 half of each warp idles, as in the Adagrad kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
scatter_add_sorted_kernel(float* __restrict__ table,
                          const int32_t* __restrict__ rows,
                          const float* __restrict__ updates, int64_t n,
                          int64_t vocab, int d) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int32_t r = rows[i];
  if (r < 0 || r >= vocab) return;
  if (i > 0 && rows[i - 1] == r) return;  // another warp owns this run
  int64_t end = i + 1;
  while (end < n && rows[end] == r) ++end;
  float* trow = table + static_cast<int64_t>(r) * d;
  for (int c = lane; c < d; c += 32) {
    float s = 0.f;
    for (int64_t j = i; j < end; ++j) s = __fadd_rn(s, updates[j * d + c]);
    trow[c] = __fadd_rn(trow[c], s);
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
extern "C" int hb_scatter_add_sorted_f32(void* table, const void* rows,
                                         const void* updates, int64_t n,
                                         int64_t vocab, int d,
                                         void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    scatter_add_sorted_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(table), static_cast<const int32_t*>(rows),
        static_cast<const float*>(updates), n, vocab, d);
  }
  return static_cast<int>(cudaGetLastError());
}
