// Dense per-row gradient totals of a row-sorted update list, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel hybridbackend_tpu/ops/pallas/scatter.py:
// gsum_dense_sorted (body _gsum_kernel). That kernel walks the output in
// blocks of rows through VMEM, writes zeros into each block and sums the
// block's duplicates with a one-hot matmul, because the TPU has no atomics
// and no cheap dynamic row write. It is the scatter half of the dense-split
// Adagrad update: an elementwise pass over (table, acc, gsum) follows it.
//
// Contract (the same as the TPU kernel's, in the logical layout, any d):
//   rows     int32 [n], ascending; entries < 0 or >= vocab are skipped;
//   updates  f32 [n, d], updates[i] belongs to rows[i];
//   out      f32 [vocab, d], written whole: out[r] is the f32 total of the
//            run of r in the list, every other row is exactly 0.0.
//
// Design. The C function first zeroes the whole output with
// cudaMemsetAsync, as the TPU kernel writes every block it owns; then one
// warp owns each run of equal rows (the warp whose entry starts the run,
// as in adagrad_update.cu) and writes that row's total. The owner sums the
// run in list order with explicitly rounded adds, starting from 0, so the
// totals are deterministic, need no float atomics, and equal bit for bit
// the totals the fused Adagrad kernel forms. Lanes stride over d.
//
// What bounds it: bytes. The output is vocab*d*4 bytes, written once by
// the memset and again, for the u distinct rows, by the owners; the list is
// n*(d+1)*4 bytes, read once. At the flagship shape the dense output
// (166.4 MB) is 92% of the bytes, so the memset sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gsum_dense_sorted_kernel(float* __restrict__ out,
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
  float* orow = out + static_cast<int64_t>(r) * d;
  for (int c = lane; c < d; c += 32) {
    float s = 0.f;
    for (int64_t j = i; j < end; ++j) s = __fadd_rn(s, updates[j * d + c]);
    orow[c] = s;
  }
}

}  // namespace

// Zeroes `out` and launches on `stream` (a cudaStream_t); returns the first
// CUDA error, else cudaGetLastError().
extern "C" int hb_gsum_dense_sorted_f32(void* out, const void* rows,
                                        const void* updates, int64_t n,
                                        int64_t vocab, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(vocab) * d * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    gsum_dense_sorted_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                               s>>>(
        static_cast<float*>(out), static_cast<const int32_t*>(rows),
        static_cast<const float*>(updates), n, vocab, d);
  }
  return static_cast<int>(cudaGetLastError());
}
