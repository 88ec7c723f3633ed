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
// A run's total is summed from 0.f in list order with explicitly rounded
// adds (sorted_runs.cuh), so the totals are deterministic, need no float
// atomics, and equal bit for bit the totals the fused Adagrad kernel forms.
//
// What bounds it: bytes. The output is vocab*d*4 bytes and the list
// n*(d+1)*4; at the flagship shape the dense output (166.4 MB) is 92% of
// them. A memset of the whole output followed by a pass that wrote the
// listed rows a second time took two passes' time for that.
//
// Design: one pass, every output byte written once, by 16-byte stores. A
// block owns the output rows [r0, r0 + block_rows), like a block of the
// TPU kernel's grid. Two warps find the block's slice of the list with a
// 33-way lower bound each (of r0 and of the range's end; invalid rows sort
// before 0 and at or after vocab, so they fall outside every slice) while
// the other warps clear one flag per row in shared memory. The slice is
// then walked in chunks of `chunk` entries, whatever its length, as the add
// kernel walks its tiles: one thread starts a bulk copy of the chunk's
// updates into shared memory, all threads stage its rows, heads are found
// there, and a group of min(32, d/4) lanes of 16 bytes per entry sums each
// run from shared memory, stores the total straight to the row in global
// memory and sets the row's flag. A run never spans two blocks, since a
// block owns whole rows. Last, the block stores zeros to every row without
// a flag, neighbouring threads on neighbouring 16 bytes. The order matters:
// the sums wait on memory and the zeros do not, so the zeros come last,
// where one block's stores drain while its neighbours on the SM still wait.
// (Composing the block's range in shared memory first and writing it with
// one bulk copy or with plain stores was built and measured too: slower at
// every block size, and limited to rows that fit shared memory.) A d that 4
// does not divide, or an address that 16 does not divide, takes the scalar
// lanes and reads the updates from global memory in the same kernel. The
// wrapper picks block_rows so that the blocks come to whole rounds of the
// card's SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

// Shared memory: the mbarrier and the slice's bounds (32 bytes), the staged
// updates (chunk * d * 4 bytes, when `staged`), chunk + 1 rows, then
// block_rows flags.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gsum_dense_sorted_kernel(float* __restrict__ out,
                         const int32_t* __restrict__ rows,
                         const float* __restrict__ updates, int64_t n,
                         int64_t vocab, int d, int block_rows, int chunk,
                         int staged) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int64_t* bounds = reinterpret_cast<int64_t*>(smem + 16);
  V* upd_s = reinterpret_cast<V*>(smem + 32);
  int32_t* rows_s = reinterpret_cast<int32_t*>(
      smem + 32 + (staged ? static_cast<size_t>(chunk) * d * 4 : 0));
  unsigned char* has_run = reinterpret_cast<unsigned char*>(rows_s + chunk + 1);

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * block_rows;
  const int nr = static_cast<int>(vocab - r0 < block_rows ? vocab - r0
                                                          : block_rows);
  const int width = d / Lane<V>::kFloats;   // lanes of V in a row
  const V* gsrc = reinterpret_cast<const V*>(updates);
  V* rows_out = reinterpret_cast<V*>(out) + r0 * width;

  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t at = lower_bound_warp(rows, n, warp == 0 ? r0 : r0 + nr);
    if ((threadIdx.x & 31) == 0) bounds[warp] = at;
    if (staged && threadIdx.x == 0) mbarrier_init(bar);
  } else {
    for (int i = threadIdx.x - 64; i < nr; i += kThreads - 64) has_run[i] = 0;
  }
  __syncthreads();

  const int64_t lo = bounds[0], hi = bounds[1];
  const Groups g(width);
  uint32_t parity = 0;
  for (int64_t base = lo; base < hi; base += chunk) {
    const int cnt = static_cast<int>(hi - base < chunk ? hi - base : chunk);
    if (staged && threadIdx.x == 0)
      bulk_load(upd_s, updates + base * d, static_cast<uint32_t>(cnt) * d * 4,
                bar);
    stage_rows(rows_s, rows, base, cnt);
    __syncthreads();
    if (staged) mbarrier_wait(bar, parity);
    const V* chunk_src = staged ? upd_s : gsrc + base * width;
    if (g.active()) {
      for (int j = g.group; j < cnt; j += g.count) {
        if (!is_head(rows_s, j, vocab)) continue;
        const int32_t r = rows_s[j + 1];
        if (g.lane == 0) has_run[r - r0] = 1;
        for (int c = g.lane; c < width; c += g.lanes) {
          rows_out[(r - r0) * width + c] =
              run_total<V>(rows_s, j, cnt, r, chunk_src, width, c, rows, gsrc,
                           base + cnt, hi);
        }
      }
    }
    parity ^= 1;
    __syncthreads();  // the next chunk overwrites rows_s and upd_s
  }

  // Lane c of row q for this thread, then every kThreads-th lane after it.
  const int dq = kThreads / width, dc = kThreads % width;
  int q = threadIdx.x / width, c = threadIdx.x % width;
  while (q < nr) {
    if (!has_run[q]) rows_out[static_cast<int64_t>(q) * width + c] =
        Lane<V>::zero();
    q += dq;
    c += dc;
    if (c >= width) {
      c -= width;
      ++q;
    }
  }
}

template <typename V>
int launch(float* out, const int32_t* rows, const float* updates, int64_t n,
           int64_t vocab, int d, int block_rows, int chunk, bool staged,
           cudaStream_t stream) {
  const size_t smem = 32 + (staged ? static_cast<size_t>(chunk) * d * 4 : 0) +
                      (static_cast<size_t>(chunk) + 1) * 4 + block_rows;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gsum_dense_sorted_kernel<V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (vocab + block_rows - 1) / block_rows;
  gsum_dense_sorted_kernel<V>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
          out, rows, updates, n, vocab, d, block_rows, chunk, staged ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (a cudaStream_t): a block per `block_rows` output
// rows, which walks its slice of the list `chunk` entries at a time.
// Returns the first CUDA error, else cudaGetLastError().
extern "C" int hb_gsum_dense_sorted_f32(void* out, const void* rows,
                                        const void* updates, int64_t n,
                                        int64_t vocab, int d, int block_rows,
                                        int chunk, void* stream) {
  if (n < 0 || block_rows < 1 || block_rows > 32768 || chunk < 1 ||
      chunk > 32768)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vocab <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const bool quads = d % 4 == 0 && aligned16(updates);
  const bool staged =
      quads && static_cast<size_t>(chunk) * d * 4 <= kMaxStageBytes;
  float* o = static_cast<float*>(out);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* u = static_cast<const float*>(updates);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quads && aligned16(out))
    return launch<float4>(o, r, u, n, vocab, d, block_rows, chunk, staged, s);
  return launch<float>(o, r, u, n, vocab, d, block_rows, chunk, staged, s);
}
