// Fused row-sparse Adagrad over a row-sorted update list, for Hopper (sm_90a).
//
// Replaces the TPU kernel hybridbackend_tpu/ops/pallas/scatter.py:534
// adagrad_update_sorted. That kernel streams the whole table through VMEM
// and sums duplicate rows with a one-hot matmul, because the TPU has no
// atomics and no cheap dynamic row read-modify-write. This card has both
// cheap row access and many independent warps, so the kernel touches only
// the rows in the list and never passes over the whole table.
//
// Contract (the same as the TPU kernel's):
//   rows     int32 [n], ascending; entries < 0 or >= vocab are skipped;
//   grads    [n, d] of the table's type, grads[i] belongs to rows[i];
//   table    f32 or bf16 [vocab, d], updated in place;
//   acc      [vocab, d] of the table's type, updated in place;
//   lr       f32 scalar in device memory (a schedule or a captured graph
//            can change it without a host round trip).
// For every distinct valid row r with per-row gradient total s = sum(g)
// and, per occurrence, q = sum(g * g):
//   dedup:     acc[r] += s * s;  table[r] -= lr * s / (sqrt(acc[r]) + eps)
//   per-occurrence (TF SparseApplyAdagrad, the JAX package's XLA path
//   _adagrad_rows_nodedup; its TPU kernel has no such mode):
//              acc[r] += q;      table[r] -= lr * s / (sqrt(acc[r]) + eps)
// In both, the denominator is read after all of the run's squares land.
// s (and q) are summed in f32 from 0.f in list order with explicitly
// rounded operations (sorted_runs.cuh: tile_run, add_span), so the totals
// carry the bits of gsum_dense.cu's and need no float atomics. The bf16
// mode (hb_adagrad_update_sorted_bf16, the TPU kernel's bf16 table and
// slot) reads table and acc as f32, does the same f32 math and stores
// each result rounded to nearest once: acc[r] = bf16(a) and table[r] =
// bf16(f32(table[r]) - lr * s / (sqrt(a) + eps)), with the denominator
// from the unrounded a = f32(acc[r]) + s * s (per occurrence: + q).
//
// What bounds it: bytes. It reads n*(d+1)*4 bytes of list and reads and
// writes 4*u*d*4 bytes of the u distinct rows of table and acc, with a few
// operations per element. A warp per entry that read rows[i], rows[i-1],
// rows[end], the gradients and the state rows one after the other kept 64
// bytes per warp in flight and reached a quarter of the bound: latency.
// This design reaches 59% of it in both modes (0.0336 ms against 0.0198 at
// the flagship list, 212992 entries on [2600000, 16], NVIDIA H100 80GB
// HBM3 at 700 W, chip_smoke.py --tune) and is bound now by the card's rate
// for scattered 64-byte rows: with the list streamed at the peak rate,
// the state rows move at about 1.75 TB/s, as scatter_add.cu's table rows
// do, and tiles of 64 to 512 entries with batches of 1 to 4 (3 to 8
// resident blocks per SM) all take 0.0331-0.0385 ms.
//
// Design: sorted_runs.cuh's update_tile with AdagradRows: scatter_add.cu's
// tile, with two state arrays. Thread 0 reads lr into shared memory while
// the tile's rows are staged. A group first issues the loads of the table
// and acc rows of up to `batch` heads it owns (held in registers: 2 *
// batch * 4 floats a thread), only then waits for the copy, sums each
// run, applies and stores: the state's latency overlaps the copy's. These
// batched register loads were taken over asynchronous copies of the state
// rows into shared memory, the other way to keep them in flight without a
// dependent wait, because they are the simpler of the two and reach the
// goal of twice the bound: at tiles of 128 entries of d = 16 a thread
// serves two entries, so a batch of 2 holds both heads' rows, 64 bytes,
// with 4 to 5 blocks resident per SM (kMinBlocks). Lanes, staging and the
// bf16 mode as in scatter_add.cu.
//
// Long runs: as in scatter_add.cu (its paragraph). The walk took
// 0.39-0.42 ms at the Criteo list, a tail streamed through the tile's own
// 8-KB buffer 0.0304; now 0.0209-0.0210 ms (the other three modes
// 0.0201-0.0222). At the flagship list 0.0334-0.0336 against 0.0342-0.0343
// before, and at a dense Trainer table's list (8192 uniform ids on
// [100000, 16]) 0.0081-0.0082 against 0.0088, chip_smoke.py --long-runs,
// NVIDIA H100 80GB HBM3, 700 W.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

// Explicitly rounded operations keep nvcc from contracting them into FMAs,
// so each step rounds as in the plain PyTorch version.
__device__ __forceinline__ void adagrad_apply(float& t, float& a, float s,
                                              float q, float lr, float eps) {
  a = __fadd_rn(a, q);
  t = __fsub_rn(t, __fdiv_rn(__fmul_rn(lr, s), __fadd_rn(sqrtf(a), eps)));
}

// A run's row (update_tile's Rows): its table and acc lanes, and the
// update of its total s and, per occurrence, the squares' sum q.
template <typename S, bool kDedup>
struct AdagradRows {
  static constexpr bool kSquares = !kDedup;
  S* table;
  S* acc;
  const float* lr_ptr;
  float eps, lr;
  template <typename V>
  struct State {
    V t, a;
  };
  __device__ void setup(float* sc) const { sc[0] = *lr_ptr; }
  __device__ void read(const float* sc) { lr = sc[0]; }
  template <typename V>
  __device__ State<V> load(int64_t at) const {
    return {load_lane<V>(table, at), load_lane<V>(acc, at)};
  }
  template <typename V>
  __device__ void store(int64_t at, State<V> st, V s, V q) const {
#pragma unroll
    for (int k = 0; k < Lane<V>::kFloats; ++k) {
      const float sk = Lane<V>::at(s, k);
      adagrad_apply(Lane<V>::at(st.t, k), Lane<V>::at(st.a, k), sk,
                    kDedup ? __fmul_rn(sk, sk) : Lane<V>::at(q, k), lr, eps);
    }
    store_lane<V>(acc, at, st.a);
    store_lane<V>(table, at, st.t);
  }
};

// The blocks of the flagship's batch (2) that one SM must hold (the tail's
// loops would otherwise take registers that lower them): 5 in bf16, at 48
// registers; 4 in f32, at 64, where at 48 the dedup kernel spilled 12
// bytes and ran 5% slower. The tuning batches (4, 8) are left to the
// compiler.
template <typename S, int kBatch>
constexpr int kMinBlocks = kBatch > 2 ? 1 : (sizeof(S) == 2 ? 5 : 4);

template <typename S, typename V, bool kDedup, int kBatch>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<S, kBatch>))
adagrad_update_sorted_kernel(S* __restrict__ table, S* __restrict__ acc,
                             const int32_t* __restrict__ rows,
                             const S* __restrict__ grads,
                             const float* __restrict__ lr_ptr, float eps,
                             int64_t n, int64_t vocab, int d, int tile,
                             int staged) {
  update_tile<S, V, kBatch>(AdagradRows<S, kDedup>{table, acc, lr_ptr, eps},
                            rows, grads, n, vocab, d, tile, staged != 0);
}

template <typename S>
using Kernel = void (*)(S*, S*, const int32_t*, const S*, const float*, float,
                        int64_t, int64_t, int, int, int);

template <typename S, typename V, bool kDedup>
Kernel<S> batched(int batch) {
  switch (batch) {
    case 1: return adagrad_update_sorted_kernel<S, V, kDedup, 1>;
    case 2: return adagrad_update_sorted_kernel<S, V, kDedup, 2>;
    case 4: return adagrad_update_sorted_kernel<S, V, kDedup, 4>;
    case 8: return adagrad_update_sorted_kernel<S, V, kDedup, 8>;
  }
  return nullptr;
}

// The kernel for `batch` (1, 2, 4 or 8), or nullptr.
template <typename S, typename V>
Kernel<S> kernel_for(int batch, bool dedup) {
  return dedup ? batched<S, V, true>(batch) : batched<S, V, false>(batch);
}

template <typename S>
int launch_for(void* table, void* acc, const void* rows, const void* grads,
               const void* lr, float eps, int64_t n, int64_t vocab, int d,
               int dedup, int tile, int batch, void* stream) {
  if (tile < 1 || tile > 32768 || !kernel_for<S, float>(batch, dedup))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || vocab <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  const bool staged = stageable<S>(grads, d, tile);
  const Kernel<S> kernel = d % 4 == 0 && lane_aligned<S>(grads) &&
                                   lane_aligned<S>(table) &&
                                   lane_aligned<S>(acc)
                               ? kernel_for<S, float4>(batch, dedup)
                               : kernel_for<S, float>(batch, dedup);
  return launch_tiles(kernel, n, d, tile, staged, sizeof(S), stream,
                      static_cast<S*>(table), static_cast<S*>(acc),
                      static_cast<const int32_t*>(rows),
                      static_cast<const S*>(grads),
                      static_cast<const float*>(lr), eps, n, vocab, d, tile,
                      staged ? 1 : 0);
}

}  // namespace

// Launch on `stream` (a cudaStream_t) with tiles of `tile` list entries,
// each thread loading the state rows of up to `batch` (1, 2, 4 or 8) heads
// before it waits for the tile's gradients, for an f32 table, acc and
// gradients (_f32) or bf16 ones (_bf16). `dedup` != 0 squares per-row
// totals; 0 sums per-occurrence squares. Each returns the first CUDA
// error, else cudaGetLastError().
extern "C" int hb_adagrad_update_sorted_f32(void* table, void* acc,
                                            const void* rows,
                                            const void* grads,
                                            const void* lr, float eps,
                                            int64_t n, int64_t vocab, int d,
                                            int dedup, int tile, int batch,
                                            void* stream) {
  return launch_for<float>(table, acc, rows, grads, lr, eps, n, vocab, d,
                           dedup, tile, batch, stream);
}

extern "C" int hb_adagrad_update_sorted_bf16(void* table, void* acc,
                                             const void* rows,
                                             const void* grads,
                                             const void* lr, float eps,
                                             int64_t n, int64_t vocab, int d,
                                             int dedup, int tile, int batch,
                                             void* stream) {
  return launch_for<__nv_bfloat16>(table, acc, rows, grads, lr, eps, n,
                                   vocab, d, dedup, tile, batch, stream);
}

// Blocks of the 4-element-lane kernel resident on one SM at row width `d`
// (a multiple of 4), tiles of `tile` entries and `batch`, into *blocks;
// `bf16` != 0 for the bf16 kernel.
extern "C" int hb_adagrad_update_sorted_blocks_per_sm(int d, int tile,
                                                      int batch, int dedup,
                                                      int bf16,
                                                      int* blocks) {
  return bf16 ? tile_blocks_per_sm(
                    kernel_for<__nv_bfloat16, float4>(batch, dedup), d,
                    tile, sizeof(__nv_bfloat16), blocks)
              : tile_blocks_per_sm(kernel_for<float, float4>(batch, dedup),
                                   d, tile, sizeof(float), blocks);
}
