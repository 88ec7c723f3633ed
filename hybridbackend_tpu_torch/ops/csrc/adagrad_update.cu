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
// rounded operations (sorted_runs.cuh: run_total, run_sums), so the totals
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
// Design: scatter_add.cu's, on sorted_runs.cuh, with two state arrays. A
// block takes a tile of `tile` consecutive entries; one thread starts a
// single bulk copy of the tile's gradients into shared memory and reads
// lr into shared memory, while all threads load the tile's rows; heads are
// found in shared memory. Each entry is served by a group of min(32, d/4)
// lanes of 16 bytes. A group first issues the loads of the table and acc
// rows of up to `batch` heads it owns (held in registers: 2 * batch * 4
// floats a thread), only then waits for the copy, sums each run from
// shared memory, applies and stores: the state's latency overlaps the
// copy's. These batched register loads were taken over asynchronous copies
// of the state rows into shared memory, the other way to keep them in
// flight without a dependent wait, because they are the simpler of the two
// and reach the goal of twice the bound: at tiles of 128 entries of d = 16
// a thread serves two entries, so a batch of 2 holds both heads' rows, 64
// bytes, some 16 KB a block with 4 to 5 blocks resident per SM. A d that 4
// does not divide, or a grads, table or acc address that 16 does not
// divide, takes the scalar lanes (and, for grads, plain loads from global
// memory) in the same kernel, as does a tile too large to stage. The bf16
// mode is the same kernel on Store<bf16, V> lanes (8 bytes for 4
// elements of table, acc and staged gradients); its gradients are staged
// only where a row is a whole number of 16 bytes (d a multiple of 8) at a
// 16-byte-aligned address, and are plain loads otherwise.

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

// Shared memory: the mbarrier and lr (32 bytes), the staged gradients
// (tile * d * sizeof(S) bytes, when `staged`), then tile + 1 rows.
template <typename S, typename V, bool kDedup, int kBatch>
__global__ void __launch_bounds__(kThreads)
adagrad_update_sorted_kernel(S* __restrict__ table, S* __restrict__ acc,
                             const int32_t* __restrict__ rows,
                             const S* __restrict__ grads,
                             const float* __restrict__ lr_ptr, float eps,
                             int64_t n, int64_t vocab, int d, int tile,
                             int staged) {
  using St = Store<S, V>;
  using Raw = typename St::Raw;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* lr_s = reinterpret_cast<float*>(smem + 16);
  Raw* grad_s = reinterpret_cast<Raw*>(smem + 32);
  int32_t* rows_s = reinterpret_cast<int32_t*>(
      smem + 32 + (staged ? static_cast<size_t>(tile) * d * sizeof(S) : 0));

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int cnt = static_cast<int>(n - t0 < tile ? n - t0 : tile);
  const int width = d / Lane<V>::kFloats;
  const Raw* gsrc = reinterpret_cast<const Raw*>(grads);
  Raw* trows = reinterpret_cast<Raw*>(table);
  Raw* arows = reinterpret_cast<Raw*>(acc);

  if (threadIdx.x == 0) {
    if (staged) {
      mbarrier_init(bar);
      bulk_load(grad_s, grads + t0 * d,
                static_cast<uint32_t>(cnt) * d * sizeof(S), bar);
    }
    *lr_s = *lr_ptr;
  }
  stage_rows(rows_s, rows, t0, cnt);
  __syncthreads();

  const float lr = *lr_s;
  const Raw* tile_src = staged ? grad_s : gsrc + t0 * width;
  const Groups g(width);
  bool landed = !staged;
  if (g.active()) {
    for (int c = g.lane; c < width; c += g.lanes) {
      for (int j0 = g.group; j0 < cnt; j0 += g.count * kBatch) {
        int32_t r[kBatch];
        V t[kBatch], a[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int j = j0 + b * g.count;
          r[b] = j < cnt && is_head(rows_s, j, vocab) ? rows_s[j + 1] : -1;
          t[b] = a[b] = Lane<V>::zero();
          if (r[b] >= 0) {
            const int64_t at = static_cast<int64_t>(r[b]) * width + c;
            t[b] = St::load(trows[at]);
            a[b] = St::load(arows[at]);
          }
        }
        if (!landed) {
          mbarrier_wait(bar, 0);
          landed = true;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (r[b] < 0) continue;
          V s = Lane<V>::zero(), q = Lane<V>::zero();
          if constexpr (kDedup) {
            s = run_total<V, S>(rows_s, j0 + b * g.count, cnt, r[b],
                                tile_src, width, c, rows, gsrc, t0 + cnt, n);
          } else {
            run_sums<V, S>(rows_s, j0 + b * g.count, cnt, r[b], tile_src,
                           width, c, rows, gsrc, t0 + cnt, n, s, q);
          }
#pragma unroll
          for (int k = 0; k < Lane<V>::kFloats; ++k) {
            const float sk = Lane<V>::at(s, k);
            adagrad_apply(Lane<V>::at(t[b], k), Lane<V>::at(a[b], k), sk,
                          kDedup ? __fmul_rn(sk, sk) : Lane<V>::at(q, k), lr,
                          eps);
          }
          const int64_t at = static_cast<int64_t>(r[b]) * width + c;
          arows[at] = St::store(a[b]);
          trows[at] = St::store(t[b]);
        }
      }
    }
  }
  // No block leaves while its copy is in flight.
  if (!landed) mbarrier_wait(bar, 0);
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
  size_t smem;
  const cudaError_t err =
      tile_shared_memory(kernel, d, tile, staged, sizeof(S), &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n + tile - 1) / tile;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<S*>(table), static_cast<S*>(acc),
      static_cast<const int32_t*>(rows), static_cast<const S*>(grads),
      static_cast<const float*>(lr), eps, n, vocab, d, tile, staged ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int blocks_per_sm(int d, int tile, int batch, int dedup, int* blocks) {
  const Kernel<S> kernel = kernel_for<S, float4>(batch, dedup);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem;
  const cudaError_t err =
      tile_shared_memory(kernel, d, tile, true, sizeof(S), &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(kernel), kThreads, smem));
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
  return bf16 ? blocks_per_sm<__nv_bfloat16>(d, tile, batch, dedup, blocks)
              : blocks_per_sm<float>(d, tile, batch, dedup, blocks);
}
