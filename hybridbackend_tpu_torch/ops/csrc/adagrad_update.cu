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
//
// Long runs: a run that leaves its tile is the tile's last, its tail (a
// column's first id in the Criteo entry point's batch takes about 1570
// of 4096 entries, 12 tiles). The group that owned it walked the rest
// one dependent global load an entry: 0.39-0.42 ms at the Criteo list,
// 12x the flagship list's time. Now the groups leave it to the block: the
// last warp finds the run's end while the groups work (run_end), then the
// block, in scalar lanes, loads the row's table and acc, adds the tile's
// part and streams the rest through the tile's own gradient buffer, a
// ring of two stages (stream_run; a tail of a few entries, or gradients
// not staged, is read from global memory in a counted loop), and applies
// and stores once: about 0.030 ms at that list, under the flagship's
// 0.034 (chip_smoke.py --long-runs, NVIDIA H100 80GB HBM3, 700 W). No
// block's shared memory grows for it but 32 bytes of header and a row,
// and the flagship's batch keeps its registers (kMinBlocks). Tiles inside
// the run find no head and only wait for their copy.

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

// The run's update of lane `at` (table t and acc a as loaded, total s and,
// per occurrence, the squares' sum q), stored once each.
template <typename V, typename S, bool kDedup>
__device__ __forceinline__ void apply_store(
    typename Store<S, V>::Raw* trows, typename Store<S, V>::Raw* arows,
    int64_t at, V t, V a, V s, V q, float lr, float eps) {
#pragma unroll
  for (int k = 0; k < Lane<V>::kFloats; ++k) {
    const float sk = Lane<V>::at(s, k);
    adagrad_apply(Lane<V>::at(t, k), Lane<V>::at(a, k), sk,
                  kDedup ? __fmul_rn(sk, sk) : Lane<V>::at(q, k), lr, eps);
  }
  arows[at] = Store<S, V>::store(a);
  trows[at] = Store<S, V>::store(t);
}

// Stages of the ring that a tail streams through, the tile's buffer cut
// in two: at d = 16 two copies of 4 KB in flight took the Criteo list's
// tails in less time than four of 2 KB (chip_smoke.py --long-runs).
constexpr int kTailStages = 2;

// Shared memory: kRingStages mbarriers, lr, the head and the end of the
// tile's tail (64 bytes), the staged gradients (tile * d * sizeof(S)
// bytes, when `staged`; also the ring of a long tail), then tile + 2 rows.
constexpr size_t kHeader = 64;

// The blocks of the flagship's batch (2) that one SM must hold, as before
// the long-run path was added (its loops would otherwise take registers
// that lower them); the tuning batches (4, 8) are left to the compiler.
template <typename S, bool kDedup, int kBatch>
constexpr int kMinBlocks =
    kBatch > 2 ? 1 : (kDedup || sizeof(S) == 2 ? 5 : 4);

template <typename S, typename V, bool kDedup, int kBatch>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<S, kDedup, kBatch>))
adagrad_update_sorted_kernel(S* __restrict__ table, S* __restrict__ acc,
                             const int32_t* __restrict__ rows,
                             const S* __restrict__ grads,
                             const float* __restrict__ lr_ptr, float eps,
                             int64_t n, int64_t vocab, int d, int tile,
                             int staged) {
  using St = Store<S, V>;
  using Raw = typename St::Raw;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* lr_s = reinterpret_cast<float*>(smem + 32);
  int* tail_head = reinterpret_cast<int*>(smem + 36);
  int64_t* tail_end = reinterpret_cast<int64_t*>(smem + 40);
  Raw* grad_s = reinterpret_cast<Raw*>(smem + kHeader);
  int32_t* rows_s = reinterpret_cast<int32_t*>(
      smem + kHeader +
      (staged ? static_cast<size_t>(tile) * d * sizeof(S) : 0));

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int cnt = static_cast<int>(n - t0 < tile ? n - t0 : tile);
  const int width = d / Lane<V>::kFloats;
  const Raw* gsrc = reinterpret_cast<const Raw*>(grads);
  Raw* trows = reinterpret_cast<Raw*>(table);
  Raw* arows = reinterpret_cast<Raw*>(acc);

  if (threadIdx.x == 0) {
    if (staged) {
      mbarrier_init(&bars[0]);
      bulk_load(grad_s, grads + t0 * d,
                static_cast<uint32_t>(cnt) * d * sizeof(S), &bars[0]);
    }
    *lr_s = *lr_ptr;
  }
  stage_rows_ahead(rows_s, rows, t0, cnt, n);
  __syncthreads();

  const float lr = *lr_s;
  // The tile's last run going on past the tile is the block's, after the
  // groups' runs: the last warp finds its end first.
  const int32_t last = rows_s[cnt];
  const bool tail = tail_leaves(rows_s, cnt, vocab);
  if (tail && static_cast<int>(threadIdx.x) >= kThreads - 32) {
    const int64_t e = run_end(rows, t0 + cnt, n, last);
    if (threadIdx.x == kThreads - 1) *tail_end = e;
  }
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
          if (tail && r[b] == last) {  // the tail's head
            *tail_head = j;
            r[b] = -1;
          }
          t[b] = a[b] = Lane<V>::zero();
          if (r[b] >= 0) {
            const int64_t at = static_cast<int64_t>(r[b]) * width + c;
            t[b] = St::load(trows[at]);
            a[b] = St::load(arows[at]);
          }
        }
        if (!landed) {
          mbarrier_wait(&bars[0], 0);
          landed = true;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (r[b] < 0) continue;
          V s = Lane<V>::zero(), q = Lane<V>::zero();
          tile_run<V, S, !kDedup>(rows_s, j0 + b * g.count, cnt, r[b],
                                  tile_src, width, c, s, q);
          const int64_t at = static_cast<int64_t>(r[b]) * width + c;
          apply_store<V, S, kDedup>(trows, arows, at, t[b], a[b], s, q, lr,
                                    eps);
        }
      }
    }
  }
  // No block leaves while its copy is in flight.
  if (!landed) mbarrier_wait(&bars[0], 0);
  if (!tail) return;

  // The tail, in scalar lanes (one chain of adds a lane, the loads far
  // ahead): its state rows, the tile's part from shared memory, then the
  // rest of the run from t0 + cnt to its end, streamed through the tile's
  // buffer or, if short or not staged, read from global memory; one apply
  // and one store.
  using Raw1 = typename Store<S, float>::Raw;
  constexpr int kAhead = 8;
  __syncthreads();  // the tail's head and end are in; grad_s is read
  const int stages = tile < kTailStages ? tile : kTailStages;
  const int js = *tail_head;
  const int64_t end = *tail_end, rest = end - (t0 + cnt);
  const bool ring_it = staged && d <= kThreads && rest > kShortTail;
  if (ring_it && threadIdx.x == 0)
    for (int b = 1; b < stages; ++b) mbarrier_init(&bars[b]);
  uint32_t phase = 1;  // bars[0] completed the tile's copy
  Raw1* t1 = reinterpret_cast<Raw1*>(table);
  Raw1* a1 = reinterpret_cast<Raw1*>(acc);
  const Raw1* g1 = reinterpret_cast<const Raw1*>(grads);
  const Raw1* tile1 = staged ? reinterpret_cast<const Raw1*>(grad_s)
                             : g1 + t0 * d;
  for (int c0 = 0; c0 < d; c0 += kThreads) {
    const int c = c0 + static_cast<int>(threadIdx.x);
    const bool active = c < d;
    const int64_t at = static_cast<int64_t>(last) * d + c;
    float t = 0.f, a = 0.f, s = 0.f, q = 0.f;
    if (active) {
      t = Store<S, float>::load(t1[at]);
      a = Store<S, float>::load(a1[at]);
      add_span<float, S, !kDedup, kAhead>(
          tile1 + static_cast<int64_t>(js) * d + c, cnt - js, d, s, q);
    }
    if (ring_it) {
      __syncthreads();  // the ring overwrites the tile's gradients
      stream_run<float, S, !kDedup, kAhead>(
          Ring<Raw1>{reinterpret_cast<Raw1*>(grad_s), bars, stages,
                     tile / stages},
          phase, g1, t0 + cnt, end, d, c, active, s, q);
    } else if (active) {
      add_span<float, S, !kDedup, kAhead>(g1 + (t0 + cnt) * d + c, rest, d,
                                          s, q);
    }
    if (active) apply_store<float, S, kDedup>(t1, a1, at, t, a, s, q, lr, eps);
  }
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
  const cudaError_t err = tile_shared_memory(kernel, d, tile, staged,
                                             sizeof(S), &smem, kHeader, 2);
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
  const cudaError_t err = tile_shared_memory(kernel, d, tile, true,
                                             sizeof(S), &smem, kHeader, 2);
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
