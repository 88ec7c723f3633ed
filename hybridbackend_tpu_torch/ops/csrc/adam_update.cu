// Fused row-sparse LazyAdam over a row-sorted update list, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel hybridbackend_tpu/ops/pallas/scatter.py:749
// adam_update_sorted (mode 'adam' of _scatter_kernel). The TPU version
// streams the whole table, m and v through VMEM, sums duplicates with a
// one-hot matmul, and carries row presence in an extra lane of the updates
// (an occurrence count), because a streamed block cannot otherwise tell a
// row with a zero gradient total from an absent one. Here presence is run
// membership: a row is updated exactly when it has a run in the list.
//
// Contract (the same as the TPU kernel's):
//   rows     int32 [n], ascending; entries < 0 or >= vocab are skipped;
//   grads    [n, d] of the table's type, grads[i] belongs to rows[i];
//   table, m, v  f32 or bf16 (one type) [vocab, d], updated in place;
//   lr, step f32 scalars in device memory (step is 1-based), so neither a
//            schedule nor the step count waits on the host.
// For every distinct valid row r in the list, with gradient total s (even
// when s == 0: TF LazyAdam updates every indexed row), and
// bc1 = 1 - b1^step, bc2 = 1 - b2^step:
//   m[r] = b1 * m[r] + (1 - b1) * s
//   v[r] = b2 * v[r] + (1 - b2) * s * s
//   table[r] -= lr * (m[r] / bc1) / (sqrt(v[r] / bc2) + eps)
// Moments of rows not in the list do not decay. `omb1` and `omb2` are
// 1 - b1 and 1 - b2 as the caller rounds them. s is summed in f32 from
// 0.f in list order with explicitly rounded adds (sorted_runs.cuh:
// run_total). The bf16 mode (hb_adam_update_sorted_bf16, the TPU kernel's
// bf16 table and moments) reads table, m and v as f32, does the same f32
// math and stores each of the three rounded to nearest once; the table's
// step uses the unrounded m[r] and v[r].
//
// What bounds it: bytes. It reads n*(d+1)*4 bytes of list and reads and
// writes 6*u*d*4 bytes of the u distinct rows of table, m and v, with a
// dozen operations per element. A warp per entry that read rows[i],
// rows[i-1], rows[end], the gradients and the three state rows one after
// the other, and computed powf twice in every thread, kept 64 bytes per
// warp in flight and reached a quarter of the bound: latency. This design
// reaches 56% of it (0.0495 ms against 0.0276 at the flagship list,
// 212992 entries on [2600000, 16], NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py --tune) and is bound now by the card's rate for scattered
// 64-byte rows: with the list streamed at the peak rate, the state rows
// move at about 1.75 TB/s, as scatter_add.cu's table rows do, and tiles of
// 64 to 512 entries with batches of 1 to 4 (2 to 6 resident blocks per SM)
// all take 0.0486-0.0566 ms.
//
// Design: adagrad_update.cu's, on sorted_runs.cuh, with three state
// arrays. A block takes a tile of `tile` consecutive entries; one thread
// starts a single bulk copy of the tile's gradients into shared memory and
// computes lr, bc1 and bc2 once for the block (powf of the same inputs
// gives the same bits in every block), while all threads load the tile's
// rows; heads are found in shared memory. Each entry is served by a group
// of min(32, d/4) lanes of 16 bytes. A group first issues the loads of the
// table, m and v rows of up to `batch` heads it owns (held in registers:
// 3 * batch * 4 floats a thread), only then waits for the copy, sums each
// run from shared memory, applies and stores. These batched register loads
// were taken over asynchronous copies of the state rows into shared memory
// because they are the simpler of the two and reach the goal of twice the
// bound: at tiles of 128 entries of d = 16 a thread serves two entries, so
// a batch of 2 holds both heads' rows, 96 bytes, some 24 KB a block with 4
// blocks resident per SM (a batch of 8 leaves one block and is slower). A
// d that 4 does not divide, or a grads, table, m or v address that 16 does
// not divide, takes the scalar lanes (and, for grads, plain loads from
// global memory) in the same kernel, as does a tile too large to stage.
// The bf16 mode is the same kernel on Store<bf16, V> lanes (8 bytes for 4
// elements of each state row and of the staged gradients); its gradients
// are staged only where a row is a whole number of 16 bytes (d a
// multiple of 8) at a 16-byte-aligned address, and are plain loads
// otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

struct AdamScalars {
  float lr, bc1, bc2;
};

struct AdamParams {
  float b1, b2, omb1, omb2, eps;
};

// Explicitly rounded operations keep nvcc from contracting them into FMAs,
// so each step rounds as in the plain PyTorch version.
__device__ __forceinline__ void adam_apply(float& t, float& m, float& v,
                                           float s, const AdamScalars& k,
                                           const AdamParams& p) {
  m = __fadd_rn(__fmul_rn(p.b1, m), __fmul_rn(p.omb1, s));
  v = __fadd_rn(__fmul_rn(p.b2, v), __fmul_rn(__fmul_rn(p.omb2, s), s));
  const float upd =
      __fdiv_rn(__fmul_rn(k.lr, __fdiv_rn(m, k.bc1)),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), p.eps));
  t = __fsub_rn(t, upd);
}

// Shared memory: the mbarrier and the block's scalars (32 bytes), the
// staged gradients (tile * d * sizeof(S) bytes, when `staged`), then
// tile + 1 rows.
template <typename S, typename V, int kBatch>
__global__ void __launch_bounds__(kThreads)
adam_update_sorted_kernel(S* __restrict__ table, S* __restrict__ m,
                          S* __restrict__ v,
                          const int32_t* __restrict__ rows,
                          const S* __restrict__ grads,
                          const float* __restrict__ lr_ptr,
                          const float* __restrict__ step_ptr, AdamParams p,
                          int64_t n, int64_t vocab, int d, int tile,
                          int staged) {
  using St = Store<S, V>;
  using Raw = typename St::Raw;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  AdamScalars* scalars_s = reinterpret_cast<AdamScalars*>(smem + 16);
  Raw* grad_s = reinterpret_cast<Raw*>(smem + 32);
  int32_t* rows_s = reinterpret_cast<int32_t*>(
      smem + 32 + (staged ? static_cast<size_t>(tile) * d * sizeof(S) : 0));

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int cnt = static_cast<int>(n - t0 < tile ? n - t0 : tile);
  const int width = d / Lane<V>::kFloats;
  const Raw* gsrc = reinterpret_cast<const Raw*>(grads);
  Raw* trows = reinterpret_cast<Raw*>(table);
  Raw* mrows = reinterpret_cast<Raw*>(m);
  Raw* vrows = reinterpret_cast<Raw*>(v);

  if (threadIdx.x == 0) {
    if (staged) {
      mbarrier_init(bar);
      bulk_load(grad_s, grads + t0 * d,
                static_cast<uint32_t>(cnt) * d * sizeof(S), bar);
    }
    const float step = *step_ptr;
    *scalars_s = AdamScalars{*lr_ptr, __fsub_rn(1.f, powf(p.b1, step)),
                             __fsub_rn(1.f, powf(p.b2, step))};
  }
  stage_rows(rows_s, rows, t0, cnt);
  __syncthreads();

  const AdamScalars k = *scalars_s;
  const Raw* tile_src = staged ? grad_s : gsrc + t0 * width;
  const Groups g(width);
  bool landed = !staged;
  if (g.active()) {
    for (int c = g.lane; c < width; c += g.lanes) {
      for (int j0 = g.group; j0 < cnt; j0 += g.count * kBatch) {
        int32_t r[kBatch];
        V ht[kBatch], hm[kBatch], hv[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int j = j0 + b * g.count;
          r[b] = j < cnt && is_head(rows_s, j, vocab) ? rows_s[j + 1] : -1;
          ht[b] = hm[b] = hv[b] = Lane<V>::zero();
          if (r[b] >= 0) {
            const int64_t at = static_cast<int64_t>(r[b]) * width + c;
            ht[b] = St::load(trows[at]);
            hm[b] = St::load(mrows[at]);
            hv[b] = St::load(vrows[at]);
          }
        }
        if (!landed) {
          mbarrier_wait(bar, 0);
          landed = true;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (r[b] < 0) continue;
          V s = run_total<V, S>(rows_s, j0 + b * g.count, cnt, r[b],
                                tile_src, width, c, rows, gsrc, t0 + cnt, n);
#pragma unroll
          for (int e = 0; e < Lane<V>::kFloats; ++e) {
            adam_apply(Lane<V>::at(ht[b], e), Lane<V>::at(hm[b], e),
                       Lane<V>::at(hv[b], e), Lane<V>::at(s, e), k, p);
          }
          const int64_t at = static_cast<int64_t>(r[b]) * width + c;
          mrows[at] = St::store(hm[b]);
          vrows[at] = St::store(hv[b]);
          trows[at] = St::store(ht[b]);
        }
      }
    }
  }
  // No block leaves while its copy is in flight.
  if (!landed) mbarrier_wait(bar, 0);
}

template <typename S>
using Kernel = void (*)(S*, S*, S*, const int32_t*, const S*, const float*,
                        const float*, AdamParams, int64_t, int64_t, int, int,
                        int);

// The kernel for `batch` (1, 2, 4 or 8), or nullptr.
template <typename S, typename V>
Kernel<S> kernel_for(int batch) {
  switch (batch) {
    case 1: return adam_update_sorted_kernel<S, V, 1>;
    case 2: return adam_update_sorted_kernel<S, V, 2>;
    case 4: return adam_update_sorted_kernel<S, V, 4>;
    case 8: return adam_update_sorted_kernel<S, V, 8>;
  }
  return nullptr;
}

template <typename S>
int launch_for(void* table, void* m, void* v, const void* rows,
               const void* grads, const void* lr, const void* step,
               AdamParams p, int64_t n, int64_t vocab, int d, int tile,
               int batch, void* stream) {
  if (tile < 1 || tile > 32768 || !kernel_for<S, float>(batch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || vocab <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  const bool staged = stageable<S>(grads, d, tile);
  const Kernel<S> kernel =
      d % 4 == 0 && lane_aligned<S>(grads) && lane_aligned<S>(table) &&
              lane_aligned<S>(m) && lane_aligned<S>(v)
          ? kernel_for<S, float4>(batch)
          : kernel_for<S, float>(batch);
  size_t smem;
  const cudaError_t err =
      tile_shared_memory(kernel, d, tile, staged, sizeof(S), &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n + tile - 1) / tile;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<S*>(table), static_cast<S*>(m), static_cast<S*>(v),
      static_cast<const int32_t*>(rows), static_cast<const S*>(grads),
      static_cast<const float*>(lr), static_cast<const float*>(step), p, n,
      vocab, d, tile, staged ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int blocks_per_sm(int d, int tile, int batch, int* blocks) {
  const Kernel<S> kernel = kernel_for<S, float4>(batch);
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
// before it waits for the tile's gradients, for f32 table, moments and
// gradients (_f32) or bf16 ones (_bf16). Each returns the first CUDA
// error, else cudaGetLastError().
extern "C" int hb_adam_update_sorted_f32(void* table, void* m, void* v,
                                         const void* rows, const void* grads,
                                         const void* lr, const void* step,
                                         float b1, float b2, float omb1,
                                         float omb2, float eps, int64_t n,
                                         int64_t vocab, int d, int tile,
                                         int batch, void* stream) {
  return launch_for<float>(table, m, v, rows, grads, lr, step,
                           AdamParams{b1, b2, omb1, omb2, eps}, n, vocab, d,
                           tile, batch, stream);
}

extern "C" int hb_adam_update_sorted_bf16(void* table, void* m, void* v,
                                          const void* rows, const void* grads,
                                          const void* lr, const void* step,
                                          float b1, float b2, float omb1,
                                          float omb2, float eps, int64_t n,
                                          int64_t vocab, int d, int tile,
                                          int batch, void* stream) {
  return launch_for<__nv_bfloat16>(table, m, v, rows, grads, lr, step,
                                   AdamParams{b1, b2, omb1, omb2, eps}, n,
                                   vocab, d, tile, batch, stream);
}

// Blocks of the 4-element-lane kernel resident on one SM at row width `d`
// (a multiple of 4), tiles of `tile` entries and `batch`, into *blocks;
// `bf16` != 0 for the bf16 kernel.
extern "C" int hb_adam_update_sorted_blocks_per_sm(int d, int tile,
                                                   int batch, int bf16,
                                                   int* blocks) {
  return bf16 ? blocks_per_sm<__nv_bfloat16>(d, tile, batch, blocks)
              : blocks_per_sm<float>(d, tile, batch, blocks);
}
