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
// tile_run, add_span). The bf16 mode (hb_adam_update_sorted_bf16, the TPU
// kernel's bf16 table and moments) reads table, m and v as f32, does the
// same f32 math and stores each of the three rounded to nearest once; the
// table's step uses the unrounded m[r] and v[r].
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
// Design: sorted_runs.cuh's update_tile with AdamRows: adagrad_update.cu's
// with three state arrays (3 * batch * 4 floats a thread in registers; at
// tiles of 128 entries of d = 16 a batch of 2 holds a thread's two heads,
// 96 bytes, with 4 blocks resident per SM, kMinBlocks; a batch of 8 leaves
// one block and is slower). Thread 0 computes lr, bc1 and bc2 once for the
// block while the tile's rows are staged.
//
// Long runs: as in scatter_add.cu (its paragraph), the tail's row present
// whatever its total. At the Criteo list 0.0219-0.0221 ms (bf16
// 0.0224-0.0225) against the walk's 0.41 (bf16 0.37); at the flagship
// list 0.0492-0.0493 against 0.0496-0.0497 before (bf16 0.0428-0.0430
// against 0.0423-0.0424), chip_smoke.py --long-runs, NVIDIA H100 80GB
// HBM3, 700 W.

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

// A run's row (update_tile's Rows): its table, m and v lanes, and the
// update of its total s (zero or not: the row is present). Thread 0
// computes lr, bc1 and bc2 once for the block (powf of the same inputs
// gives the same bits in every block).
template <typename S>
struct AdamRows {
  static constexpr bool kSquares = false;
  S* table;
  S* m;
  S* v;
  const float* lr_ptr;
  const float* step_ptr;
  AdamParams p;
  AdamScalars k;
  template <typename V>
  struct State {
    V t, m, v;
  };
  __device__ void setup(float* sc) const {
    const float step = *step_ptr;
    sc[0] = *lr_ptr;
    sc[1] = __fsub_rn(1.f, powf(p.b1, step));
    sc[2] = __fsub_rn(1.f, powf(p.b2, step));
  }
  __device__ void read(const float* sc) {
    k = AdamScalars{sc[0], sc[1], sc[2]};
  }
  template <typename V>
  __device__ State<V> load(int64_t at) const {
    return {load_lane<V>(table, at), load_lane<V>(m, at),
            load_lane<V>(v, at)};
  }
  template <typename V>
  __device__ void store(int64_t at, State<V> st, V s, V) const {
#pragma unroll
    for (int e = 0; e < Lane<V>::kFloats; ++e)
      adam_apply(Lane<V>::at(st.t, e), Lane<V>::at(st.m, e),
                 Lane<V>::at(st.v, e), Lane<V>::at(s, e), k, p);
    store_lane<V>(m, at, st.m);
    store_lane<V>(v, at, st.v);
    store_lane<V>(table, at, st.t);
  }
};

// The blocks of the flagship's batch (2) that one SM must hold, as before
// the long-run path was added (2 without the floor); the tuning batches
// (4, 8) are left to the compiler.
template <int kBatch>
constexpr int kMinBlocks = kBatch > 2 ? 1 : 4;

template <typename S, typename V, int kBatch>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kBatch>)
adam_update_sorted_kernel(S* __restrict__ table, S* __restrict__ m,
                          S* __restrict__ v,
                          const int32_t* __restrict__ rows,
                          const S* __restrict__ grads,
                          const float* __restrict__ lr_ptr,
                          const float* __restrict__ step_ptr, AdamParams p,
                          int64_t n, int64_t vocab, int d, int tile,
                          int staged) {
  update_tile<S, V, kBatch>(AdamRows<S>{table, m, v, lr_ptr, step_ptr, p, {}},
                            rows, grads, n, vocab, d, tile, staged != 0);
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
  return launch_tiles(kernel, n, d, tile, staged, sizeof(S), stream,
                      static_cast<S*>(table), static_cast<S*>(m),
                      static_cast<S*>(v), static_cast<const int32_t*>(rows),
                      static_cast<const S*>(grads),
                      static_cast<const float*>(lr),
                      static_cast<const float*>(step), p, n, vocab, d, tile,
                      staged ? 1 : 0);
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
  return bf16 ? tile_blocks_per_sm(kernel_for<__nv_bfloat16, float4>(batch),
                                   d, tile, sizeof(__nv_bfloat16), blocks)
              : tile_blocks_per_sm(kernel_for<float, float4>(batch), d, tile,
                                   sizeof(float), blocks);
}
