// Row-sparse add over a row-sorted update list, for Hopper (sm_90a).
//
// Replaces the TPU kernel hybridbackend_tpu/ops/pallas/scatter.py:
// scatter_add_sorted (mode 'add' of _scatter_kernel). The TPU version
// streams the whole table and sums duplicates with a one-hot matmul; here
// only the rows in the list are read and written.
//
// Contract (the same as the TPU kernel's):
//   rows     int32 [n], ascending; entries < 0 or >= vocab are skipped;
//   updates  [n, d] of the table's type, updates[i] belongs to rows[i];
//   table    f32 or bf16 [vocab, d], updated in place:
//            table[r] += sum of updates[i] over the i with rows[i] == r.
// The sum of a run is formed first, in f32 from 0.f in list order with
// explicitly rounded adds, and then added to the row once, as the TPU
// kernel adds its per-row totals. No float atomics: the result is
// deterministic. A bf16 table (hb_scatter_add_sorted_bf16) is read as
// f32 and stores bf16(f32(table[r]) + s), rounded to nearest once, as the
// TPU kernel's `(tbl + gsum).astype(bf16)`.
//
// What bounds it: bytes in the reckoning (n*(d+1)*4 bytes of list read,
// 2*u*d*4 bytes of the u distinct rows read and written, one add per
// element), latency in practice. A warp per entry that read rows[i],
// rows[i-1], rows[end], the update and the table row one after the other
// kept 64 bytes per warp in flight and reached a quarter of the bound.
//
// Design (sorted_runs.cuh holds the pieces). A block takes a tile of
// `tile` consecutive entries. One thread starts a single bulk copy of the
// tile's updates into shared memory while all threads load the tile's
// rows; run heads are then found in shared memory. Each entry is served by
// a group of min(32, d/4) lanes of 16 bytes (4 lanes at d = 16, 8 entries
// per warp instruction). A group first issues the loads of the table rows
// of up to kBatch heads it owns, only then waits for the bulk copy, sums
// each run from shared memory and stores: the table's latency overlaps the
// copy's, and a thread has kBatch 16-byte loads in flight, not one of 4
// bytes. One tile per block and no ring: at 128 entries of d = 16 a block
// holds 9 KB of shared memory and 256 threads, so eight blocks are resident
// on an SM, and while one waits for its copy the others update (1664 tiles
// at the flagship list, 1056 resident at once). Tiles of 64 to 512 entries
// measure within 5% of each other there; 128 is the fastest. A ring of two
// stages in a persistent block would buy nothing over that and cost a
// second barrier. A d that 4 does not divide, or an `updates` or `table`
// address that a 4-element lane (16 bytes in f32, 8 in bf16) does not
// divide, takes the scalar lanes. `updates` are staged by the bulk copy
// only where a row is a whole number of 16 bytes (every d that 4 divides
// in f32, 8 in bf16) at a 16-byte-aligned address; otherwise, and for a
// tile too large to stage (d > 2560 at the smallest tile in f32), they are
// plain loads from global memory in the same kernel. The bf16 kernel is
// the f32 one with Store<bf16, V> lanes: a row of 16 is 4 lanes of 8
// bytes, so a thread's loads are 8 bytes wide.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

constexpr int kBatch = 4;  // table rows a thread loads before it adds

// Shared memory: the mbarrier (16 bytes), the staged updates
// (tile * d * sizeof(S) bytes, when `staged`), then tile + 1 rows.
template <typename S, typename V>
__global__ void __launch_bounds__(kThreads)
scatter_add_sorted_kernel(S* __restrict__ table,
                          const int32_t* __restrict__ rows,
                          const S* __restrict__ updates, int64_t n,
                          int64_t vocab, int d, int tile, int staged) {
  using St = Store<S, V>;
  using Raw = typename St::Raw;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  Raw* upd_s = reinterpret_cast<Raw*>(smem + 16);
  int32_t* rows_s = reinterpret_cast<int32_t*>(
      smem + 16 + (staged ? static_cast<size_t>(tile) * d * sizeof(S) : 0));

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int cnt = static_cast<int>(n - t0 < tile ? n - t0 : tile);
  const int width = d / Lane<V>::kFloats;
  const Raw* gsrc = reinterpret_cast<const Raw*>(updates);
  Raw* trows = reinterpret_cast<Raw*>(table);

  if (staged && threadIdx.x == 0) {
    mbarrier_init(bar);
    bulk_load(upd_s, updates + t0 * d,
              static_cast<uint32_t>(cnt) * d * sizeof(S), bar);
  }
  stage_rows(rows_s, rows, t0, cnt);
  __syncthreads();

  const Raw* tile_src = staged ? upd_s : gsrc + t0 * width;
  const Groups g(width);
  bool landed = !staged;
  if (g.active()) {
    for (int c = g.lane; c < width; c += g.lanes) {
      for (int j0 = g.group; j0 < cnt; j0 += g.count * kBatch) {
        int32_t r[kBatch];
        V held[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int j = j0 + b * g.count;
          r[b] = j < cnt && is_head(rows_s, j, vocab) ? rows_s[j + 1] : -1;
          held[b] = Lane<V>::zero();
          if (r[b] >= 0)
            held[b] =
                St::load(trows[static_cast<int64_t>(r[b]) * width + c]);
        }
        if (!landed) {
          mbarrier_wait(bar, 0);
          landed = true;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (r[b] < 0) continue;
          const V s = run_total<V, S>(rows_s, j0 + b * g.count, cnt, r[b],
                                      tile_src, width, c, rows, gsrc,
                                      t0 + cnt, n);
          trows[static_cast<int64_t>(r[b]) * width + c] =
              St::store(Lane<V>::add(held[b], s));
        }
      }
    }
  }
  // No block leaves while its copy is in flight.
  if (!landed) mbarrier_wait(bar, 0);
}

template <typename S, typename V>
int launch(S* table, const int32_t* rows, const S* updates, int64_t n,
           int64_t vocab, int d, int tile, bool staged, cudaStream_t stream) {
  const size_t smem =
      16 + (staged ? static_cast<size_t>(tile) * d * sizeof(S) : 0) +
      (static_cast<size_t>(tile) + 1) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_add_sorted_kernel<S, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + tile - 1) / tile;
  scatter_add_sorted_kernel<S, V>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
          table, rows, updates, n, vocab, d, tile, staged ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The launch for a table of S: 4-element lanes where d and every address
// allow them, the bulk copy where the updates are stageable.
template <typename S>
int launch_for(void* table, const void* rows, const void* updates, int64_t n,
               int64_t vocab, int d, int tile, void* stream) {
  if (tile < 1 || tile > 32768) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || vocab <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  const bool staged = stageable<S>(updates, d, tile);
  S* t = static_cast<S*>(table);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const S* u = static_cast<const S*>(updates);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && lane_aligned<S>(updates) && lane_aligned<S>(table))
    return launch<S, float4>(t, r, u, n, vocab, d, tile, staged, s);
  return launch<S, float>(t, r, u, n, vocab, d, tile, staged, s);
}

}  // namespace

// Launch on `stream` (a cudaStream_t) with tiles of `tile` list entries,
// for an f32 table and updates (_f32) or bf16 ones (_bf16); each returns
// the first CUDA error, else cudaGetLastError().
extern "C" int hb_scatter_add_sorted_f32(void* table, const void* rows,
                                         const void* updates, int64_t n,
                                         int64_t vocab, int d, int tile,
                                         void* stream) {
  return launch_for<float>(table, rows, updates, n, vocab, d, tile, stream);
}

extern "C" int hb_scatter_add_sorted_bf16(void* table, const void* rows,
                                          const void* updates, int64_t n,
                                          int64_t vocab, int d, int tile,
                                          void* stream) {
  return launch_for<__nv_bfloat16>(table, rows, updates, n, vocab, d, tile,
                                   stream);
}
