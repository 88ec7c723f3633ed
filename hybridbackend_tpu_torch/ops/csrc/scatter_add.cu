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
// Design: sorted_runs.cuh's update_tile with AddRows. A block takes a
// tile of `tile` consecutive entries, one bulk copy of its updates and one
// load of its rows; a group of min(32, d/4) lanes (4 at d = 16, 8 entries
// a warp instruction) serves an entry, issues the loads of the table rows
// of up to kBatch heads it owns, only then waits for the copy, sums each
// run from shared memory and stores once. Tiles of 64 to 512 entries
// measure within 5% of each other at the flagship list; 128 is the
// fastest, 256 no faster at the Criteo list. A d that 4 does not divide,
// or an `updates` or `table` address that a 4-element lane does not
// divide, takes the scalar lanes; updates that cannot be staged (a row not
// a whole number of 16 bytes, an unaligned address, a tile too large)
// are plain loads from global memory in the same kernel. The bf16 kernel
// is the f32 one with Store<bf16, V> lanes (8 bytes for 4 elements).
//
// Long runs: a column's first id in the Criteo entry point's batch takes
// about 1570 of 4096 entries. A run's owner used to walk its rest past the
// tile one dependent global load an entry (0.41 ms at the Criteo list,
// 21x the flagship list's time). Now a run that ends within 8 entries
// past its tile stays its group's (those entries are staged with the
// tile), and a longer one is the block's: its end found by a search while
// the groups work, its rest streamed through a ring of two 16-KB stages in
// shared memory and added in scalar lanes. At the Criteo list
// 0.0197-0.0198 ms (bf16 0.0200-0.0202) against the walk's 0.41 and
// `index_add_`'s 0.0254-0.0259; at the flagship list 0.0182-0.0183
// against the walk's 0.0192-0.0193 (bf16 0.0159-0.0160 against 0.0159),
// chip_smoke.py --long-runs, NVIDIA H100 80GB HBM3, 700 W. The totals
// keep their bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

// Table rows a thread loads before it waits for its tile: at d = 16 a
// group serves 2 entries of a 128-entry tile; bf16 ran faster with 4.
template <typename S>
constexpr int kBatch = sizeof(S) == 2 ? 4 : 2;

// A run's row (update_tile's Rows): its table lane, and the total added
// and stored once.
template <typename S>
struct AddRows {
  static constexpr bool kSquares = false;
  S* table;
  template <typename V>
  struct State {
    V t;
  };
  __device__ void setup(float*) const {}
  __device__ void read(const float*) {}
  template <typename V>
  __device__ State<V> load(int64_t at) const {
    return {load_lane<V>(table, at)};
  }
  template <typename V>
  __device__ void store(int64_t at, State<V> st, V s, V) const {
    store_lane<V>(table, at, Lane<V>::add(st.t, s));
  }
};

// The blocks that one SM must hold, as in 4-element lanes before the
// long-run path was added (its loops would otherwise take registers that
// lower them to 4).
constexpr int kMinBlocks = 5;

template <typename S, typename V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scatter_add_sorted_kernel(S* __restrict__ table,
                          const int32_t* __restrict__ rows,
                          const S* __restrict__ updates, int64_t n,
                          int64_t vocab, int d, int tile, int staged) {
  update_tile<S, V, kBatch<S>>(AddRows<S>{table}, rows, updates, n, vocab, d,
                            tile, staged != 0);
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
  const auto kernel =
      d % 4 == 0 && lane_aligned<S>(updates) && lane_aligned<S>(table)
          ? scatter_add_sorted_kernel<S, float4>
          : scatter_add_sorted_kernel<S, float>;
  return launch_tiles(kernel, n, d, tile, staged, sizeof(S), stream,
                      static_cast<S*>(table),
                      static_cast<const int32_t*>(rows),
                      static_cast<const S*>(updates), n, vocab, d, tile,
                      staged ? 1 : 0);
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
