// Device code shared by the kernels that walk a row-sorted update list on
// Hopper (sm_90a): scatter_add.cu, gsum_dense.cu, adagrad_update.cu and
// adam_update.cu.
//
// The list is `rows` int32 [n], ascending, with `updates` [n, d] stored as
// S: float, or __nv_bfloat16 where the table it updates is bf16. A *run*
// is a maximal stretch of equal rows; its *head* is its first entry.
// Every kernel here gives each run one owner, which forms the run's total
// in f32 from 0.f by adding the run's entries in list order with
// __fadd_rn: no float atomics, no tree or shuffle reduction, so every
// kernel forms the same bits for the same list, in either storage type.
//
// What the pieces are for, on this card:
//   * A block takes a *tile* of consecutive list entries. The tile's rows
//     (and the entry before it, to tell whether the first entry starts a
//     run) go to shared memory with one coalesced load (stage_rows); the
//     tile's updates are one contiguous span of cnt*d*sizeof(S) bytes,
//     which one thread copies with a single cp.async.bulk that reports to
//     an mbarrier (bulk_load). Tens of KB are in flight per block for one
//     instruction and no registers. A contiguous span needs no tensor map.
//   * Run heads are found in shared memory (is_head), and a run is summed
//     from shared memory (run_total); an owner whose run leaves the tile
//     finishes it from global memory, and a tile that starts inside a run
//     leaves those entries to the earlier tile's owner (scatter_add.cu,
//     adam_update.cu).
//   * Long runs (gsum_dense.cu, adagrad_update.cu): a run that leaves the
//     tile is the tile's last, its *tail*. run_total walks a tail one
//     dependent global load an entry (rows[i] decides whether entry i is
//     added), about 0.34 us an entry on this card: a column of a few rows
//     that takes a zipf column's hot ids gives runs of thousands, and a
//     millisecond of walk. Here the block instead finds the tail's end
//     with a warp's search (run_end: one read of 32 rows, then 33-way
//     steps) and adds the tail as a known span in scalar lanes, one chain
//     of adds a lane: streamed through a ring of 2 to 4 shared-memory
//     stages by one thread's bulk copies against mbarriers (stream_run),
//     or, a tail of a few entries or of rows that cannot be staged, read
//     from global memory in a counted loop (add_span, which keeps a block
//     of loads in flight ahead of the adds). kernel 4 also finds a run's
//     extent in its chunk from bits of change points (stage_rows_runs,
//     next_change). The adds keep their order and rounding, so the bits
//     are run_total's.
//   * An entry is served by a *group* of min(32, width) threads (Groups),
//     not by a warp: at d = 16 a row is 4 lanes of 4 elements, so one warp
//     instruction serves 8 entries. Lane<float4> is the 4-element math
//     lane, Lane<float> the scalar one for a d or an address that a lane's
//     storage does not divide; a group never cooperates across lanes, so
//     it may straddle warps.
//   * Store<S, V> is how a math lane V lies in memory: the math is f32
//     whatever the storage; a bf16 lane (8 bytes for 4 elements) widens
//     exactly to f32 on load and is rounded to nearest once on store.
//   * lower_bound_warp finds where a row starts in the sorted list with a
//     33-way search (4 or 5 dependent reads for 2e5 entries, not 18).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sorted_runs {

constexpr int kThreads = 256;
// The most a block stages of a tile's updates; a larger tile is read from
// global memory.
constexpr size_t kMaxStageBytes = 160 * 1024;

// One thread's share of a row in f32: an element, or 4 of them.
template <typename V>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int kFloats = 1;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  // q + g*g, each operation rounded.
  static __device__ __forceinline__ float add_square(float q, float g) {
    return __fadd_rn(q, __fmul_rn(g, g));
  }
  // Element k (0 only) of the lane.
  static __device__ __forceinline__ float& at(float& a, int) { return a; }
};

template <>
struct Lane<float4> {
  static constexpr int kFloats = 4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float4 add(float4 a, float4 b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  static __device__ __forceinline__ float4 add_square(float4 q, float4 g) {
    return make_float4(Lane<float>::add_square(q.x, g.x),
                       Lane<float>::add_square(q.y, g.y),
                       Lane<float>::add_square(q.z, g.z),
                       Lane<float>::add_square(q.w, g.w));
  }
  // Element k of the lane; with k known at compile time (an unrolled
  // loop) it stays in a register.
  static __device__ __forceinline__ float& at(float4& a, int k) {
    return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
  }
};

// The storage `Raw` of a math lane V in storage type S, and the exact
// load and the round-to-nearest store between them.
template <typename S, typename V>
struct Store;

template <typename V>
struct Store<float, V> {
  using Raw = V;
  static __device__ __forceinline__ V load(Raw r) { return r; }
  static __device__ __forceinline__ Raw store(V v) { return v; }
};

template <>
struct Store<__nv_bfloat16, float> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ float load(Raw r) {
    return __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Four bf16, element k in bits 16k..16k+15 of the little-endian pair.
template <>
struct Store<__nv_bfloat16, float4> {
  using Raw = uint2;
  static __device__ __forceinline__ float4 load(Raw r) {
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  }
  static __device__ __forceinline__ uint32_t pair(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
           | (static_cast<uint32_t>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
  }
  static __device__ __forceinline__ Raw store(float4 v) {
    return make_uint2(pair(v.x, v.y), pair(v.z, v.w));
  }
};

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether `p` may be read and written in 4-element lanes of S.
template <typename S>
__host__ inline bool lane_aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(S)) == 0;
}

// Whether the `tile`-entry tiles of a list of `d`-wide rows of S at
// `updates` go to shared memory with one bulk copy each: a row is a whole
// number of 16 bytes (so every tile's span starts and ends on one),
// `updates` is 16-byte aligned, and a tile fits in kMaxStageBytes.
template <typename S>
__host__ inline bool stageable(const void* updates, int d, int tile) {
  const size_t row = static_cast<size_t>(d) * sizeof(S);
  return row % 16 == 0 && aligned16(updates) &&
         static_cast<size_t>(tile) * row <= kMaxStageBytes;
}

// The threads of a block cut into groups of `lanes` = min(32, width)
// threads; group g serves one list entry at a time, lane l the elements
// l, l + lanes, ... of its row. Threads beyond the last whole group idle.
struct Groups {
  int lanes, count, group, lane;
  __device__ explicit Groups(int width) {
    lanes = width < 32 ? (width > 0 ? width : 1) : 32;
    count = kThreads / lanes;
    group = threadIdx.x / lanes;
    lane = threadIdx.x % lanes;
  }
  __device__ bool active() const { return group < count; }
};

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory of a launch of a tile kernel whose block
// holds `header` bytes of mbarriers and scalars, then the tile's staged
// updates of `elem` bytes an element (when `staged`), then its tile +
// `extra_rows` rows (adagrad_update.cu: 64 and 2, adam_update.cu: 32 and
// 1); raises `kernel`'s limit where that is above 48 KB.
template <typename Kernel>
cudaError_t tile_shared_memory(Kernel kernel, int d, int tile, bool staged,
                               size_t elem, size_t* bytes, size_t header = 32,
                               int extra_rows = 1) {
  *bytes = header + (staged ? static_cast<size_t>(tile) * d * elem : 0) +
           (static_cast<size_t>(tile) + extra_rows) * 4;
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

// One thread: makes `bar` ready for one arrival and for the async proxy.
__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   shared_address(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: copies `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory; `bar` completes when they land.
__device__ __forceinline__ void bulk_load(void* dst_shared,
                                          const void* src_global,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(shared_address(dst_shared)),
      "l"(__cvta_generic_to_global(src_global)), "r"(bytes),
      "r"(shared_address(bar))
      : "memory");
}

// Every thread that reads what bulk_load brought waits here first.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t"
        ".reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t"
        "}"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
  }
}

// All threads: rows_s[1 + k] = rows[t0 + k] for k in [0, cnt), and
// rows_s[0] = rows[t0 - 1], or -1 (no valid row) at the head of the list.
// The block syncs before it reads rows_s.
__device__ __forceinline__ void stage_rows(int32_t* rows_s,
                                           const int32_t* __restrict__ rows,
                                           int64_t t0, int cnt) {
  for (int i = threadIdx.x; i <= cnt; i += kThreads) {
    const int64_t at = t0 - 1 + i;
    rows_s[i] = at >= 0 ? rows[at] : -1;
  }
}

// Whether tile entry j starts a run of a valid row.
__device__ __forceinline__ bool is_head(const int32_t* rows_s, int j,
                                        int64_t vocab) {
  const int32_t r = rows_s[j + 1];
  return r >= 0 && r < vocab && r != rows_s[j];
}

// Element c of the total of the run of row r that tile entry j heads,
// summed in f32 from 0.f in list order. Entries [j, cnt) of the tile are
// read from `tile_src` (shared or global memory; entry k, lane c at
// tile_src[k * stride + c]). A run that reaches the tile's end goes on in
// global memory from list entry `tile_end` (lane c of entry i at
// updates[i * stride + c]) while rows[i] == r and i < limit.
template <typename V, typename S = float>
__device__ __forceinline__ V run_total(
    const int32_t* rows_s, int j, int cnt, int32_t r,
    const typename Store<S, V>::Raw* tile_src, int64_t stride, int c,
    const int32_t* __restrict__ rows,
    const typename Store<S, V>::Raw* __restrict__ updates, int64_t tile_end,
    int64_t limit) {
  using St = Store<S, V>;
  V s = Lane<V>::zero();
  int k = j;
  do {
    s = Lane<V>::add(s, St::load(tile_src[k * stride + c]));
    ++k;
  } while (k < cnt && rows_s[k + 1] == r);
  if (k == cnt) {
    for (int64_t i = tile_end; i < limit && rows[i] == r; ++i)
      s = Lane<V>::add(s, St::load(updates[i * stride + c]));
  }
  return s;
}

// One whole warp: the first index i in [0, n) with rows[i] >= key (n if
// none), for ascending rows. Each step reads 32 probes that cut the span
// into 33 parts.
__device__ __forceinline__ int64_t lower_bound_warp(
    const int32_t* __restrict__ rows, int64_t n, int64_t key) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t p = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned below = __ballot_sync(0xffffffffu, rows[p] < key);
    const int k = __popc(below);  // probes 0..k-1 are below the key
    const long long last_below =
        __shfl_sync(0xffffffffu, static_cast<long long>(p), k > 0 ? k - 1 : 0);
    const long long first_at =
        __shfl_sync(0xffffffffu, static_cast<long long>(p), k < 32 ? k : 31);
    if (k > 0) lo = last_below + 1;
    if (k < 32) hi = first_at;
  }
  return lo;
}

// ---------------------------------------------------------------------
// Long runs (gsum_dense.cu, adagrad_update.cu). A run that leaves its tile
// is always the tile's last run. Instead of walking its tail one
// dependent global load an entry (run_total), the block finds the tail's
// end with a search (run_end) and then adds the tail as one known span:
// streamed through shared memory by bulk copies (stream_run), or, where
// the rows cannot be staged or the tail is short, read from global
// memory in a counted loop with several loads in flight (add_span).

// A tail of at most this many entries is read from global memory: one
// round of loads, where a bulk copy would cost a round of its own.
constexpr int64_t kShortTail = 8;
// Stages of kernel 4's ring (and mbarriers a kernel holds for one).
constexpr int kRingStages = 4;

// All threads: stage_rows for a tile of `cnt` entries, and one more row:
// rows_s[cnt + 1] = rows[t0 + cnt], or -1 where t0 + cnt is `limit`
// (whether the tile's last run goes on past it). The block syncs before
// it reads rows_s.
__device__ __forceinline__ void stage_rows_ahead(
    int32_t* rows_s, const int32_t* __restrict__ rows, int64_t t0, int cnt,
    int64_t limit) {
  for (int i = threadIdx.x; i <= cnt + 1; i += kThreads) {
    const int64_t at = t0 - 1 + i;
    rows_s[i] = at >= 0 && at < limit ? rows[at] : -1;
  }
}

// stage_rows_ahead, and the tile's change points, a bit an entry: bit j
// of change_s (entry j of the tile, j in [0, cnt]) is set where
// rows_s[j + 1] != rows_s[j], so that a run's extent is a search for the
// next set bit (next_change), not a walk through shared memory, where each
// step waits for the last load. Each warp ballots its 32 entries.
__device__ __forceinline__ void stage_rows_runs(
    int32_t* rows_s, uint32_t* change_s, const int32_t* __restrict__ rows,
    int64_t t0, int cnt, int64_t limit) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base <= cnt + 1; base += kThreads) {
    const int i = base + static_cast<int>(threadIdx.x);
    const int64_t at = t0 - 1 + i;
    int32_t v = -1;
    if (i <= cnt + 1) {
      v = at >= 0 && at < limit ? rows[at] : -1;
      rows_s[i] = v;
    }
    int32_t next = __shfl_down_sync(0xffffffffu, v, 1);
    if (lane == 31)
      next = i + 1 <= cnt + 1 && at + 1 < limit ? rows[at + 1] : -1;
    const unsigned word = __ballot_sync(0xffffffffu, i <= cnt && next != v);
    if (lane == 0 && i <= cnt) change_s[i >> 5] = word;
  }
}

// The run of row r that tile entry j heads, as far as the tile holds it,
// added to s (and q) in list order: run_total's walk without its global
// part, for a run that ends in the tile.
template <typename V, typename S, bool kSquares>
__device__ __forceinline__ void tile_run(
    const int32_t* rows_s, int j, int cnt, int32_t r,
    const typename Store<S, V>::Raw* tile_src, int64_t stride, int c, V& s,
    V& q) {
  using St = Store<S, V>;
  int k = j;
  do {
    const V x = St::load(tile_src[k * stride + c]);
    s = Lane<V>::add(s, x);
    if constexpr (kSquares) q = Lane<V>::add_square(q, x);
    ++k;
  } while (k < cnt && rows_s[k + 1] == r);
}

// The first k in (j, cnt] whose bit is set in change_s (entry k starts a
// new stretch of rows), or cnt + 1 if none: the run at entry j covers
// entries [j, k) of the tile, and goes on past it where k is cnt + 1.
__device__ __forceinline__ int next_change(const uint32_t* change_s, int j,
                                           int cnt) {
  for (int k = j + 1; k <= cnt; k = (k | 31) + 1) {
    const uint32_t w = change_s[k >> 5] >> (k & 31);
    if (w) {
      const int at = k + __ffs(static_cast<int>(w)) - 1;
      return at <= cnt ? at : cnt + 1;
    }
  }
  return cnt + 1;
}

// Whether the last run of a tile of `cnt` entries (staged by
// stage_rows_runs) starts in the tile and goes on past it: its tail.
__device__ __forceinline__ bool tail_leaves(const int32_t* rows_s, int cnt,
                                            int64_t vocab) {
  const int32_t r = rows_s[cnt];
  return r >= 0 && r < vocab && rows_s[cnt + 1] == r && rows_s[0] != r;
}

// s (and, with kSquares, q: each entry's square rounded and added) over
// entries [0, m) of a span, entry k's lane at src[k * stride], in order,
// from the values s and q hold. The loads of the next kAhead entries are
// in flight while the adds of the last kAhead wait on each other, two
// register blocks taking turns (a copy from one to the other would wait
// for the loads): the adds take the time, not the loads.
// kStride, where nonzero, is `stride` known at compile time: each load is
// then one instruction at a fixed offset from the span's pointer.
template <typename V, typename S, bool kSquares, int kAhead = 4,
          int kStride = 0>
__device__ __forceinline__ void add_span(
    const typename Store<S, V>::Raw* src, int64_t m, int64_t runtime_stride,
    V& s, V& q) {
  using St = Store<S, V>;
  using Raw = typename St::Raw;
  const int64_t stride = kStride ? kStride : runtime_stride;
  const auto add = [&](Raw raw) {
    const V x = St::load(raw);
    s = Lane<V>::add(s, x);
    if constexpr (kSquares) q = Lane<V>::add_square(q, x);
  };
  Raw a[kAhead], b[kAhead];
  const auto fetch = [&](Raw* to, int64_t k) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) to[u] = src[(k + u) * stride];
  };
  const auto add_all = [&](const Raw* from) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) add(from[u]);
  };
  int64_t k = 0;
  if (m >= kAhead) {
    fetch(a, 0);
#pragma unroll 1
    while (true) {  // a holds entries [k, k + kAhead)
      if (k + 2 * kAhead > m) {
        add_all(a);
        k += kAhead;
        break;
      }
      fetch(b, k + kAhead);
      add_all(a);
      k += kAhead;
      if (k + 2 * kAhead > m) {
        add_all(b);
        k += kAhead;
        break;
      }
      fetch(a, k + kAhead);
      add_all(b);
      k += kAhead;
    }
  }
#pragma unroll 1
  for (; k < m; ++k) add(src[k * stride]);
}

// One whole warp: the first index in [t, limit) whose row is not r (limit
// if none), for ascending rows where rows[t - 1] == r. The first step
// reads the 32 rows from t, which ends a short tail in one read; a longer
// one takes lower_bound_warp of r + 1 over the rest, a few reads for
// thousands of entries. On rows out of order it returns some index in
// [t, limit], after at most about log33 of the span's steps.
__device__ __forceinline__ int64_t run_end(const int32_t* __restrict__ rows,
                                           int64_t t, int64_t limit,
                                           int32_t r) {
  const int64_t i = t + (threadIdx.x & 31);
  const unsigned ended =
      __ballot_sync(0xffffffffu, i >= limit || rows[i] != r);
  if (ended) return t + __ffs(static_cast<int>(ended)) - 1;
  return t + 32 + lower_bound_warp(rows + t + 32, limit - t - 32,
                                   static_cast<int64_t>(r) + 1);
}

// A ring of `stages` stages of `stage` entries (rows of `width` lanes
// stored as Raw) in shared memory at `buf`, stage b reporting to bars[b]
// (initialised, one arrival). Bit b of `phase` is the parity bars[b]
// completes next; every thread of the block keeps the same bits.
template <typename Raw>
struct Ring {
  Raw* buf;
  uint64_t* bars;
  int stages, stage;
};

// All threads of the block: adds lane c of entries [begin, end) of `src`
// (global memory, entry i's lane at src[i * width + c]) to s (and q) in
// list order, in the threads with `active` (thread 0 among them). Thread
// 0 copies the span through the ring, ring.stages bulk copies in flight:
// a stage is refilled once the block has synced after reading it. Entries
// must be a whole number of 16 bytes at a 16-byte-aligned `src`. Ends
// synced, so the ring may be reused.
template <typename V, typename S, bool kSquares, int kAhead = 4,
          int kStride = 0>
__device__ __forceinline__ void stream_run(
    const Ring<typename Store<S, V>::Raw>& ring, uint32_t& phase,
    const typename Store<S, V>::Raw* __restrict__ src, int64_t begin,
    int64_t end, int width, int c, bool active, V& s, V& q) {
  using Raw = typename Store<S, V>::Raw;
  const int64_t total = end - begin;
  const int64_t chunks = (total + ring.stage - 1) / ring.stage;
  const auto copy = [&](int64_t k) {
    const int b = static_cast<int>(k % ring.stages);
    const int64_t e0 = begin + k * ring.stage;
    const int64_t m = end - e0 < ring.stage ? end - e0 : ring.stage;
    bulk_load(ring.buf + static_cast<int64_t>(b) * ring.stage * width,
              src + e0 * width,
              static_cast<uint32_t>(m * width * sizeof(Raw)), &ring.bars[b]);
  };
  if (threadIdx.x == 0)
    for (int64_t k = 0; k < chunks && k < ring.stages; ++k) copy(k);
#pragma unroll 1
  for (int64_t k = 0; k < chunks; ++k) {
    const int b = static_cast<int>(k % ring.stages);
    if (active) {
      const int64_t e0 = k * ring.stage;
      mbarrier_wait(&ring.bars[b], (phase >> b) & 1u);
      add_span<V, S, kSquares, kAhead, kStride>(
          ring.buf + static_cast<int64_t>(b) * ring.stage * width + c,
          total - e0 < ring.stage ? total - e0 : ring.stage, width, s, q);
    }
    phase ^= 1u << b;
    __syncthreads();
    if (threadIdx.x == 0 && k + ring.stages < chunks) copy(k + ring.stages);
  }
}

}  // namespace sorted_runs
