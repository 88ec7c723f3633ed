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
//   * A block of a *tile kernel* (scatter_add.cu, adagrad_update.cu,
//     adam_update.cu; all three are update_tile with their own Rows) takes
//     a *tile* of consecutive list entries. The tile's rows and those
//     around it go to shared memory with one coalesced load
//     (stage_rows_ahead); the tile's updates are one contiguous span, which
//     one thread copies with a single cp.async.bulk that reports to an
//     mbarrier (bulk_load): tens of KB in flight per block for one
//     instruction and no registers, and no tensor map.
//   * Run heads are found in shared memory (is_head), and a group adds a
//     run from shared memory (tile_run). A tile that starts inside a run
//     leaves those entries to the run's owner.
//   * Long runs: a column of a few rows that takes a zipf column's hot ids
//     gives runs of thousands. Walking a run past its tile one dependent
//     global load an entry cost about 0.3 us an entry, a millisecond at
//     such a list. A run that goes on past its tile is the tile's last,
//     its *tail*. A short one (kShortTail) is staged with the tile and
//     stays its group's; for a long one the last warp finds the end with
//     a search while the groups work (run_end: one read of 32 rows, then
//     33-way steps), and the block adds it as a known span in scalar
//     lanes, one chain of adds a lane (finish_tail), streamed through a
//     ring of shared-memory stages by one thread's bulk copies against
//     mbarriers (stream_run), or, rows that cannot be staged, read from
//     global memory in a counted loop (add_span, which keeps a block of
//     loads in flight ahead of the adds). Kernel 4 (gsum_dense.cu) also
//     finds a run's extent in its chunk from bits of change points
//     (stage_rows_runs, next_change). The adds keep their order and
//     rounding, so the bits are those of a walk.
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
// A run that goes on for at most this many entries past its tile (a
// short tail) is its group's: a tile kernel stages those entries with its
// tile; kernel 4 reads them from global memory, one round of loads where
// a bulk copy would cost a round of its own.
constexpr int kShortTail = 8;

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

// Whether a tile kernel copies its `tile`-entry tiles (and the kShortTail
// entries past each) of a list of `d`-wide rows of S at `updates` to
// shared memory with one bulk copy each: a row is a whole number of 16
// bytes (so every span starts and ends on one), `updates` is 16-byte
// aligned, and a tile fits in kMaxStageBytes.
template <typename S>
__host__ inline bool stageable(const void* updates, int d, int tile) {
  const size_t row = static_cast<size_t>(d) * sizeof(S);
  return row % 16 == 0 && aligned16(updates) &&
         (static_cast<size_t>(tile) + kShortTail) * row <= kMaxStageBytes;
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

// The ring that a tile kernel's tail streams through: kTailStages stages
// of kTailStageBytes of whole entries (at least one), in the block's
// gradient buffer (tile_buffer_bytes).
constexpr int kTailStages = 2;
constexpr size_t kTailStageBytes = 16 * 1024;

// Entries in a stage of the tail's ring, for rows of `row` bytes.
__host__ __device__ inline int tail_stage_entries(size_t row) {
  return kTailStageBytes >= row ? static_cast<int>(kTailStageBytes / row)
                                : 1;
}

// Bytes of a tile kernel's gradient buffer where its updates are
// `staged`: the tile's updates and the kShortTail entries past it, or the
// tail's ring where that is larger (a tail is streamed where a row is at
// most kThreads wide); else 0.
__host__ __device__ inline size_t tile_buffer_bytes(int tile, int d,
                                                    size_t elem,
                                                    bool staged) {
  if (!staged) return 0;
  const size_t row = static_cast<size_t>(d) * elem;
  const size_t updates = (static_cast<size_t>(tile) + kShortTail) * row;
  const size_t ring =
      d <= kThreads ? kTailStages * tail_stage_entries(row) * row : 0;
  return updates > ring ? updates : ring;
}

// The head of a tile kernel's dynamic shared memory: the mbarriers of the
// tile's copy (bars[0]) and of its tail's ring, where the tail's run ends
// in the list and where its head lies in the tile, and the kernel's own
// scalars (its learning rate, and LazyAdam's bias corrections).
struct TileHeader {
  uint64_t bars[kTailStages];
  int64_t tail_end;
  int tail_head;
  float scalars[3];
};
// The header's bytes: the staged updates start 128-byte aligned, where
// their bulk copies ran fastest (PERF.md).
constexpr size_t kHeaderBytes = 128;
static_assert(sizeof(TileHeader) <= kHeaderBytes, "TileHeader too large");

// The dynamic shared memory of a launch of a tile kernel: its TileHeader,
// its gradient buffer for updates of `elem` bytes an element
// (tile_buffer_bytes), then its tile's rows and the ones around it
// (stage_rows_ahead); raises `kernel`'s limit where that is above 48 KB.
template <typename Kernel>
cudaError_t tile_shared_memory(Kernel kernel, int d, int tile, bool staged,
                               size_t elem, size_t* bytes) {
  *bytes = kHeaderBytes + tile_buffer_bytes(tile, d, elem, staged) +
           (static_cast<size_t>(tile) + 2 + kShortTail) * 4;
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

// Launches the tile kernel `kernel` on `stream` with `args` (of its own
// types): a block a tile of `tile` of the n entries, with the shared
// memory that tile_shared_memory counts for updates of `elem` bytes an
// element. Returns the first CUDA error, else cudaGetLastError().
template <typename... Params, typename... Args>
int launch_tiles(void (*kernel)(Params...), int64_t n, int d, int tile,
                 bool staged, size_t elem, void* stream, Args... args) {
  size_t smem;
  const cudaError_t err =
      tile_shared_memory(kernel, d, tile, staged, elem, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>((n + tile - 1) / tile), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the tile kernel `kernel` (nullptr: cudaErrorInvalidValue)
// resident on one SM with its updates staged, into *blocks.
template <typename... Params>
int tile_blocks_per_sm(void (*kernel)(Params...), int d, int tile,
                       size_t elem, int* blocks) {
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem;
  const cudaError_t err = tile_shared_memory(kernel, d, tile, true, elem,
                                             &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(kernel), kThreads, smem));
}

// Where a tile kernel's staged rows lie in its shared memory `smem`, laid
// out as tile_shared_memory counts it for updates of S.
template <typename S>
__device__ __forceinline__ int32_t* tile_rows(unsigned char* smem, int tile,
                                              int d, bool staged) {
  return reinterpret_cast<int32_t*>(
      smem + kHeaderBytes + tile_buffer_bytes(tile, d, sizeof(S), staged));
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

// Whether tile entry j starts a run of a valid row.
__device__ __forceinline__ bool is_head(const int32_t* rows_s, int j,
                                        int64_t vocab) {
  const int32_t r = rows_s[j + 1];
  return r >= 0 && r < vocab && r != rows_s[j];
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
// Long runs (all four kernels). A run that leaves its tile (kernel 4: its
// chunk) is always the tile's last run, its tail. The block finds the
// tail's end with a search (run_end) and then adds the tail as one known
// span: streamed through shared memory by bulk copies (stream_run), or,
// where the rows cannot be staged or the tail is short, read from global
// memory in a counted loop with several loads in flight (add_span).

// Stages of kernel 4's ring (and mbarriers a kernel holds for one).
constexpr int kRingStages = 4;

// All threads: rows_s[1 + k] = rows[t0 + k] for k in [0, cnt + kShortTail]
// (the tile and kShortTail + 1 entries past it: how far the tile's last
// run goes on), or -1 from `limit` on, and rows_s[0] = rows[t0 - 1], or -1
// (no valid row) at the head of the list. The block syncs before it reads
// rows_s.
__device__ __forceinline__ void stage_rows_ahead(
    int32_t* rows_s, const int32_t* __restrict__ rows, int64_t t0, int cnt,
    int64_t limit) {
  for (int i = threadIdx.x; i <= cnt + 1 + kShortTail; i += kThreads) {
    const int64_t at = t0 - 1 + i;
    rows_s[i] = at >= 0 && at < limit ? rows[at] : -1;
  }
}

// All threads: rows_s[1 + k] = rows[t0 + k] for k in [0, cnt], or -1
// from `limit` on, and rows_s[0] = rows[t0 - 1], or -1 at the head of the
// list; and the tile's change points, a bit an entry: bit j of change_s
// (entry j of the tile, j in [0, cnt]) is set where
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

// The run of row r that tile entry j heads, added to s (and q) in list
// order from `tile_src` (entry k, lane c at tile_src[k * stride + c]),
// as far as the staged rows show it (stage_rows_ahead): a run that ends in
// the tile, or a short tail, which ends within kShortTail entries past it
// (the staged updates hold those too).
template <typename V, typename S, bool kSquares>
__device__ __forceinline__ void tile_run(
    const int32_t* rows_s, int j, int32_t r,
    const typename Store<S, V>::Raw* tile_src, int64_t stride, int c, V& s,
    V& q) {
  using St = Store<S, V>;
  int k = j;
  do {
    const V x = St::load(tile_src[k * stride + c]);
    s = Lane<V>::add(s, x);
    if constexpr (kSquares) q = Lane<V>::add_square(q, x);
    ++k;
  } while (rows_s[k + 1] == r);
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
// (initialised, one arrival); chunk k of a span goes to stage (k + rot) %
// stages. Bit b of `phase` is the parity bars[b] completes next; every
// thread of the block keeps the same bits.
template <typename Raw>
struct Ring {
  Raw* buf;
  uint64_t* bars;
  int stages, stage;
  int rot = 0;
};

// One thread: starts the bulk copy of chunk k of entries [begin, end) of
// `src` (global memory, entries of `width` lanes) into its stage of
// `ring`.
template <typename Raw>
__device__ __forceinline__ void ring_copy(const Ring<Raw>& ring,
                                          const Raw* src, int64_t begin,
                                          int64_t end, int width, int64_t k) {
  const int b = static_cast<int>((k + ring.rot) % ring.stages);
  const int64_t e0 = begin + k * ring.stage;
  const int64_t m = end - e0 < ring.stage ? end - e0 : ring.stage;
  bulk_load(ring.buf + static_cast<int64_t>(b) * ring.stage * width,
            src + e0 * width, static_cast<uint32_t>(m * width * sizeof(Raw)),
            &ring.bars[b]);
}

// All threads of the block: adds lane c of entries [begin, end) of `src`
// (global memory, entry i's lane at src[i * width + c]) to s (and q) in
// list order, in the threads with `active` (thread 0 among them). Thread
// 0 copies the span through the ring (ring_copy; chunks [0, issued)
// are started already), ring.stages bulk copies in flight: a stage is
// refilled once the block has synced after reading it. Entries must be a
// whole number of 16 bytes at a 16-byte-aligned `src`. Ends synced, so the
// ring may be reused.
template <typename V, typename S, bool kSquares, int kAhead = 4,
          int kStride = 0>
__device__ __forceinline__ void stream_run(
    const Ring<typename Store<S, V>::Raw>& ring, uint32_t& phase,
    const typename Store<S, V>::Raw* __restrict__ src, int64_t begin,
    int64_t end, int width, int c, bool active, V& s, V& q,
    int64_t issued = 0) {
  const int64_t total = end - begin;
  const int64_t chunks = (total + ring.stage - 1) / ring.stage;
  if (threadIdx.x == 0)
    for (int64_t k = issued; k < chunks && k < ring.stages; ++k)
      ring_copy(ring, src, begin, end, width, k);
#pragma unroll 1
  for (int64_t k = 0; k < chunks; ++k) {
    const int b = static_cast<int>((k + ring.rot) % ring.stages);
    if (active) {
      const int64_t e0 = k * ring.stage;
      mbarrier_wait(&ring.bars[b], (phase >> b) & 1u);
      add_span<V, S, kSquares, kAhead, kStride>(
          ring.buf + static_cast<int64_t>(b) * ring.stage * width + c,
          total - e0 < ring.stage ? total - e0 : ring.stage, width, s, q);
    }
    phase ^= 1u << b;
    __syncthreads();
    if (threadIdx.x == 0 && k + ring.stages < chunks)
      ring_copy(ring, src, begin, end, width, k + ring.stages);
  }
}

// The row of the run that tile entry j heads, for its group to add and
// apply, or -1: j is past the tile, heads no run of a valid row, or heads
// a long tail (`tail`: the tile's last run goes on for more than
// kShortTail entries past it), which is the block's: its place goes to
// hdr->tail_head.
__device__ __forceinline__ int32_t group_head(TileHeader* hdr,
                                              const int32_t* rows_s, int j,
                                              int cnt, int64_t vocab,
                                              bool tail) {
  if (j >= cnt || !is_head(rows_s, j, vocab)) return -1;
  const int32_t r = rows_s[j + 1];
  if (tail && r == rows_s[cnt]) {
    hdr->tail_head = j;
    return -1;
  }
  return r;
}

// Lane `at` of the array `p` of S, loaded as math lane V; and stored.
template <typename V, typename S>
__device__ __forceinline__ V load_lane(const S* p, int64_t at) {
  using St = Store<S, V>;
  return St::load(reinterpret_cast<const typename St::Raw*>(p)[at]);
}

template <typename V, typename S>
__device__ __forceinline__ void store_lane(S* p, int64_t at, V x) {
  using St = Store<S, V>;
  reinterpret_cast<typename St::Raw*>(p)[at] = St::store(x);
}

// A tile kernel's update of a run's row (update_tile, finish_tail call it
// so; scatter_add.cu, adagrad_update.cu and adam_update.cu define one):
//   kSquares                   whether q, the sum of the run's squares, is
//                              formed beside its total s;
//   State<V>                   the row's state in one math lane V;
//   setup(float* sc)           thread 0, before the block syncs: the
//                              kernel's scalars into TileHeader::scalars;
//   read(const float* sc)      every thread, after: takes them;
//   load<V>(at)                the state of lane `at` (r * d / kFloats + c);
//   store<V>(at, state, s, q)  applies the run's totals and stores once.

// All threads of a tile kernel's block, after its groups, once the tile's
// copy has landed: the long tail of row r (from hdr->tail_head in the tile
// to hdr->tail_end), in scalar lanes, one chain of adds a lane with the
// loads far ahead: the row's state, the tile's part, then the rest,
// streamed through `grad_s` as the tail's ring (its first chunk in stage
// 1, started early where the tile's updates fit in stage 0) or, updates
// not staged or a row wider than kThreads, read from global memory. Then
// one apply and store.
template <typename S, typename Rows>
__device__ __forceinline__ void finish_tail(const Rows& op, TileHeader* hdr,
                                            S* grad_s,
                                            const S* __restrict__ grads,
                                            bool staged, int64_t t0, int cnt,
                                            int tile, int d, int32_t r) {
  constexpr bool kSq = Rows::kSquares;
  // Loads a lane keeps in flight ahead of its adds: 16 took the Criteo
  // list's tails about 1 us faster than 8 (chip_smoke.py --long-runs).
  constexpr int kAhead = 16;
  __syncthreads();  // the tail's head and end are in; grad_s is read
  const int js = hdr->tail_head;
  const int64_t end = hdr->tail_end;
  const bool ring_it = staged && d <= kThreads;
  const Ring<S> ring{grad_s, hdr->bars, kTailStages,
                     tail_stage_entries(static_cast<size_t>(d) * sizeof(S)),
                     1};
  const bool early = ring_it && tile + kShortTail <= ring.stage;
  if (ring_it && threadIdx.x == 0) {
    for (int b = 1; b < kTailStages; ++b) mbarrier_init(&hdr->bars[b]);
    if (early) ring_copy(ring, grads, t0 + cnt, end, d, 0);
  }
  uint32_t phase = 1;  // bars[0] completed the tile's copy
  const S* tile_src = staged ? grad_s : grads + t0 * d;
  for (int c0 = 0; c0 < d; c0 += kThreads) {
    const int c = c0 + static_cast<int>(threadIdx.x);
    const bool active = c < d;
    const int64_t at = static_cast<int64_t>(r) * d + c;
    typename Rows::template State<float> st{};
    float s = 0.f, q = 0.f;
    if (active) {
      st = op.template load<float>(at);
      add_span<float, S, kSq, kAhead>(
          tile_src + static_cast<int64_t>(js) * d + c, cnt - js, d, s, q);
    }
    if (ring_it) {
      __syncthreads();  // the ring overwrites the tile's gradients
      stream_run<float, S, kSq, kAhead>(ring, phase, grads, t0 + cnt, end,
                                        d, c, active, s, q, early ? 1 : 0);
    } else if (active) {
      add_span<float, S, kSq, kAhead>(grads + (t0 + cnt) * d + c,
                                      end - (t0 + cnt), d, s, q);
    }
    if (active) op.template store<float>(at, st, s, q);
  }
}

// The block of a tile kernel: tile blockIdx.x of `tile` entries of the
// list (rows, grads [n, d] of S), each run of a valid row updated once by
// `op` (a Rows) in math lanes V. A group of min(32, d / kFloats) lanes
// serves an entry: it loads the state of up to kBatch heads it owns, only
// then waits for the tile's copy (its latency overlapping the copy's),
// adds each run (tile_run), applies and stores. A long tail is the
// block's (finish_tail), its end found by the last warp while the groups
// work. Shared memory as tile_shared_memory counts it.
template <typename S, typename V, int kBatch, typename Rows>
__device__ __forceinline__ void update_tile(Rows op,
                                            const int32_t* __restrict__ rows,
                                            const S* __restrict__ grads,
                                            int64_t n, int64_t vocab, int d,
                                            int tile, bool staged) {
  using Raw = typename Store<S, V>::Raw;
  extern __shared__ __align__(128) unsigned char smem[];
  TileHeader* hdr = reinterpret_cast<TileHeader*>(smem);
  S* grad_s = reinterpret_cast<S*>(smem + kHeaderBytes);
  int32_t* rows_s = tile_rows<S>(smem, tile, d, staged);
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int cnt = static_cast<int>(n - t0 < tile ? n - t0 : tile);
  const int width = d / Lane<V>::kFloats;

  if (threadIdx.x == 0) {
    if (staged) {  // the tile and the entries past it that a short tail takes
      const int64_t past = n - t0 - cnt < kShortTail ? n - t0 - cnt
                                                      : kShortTail;
      mbarrier_init(&hdr->bars[0]);
      bulk_load(grad_s, grads + t0 * d,
                static_cast<uint32_t>(cnt + past) * d * sizeof(S),
                &hdr->bars[0]);
    }
    op.setup(hdr->scalars);
  }
  stage_rows_ahead(rows_s, rows, t0, cnt, n);
  __syncthreads();

  op.read(hdr->scalars);
  const int32_t last = rows_s[cnt];
  const bool tail = tail_leaves(rows_s, cnt, vocab) &&
                    rows_s[cnt + 1 + kShortTail] == last;
  if (tail && static_cast<int>(threadIdx.x) >= kThreads - 32) {
    const int64_t e = run_end(rows, t0 + cnt, n, last);
    if (threadIdx.x == kThreads - 1) hdr->tail_end = e;
  }
  const Raw* tile_src =
      reinterpret_cast<const Raw*>(staged ? grad_s : grads + t0 * d);
  const Groups g(width);
  bool landed = !staged;
  if (g.active()) {
    for (int c = g.lane; c < width; c += g.lanes) {
      for (int j0 = g.group; j0 < cnt; j0 += g.count * kBatch) {
        int32_t r[kBatch];
        typename Rows::template State<V> held[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          r[b] = group_head(hdr, rows_s, j0 + b * g.count, cnt, vocab, tail);
          held[b] = {};
          if (r[b] >= 0)
            held[b] = op.template load<V>(static_cast<int64_t>(r[b]) * width +
                                          c);
        }
        if (!landed) {
          mbarrier_wait(&hdr->bars[0], 0);
          landed = true;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (r[b] < 0) continue;
          V s = Lane<V>::zero(), q = Lane<V>::zero();
          tile_run<V, S, Rows::kSquares>(rows_s, j0 + b * g.count, r[b],
                                         tile_src, width, c, s, q);
          op.template store<V>(static_cast<int64_t>(r[b]) * width + c,
                               held[b], s, q);
        }
      }
    }
  }
  // No block leaves while its copy is in flight.
  if (!landed) mbarrier_wait(&hdr->bars[0], 0);
  if (tail)
    finish_tail<S>(op, hdr, grad_s, grads, staged, t0, cnt, tile, d, last);
}

}  // namespace sorted_runs
