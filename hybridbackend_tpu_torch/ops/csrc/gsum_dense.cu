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
// updates into shared memory, all threads stage its rows and a bit for
// each change of row (a run's extent is then a search for the next bit),
// heads are found there, and a group of min(32, d/4) lanes of 16 bytes per
// entry sums each run of at most kLongRun entries from shared memory,
// stores the total straight to the row in global memory and sets the
// row's flag. A longer run goes to a group of scalar lanes after the short
// ones, the groups side by side: one chain of adds a lane with its loads
// ahead of it, where a 4-element lane keeps four chains and waits on them.
// A run never spans two blocks, since a block owns whole rows, but it may
// span many chunks: a column of a few rows takes a zipf column's hot ids,
// runs of hundreds to thousands (phase 36's list: the adapter's backward).
// The chunk's last run, if it goes on past the chunk (its tail), is the
// block's: the last warp finds the run's end while the chunk's copy lands
// (run_end), a scalar group adds the chunk's part beside the long runs,
// the rest streams through twice a chunk's buffer, a ring of four stages
// (stream_run; a tail of a few entries, or rows not staged, is read from
// global memory in a counted loop), the total is stored, and the walk
// resumes at the run's end, so no chunk inside a run is copied or
// scanned. At phase 36's list (106496 entries on [1279569, 16], runs up
// to 1638) this took the kernel from 1.03 ms (run_total's walk, a
// dependent global load an entry) to about 0.067, against 0.030 for the
// same output with no entry at all and 0.052 for zeros + index_add_
// (chip_smoke.py --long-runs, NVIDIA H100 80GB HBM3, 700 W): the hot
// blocks' adds, one chain an element at several cycles an entry, and
// their chunks' steps, one after another, are what is left. Last, the block
// stores zeros to every row without a flag, neighbouring threads on
// neighbouring 16 bytes. The order matters: the sums wait on memory and the
// zeros do not, so the zeros come last, where one block's stores drain
// while its neighbours on the SM still wait. (Composing the block's range
// in shared memory first and writing it with one bulk copy or with plain
// stores was built and measured too: slower at every block size, and
// limited to rows that fit shared memory.) A d that 4 does not divide, or
// an address that 16 does not divide, takes the scalar lanes and reads the
// updates from global memory in the same kernel; d = 16 has a kernel of
// its own (kD), its loads at fixed offsets. The wrapper picks block_rows so
// that the blocks come to whole rounds of the card's SMs, at least one, so
// that a small table (a dense Trainer's [100000, 16]) fills the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

// Shared memory: kRingStages mbarriers, the slice's bounds, the end of a
// tail, the head of its run and the count of long runs (64 bytes), the
// staged updates (2 * chunk * d * 4 bytes, when `staged`: a chunk, and
// all of it the ring of a long tail), chunk + 2 rows, the chunk's change
// points (chunk / 32 + 2 words), its long runs' heads (long_slots), the
// tail's partial sums (kThreads floats), then block_rows flags.
constexpr size_t kHeader = 64;

// A run in a chunk longer than this is added by a group of scalar lanes
// after the short ones: one chain of adds a lane, every lane's loads ahead
// of its adds, where a group of 4-element lanes keeps four chains in a
// lane and waits on its loads.
constexpr int kLongRun = 16;
// Loads in flight per scalar lane of a long run: enough that a lane's
// adds do not wait on shared memory.
constexpr int kAhead = 8;

__host__ __device__ constexpr int long_slots(int chunk) {
  return chunk / kLongRun + 1;
}

// kD, where nonzero, is d known at compile time (the flagship's 16), so
// that every load of a run's sum is at a fixed offset. Three blocks an SM
// stay resident, as the blocking rule needs (gsum_blocking).
template <typename V, int kD>
__global__ void __launch_bounds__(kThreads, 3)
gsum_dense_sorted_kernel(float* __restrict__ out,
                         const int32_t* __restrict__ rows,
                         const float* __restrict__ updates, int64_t n,
                         int64_t vocab, int d_arg, int block_rows, int chunk,
                         int staged) {
  const int d = kD ? kD : d_arg;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int64_t* bounds = reinterpret_cast<int64_t*>(smem + 32);  // lo, hi, end
  int* tail_head = reinterpret_cast<int*>(smem + 56);
  int* long_count = reinterpret_cast<int*>(smem + 60);
  float* upd_s = reinterpret_cast<float*>(smem + kHeader);
  int32_t* rows_s = reinterpret_cast<int32_t*>(
      smem + kHeader + (staged ? 2 * static_cast<size_t>(chunk) * d * 4 : 0));
  uint32_t* change_s = reinterpret_cast<uint32_t*>(rows_s + chunk + 2);
  int* long_s = reinterpret_cast<int*>(change_s + chunk / 32 + 2);
  float* tail_part = reinterpret_cast<float*>(long_s + long_slots(chunk));
  unsigned char* has_run = reinterpret_cast<unsigned char*>(tail_part +
                                                            kThreads);

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * block_rows;
  const int nr = static_cast<int>(vocab - r0 < block_rows ? vocab - r0
                                                          : block_rows);
  const int width = d / Lane<V>::kFloats;   // lanes of V in a row
  V* rows_out = reinterpret_cast<V*>(out) + r0 * width;
  float* row0 = out + r0 * d;
  // A tail streams through twice a chunk: the walk takes chunks that
  // land soon, the ring keeps more bytes in flight.
  const int stages = 2 * chunk < kRingStages ? 2 * chunk : kRingStages;
  const Ring<float> ring{upd_s, bars, stages, 2 * chunk / stages};

  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t at = lower_bound_warp(rows, n, warp == 0 ? r0 : r0 + nr);
    if ((threadIdx.x & 31) == 0) bounds[warp] = at;
    if (threadIdx.x == 0) {
      *long_count = 0;
      if (staged)
        for (int b = 0; b < stages; ++b) mbarrier_init(&bars[b]);
    }
  } else {
    for (int i = threadIdx.x - 64; i < nr; i += kThreads - 64) has_run[i] = 0;
  }
  __syncthreads();

  const int64_t lo = bounds[0], hi = bounds[1];
  const Groups g(width), sg(d);
  uint32_t phase = 0;
  float unused1 = 0.f;
  int64_t base = lo;
  while (base < hi) {
    const int cnt = static_cast<int>(hi - base < chunk ? hi - base : chunk);
    if (staged && threadIdx.x == 0)
      bulk_load(upd_s, updates + base * d, static_cast<uint32_t>(cnt) * d * 4,
                &bars[0]);
    stage_rows_runs(rows_s, change_s, rows, base, cnt, hi);
    __syncthreads();
    // The chunk's last run going on past the chunk is the block's: the last
    // warp finds its end while the copy lands.
    const int32_t last = rows_s[cnt];
    const bool tail = tail_leaves(rows_s, cnt, vocab);
    if (tail && warp == kThreads / 32 - 1) {
      const int64_t e = run_end(rows, base + cnt, hi, last);
      if ((threadIdx.x & 31) == 0) bounds[2] = e;
    }
    if (staged) {
      mbarrier_wait(&bars[0], phase & 1u);
      phase ^= 1u;
    }
    const V* chunk_src = staged ? reinterpret_cast<const V*>(upd_s)
                                : reinterpret_cast<const V*>(updates) +
                                      base * width;
    // Element c of the sum of the chunk's entries [j, j + m), in scalar
    // lanes: from shared memory in its own branch, so that the loads are
    // shared-memory loads.
    const auto chunk_sum = [&](int j, int m, int c) {
      float s = 0.f;
      if (staged)
        add_span<float, float, false, kAhead, kD>(
            upd_s + static_cast<int64_t>(j) * d + c, m, d, s, unused1);
      else
        add_span<float, float, false, kAhead, kD>(
            updates + (base + j) * d + c, m, d, s, unused1);
      return s;
    };
    // Short runs: a group of 4-element lanes each, stored at once.
    if (g.active()) {
      for (int j = g.group; j < cnt; j += g.count) {
        if (!is_head(rows_s, j, vocab)) continue;
        const int32_t r = rows_s[j + 1];
        const int k = next_change(change_s, j, cnt);
        if (k > cnt) {  // the tail
          if (g.lane == 0) *tail_head = j;
          continue;
        }
        if (k - j > kLongRun) {
          if (g.lane == 0) long_s[atomicAdd(long_count, 1)] = j;
          continue;
        }
        if (g.lane == 0) has_run[r - r0] = 1;
        for (int c = g.lane; c < width; c += g.lanes) {
          V s = Lane<V>::zero();
          for (int i = j; i < k; ++i)
            s = Lane<V>::add(s, chunk_src[i * width + c]);
          rows_out[(r - r0) * width + c] = s;
        }
      }
    }
    __syncthreads();  // the long runs, the tail's head and end are in
    // Long runs, a group of scalar lanes each, the groups side by side;
    // beside them the tail's part in the chunk, into tail_part (a row of at
    // most kThreads lanes; a wider tail sums its part in the loop below).
    const int longs = *long_count, js = *tail_head;
    const bool split = tail && d <= kThreads;
    if (longs + split > 0 && sg.active()) {
      for (int i = sg.group; i < longs + split; i += sg.count) {
        if (i == longs) {
          for (int c = sg.lane; c < d; c += sg.lanes)
            tail_part[c] = chunk_sum(js, cnt - js, c);
          continue;
        }
        const int j = long_s[i];
        const int32_t r = rows_s[j + 1];
        const int k = next_change(change_s, j, cnt);
        if (sg.lane == 0) has_run[r - r0] = 1;
        for (int c = sg.lane; c < d; c += sg.lanes)
          row0[(r - r0) * d + c] = chunk_sum(j, k - j, c);
      }
    }
    if (!tail) {
      if (longs > 0) {
        __syncthreads();  // the next chunk overwrites rows_s and upd_s
        if (threadIdx.x == 0) *long_count = 0;
      }
      base += cnt;
      continue;
    }
    // The rest of the tail, in scalar lanes, from base + cnt to the run's
    // end: streamed through the chunk's buffer or, if short or not staged,
    // read from global memory.
    const int64_t end = bounds[2], rest = end - (base + cnt);
    const bool ring_it = staged && d <= kThreads && rest > kShortTail;
    __syncthreads();  // tail_part is in; the ring overwrites upd_s
    for (int c0 = 0; c0 < d; c0 += kThreads) {
      const int c = c0 + static_cast<int>(threadIdx.x);
      const bool active = c < d;
      float s = !active ? 0.f : split ? tail_part[c] : chunk_sum(js, cnt - js,
                                                                 c);
      if (ring_it)
        stream_run<float, float, false, kAhead, kD>(
            ring, phase, updates, base + cnt, end, d, c, active, s, unused1);
      else if (active)
        add_span<float, float, false, kAhead, kD>(
            updates + (base + cnt) * d + c, rest, d, s, unused1);
      if (active) row0[(last - r0) * d + c] = s;
    }
    if (threadIdx.x == 0) has_run[last - r0] = 1;
    __syncthreads();  // the next chunk overwrites rows_s and upd_s
    if (threadIdx.x == 0) *long_count = 0;
    base = end;
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

template <typename V, int kD = 0>
int launch(float* out, const int32_t* rows, const float* updates, int64_t n,
           int64_t vocab, int d, int block_rows, int chunk, bool staged,
           cudaStream_t stream) {
  const size_t smem = kHeader +
                      (staged ? 2 * static_cast<size_t>(chunk) * d * 4 : 0) +
                      (static_cast<size_t>(chunk) + 2) * 4 +
                      (static_cast<size_t>(chunk) / 32 + 2) * 4 +
                      static_cast<size_t>(long_slots(chunk)) * 4 +
                      kThreads * 4 + block_rows;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gsum_dense_sorted_kernel<V, kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (vocab + block_rows - 1) / block_rows;
  gsum_dense_sorted_kernel<V, kD>
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
      quads && 2 * static_cast<size_t>(chunk) * d * 4 <= kMaxStageBytes;
  float* o = static_cast<float*>(out);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* u = static_cast<const float*>(updates);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quads && aligned16(out))
    return d == 16 ? launch<float4, 16>(o, r, u, n, vocab, d, block_rows,
                                        chunk, staged, s)
                   : launch<float4>(o, r, u, n, vocab, d, block_rows, chunk,
                                    staged, s);
  return launch<float>(o, r, u, n, vocab, d, block_rows, chunk, staged, s);
}
