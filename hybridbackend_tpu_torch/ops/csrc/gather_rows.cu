// Row gather with clipped ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel hybridbackend_tpu/ops/pallas/gather.py:
// gather_rows_pallas (body _gather_kernel). That kernel prefetches the ids
// into SMEM and starts one DMA per row from the HBM-resident table into a
// VMEM block of 128 rows, because a TPU core reaches device memory only
// through DMAs; it needs d % 128 == 0 and the ids padded to whole blocks.
// Here threads read device memory directly, so any n and any d work.
//
// Contract (the TPU kernel's): out[i] = table[clip(ids[i], 0, vocab - 1)].
// An id below 0 reads row 0 and an id at or above vocab reads row vocab-1;
// this differs from the embedding lookup, where invalid ids read zeros.
//   table  [vocab, row_bytes] of any element type, contiguous;
//   ids    int32 or int64 [n];
//   out    [n, row_bytes], contiguous.
//
// Design. The C function picks the widest chunk (16, 8, 4, 2 or 1 bytes)
// that divides a row and the alignment of both pointers: 16-byte chunks
// for f32 rows with d % 4 == 0 from tensors PyTorch allocated. Each thread
// copies one chunk; neighbouring threads copy neighbouring chunks of one
// row, so each row is one coalesced read and one coalesced write. A grid
// stride covers any n.
//
// What bounds it: bytes. It reads n ids and n rows and writes n rows; no
// arithmetic beyond the address. Rows come from random places in the
// table, one d*4-byte segment each (64 bytes at the flagship d = 16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, typename Id>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(T* __restrict__ out, const T* __restrict__ table,
                   const Id* __restrict__ ids, int64_t n, int64_t vocab,
                   int64_t chunks) {
  const int64_t total = n * chunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < total; k += stride) {
    const int64_t i = k / chunks;
    int64_t id = static_cast<int64_t>(ids[i]);
    id = id < 0 ? 0 : (id >= vocab ? vocab - 1 : id);
    out[k] = table[id * chunks + (k - i * chunks)];
  }
}

template <typename T>
void launch_width(void* out, const void* table, const void* ids, int ids_64,
                  int64_t n, int64_t vocab, int64_t row_bytes,
                  cudaStream_t stream) {
  const int64_t chunks = row_bytes / static_cast<int64_t>(sizeof(T));
  const int64_t total = n * chunks;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  if (ids_64) {
    gather_rows_kernel<T, int64_t>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
            static_cast<T*>(out), static_cast<const T*>(table),
            static_cast<const int64_t*>(ids), n, vocab, chunks);
  } else {
    gather_rows_kernel<T, int32_t>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
            static_cast<T*>(out), static_cast<const T*>(table),
            static_cast<const int32_t*>(ids), n, vocab, chunks);
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
// `ids_64` != 0: ids are int64, else int32. Nothing is launched when the
// output is empty.
extern "C" int hb_gather_rows(void* out, const void* table, const void* ids,
                              int ids_64, int64_t n, int64_t vocab,
                              int64_t row_bytes, void* stream) {
  if (n > 0 && row_bytes > 0) {
    const uintptr_t align = reinterpret_cast<uintptr_t>(out) |
                            reinterpret_cast<uintptr_t>(table) |
                            static_cast<uintptr_t>(row_bytes);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (align % 16 == 0) {
      launch_width<uint4>(out, table, ids, ids_64, n, vocab, row_bytes, s);
    } else if (align % 8 == 0) {
      launch_width<uint2>(out, table, ids, ids_64, n, vocab, row_bytes, s);
    } else if (align % 4 == 0) {
      launch_width<uint32_t>(out, table, ids, ids_64, n, vocab, row_bytes, s);
    } else if (align % 2 == 0) {
      launch_width<uint16_t>(out, table, ids, ids_64, n, vocab, row_bytes, s);
    } else {
      launch_width<uint8_t>(out, table, ids, ids_64, n, vocab, row_bytes, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
