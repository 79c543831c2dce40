// K8, K9 and K10: the probe kernels, the TPU prototypes and measurements
// behind the KV page write, the packed int8 pool layout and the paged
// decode's DMA floor.
//
// Replaces (scripts/ of the JAX package):
// - K8  proto_page_write.py, pallas_page_write: bf16 source pages
//   [n, page, kw] copied into two [num_pages, page, kw] pools at table
//   ids, in place (the prototype of K1);
// - K9  probe_bitcast.py, probe_forward / probe_reverse /
//   probe_roundtrip_inject: the int32 <-> int8 bitcast of the packed pool
//   layout (H1: int32 row t holds int8 rows 4t..4t+3 as its little-endian
//   bytes) and the splice of one int8 row into a packed block by shift and
//   mask;
// - K10 probe_bitcast.py, bench_dma, and profile_dma.py, make_bench:
//   scattered pages [page, kw] streamed by a table through an NBUF-deep
//   ring; the result is the sum over pages of sum(row 0) * 0.0 in f32, so
//   0.0, or NaN when a named page's row 0 holds a NaN or an infinity.
//
// Bound on the H100: bytes, for every one; none does arithmetic worth
// counting. K8 reads and writes each page once; K9 reads and writes each
// byte once (inject: one packed row); K10 reads each named page once.
//
// Design. Each is a plain memory kernel, written for Hopper and not
// carried over block by block:
// - K8: one CTA per table entry copies its page of both pools with 16-byte
//   vectors, four loads in flight per thread before their stores. Ids are
//   distinct (the probe builds them so); an id of 0 (the trash page) or
//   outside the pool is skipped, so page 0 is never written.
// - K9: the bitcast is a 4x4 byte transpose. A thread takes four int32
//   words of one packed row (columns c..c+3) and the four 4-byte runs of
//   the four int8 rows they hold, so every load and store is at least
//   4 bytes wide and a warp's accesses are contiguous. The inject gives
//   one thread each word of the packed row it touches: the thread reads,
//   masks and writes its own word, so no two threads race on one.
// - K10: a persistent grid, one CTA per SM; CTA b walks pages b, b + grid,
//   ... of the table. A page can be larger than the ring (an int8
//   [128, 1024] page is 128 KB), so the ring's stages are chunks of a page:
//   NBUF stages in dynamic shared memory, filled with cp.async 16-byte
//   copies, one commit group a stage, and consumed NBUF - 1 groups behind
//   the newest. Chunk 0 of each page holds row 0, which the CTA sums in
//   f32 (warp shuffles, then one thread), times 0.0, into its accumulator;
//   the CTAs combine theirs with one atomicAdd each into the zeroed output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- K8

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;

__global__ void __launch_bounds__(kCopyThreads) page_copy_kernel(
    uint4* __restrict__ k_pool, uint4* __restrict__ v_pool,
    const int32_t* __restrict__ tables,
    const uint4* __restrict__ new_k, const uint4* __restrict__ new_v,
    long long num_pages, long long page_vecs) {
  const long long i = blockIdx.x;
  const int32_t page = tables[i];
  if (page <= 0 || page >= num_pages) return;
  for (int pool = 0; pool < 2; ++pool) {
    const uint4* __restrict__ src = (pool == 0 ? new_k : new_v) + i * page_vecs;
    uint4* __restrict__ dst = (pool == 0 ? k_pool : v_pool) + (long long)page * page_vecs;
    for (long long j = threadIdx.x; j < page_vecs; j += (long long)kCopyThreads * kCopyUnroll) {
      uint4 buf[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const long long jj = j + (long long)u * kCopyThreads;
        if (jj < page_vecs) buf[u] = src[jj];
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const long long jj = j + (long long)u * kCopyThreads;
        if (jj < page_vecs) dst[jj] = buf[u];
      }
    }
  }
}

// ---------------------------------------------------------------- K9

constexpr int kBitcastThreads = 256;

// o[j] byte m = w[m] byte j: the transpose of a 4x4 byte matrix whose rows
// are the four words, little-endian byte 0 first.
__device__ __forceinline__ void transpose4(const uint32_t w[4], uint32_t o[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = ((w[0] >> (8 * j)) & 0xFFu) | (((w[1] >> (8 * j)) & 0xFFu) << 8) |
           (((w[2] >> (8 * j)) & 0xFFu) << 16) | (((w[3] >> (8 * j)) & 0xFFu) << 24);
  }
}

// int32 [t, c] -> int8 [4t, c]; one thread per (packed row, 4 columns).
__global__ void __launch_bounds__(kBitcastThreads) unpack_kernel(
    const uint4* __restrict__ packed, uint32_t* __restrict__ rows, long long t, long long c4) {
  const long long idx = (long long)blockIdx.x * kBitcastThreads + threadIdx.x;
  if (idx >= t * c4) return;
  const long long r = idx / c4, q = idx % c4;
  const uint4 v = packed[idx];
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
  transpose4(w, o);
#pragma unroll
  for (int j = 0; j < 4; ++j) rows[(4 * r + j) * c4 + q] = o[j];
}

// int8 [4t, c] -> int32 [t, c], the inverse; the same transpose.
__global__ void __launch_bounds__(kBitcastThreads) pack_kernel(
    const uint32_t* __restrict__ rows, uint4* __restrict__ packed, long long t, long long c4) {
  const long long idx = (long long)blockIdx.x * kBitcastThreads + threadIdx.x;
  if (idx >= t * c4) return;
  const long long r = idx / c4, q = idx % c4;
  uint32_t w[4], o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = rows[(4 * r + j) * c4 + q];
  transpose4(w, o);
  packed[idx] = make_uint4(o[0], o[1], o[2], o[3]);
}

// int8 row `row` [c] into int8 row `off` of a packed int32 [t4, c] block,
// in place: byte lane off % 4 of packed row off / 4, one thread a word.
__global__ void __launch_bounds__(kBitcastThreads) inject_kernel(
    uint32_t* __restrict__ packed, const uint8_t* __restrict__ row, long long c, long long off) {
  const long long col = (long long)blockIdx.x * kBitcastThreads + threadIdx.x;
  if (col >= c) return;
  const int shift = 8 * (int)(off % 4);
  uint32_t* word = packed + (off / 4) * c + col;
  *word = (*word & ~(0xFFu << shift)) | ((uint32_t)row[col] << shift);
}

__global__ void noop_kernel() {}

// ---------------------------------------------------------------- K10

constexpr int kGatherThreads = 256;
// shared memory the ring may take; a chunk is at most kRingBytes / nbuf
constexpr int kRingBytes = 160 * 1024;

enum Dtype { kInt8 = 0, kInt32 = 1, kBf16 = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
__device__ __forceinline__ float row_elem(const unsigned char* row, int e) {
  if constexpr (D == kInt8) {
    return (float)((const int8_t*)row)[e];
  } else if constexpr (D == kInt32) {
    return (float)((const int32_t*)row)[e];
  } else {
    return __uint_as_float((uint32_t)((const uint16_t*)row)[e] << 16);
  }
}

template <int D, int NBUF>
__global__ void __launch_bounds__(kGatherThreads) page_gather_kernel(
    const unsigned char* __restrict__ pool, const int32_t* __restrict__ tables,
    long long n_pages, long long page_bytes, int chunk_bytes, int chunks_per_page,
    int row_elems, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float warp_sums[kGatherThreads / 32];
  const long long b = blockIdx.x, g = gridDim.x;
  const long long my_pages = n_pages > b ? (n_pages - 1 - b) / g + 1 : 0;
  const long long items = my_pages * chunks_per_page;

  // stage `stage` <- chunk `item` of this CTA's walk; always one commit
  // group, empty past the end, so the group count stays in step
  auto fetch = [&](long long item, int stage) {
    if (item < items) {
      const long long p = b + (item / chunks_per_page) * g;
      const long long chunk = item % chunks_per_page;
      const long long off = chunk * chunk_bytes;
      const long long left = page_bytes - off;
      const int bytes = left < chunk_bytes ? (int)left : chunk_bytes;
      const unsigned char* src = pool + (long long)tables[p] * page_bytes + off;
      unsigned char* dst = ring + (long long)stage * chunk_bytes;
      for (int o = threadIdx.x * 16; o < bytes; o += kGatherThreads * 16) cp_async16(dst + o, src + o);
    }
    cp_async_commit();
  };

  float acc = 0.0f;  // thread 0's
#pragma unroll
  for (int s = 0; s < NBUF; ++s) fetch(s, s);
  for (long long it = 0; it < items; ++it) {
    const int stage = (int)(it % NBUF);
    const bool first = it % chunks_per_page == 0;  // chunk 0 holds row 0
    cp_async_wait<NBUF - 1>();
    __syncthreads();
    if (first) {
      const unsigned char* row = ring + (long long)stage * chunk_bytes;
      float s = 0.0f;
      for (int e = threadIdx.x; e < row_elems; e += kGatherThreads) s += row_elem<D>(row, e);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
    }
    __syncthreads();  // the stage is read and the warp sums are written
    if (first && threadIdx.x == 0) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kGatherThreads / 32; ++w) s += warp_sums[w];
      acc += s * 0.0f;
    }
    fetch(it + NBUF, stage);
  }
  cp_async_wait<0>();
  if (threadIdx.x == 0 && my_pages > 0) atomicAdd(out, acc);
}

template <int D, int NBUF>
int gather_launch(const void* pool, const void* tables, long long n_pages, long long page_bytes,
                  int chunk_bytes, int chunks_per_page, int row_elems, int grid, void* out,
                  cudaStream_t stream) {
  const int smem = NBUF * chunk_bytes;
  auto kern = page_gather_kernel<D, NBUF>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kGatherThreads, smem, stream>>>(
      (const unsigned char*)pool, (const int32_t*)tables, n_pages, page_bytes, chunk_bytes,
      chunks_per_page, row_elems, (float*)out);
  return (int)cudaGetLastError();
}

template <int D>
int gather_dispatch(int nbuf, const void* pool, const void* tables, long long n_pages,
                    long long page_bytes, int chunk_bytes, int chunks_per_page, int row_elems,
                    int grid, void* out, cudaStream_t stream) {
  switch (nbuf) {
    case 2: return gather_launch<D, 2>(pool, tables, n_pages, page_bytes, chunk_bytes, chunks_per_page, row_elems, grid, out, stream);
    case 4: return gather_launch<D, 4>(pool, tables, n_pages, page_bytes, chunk_bytes, chunks_per_page, row_elems, grid, out, stream);
    case 8: return gather_launch<D, 8>(pool, tables, n_pages, page_bytes, chunk_bytes, chunks_per_page, row_elems, grid, out, stream);
    case 16: return gather_launch<D, 16>(pool, tables, n_pages, page_bytes, chunk_bytes, chunks_per_page, row_elems, grid, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K8. page_bytes a multiple of 16, pointers 16-byte aligned (the wrapper
// checks both). Returns cudaGetLastError().
extern "C" int page_copy_launch(void* k_pool, void* v_pool, const void* tables,
                                const void* new_k, const void* new_v, long long n_pages,
                                long long num_pages, long long page_bytes, void* stream) {
  if (n_pages <= 0) return 0;
  page_copy_kernel<<<(unsigned)n_pages, kCopyThreads, 0, (cudaStream_t)stream>>>(
      (uint4*)k_pool, (uint4*)v_pool, (const int32_t*)tables, (const uint4*)new_k,
      (const uint4*)new_v, num_pages, page_bytes / 16);
  return (int)cudaGetLastError();
}

// K9, forward: int32 packed [t, c] -> int8 rows [4t, c]; c % 4 == 0,
// pointers 16-byte aligned.
extern "C" int unpack_int8_rows_launch(const void* packed, void* rows, long long t, long long c,
                                       void* stream) {
  const long long n = t * (c / 4);
  if (n <= 0) return 0;
  unpack_kernel<<<(unsigned)((n + kBitcastThreads - 1) / kBitcastThreads), kBitcastThreads, 0,
                  (cudaStream_t)stream>>>((const uint4*)packed, (uint32_t*)rows, t, c / 4);
  return (int)cudaGetLastError();
}

// K9, reverse: int8 rows [4t, c] -> int32 packed [t, c]; the same rules.
extern "C" int pack_int8_rows_launch(const void* rows, void* packed, long long t, long long c,
                                     void* stream) {
  const long long n = t * (c / 4);
  if (n <= 0) return 0;
  pack_kernel<<<(unsigned)((n + kBitcastThreads - 1) / kBitcastThreads), kBitcastThreads, 0,
                (cudaStream_t)stream>>>((const uint32_t*)rows, (uint4*)packed, t, c / 4);
  return (int)cudaGetLastError();
}

// K9, inject: int8 row [c] into int8 row `off` of packed [t4, c], in place;
// 0 <= off < 4 * t4 (the wrapper checks).
extern "C" int inject_int8_row_launch(void* packed, const void* row, long long c, long long off,
                                      void* stream) {
  if (c <= 0) return 0;
  inject_kernel<<<(unsigned)((c + kBitcastThreads - 1) / kBitcastThreads), kBitcastThreads, 0,
                  (cudaStream_t)stream>>>((uint32_t*)packed, (const uint8_t*)row, c, off);
  return (int)cudaGetLastError();
}

// An empty kernel, one block of one warp: what a CUDA-event timing of
// one launch reads when the launch does no work (the launch floor that
// chip_smoke.py prints beside the kernels' times).
extern "C" int noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// K10. pool [num_pages, page] of `dtype` (0 int8, 1 int32, 2 bf16), page
// bytes a multiple of 16, pointers 16-byte aligned; `out` one zeroed f32;
// nbuf in {2, 4, 8, 16}; `grid` CTAs (one per SM). A page's chunks are
// equal, 16-byte multiples, at most kRingBytes / nbuf; its first chunk
// must hold row 0 (row_bytes). cudaErrorInvalidValue for what it does not
// take.
extern "C" int page_gather_launch(const void* pool, const void* tables, long long n_pages,
                                  long long page_bytes, int row_bytes, int dtype, int nbuf,
                                  int grid, void* out, void* stream) {
  if (n_pages <= 0) return 0;
  if (nbuf <= 0 || grid <= 0 || page_bytes % 16) return (int)cudaErrorInvalidValue;
  const long long max_chunk = (kRingBytes / nbuf) / 16 * 16;
  const long long chunks = (page_bytes + max_chunk - 1) / max_chunk;
  const long long chunk = ((page_bytes + chunks - 1) / chunks + 15) / 16 * 16;
  if (row_bytes > chunk) return (int)cudaErrorInvalidValue;
  const int elem = dtype == kInt8 ? 1 : dtype == kInt32 ? 4 : 2;
  const int row_elems = row_bytes / elem;
  if (grid > n_pages) grid = (int)n_pages;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kInt8: return gather_dispatch<kInt8>(nbuf, pool, tables, n_pages, page_bytes, (int)chunk, (int)chunks, row_elems, grid, out, s);
    case kInt32: return gather_dispatch<kInt32>(nbuf, pool, tables, n_pages, page_bytes, (int)chunk, (int)chunks, row_elems, grid, out, s);
    case kBf16: return gather_dispatch<kBf16>(nbuf, pool, tables, n_pages, page_bytes, (int)chunk, (int)chunks, row_elems, grid, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
