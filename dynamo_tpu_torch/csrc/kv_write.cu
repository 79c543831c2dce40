// K1 and K7: paged KV write, the prefill-side page scatter.
//
// Replaces: dynamo_tpu/ops/pallas_kv_write.py, paged_kv_write / _kernel
// (K1, the bf16 branch) and _kernel_q (K7, the quantized branch, in its
// int8 and int4 forms). For each source page i of a prefill chunk it
// copies new_k[i] and new_v[i] ([page_size, row bytes]) into pool page
// page_table[i], in place; K7 also copies the page's scale tiles new_ks[i]
// and new_vs[i] ([K, page_size] f32) into scale-pool page page_table[i],
// routed by the same table. Page 0 is the trash page: padding pages of a
// dispatch all land there, rows and scales alike, so several blocks may
// write it at once (its contents are never read as valid KV).
//
// Bound on the H100: bytes. It reads each source page (and scale tile)
// once and writes it once, with no arithmetic, so the floor is
// 2 * bytes / 3.35 TB/s. An int8 page is half a bf16 page and an int4
// page (two codes a byte, K*Hd/2 bytes a row) a quarter; the scale tiles
// add 2 * K * page_size * 4 bytes (4 KB a page at the 8B shape) to both.
//
// Design: the copy is dtype-blind (16-byte vectors), one block per
// (page, K-or-V, slice of the page). A bf16 page of the 8B model is
// 128 KB; it is cut into 16 KB slices so a 64-page chunk launches 1024
// blocks and every SM has loads in flight (an int4 page of 32 KB is two
// slices). Each thread moves four 16-byte vectors per step, loads first,
// so four requests are outstanding per thread. K7 is the same kernel
// instantiated for a quantized format: the slice-0 block of each page and
// pool also copies that page's scale tile (a few KB, one float a thread
// per step). Its int8 and int4 instantiations run the same code: a packed
// int4 row is bytes like any other. Page ids outside [0, num_pages) are
// skipped rather than written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kSliceBytes = 16384;

enum class KvFmt { kBf16, kInt8, kInt4 };

template <KvFmt F>
__global__ void __launch_bounds__(kThreads) paged_kv_write_kernel(
    uint4* __restrict__ k_pool, uint4* __restrict__ v_pool,
    const int32_t* __restrict__ page_table,
    const uint4* __restrict__ new_k, const uint4* __restrict__ new_v,
    float* __restrict__ ks_pool, float* __restrict__ vs_pool,      // K7 only
    const float* __restrict__ new_ks, const float* __restrict__ new_vs,
    long long num_pages, long long page_vecs, long long slice_vecs, int tile_floats) {
  constexpr bool kQuant = F != KvFmt::kBf16;
  const long long i = blockIdx.x;
  const int32_t page = page_table[i];
  if (page < 0 || page >= num_pages) return;
  const uint4* __restrict__ src = (blockIdx.y == 0 ? new_k : new_v) + i * page_vecs;
  uint4* __restrict__ dst = (blockIdx.y == 0 ? k_pool : v_pool) + (long long)page * page_vecs;
  const long long lo = (long long)blockIdx.z * slice_vecs;
  const long long hi = lo + slice_vecs < page_vecs ? lo + slice_vecs : page_vecs;
  for (long long j = lo + threadIdx.x; j < hi; j += (long long)kThreads * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long jj = j + (long long)u * kThreads;
      if (jj < hi) buf[u] = src[jj];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long jj = j + (long long)u * kThreads;
      if (jj < hi) dst[jj] = buf[u];
    }
  }
  if constexpr (kQuant) {
    if (blockIdx.z == 0) {
      const float* __restrict__ ssrc = (blockIdx.y == 0 ? new_ks : new_vs) + i * tile_floats;
      float* __restrict__ sdst = (blockIdx.y == 0 ? ks_pool : vs_pool) + (long long)page * tile_floats;
      for (int j = threadIdx.x; j < tile_floats; j += kThreads) sdst[j] = ssrc[j];
    }
  }
}

template <KvFmt F>
int launch(void* k_pool, void* v_pool, const void* page_table, const void* new_k,
           const void* new_v, void* ks_pool, void* vs_pool, const void* new_ks,
           const void* new_vs, long long n_pages, long long num_pages,
           long long page_bytes, int tile_floats, void* stream) {
  if (n_pages <= 0) return 0;
  const long long page_vecs = page_bytes / 16;
  long long slices = (page_bytes + kSliceBytes - 1) / kSliceBytes;
  if (slices < 1) slices = 1;
  const long long slice_vecs = (page_vecs + slices - 1) / slices;
  dim3 grid((unsigned)n_pages, 2, (unsigned)slices);
  paged_kv_write_kernel<F><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint4*)k_pool, (uint4*)v_pool, (const int32_t*)page_table,
      (const uint4*)new_k, (const uint4*)new_v, (float*)ks_pool, (float*)vs_pool,
      (const float*)new_ks, (const float*)new_vs,
      num_pages, page_vecs, slice_vecs, tile_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. page_bytes must be a multiple of 16 and every pointer 16-byte aligned
// (the Python wrapper checks both). Returns cudaGetLastError().
extern "C" int paged_kv_write_launch(
    void* k_pool, void* v_pool, const void* page_table,
    const void* new_k, const void* new_v,
    long long n_pages, long long num_pages, long long page_bytes,
    void* stream) {
  return launch<KvFmt::kBf16>(k_pool, v_pool, page_table, new_k, new_v, nullptr, nullptr,
                       nullptr, nullptr, n_pages, num_pages, page_bytes, 0, stream);
}

// K7: K1 over int8 pages plus the scale tiles [K, page_size] f32 of each
// page (tile_floats = K * page_size), with the same alignment rules.
extern "C" int paged_kv_write_q_launch(
    void* k_pool, void* v_pool, const void* page_table,
    const void* new_k, const void* new_v,
    void* ks_pool, void* vs_pool, const void* new_ks, const void* new_vs,
    long long n_pages, long long num_pages, long long page_bytes, int tile_floats,
    void* stream) {
  return launch<KvFmt::kInt8>(k_pool, v_pool, page_table, new_k, new_v, ks_pool, vs_pool,
                              new_ks, new_vs, n_pages, num_pages, page_bytes, tile_floats, stream);
}

// K7, int4 form: nibble-packed pages (K*Hd/2 bytes a row) and the same
// scale tiles; the same alignment rules.
extern "C" int paged_kv_write_q4_launch(
    void* k_pool, void* v_pool, const void* page_table,
    const void* new_k, const void* new_v,
    void* ks_pool, void* vs_pool, const void* new_ks, const void* new_vs,
    long long n_pages, long long num_pages, long long page_bytes, int tile_floats,
    void* stream) {
  return launch<KvFmt::kInt4>(k_pool, v_pool, page_table, new_k, new_v, ks_pool, vs_pool,
                              new_ks, new_vs, n_pages, num_pages, page_bytes, tile_floats, stream);
}
