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
// write it at once (its contents are never read as valid KV). Page ids
// outside [0, num_pages) are skipped rather than written.
//
// Bound on the H100: bytes. It reads each source page (and scale tile)
// once and writes it once, with no arithmetic, so the floor is
// 2 * bytes / 3.35 TB/s: 8.9 MB and 2.7 us for an int4 chunk of 64 pages
// of the 8B model (int8 17.3 MB, bf16 33.6 MB). What holds it back on the
// card is latency, not bandwidth: a few MB in one pass, so each block's
// loads wait a full trip to memory and its stores another, and an empty
// launch alone (chip_smoke.py's launch floor) reads ~4.7 us.
//
// Design: one pass of 16-byte vectors over a flat list of work items,
// planned on the host (ops/kv_write.py `copy_plan`, from the shapes and
// the SM count): item `it` is chunk c of pool p of page i, or of its scale
// tile, with (i, p, c) from `it` alone. A chunk is at most 16 KB, one
// round of four vectors for each of a block's 256 threads, so all of a
// chunk's loads are in flight at once. Blocks take items b, b + grid, ...
// (one item each at the 8B shapes, up to eight blocks an SM). The loads
// leave before the page id is read: the source address does not depend on
// it. The scale tiles are items of their own, copied beside the page
// bytes rather than after them. A design on Hopper's bulk copies (one
// thread a block issuing cp.async.bulk loads and stores through a ring of
// shared-memory stages on mbarriers, over the same items) was right, but
// slower warm in every format at the 8B page-64 shape and no faster
// flushed (PERF.md §6): a copy this small pays the bulk unit's
// latency twice and gains nothing from freeing the threads. The same code
// serves bf16, int8 and int4 (a packed int4 row is bytes like any other);
// the instantiations differ in their name and their scale items. The
// grouped int4 form (scale groups finer than head_dim: S = K * groups
// channels a row) copies scale tiles [S, page_size], S / K times K7's; its
// instantiation of its own keeps its launches apart in a profile.
// A scale tile that is not whole 16-byte vectors (K * page_size not a
// multiple of 4, e.g. K 2 at page 3) lies at 4-byte offsets in its pool, so
// its items go in 4-byte words, four a thread (at most 4 KB an item).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte vectors a thread keeps in flight
constexpr int kMaxChunk = kThreads * kVecs * 16;
constexpr int kMaxWordChunk = kThreads * kVecs * 4;

enum class KvFmt { kBf16, kInt8, kInt4, kInt4G };

struct Args {
  unsigned char* k_pool;
  unsigned char* v_pool;
  const int32_t* page_table;
  const unsigned char* new_k;
  const unsigned char* new_v;
  unsigned char* ks_pool;  // K7 only
  unsigned char* vs_pool;
  const unsigned char* new_ks;
  const unsigned char* new_vs;
  long long num_pages, page_bytes, tile_bytes;
  unsigned n_items;
  int chunk, page_chunks, tile_chunk, tile_chunks;
  bool tile_words;  // scale tiles in 4-byte words (tile_bytes % 16 != 0)
};

// Item `it` of the plan: which bytes of which source it copies. Mirrored
// by ops/kv_write.py `plan_items`.
struct Item {
  long long i;    // source page
  long long off;  // bytes into the page (or its scale tile)
  int bytes;
  bool scale, v;
};

__device__ __forceinline__ Item item_of(const Args& a, unsigned it) {
  const unsigned per_pair = (unsigned)(a.page_chunks + a.tile_chunks);
  const unsigned pair = it / per_pair;
  const int c = (int)(it - pair * per_pair);
  Item r;
  r.i = pair >> 1;
  r.v = pair & 1;
  r.scale = c >= a.page_chunks;
  const long long whole = r.scale ? a.tile_bytes : a.page_bytes;
  const int size = r.scale ? a.tile_chunk : a.chunk;
  r.off = (long long)(r.scale ? c - a.page_chunks : c) * size;
  r.bytes = (int)(whole - r.off < size ? whole - r.off : size);
  return r;
}

template <KvFmt F>
__global__ void __launch_bounds__(kThreads) paged_kv_write_kernel(const Args a) {
  for (unsigned it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const Item r = item_of(a, it);
    const long long whole = r.scale ? a.tile_bytes : a.page_bytes;
    const unsigned char* src =
        (r.scale ? (r.v ? a.new_vs : a.new_ks) : (r.v ? a.new_v : a.new_k)) + r.i * whole + r.off;
    if (r.scale && a.tile_words) {
      const int nw = r.bytes / 4;
      uint32_t wbuf[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int j = threadIdx.x + u * kThreads;
        if (j < nw) wbuf[u] = ((const uint32_t*)src)[j];
      }
      const int32_t page = a.page_table[r.i];
      if (page < 0 || page >= a.num_pages) continue;
      uint32_t* dst = (uint32_t*)((r.v ? a.vs_pool : a.ks_pool) + (long long)page * whole + r.off);
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int j = threadIdx.x + u * kThreads;
        if (j < nw) dst[j] = wbuf[u];
      }
      continue;
    }
    const int nvec = r.bytes / 16;
    uint4 buf[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int j = threadIdx.x + u * kThreads;
      if (j < nvec) buf[u] = ((const uint4*)src)[j];
    }
    const int32_t page = a.page_table[r.i];
    if (page < 0 || page >= a.num_pages) continue;
    unsigned char* dst =
        (r.scale ? (r.v ? a.vs_pool : a.ks_pool) : (r.v ? a.v_pool : a.k_pool)) +
        (long long)page * whole + r.off;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int j = threadIdx.x + u * kThreads;
      if (j < nvec) ((uint4*)dst)[j] = buf[u];
    }
  }
}

template <KvFmt F>
int launch(void* k_pool, void* v_pool, const void* page_table, const void* new_k,
           const void* new_v, void* ks_pool, void* vs_pool, const void* new_ks,
           const void* new_vs, long long n_pages, long long num_pages, long long page_bytes,
           long long tile_bytes, int chunk, int tile_chunk, int grid, void* stream) {
  if (n_pages <= 0) return 0;
  const bool tile_words = tile_bytes % 16 != 0;
  if (chunk <= 0 || chunk % 16 || chunk > kMaxChunk || grid <= 0 || page_bytes % 16 ||
      tile_bytes % 4 || (tile_bytes && tile_chunk <= 0) ||
      (tile_words ? tile_chunk % 4 || tile_chunk > kMaxWordChunk
                  : tile_chunk % 16 || tile_chunk > kMaxChunk)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.k_pool = (unsigned char*)k_pool;
  a.v_pool = (unsigned char*)v_pool;
  a.page_table = (const int32_t*)page_table;
  a.new_k = (const unsigned char*)new_k;
  a.new_v = (const unsigned char*)new_v;
  a.ks_pool = (unsigned char*)ks_pool;
  a.vs_pool = (unsigned char*)vs_pool;
  a.new_ks = (const unsigned char*)new_ks;
  a.new_vs = (const unsigned char*)new_vs;
  a.num_pages = num_pages;
  a.page_bytes = page_bytes;
  a.tile_bytes = tile_bytes;
  a.chunk = chunk;
  a.page_chunks = (int)((page_bytes + chunk - 1) / chunk);
  a.tile_chunk = tile_bytes ? tile_chunk : chunk;
  a.tile_chunks = (int)((tile_bytes + a.tile_chunk - 1) / a.tile_chunk);
  a.tile_words = tile_words;
  const long long n_items = 2 * n_pages * (a.page_chunks + a.tile_chunks);
  if (n_items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.n_items = (unsigned)n_items;
  paged_kv_write_kernel<F><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. page_bytes a multiple of 16, every pointer 16-byte aligned (the
// Python wrapper checks both); chunk and grid from ops/kv_write.py
// `copy_plan`. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// plan the kernel does not take.
extern "C" int paged_kv_write_launch(
    void* k_pool, void* v_pool, const void* page_table,
    const void* new_k, const void* new_v,
    long long n_pages, long long num_pages, long long page_bytes,
    void* stream, int chunk, int grid) {
  return launch<KvFmt::kBf16>(k_pool, v_pool, page_table, new_k, new_v, nullptr, nullptr,
                              nullptr, nullptr, n_pages, num_pages, page_bytes, 0, chunk, 0,
                              grid, stream);
}

// K7: K1 over int8 pages plus the scale tiles [K, page_size] f32 of each
// page (tile_floats = K * page_size floats, in items of tile_chunk bytes:
// 16-byte vectors when the tile is whole vectors, else 4-byte words), with
// the same rules.
extern "C" int paged_kv_write_q_launch(
    void* k_pool, void* v_pool, const void* page_table,
    const void* new_k, const void* new_v,
    void* ks_pool, void* vs_pool, const void* new_ks, const void* new_vs,
    long long n_pages, long long num_pages, long long page_bytes, int tile_floats,
    void* stream, int chunk, int tile_chunk, int grid) {
  return launch<KvFmt::kInt8>(k_pool, v_pool, page_table, new_k, new_v, ks_pool, vs_pool,
                              new_ks, new_vs, n_pages, num_pages, page_bytes,
                              4LL * tile_floats, chunk, tile_chunk, grid, stream);
}

// K7, int4 form: nibble-packed pages (K*Hd/2 bytes a row) and the same
// scale tiles; the same rules.
extern "C" int paged_kv_write_q4_launch(
    void* k_pool, void* v_pool, const void* page_table,
    const void* new_k, const void* new_v,
    void* ks_pool, void* vs_pool, const void* new_ks, const void* new_vs,
    long long n_pages, long long num_pages, long long page_bytes, int tile_floats,
    void* stream, int chunk, int tile_chunk, int grid) {
  return launch<KvFmt::kInt4>(k_pool, v_pool, page_table, new_k, new_v, ks_pool, vs_pool,
                              new_ks, new_vs, n_pages, num_pages, page_bytes,
                              4LL * tile_floats, chunk, tile_chunk, grid, stream);
}

// K7, grouped int4 form: nibble-packed pages and scale tiles [S, page_size]
// f32 of S = K * groups channels (tile_floats = S * page_size); the same
// rules.
extern "C" int paged_kv_write_q4g_launch(
    void* k_pool, void* v_pool, const void* page_table,
    const void* new_k, const void* new_v,
    void* ks_pool, void* vs_pool, const void* new_ks, const void* new_vs,
    long long n_pages, long long num_pages, long long page_bytes, int tile_floats,
    void* stream, int chunk, int tile_chunk, int grid) {
  return launch<KvFmt::kInt4G>(k_pool, v_pool, page_table, new_k, new_v, ks_pool, vs_pool,
                               new_ks, new_vs, n_pages, num_pages, page_bytes,
                               4LL * tile_floats, chunk, tile_chunk, grid, stream);
}
