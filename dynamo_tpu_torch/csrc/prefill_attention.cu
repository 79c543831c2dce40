// K2 and K6: causal chunked-prefill flash attention read in place from the
// paged KV pool.
//
// Replaces: dynamo_tpu/ops/pallas_prefill.py, flash_prefill_attention /
// _kernel, its bf16 branch (K2) and its int8 and int4 branches (K6). Row b's queries
// sit at absolute positions pos0[b] .. pos0[b] + t_valid[b] - 1 and attend
// keys with k_pos <= q_pos through the row's block table; rows at or past
// t_valid are 0. q arrives with rope applied and unscaled. K4
// (ragged_paged_attention, ops/decode_attention.py) launches the same
// kernel with per-row query lengths as t_valid and pos0 mid-page.
//
// K6 reads int8 pools with f32 scale pools [num_pages, K, page_size]
// (ops/quant.py layout), or nibble-packed int4 pools (K*Hd/2 bytes a row,
// ops/quant.py planar layout: a head's byte j holds feature j in its low
// nibble, ((b & 15) ^ 8) - 8, and feature j + Hd/2 in its high one, b >> 4
// of the signed byte). As in the reference the rows are never dequantized:
// the K scale multiplies the score, the V scale the probability ((p * vs)
// . v_codes == p . dequant(v)), and the denominator sums the unscaled
// probabilities.
//
// K6's grouped int4 form reads int4 pools whose scale pools carry S = K *
// groups channels [num_pages, S, page_size] (scale groups of `group`
// features, a power of two from 8 to Hd / 2). A scale that varies across a
// head's features cannot be folded into the score or the probability, so
// this form does what the reference's gather path does there
// (dynamo_tpu/ops/attention.py paged_attention over
// dequantize_kv_rows_int4 rows): each code times its group's scale in
// f32, rounded once to bf16, is the operand; the products are then K2's
// (scores scaled in f32, probabilities split in two bf16 terms). A packed
// byte's two nibbles are features j and j + Hd/2, so they may lie in
// different groups: each half of a row takes its own group's scale. The
// block's scales are staged beside its codes, one 4-byte copy each. Bound:
// as K6's int4 form (the products and the row reads), the widening pass
// now a multiply and a rounding an element.
//
// Bound on the H100: at the engine's shapes (chunks of 512 over a prompt)
// its ~2 * 2 * B * H * Hd * T * T / 2 FLOPs at the bf16 tensor-core rate
// take about as long as one read of q/K/V and one write of the output
// (Llama-3.1-8B's [8, 512] chunk: 0.022 ms against 0.026), so both bound
// it; the split P . V adds half the FLOPs again.
//
// Design. Both products run on the tensor cores, mma.sync m16n8k16 bf16 ->
// f32 on ldmatrix fragments. One block per (query tile, kv head,
// sequence), the last query tiles launched first (they walk the most
// keys). The tile holds 64 query rows: 64 / G positions times the G query
// heads that share the kv head, so each staged key serves all of them
// (GQA). Four warps own 16 rows each (one m16 tile); each loads its q rows
// once, unscaled, as bf16 A fragments kept in registers.
//   Gather: keys come in blocks of 64 up to the tile's causal limit (blocks
// above it are never loaded), copied through the block table by 16-byte
// cp.async into a ring of two stages, block j + 1 in flight while block j
// computes; keys past the limit are zero-filled. Up to 8 threads share a
// key's row, so a warp's copy reads whole 128-byte lines; each thread reads
// its keys' page ids a block ahead, so no copy waits on a table lookup.
// bf16 rows land in the operand tiles themselves; int8/int4 codes land in a
// raw stage with each key's two scales and are widened to bf16 once per
// block, exactly and without integer-to-float conversions (|code| <= 127).
// Operand rows are padded by 16 bytes, so ldmatrix is free of bank
// conflicts.
//   Scores: S = q . K on the tensor cores (products of bf16 are exact in
// f32), then times hd**-0.5 * log2(e) (times the key's K scale) in f32,
// masked by absolute position. The online softmax lives in the C
// fragments, in log2 units (ex2): a row's max is taken within the quad of
// lanes holding it (shfl_xor 1 and 2) once a block, the f32 output
// accumulators (Hd/2 per thread) are rescaled in registers, and each thread
// keeps a partial denominator of the unrounded f32 probabilities, summed
// over the quad at the end.
//   P . V: two adjacent n8 score tiles are one k16 A fragment, with no
// shared-memory round trip. A probability rounded once to bf16 would move
// outputs by more than one bf16 ulp, so x = p (x = p * v_scale for
// int8/int4) goes in as two bf16 terms, hi = bf16(x) and lo = bf16(x -
// hi), both multiplied by the same V fragments (ldmatrix.trans): x is
// carried to ~2**-17 of itself, at 1.5x the unsplit tensor-core work.
// Masking by absolute position also hides the garbage tail rows the
// page-scatter write leaves past t_valid in a chunk's last page. The
// output is normalized in f32, staged in shared memory as bf16 and
// stored with 16-byte writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // query rows of a tile
constexpr int kKeys = 64;     // keys of a block
constexpr int kWarps = 4;     // each owns 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements (16 bytes) of padding per operand row
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

enum class KvFmt { kBf16, kInt8, kInt4, kInt4G };

// bytes of one kv head's row in the pool
template <int HD, KvFmt F>
__host__ __device__ constexpr int row_bytes() {
  return F == KvFmt::kBf16 ? 2 * HD : F == KvFmt::kInt8 ? HD : HD / 2;
}

// Shared memory: for bf16 pools, two stages each holding a K and a V
// operand tile; for int8/int4, two bf16 operand tiles, then two stages each
// holding the raw K and V codes and the block's K and V scales (kScales a
// key: one, or up to Hd / 8 groups for the grouped form). The q tile
// (before the key loop) and the output tile (after it) borrow an operand
// tile that is not yet or no longer in use.
template <int HD, KvFmt F>
struct Smem {
  static constexpr bool kQuant = F != KvFmt::kBf16;
  static constexpr int kScales = F == KvFmt::kInt4G ? HD / 8 : 1;  // scales a key, at most
  static constexpr int kStride = HD + kPad;                   // operand row, bf16 elements
  static constexpr int kTile = kKeys * kStride * 2;           // operand tile, bytes
  static constexpr int kRaw = kKeys * row_bytes<HD, F>();     // raw K or V block, bytes
  static constexpr int kOps = kQuant ? 2 * kTile : 0;
  static constexpr int kStage = kQuant ? 2 * kRaw + 2 * kKeys * 4 * kScales : 2 * kTile;
  static constexpr size_t kBytes = (size_t)kOps + 2 * (size_t)kStage;
  static_assert(kRows * kStride * 2 <= kTile, "q and output tiles fit an operand tile");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2**x (ex2.approx: ~2**-22 relative; 0 for the masked scores' -huge)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair (x in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo: the bf16 pair nearest (x, y), and the pair nearest what it left
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// 16 int8 codes -> 16 bf16 at dst, exact: byte c ^ 0x80 = c + 128 is put in
// the low mantissa bits of 2**23, and 2**23 + 128 taken off in f32 (no
// integer-to-float conversion, which runs at a quarter of the f32 rate)
__device__ __forceinline__ void widen16(const uint4& raw, __nv_bfloat16* dst) {
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = in[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | e)) - 8388736.f;
    w[2 * i] = pack_bf16(f[0], f[1]);
    w[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// 16 packed int4 bytes -> their 16 low nibbles at lo, the 16 high ones at
// hi, exact: nibble n ^ 8 = code + 8 is put in the low mantissa bits of the
// bf16 128, and 136 taken off in bf16
__device__ __forceinline__ void widen16_nib(const uint4& raw, __nv_bfloat16* lo,
                                            __nv_bfloat16* hi) {
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t wl[8], wh[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = in[i] ^ 0x88888888u;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // bytes 2e and 2e + 1 of the word in the two 16-bit lanes
      const uint32_t pair = __byte_perm(u, 0, 0x4140 + 0x202 * e);
      uint32_t l = (pair & 0x000F000Fu) | 0x43004300u;
      uint32_t h = ((pair >> 4) & 0x000F000Fu) | 0x43004300u;
      __nv_bfloat162 lv = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&l), off);
      __nv_bfloat162 hv = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&h), off);
      wl[2 * i + e] = *reinterpret_cast<uint32_t*>(&lv);
      wh[2 * i + e] = *reinterpret_cast<uint32_t*>(&hv);
    }
  }
  reinterpret_cast<uint4*>(lo)[0] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
  reinterpret_cast<uint4*>(lo)[1] = make_uint4(wl[4], wl[5], wl[6], wl[7]);
  reinterpret_cast<uint4*>(hi)[0] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
  reinterpret_cast<uint4*>(hi)[1] = make_uint4(wh[4], wh[5], wh[6], wh[7]);
}

// 16 packed int4 bytes -> their 16 low nibbles times their groups' scales at
// lo, the 16 high ones at hi, each product in f32 rounded once to bf16 (the
// reference's dequantization to the working type). sc: the key's scales
// (one a group), f_lo / f_hi: the features of the first low / high nibble,
// 1 << gshift: a group's features (>= 8, so four consecutive features
// share a scale). Codes as in widen16: nibble n ^ 8 = code + 8 in the low
// mantissa bits of 2**23, and 2**23 + 8 taken off in f32, exactly.
__device__ __forceinline__ void widen16_nib_g(const uint4& raw, __nv_bfloat16* lo,
                                              __nv_bfloat16* hi, const float* sc, int f_lo,
                                              int f_hi, int gshift) {
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t wl[8], wh[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = in[i] ^ 0x88888888u;
    float l[4], h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t byte = (u >> (8 * e)) & 0xFFu;
      l[e] = __int_as_float(0x4B000000u | (byte & 15u)) - 8388616.f;
      h[e] = __int_as_float(0x4B000000u | (byte >> 4)) - 8388616.f;
    }
    const float sl = sc[(f_lo + 4 * i) >> gshift];
    const float sh = sc[(f_hi + 4 * i) >> gshift];
    wl[2 * i] = pack_bf16(__fmul_rn(l[0], sl), __fmul_rn(l[1], sl));
    wl[2 * i + 1] = pack_bf16(__fmul_rn(l[2], sl), __fmul_rn(l[3], sl));
    wh[2 * i] = pack_bf16(__fmul_rn(h[0], sh), __fmul_rn(h[1], sh));
    wh[2 * i + 1] = pack_bf16(__fmul_rn(h[2], sh), __fmul_rn(h[3], sh));
  }
  reinterpret_cast<uint4*>(lo)[0] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
  reinterpret_cast<uint4*>(lo)[1] = make_uint4(wl[4], wl[5], wl[6], wl[7]);
  reinterpret_cast<uint4*>(hi)[0] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
  reinterpret_cast<uint4*>(hi)[1] = make_uint4(wh[4], wh[5], wh[6], wh[7]);
}

// The minimum of one block an SM is stated: without it ptxas holds the bf16
// Hd 128 form to 199 registers instead of 222, and that form was slower
// (PERF.md §6); smem and 222 registers still fit two blocks an SM.
template <int HD, KvFmt F>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, T, H, HD]
    const int8_t* __restrict__ k_pool,         // [slots, K * row_bytes] (bytes of any format)
    const int8_t* __restrict__ v_pool,
    const float* __restrict__ ks_pool,         // [num_pages, S, page_size] (K6; S = K, or
                                               // K * groups in the grouped form)
    const float* __restrict__ vs_pool,
    const int32_t* __restrict__ tables,        // [B, W]
    const int32_t* __restrict__ pos0,          // [B]
    const int32_t* __restrict__ t_valid,       // [B]
    __nv_bfloat16* __restrict__ out,           // [B, T, H, HD]
    int T, int H, int K, int W, int page_size, float scale,
    int gshift) {  // grouped form: a scale group is 1 << gshift features
  using S = Smem<HD, F>;
  constexpr bool kQuant = S::kQuant;
  constexpr bool kGrouped = F == KvFmt::kInt4G;
  constexpr bool kFold = kQuant && !kGrouped;  // scales folded into scores and probabilities
  const int gph = kGrouped ? HD >> gshift : 1;  // scale groups a kv head
  constexpr int RB = row_bytes<HD, F>();
  constexpr int VPR = RB / 16;        // 16-byte vectors of a pool row
  constexpr int QV = HD / 8;          // 16-byte vectors of a q or output row
  constexpr int DT = HD / 8;          // n8 tiles of the output
  constexpr int KT = kKeys / 8;       // n8 tiles of a score block
  constexpr int ST = S::kStride;
  const int G = H / K;
  const int TQ = kRows / G;
  const int rows = TQ * G;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * TQ;  // the longest tiles first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tlen = t_valid[b];
  const int p0 = pos0[b];
  const int n_valid = max(0, min(tlen, min(T, t0 + TQ)) - t0);
  const long long kw = (long long)K * RB;  // a pool row, bytes

  // The q load and the output store: two threads a tile row (position t0 +
  // r / G, query head kh * G + r % G), vectors half, half + 2, ...
  const int my_r = tid >> 1;
  const int my_half = tid & 1;
  const int my_t = my_r / G;
  const bool my_row = my_r < rows && t0 + my_t < T;  // a row of the output
  const long long my_off = (((long long)b * T + t0 + my_t) * H + kh * G + my_r % G) * HD;

  if (n_valid == 0) {  // the whole tile is past t_valid: zeros
    if (my_row) {
#pragma unroll
      for (int i = 0; i < QV / 2; ++i)
        reinterpret_cast<uint4*>(out + my_off)[my_half + 2 * i] = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int s) { return smem + S::kOps + s * S::kStage; };
  __nv_bfloat16* qo_s = reinterpret_cast<__nv_bfloat16*>(kQuant ? smem : stage(1));

  // causal limit: the tile's last valid query position, plus one
  const int kend = p0 + t0 + n_valid;
  const int nblk = (kend + kKeys - 1) / kKeys;

  // The key gather: TPK threads copy a key's K and V rows, TPK (up to 8)
  // consecutive 16-byte vectors at a time, so a warp's copy reads whole
  // 128-byte lines of 4 to 32 keys. Each thread serves NK keys of a block
  // (key = tid / TPK + KPP * i) and reads their page ids from the block
  // table a block ahead, so no copy waits on a lookup. The thread that
  // copies a key's first vector also copies its K scale, the next its V
  // scale (for int4 at Hd 32, one thread a key, both). Shifts for a page
  // size that is a power of two.
  constexpr int TPK = VPR < 8 ? VPR : 8;                     // threads a key
  constexpr int KPP = kThreads / TPK;                         // keys a pass
  constexpr int NK = KPP >= kKeys ? 1 : kKeys / KPP;          // keys a thread
  const int my_key = tid / TPK;
  const int my_part = tid % TPK;
  const int pshift = (page_size & (page_size - 1)) == 0 ? __ffs(page_size) - 1 : -1;
  auto page_ids = [&](int j, int* pages) {  // the pages of this thread's keys of block j
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int pos = j * kKeys + my_key + KPP * i;
      const int pi = pshift >= 0 ? pos >> pshift : pos / page_size;
      pages[i] = pi < W ? __ldg(tables + (long long)b * W + pi) : 0;
    }
  };
  auto load_block = [&](int j, int s, const int* pages) {
    unsigned char* st = stage(s);
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int key = my_key + KPP * i;
      if (KPP > kKeys && key >= kKeys) break;
      const int pos = j * kKeys + key;
      const bool ok = pos < kend;
      const int po = pshift >= 0 ? pos & (page_size - 1) : pos % page_size;
      const long long page = pages[i];
      const long long off = ok ? (page * page_size + po) * kw + kh * RB : 0;
      const int dst = kQuant ? key * RB : key * ST * 2;
#pragma unroll
      for (int v = 0; v < VPR / TPK; ++v) {
        const int vb = (my_part + TPK * v) * 16;
        cp_async16(st + dst + vb, k_pool + off + vb, ok);
        cp_async16(st + (kQuant ? S::kRaw : S::kTile) + dst + vb, v_pool + off + vb, ok);
      }
      if constexpr (kFold) {
        const long long si = ok ? (page * K + kh) * page_size + po : 0;
        float* sc_s = reinterpret_cast<float*>(st + 2 * S::kRaw);
        if constexpr (TPK >= 2) {
          if (my_part < 2)
            cp_async4(sc_s + my_part * kKeys + key, (my_part ? vs_pool : ks_pool) + si, ok);
        } else {
          cp_async4(sc_s + key, ks_pool + si, ok);
          cp_async4(sc_s + kKeys + key, vs_pool + si, ok);
        }
      }
    }
    if constexpr (kGrouped) {
      // the block's K and V scales, [key][group] each, consecutive threads
      // on consecutive keys (consecutive floats of a page's channel)
      float* sc_s = reinterpret_cast<float*>(st + 2 * S::kRaw);
      for (int x = tid; x < 2 * kKeys * gph; x += kThreads) {
        const int key = x % kKeys;
        const int grp = (x / kKeys) % gph;
        const int which = x / (kKeys * gph);
        const int pos = j * kKeys + key;
        const int pi = pshift >= 0 ? pos >> pshift : pos / page_size;
        const bool ok = pos < kend && pi < W;
        const int po = pshift >= 0 ? pos & (page_size - 1) : pos % page_size;
        const long long page = ok ? __ldg(tables + (long long)b * W + pi) : 0;
        const long long si = ok ? ((page * K + kh) * gph + grp) * page_size + po : 0;
        cp_async4(sc_s + which * kKeys * S::kScales + key * gph + grp,
                  (which ? vs_pool : ks_pool) + si, ok);
      }
    }
  };

  // the q tile (rows past t_valid or past the tile zero-filled) and key block 0
  int pages[NK];
  page_ids(0, pages);
  {
    const bool ok = my_r < rows && my_t < n_valid;
#pragma unroll
    for (int i = 0; i < QV / 2; ++i) {
      const int vi = my_half + 2 * i;
      cp_async16(qo_s + my_r * ST + vi * 8, q + (ok ? my_off + vi * 8 : 0), ok);
    }
  }
  load_block(0, 0, pages);
  if (nblk > 1) page_ids(1, pages);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's q rows as A fragments: k16 step ks in qa[ks]
  uint32_t qa[HD / 16][4];
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldmatrix_x4(qa[ks], qo_s + r * ST + ks * 16 + (lane >> 4) * 8);
  }
  __syncthreads();  // the q tile's space is free

  // this thread's two rows (lane / 4 and lane / 4 + 8 of the warp's 16)
  const int r_lo = warp * 16 + (lane >> 2);
  const int qpos[2] = {p0 + t0 + r_lo / G, p0 + t0 + (r_lo + 8) / G};
  const int qpos_min = p0 + t0;
  const float sc = scale * kLog2e;  // scores in log2 units

  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};  // this thread's part of each row's denominator
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    if (j + 1 < nblk) {
      load_block(j + 1, (j + 1) & 1, pages);
      if (j + 2 < nblk) page_ids(j + 2, pages);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // block j has landed for every thread
    unsigned char* st = stage(j & 1);
    const __nv_bfloat16* k_s;
    const __nv_bfloat16* v_s;
    const float* ks_s = reinterpret_cast<const float*>(st + 2 * S::kRaw);
    const float* vs_s = ks_s + kKeys;
    if constexpr (kQuant) {
      // widen the raw codes into the operand tiles, once per block
      __nv_bfloat16* ko = reinterpret_cast<__nv_bfloat16*>(smem);
      __nv_bfloat16* vo = ko + kKeys * ST;
#pragma unroll
      for (int i = 0; i < 2 * kKeys * VPR / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int which = idx / (kKeys * VPR);
        const int key = (idx / VPR) % kKeys;
        const int vi = idx % VPR;
        const uint4 raw = *reinterpret_cast<const uint4*>(st + which * S::kRaw + key * RB + vi * 16);
        __nv_bfloat16* row = (which ? vo : ko) + key * ST;
        if constexpr (F == KvFmt::kInt8) {
          widen16(raw, row + vi * 16);
        } else if constexpr (kGrouped) {
          const float* sc = ks_s + which * kKeys * S::kScales + key * gph;
          widen16_nib_g(raw, row + vi * 16, row + HD / 2 + vi * 16, sc, vi * 16,
                        HD / 2 + vi * 16, gshift);
        } else {
          widen16_nib(raw, row + vi * 16, row + HD / 2 + vi * 16);
        }
      }
      __syncthreads();
      k_s = ko;
      v_s = vo;
    } else {
      k_s = reinterpret_cast<const __nv_bfloat16*>(st);
      v_s = reinterpret_cast<const __nv_bfloat16*>(st + S::kTile);
    }

    // scores: s[n] is the C fragment of keys 8n .. 8n + 7 of the block
    float s[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < KT / 2; ++np) {
        uint32_t bk[4];
        const int key = (2 * np + (lane >> 4)) * 8 + (lane & 7);
        ldmatrix_x4(bk, k_s + key * ST + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[ks], bk[2], bk[3]);
      }
    }

    // mask by absolute position, online softmax in log2 units. bf16 (and
    // grouped int4, whose operands are dequantized already): the max is
    // taken on the raw scores and hd**-0.5 * log2(e) folded into the
    // exponent's fma; int8/int4: each score first times its key's K scale
    // and that factor.
    const int kb = j * kKeys;
    const bool masked = kb + kKeys - 1 > qpos_min;
    const float post = kFold ? 1.f : sc;
    float mx[2] = {kNegInf, kNegInf};
    if constexpr (kFold) {
#pragma unroll
      for (int n = 0; n < KT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= sc * ks_s[n * 8 + (lane & 3) * 2 + (e & 1)];
      }
    }
    if (masked) {
#pragma unroll
      for (int n = 0; n < KT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kb + n * 8 + (lane & 3) * 2 + (e & 1) > qpos[e >> 1]) s[n][e] = kNegInf;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < KT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_i[i], mx[i] * post);
      alpha[i] = ex2(m_i[i] - m_new);
      m_i[i] = m_new;
      l_i[i] *= alpha[i];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < KT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[n][e], post, -m_i[e >> 1]));
        l_i[e >> 1] += p;
        s[n][e] = kFold ? p * vs_s[n * 8 + (lane & 3) * 2 + (e & 1)] : p;
      }
    }

    // P . V: keys 16 kk .. 16 kk + 15 are score tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_s + key * ST + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], hi, bv[0], bv[1]);
        mma_bf16(acc[2 * dp], lo, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], hi, bv[2], bv[3]);
        mma_bf16(acc[2 * dp + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage and the operand tiles
  }

  // normalize, stage the tile as bf16, store it with 16-byte writes
  float inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
    inv_l[i] = 1.f / fmaxf(l_i[i], 1e-30f);
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(qo_s + r_lo * ST + col) =
        pack_bf16(acc[d][0] * inv_l[0], acc[d][1] * inv_l[0]);
    *reinterpret_cast<uint32_t*>(qo_s + (r_lo + 8) * ST + col) =
        pack_bf16(acc[d][2] * inv_l[1], acc[d][3] * inv_l[1]);
  }
  __syncthreads();
  if (my_row) {
    const bool live = my_t < n_valid;
#pragma unroll
    for (int i = 0; i < QV / 2; ++i) {
      const int vi = my_half + 2 * i;
      reinterpret_cast<uint4*>(out + my_off)[vi] =
          live ? *reinterpret_cast<const uint4*>(qo_s + my_r * ST + vi * 8) : make_uint4(0, 0, 0, 0);
    }
  }
}

template <int HD, KvFmt F>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* ks_pool, const void* vs_pool,
           const void* tables, const void* pos0, const void* t_valid, void* out,
           int B, int T, int H, int K, int W, int page_size, float scale, int gshift,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<HD, F>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<HD, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int G = H / K;
  const int TQ = kRows / G;
  dim3 grid((unsigned)((T + TQ - 1) / TQ), (unsigned)K, (unsigned)B);
  flash_prefill_kernel<HD, F><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_pool, (const int8_t*)v_pool,
      (const float*)ks_pool, (const float*)vs_pool,
      (const int32_t*)tables, (const int32_t*)pos0, (const int32_t*)t_valid,
      (__nv_bfloat16*)out, T, H, K, W, page_size, scale, gshift);
  return (int)cudaGetLastError();
}

template <KvFmt F>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* ks_pool, const void* vs_pool,
             const void* tables, const void* pos0, const void* t_valid, void* out,
             int B, int T, int H, int K, int HD, int W, int page_size, float scale,
             void* stream, int gshift = 0) {
  if (B <= 0 || T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (HD) {
    case 32: return launch<32, F>(q, k_pool, v_pool, ks_pool, vs_pool, tables, pos0, t_valid, out, B, T, H, K, W, page_size, scale, gshift, s);
    case 64: return launch<64, F>(q, k_pool, v_pool, ks_pool, vs_pool, tables, pos0, t_valid, out, B, T, H, K, W, page_size, scale, gshift, s);
    case 128: return launch<128, F>(q, k_pool, v_pool, ks_pool, vs_pool, tables, pos0, t_valid, out, B, T, H, K, W, page_size, scale, gshift, s);
    default: return -1;
  }
}

// log2 of a scale group's features: a power of two from 8 to HD / 2, else -1
inline int group_shift(int group, int HD) {
  if (group < 8 || group >= HD || (group & (group - 1))) return -1;
  int sh = 0;
  while ((1 << sh) < group) ++sh;
  return sh;
}

}  // namespace

// K2. head_dim in {32, 64, 128} and 1 <= H/K <= 64 (checked by the
// wrapper; -1 here otherwise). Returns cudaGetLastError().
extern "C" int flash_prefill_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* pos0, const void* t_valid, void* out,
    int B, int T, int H, int K, int HD, int W, int page_size, float scale,
    void* stream) {
  return dispatch<KvFmt::kBf16>(q, k_pool, v_pool, nullptr, nullptr, tables, pos0, t_valid,
                                out, B, T, H, K, HD, W, page_size, scale, stream);
}

// K6: int8 pools with f32 scale pools [num_pages, K, page_size]; the same
// shape rules as K2.
extern "C" int flash_prefill_q_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* ks_pool, const void* vs_pool,
    const void* tables, const void* pos0, const void* t_valid, void* out,
    int B, int T, int H, int K, int HD, int W, int page_size, float scale,
    void* stream) {
  return dispatch<KvFmt::kInt8>(q, k_pool, v_pool, ks_pool, vs_pool, tables, pos0, t_valid,
                                out, B, T, H, K, HD, W, page_size, scale, stream);
}

// K6, int4 form: nibble-packed pools [slots, K*HD/2] with the same scale
// pools and shape rules.
extern "C" int flash_prefill_q4_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* ks_pool, const void* vs_pool,
    const void* tables, const void* pos0, const void* t_valid, void* out,
    int B, int T, int H, int K, int HD, int W, int page_size, float scale,
    void* stream) {
  return dispatch<KvFmt::kInt4>(q, k_pool, v_pool, ks_pool, vs_pool, tables, pos0, t_valid,
                                out, B, T, H, K, HD, W, page_size, scale, stream);
}

// K6, grouped int4 form: nibble-packed pools [slots, K*HD/2] with f32 scale
// pools [num_pages, K * HD / group, page_size], `group` features a scale (a
// power of two, 8 <= group < HD; -1 otherwise); the same shape rules as K2.
extern "C" int flash_prefill_q4g_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* ks_pool, const void* vs_pool,
    const void* tables, const void* pos0, const void* t_valid, void* out,
    int B, int T, int H, int K, int HD, int W, int page_size, float scale,
    void* stream, int group) {
  const int gshift = group_shift(group, HD);
  if (gshift < 0) return -1;
  return dispatch<KvFmt::kInt4G>(q, k_pool, v_pool, ks_pool, vs_pool, tables, pos0, t_valid,
                                 out, B, T, H, K, HD, W, page_size, scale, stream, gshift);
}
