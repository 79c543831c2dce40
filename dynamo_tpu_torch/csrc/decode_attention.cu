// K3 and K5: paged decode attention fused with the new token's KV write.
//
// Replaces: dynamo_tpu/ops/pallas_attention.py,
// fused_paged_decode_attention / _decode_kernel (K3, the bf16 branch) and
// _decode_kernel_q (K5, its int8 and int4 branches), and their read-only use
// paged_decode_attention (write_pos = -1). One query token per sequence:
// if write_pos[b] >= 0 the new K/V row is stored at that position's slot,
// then the query attends lengths[b] keys (the count includes the new
// token). Rows with lengths == 0 output 0. As in the reference, q is
// scaled by hd**-0.5 and rounded to the working type before the dot
// products.
//
// K5 reads int8 pools with f32 scale pools [num_pages, K, page_size]
// (ops/quant.py layout). The new row arrives quantized with its scales
// [B, K]; both are stored at write_pos, and the new token is attended
// through that quantized row. The math is f32 on the int8 values: the K
// scale multiplies the score, the V scale multiplies the probability
// before the P.V product ((p * vs) . v_int8 == p . dequant(v)).
//
// K5's int4 form reads nibble-packed pools and new rows (K*Hd/2 bytes a
// row, ops/quant.py planar layout: a head's byte j holds feature j in its
// low nibble and feature j + Hd/2 in its high one) with the same scales.
// Codes are widened in registers (low ((b & 15) ^ 8) - 8, high b >> 4 on
// the signed byte), exactly.
//
// K5's grouped int4 form takes scale pools of S = K * groups channels
// [num_pages, S, page_size] and new scales [B, S] (groups of `group`
// features, a power of two from 8 to Hd / 2). A scale that varies across a
// head's features cannot be folded into the score or the probability, so,
// as the reference's gather path does (dynamo_tpu/ops/attention.py
// paged_attention over dequantize_kv_rows_int4 rows), each code times its
// group's scale in f32 is rounded once to bf16 and that value is the
// operand: in the score's A fragments, and in P.V's f32 V features. A
// packed byte's two nibbles (features j and j + Hd/2) may lie in different
// groups; each takes its own. A tile's scales are staged beside its rows,
// one 4-byte copy each, [key][group]. Bound: bytes, as the int4 form's,
// with S scales a row where it reads K (group 32 at the 8B shape: 1,280
// bytes a token and layer against 1,088); the per-element products and
// roundings cost the CUDA cores what the fold saved them.
//
// Bound on the H100: bytes. Each step streams every live K/V row once
// (2 * sum(lengths) * K * Hd bytes per element size, plus 8 bytes of
// scales per row and kv head for K5) for ~4 FLOPs per byte (~8 at int8,
// ~16 at int4), far below the ~295 FLOP/byte at which the tensor cores
// would bound it. At Llama-3.1-8B's decode shape (B 8, K 8, lengths
// 512-600) that is 18.7 MB, 5.6 us at 3.35 TB/s; a single block per (kv
// head, sequence) gave 64 blocks on 132 SMs, each walking its keys through
// a chain of shuffles and exponentials, and reached 7 % of that rate.
//
// Design (flash-decoding, one launch).
//   Split: the grid is (kv head, sequence, split); split s of a row covers
// key positions [s * chunk, (s + 1) * chunk), chunk a multiple of 128 that
// the wrapper chooses (ops/decode_attention.split_plan) from B, K, the
// table width and the SM count, never from the lengths, which would cost a
// device-to-host read per layer on a host-bound step. The splits cover the
// table's W * page_size positions; one that starts at or past its row's
// length exits at once (the engine passes its full table width, so at W 32
// most splits of a 600-key row are empty).
//   Tiles: four warps take the split's 16-key tiles in turn (warp w tiles
// w, w + 4, ...), each with its own online softmax, so the key loop has no
// block barrier. A warp copies its tile's K and V rows (and scales) with
// 16-byte cp.async into a ring of two stages of its own, lanes on
// consecutive vectors of a row so a warp reads whole 128-byte lines; a
// tile lies inside one page whenever page_size is a multiple of 16, and
// then its page id is read a tile ahead, once.
//   Scores: mma.sync m16n8k16 (bf16 -> f32), keys on M and the G <= 8
// query heads on N (zero past G). Products of bf16 values are exact in f32,
// so this computes the f32 dot product with no per-key shuffle. A lane
// builds its A fragments straight from the staged rows: bf16 words as they
// are, int8 and int4 codes widened exactly to bf16 in registers. A dot
// product may take its features in any order, so a lane takes those of the
// bytes it reads, and q's B fragments (loaded once a block, scaled and
// rounded to bf16 as in the reference) take the same ones. K rows of 128 or
// 256 bytes are padded by 64 bytes, so a quarter warp's 16-byte reads meet
// 32 distinct banks.
//   Softmax: a tile's max per head over its 16 keys (three shuffles for
// the two heads a lane holds), one ex2 per score, in log2 units.
//   P.V: f32 on the CUDA cores (decode does ~G FLOPs a byte): a lane holds
// Hd/32 features of every head's accumulator and reads each key's
// probabilities (times its V scale for K5), unrounded, from the warp's
// shared tile.
//   Write: the split whose range holds write_pos stores the new row (and
// its scales): the lanes that would copy that key load the new row into
// registers and store it to the pool and to the tile, so the pool is never
// read back at write_pos, and no other split reads that position. A
// write_pos at or past the row's length is stored at the block's start.
//   Combine: the four warps merge through shared memory, in warp order. A
// row with one active split writes its output directly. Otherwise each
// active split writes its partial (max, denominator and unnormalised
// output per head, f32) to the wrapper's scratch, fences and takes a
// ticket on its (sequence, kv head) counter; the block that draws the last
// ticket merges the partials in split order (so the bits do not depend on
// which block came last), writes the output and sets the counter back to
// 0. One launch a call: no memset and no combine kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;
constexpr int kTileKeys = 16;                     // a warp's tile: the mma's M
constexpr int kStages = 2;                        // a warp's ring
constexpr int kSplitKeys = kStages * kWarps * kTileKeys;  // a split's keys are a multiple of this
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

enum class KvFmt { kBf16, kInt8, kInt4, kInt4G };

// bytes of one kv head's row in the pool
template <int HD, KvFmt F>
__host__ __device__ constexpr int row_bytes() {
  return F == KvFmt::kBf16 ? 2 * HD : F == KvFmt::kInt8 ? HD : HD / 2;
}

// Shared memory: each warp's ring (two stages of 16 K rows, padded, 16 V
// rows and, for K5, their 16 K and 16 V scales, or kMaxS a key each in the
// grouped form), then each warp's
// probabilities [16 keys][8 heads] and rescale factors [8]. The warps'
// merge reuses it from the start.
template <int HD, KvFmt F>
struct Smem {
  static constexpr int RB = row_bytes<HD, F>();
  static constexpr int KSTR = RB % 128 == 0 ? RB + 64 : RB;
  static constexpr int kMaxS = F == KvFmt::kInt4G ? HD / 8 : 1;  // scales a key, at most
  static constexpr int kScales = F == KvFmt::kBf16 ? 0 : 2 * kTileKeys * 4 * kMaxS;
  static constexpr int kStage = kTileKeys * (KSTR + RB) + kScales;
  static constexpr int kPs = (kTileKeys + 1) * kMaxG * 4;
  static constexpr int kWarpMerge = (2 * kWarps * kMaxG + kWarps * kMaxG * HD) * 4;
  static_assert(kStage % 16 == 0 && kPs % 16 == 0, "16-byte aligned stages");
  static constexpr int kRing = kWarps * (kStages * kStage + kPs);
  static constexpr int kBytes = kRing > kWarpMerge ? kRing : kWarpMerge;
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

// two floats as a bf16 pair (x in the low half), rounded to nearest (exact
// for the values used here: bf16 q, int8 and int4 codes)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte j of a word, sign-extended
__device__ __forceinline__ int sbyte(uint32_t x, int j) { return (int)(x << (24 - 8 * j)) >> 24; }
__device__ __forceinline__ float nib_lo(int b) { return (float)(((b & 15) ^ 8) - 8); }
__device__ __forceinline__ float nib_hi(int b) { return (float)(b >> 4); }

// ---- the score operands
//
// Lane (g8 = lane / 4, c4 = lane % 4) supplies rows g8 and g8 + 8 of the
// tile's A fragments and head g8's B fragment. It reads RB / 4 bytes of
// each row, as NV vectors of VB bytes at byte (i * 4 + c4) * VB, NW words
// in all. A word becomes k-step columns 2*c4, 2*c4 + 1 (half 0) or 2*c4 + 8,
// 2*c4 + 9 (half 1): bf16, a word is one half of k-step w / 2; int8, the
// four codes of a word are both halves of k-step w; int4, a word's four
// low nibbles are k-step 2w and its four high nibbles k-step 2w + 1. q's
// B fragment takes the same features in the same places.
template <int HD, KvFmt F>
struct Frag {
  static constexpr int RB = row_bytes<HD, F>();
  static constexpr int TB = RB / 4;
  static constexpr int VB = TB < 16 ? TB : 16;
  static constexpr int NV = TB / VB;
  static constexpr int WPV = VB / 4;
  static constexpr int NW = TB / 4;
  static constexpr int KS = HD / 16;
  static_assert(NW * (F == KvFmt::kBf16 ? 1 : F == KvFmt::kInt8 ? 2 : 4) == 2 * KS,
                "a lane's words fill the k-steps");
  __device__ static int word_off(int w, int c4) {
    return ((w / WPV) * 4 + c4) * VB + (w % WPV) * 4;
  }
};

template <int HD, KvFmt F>
__device__ __forceinline__ void load_words(const unsigned char* row, int c4, uint32_t* wd) {
  using Fr = Frag<HD, F>;
#pragma unroll
  for (int i = 0; i < Fr::NV; ++i) {
    const unsigned char* p = row + (i * 4 + c4) * Fr::VB;
    if constexpr (Fr::VB == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      wd[4 * i] = v.x; wd[4 * i + 1] = v.y; wd[4 * i + 2] = v.z; wd[4 * i + 3] = v.w;
    } else if constexpr (Fr::VB == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      wd[2 * i] = v.x; wd[2 * i + 1] = v.y;
    } else {
      wd[i] = *reinterpret_cast<const uint32_t*>(p);
    }
  }
}

// one row's words into a[ks][rsel] (half 0) and a[ks][rsel + 2] (half 1)
template <int HD, KvFmt F>
__device__ __forceinline__ void row_frag(const uint32_t* wd, uint32_t (*a)[4], int rsel) {
  using Fr = Frag<HD, F>;
#pragma unroll
  for (int w = 0; w < Fr::NW; ++w) {
    const uint32_t x = wd[w];
    if constexpr (F == KvFmt::kBf16) {
      a[w >> 1][rsel + 2 * (w & 1)] = x;
    } else if constexpr (F == KvFmt::kInt8) {
      a[w][rsel] = pack_bf16((float)sbyte(x, 0), (float)sbyte(x, 1));
      a[w][rsel + 2] = pack_bf16((float)sbyte(x, 2), (float)sbyte(x, 3));
    } else {
      const int b0 = sbyte(x, 0), b1 = sbyte(x, 1), b2 = sbyte(x, 2), b3 = sbyte(x, 3);
      a[2 * w][rsel] = pack_bf16(nib_lo(b0), nib_lo(b1));
      a[2 * w][rsel + 2] = pack_bf16(nib_lo(b2), nib_lo(b3));
      a[2 * w + 1][rsel] = pack_bf16(nib_hi(b0), nib_hi(b1));
      a[2 * w + 1][rsel + 2] = pack_bf16(nib_hi(b2), nib_hi(b3));
    }
  }
}

// the grouped int4 form's rows: each code times its group's scale (sc: the
// key's scales, one a group; 1 << gshift features a group, >= 8, so a
// word's four low or four high nibbles share one), in f32, rounded to bf16
template <int HD>
__device__ __forceinline__ void row_frag_g(const uint32_t* wd, uint32_t (*a)[4], int rsel,
                                           const float* sc, int c4, int gshift) {
  using Fr = Frag<HD, KvFmt::kInt4G>;
#pragma unroll
  for (int w = 0; w < Fr::NW; ++w) {
    const uint32_t x = wd[w];
    const int off = Fr::word_off(w, c4);  // the low nibbles' first feature
    const float sl = sc[off >> gshift];
    const float sh = sc[(HD / 2 + off) >> gshift];
    const int b0 = sbyte(x, 0), b1 = sbyte(x, 1), b2 = sbyte(x, 2), b3 = sbyte(x, 3);
    a[2 * w][rsel] = pack_bf16(__fmul_rn(nib_lo(b0), sl), __fmul_rn(nib_lo(b1), sl));
    a[2 * w][rsel + 2] = pack_bf16(__fmul_rn(nib_lo(b2), sl), __fmul_rn(nib_lo(b3), sl));
    a[2 * w + 1][rsel] = pack_bf16(__fmul_rn(nib_hi(b0), sh), __fmul_rn(nib_hi(b1), sh));
    a[2 * w + 1][rsel + 2] = pack_bf16(__fmul_rn(nib_hi(b2), sh), __fmul_rn(nib_hi(b3), sh));
  }
}

// head g8's B fragments: qh = its q row (null past G: zeros)
template <int HD, KvFmt F>
__device__ __forceinline__ void q_frag(const __nv_bfloat16* qh, float scale, int c4,
                                       uint32_t (*qb)[2]) {
  using Fr = Frag<HD, F>;
  auto qv = [&](int f) {
    return qh ? __bfloat162float(__float2bfloat16(__bfloat162float(qh[f]) * scale)) : 0.f;
  };
#pragma unroll
  for (int w = 0; w < Fr::NW; ++w) {
    const int off = Fr::word_off(w, c4);
    if constexpr (F == KvFmt::kBf16) {
      qb[w >> 1][w & 1] = pack_bf16(qv(off / 2), qv(off / 2 + 1));
    } else if constexpr (F == KvFmt::kInt8) {
      qb[w][0] = pack_bf16(qv(off), qv(off + 1));
      qb[w][1] = pack_bf16(qv(off + 2), qv(off + 3));
    } else {
      qb[2 * w][0] = pack_bf16(qv(off), qv(off + 1));
      qb[2 * w][1] = pack_bf16(qv(off + 2), qv(off + 3));
      qb[2 * w + 1][0] = pack_bf16(qv(HD / 2 + off), qv(HD / 2 + off + 1));
      qb[2 * w + 1][1] = pack_bf16(qv(HD / 2 + off + 2), qv(HD / 2 + off + 3));
    }
  }
}

// ---- the P.V operands
//
// Lane l holds DPL = Hd/32 features of every head's accumulator: those of
// the row bytes it reads, feat(l, dd). bf16 and int8: features
// [l*DPL, (l+1)*DPL). int4 at Hd 128: bytes 2l and 2l+1, features {2l,
// 2l+1, 64+2l, 65+2l}; at Hd 64 byte l, features {l, 32+l}; at Hd 32 byte
// l mod 16, feature l (lanes l and l+16 read one byte).
template <int HD, KvFmt F>
__device__ __forceinline__ int feat(int lane, int dd) {
  constexpr int DPL = HD / 32;
  if constexpr (F != KvFmt::kInt4 && F != KvFmt::kInt4G) {
    return lane * DPL + dd;
  } else if constexpr (HD == 32) {
    return lane;
  } else {
    constexpr int BPL = DPL / 2;  // packed bytes a lane
    return dd < BPL ? lane * BPL + dd : HD / 2 + lane * BPL + dd - BPL;
  }
}

// the lane's DPL features of a staged V row, as f32
template <int HD, KvFmt F>
__device__ __forceinline__ void v_feats(const unsigned char* row, int lane, float* f) {
  constexpr int DPL = HD / 32;
  if constexpr (F == KvFmt::kBf16) {
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(row) + lane * DPL;
    if constexpr (DPL == 4) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    } else if constexpr (DPL == 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      f[0] = a.x; f[1] = a.y;
    } else {
      f[0] = __bfloat162float(*p);
    }
  } else if constexpr (F == KvFmt::kInt8) {
    const int8_t* p = reinterpret_cast<const int8_t*>(row) + lane * DPL;
    if constexpr (DPL == 4) {
      const char4 c = *reinterpret_cast<const char4*>(p);
      f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
    } else if constexpr (DPL == 2) {
      const char2 c = *reinterpret_cast<const char2*>(p);
      f[0] = c.x; f[1] = c.y;
    } else {
      f[0] = *p;
    }
  } else {
    const int8_t* p = reinterpret_cast<const int8_t*>(row);
    if constexpr (HD == 128) {
      const char2 c = *reinterpret_cast<const char2*>(p + 2 * lane);
      f[0] = nib_lo(c.x); f[1] = nib_lo(c.y); f[2] = nib_hi(c.x); f[3] = nib_hi(c.y);
    } else if constexpr (HD == 64) {
      const int c = p[lane];
      f[0] = nib_lo(c); f[1] = nib_hi(c);
    } else {
      const int c = p[lane & 15];
      f[0] = lane < 16 ? nib_lo(c) : nib_hi(c);
    }
  }
}

// GP: 4 when H/K <= 4, else 8 (the accumulators a lane keeps). At least
// four blocks an SM (at most 128 registers a thread): registers then never
// hold an SM to fewer blocks than its shared memory does (three of the bf16
// Hd 128 form's 76 KB), and each block's copies wait behind the others'.
template <int HD, KvFmt F, int GP>
__global__ void __launch_bounds__(kThreads, 4) fused_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, H, HD]
    const unsigned char* __restrict__ new_k,   // [B, K * row_bytes] (any format, as bytes)
    const unsigned char* __restrict__ new_v,
    unsigned char* __restrict__ k_pool,        // [slots, K * row_bytes]
    unsigned char* __restrict__ v_pool,
    const float* __restrict__ new_ks,          // [B, K] (K5; unused when no write)
    const float* __restrict__ new_vs,
    float* __restrict__ ks_pool,               // [num_pages, S, page_size] (K5; S = K, or
                                               // K * groups in the grouped form)
    float* __restrict__ vs_pool,
    const int32_t* __restrict__ tables,        // [B, W]
    const int32_t* __restrict__ lengths,       // [B]
    const int32_t* __restrict__ write_pos,     // [B]
    __nv_bfloat16* __restrict__ out,           // [B, H, HD]
    float* __restrict__ part,                  // [B, K, splits, 2 * kMaxG + G * HD] (splits > 1)
    int* __restrict__ tickets,                 // [B, K], 0 between launches
    int H, int K, int W, int page_size, int chunk, float scale,
    int gshift) {  // grouped form: a scale group is 1 << gshift features
  using S = Smem<HD, F>;
  using Fr = Frag<HD, F>;
  constexpr bool kQuant = F != KvFmt::kBf16;
  constexpr bool kGrouped = F == KvFmt::kInt4G;
  constexpr bool kFold = kQuant && !kGrouped;  // scales folded into scores and probabilities
  const int gph = kGrouped ? HD >> gshift : 1;  // scale groups a kv head
  constexpr int RB = S::RB;
  constexpr int KSTR = S::KSTR;
  constexpr int DPL = HD / 32;
  constexpr int KS = Fr::KS;
  constexpr int VPR = RB / 16;                   // 16-byte vectors of a row
  constexpr int NJ = VPR >= 2 ? VPR / 2 : 1;     // vectors a lane copies of each pool, a tile
  const int G = H / K;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int c4 = lane & 3;
  const long long kw = (long long)K * RB;        // a pool row, bytes
  // keys past the table are not attended (the plain version's gather stops there)
  const int L = min(lengths[b], W * page_size);
  const int wpos = write_pos[b];
  const int start = split * chunk;
  const int end = min(start + chunk, L);
  const int n_act = (L + chunk - 1) / chunk;     // splits holding keys

  const int pshift = (page_size & (page_size - 1)) == 0 ? __ffs(page_size) - 1 : -1;
  auto pdiv = [&](int pos) { return pshift >= 0 ? pos >> pshift : pos / page_size; };
  auto pmod = [&](int pos) { return pshift >= 0 ? pos & (page_size - 1) : pos % page_size; };
  auto page_of = [&](int pos) -> int {
    const int pi = pdiv(pos);
    return pi < W ? __ldg(tables + (long long)b * W + pi) : 0;
  };

  // A tile lies in one page when page_size is a multiple of 16 (tiles start
  // at multiples of 16): one page id a tile, read a tile ahead. The first
  // two of this warp's tiles are read before the length arrives.
  const bool one_page = page_size % kTileKeys == 0;
  auto tile_page = [&](int key0) { return one_page ? page_of(key0) : 0; };
  const int tp0 = tile_page(start + warp * kTileKeys);
  const int tp1 = tile_page(start + (warp + kWarps) * kTileKeys);

  // the split whose range holds write_pos stores the new row; inside the
  // row's length the tile load does it (see issue), else it happens here
  const bool writer = wpos >= 0 && min(wpos / chunk, nsplit - 1) == split;
  const bool own_write = writer && wpos < end;
  if (writer && !own_write) {
    const long long page = page_of(wpos);
    const long long slot = page * page_size + pmod(wpos);
    if (tid < 2 * VPR) {
      const int v = (tid % VPR) * 16;
      const long long src = (long long)b * kw + kh * RB + v;
      const long long dst = slot * kw + kh * RB + v;
      if (tid < VPR) {
        *reinterpret_cast<uint4*>(k_pool + dst) = *reinterpret_cast<const uint4*>(new_k + src);
      } else {
        *reinterpret_cast<uint4*>(v_pool + dst) = *reinterpret_cast<const uint4*>(new_v + src);
      }
    }
    if constexpr (kFold) {
      const long long si = (page * K + kh) * page_size + pmod(wpos);
      if (tid == kThreads - 2) ks_pool[si] = new_ks[(long long)b * K + kh];
      if (tid == kThreads - 1) vs_pool[si] = new_vs[(long long)b * K + kh];
    }
    if constexpr (kGrouped) {
      const int x = tid - (kThreads - 2 * gph);  // the last 2 * gph threads
      if (x >= 0) {
        const int grp = x % gph;
        const long long ch = ((long long)b * K + kh) * gph + grp;
        const long long si = ((page * K + kh) * gph + grp) * page_size + pmod(wpos);
        if (x < gph) {
          ks_pool[si] = new_ks[ch];
        } else {
          vs_pool[si] = new_vs[ch];
        }
      }
    }
  }
  if (split >= n_act) {  // no keys here
    if (L <= 0 && split == 0) {  // an idle row: zeros
      for (int idx = tid; idx < G * HD; idx += kThreads)
        out[((long long)b * H + kh * G) * HD + idx] = __float2bfloat16(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int s) { return smem + (warp * kStages + s) * S::kStage; };
  float* ps = reinterpret_cast<float*>(smem + kWarps * kStages * S::kStage + warp * S::kPs);
  float* pal = ps + kTileKeys * kMaxG;

  // this warp's copy of a tile into stage s: lane + 32 j is vector (x % VPR)
  // of key (x / VPR), in both pools; lanes 0-15 copy the keys' K scales,
  // 16-31 their V scales. The new row goes registers -> pool and tile.
  auto issue = [&](int key0, int s, int tpage) {
    unsigned char* st = stage(s);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int x = lane + 32 * j;
      if (VPR == 1 && x >= kTileKeys) break;  // int4 at Hd 32: one vector a row
      const int r = x / VPR;
      const int v = (x % VPR) * 16;
      const int pos = key0 + r;
      const bool ok = pos < end;
      const long long page = ok ? (one_page ? tpage : page_of(pos)) : 0;
      const long long off = ok ? (page * page_size + pmod(pos)) * kw + kh * RB + v : 0;
      unsigned char* dk = st + r * KSTR + v;
      unsigned char* dv = st + kTileKeys * KSTR + r * RB + v;
      if (own_write && pos == wpos) {
        const long long src = (long long)b * kw + kh * RB + v;
        const uint4 nk = *reinterpret_cast<const uint4*>(new_k + src);
        const uint4 nv = *reinterpret_cast<const uint4*>(new_v + src);
        *reinterpret_cast<uint4*>(k_pool + off) = nk;
        *reinterpret_cast<uint4*>(v_pool + off) = nv;
        *reinterpret_cast<uint4*>(dk) = nk;
        *reinterpret_cast<uint4*>(dv) = nv;
      } else {
        cp_async16(dk, k_pool + off, ok);
        cp_async16(dv, v_pool + off, ok);
      }
    }
    if constexpr (kGrouped) {
      // [key][group] K scales, then V scales; lanes on consecutive keys
      float* ds0 = reinterpret_cast<float*>(st + kTileKeys * (KSTR + RB));
      for (int x = lane; x < 2 * kTileKeys * gph; x += 32) {
        const int r = x % kTileKeys;
        const int grp = (x / kTileKeys) % gph;
        const bool isv = x >= kTileKeys * gph;
        const int pos = key0 + r;
        const bool ok = pos < end;
        const long long page = ok ? (one_page ? tpage : page_of(pos)) : 0;
        const long long si = ok ? ((page * K + kh) * gph + grp) * page_size + pmod(pos) : 0;
        float* ds = ds0 + (isv ? kTileKeys * S::kMaxS : 0) + r * gph + grp;
        float* pool_s = isv ? vs_pool : ks_pool;
        if (own_write && pos == wpos) {
          const float sv = (isv ? new_vs : new_ks)[((long long)b * K + kh) * gph + grp];
          pool_s[si] = sv;
          *ds = sv;
        } else {
          cp_async4(ds, pool_s + si, ok);
        }
      }
    } else if constexpr (kQuant) {
      const int r = lane & 15;
      const bool isv = lane >= 16;
      const int pos = key0 + r;
      const bool ok = pos < end;
      const long long page = ok ? (one_page ? tpage : page_of(pos)) : 0;
      const long long si = ok ? (page * K + kh) * page_size + pmod(pos) : 0;
      float* ds = reinterpret_cast<float*>(st + kTileKeys * (KSTR + RB)) + (isv ? kTileKeys : 0) + r;
      float* pool_s = isv ? vs_pool : ks_pool;
      if (own_write && pos == wpos) {
        const float sv = (isv ? new_vs : new_ks)[(long long)b * K + kh];
        pool_s[si] = sv;
        *ds = sv;
      } else {
        cp_async4(ds, pool_s + si, ok);
      }
    }
  };

  const int ntiles = (end - start + kTileKeys - 1) / kTileKeys;
  const int my_tiles = warp < ntiles ? (ntiles - 1 - warp) / kWarps + 1 : 0;
  auto key0_of = [&](int i) { return start + (warp + kWarps * i) * kTileKeys; };

  if (my_tiles > 0) issue(key0_of(0), 0, tp0);
  cp_async_commit();
  if (my_tiles > 1) issue(key0_of(1), 1, tp1);
  cp_async_commit();

  // head g8's q as B fragments, while the copies fly
  uint32_t qb[KS][2];
  q_frag<HD, F>(g8 < G ? q + ((long long)b * H + kh * G + g8) * HD : nullptr, scale, c4, qb);

  // this lane's softmax state for heads 2*c4 and 2*c4 + 1 (log2 units; l
  // over its own two rows of each tile), and its P.V accumulators
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) o[g][dd] = 0.f;
  }

  for (int i = 0; i < my_tiles; ++i) {
    const int tp_next = i + 2 < my_tiles ? tile_page(key0_of(i + 2)) : 0;
    cp_async_wait<1>();
    __syncwarp();
    const unsigned char* st = stage(i & 1);
    const int key0 = key0_of(i);

    // scores of keys g8 and g8 + 8 for heads 2*c4 and 2*c4 + 1
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* ksc = reinterpret_cast<const float*>(st + kTileKeys * (KSTR + RB));
    {
      uint32_t a[KS][4];
      uint32_t wd[Fr::NW];
      load_words<HD, F>(st + g8 * KSTR, c4, wd);
      if constexpr (kGrouped) {
        row_frag_g<HD>(wd, a, 0, ksc + g8 * gph, c4, gshift);
      } else {
        row_frag<HD, F>(wd, a, 0);
      }
      load_words<HD, F>(st + (g8 + 8) * KSTR, c4, wd);
      if constexpr (kGrouped) {
        row_frag_g<HD>(wd, a, 1, ksc + (g8 + 8) * gph, c4, gshift);
      } else {
        row_frag<HD, F>(wd, a, 1);
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_bf16(acc, a[ks], qb[ks][0], qb[ks][1]);
    }
    const bool ok0 = key0 + g8 < end;
    const bool ok1 = key0 + g8 + 8 < end;
    const float f0 = kFold ? ksc[g8] * kLog2e : kLog2e;
    const float f1 = kFold ? ksc[g8 + 8] * kLog2e : kLog2e;
    const float s0 = ok0 ? acc[0] * f0 : kNegInf;
    const float s1 = ok0 ? acc[1] * f0 : kNegInf;
    const float s2 = ok1 ? acc[2] * f1 : kNegInf;
    const float s3 = ok1 ? acc[3] * f1 : kNegInf;
    float mx0 = fmaxf(s0, s2), mx1 = fmaxf(s1, s3);
#pragma unroll
    for (int sh = 4; sh < 32; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    const float p0 = ok0 ? ex2(s0 - mn0) : 0.f;
    const float p1 = ok0 ? ex2(s1 - mn1) : 0.f;
    const float p2 = ok1 ? ex2(s2 - mn0) : 0.f;
    const float p3 = ok1 ? ex2(s3 - mn1) : 0.f;
    l0 = l0 * al0 + p0 + p2;
    l1 = l1 * al1 + p1 + p3;
    m0 = mn0;
    m1 = mn1;
    const float vs0 = kFold ? ksc[kTileKeys + g8] : 1.f;
    const float vs1 = kFold ? ksc[kTileKeys + g8 + 8] : 1.f;
    *reinterpret_cast<float2*>(ps + g8 * kMaxG + 2 * c4) = make_float2(p0 * vs0, p1 * vs0);
    *reinterpret_cast<float2*>(ps + (g8 + 8) * kMaxG + 2 * c4) = make_float2(p2 * vs1, p3 * vs1);
    if (g8 == 0) *reinterpret_cast<float2*>(pal + 2 * c4) = make_float2(al0, al1);
    __syncwarp();

    // P.V over the tile (rows past the length are zero-filled, their p 0)
    {
      const float4 a0 = *reinterpret_cast<const float4*>(pal);
      const float4 a1 = GP > 4 ? *reinterpret_cast<const float4*>(pal + 4) : a0;
      const float al[kMaxG] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) o[g][dd] *= al[g];
      }
      const unsigned char* vrows = st + kTileKeys * KSTR;
#pragma unroll 4
      for (int r = 0; r < kTileKeys; ++r) {
        float vf[DPL];
        v_feats<HD, F>(vrows + r * RB, lane, vf);
        if constexpr (kGrouped) {
          const float* vsc = ksc + kTileKeys * S::kMaxS + r * gph;
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd)
            vf[dd] = __bfloat162float(
                __float2bfloat16_rn(__fmul_rn(vf[dd], vsc[feat<HD, F>(lane, dd) >> gshift])));
        }
        const float4 pa = *reinterpret_cast<const float4*>(ps + r * kMaxG);
        const float4 pb = GP > 4 ? *reinterpret_cast<const float4*>(ps + r * kMaxG + 4) : pa;
        const float pr[kMaxG] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) o[g][dd] = fmaf(pr[g], vf[dd], o[g][dd]);
        }
      }
    }
    __syncwarp();  // the stage and ps are free for the next copy
    if (i + 2 < my_tiles) issue(key0_of(i + 2), i & 1, tp_next);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int sh = 4; sh < 32; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }

  // the warps' merge, in warp order (a warp without tiles holds -huge, 0, 0)
  __syncthreads();  // every warp is done with its stages
  float* mg_m = reinterpret_cast<float*>(smem);   // [kWarps][kMaxG]
  float* mg_l = mg_m + kWarps * kMaxG;            // [kWarps][kMaxG]
  float* mg_o = mg_l + kWarps * kMaxG;            // [kWarps][kMaxG][HD]
  if (g8 == 0) {
    mg_m[warp * kMaxG + 2 * c4] = m0;
    mg_m[warp * kMaxG + 2 * c4 + 1] = m1;
    mg_l[warp * kMaxG + 2 * c4] = l0;
    mg_l[warp * kMaxG + 2 * c4 + 1] = l1;
  }
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) mg_o[(warp * kMaxG + g) * HD + feat<HD, F>(lane, dd)] = o[g][dd];
  }
  __syncthreads();

  const int psz = 2 * kMaxG + G * HD;
  float* my_part = n_act > 1 ? part + (((long long)b * K + kh) * nsplit + split) * psz : nullptr;
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mg_m[w * kMaxG + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = ex2(mg_m[w * kMaxG + g] - mx);
      den += mg_l[w * kMaxG + g] * e;
      num += mg_o[(w * kMaxG + g) * HD + idx % HD] * e;
    }
    if (n_act == 1) {
      out[((long long)b * H + kh * G) * HD + idx] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      my_part[2 * kMaxG + idx] = num;
      if (idx % HD == 0) {
        my_part[g] = mx;
        my_part[kMaxG + g] = den;
      }
    }
  }
  if (n_act == 1) return;

  // the ticket: the last of the row's active splits to arrive merges
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* t = tickets + (long long)b * K + kh;
    s_last = atomicAdd(t, 1) == n_act - 1;
    if (s_last) *t = 0;  // every split of this launch has drawn: ready for the next
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // A thread merges a float4 of the output columns over the splits, in
  // split order: eight splits' maxima, denominators and outputs are loaded
  // at once, and a later batch of eight rescales what came before it (for
  // up to eight splits, the merge under the splits' common maximum).
  const float* row_part = part + ((long long)b * K + kh) * nsplit * psz;
  constexpr int kBatch = 8;
  for (int c = tid * 4; c < G * HD; c += kThreads * 4) {
    const int g = c / HD;
    float mx = kNegInf, den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_act; s0 += kBatch) {
      float4 x[kBatch];
      float bm[kBatch], bl[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float* ps_ = row_part + (long long)(s0 + u) * psz;
        const bool in = s0 + u < n_act;
        bm[u] = in ? __ldcg(ps_ + g) : kNegInf;
        bl[u] = in ? __ldcg(ps_ + kMaxG + g) : 0.f;
        x[u] = in ? __ldcg(reinterpret_cast<const float4*>(ps_ + 2 * kMaxG + c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float nm = mx;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) nm = fmaxf(nm, bm[u]);
      const float r = ex2(mx - nm);
      den *= r;
      num.x *= r;
      num.y *= r;
      num.z *= r;
      num.w *= r;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float e = s0 + u < n_act ? ex2(bm[u] - nm) : 0.f;
        den += bl[u] * e;
        num.x += x[u].x * e;
        num.y += x[u].y * e;
        num.z += x[u].z * e;
        num.w += x[u].w * e;
      }
      mx = nm;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + ((long long)b * H + kh * G) * HD + c);
    o2[0] = __floats2bfloat162_rn(num.x * inv, num.y * inv);
    o2[1] = __floats2bfloat162_rn(num.z * inv, num.w * inv);
  }
}

template <int HD, KvFmt F, int GP>
int launch(const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
           const void* new_ks, const void* new_vs, void* ks_pool, void* vs_pool,
           const void* tables, const void* lengths, const void* write_pos, void* out,
           int B, int H, int K, int W, int page_size, float scale, cudaStream_t stream,
           void* part, void* tickets, int chunk, int gshift) {
  if (chunk <= 0 || chunk % kSplitKeys != 0) return -1;
  const long long span = (long long)W * page_size;
  const int nsplit = span > chunk ? (int)((span + chunk - 1) / chunk) : 1;
  if (nsplit > 1 && (part == nullptr || tickets == nullptr)) return -1;
  constexpr int smem = Smem<HD, F>::kBytes;
  auto kern = fused_decode_kernel<HD, F, GP>;
  if constexpr (smem > 48 * 1024) {
    // above 48 KB only after this, once per device
    static unsigned done = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 32 || !(done & (1u << dev))) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < 32) done |= 1u << dev;
    }
  }
  dim3 grid((unsigned)K, (unsigned)B, (unsigned)nsplit);
  kern<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const unsigned char*)new_k, (const unsigned char*)new_v,
      (unsigned char*)k_pool, (unsigned char*)v_pool, (const float*)new_ks, (const float*)new_vs,
      (float*)ks_pool, (float*)vs_pool, (const int32_t*)tables, (const int32_t*)lengths,
      (const int32_t*)write_pos, (__nv_bfloat16*)out, (float*)part, (int*)tickets, H, K, W,
      page_size, chunk, scale, gshift);
  return (int)cudaGetLastError();
}

template <KvFmt F>
int dispatch(const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
             const void* new_ks, const void* new_vs, void* ks_pool, void* vs_pool,
             const void* tables, const void* lengths, const void* write_pos, void* out,
             int B, int H, int K, int HD, int W, int page_size, float scale, void* stream,
             void* part, void* tickets, int chunk, int gshift = 0) {
  if (B <= 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kMaxG) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (H / K > 4) {
    switch (HD) {
      case 32: return launch<32, F, 8>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool, vs_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s, part, tickets, chunk, gshift);
      case 64: return launch<64, F, 8>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool, vs_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s, part, tickets, chunk, gshift);
      case 128: return launch<128, F, 8>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool, vs_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s, part, tickets, chunk, gshift);
      default: return -1;
    }
  }
  switch (HD) {
    case 32: return launch<32, F, 4>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool, vs_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s, part, tickets, chunk, gshift);
    case 64: return launch<64, F, 4>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool, vs_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s, part, tickets, chunk, gshift);
    case 128: return launch<128, F, 4>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool, vs_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s, part, tickets, chunk, gshift);
    default: return -1;
  }
}

}  // namespace

// The three entry points keep their arguments and take three more at the
// end: `part`, the f32 scratch for the splits' partials ([B, K, splits,
// 16 + (H/K) * HD] floats; may be null when one split covers the table),
// `tickets`, B * K int32 counters that are 0 between launches (each launch
// leaves them 0), and `chunk`, the keys of a split (a multiple of 128;
// splits = ceil(W * page_size / chunk)). The wrapper owns both buffers and
// plans the split (ops/decode_attention.py).

// K3. head_dim in {32, 64, 128} and 1 <= H/K <= 8 (checked by the wrapper;
// -1 here otherwise). new_k/new_v may be null when every write_pos is -1.
// Returns cudaGetLastError().
extern "C" int fused_decode_launch(
    const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
    const void* tables, const void* lengths, const void* write_pos, void* out,
    int B, int H, int K, int HD, int W, int page_size, float scale, void* stream,
    void* part, void* tickets, int chunk) {
  return dispatch<KvFmt::kBf16>(q, new_k, new_v, k_pool, v_pool, nullptr, nullptr, nullptr,
                                nullptr, tables, lengths, write_pos, out, B, H, K, HD, W,
                                page_size, scale, stream, part, tickets, chunk);
}

// K5: int8 pools and new rows, f32 scale pools [num_pages, K, page_size] and
// new scales [B, K]; the same shape rules as K3. new_k/new_v/new_ks/new_vs
// may be null when every write_pos is -1.
extern "C" int fused_decode_q_launch(
    const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
    const void* new_ks, const void* new_vs, void* ks_pool, void* vs_pool,
    const void* tables, const void* lengths, const void* write_pos, void* out,
    int B, int H, int K, int HD, int W, int page_size, float scale, void* stream,
    void* part, void* tickets, int chunk) {
  return dispatch<KvFmt::kInt8>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool,
                                vs_pool, tables, lengths, write_pos, out, B, H, K, HD, W,
                                page_size, scale, stream, part, tickets, chunk);
}

// K5, int4 form: nibble-packed pools and new rows [*, K*HD/2] with the same
// scales and rules as K5.
extern "C" int fused_decode_q4_launch(
    const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
    const void* new_ks, const void* new_vs, void* ks_pool, void* vs_pool,
    const void* tables, const void* lengths, const void* write_pos, void* out,
    int B, int H, int K, int HD, int W, int page_size, float scale, void* stream,
    void* part, void* tickets, int chunk) {
  return dispatch<KvFmt::kInt4>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool,
                                vs_pool, tables, lengths, write_pos, out, B, H, K, HD, W,
                                page_size, scale, stream, part, tickets, chunk);
}

// K5, grouped int4 form: nibble-packed pools and new rows [*, K*HD/2], f32
// scale pools [num_pages, S, page_size] and new scales [B, S] of S = K * HD
// / group channels, `group` features a scale (a power of two, 8 <= group <
// HD; -1 otherwise); the same rules as K5.
extern "C" int fused_decode_q4g_launch(
    const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
    const void* new_ks, const void* new_vs, void* ks_pool, void* vs_pool,
    const void* tables, const void* lengths, const void* write_pos, void* out,
    int B, int H, int K, int HD, int W, int page_size, float scale, void* stream,
    void* part, void* tickets, int chunk, int group) {
  if (group < 8 || group >= HD || (group & (group - 1))) return -1;
  int gshift = 0;
  while ((1 << gshift) < group) ++gshift;
  return dispatch<KvFmt::kInt4G>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool,
                                 vs_pool, tables, lengths, write_pos, out, B, H, K, HD, W,
                                 page_size, scale, stream, part, tickets, chunk, gshift);
}
