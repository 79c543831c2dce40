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
// Codes are unpacked to f32 in registers (low ((b & 15) ^ 8) - 8, high
// b >> 4 on the signed byte), never through bf16. The reference's planar
// query layout is a Mosaic layout; here each lane holds q and its
// accumulator in the order of the features its packed bytes carry, and the
// merge writes them back in natural order.
//
// Bound on the H100: bytes. Each step streams every live K/V row once
// (2 * sum(lengths) * K * Hd bytes per element size, plus 8 bytes of
// scales per row and kv head for K5) for ~4 FLOPs per byte (~8 at int8,
// ~16 at int4), far below the ~295 FLOP/byte at which the tensor cores
// would bound it.
//
// Design: one block per (kv head, sequence), 8 warps. Every warp holds
// its kv head's slice of the new row in registers and warp 0 stores it
// (lane 0 also its two scales), so no two blocks write the same bytes.
// Each warp then walks every 8th key position; a key row (Hd elements) is
// one coalesced load across the warp, lane l holding features
// [l*Hd/32, (l+1)*Hd/32): 8 bytes a lane for bf16 at Hd 128, 4 for int8.
// An int4 row has Hd/2 bytes a head, so a lane holds the features of its
// packed bytes (see feat()): at Hd 128 bytes 2l and 2l+1, features
// {2l, 2l+1, 64+2l, 65+2l}; at Hd 64 byte l, features {l, 32+l}; at Hd 32
// byte l mod 16, feature l (lanes l and l+16 read one byte).
// (Sixteen int8 features a lane would need a lane's q and accumulator
// slices for 16 features of every one of up to 8 query heads, 256 floats,
// more than the 255 registers a thread has.) Four keys are loaded before
// any is used, to keep loads in flight. The dot products for the G query
// heads that share the kv head finish with warp shuffles, and each warp
// keeps an f32 online softmax (max, denominator, accumulator) per head. At
// the position being written the kernel uses the new row (and its scales)
// from registers, not a re-read of the pool. The eight warps' partial
// states are merged through shared memory at the end. Splitting long
// sequences over several blocks (flash-decode with a combine pass) is
// later work: at B = 8 and K = 8 this launches only 64 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;
constexpr int kUnroll = 4;
constexpr float kNegInf = -0.7f * FLT_MAX;

enum class KvFmt { kBf16, kInt8, kInt4 };

// pool element type (bytes for both quantized formats) and the elements of
// one kv head's row
template <KvFmt F>
using kv_t = typename std::conditional<F == KvFmt::kBf16, __nv_bfloat16, int8_t>::type;
template <int HD, KvFmt F>
__host__ __device__ constexpr int row_elems() { return F == KvFmt::kInt4 ? HD / 2 : HD; }

// The lane mapping: the feature (of a kv head's Hd) that lane `lane` holds
// in slot dd of its DPL = Hd/32 registers of q, K, V and accumulator.
template <int HD, KvFmt F>
__device__ __forceinline__ int feat(int lane, int dd) {
  constexpr int DPL = HD / 32;
  if constexpr (F != KvFmt::kInt4) {
    return lane * DPL + dd;
  } else if constexpr (HD == 32) {
    return lane;
  } else {
    constexpr int BPL = DPL / 2;  // packed bytes a lane
    return dd < BPL ? lane * BPL + dd : HD / 2 + lane * BPL + dd - BPL;
  }
}

// the element offset of the lane's slice inside a kv head's row
template <int HD, KvFmt F>
__device__ __forceinline__ int lane_off(int lane) {
  constexpr int DPL = HD / 32;
  if constexpr (F != KvFmt::kInt4) {
    return lane * DPL;
  } else if constexpr (HD == 32) {
    return lane & 15;
  } else {
    return lane * (DPL / 2);
  }
}

// int4: the lane's packed bytes of a row (two at Hd 128, else one)
template <int HD>
using nib_t = typename std::conditional<HD == 128, char2, int8_t>::type;

__device__ __forceinline__ float nib_lo(int b) { return (float)(((b & 15) ^ 8) - 8); }
__device__ __forceinline__ float nib_hi(int b) { return (float)(b >> 4); }

template <int HD>
__device__ __forceinline__ void unpack_nib(nib_t<HD> c, int lane, float* f) {
  if constexpr (HD == 128) {
    f[0] = nib_lo(c.x); f[1] = nib_lo(c.y); f[2] = nib_hi(c.x); f[3] = nib_hi(c.y);
  } else if constexpr (HD == 64) {
    f[0] = nib_lo(c); f[1] = nib_hi(c);
  } else {
    f[0] = lane < 16 ? nib_lo(c) : nib_hi(c);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* f) {
  if constexpr (DPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else if constexpr (DPL == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = a.x; f[1] = a.y;
  } else {
    f[0] = __bfloat162float(*p);
  }
}

template <int DPL>
__device__ __forceinline__ void load_row(const int8_t* p, float* f) {
  if constexpr (DPL == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
  } else if constexpr (DPL == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    f[0] = c.x; f[1] = c.y;
  } else {
    f[0] = *p;
  }
}

// the lane's DPL features of a row, p = the row's head slice + lane_off
template <int HD, KvFmt F>
__device__ __forceinline__ void load_feats(const kv_t<F>* p, int lane, float* f) {
  if constexpr (F == KvFmt::kInt4) {
    unpack_nib<HD>(*reinterpret_cast<const nib_t<HD>*>(p), lane, f);
  } else {
    load_row<HD / 32>(p, f);
  }
}

// f holds values of T's own type widened to f32, so both casts are exact
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float f) { *p = __float2bfloat16(f); }
__device__ __forceinline__ void store_elem(int8_t* p, float f) { *p = (int8_t)__float2int_rn(f); }

template <int HD, KvFmt F>
__global__ void __launch_bounds__(kThreads) fused_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, H, HD]
    const kv_t<F>* __restrict__ new_k,         // [B, K * row_elems]
    const kv_t<F>* __restrict__ new_v,
    kv_t<F>* __restrict__ k_pool,              // [slots, K * row_elems]
    kv_t<F>* __restrict__ v_pool,
    const float* __restrict__ new_ks,          // [B, K] (K5; unused when no write)
    const float* __restrict__ new_vs,
    float* __restrict__ ks_pool,               // [num_pages, K, page_size] (K5)
    float* __restrict__ vs_pool,
    const int32_t* __restrict__ tables,        // [B, W]
    const int32_t* __restrict__ lengths,       // [B]
    const int32_t* __restrict__ write_pos,     // [B]
    __nv_bfloat16* __restrict__ out,           // [B, H, HD]
    int H, int K, int W, int page_size, float scale) {
  constexpr bool kQuant = F != KvFmt::kBf16;
  constexpr int DPL = HD / 32;
  constexpr int RE = row_elems<HD, F>();
  const int G = H / K;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int kw = K * RE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int loff = kh * RE + lane_off<HD, F>(lane);  // the lane's slice of a row
  const int L = lengths[b];
  const int wpos = write_pos[b];

  auto page_of = [&](int pos) -> long long {
    const int pi = pos / page_size;
    return pi < W ? tables[(long long)b * W + pi] : 0;
  };
  // this kv head's scale of position pos in scale-pool page `page`
  auto scale_at = [&](long long page, int pos) -> long long {
    return (page * K + kh) * page_size + pos % page_size;
  };

  // this kv head's slice of the new row, held in registers (the lane's
  // features, see feat()); warp 0 stores it into the pool
  float nkf[DPL], nvf[DPL];
  float nks = 1.f, nvs = 1.f;
  if (wpos >= 0) {
    const long long src = (long long)b * kw + loff;
    const long long page = page_of(wpos);
    const long long dst = (page * page_size + wpos % page_size) * kw + loff;
    if constexpr (F == KvFmt::kInt4) {
      const nib_t<HD> rk = *reinterpret_cast<const nib_t<HD>*>(new_k + src);
      const nib_t<HD> rv = *reinterpret_cast<const nib_t<HD>*>(new_v + src);
      unpack_nib<HD>(rk, lane, nkf);
      unpack_nib<HD>(rv, lane, nvf);
      // the packed bytes go to the pool as they came (at Hd 32, lanes l
      // and l + 16 hold the two nibbles of one byte: the lower lane stores)
      if (warp == 0 && (HD != 32 || lane < 16)) {
        *reinterpret_cast<nib_t<HD>*>(k_pool + dst) = rk;
        *reinterpret_cast<nib_t<HD>*>(v_pool + dst) = rv;
      }
    } else {
      load_row<DPL>(new_k + src, nkf);
      load_row<DPL>(new_v + src, nvf);
      if (warp == 0) {
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          store_elem(k_pool + dst + dd, nkf[dd]);
          store_elem(v_pool + dst + dd, nvf[dd]);
        }
      }
    }
    if constexpr (kQuant) {
      nks = new_ks[(long long)b * K + kh];
      nvs = new_vs[(long long)b * K + kh];
      if (warp == 0 && lane == 0) {
        ks_pool[scale_at(page, wpos)] = nks;
        vs_pool[scale_at(page, wpos)] = nvs;
      }
    }
  }

  float qr[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const __nv_bfloat16* qh = q + ((long long)b * H + kh * G + g) * HD;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd)
        qr[g][dd] = __bfloat162float(
            __float2bfloat16(__bfloat162float(qh[feat<HD, F>(lane, dd)]) * scale));
    }
  }

  float m[kMaxG], l[kMaxG], o[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) o[g][dd] = 0.f;
  }

  for (int p0 = warp; p0 < L; p0 += kWarps * kUnroll) {
    float kf[kUnroll][DPL], vf[kUnroll][DPL];
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = p0 + u * kWarps;
      ksc[u] = 1.f;
      vsc[u] = 1.f;
      if (pos == wpos) {  // the new row, from registers: no re-read of the pool
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          kf[u][dd] = nkf[dd];
          vf[u][dd] = nvf[dd];
        }
        ksc[u] = nks;
        vsc[u] = nvs;
      } else if (pos < L) {
        const long long page = page_of(pos);
        const long long base = (page * page_size + pos % page_size) * kw + loff;
        load_feats<HD, F>(k_pool + base, lane, kf[u]);
        load_feats<HD, F>(v_pool + base, lane, vf[u]);
        if constexpr (kQuant) {
          ksc[u] = ks_pool[scale_at(page, pos)];
          vsc[u] = vs_pool[scale_at(page, pos)];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p0 + u * kWarps >= L) break;  // warp-uniform
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float s = 0.f;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) s += qr[g][dd] * kf[u][dd];
        s = warp_sum(s);
        if constexpr (kQuant) s *= ksc[u];
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
        const float pv = kQuant ? p * vsc[u] : p;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) o[g][dd] = o[g][dd] * alpha + pv * vf[u][dd];
      }
    }
  }

  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_o[kWarps][kMaxG][HD];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) sm_o[warp][g][feat<HD, F>(lane, dd)] = o[g][dd];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * c;
      num += sm_o[w][g][d] * c;
    }
    out[((long long)b * H + kh * G + g) * HD + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

template <int HD, KvFmt F>
int launch(const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
           const void* new_ks, const void* new_vs, void* ks_pool, void* vs_pool,
           const void* tables, const void* lengths, const void* write_pos, void* out,
           int B, int H, int K, int W, int page_size, float scale, cudaStream_t stream) {
  using T = kv_t<F>;
  dim3 grid((unsigned)K, (unsigned)B);
  fused_decode_kernel<HD, F><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const T*)new_k, (const T*)new_v, (T*)k_pool, (T*)v_pool,
      (const float*)new_ks, (const float*)new_vs, (float*)ks_pool, (float*)vs_pool,
      (const int32_t*)tables, (const int32_t*)lengths, (const int32_t*)write_pos,
      (__nv_bfloat16*)out, H, K, W, page_size, scale);
  return (int)cudaGetLastError();
}

template <KvFmt F>
int dispatch(const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
             const void* new_ks, const void* new_vs, void* ks_pool, void* vs_pool,
             const void* tables, const void* lengths, const void* write_pos, void* out,
             int B, int H, int K, int HD, int W, int page_size, float scale, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (HD) {
    case 32: return launch<32, F>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool, vs_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s);
    case 64: return launch<64, F>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool, vs_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s);
    case 128: return launch<128, F>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool, vs_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s);
    default: return -1;
  }
}

}  // namespace

// K3. head_dim in {32, 64, 128} and 1 <= H/K <= 8 (checked by the wrapper;
// -1 here otherwise). new_k/new_v may be null when every write_pos is -1.
// Returns cudaGetLastError().
extern "C" int fused_decode_launch(
    const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
    const void* tables, const void* lengths, const void* write_pos, void* out,
    int B, int H, int K, int HD, int W, int page_size, float scale, void* stream) {
  return dispatch<KvFmt::kBf16>(q, new_k, new_v, k_pool, v_pool, nullptr, nullptr, nullptr,
                                nullptr, tables, lengths, write_pos, out, B, H, K, HD, W,
                                page_size, scale, stream);
}

// K5: int8 pools and new rows, f32 scale pools [num_pages, K, page_size] and
// new scales [B, K]; the same shape rules as K3. new_k/new_v/new_ks/new_vs
// may be null when every write_pos is -1.
extern "C" int fused_decode_q_launch(
    const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
    const void* new_ks, const void* new_vs, void* ks_pool, void* vs_pool,
    const void* tables, const void* lengths, const void* write_pos, void* out,
    int B, int H, int K, int HD, int W, int page_size, float scale, void* stream) {
  return dispatch<KvFmt::kInt8>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool,
                                vs_pool, tables, lengths, write_pos, out, B, H, K, HD, W,
                                page_size, scale, stream);
}

// K5, int4 form: nibble-packed pools and new rows [*, K*HD/2] with the same
// scales and rules as K5.
extern "C" int fused_decode_q4_launch(
    const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
    const void* new_ks, const void* new_vs, void* ks_pool, void* vs_pool,
    const void* tables, const void* lengths, const void* write_pos, void* out,
    int B, int H, int K, int HD, int W, int page_size, float scale, void* stream) {
  return dispatch<KvFmt::kInt4>(q, new_k, new_v, k_pool, v_pool, new_ks, new_vs, ks_pool,
                                vs_pool, tables, lengths, write_pos, out, B, H, K, HD, W,
                                page_size, scale, stream);
}
