// K2 and K6: causal chunked-prefill flash attention read in place from the
// paged KV pool.
//
// Replaces: dynamo_tpu/ops/pallas_prefill.py, flash_prefill_attention /
// _kernel, its bf16 branch (K2) and its int8 and int4 branches (K6). Row b's queries
// sit at absolute positions pos0[b] .. pos0[b] + t_valid[b] - 1 and attend
// keys with k_pos <= q_pos through the row's block table; rows at or past
// t_valid are 0. q arrives with rope applied and unscaled; scale hd**-0.5
// is applied here, to q in f32, as the reference does.
//
// K6 reads int8 pools with f32 scale pools [num_pages, K, page_size]
// (ops/quant.py layout). As in the reference the math stays f32 on the
// int8 values: the K scale multiplies the score, the V scale multiplies
// the probability before the P.V product ((p * vs) . v_int8 ==
// p . dequant(v)); the denominator sums the unscaled probabilities. The
// rows are never dequantized to bf16, which would round where the
// reference does not. K6's int4 form reads nibble-packed pools (K*Hd/2
// bytes a row, ops/quant.py planar layout: a head's byte j holds feature j
// in its low nibble and feature j + Hd/2 in its high one) and unpacks
// each code to f32 in registers: low ((b & 15) ^ 8) - 8, high b >> 4 on
// the signed byte. The scales fold in as for int8, and the output is in
// natural feature order.
//
// Bound on the H100: at the engine's shapes (chunks of 512 over a prompt)
// operations dominate: ~2 * 2 * B * H * Hd * T * T / 2 FLOPs against one
// read of q/K/V. This first version runs the two products on the CUDA
// cores in f32 (67 TFLOP/s peak, not the tensor cores' 989), so it sits
// well above the bound; wgmma/TMA tiles are later work.
//
// Design: one block per (query tile, kv head, sequence). The tile holds
// 64 query rows: 64 / G positions times the G query heads that share the
// kv head, so each staged key row serves all of them (GQA). Keys stream
// in chunks of 32 up to the tile's causal limit (chunks above it are never
// loaded); K/V rows are gathered through the block table with 16-byte
// loads into shared memory, in the pool's own bytes (int8 rows are half
// the bytes of bf16 ones, int4 rows a quarter), K rows padded by 16 bytes
// so the score loop's vector reads are free of bank conflicts; K6 also
// stages each key's two scales. An int4 K vector of 16 bytes scores 32
// features: its low nibbles against q's features j.., its high ones
// against j + Hd/2... Each warp owns 16 rows: lane j scores key j for all of them, the
// row max and sum come from warp shuffles, and the probabilities go
// through shared memory to the PV product, where lane l owns features l,
// l+32, ... of the f32 accumulator (for int4, feature f is the low or high
// nibble of byte f mod Hd/2). Scores, running max/denominator and
// accumulator are f32; output bf16. Masking is by absolute position,
// which also hides the garbage tail rows the page-scatter write leaves
// past t_valid in a chunk's last page.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;
constexpr int kKeys = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr float kNegInf = -0.7f * FLT_MAX;

enum class KvFmt { kBf16, kInt8, kInt4 };

// pool element type (bytes for both quantized formats) and the elements of
// one kv head's row
template <KvFmt F>
using kv_t = typename std::conditional<F == KvFmt::kBf16, __nv_bfloat16, int8_t>::type;
template <int HD, KvFmt F>
__host__ __device__ constexpr int row_elems() { return F == KvFmt::kInt4 ? HD / 2 : HD; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the 8 elements of group `h` of a 16-byte vector, widened to f32
// (one group of bf16, two of int8)
__device__ __forceinline__ void unpack8(const uint4& raw, int, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(k2[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack8(const uint4& raw, int h, float* f, const int8_t*) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw) + 8 * h;
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = c[e];
}

// int4: the 8 low (kHi false) or high nibbles of group h of a 16-byte
// vector of packed bytes, sign-extended to f32
template <bool kHi>
__device__ __forceinline__ void unpack8_nib(const uint4& raw, int h, float* f) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw) + 8 * h;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int b = c[e];
    f[e] = kHi ? (float)(b >> 4) : (float)(((b & 15) ^ 8) - 8);
  }
}

// feature d of a kv head's row staged in shared memory, as f32
template <int HD, KvFmt F>
__device__ __forceinline__ float feature(const kv_t<F>* row, int d) {
  if constexpr (F == KvFmt::kBf16) {
    return __bfloat162float(row[d]);
  } else if constexpr (F == KvFmt::kInt8) {
    return row[d];
  } else {
    const int b = row[d % (HD / 2)];
    return d < HD / 2 ? (float)(((b & 15) ^ 8) - 8) : (float)(b >> 4);
  }
}

template <int HD, KvFmt F>
constexpr size_t smem_bytes() {
  constexpr size_t rb = row_elems<HD, F>() * sizeof(kv_t<F>);  // a head's row, bytes
  return (size_t)kRows * HD * 4                                 // q tile, f32, pre-scaled
         + (size_t)kRows * kKeys * 4                            // probabilities
         + (size_t)kKeys * (rb + 16)                            // K chunk (padded rows)
         + (size_t)kKeys * rb                                   // V chunk
         + (F != KvFmt::kBf16 ? 2 * kKeys * 4 : 0);             // the chunk's K and V scales
}

template <int HD, KvFmt F>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, T, H, HD]
    const kv_t<F>* __restrict__ k_pool,        // [slots, K * row_elems]
    const kv_t<F>* __restrict__ v_pool,
    const float* __restrict__ ks_pool,         // [num_pages, K, page_size] (K6)
    const float* __restrict__ vs_pool,
    const int32_t* __restrict__ tables,        // [B, W]
    const int32_t* __restrict__ pos0,          // [B]
    const int32_t* __restrict__ t_valid,       // [B]
    __nv_bfloat16* __restrict__ out,           // [B, T, H, HD]
    int T, int H, int K, int W, int page_size, float scale) {
  using Tkv = kv_t<F>;
  constexpr bool kQuant = F != KvFmt::kBf16;
  constexpr int RE = row_elems<HD, F>();          // a kv head's row, elements
  constexpr int DPL = HD / 32;                    // accumulator features per lane
  constexpr int EPV = 16 / sizeof(Tkv);           // elements per 16-byte vector
  constexpr int KROW = RE + 16 / sizeof(Tkv);     // padded K row, elements
  const int G = H / K;
  const int TQ = kRows / G;
  const int rows = TQ * G;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TQ;
  const int kw = K * RE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tlen = t_valid[b];
  const int p0 = pos0[b];
  const int t_end = min(T, t0 + TQ);
  const int n_valid = max(0, min(tlen, t_end) - t0);

  auto out_at = [&](int r, int d) -> __nv_bfloat16* {
    const int t = t0 + r / G;
    const int h = kh * G + r % G;
    return out + (((long long)b * T + t) * H + h) * HD + d;
  };

  if (n_valid == 0) {  // the whole tile is past t_valid: zeros
    for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
      const int r = idx / HD;
      if (t0 + r / G < T) *out_at(r, idx % HD) = __float2bfloat16(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + kRows * HD;
  Tkv* k_s = reinterpret_cast<Tkv*>(p_s + kRows * kKeys);
  Tkv* v_s = k_s + kKeys * KROW;
  float* ks_s = reinterpret_cast<float*>(v_s + kKeys * RE);  // kQuant only
  float* vs_s = ks_s + kKeys;

  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int t = t0 + r / G;
    float v = 0.f;
    if (r < rows && t < T) {
      const int h = kh * G + r % G;
      v = __bfloat162float(q[(((long long)b * T + t) * H + h) * HD + d]) * scale;
    }
    q_s[idx] = v;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  // causal limit: the tile's last valid query position, plus one
  const int kend = p0 + t0 + n_valid;
  constexpr int VPR = RE / EPV;  // 16-byte vectors per K/V row
  for (int c0 = 0; c0 < kend; c0 += kKeys) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = threadIdx.x; idx < kKeys * VPR; idx += kThreads) {
      const int j = idx / VPR;
      const int vi = idx % VPR;
      const int pos = c0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      float ksc = 0.f, vsc = 0.f;
      if (pos < kend) {
        const int pi = pos / page_size;
        const long long page = pi < W ? tables[(long long)b * W + pi] : 0;
        const long long base = (page * page_size + pos % page_size) * kw + kh * RE;
        kv = reinterpret_cast<const uint4*>(k_pool + base)[vi];
        vv = reinterpret_cast<const uint4*>(v_pool + base)[vi];
        if (kQuant && vi == 0) {
          const long long si = (page * K + kh) * page_size + pos % page_size;
          ksc = ks_pool[si];
          vsc = vs_pool[si];
        }
      }
      *reinterpret_cast<uint4*>(k_s + j * KROW + vi * EPV) = kv;
      *reinterpret_cast<uint4*>(v_s + j * RE + vi * EPV) = vv;
      if (kQuant && vi == 0) {
        ks_s[j] = ksc;
        vs_s[j] = vsc;
      }
    }
    __syncthreads();

    // scores: lane j against key c0 + j, for this warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const Tkv* krow = k_s + lane * KROW;
    // s[i] += q[row i][d .. d+7] . kf[0 .. 7]
    auto dot8 = [&](int d, const float* kf) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + (warp + kWarps * i) * HD + d);
        const float4 a = qr[0];
        const float4 c = qr[1];
        s[i] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3]
              + c.x * kf[4] + c.y * kf[5] + c.z * kf[6] + c.w * kf[7];
      }
    };
#pragma unroll 2
    for (int d0 = 0; d0 < RE; d0 += EPV) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
#pragma unroll
      for (int hh = 0; hh < EPV / 8; ++hh) {
        float kf[8];
        if constexpr (F == KvFmt::kInt4) {  // packed byte j: features j and j + HD/2
          unpack8_nib<false>(raw, hh, kf);
          dot8(d0 + 8 * hh, kf);
          unpack8_nib<true>(raw, hh, kf);
          dot8(HD / 2 + d0 + 8 * hh, kf);
        } else {
          unpack8(raw, hh, kf, krow);
          dot8(d0 + 8 * hh, kf);
        }
      }
    }
    float kscale = 1.f, vscale = 1.f;
    if constexpr (kQuant) {
      kscale = ks_s[lane];
      vscale = vs_s[lane];
    }

    // mask by absolute position, online softmax update
    const int kpos = c0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const int tt = r / G;
      const bool valid = r < rows && tt < n_valid && kpos <= p0 + t0 + tt;
      const float sv = valid ? (kQuant ? s[i] * kscale : s[i]) : kNegInf;
      const float m_new = fmaxf(m_i[i], warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + warp_sum(p);
      m_i[i] = m_new;
      p_s[r * kKeys + lane] = kQuant ? p * vscale : p;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
    }
    __syncwarp();

    // PV: lane owns features lane + 32 * dd
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vf[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) vf[dd] = feature<HD, F>(v_s + j * RE, lane + 32 * dd);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = p_s[(warp + kWarps * i) * kKeys + j];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[i][dd] += p * vf[dd];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= rows || t0 + r / G >= T) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      *out_at(r, lane + 32 * dd) = __float2bfloat16(acc[i][dd] / denom);
    }
  }
}

template <int HD, KvFmt F>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* ks_pool, const void* vs_pool,
           const void* tables, const void* pos0, const void* t_valid, void* out,
           int B, int T, int H, int K, int W, int page_size, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, F>();
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
      (const __nv_bfloat16*)q, (const kv_t<F>*)k_pool, (const kv_t<F>*)v_pool,
      (const float*)ks_pool, (const float*)vs_pool,
      (const int32_t*)tables, (const int32_t*)pos0, (const int32_t*)t_valid,
      (__nv_bfloat16*)out, T, H, K, W, page_size, scale);
  return (int)cudaGetLastError();
}

template <KvFmt F>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* ks_pool, const void* vs_pool,
             const void* tables, const void* pos0, const void* t_valid, void* out,
             int B, int T, int H, int K, int HD, int W, int page_size, float scale,
             void* stream) {
  if (B <= 0 || T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (HD) {
    case 32: return launch<32, F>(q, k_pool, v_pool, ks_pool, vs_pool, tables, pos0, t_valid, out, B, T, H, K, W, page_size, scale, s);
    case 64: return launch<64, F>(q, k_pool, v_pool, ks_pool, vs_pool, tables, pos0, t_valid, out, B, T, H, K, W, page_size, scale, s);
    case 128: return launch<128, F>(q, k_pool, v_pool, ks_pool, vs_pool, tables, pos0, t_valid, out, B, T, H, K, W, page_size, scale, s);
    default: return -1;
  }
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
