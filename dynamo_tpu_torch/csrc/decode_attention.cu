// K3: paged decode attention fused with the new token's KV write.
//
// Replaces: dynamo_tpu/ops/pallas_attention.py,
// fused_paged_decode_attention / _decode_kernel (the bf16 branch), and its
// read-only use paged_decode_attention (write_pos = -1). One query token
// per sequence: if write_pos[b] >= 0 the new K/V row is stored at that
// position's slot, then the query attends lengths[b] keys (the count
// includes the new token). Rows with lengths == 0 output 0. As in the
// reference, q is scaled by hd**-0.5 and rounded to the working type
// before the dot products.
//
// Bound on the H100: bytes. Each step streams every live K/V row once
// (2 * sum(lengths) * K * Hd * 2 bytes) for ~4 FLOPs per byte, far below
// the ~295 FLOP/byte at which the tensor cores would bound it.
//
// Design: one block per (kv head, sequence), 8 warps. Every warp holds
// its kv head's slice of the new row in registers and warp 0 stores it,
// so no two blocks write the same bytes. Each warp then walks every 8th
// key position; a key row (Hd bf16) is one coalesced load across the
// warp, lane l holding features [l*Hd/32, (l+1)*Hd/32). Four keys are
// loaded before any is used, to keep loads in flight. The dot products for the G query heads
// that share the kv head finish with warp shuffles, and each warp keeps
// an f32 online softmax (max, denominator, accumulator) per head. At the
// position being written the kernel uses the new row from registers, not
// a re-read of the pool. The eight warps' partial states are merged through
// shared memory at the end. Splitting long sequences over several blocks
// (flash-decode with a combine pass) is later work: at B = 8 and K = 8
// this launches only 64 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;
constexpr int kUnroll = 4;
constexpr float kNegInf = -0.7f * FLT_MAX;

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

template <int HD>
__global__ void __launch_bounds__(kThreads) fused_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, H, HD]
    const __nv_bfloat16* __restrict__ new_k,   // [B, K*HD] (unused when no write)
    const __nv_bfloat16* __restrict__ new_v,
    __nv_bfloat16* __restrict__ k_pool,        // [num_slots, K*HD]
    __nv_bfloat16* __restrict__ v_pool,
    const int32_t* __restrict__ tables,        // [B, W]
    const int32_t* __restrict__ lengths,       // [B]
    const int32_t* __restrict__ write_pos,     // [B]
    __nv_bfloat16* __restrict__ out,           // [B, H, HD]
    int H, int K, int W, int page_size, float scale) {
  constexpr int DPL = HD / 32;
  const int G = H / K;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int kw = K * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int L = lengths[b];
  const int wpos = write_pos[b];
  const __nv_bfloat16* nk = new_k + (long long)b * kw + kh * HD;
  const __nv_bfloat16* nv = new_v + (long long)b * kw + kh * HD;

  auto slot_of = [&](int pos) -> long long {
    const int pi = pos / page_size;
    const int page = pi < W ? tables[(long long)b * W + pi] : 0;
    return (long long)page * page_size + pos % page_size;
  };

  // this kv head's slice of the new row, held in registers (lane l owns
  // features [l*DPL, (l+1)*DPL)); warp 0 stores it into the pool
  float nkf[DPL], nvf[DPL];
  if (wpos >= 0) {
    load_row<DPL>(nk + lane * DPL, nkf);
    load_row<DPL>(nv + lane * DPL, nvf);
    if (warp == 0) {
      const long long base = slot_of(wpos) * kw + kh * HD + lane * DPL;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        k_pool[base + dd] = __float2bfloat16(nkf[dd]);  // bf16 -> f32 -> bf16 is exact
        v_pool[base + dd] = __float2bfloat16(nvf[dd]);
      }
    }
  }

  float qr[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      load_row<DPL>(q + ((long long)b * H + kh * G + g) * HD + lane * DPL, qr[g]);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd)
        qr[g][dd] = __bfloat162float(__float2bfloat16(qr[g][dd] * scale));
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
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = p0 + u * kWarps;
      if (pos == wpos) {  // the new row, from registers: no re-read of the pool
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          kf[u][dd] = nkf[dd];
          vf[u][dd] = nvf[dd];
        }
      } else if (pos < L) {
        const long long base = slot_of(pos) * kw + kh * HD + lane * DPL;
        load_row<DPL>(k_pool + base, kf[u]);
        load_row<DPL>(v_pool + base, vf[u]);
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
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) o[g][dd] = o[g][dd] * alpha + p * vf[u][dd];
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
    for (int dd = 0; dd < DPL; ++dd) sm_o[warp][g][lane * DPL + dd] = o[g][dd];
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

template <int HD>
int launch(const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
           const void* tables, const void* lengths, const void* write_pos, void* out,
           int B, int H, int K, int W, int page_size, float scale, cudaStream_t stream) {
  dim3 grid((unsigned)K, (unsigned)B);
  fused_decode_kernel<HD><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)new_k, (const __nv_bfloat16*)new_v,
      (__nv_bfloat16*)k_pool, (__nv_bfloat16*)v_pool, (const int32_t*)tables,
      (const int32_t*)lengths, (const int32_t*)write_pos, (__nv_bfloat16*)out,
      H, K, W, page_size, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// head_dim in {32, 64, 128} and 1 <= H/K <= 8 (checked by the wrapper; -1
// here otherwise). new_k/new_v may be null when every write_pos is -1.
// Returns cudaGetLastError().
extern "C" int fused_decode_launch(
    const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
    const void* tables, const void* lengths, const void* write_pos, void* out,
    int B, int H, int K, int HD, int W, int page_size, float scale, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (HD) {
    case 32: return launch<32>(q, new_k, new_v, k_pool, v_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s);
    case 64: return launch<64>(q, new_k, new_v, k_pool, v_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s);
    case 128: return launch<128>(q, new_k, new_v, k_pool, v_pool, tables, lengths, write_pos, out, B, H, K, W, page_size, scale, s);
    default: return -1;
  }
}
