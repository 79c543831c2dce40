// W8A8: per-token activation quantization and the s8 x s8 -> s32 GEMM with
// its dequantization fused in the epilogue.
//
// Replaces: dynamo_tpu/ops/quant.py, quant_matmul (:60-77), which XLA
// compiles into fused ops (an absmax reduction, the division and rounding
// of the codes, lax.dot_general with preferred_element_type=int32, and the
// two scale products); no pl.pallas_call is involved. The scheme
// (ops/quant.py): a row's scale is s = amax / 127 (1.0 for an all-zero
// row), its codes clip(round(x / s), -127, 127); the dot is exact in int32
// (127 * 127 * K < 2**31 for K < 133,144); the output is
// (f32(acc) * xs[m]) * ws[n], rounded once to the output type.
//
// quantize_rows: x [M, K] bf16 or f32 -> codes [M, K] int8, scales [M]
// f32. One block a row: a pass of 16-byte loads for the absmax (a warp
// shuffle, then the block's warps), the scale by IEEE division, and a
// second pass over the same row (an L1/L2 hit) for the codes. The build
// has no --use_fast_math, so `__fdiv_rn` is the true division and `rintf`
// rounds half to even, as jnp.round does: codes and scales are the bytes
// the plain version computes. Bound: bytes (reads x once, writes the
// codes and a scale a row): 3 * M * K bytes from bf16.
//
// w8a8_gemm: codes [M, K] int8 (row-major) x weight codes [N, K] int8
// (K-contiguous: the transpose of the JAX package's [in, out], because
// mma.sync's s8 B operand is K-major and ldmatrix .trans takes only 16-bit
// elements on sm_90), xs [M], ws [N] -> out [M, N] bf16 or f32. Warps run
// mma.sync.m16n8k32 s8 -> s32 on 16 x 8 output tiles. A dot product may
// take its k in any order, so lane (g, t) loads bytes [16t, 16t + 16) of a
// 64-wide k step for A rows g and g + 8 and for B column g, and feeds
// words 0-1 of them to one mma and words 2-3 to the next, the same k for A
// and B: 16-byte loads with no ldmatrix. Rows past M and columns past N
// load zeros and store nothing; integer sums are exact in any order. The
// epilogue computes (f32(acc) * xs[m]) * ws[n] with __int2float_rn and
// __fmul_rn and rounds once (__float2bfloat16_rn for bf16). Two kernels:
//   - M <= 64 (decode rows, verify rows, heads): a block is one 16 x 8
//     tile whose eight warps split K and sum through shared memory;
//     fragments come straight from global memory (A stays in L1), and a
//     K % 64 == 32 tail takes one k32 step of 8-byte loads. ceil(N / 8) x
//     ceil(M / 16) blocks. Bound: bytes, the weights read once (N * K at
//     3.35 TB/s: 17.5 us for the 8B model's w_gate).
//   - M > 64 (prefill and mixed steps): a 128 x 128 block tile, its k
//     tiles staged through a 3-stage cp.async ring in shared memory
//     (zero-filled past M, N and K), eight warps of 64 x 32. Bound:
//     operations, 2 * M * N * K at 1,979 int8 TOPS.
// Neither uses TMA or wgmma (PERF.md and ROADMAP list the follow-ups).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ quantize_rows

constexpr int kQThreads = 256;

__device__ __forceinline__ void unpack(const uint4& v, float* f, const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& v, float* f, const float*) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ uint32_t code4(const float* f, float s) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = fminf(fmaxf(rintf(__fdiv_rn(f[i], s)), -127.f), 127.f);
    out |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * i);
  }
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kQThreads) quantize_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales, int K) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte vector
  __shared__ float red[kQThreads / 32];
  __shared__ float scale_s;
  const long long row = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + row * K);
  const int nvec = K / kPer;
  float amax = 0.f;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float f[kPer];
    unpack(__ldg(src + v), f, x);
#pragma unroll
    for (int i = 0; i < kPer; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
    const float s = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
    scale_s = s;
    scales[row] = s;
  }
  __syncthreads();
  const float s = scale_s;
  int8_t* dst = q + row * K;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float f[kPer];
    unpack(__ldg(src + v), f, x);
    if constexpr (kPer == 8) {
      uint2 out = make_uint2(code4(f, s), code4(f + 4, s));
      *reinterpret_cast<uint2*>(dst + v * 8) = out;
    } else {
      *reinterpret_cast<uint32_t*>(dst + v * 4) = code4(f, s);
    }
  }
}

// ------------------------------------------------------------ w8a8_gemm

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* out, float v0, float v1, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
  } else {
    out[0] = v0;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, float v0, float v1, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(out) =
        __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
  } else {
    out[0] = __float2bfloat16_rn(v0);
  }
}

// (f32(acc) * xs[m]) * ws[n], rounded once to OutT, for a warp's MT x NT
// tiles at (m0, n0); rows past M and columns past N are not stored.
template <int MT, int NT, typename OutT>
__device__ __forceinline__ void epilogue(const int (&acc)[MT][NT][4], int m0, int n0, int g,
                                         int t, const float* __restrict__ xs,
                                         const float* __restrict__ ws, OutT* __restrict__ out,
                                         int M, int N) {
  const bool even = (N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mt * 16 + h * 8 + g;
      if (r >= M) continue;
      const float sx = xs[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = n0 + nt * 8 + 2 * t;
        if (c >= N) continue;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h]), sx), ws[c]);
        const bool pair = c + 1 < N;
        const float v1 = pair ? __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), sx),
                                          ws[c + 1])
                              : 0.f;
        OutT* o = out + (long long)r * N + c;
        if (pair && !even) {
          store2(o, v0, 0.f, false);
          store2(o + 1, v1, 0.f, false);
        } else {
          store2(o, v0, v1, pair);
        }
      }
    }
}

// The M <= 64 kernel: block (bx, by) owns the 16 x 8 tile at rows 16 by,
// columns 8 bx; its kSplit warps take equal runs of the 64-wide k steps,
// and warp 0 sums the others' tiles through shared memory. (Tiles of 16
// or 32 columns, which read A from L2 a half or a quarter as often, and
// batches of 8 k steps with all their loads in flight, were no faster on
// the card at the 8B shapes.)
constexpr int kSplit = 8;

template <typename OutT>
__global__ void __launch_bounds__(32 * kSplit) w8a8_gemm_rows_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ wq, const float* __restrict__ ws, OutT* __restrict__ out,
    int M, int N, int K) {
  const int wk = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * 16, n0 = blockIdx.x * 8;
  // the rows and the column this lane loads (nullptr past M or N: zeros)
  const int8_t* a_lo = m0 + g < M ? xq + (long long)(m0 + g) * K : nullptr;
  const int8_t* a_hi = m0 + g + 8 < M ? xq + (long long)(m0 + g + 8) * K : nullptr;
  const int8_t* b_col = n0 + g < N ? wq + (long long)(n0 + g) * K : nullptr;
  int acc[1][1][4] = {{{0, 0, 0, 0}}};
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  const int steps = K >> 6;
  const int per = (steps + kSplit - 1) / kSplit;
  const int s_end = min(steps, (wk + 1) * per);
#pragma unroll 2
  for (int s = wk * per; s < s_end; ++s) {
    const int kb = (s << 6) + (t << 4);
    const uint4 lo = a_lo ? __ldg(reinterpret_cast<const uint4*>(a_lo + kb)) : zero4;
    const uint4 hi = a_hi ? __ldg(reinterpret_cast<const uint4*>(a_hi + kb)) : zero4;
    const uint4 b = b_col ? __ldg(reinterpret_cast<const uint4*>(b_col + kb)) : zero4;
    mma_s8(acc[0][0], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
    mma_s8(acc[0][0], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
  }
  if ((K & 63) && wk == kSplit - 1) {
    // the k32 tail: lane (g, t) takes bytes [8t, 8t + 8)
    const int kb = (steps << 6) + (t << 3);
    const uint2 zero2 = make_uint2(0, 0);
    const uint2 lo = a_lo ? __ldg(reinterpret_cast<const uint2*>(a_lo + kb)) : zero2;
    const uint2 hi = a_hi ? __ldg(reinterpret_cast<const uint2*>(a_hi + kb)) : zero2;
    const uint2 b = b_col ? __ldg(reinterpret_cast<const uint2*>(b_col + kb)) : zero2;
    mma_s8(acc[0][0], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  }

  __shared__ int part[kSplit - 1][4][32];
  if (wk > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) part[wk - 1][i][lane] = acc[0][0][i];
  }
  __syncthreads();
  if (wk > 0) return;
#pragma unroll
  for (int w = 0; w < kSplit - 1; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][0][i] += part[w][i][lane];
  epilogue<1, 1>(acc, m0, n0, g, t, xs, ws, out, M, N);
}

// The M > 64 kernel: a 128 x 128 block tile staged through shared memory.
// Each k tile (64 bytes of K) of A and B lands by 16-byte cp.async in a
// ring of kStages stages, zero-filled past M, N and K; 8 warps (2 x 4) each
// own a 64 x 32 tile and read their fragments from the stage with 16-byte
// loads in the same k order as above (rows of 64 bytes: the 8 lanes of a
// load phase read two rows, 128 contiguous bytes, no bank conflict).
constexpr int kTile = 128, kStages = 3, kTileThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

template <typename OutT>
__global__ void __launch_bounds__(kTileThreads, 2) w8a8_gemm_tiled_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ wq, const float* __restrict__ ws, OutT* __restrict__ out,
    int M, int N, int K) {
  constexpr int MT = 4, NT = 4;  // a warp's 64 x 32 tile
  __shared__ __align__(128) int8_t stage[kStages][2][kTile * 64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int bm = blockIdx.y * kTile, bn = blockIdx.x * kTile;
  const int tiles = (K + 63) >> 6;

  // this thread's two 16-byte chunks of each operand's tile
  auto load = [&](int s, int kt) {
    const int k0 = kt << 6;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + i * kTileThreads;  // chunk: row c / 4, bytes 16 (c % 4)
      const int row = c >> 2, kb = k0 + ((c & 3) << 4);
      const bool kin = kb < K;
      const int ra = bm + row, rb = bn + row;
      cp_async16(&stage[s][0][c * 16], ra < M && kin ? xq + (long long)ra * K + kb : xq,
                 ra < M && kin);
      cp_async16(&stage[s][1][c * 16], rb < N && kin ? wq + (long long)rb * K + kb : wq,
                 rb < N && kin);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < tiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1's stage
    const int next = kt + kStages - 1;
    if (next < tiles) load(next % kStages, next);
    asm volatile("cp.async.commit_group;\n" ::);
    const int8_t* a_s = stage[kt % kStages][0];
    const int8_t* b_s = stage[kt % kStages][1];
    uint4 b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      b[nt] = *reinterpret_cast<const uint4*>(b_s + (wn * 32 + nt * 8 + g) * 64 + t * 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wm * 64 + mt * 16 + g;
      const uint4 a0 = *reinterpret_cast<const uint4*>(a_s + r * 64 + t * 16);
      const uint4 a1 = *reinterpret_cast<const uint4*>(a_s + (r + 8) * 64 + t * 16);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_s8(acc[mt][nt], a0.x, a1.x, a0.y, a1.y, b[nt].x, b[nt].y);
        mma_s8(acc[mt][nt], a0.z, a1.z, a0.w, a1.w, b[nt].z, b[nt].w);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  epilogue<MT, NT>(acc, bm + wm * 64, bn + wn * 32, g, t, xs, ws, out, M, N);
}

template <typename OutT>
int gemm(const void* xq, const void* xs, const void* wq, const void* ws, void* out, int M,
         int N, int K, cudaStream_t stream) {
  const int8_t* a = (const int8_t*)xq;
  const int8_t* b = (const int8_t*)wq;
  const float* sa = (const float*)xs;
  const float* sb = (const float*)ws;
  OutT* o = (OutT*)out;
  if (M <= 64) {
    dim3 grid((N + 7) / 8, (M + 15) / 16);
    w8a8_gemm_rows_kernel<OutT><<<grid, 32 * kSplit, 0, stream>>>(a, sa, b, sb, o, M, N, K);
  } else {
    dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    w8a8_gemm_tiled_kernel<OutT><<<grid, kTileThreads, 0, stream>>>(a, sa, b, sb, o, M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (bf16 when is_bf16, else f32), K a multiple of 32, every
// pointer 16-byte aligned (the Python wrapper checks both). Returns
// cudaGetLastError().
extern "C" int quantize_rows_launch(const void* x, void* q, void* scales, int M, int K,
                                    int is_bf16, void* stream) {
  if (M <= 0) return 0;
  const int nvec = K / (is_bf16 ? 8 : 4);
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kQThreads ? kQThreads : threads);
  if (is_bf16) {
    quantize_rows_kernel<__nv_bfloat16><<<M, threads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)scales, K);
  } else {
    quantize_rows_kernel<float><<<M, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)q, (float*)scales, K);
  }
  return (int)cudaGetLastError();
}

// xq [M, K] int8, wq [N, K] int8, xs [M] and ws [N] f32, out [M, N] (bf16
// when out_bf16, else f32); K a multiple of 32, the codes 16-byte aligned
// and out 4-byte aligned. Returns cudaGetLastError(), or cudaErrorInvalidValue for an M
// the grid does not take.
extern "C" int w8a8_gemm_launch(const void* xq, const void* xs, const void* wq, const void* ws,
                                void* out, int M, int N, int K, int out_bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (out_bf16) return gemm<__nv_bfloat16>(xq, xs, wq, ws, out, M, N, K, (cudaStream_t)stream);
  return gemm<float>(xq, xs, wq, ws, out, M, N, K, (cudaStream_t)stream);
}
