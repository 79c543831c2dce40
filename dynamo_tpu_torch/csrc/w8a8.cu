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
// The row quantization: one kernel template with three prologues, each with
// its own C entry and wrapper (ops/w8a8.py), rows [M, K] bf16 or f32 ->
// codes [M, K] int8 and scales [M] f32 of
//   - quantize_rows: x itself;
//   - rms_norm_quantize_rows: y = rms_norm(x, weight, eps, offset) as
//     ops/norm.py computes it (the sum of squares in f32, var = sum * (1 /
//     K), r = rsqrtf(var + eps), y = (x * r) * (weight + offset), rounded
//     once to x's type), which replaces the norm's ~ten torch ops ahead of
//     the projections of wq/wk/wv and w_gate/w_up;
//   - silu_mul_quantize_rows: y = silu(gate) * up as torch computes it (the
//     SiLU in f32 as g / (1 + expf(-g)) rounded to the type, then the
//     product rounded again), which replaces F.silu and the product ahead
//     of w_down.
// The fused prologues may also write y (a null pointer on the main path;
// the codes are the same either way). Codes and scales are what
// quantize_rows_plain computes from the rows it quantizes: the scale by
// IEEE division (__fdiv_rn(amax, 127), 1.0 for an all-zero row), the codes
// rint of the IEEE quotient (round half to even, as jnp.round) clipped to
// +-127, computed by a product with the scale's reciprocal wherever that
// provably rounds alike (`code_bits`); the build has no --use_fast_math.
// The one sum whose order is the kernel's own is the norm's sum of
// squares, so its y is within a bf16 ulp of torch's and the codes are
// exactly quantize_rows_plain(y).
// Bound: bytes (each input read once, codes and scales written once): 3MK
// from bf16 rows, 5MK for SiLU x up. A row is read once into registers (16-
// byte loads, at most kQVec a thread) and its codes written from there:
//   - a decode row (M <= 64) may be split across a thread block cluster of
//     C blocks (C <= 8, on neighbouring SMs): each block reduces its slice
//     (warp shuffles, then its warps in order), publishes its partial in
//     its own shared memory, and after a cluster barrier reads its peers'
//     through distributed shared memory (mapa + ld.shared::cluster) in rank
//     order, so every block of the row computes the same bytes. The norm
//     exchanges the sum of squares, then every prologue the amax of the
//     rows it quantizes. The exchange costs a launch more than the spread
//     saves for the plain and norm prologues at the 8B widths, so their
//     decode rows take one block (a thread a vector); SiLU x up's expf and
//     division an element repay 8 SMs a row (ops/w8a8.py DECODE_CLUSTER);
//   - a prefill row (M > 64) takes one block of four vectors a thread (C =
//     1 where the row fits 1024 threads x kQVec vectors: 64 KB); the fewer
//     threads a row, the more rows an SM holds in flight.
// ops/w8a8.py `quant_plan` picks C, the vectors a block takes and the
// threads from the shape alone (a graph replay launches what its capture
// planned). Launches are programmatic dependent launches with the cluster
// shape as a second attribute: a kernel signals its dependents at once
// (griddepcontrol.launch_dependents), so the GEMM after it runs its
// prologue early; it reads the norm's weights (no kernel writes them),
// then waits (griddepcontrol.wait) for the kernel before it to complete
// before it reads its rows or writes anything.
//
// w8a8_gemm: codes [M, K] int8 (row-major) x weight codes [N, K] int8
// (K-contiguous: the transpose of the JAX package's [in, out]), xs [M],
// ws [N] -> out [M, N] bf16 or f32. Both operands are K-major, which is
// what wgmma's 8-bit operands must be in shared memory. One kernel
// template; ops/w8a8.py `gemm_plan` picks its instantiation and its split
// of K from the shape alone (a graph replay launches what was captured):
//   - "tiles" (M > 64: prefill and mixed steps; bound: operations, 2MKN at
//     1,979 int8 TOP/s): a 128 x 256 block tile. A producer warpgroup
//     (its registers given to the consumers by setmaxnreg) has one lane
//     issue TMA loads (cp.async.bulk.tensor.2d, 128-byte swizzle) of a
//     128-byte k tile of A (128 rows) and of B (256 rows) into a 4-stage
//     ring of 48 KB stages, each stage a `full` mbarrier (the copies'
//     bytes) and an `empty` one (the consumers' release). Two consumer
//     warpgroups each own 64 rows and run wgmma.mma_async m64n256k32
//     s32.s8.s8 straight from the staged tiles, four k32 steps a stage
//     with the descriptors advanced 32 bytes inside the swizzle row; one
//     wgmma group stays in flight while the next is issued. bf16 outputs
//     leave through shared memory by TMA stores (two 8 KB staging chunks a
//     warpgroup), so a block's stores run while it computes its next tile:
//     the threads' own 4-byte stores had cost a fifth of the time. On an
//     H100 SXM at 700 W the earlier mma.sync kernel reached 24-29 % of the
//     int8 peak at the 8B prefill shapes, this one 58-82 % (PERF.md).
//   - "rows" and "rows_wide" (M <= 64: decode, verify and head rows;
//     bound: bytes, the weights read once at 3.35 TB/s): a 64 x 64 (or,
//     from 8,192 columns on, 64 x 128) block tile whose rows past M are
//     the TMA's zero fill, one consumer warpgroup on m64n64k32 (m64n128k32)
//     and one producer warp, a 6-stage (4-stage) ring of 16 KB (24 KB)
//     stages, two blocks an SM, and K split across blocks until one wave
//     of blocks holds the card, so up to 96-128 KB of weight tiles are in
//     flight on every SM whatever N is (the earlier kernel held a few
//     16-byte loads a lane, and 128 blocks at N 1024). What bounds them
//     now is a launch's ramp and drain, a few microseconds at either end
//     of a stream of 4-59 MB: on the H100 the 525 MB head streams at
//     84 % of the memory rate, the 59 MB projections at ~60 %.
// Every kernel is persistent: `blocks` blocks walk the (row tile, column
// tile, split) work items, row tiles fastest, so a wave of items shares a
// few column tiles of B and A stays in the L2 where it fits (50 MB); the
// ring's stages and phases run on from one item to the next.
// Launches are programmatic dependent launches: a GEMM may start while the
// kernel before it ends, and waits (griddepcontrol.wait) for it before it
// reads A or xs or writes anything; it lets the next launch start at once.
// In a decode graph each GEMM's prologue (barriers, tensor-map prefetch,
// the launch itself) thus overlaps the kernel before it. (ops/w8a8.py PDL
// = False launches them as ordinary launches, for a trace to compare.)
// Split K: every block stores its int32 partial tile (rows < M) in a
// workspace [splits, M, N rounded up to 4], then draws a ticket on its
// tile's counter (atomicAdd after a __threadfence); the last block to draw
// sums the splits' partials with all its threads (eight 16-byte loads in
// flight each) and runs the epilogue, and sets the counter back to 0, so
// the next launch (or a graph replay) finds it ready. Integer sums are
// exact in any order, so the result is the same bytes whatever order the
// splits finish in. The wrapper owns the workspace and counters; the
// kernel allocates nothing.
// Epilogue: (f32(acc) * xs[m]) * ws[n] with __int2float_rn and two
// __fmul_rn, rounded once (__float2bfloat16_rn for bf16), from the
// accumulator fragment (row 16 w + l / 4 (+ 8), columns 8 j + 2 (l % 4)
// (+ 1) for lane l of warp w). Rows past M and columns past N are not
// stored (the TMA store clips them), and an odd N stores single elements.
// TMA covers the ragged edges: rows past M or N and bytes past K (K is a
// multiple of 32, so row strides are multiples of 16 bytes) land as zeros.
// The tensor maps are encoded on the host at each call (A's pointer
// changes every call; `w8a8_encode_us` reports the cost, ~0.2 us for two)
// through cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint so
// that the library links no libcuda, and passed as __grid_constant__
// parameters, so a CUDA-graph capture records them with the launch.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Programmatic dependent launch: a kernel launched with the attribute may
// start while the kernel before it on the stream finishes. It lets the next
// one start (launch_dependents) at once, and waits (wait) for the one before
// it to complete, its memory visible, before it reads what that one may
// write or writes anything itself. Without the attribute both are no-ops.
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ------------------------------------------------------------ row quantization

constexpr int kQThreads = 1024;  // a block's threads at most
constexpr int kQVec = 4;         // 16-byte vectors of a row a thread holds at most
constexpr int kMaxCluster = 8;   // the portable cluster size

enum Prologue { kPlain = 0, kNorm = 1, kSiluMul = 2 };

struct RowArgs {
  const void* x;    // [M, K] the rows (the gate's for kSiluMul)
  const void* aux;  // kNorm: the weight [K]; kSiluMul: the up rows [M, K]
  int8_t* q;        // [M, K] codes
  float* scales;    // [M]
  void* y;          // [M, K] the prologue's rows, or null
  int K;
  int cluster;  // blocks a row
  int per;      // 16-byte vectors of the row each block takes (the last fewer)
  float eps, w_off, inv_k;  // kNorm
};

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

// values already rounded to the type, back into a 16-byte vector
__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (__float_as_uint(f[2 * i]) >> 16) | (__float_as_uint(f[2 * i + 1]) & 0xffff0000u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// f32 -> the activation type -> f32 (round to nearest even)
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// The code of f at scale s: clip(rint(__fdiv_rn(f, s)), -127, 127), its
// value in the low byte of the result. `rs` is __frcp_rn(s) when s > 1e-30
// (else 0): then t = f * rs is within 2.3e-5 of the IEEE quotient (|f / s|
// <= 127.00001; two roundings of 2^-24), so where t lies more than 0.499
// from a half-integer both round to the same integer, which t + 1.5 * 2^23
// rounds to (half to even) in its low bits; the rare rest, and every f of
// a row with a tiny scale, divide. The division, rintf and a float-to-int
// conversion run at a fraction of the FMA rate: at prefill rows they had
// made the kernel compute-bound.
__device__ __forceinline__ uint32_t code_bits(float f, float s, float rs) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23: integers of |t| < 2^22 in the low bits
  const float t = __fmul_rn(f, rs);
  float big = __fadd_rn(t, kMagic);
  if (rs == 0.f || fabsf(__fsub_rn(t, __fsub_rn(big, kMagic))) > 0.499f)
    big = __fadd_rn(fminf(fmaxf(rintf(__fdiv_rn(f, s)), -127.f), 127.f), kMagic);
  return __float_as_uint(big);
}

// four codes, one a byte
__device__ __forceinline__ uint32_t code4(const float* f, float s, float rs) {
  const uint32_t lo = __byte_perm(code_bits(f[0], s, rs), code_bits(f[1], s, rs), 0x0040);
  const uint32_t hi = __byte_perm(code_bits(f[2], s, rs), code_bits(f[3], s, rs), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float at `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float ld_peer(const float* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// The row's sum (kMax false) or max of every thread's `v`: a warp's xor
// shuffles, the block's warps in order, then the cluster's blocks in rank
// order, through `share` (this block's partial) in each block's shared
// memory. Each thread computes the same bytes, in every block of the row.
template <bool kMax>
__device__ __forceinline__ float row_reduce(float v, float* red, float* share, int C) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) t = kMax ? fmaxf(t, red[w]) : t + red[w];
  if (C == 1) return t;
  if (threadIdx.x == 0) *share = t;
  cluster_arrive();
  cluster_wait();
  t = ld_peer(share, 0);
  for (int r = 1; r < C; ++r) {
    const float u = ld_peer(share, r);
    t = kMax ? fmaxf(t, u) : t + u;
  }
  return t;
}

// a row's slice into registers: vector t + i nt of `src` for i < kQVec
template <typename T>
__device__ __forceinline__ void load_slice(uint4 (&v)[kQVec], const void* base, long long at,
                                           int t, int nt, int n) {
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const T*>(base) + at);
#pragma unroll
  for (int i = 0; i < kQVec; ++i)
    if (t + i * nt < n) v[i] = __ldg(src + t + i * nt);
}

// Block (row, rank) of the grid [M * C] (clusters of C blocks along x)
// quantizes vectors [rank * per, ...) of row `row`; thread t holds vectors
// t + i nt (at most kQVec) in registers from the one read to the codes'
// write.
template <int P, typename T>
__global__ void __launch_bounds__(kQThreads) quantize_rows_kernel(const RowArgs a) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte vector
  __shared__ float red[2][kQThreads / 32];  // [reduction][warp]
  __shared__ float share[2];  // this block's partials: the sum of squares, the amax
  const int C = a.cluster;
  const int rank = blockIdx.x % C;  // the block's rank in its cluster (clusters run along x)
  const long long row = blockIdx.x / C;
  const int v0 = rank * a.per;
  const int n = min(a.per, a.K / kPer - v0);  // vectors this block takes (>= 1: the plan)
  const long long base = row * a.K + (long long)v0 * kPer;  // the slice's first element
  const int t = threadIdx.x, nt = blockDim.x;
  const T* tag = nullptr;  // selects the type's overloads
  grid_dep_launch();
  uint4 w[kQVec];
  if constexpr (P == kNorm)  // the weights: no kernel writes them, so before the wait
    load_slice<T>(w, a.aux, v0 * kPer, t, nt, n);
  grid_dep_wait();  // the rows, and every write, after the kernel before
  uint4 xv[kQVec], uv[kQVec];
  load_slice<T>(xv, a.x, base, t, nt, n);
  if constexpr (P == kSiluMul) {
    load_slice<T>(uv, a.aux, base, t, nt, n);
#pragma unroll
    for (int i = 0; i < kQVec; ++i) {
      if (t + i * nt < n) {
        float g[kPer], u[kPer];
        unpack(xv[i], g, tag);
        unpack(uv[i], u, tag);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float act = round_to(__fdiv_rn(g[j], __fadd_rn(1.f, expf(-g[j]))), tag);
          g[j] = round_to(__fmul_rn(act, u[j]), tag);
        }
        xv[i] = pack(g, tag);
      }
    }
  } else if constexpr (P == kNorm) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kQVec; ++i) {
      if (t + i * nt < n) {
        float f[kPer];
        unpack(xv[i], f, tag);
#pragma unroll
        for (int j = 0; j < kPer; ++j) ss += f[j] * f[j];
      }
    }
    const float sum = row_reduce<false>(ss, red[0], &share[0], C);
    const float r = rsqrtf(__fadd_rn(__fmul_rn(sum, a.inv_k), a.eps));
#pragma unroll
    for (int i = 0; i < kQVec; ++i) {
      if (t + i * nt < n) {
        float f[kPer], wf[kPer];
        unpack(xv[i], f, tag);
        unpack(w[i], wf, tag);
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          f[j] = round_to(__fmul_rn(__fmul_rn(f[j], r), __fadd_rn(wf[j], a.w_off)), tag);
        xv[i] = pack(f, tag);
      }
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kQVec; ++i) {
    if (t + i * nt < n) {
      float f[kPer];
      unpack(xv[i], f, tag);
#pragma unroll
      for (int j = 0; j < kPer; ++j) amax = fmaxf(amax, fabsf(f[j]));
    }
  }
  const float m = row_reduce<true>(amax, red[1], &share[1], C);
  // this block has read its peers' partials; it waits for theirs of its
  // own before it exits (its shared memory must outlive their reads)
  if (C > 1) cluster_arrive();
  const float s = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
  const float rs = s > 1e-30f ? __frcp_rn(s) : 0.f;
  if (rank == 0 && t == 0) a.scales[row] = s;
  int8_t* dst = a.q + base;
  uint4* y = a.y ? reinterpret_cast<uint4*>(static_cast<T*>(a.y) + base) : nullptr;
#pragma unroll
  for (int i = 0; i < kQVec; ++i) {
    const int v = t + i * nt;
    if (v < n) {
      float f[kPer];
      unpack(xv[i], f, tag);
      if constexpr (kPer == 8) {
        *reinterpret_cast<uint2*>(dst + v * 8) = make_uint2(code4(f, s, rs), code4(f + 4, s, rs));
      } else {
        *reinterpret_cast<uint32_t*>(dst + v * 4) = code4(f, s, rs);
      }
      if (y) y[v] = xv[i];
    }
  }
  if (C > 1) cluster_wait();
}

// ------------------------------------------------------------ w8a8_gemm

constexpr int kKTile = 128;  // bytes of K a stage holds: one 128-byte swizzle row a row
constexpr int kOutChunk = 64 * 128;  // a staged 64 x 64 bf16 output chunk

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a box of the 2D tensor map at (k byte, row) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// a 64 x 64 bf16 box from shared memory to the output at (column, row);
// the TMA clips what lies past M or N
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          (uint64_t)map),
      "r"(src), "r"(col), "r"(row)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk stores still read shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the TMA's
// 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (the
// stride byte offset), leading byte offset unused (1), layout 1 (SW128).
// The tile starts 1024-byte aligned; a k32 step adds 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// m64nNk32 s32 += s8 x s8, both operands from shared memory
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 256) {
    wgmma_n256(d, da, db);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    static_assert(BN == 64, "block tile widths: 64, 128 and 256");
    wgmma_n64(d, da, db);
  }
}

__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
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

// The last split of a block tile: every consumer thread takes 4-column
// groups of the tile's valid rows, sums the splits' partials (eight loads
// in flight at a time, from L2), and stores (f32(sum) * xs[m]) * ws[n].
template <int BN, int NT, typename OutT>
__device__ __forceinline__ void merge(const int* __restrict__ part, const float* __restrict__ xs,
                                      const float* __restrict__ ws, OutT* __restrict__ out,
                                      int M, int N, int ld, int m0, int rows, int n0,
                                      int splits) {
  constexpr int G = BN / 4;  // 4-column groups a row
  const long long stride = (long long)M * ld;
  for (int e = threadIdx.x; e < rows * G; e += NT) {
    const int r = m0 + e / G, c = n0 + 4 * (e % G);
    if (c >= N) continue;
    const int* p = part + (long long)r * ld + c;
    int sum[4] = {0, 0, 0, 0};
    for (int z0 = 0; z0 < splits; z0 += 8) {
      int4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = z0 + i < splits ? __ldcg(reinterpret_cast<const int4*>(p + (z0 + i) * stride))
                               : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sum[0] += v[i].x;
        sum[1] += v[i].y;
        sum[2] += v[i].z;
        sum[3] += v[i].w;
      }
    }
    const float sx = xs[r];
    OutT* o = out + (long long)r * N + c;
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      if (c + i >= N) break;
      const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(sum[i]), sx), ws[c + i]);
      const bool pair = c + i + 1 < N;
      const float v1 =
          pair ? __fmul_rn(__fmul_rn(__int2float_rn(sum[i + 1]), sx), ws[c + i + 1]) : 0.f;
      if (pair && (N & 1)) {
        store2(o + i, v0, 0.f, false);
        store2(o + i + 1, v1, 0.f, false);
      } else {
        store2(o + i, v0, v1, pair);
      }
    }
  }
}

// C consumer warpgroups (block rows 64 C), block columns BN, S ring stages
template <int C, int BN, int S>
struct Tile {
  static constexpr int kC = C, kBN = BN, kS = S;
  static constexpr int kBM = 64 * C;
  static constexpr int kConsumers = 128 * C;
  // + the producer: a warp, or with two consumer warpgroups a whole
  // warpgroup, which gives its registers to the consumers (setmaxnreg)
  static constexpr bool kRebalance = C == 2;
  static constexpr int kThreads = kConsumers + (kRebalance ? 128 : 32);
  static constexpr int kABytes = kBM * kKTile;
  static constexpr int kStageBytes = kABytes + BN * kKTile;
  // bf16 outputs leave the two-consumer tile by TMA stores, through two
  // 64 x 64 staging chunks (128-byte swizzle) a consumer warpgroup
  static constexpr int kOutBytes = kRebalance ? C * 2 * kOutChunk : 0;
  // the ring (1024-byte aligned by hand), the staging chunks, full[S] and
  // empty[S] barriers, the ticket flag
  static constexpr int kSmem = 1024 + S * kStageBytes + kOutBytes + 2 * S * 8 + 16;
};

// A persistent block walks the work items q = blockIdx.x, + gridDim.x, ...
// of the (row tile, column tile, split) space, row tiles fastest; item q
// is out[M, N]'s block tile at row tile q % mt, column tile q / mt % nt,
// over the k tiles [split * per_split, ...) of split q / (mt * nt). The
// ring's stages and phases run on across items, so the producer fills the
// next item's stages while the consumers store the last one's outputs.
template <int C, int BN, int S, typename OutT>
__global__ void __launch_bounds__(Tile<C, BN, S>::kThreads, C == 1 ? 2 : 1) w8a8_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_out, const float* __restrict__ xs,
    const float* __restrict__ ws, OutT* __restrict__ out, int* __restrict__ part,
    int* __restrict__ counters, int M, int N, int k_tiles, int per_split, int splits,
    int tma_out) {
  using T = Tile<C, BN, S>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t staged = ring + S * T::kStageBytes;
  const uint32_t full = staged + T::kOutBytes, empty = full + 8 * S;
  volatile int* flag = reinterpret_cast<volatile int*>(smem_raw + (empty + 8 * S - raw));
  const int mt = (M + T::kBM - 1) / T::kBM, nt = (N + BN - 1) / BN;
  const int items = mt * nt * splits;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  grid_dep_launch();

  if (warp >= 4 * C) {  // the producer: one lane issues every copy
    if constexpr (T::kRebalance) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == T::kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_a) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_b) : "memory");
      grid_dep_wait();  // A is written by the kernel before
      int g = 0;  // k tiles issued by this block, over all its items
      for (int q = blockIdx.x; q < items; q += gridDim.x) {
        const int m0 = (q % mt) * T::kBM, n0 = (q / mt % nt) * BN;
        const int kt0 = q / (mt * nt) * per_split;
        const int n_k = min(k_tiles, kt0 + per_split) - kt0;
        for (int i = 0; i < n_k; ++i, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(empty + 8 * s, ((g / S) - 1) & 1);  // round g / S - 1 released
          mbar_expect_tx(full + 8 * s, T::kStageBytes);  // whole boxes, zero fill included
          const uint32_t dst = ring + s * T::kStageBytes;
          const int k = (kt0 + i) * kKTile;
          tma_load(dst, &map_a, full + 8 * s, k, m0);
          tma_load(dst + T::kABytes, &map_b, full + 8 * s, k, n0);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows m0 + 64 wg of each block tile, all BN columns
  if constexpr (T::kRebalance) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  grid_dep_wait();  // xs, and every global write, after the kernel before
  const int wg = warp >> 2;
  const int t = threadIdx.x & 127, lane = t & 31;
  int g = 0;  // k tiles consumed by this block, over all its items
  for (int q = blockIdx.x; q < items; q += gridDim.x) {
    const int m0 = (q % mt) * T::kBM, n0 = (q / mt % nt) * BN;
    const int split = q / (mt * nt);
    const int kt0 = split * per_split;
    const int n_k = min(k_tiles, kt0 + per_split) - kt0;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int i = 0; i < n_k; ++i, ++g) {
      const int s = g % S;
      mbar_wait(full + 8 * s, (g / S) & 1);
      const uint32_t a = ring + s * T::kStageBytes + wg * 64 * kKTile;
      const uint32_t b = ring + s * T::kStageBytes + T::kABytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKTile / 32; ++j)
        wgmma_k32<BN>(acc, sw128_desc(a + 32 * j), sw128_desc(b + 32 * j));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (i > 0) mbar_arrive(empty + 8 * ((g - 1) % S));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty + 8 * ((g - 1) % S));  // the item's last stage (n_k >= 1)

    const int r0 = m0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);  // rows r0 and r0 + 8
    const int c0 = n0 + 2 * (lane & 3);                         // columns c0 + 8 j (+ 1)
    if (splits > 1) {
      // split K: store the partial, draw the tile's ticket, the last merges
      const int ld = (N + 3) & ~3;
      int* mine = part + (long long)split * M * ld;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = c0 + 8 * j;
          if (c < N)
            *reinterpret_cast<int2*>(mine + (long long)r * ld + c) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      __threadfence();
      consumers_sync(T::kConsumers);
      if (threadIdx.x == 0) {
        int* ticket = counters + q % (mt * nt);
        const int last = atomicAdd(ticket, 1) == splits - 1;
        if (last) *ticket = 0;  // every split has drawn: ready for the next launch
        *flag = last;
      }
      consumers_sync(T::kConsumers);
      if (*flag) {
        __threadfence();
        merge<BN, T::kConsumers>(part, xs, ws, out, M, N, ld, m0, min(T::kBM, M - m0), n0,
                                 splits);
      }
      continue;
    }

    // the epilogue: (f32(acc) * xs[m]) * ws[n], rounded once to OutT
    if constexpr (T::kOutBytes > 0 && sizeof(OutT) == 2) {
      if (tma_out) {
        // bf16 by TMA stores: each 64-column chunk goes through one of the
        // warpgroup's two staging chunks, written conflict-free in the
        // 128-byte swizzle (16-byte unit j ^ row % 8), then stored while
        // the warpgroup goes on; a chunk is rewritten only once the store
        // that read it two chunks earlier is done reading
        const float sx0 = r0 < M ? xs[r0] : 0.f, sx1 = r0 + 8 < M ? xs[r0 + 8] : 0.f;
        const int rr = (t >> 5) * 16 + (lane >> 2);  // the thread's rows rr, rr + 8 of 64
#pragma unroll
        for (int ch = 0; ch < BN / 64; ++ch) {
          const uint32_t buf = staged + (wg * 2 + (ch & 1)) * kOutChunk;
          if (t == 0) tma_store_wait_read<1>();
          warpgroup_sync(wg);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = ch * 8 + jj, c = c0 + 8 * j;
            const float2 w2 = c + 1 < N ? __ldg(reinterpret_cast<const float2*>(ws + c))
                                        : make_float2(0.f, 0.f);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float sx = h ? sx1 : sx0;
              const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sx), w2.x);
              const float v1 =
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sx), w2.y);
              const __nv_bfloat162 v =
                  __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
              const int row = rr + 8 * h;
              const uint32_t at = buf + row * 128 + ((jj ^ (row & 7)) << 4) + 4 * (lane & 3);
              asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                           "r"(*reinterpret_cast<const uint32_t*>(&v))
                           : "memory");
            }
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          warpgroup_sync(wg);
          if (t == 0) tma_store(&map_out, buf, n0 + 64 * ch, m0 + 64 * wg);
        }
        continue;
      }
    }
    const bool even = (N & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      const float sx = xs[r];
      OutT* row = out + (long long)r * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j;
        if (c >= N) continue;
        const bool pair = c + 1 < N;
        const float2 w2 =
            pair ? __ldg(reinterpret_cast<const float2*>(ws + c)) : make_float2(ws[c], 0.f);
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sx), w2.x);
        const float v1 =
            pair ? __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sx), w2.y) : 0.f;
        if (pair && !even) {
          store2(row + c, v0, 0.f, false);
          store2(row + c + 1, v1, 0.f, false);
        } else {
          store2(row + c, v0, v1, pair);
        }
      }
    }
  }
  if constexpr (T::kOutBytes > 0) {
    if (tma_out && t == 0) tma_store_wait_read<0>();  // the staging chunks outlive the reads
  }
}

// the variants of ops/w8a8.py GEMM_VARIANTS, by id
using Rows = Tile<1, 64, 6>;       // 0: "rows"
using RowsWide = Tile<1, 128, 4>;  // 1: "rows_wide"
using Tiles = Tile<2, 256, 4>;     // 2: "tiles"

// a launch that may start while the kernel before it on the stream ends
// (programmatic stream serialization) when `pdl`, else an ordinary one, in
// clusters of `cluster` blocks along x when that is above 1; the kernels
// wait for the one before them themselves
template <typename... Params, typename... Args>
cudaError_t launch_pdl(bool pdl, void (*kernel)(Params...), dim3 grid, int block, int smem,
                       cudaStream_t stream, int cluster, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n++].val.clusterDim.z = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// one row quantization with prologue P, after checking the plan
// (ops/w8a8.py quant_plan): C blocks a row cover its K / kPer vectors, each
// at least one and at most threads * kQVec
template <int P>
int launch_rows(RowArgs a, int M, int is_bf16, int threads, int pdl, void* stream) {
  if (M <= 0) return 0;
  const int nvec = a.K / (is_bf16 ? 8 : 4);
  const int C = a.cluster;
  if (a.K <= 0 || a.K % 32 || C < 1 || C > kMaxCluster || threads < 32 || threads > kQThreads ||
      threads % 32 || a.per < 1 || a.per > threads * kQVec || (long long)a.per * C < nvec ||
      (long long)(C - 1) * a.per >= nvec || (long long)M * C > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  a.inv_k = 1.f / (float)a.K;
  const dim3 grid(M * C);
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      is_bf16 ? launch_pdl(pdl != 0, quantize_rows_kernel<P, __nv_bfloat16>, grid, threads, 0, s,
                           C, a)
              : launch_pdl(pdl != 0, quantize_rows_kernel<P, float>, grid, threads, 0, s, C, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the 2D map over a row-major [rows, cols] tensor of `elem_bytes`-byte
// elements (int8 codes, or bf16 outputs), boxes of 128 bytes by box_rows
// in the 128-byte swizzle
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
            int elem_bytes = 1) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(kKTile / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T, typename OutT>
int launch(const void* xq, const void* xs, const void* wq, const void* ws, void* out, int M,
           int N, int K, int splits, int blocks, int pdl, void* part, void* counters,
           cudaStream_t stream) {
  constexpr int BN = T::kBN;
  const int k_tiles = (K + kKTile - 1) / kKTile;
  const int per = (k_tiles + splits - 1) / splits;
  // every split holds at least one k tile; a split launch has its buffers
  if (splits < 1 || (splits - 1) * per >= k_tiles || blocks < 1) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const long long items = (long long)((M + T::kBM - 1) / T::kBM) * ((N + BN - 1) / BN) * splits;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b, map_out = {};
  if (!encode(&map_a, xq, M, K, T::kBM) || !encode(&map_b, wq, N, K, BN))
    return (int)cudaErrorInvalidValue;
  // bf16 outputs of an unsplit two-consumer tile by TMA stores (rows of N
  // a multiple of 16 bytes); the rest by the threads' own stores
  const int tma_out = T::kOutBytes > 0 && sizeof(OutT) == 2 && splits == 1 && N % 8 == 0;
  if (tma_out && !encode(&map_out, out, M, N, 64, 2)) return (int)cudaErrorInvalidValue;
  auto kernel = w8a8_gemm_kernel<T::kC, BN, T::kS, OutT>;
  static bool attr = false;  // set once, before any graph capture (the eager run)
  if (!attr) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    // the largest shared-memory carveout, so `resident` blocks fit an SM
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int grid = (int)(items < blocks ? items : blocks);
  const cudaError_t e = launch_pdl(pdl != 0, kernel, dim3(grid), T::kThreads, T::kSmem, stream,
                                   1, map_a, map_b, map_out, (const float*)xs, (const float*)ws,
                                   (OutT*)out, (int*)part, (int*)counters, M, N, k_tiles, per,
                                   splits, tma_out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// blocks of the variant that fit an SM at once (cudaOccupancy...), with
// the launcher's attributes set; -1 for an unknown variant
template <class T>
int occupancy() {
  auto kernel = w8a8_gemm_kernel<T::kC, T::kBN, T::kS, __nv_bfloat16>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, T::kThreads, T::kSmem) !=
      cudaSuccess)
    return -1;
  return n;
}

template <typename OutT>
int gemm(int variant, const void* xq, const void* xs, const void* wq, const void* ws, void* out,
         int M, int N, int K, int splits, int blocks, int pdl, void* part, void* counters,
         cudaStream_t stream) {
  switch (variant) {
    case 0:
      return launch<Rows, OutT>(xq, xs, wq, ws, out, M, N, K, splits, blocks, pdl, part,
                                counters, stream);
    case 1:
      return launch<RowsWide, OutT>(xq, xs, wq, ws, out, M, N, K, splits, blocks, pdl, part,
                                    counters, stream);
    case 2:
      return launch<Tiles, OutT>(xq, xs, wq, ws, out, M, N, K, splits, blocks, pdl, part,
                                 counters, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The row quantizations. Rows [M, K] (bf16 when is_bf16, else f32), K a
// multiple of 32, every pointer 16-byte aligned, the tensors contiguous
// (the Python wrappers check these); `cluster`, `per` and `threads` from
// ops/w8a8.py quant_plan; `pdl` makes the launch a programmatic dependent
// one (ops/w8a8.py PDL). Each returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int quantize_rows_launch(const void* x, void* q, void* scales, int M, int K,
                                    int is_bf16, int cluster, int per, int threads, int pdl,
                                    void* stream) {
  RowArgs a = {x, nullptr, (int8_t*)q, (float*)scales, nullptr, K, cluster, per, 0.f, 0.f, 0.f};
  return launch_rows<kPlain>(a, M, is_bf16, threads, pdl, stream);
}

// codes and scales of rms_norm(x, weight [K] of x's type, eps, w_off); `y`
// null, or [M, K] of x's type for the normed rows
extern "C" int rms_norm_quantize_rows_launch(const void* x, const void* weight, void* q,
                                             void* scales, void* y, int M, int K, int is_bf16,
                                             float eps, float w_off, int cluster, int per,
                                             int threads, int pdl, void* stream) {
  RowArgs a = {x, weight, (int8_t*)q, (float*)scales, y, K, cluster, per, eps, w_off, 0.f};
  return launch_rows<kNorm>(a, M, is_bf16, threads, pdl, stream);
}

// codes and scales of silu(gate) * up, both [M, K] of one type; `y` null, or
// [M, K] of that type for the product
extern "C" int silu_mul_quantize_rows_launch(const void* gate, const void* up, void* q,
                                             void* scales, void* y, int M, int K, int is_bf16,
                                             int cluster, int per, int threads, int pdl,
                                             void* stream) {
  RowArgs a = {gate, up, (int8_t*)q, (float*)scales, y, K, cluster, per, 0.f, 0.f, 0.f};
  return launch_rows<kSiluMul>(a, M, is_bf16, threads, pdl, stream);
}

// xq [M, K] int8, wq [N, K] int8, xs [M] and ws [N] f32, out [M, N] (bf16
// when out_bf16, else f32); K a multiple of 32, the codes 16-byte aligned
// and out 4-byte aligned. `variant`, `splits` and `blocks` (the persistent
// grid) come from ops/w8a8.py `gemm_plan`; `pdl` makes the launch a
// programmatic dependent one (ops/w8a8.py PDL); with splits > 1, `part` holds
// splits * M * N4 int32 (N4: N rounded up to 4) and `counters` one zeroed
// int32 a block tile (the kernel leaves them zero). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan or shape the
// kernel does not take (or a tensor map that does not encode).
extern "C" int w8a8_gemm_launch(const void* xq, const void* xs, const void* wq, const void* ws,
                                void* out, int M, int N, int K, int out_bf16, int variant,
                                int splits, int blocks, int pdl, void* part, void* counters,
                                void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    return gemm<__nv_bfloat16>(variant, xq, xs, wq, ws, out, M, N, K, splits, blocks, pdl, part,
                               counters, s);
  return gemm<float>(variant, xq, xs, wq, ws, out, M, N, K, splits, blocks, pdl, part, counters,
                     s);
}

// Blocks of GEMM variant `variant` that fit one SM at once (what the
// plan's `resident` assumes), or -1.
extern "C" int w8a8_occupancy(int variant) {
  switch (variant) {
    case 0:
      return occupancy<Rows>();
    case 1:
      return occupancy<RowsWide>();
    case 2:
      return occupancy<Tiles>();
    default:
      return -1;
  }
}

// The host's cost of one call's two tensor maps: the mean microseconds of
// `iters` encodings of A's and B's maps at these shapes (no device work).
// Returns a negative number when a map does not encode.
extern "C" double w8a8_encode_us(const void* xq, const void* wq, int M, int N, int K, int iters) {
  CUtensorMap a, b;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (!encode(&a, xq, M, K, Tiles::kBM) || !encode(&b, wq, N, K, 256)) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / (iters > 0 ? iters : 1);
}
