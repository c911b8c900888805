// e4m3 x e4m3 -> f32 matrix product for Hopper (sm_90a), with or without
// per-128x128-tile scales.
//
// Replaces the two Pallas TPU kernels of repro/kernels/fp8_matmul.py:
//   fp8_matmul          (_mm_kernel):      out = x @ w, no scale (the
//                        recipe's scalar scales stay outside, in
//                        repro_torch.precision.fp8.fp8_matmul);
//   fp8_matmul_tile128  (_mm_tile_kernel): out = sum over 128-deep K blocks
//                        ki of sx[mi,ki] * sw[ki,ni] * (x_blk @ w_blk), the
//                        DeepSeek-V3 recipe.  The scale varies along K, so
//                        it is applied to each block's f32 partial inside
//                        the K loop and cannot be folded outside.
// x is (M,K) row-major e4m3, w is (K,N) row-major e4m3 (the reference's
// layouts: no transpose), out is (M,N) row-major f32.  sx is (M/128, K/128)
// and sw (K/128, N/128), both row-major f32.
//
// Bound.  At the main path's shapes (M = 8192 tokens, K x N = 512 x 2048 or
// 2048 x 512) the f32 output dominates the bytes: 72 MB or 35 MB, 22 or 10
// us at 3.35 TB/s, against 9 us of fp8 tensor-core work.  This first kernel
// runs on the f32 FMA units (67 TFLOP/s), not the fp8 tensor cores, so it
// is bound by its own FMA rate, far above the card's bound; fp8 wgmma with
// TMA is the later redesign.
//
// Design.  One thread block of 256 threads owns one 128 x 128 output tile
// and walks K in steps of 32.  Each step stages a 128 x 32 slice of x and a
// 32 x 128 slice of w from device memory with one 16-byte load per thread
// each (prefetched into registers one step ahead), converts the e4m3 bytes
// to f32 (exact) with the hardware's e4m3x2 -> f16x2 conversion, and stores
// them to shared memory: x transposed, so both operands are read as float4
// rows.  Each thread accumulates an 8 x 8 sub-tile in f32 registers.  With
// TILE_SCALED, four steps make one 128-deep K block: their sum is kept in a
// second set of registers and added to the accumulator as
// acc + (sx * sw) * partial, rounded as the TPU kernel rounds it.  No
// split-K and no atomics: each output element is summed by one thread in a
// fixed order, so two launches give bit-identical results.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output tile rows (one scale tile with TILE_SCALED)
constexpr int kBN = 128;      // output tile columns
constexpr int kBK = 32;       // K step staged in shared memory
constexpr int kTile = 128;    // scale tile
constexpr int kThreads = 256;

// 16 e4m3 bytes -> 16 floats (exact: every e4m3 value is an f16 value)
__device__ __forceinline__ void unpack16(const uint4 v, float* f) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(words[i] & 0xffffu), __NV_E4M3);
    const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(words[i] >> 16), __NV_E4M3);
    const float2 a = __half22float2(__half2(lo));
    const float2 b = __half22float2(__half2(hi));
    f[4 * i + 0] = a.x;
    f[4 * i + 1] = a.y;
    f[4 * i + 2] = b.x;
    f[4 * i + 3] = b.y;
  }
}

// The 16 bytes at p, of which the first `valid` exist (the rest read as 0,
// which is +0 in e4m3).  One 16-byte load when all 16 exist and p is
// 16-byte aligned (`vec`), else byte loads.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p,
                                        int valid, bool vec) {
  if (vec && valid >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && i < valid; ++i)
    w[i >> 2] |= static_cast<uint32_t>(p[i]) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool TILE_SCALED>
__global__ void __launch_bounds__(kThreads)
fp8_mm(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
       const float* __restrict__ sx, const float* __restrict__ sw,
       float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float xs[kBK][kBM];   // x slice, transposed
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // staging: x row xr, K bytes [xc, xc+16) of the step; w row wr, columns
  // [wc, wc+16).  A warp's x rows are consecutive, so its transposed
  // shared-memory stores hit 32 banks.
  const int xr = tid & (kBM - 1), xc = (tid >> 7) * 16;
  const int wr = tid >> 3, wc = (tid & 7) * 16;
  const bool xvec = (K % 16) == 0, wvec = (N % 16) == 0;
  const uint8_t* xrow = x + static_cast<long long>(m0 + xr) * K;
  const int wcols = N - (n0 + wc);

  auto load_x = [&](int k0) {
    const int valid = (m0 + xr < M) ? K - (k0 + xc) : 0;
    return load16(xrow + k0 + xc, valid, xvec);
  };
  auto load_w = [&](int k0) {
    const int valid = (k0 + wr < K) ? wcols : 0;
    return load16(w + static_cast<long long>(k0 + wr) * N + n0 + wc, valid,
                  wvec);
  };

  // compute: rows {ty*4 + i, 64 + ty*4 + i}, columns {tx*4 + j, 64 + tx*4 + j}
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nsteps = (K + kBK - 1) / kBK;
  const int steps_per_tile = kTile / kBK;
  uint4 xa = load_x(0), wa = load_w(0);
  for (int s = 0; s < nsteps; ++s) {
    {
      float f[16];
      unpack16(xa, f);
#pragma unroll
      for (int j = 0; j < 16; ++j) xs[xc + j][xr] = f[j];
      unpack16(wa, f);
      const float4 v[4] = {make_float4(f[0], f[1], f[2], f[3]),
                           make_float4(f[4], f[5], f[6], f[7]),
                           make_float4(f[8], f[9], f[10], f[11]),
                           make_float4(f[12], f[13], f[14], f[15])};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // rotate the four float4 stores so a quarter warp hits 32 banks;
        // selects, not a dynamic index, keep v in registers
        const int jj = (q + (tid >> 1)) & 3;
        const float4 u = jj == 0 ? v[0] : jj == 1 ? v[1] : jj == 2 ? v[2] : v[3];
        *reinterpret_cast<float4*>(&ws[wr][wc + 4 * jj]) = u;
      }
    }
    __syncthreads();
    if (s + 1 < nsteps) {             // next step's loads fly during the FMAs
      xa = load_x((s + 1) * kBK);
      wa = load_w((s + 1) * kBK);
    }
    if (TILE_SCALED && s % steps_per_tile == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (TILE_SCALED)
            part[i][j] = fmaf(a[i], b[j], part[i][j]);
          else
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
    if (TILE_SCALED && s % steps_per_tile == steps_per_tile - 1) {
      const int ki = s / steps_per_tile;
      const float sc = __fmul_rn(sx[blockIdx.y * (K / kTile) + ki],
                                 sw[ki * (N / kTile) + blockIdx.x]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(sc, part[i][j]));
    }
    __syncthreads();
  }

  const bool ovec = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
    float* orow = out + static_cast<long long>(r) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * 64 + tx * 4;
      if (ovec && c + 4 <= N) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) orow[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

}  // namespace

// x: M*K e4m3 bytes, w: K*N e4m3 bytes, out: M*N f32, all 16-byte aligned.
// tile_scaled != 0 needs M, N, K multiples of 128 and the compact scales sx
// ((M/128)*(K/128) f32) and sw ((K/128)*(N/128) f32); otherwise sx and sw
// are not read.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int repro_fp8_matmul(const uint8_t* x, const uint8_t* w,
                                const float* sx, const float* sw, float* out,
                                int M, int N, int K, int tile_scaled,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (tile_scaled)
    fp8_mm<true><<<grid, kThreads, 0, st>>>(x, w, sx, sw, out, M, N, K);
  else
    fp8_mm<false><<<grid, kThreads, 0, st>>>(x, w, sx, sw, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
