// Online-softmax GQA attention, forward only, f32, on the FMA units of
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention.py
// (_flash_kernel, called at flash_attention.py:110) for f32 q, k and v;
// bf16 runs on the TMA + wgmma kernel of flash_attention_wgmma.cu.  It
// computes the same function: scores q.k * (1/sqrt(D)) in f32, masked
// entries at -1e30, a running max m, denominator l and accumulator acc in
// f32 over kv tiles in ascending order, and out = acc / max(l, 1e-30).
// Query head h reads kv head h / (H / Hkv): KV is never repeated.  Modes:
// causal (k <= q), swa (k <= q and k > q - window) and bidirectional.
//
// q is (B,S,H,D) and k, v are (B,S,Hkv,D), f32, read in place through
// their (b, s, h) strides (the head dim has stride 1 and every row starts
// on a 4-element boundary); out is (B,S,H,D) contiguous.  No transposes to
// (B*H, S, D), as the TPU wrapper makes.
//
// Bound and why f32 stays here.  Both products run on the f32 FMA units
// (67 TFLOP/s), as the TPU kernel upcasts and takes f32 dots: the kernel
// is bound by that rate.  TF32 wgmma would be faster but keeps about
// three decimal digits, and the f32 check holds the result within 2e-5 of
// float64; nothing on the card's check paths runs attention in f32.
//
// Design.  One thread block of 256 threads owns one 64-row q tile of one
// (b, h) and loops over 64-row kv tiles, skipping the tiles the mask
// empties for the whole q tile.  q, k and v are staged in shared memory
// (119 KB at D 128, so dynamic shared memory), and the 64 x 64
// probabilities go through shared memory between the two products.
// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16i and score columns
// tx + 16j (i, j < 4), and the output columns of the float4 groups tx +
// 16u of a row's D / 4: at D 64 columns [4tx, 4tx+4), at D 128 also those
// + 64; at D 80 and 112 (20 and 28 groups) the second group only for tx <
// 4 and tx < 12, the rest of the half-warp idle for it.  A row's 16
// threads sit in one half-warp, so its max and sum are shuffles.
// A masked entry's probability is set to 0 itself: a row whose first
// tiles are all masked keeps l = 0 and acc = 0 rather than junk that a
// later alpha = 0 would have to wipe, so the result does not rely on the
// tile order.  No atomics and no split over kv: each output element comes
// from one thread in a fixed order, so two launches give identical bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;
constexpr int kPad = 4;          // q/k/v row pitch D + 4: float4 aligned, no
                                 // bank conflicts on the k column reads
constexpr int kLP = kBK + 16;    // probability row pitch
constexpr float kNegInf = -1e30f;

enum Mode { kCausal = 0, kSwa = 1, kBidirectional = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, H, Hkv;
  long long qs[3], ks[3], vs[3];   // (b, s, h) strides in elements
  int mode, window;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 f) {
  *reinterpret_cast<float4*>(p) = f;
}

// rows [r0, r0 + 64) of one head (row stride `rs`) into tile[64][D + kPad];
// rows at or past S read as 0
template <int D>
__device__ __forceinline__ void stage(float* tile, const float* base,
                                      long long rs, int r0, int S) {
  constexpr int kGroups = D / 4;
  for (int g = threadIdx.x; g < kBQ * kGroups; g += kThreads) {
    const int r = g / kGroups, c = (g % kGroups) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) f = load4(base + (r0 + r) * rs + c);
    store4(tile + r * (D + kPad) + c, f);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  constexpr int LD = D + kPad;
  constexpr int kG4 = D / 4;       // float4 groups of a row
  constexpr int NU = (kG4 + 15) / 16;   // float4 output groups per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + kBQ * LD;
  float* vt = kt + kBK * LD;
  float* pt = vt + kBK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the groups tx + 16u this thread owns: all NU at D 64 and 128
  const int n_own = kG4 % 16 == 0 ? NU : (kG4 - tx + 15) / 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hkv);
  // the heaviest causal q tiles first, so the last wave is short
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const float* qg = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.ks[0] + hk * p.ks[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.vs[0] + hk * p.vs[2];

  stage<D>(qt, qg, p.qs[1], q0, p.S);

  // the kv tiles with at least one unmasked entry for some row of the tile
  const int q_last = min(q0 + kBQ, p.S) - 1;
  int t_lo = 0, t_hi = (p.S + kBK - 1) / kBK;
  if (p.mode != kBidirectional) t_hi = q_last / kBK + 1;
  if (p.mode == kSwa) t_lo = max(0, q0 - p.window + 1) / kBK;

  float m[4], l[4], acc[4][4 * NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NU; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();               // the previous tile's k, v and p are read
    stage<D>(kt, kg, p.ks[1], k0, p.S);
    stage<D>(vt, vg, p.vs[1], k0, p.S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(qt + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = load4(kt + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < p.S &&
                (p.mode == kBidirectional ||
                 (kp <= qp && (p.mode != kSwa || kp > qp - p.window)));
        s[i][j] = ok[j] ? s[i][j] * p.scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        pt[(ty + 16 * i) * kLP + tx + 16 * j] = pij;
        ps += pij;
      }
      l[i] = l[i] * alpha + half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NU; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(pt + (ty + 16 * i) * kLP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          if (u >= n_own) continue;
          const float4 w = load4(vt + (c + cc) * LD + 64 * u + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pa = cc == 0 ? a[i].x : cc == 1 ? a[i].y
                           : cc == 2 ? a[i].z : a[i].w;
            acc[i][4 * u + 0] = fmaf(pa, w.x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = fmaf(pa, w.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(pa, w.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(pa, w.w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }

  float* og = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = og + ((static_cast<long long>(b) * p.S + r) * p.H + h) * D;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (u < n_own)
        store4(orow + 64 * u + 4 * tx,
               make_float4(acc[i][4 * u + 0] / den, acc[i][4 * u + 1] / den,
                           acc[i][4 * u + 2] / den, acc[i][4 * u + 3] / den));
  }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t st) {
  constexpr int kSmem = (kBQ * (D + kPad) + 2 * kBK * (D + kPad) + kBQ * kLP)
                        * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.S + kBQ - 1) / kBQ, B * p.H);
  flash_fwd<D><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 q (B,S,H,D), k and v (B,S,Hkv,D) with the given (b, s, h) strides
// in elements and unit stride over D; out (B,S,H,D) contiguous.  D is 64,
// 80, 112 or 128 (else returns cudaErrorInvalidValue); mode 0 causal, 1 swa, 2
// bidirectional.  Launches on `stream` and returns cudaGetLastError() (0
// on success).
extern "C" int repro_flash_attention_fma(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int mode, int window, float scale, void* stream) {
  const Params p{q, k, v, out, S, H, Hkv, {qsb, qss, qsh}, {ksb, kss, ksh},
                 {vsb, vss, vsh}, mode, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(p, B, st);
  if (D == 80) return launch<80>(p, B, st);
  if (D == 112) return launch<112>(p, B, st);
  if (D == 128) return launch<128>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
