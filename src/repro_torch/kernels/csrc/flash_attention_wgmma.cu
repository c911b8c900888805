// Online-softmax GQA attention, forward only, bf16, for Hopper (sm_90a):
// TMA loads and wgmma products.
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention.py
// (_flash_kernel, called at flash_attention.py:110) for bf16 q, k and v;
// f32 stays on the FMA kernel of flash_attention.cu.  It computes the same
// function: scores q.k in f32 times 1/sqrt(D), masked entries excluded
// with their probability set to 0 itself (so the result does not rely on
// the tile order), a running max m, denominator l (summed from the f32
// probabilities) and accumulator acc in f32 over kv tiles in ascending
// order, and out = acc / max(l, 1e-30) cast to bf16.  Query head h reads
// kv head h / (H / Hkv): KV is never repeated.  Modes: causal (k <= q),
// swa (k <= q and k > q - window) and bidirectional.  D is 64, 80, 112 or
// 128.
//
// Operands.  q is (B,S,H,D) and k, v are (B,S,Hkv,D), read in place by
// TMA through 4-d tensor maps over (D, H, S, B) with their own strides (16
// -byte aligned base, strides in multiples of 16 bytes; the head dim of
// unit stride).  Rows at or past S come back as zeros from TMA's
// out-of-bounds fill, and the mask excludes them in every mode.  out is
// (B,S,H,D) contiguous.
//
// D off a multiple of 64 (80, 112).  Shared memory holds ceil(D / 64)
// boxes of 64 columns, DP = 128 at both, and the tensor maps' inner extent
// is the true D, so TMA fills the columns past D with zeros: nothing is
// copied or padded in device memory.  q k^T runs D / 16 k-steps, the true
// D's work; p v runs at N = DP, its columns past D zeros that are never
// stored.  So p v costs DP / D of its work (1.6x at D 80, 1.14x at 112),
// and the registers and shared memory are those of D 128.
//
// Bound.  At the main path's shape (8 x 1024, 8 heads of 64, causal) the
// card must move 33.5 MB of q, k, v and out, 10 us at 3.35 TB/s, and do
// 8.6 GFLOP (4 D per unmasked pair), 8.7 us on the bf16 tensor cores; at
// 2 x 4096 the 34.4 GFLOP take 35 us.  So the products belong on the
// tensor cores, and the loads must overlap them.
//
// Numerics.  p is computed in f32, as the TPU kernel does.  A single bf16
// rounding of p (as FlashAttention and scaled_dot_product_attention do)
// costs 2^-9 of each weight, about 1e-3 |w|_2 on the output, more than
// half a bf16 ulp wherever |out| is small against |w|_2.  So p is split,
// p = p_hi + p_lo with p_hi = bf16(p) and p_lo = bf16(p - p_hi), and p v
// is two wgmmas into one f32 accumulator: p carried to about 2^-17, every
// product of two bf16 exact in f32.  That is 6 D flops per pair, not 4.
//
// Design.  One block of 384 threads owns 128 q rows of one (b, h): two
// consumer warpgroups of 64 rows each and a producer warpgroup, one lane
// of which issues every TMA load; setmaxnreg moves registers from the
// producer to the consumers.  q is loaded once; k and v go through a ring
// of kStages tiles of BK rows (128 at D 64, 64 at D 128) with full and
// empty mbarriers, so the loads of the next tiles overlap the products.
// Each consumer warpgroup runs s = q k^T as wgmma from shared memory (both
// K-major, 128-byte swizzle), masks, scales and updates its softmax in
// registers on the accumulator fragment (row max is a quad shuffle), packs
// p into the A-operand fragment as p_hi and p_lo, and issues p v with A
// from registers and v read MN-major through the transpose bit: p never
// touches shared memory and v needs no transposed copy.  The q k^T of tile
// t is issued together with the p v of tile t - 1, so the softmax of tile
// t runs while the tensor cores take that p v.  Tiles the mask empties for
// the whole block are skipped, and only tiles that cross the mask's edge
// evaluate it.  The heaviest causal q tiles run first.  No atomics and no
// split over kv: each output element comes from one thread in a fixed
// order, so two launches give identical bits.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;                 // q rows per block
constexpr int kStages = 3;               // k/v ring depth
constexpr int kConsumerWarps = 8;        // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;   // + the producer's
// registers a thread, moved by setmaxnreg from the producer warpgroup to
// the consumers: 128 x 40 + 256 x 232 = 384 x 168, the launch's share
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum Mode { kCausal = 0, kSwa = 1, kBidirectional = 2 };

// the profiled build's phases, in SM cycles of one consumer warpgroup:
// waits for TMA data, waits for the other warpgroup's turn, issuing q k^T
// (and p v) and waiting for q k^T, the softmax, waiting for p v, rescaling
// acc and packing p, and the whole
enum Phase { kLoad, kTurn, kQK, kSoftmax, kPV, kPack, kTotal, kPhases };

struct Params {
  __nv_bfloat16* out;
  long long* prof;     // the profiled build: kPhases per consumer warpgroup
  int S, H, Hkv, mode, window;
  float scale;
};

// the head dim as shared memory and p v hold it: whole boxes of 64 columns
template <int D>
constexpr int kPadD = (D + 63) / 64 * 64;

// kv rows per tile: 128 at D 64, 64 at D 80, 112 and 128 (the registers of
// s and p grow with it, those of acc with kPadD)
template <int D>
constexpr int kTileK = kPadD<D> == 64 ? 128 : 64;

// shared memory, in bytes from a 1024-aligned base: q as kPadD / 64 boxes
// of kBQ rows, then kStages tiles of k and of v, each kPadD / 64 boxes of
// BK rows, then the barriers
template <int D, int BK>
struct Smem {
  static constexpr int kBoxes = kPadD<D> / 64;
  static constexpr int kQBox = kBQ * 128;
  static constexpr int kKVBox = BK * 128;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// which entries of a tile this thread keeps: its rows row0 and row0 + 8,
// columns col0 + 8 j + {0, 1}
struct Mask {
  int row0, col0, S, mode, window;
  __device__ __forceinline__ bool keep(int j, int e) const {
    const int qp = row0 + 8 * (e / 2), kp = col0 + 8 * j + e % 2;
    return kp < S && (mode == kBidirectional ||
                      (kp <= qp && (mode != kSwa || kp > qp - window)));
  }
};

// One tile of this thread's online softmax, in the log2 domain (c = scale
// * log2 e > 0, so the row max is taken on the raw scores): the scores s
// become p (0 where masked), m (log2 domain) moves to the new row max, l
// (this thread's part of the row sum) to l alpha + sum p, and alpha is the
// factor for acc.  Each row's max and sum run as two chains, not one.
// kMask: the tile crosses the mask.
template <int BK, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float c, const Mask& mask) {
  float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask && !mask.keep(j, e)) s[4 * j + e] = kNegInf;
      mx[e / 2][j % 2] = fmaxf(mx[e / 2][j % 2], s[4 * j + e]);
    }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new =
        fmaxf(m[r], c * quad_max(fmaxf(mx[r][0], mx[r][1])));
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    mc[r] = -m_new;
  }
  float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = ex2(fmaf(s[4 * j + e], c, mc[e / 2]));
      if (kMask && !mask.keep(j, e)) pe = 0.f;
      s[4 * j + e] = pe;
      ps[e / 2][j % 2] += pe;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + (ps[r][0] + ps[r][1]);
}

template <int D, int BK, bool kProf>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<D, BK>;
  constexpr int DP = kPadD<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ks = smem + L::kK;
  uint8_t* vs = smem + L::kV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hkv);
  // the heaviest causal q tiles first, so the last wave is short
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  // the kv tiles with at least one unmasked entry for some row of the block
  const int q_last = min(q0 + kBQ, p.S) - 1;
  int t_lo = 0, t_hi = (p.S + BK - 1) / BK;
  if (p.mode != kBidirectional) t_hi = q_last / BK + 1;
  if (p.mode == kSwa) t_lo = max(0, q0 - p.window + 1) / BK;
  t_lo = min(t_lo, t_hi - 1);    // at least one tile, masked whole if need be

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // the producer warpgroup: lane 0 of its first warp issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load_4d(qs + x * L::kQBox, &tq, q_full, 64 * x, h, q0, b);
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int st = i % kStages, round = i / kStages;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_arrive_expect_tx(&k_full[st], L::kKVBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(ks + st * L::kKVBytes + x * L::kKVBox, &tk,
                      &k_full[st], 64 * x, hk, t * BK, b);
        mbar_arrive_expect_tx(&v_full[st], L::kKVBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(vs + st * L::kKVBytes + x * L::kKVBox, &tv,
                      &v_full[st], 64 * x, hk, t * BK, b);
      }
    }
  } else {
    // a consumer warpgroup: rows [r_lo, r_lo + 64) of the block; this
    // thread holds rows row0 and row0 + 8.  Every tile of the block's range
    // goes through both warpgroups (a tile masked whole for one adds p = 0
    // there), so no wgmma sits under a branch that differs between them.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = warp / 4;
    const int r_lo = q0 + 64 * wg;
    const int r_hi = r_lo + 63;
    const int row0 = r_lo + 16 * (warp % 4) + lane / 4;
    const int col = 2 * (lane % 4);
    const uint8_t* qw = qs + wg * 64 * 128;
    const float c = p.scale * kLog2e;

    float o[DP / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // p of the last tile, whose p v is not issued yet, as A fragments
    uint32_t ph[BK / 16][4], pl[BK / 16][4];

    // s = q k^T of the tile in stage st, over the true D
    auto issue_qk = [&](int st) {
      const uint8_t* kt = ks + st * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_kk<BK>(
            s, desc_sw128(qw + kk / 4 * L::kQBox + kk % 4 * 32, 16, 1024),
            desc_sw128(kt + kk / 4 * L::kKVBox + kk % 4 * 32, 16, 1024),
            kk > 0);
      wgmma_commit();
    };
    // acc += p_hi v + p_lo v with v in stage st, over DP columns
    auto issue_pv = [&](int st) {
      const uint8_t* vt = vs + st * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_mn<DP>(o, ph[kk],
                        desc_sw128(vt + kk * 2048, L::kKVBox, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_mn<DP>(o, pl[kk],
                       desc_sw128(vt + kk * 2048, L::kKVBox, 1024), 1);
      wgmma_commit();
    };
    // the softmax of tile t on s (s becomes p); alpha rescales acc
    auto softmax = [&](int t, float (&alpha)[2]) {
      const int k0 = t * BK;
      // no entry of the tile is masked for any row of the warpgroup
      const bool whole =
          k0 + BK <= p.S &&
          (p.mode == kBidirectional || k0 + BK - 1 <= r_lo) &&
          (p.mode != kSwa || k0 > r_hi - p.window);
      const Mask mask{row0, k0 + col, p.S, p.mode, p.window};
      if (whole) softmax_tile<BK, false>(s, m, l, alpha, c, mask);
      else softmax_tile<BK, true>(s, m, l, alpha, c, mask);
    };
    // p = p_hi + p_lo into the A fragments of BK / 16 k-steps
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          const float2 hf = __bfloat1622float2(hi);
          ph[kk][r] = bf16x2_bits(hi);
          pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
        }
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    // the two warpgroups take turns to issue their wgmmas (named barriers
    // 1 and 2), so one's softmax overlaps the other's products; warpgroup
    // 0 goes first.  Each takes n + 1 turns: the first q k^T, n - 1 of
    // q k^T with p v, the last p v.
    const int turns = t_hi - t_lo + 1;
    int turn = 0;
    auto my_turn = [&]() { named_bar_sync(1 + wg, 256); };
    auto next_turn = [&]() {
      if (++turn < turns || wg == 0) named_bar_arrive(2 - wg, 256);
    };
    if (wg == 0) named_bar_arrive(1, 256);
    // the profiled build's cycle counts (kProf only)
    long long cyc[kPhases] = {}, mark = kProf ? clock64() : 0;
    const long long start = mark;
    auto tick = [&](Phase ph) {
      if constexpr (kProf) {
        const long long now = clock64();
        cyc[ph] += now - mark;
        mark = now;
      }
    };

    float alpha[2];
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    tick(kLoad);
    my_turn();
    tick(kTurn);
    wgmma_fence();
    issue_qk(0);
    next_turn();
    wgmma_wait<0>();
    fence_regs(s);
    tick(kQK);
    softmax(t_lo, alpha);              // acc is 0: nothing to rescale
    tick(kSoftmax);
    pack();
    tick(kPack);
    int p_st = 0;
    uint32_t p_parity = 0;
    for (int t = t_lo + 1, i = 1; t < t_hi; ++t, ++i) {
      // s = q k^T of tile t, then acc += p v of tile t - 1: the softmax of
      // tile t overlaps that p v on the tensor cores
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      mbar_wait(&k_full[st], parity);
      mbar_wait(&v_full[p_st], p_parity);
      tick(kLoad);
      my_turn();
      tick(kTurn);
      wgmma_fence();
      issue_qk(st);
      issue_pv(p_st);
      next_turn();
      wgmma_wait<1>();
      fence_regs(s);
      tick(kQK);
      softmax(t, alpha);
      tick(kSoftmax);
      wgmma_wait<0>();
      fence_regs(o);
      tick(kPV);
      release(p_st);
#pragma unroll
      for (int i2 = 0; i2 < DP / 2; ++i2) o[i2] *= alpha[(i2 % 4) / 2];
      pack();
      tick(kPack);
      p_st = st;
      p_parity = parity;
    }
    mbar_wait(&v_full[p_st], p_parity);
    tick(kLoad);
    my_turn();
    tick(kTurn);
    wgmma_fence();
    issue_pv(p_st);
    next_turn();
    wgmma_wait<0>();
    fence_regs(o);
    tick(kPV);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float den = fmaxf(quad_sum(l[r]), 1e-30f);
      if (row >= p.S) continue;
      __nv_bfloat16* orow =
          p.out + ((static_cast<long long>(b) * p.S + row) * p.H + h) * D +
          col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / den,
                                  o[4 * j + 2 * r + 1] / den);
    }
    if constexpr (kProf) {
      cyc[kTotal] = clock64() - start;
      long long* out = p.prof + ((static_cast<long long>(blockIdx.y) *
                                  gridDim.x + blockIdx.x) * 2 + wg) * kPhases;
      if (threadIdx.x % 128 == 0)
        for (int ph = 0; ph < kPhases; ++ph) out[ph] = cyc[ph];
    }
  }
}

// a (B,S,Hh,D) bf16 tensor with (b, s, h) strides in elements, as a
// tensor map over (D, Hh, S, B) read in boxes of 64 columns x `rows` rows
// (a box's columns at or past D read as zeros)
bool tensor_map(CUtensorMap* map, const void* base, int B, int S, int Hh,
                int D, long long sb, long long ss, long long sh, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hh),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * sh),
                                 static_cast<cuuint64_t>(2 * ss),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return sw128_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4,
                          dims, strides, box);
}

template <int D, int BK, bool kProf>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int B, const long long* qs, const long long* ks,
           const long long* vs, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, p.S, p.H, D, qs[0], qs[1], qs[2], kBQ) ||
      !tensor_map(&tk, k, B, p.S, p.Hkv, D, ks[0], ks[1], ks[2], BK) ||
      !tensor_map(&tv, v, B, p.S, p.Hkv, D, vs[0], vs[1], vs[2], BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = Smem<D, BK>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma<D, BK, kProf>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.S + kBQ - 1) / kBQ, B * p.H);
  flash_wgmma<D, BK, kProf><<<grid, kThreads, kSmem, st>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kProf>
int run(const void* q, const void* k, const void* v, void* out,
        long long* prof, int B, int S, int H, int Hkv, int D,
        const long long* qs, const long long* ks, const long long* vs,
        int mode, int window, float scale, void* stream) {
  const Params p{static_cast<__nv_bfloat16*>(out), prof, S, H, Hkv, mode,
                 window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, kTileK<64>, kProf>(q, k, v, p, B, qs, ks, vs, st);
  if (D == 80)
    return launch<80, kTileK<80>, kProf>(q, k, v, p, B, qs, ks, vs, st);
  if (D == 112)
    return launch<112, kTileK<112>, kProf>(q, k, v, p, B, qs, ks, vs, st);
  if (D == 128)
    return launch<128, kTileK<128>, kProf>(q, k, v, p, B, qs, ks, vs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16 q (B,S,H,D), k and v (B,S,Hkv,D) with the given (b, s, h) strides
// in elements (multiples of 8), unit stride over D and 16-byte aligned
// bases; out (B,S,H,D) contiguous.  D is 64, 80, 112 or 128; mode 0
// causal, 1 swa,
// 2 bidirectional.  Launches on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for another D or a tensor map
// cuTensorMapEncodeTiled refuses.
extern "C" int repro_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int mode, int window, float scale, void* stream) {
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh};
  return run<false>(q, k, v, out, nullptr, B, S, H, Hkv, D, qs, ks, vs, mode,
                    window, scale, stream);
}

// The same launch on the profiled build: prof takes kPhases int64 (the
// Phase order) for each consumer warpgroup, two a block, blocks in
// (blockIdx.y, blockIdx.x) order.
extern "C" int repro_flash_attention_wgmma_profile(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int mode, int window, float scale, void* prof,
    void* stream) {
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh};
  return run<true>(q, k, v, out, static_cast<long long*>(prof), B, S, H, Hkv,
                   D, qs, ks, vs, mode, window, scale, stream);
}

// the dynamic shared memory a block of the D kernel takes, in bytes (0 for
// another D)
extern "C" int repro_flash_attention_wgmma_smem(int D) {
  if (D == 64) return Smem<64, kTileK<64>>::kBytes;
  if (D == 80) return Smem<80, kTileK<80>>::kBytes;
  if (D == 112) return Smem<112, kTileK<112>>::kBytes;
  if (D == 128) return Smem<128, kTileK<128>>::kBytes;
  return 0;
}
