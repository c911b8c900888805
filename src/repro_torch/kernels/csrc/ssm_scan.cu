// Chunked gated-linear-attention scan (Mamba2 SSD / RWKV-6 core) for
// Hopper (sm_90a): chunk-parallel, every product on the tensor cores in
// split TF32 (f32-class accuracy).
//
// Replaces the Pallas TPU kernel of repro/kernels/ssm_scan.py (_gla_kernel,
// called at ssm_scan.py:104).  It computes the same function.  For each
// (b, h) the chunks of C rows run in order over a (dk, dv) f32 state S that
// starts at zero.  In each chunk, with lw the log-decay rows:
//   L = cumsum(lw) over the rows;  Lq = L - lw when exclusive, else L;
//   q_t = q * exp(Lq);
//   A = (q k^T) * exp(min(Lq_t - L_s, 0))        scalar decay (dw = 1), or
//   A = q_t (k * exp(-max(L, -20)))^T             per-channel decay;
//   A masked causally: s < t when exclusive, s <= t otherwise;
//   y = A v + q_t S;   S <- exp(L_C) * S + (k * exp(L_C - L))^T v.
// y (B,S,H,dv) and the final S (B,H,dk,dv) are written in f32.
//
// q, k (B,S,H,dk) and v (B,S,H,dv) are f32 or bf16 and log_w (B,S,H,dw) is
// f32; all are read in place through their (b, s, h) strides, the last dim
// contiguous.  No transposes to (B*H, S, d), as the TPU wrapper makes.
//
// Bound.  At rwkv6-7b's shape (B 2 x S 4096, 64 heads, dk = dv = 64, chunk
// 128) the card must move 470 MB (q, k, v in bf16, log_w and y in f32, the
// final state), 0.14 ms at 3.35 TB/s; the products are some 26 GFLOP.  The
// earlier kernel ran them on the f32 FMA units, one block per (b, h)
// walking the chunks in order: 128 blocks on 132 SMs, 12x the bound.
//
// Design.  Three passes on the stream, one launch of the wrapper:
//  1. state: one block per (b, h, chunk, 64 channels of dk) scans L and
//     forms the chunk's k_dec^T v = (k * exp(L_C - L))^T v on wgmma, into
//     a scratch buffer the wrapper allocates, and exp(L_C);
//  2. fold: one thread per (b, h, i, j) walks the chunks in order, S <-
//     exp(L_C) * S + k_dec^T v (the plain loop's f32 operations in its
//     order), leaving in each chunk's slot the state it starts from, and
//     writes the final state;
//  3. out: one block per (b, h, chunk) recomputes L and the decayed q and
//     k, forms A = q_t k_t^T on wgmma (the all-masked causal 64 x 64 tile
//     skipped), y = q_t S_{c-1} + A v on wgmma, and writes y.
// Passes 1 and 3 have B*H*(S/C) blocks (4,096 at rwkv6's shape), so they
// fill the card whatever B*H is, in chunk-major order so that the blocks in
// flight read the same rows; the only sequential walk is the fold, 32
// multiply-adds a thread.  The price is traffic: k, v and log_w are read
// twice and the scratch three times, 1.01 GB at rwkv6's shape (0.30 ms),
// and the split operands take 54 GFLOP of TF32 (0.11 ms at 495 TF/s).
// What limits it: an out-pass block holds 166 KB of split tiles and 255
// registers a thread, so one fits an SM; its loads go out in bursts that
// every SM issues at once, and overlap little of its products and stores.
// Each block, its own staging done, prefetches to L2 the rows of the block
// a wave behind it (prefetch_chunk), so that wave's loads find L2.
//
// Numerics.  One TF32 rounding of an operand (2^-11) costs some 4e-4
// normwise at rwkv6's shape, against the check's 1e-5, so every f32
// operand is split, x = hi + lo with hi = tf32(x) (round to nearest) and lo
// = x - hi (exact), and a product is hi.hi + hi.lo + lo.hi into one f32
// accumulator: 3xTF32, about 2^-21 a product.  An operand that is exact in
// TF32 is not split and its product takes two passes: v in bf16 always, and
// q and k in bf16 in the scalar branch, where A = (q k^T) * D and y's
// q_t S = exp(Lq_t) (q S).  TF32 wgmma reads both operands K-major from
// shared memory (no transpose bit), so each staging loop writes its tile in
// the reduction dim's order; A goes to y's product from registers, its
// columns permuted within each k8 step to meet the register fragment, and
// v's tile is written in the same order.  No atomics, no split over a
// reduction: two launches give identical bits.
//
// Staging.  Every operand passes through registers (decay, split,
// transpose) before shared memory, so loads are ordinary loads, not TMA:
// 16-byte ones where every row allows it (the wrapper's ``vec`` flag),
// else one element a thread, each thread's issued in one round.  The
// per-channel scan gives each warp 8 channels in 4 row groups, whose starts
// differ by 1 or 2 rows mod 8 so that the swizzled stores of a warp fall in
// 32 banks.  The staged exponentials take ex2.approx (fexp).
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;          // wgmma rows, an s-tile, a dk slice
constexpr int kWarpgroup = 128;
constexpr int kFoldThreads = 256;
constexpr int kMaxC = 128;         // the largest chunk (the wrapper checks)
constexpr float kClamp = 20.0f;    // the safe-gate clamp (models/ssm CLAMP)

// the profiled build: int64 SM cycles per block, measured by thread 0
// between barriers, kSlots per block in each pass's region
constexpr int kSlots = 8;
enum StatePhase { kStStage, kStMma, kStStore, kStTotal, kStK, kStV };
enum OutPhase { kOutStage, kOutQK, kOutV, kOutY, kOutStore, kOutTotal,
                kOutQKStage, kOutSStage };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* lw;
  float* y;
  float* sfin;
  // scratch: each chunk's k_dec^T v, then the state it starts from,
  // [n][B*H][dk][ld]; and exp(L_C), [n][B*H][dw]
  float* kv;
  float* decay;
  long long* prof;   // the profiled build, else null
  int S, H, BH, dk, dv, dw, C, n, ld;
  int excl, vec;
  long long qs[3], ks[3], vs[3], ws[3];   // (b, s, h) strides in elements
};

// Staging loads.  Each is unconditional (callers clamp the address into
// the tensor and select the value after) and a plain (weak, L1-cached)
// global load in volatile asm: ptxas re-issues a read-only (.nc) load next
// to its first use, inside that row's branch, and the loads of a staging
// loop then wait one after another; issued where they are written, a
// thread's loads are in flight together.
__device__ __forceinline__ float ld(const float* p) {
  float x;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(x) : "l"(p));
  return x;
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  unsigned short x;
  asm volatile("ld.global.u16 %0, [%1];" : "=h"(x) : "l"(p));
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// the fold's loads of the scratch it rewrites (volatile measured faster
// there than weak loads)
__device__ __forceinline__ float ld_volatile(const float* p) {
  float x;
  asm volatile("ld.volatile.global.f32 %0, [%1];" : "=f"(x) : "l"(p));
  return x;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 x;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w) : "l"(p));
  return x;
}

// the 16 / sizeof(T) values of a 16-byte load, as f32
__device__ __forceinline__ void unpack(const uint4& u, float* dst, float) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float* dst,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    dst[2 * m] = __uint_as_float(w[m] << 16);
    dst[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
  }
}

// x rounded to TF32 (nearest, ties away), as an f32 with 13 zero low
// bits: cvt.rna.tf32.f32 on finite x, in two integer operations
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// e^x for the staged operands: ex2.approx of x log2 e, some 2^-22 relative
// near x = 0 (the per-chunk decay exp(L_C), which the fold compounds,
// takes expf)
__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// x into hi[at] and, split, its remainder into lo[at]; only when `on`
template <bool SPLIT>
__device__ __forceinline__ void put(float* hi, float* lo, int at, float x,
                                    bool on = true) {
  if constexpr (SPLIT) {
    const float h = tf32(x);
    if (on) {
      hi[at] = h;
      lo[at] = x - h;
    }
  } else {
    if (on) hi[at] = x;
  }
}

// Float index of element (r, k) of a K-major f32 tile of `rows` rows in
// the 128-byte swizzle of hopper.cuh: boxes of 32 k (128 bytes a row) one
// after the other, row r of a box at 32 r, its 16-byte chunk j at j ^ r % 8.
__device__ __forceinline__ int swz(int rows, int r, int k) {
  return (k >> 5) * rows * 32 + r * 32 + ((((k >> 2) & 7) ^ (r & 7)) << 2)
         + (k & 3);
}

// wgmma descriptor of k8 step kk of the rows r0.. of such a tile
__device__ __forceinline__ uint64_t kdesc(const float* tile, int rows, int r0,
                                          int kk) {
  return desc_sw128(tile + (kk >> 2) * rows * 32 + r0 * 32 + (kk & 3) * 8, 16,
                    1024);
}

// y's k order within a k8 step: the A fragment of y's product holds, for
// logical column l, accumulator column 2 (l % 4) + l / 4, so v's row s
// sits at logical column perm(s)
__device__ __forceinline__ int perm(int s) {
  return (s & ~7) | ((s & 1) << 2) | ((s >> 1) & 3);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ tf32 wgmma
// d (m64 x nN f32 fragment, as in hopper.cuh) += a b in TF32 (acc = 0:
// d = a b), both K-major:
// mma_ss reads a (64 x 8) and b (N x 8) from shared memory; mma_rs takes a
// from registers, a[r] holding row 16 w + l / 4 + 8 (r % 2), column
// l % 4 + 4 (r / 2) of the k8 step (warp w of the warpgroup, lane l).
#define SSM_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SSM_REGS64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define SSM_REGS16                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SSM_OUT8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SSM_OUT16(d) SSM_OUT8(d, 0), SSM_OUT8(d, 8)
#define SSM_OUT32(d)                                                       \
  SSM_OUT8(d, 0), SSM_OUT8(d, 8), SSM_OUT8(d, 16), SSM_OUT8(d, 24)
#define SSM_OUT64(d)                                                       \
  SSM_OUT32(d), SSM_OUT8(d, 32), SSM_OUT8(d, 40), SSM_OUT8(d, 48),         \
      SSM_OUT8(d, 56)
// scale-d is the predicate `acc` != 0: 0 overwrites d
#define SSM_WGMMA(n, regs, out, a, b, acc, ...)                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " acc ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" n "k8.f32.tf32.tf32 "    \
               regs ", " a ", " b ", p, 1, 1;\n}\n"                        \
               : out : __VA_ARGS__)

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int acc = 1) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma widths 32 to 128");
  if constexpr (N == 32)
    SSM_WGMMA("32", SSM_REGS16, SSM_OUT16(d), "%16", "%17", "%18", "l"(a),
              "l"(b), "r"(acc));
  else if constexpr (N == 64)
    SSM_WGMMA("64", SSM_REGS32, SSM_OUT32(d), "%32", "%33", "%34", "l"(a),
              "l"(b), "r"(acc));
  else
    SSM_WGMMA("128", SSM_REGS64, SSM_OUT64(d), "%64", "%65", "%66", "l"(a),
              "l"(b), "r"(acc));
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 128, "wgmma widths 64 and 128");
  if constexpr (N == 64)
    SSM_WGMMA("64", SSM_REGS32, SSM_OUT32(d), "{%32, %33, %34, %35}", "%36",
              "%37", "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(1));
  else
    SSM_WGMMA("128", SSM_REGS64, SSM_OUT64(d), "{%64, %65, %66, %67}", "%68",
              "%69", "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(1));
}

#undef SSM_WGMMA
#undef SSM_OUT64
#undef SSM_OUT32
#undef SSM_OUT16
#undef SSM_OUT8
#undef SSM_REGS64
#undef SSM_REGS32
#undef SSM_REGS16

// ------------------------------------------------------------- staging

// the first row of row group g (of 4) of a chunk of C rows: about g C / 4,
// moved to g * stride mod 8 so the groups' stores fall in other banks
__device__ __forceinline__ int group_start(int g, int C, int stride) {
  return g >= 4 ? C : min(C, 8 * (g * C / 32) + g * stride);
}

// The block's rows of one (b, h): pointers to row t0 of the chunk.
template <typename T>
struct Rows {
  const T* q;
  const T* k;
  const T* v;
  const float* lw;
  long long qs, ks, vs, ws;     // row strides
};

template <typename T>
__device__ __forceinline__ Rows<T> rows_of(const Params& p, int b, int h,
                                           long long t0) {
  Rows<T> r;
  r.q = static_cast<const T*>(p.q) + b * p.qs[0] + t0 * p.qs[1] + h * p.qs[2];
  r.k = static_cast<const T*>(p.k) + b * p.ks[0] + t0 * p.ks[1] + h * p.ks[2];
  r.v = static_cast<const T*>(p.v) + b * p.vs[0] + t0 * p.vs[1] + h * p.vs[2];
  r.lw = p.lw + b * p.ws[0] + t0 * p.ws[1] + h * p.ws[2];
  r.qs = p.qs[1];
  r.ks = p.ks[1];
  r.vs = p.vs[1];
  r.ws = p.ws[1];
  return r;
}

// Rows of 128-byte lines into L2: the lines of rows r < nrows, `bytes`
// each, `stride` bytes apart, by the block's threads.
__device__ __forceinline__ void prefetch_rows(const void* base, int nrows,
                                              long long stride, int bytes,
                                              int tid, int nthreads) {
  const int lines = (bytes + 127) / 128;
  for (int e = tid; e < nrows * lines; e += nthreads) {
    const int row = e / lines, line = e % lines;
    asm volatile("prefetch.global.L2 [%0];" :: "l"(
        static_cast<const char*>(base) + row * stride
        + min(128 * line, bytes - 1)));
  }
}

// The rows the block that runs in this one's place a wave later (item
// bc, c (B H) + b h) will read, brought to L2 while this block computes:
// its staging loads then find L2 rather than the DRAM burst every SM
// issues at once at the start of a wave.
template <typename T>
__device__ __forceinline__ void prefetch_chunk(const Params& p, long long bc,
                                               bool out_pass, int tid,
                                               int nthreads) {
  const int c = bc / p.BH, bh = bc % p.BH, b = bh / p.H, h = bh % p.H;
  const Rows<T> r = rows_of<T>(p, b, h, (long long)c * p.C);
  constexpr int E = sizeof(T);
  prefetch_rows(r.k, p.C, r.ks * E, p.dk * E, tid, nthreads);
  prefetch_rows(r.v, p.C, r.vs * E, p.dv * E, tid, nthreads);
  prefetch_rows(r.lw, p.C, r.ws * 4, p.dw * 4, tid, nthreads);
  if (out_pass) {
    prefetch_rows(r.q, p.C, r.qs * E, p.dk * E, tid, nthreads);
    prefetch_rows(p.kv + bc * p.dk * p.ld, p.dk, p.ld * 4, p.dv * 4, tid,
                  nthreads);
  }
}

// The scalar scan runs in float64: with strong decays L reaches -100
// within a chunk, and an f32 rounding of L (some 4e-6 there) would become
// a relative error of exp(Lq_t - L_s) near 1; the differences are taken in
// float64 too, and only then rounded to f32 for the exponential.  The
// per-channel scan, whose exponents the clamp at -20 bounds, stays f32 as
// the plain version's does (float64 there cost a quarter of the time).

// Scalar decay: Lr[t] = L and (Lq not null) Lq[t] = Lq of the chunk's
// rows, by one warp (lane l scans rows 4 l .. 4 l + 3, then the warp scans
// the lanes' sums); returns L_C on every lane
__device__ __forceinline__ double scalar_scan(const float* lw, long long ws,
                                              int C, bool excl, double* Lr,
                                              double* Lq, int lane) {
  float x[4];
  double sum = 0.0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    x[u] = ld(lw + min(t, C - 1) * ws);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    x[u] = 4 * lane + u < C ? x[u] : 0.0f;
    sum += x[u];
  }
  double inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  double run = inc - sum;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    run += x[u];
    if (t < C) {
      Lr[t] = run;
      if (Lq != nullptr) Lq[t] = excl ? run - x[u] : run;
    }
  }
  return __shfl_sync(0xffffffffu, inc, 31);
}

// the most rows a row group of a chunk of at most kMaxC rows has (36, at C
// 127 and stride 1)
constexpr int kGroupRows = kMaxC / 4 + 4;

// Per-channel decay: the warp's 8 channels c0 .. c0 + 7 (channel c0 + l %
// 8 on lane l, row group l / 8), L scanned down the chunk's C rows.  Each
// lane loads its group's rows (log_w and fetch's values) in one round,
// sums them, takes the sums of the groups above it, then walks the rows
// calling visit(t, L, Lq, L_C, fetch(t), valid) in order, for all
// kGroupRows of them with `valid` false past the group's end (so the walk
// has no branches; visit stores only valid rows).  Returns L_C.
template <typename Fetch, typename Visit>
__device__ __forceinline__ float channel_scan(const float* lw, long long ws,
                                              int C, bool excl, bool live,
                                              int stride, int lane,
                                              Fetch fetch, Visit visit) {
  const int g = lane >> 3;
  const int lo = group_start(g, C, stride);
  const int n = live ? group_start(g + 1, C, stride) - lo : 0;
  float x[kGroupRows];
  float2 f[kGroupRows];
#pragma unroll
  for (int u = 0; u < kGroupRows; ++u) {
    const int t = min(lo + u, C - 1);
    x[u] = ld(lw + t * ws);
    f[u] = fetch(t);
  }
  float sum = 0.0f;
#pragma unroll
  for (int u = 0; u < kGroupRows; ++u) sum += u < n ? x[u] : 0.0f;
  float pre = 0.0f, total = 0.0f;
#pragma unroll
  for (int gg = 0; gg < 4; ++gg) {
    const float s = __shfl_sync(0xffffffffu, sum, (lane & 7) + 8 * gg);
    if (gg < g) pre += s;
    total += s;
  }
  float run = pre;
#pragma unroll
  for (int u = 0; u < kGroupRows; ++u) {
    const bool valid = u < n;
    const float xu = valid ? x[u] : 0.0f;
    run += xu;
    visit(lo + u, run, excl ? run - xu : run, total, f[u], valid);
  }
  return total;
}

// A thread's share of a staging loop held in registers: load() takes
// get(e) for e = begin, begin + step, .. (kN of them; get sees an index
// clamped to end - 1 and loads unconditionally), store() hands those
// below end to use(e, value).  The loads of one load() are in flight
// together, and other work can run before store().
template <int kN, typename V>
struct Held {
  V x[kN];
  template <typename Get>
  __device__ __forceinline__ void load(int begin, int end, int step,
                                       Get get) {
#pragma unroll
    for (int u = 0; u < kN; ++u) x[u] = get(min(begin + u * step, end - 1));
  }
  template <typename Use>
  __device__ __forceinline__ void store(int begin, int end, int step,
                                        Use use) const {
#pragma unroll
    for (int u = 0; u < kN; ++u)
      if (begin + u * step < end) use(begin + u * step, x[u]);
  }
};

// For e = begin, begin + step, .. < end: kB values at a time loaded, then
// used (Held).
template <int kB, typename Get, typename Use>
__device__ __forceinline__ void batched(int begin, int end, int step,
                                        Get get, Use use) {
  for (int e0 = begin; e0 < end; e0 += kB * step) {
    Held<kB, decltype(get(begin))> h;
    h.load(e0, end, step, get);
    h.store(e0, end, step, use);
  }
}

// 16 bytes of f32 values
struct F4 {
  float v[4];
};
// 16 bytes each of q and k
struct QK {
  uint4 q, k;
};

// v's rows s < R of the chunk as a K-major tile of DVP rows (j) and R
// columns (s, in y's order when PERM), zeros for s >= C and j >= dv: the
// loop's index e gives s = e % R (a warp's lanes take 32 consecutive s, so
// its stores fall in 32 banks) and the piece of j, 16 bytes (get, use)
// or one element (get1, use1).
template <typename T, int DVP, bool SPLIT, bool PERM>
struct VTile {
  static constexpr int VT = 16 / sizeof(T);
  const T* v;
  long long vs;
  float* VH;
  float* VL;
  int C, R, rl, dv;                 // rl = log2 R (R is 64 or 128)
  __device__ __forceinline__ VTile(const Rows<T>& r, float* hi, float* lo,
                                   int C_, int R_, int dv_)
      : v(r.v), vs(r.vs), VH(hi), VL(lo), C(C_), R(R_),
        rl(R_ == 128 ? 7 : 6), dv(dv_) {}
  __device__ __forceinline__ int pieces() const { return R * (DVP / VT); }
  __device__ __forceinline__ uint4 get(int e) const {
    const int s = e & (R - 1), j0 = (e >> rl) * VT;
    const uint4 x = ld16(v + min(s, C - 1) * vs + (j0 < dv ? j0 : 0));
    return s < C && j0 < dv ? x : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void use(int e, const uint4& raw) const {
    const int s = e & (R - 1), j0 = (e >> rl) * VT;
    const int col = PERM ? perm(s) : s;
    float x[VT];
    unpack(raw, x, T());
#pragma unroll
    for (int u = 0; u < VT; ++u)
      put<SPLIT>(VH, VL, swz(DVP, j0 + u, col), x[u]);
  }
  __device__ __forceinline__ float get1(int e) const {
    const int s = e & (R - 1), j = e >> rl;
    const float x = ld(v + min(s, C - 1) * vs + min(j, dv - 1));
    return s < C && j < dv ? x : 0.0f;
  }
  __device__ __forceinline__ void use1(int e, float x) const {
    const int s = e & (R - 1), j = e >> rl;
    put<SPLIT>(VH, VL, swz(DVP, j, PERM ? perm(s) : s), x);
  }
  // the whole tile, by the block's threads
  __device__ __forceinline__ void stage(bool vec, int tid, int nthreads) const {
    if (vec)
      batched<DVP / VT>(tid, pieces(), nthreads,
                        [&](int e) { return get(e); },
                        [&](int e, const uint4& x) { use(e, x); });
    else
      batched<32>(tid, R * DVP, nthreads, [&](int e) { return get1(e); },
                  [&](int e, float x) { use1(e, x); });
  }
};

// the profile's clock: thread 0 adds the cycles since the last lap to
// slot `ph`
// slot `ph`, kept in shared memory while the block runs; total() copies
// the slots to the block's row of the profile
struct Laps {
  long long* out;                 // the profile's row, or null
  long long* sm;                  // kSlots in shared memory
  long long mark, start;
  __device__ __forceinline__ void lap(int ph) {
    if (out != nullptr) {
      const long long now = clock64();
      sm[ph] += now - mark;
      mark = now;
    }
  }
  __device__ __forceinline__ void total(int ph) {
    if (out != nullptr) {
      sm[ph] = clock64() - start;
      for (int i = 0; i < kSlots; ++i) out[i] = sm[i];
    }
  }
};

__device__ __forceinline__ Laps laps(long long* prof, long long block,
                                     long long* slots) {
  Laps l{nullptr, slots, 0, 0};
  if (prof != nullptr && threadIdx.x == 0) {
    l.out = prof + block * kSlots;
    for (int i = 0; i < kSlots; ++i) slots[i] = 0;
    l.mark = l.start = clock64();
  }
  return l;
}

// ---------------------------------------------------------- 1. state pass

constexpr int kStateThreads = 2 * kWarpgroup;

template <typename T, int DVP>
struct StateSmem {
  static constexpr bool kVLo = sizeof(T) == 4;
  // floats, from a 1024-aligned base: k_dec^T hi and lo (64 x R), v^T hi
  // (and lo) (DVP x R), the scalar scan
  static __host__ __device__ int bytes(int R) {
    return 4 * (2 * kTile * R + (kVLo ? 2 : 1) * DVP * R + 4 * kMaxC) + 1024;
  }
};

// One block of two warpgroups per (b, h, chunk, 64 channels m): the
// chunk's k_dec^T v for those channels (each warpgroup half of its
// columns), and exp(L_C).
template <typename T, bool SCALAR, int DVP>
__global__ void __launch_bounds__(kStateThreads, 2)
gla_state(const Params p, int ahead) {
  constexpr bool kVLo = StateSmem<T, DVP>::kVLo;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  float* sm = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  __shared__ long long slots[kSlots];
  const int C = p.C, R = (C + kTile - 1) / kTile * kTile;
  const int mt = (p.dk + kTile - 1) / kTile;
  // blocks in (chunk, b h, m) order: the blocks in flight share rows
  const int m = blockIdx.x % mt;
  const long long bc = blockIdx.x / mt;             // c (B H) + b h
  const int c = bc / p.BH, bh = bc % p.BH;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0), wl = warp % 4;
  const int i0 = m * kTile;                         // the block's channels
  float* KH = sm;
  float* KL = KH + kTile * R;
  float* VH = KL + kTile * R;
  float* VL = VH + DVP * R;                         // kVLo only
  double* Lr = reinterpret_cast<double*>(VH + (kVLo ? 2 : 1) * DVP * R);
  double* Lc = Lr + kMaxC;
  Laps lp = laps(p.prof, blockIdx.x, slots);
  const Rows<T> r = rows_of<T>(p, b, h, (long long)c * C);
  float* decay = p.decay + bc * p.dw;

  // v's tile: its loads go out with k's and log_w's, held in registers
  constexpr int VT = 16 / sizeof(T);
  const VTile<T, DVP, kVLo, false> vt(r, VH, VL, C, R, p.dv);
  Held<DVP / (2 * VT), uint4> vh;              // R * DVP / VT / kStateThreads
  if (p.vec)
    vh.load(tid, vt.pieces(), kStateThreads, [&](int e) { return vt.get(e); });
  // k_dec^T: row i - i0, column s
  if constexpr (SCALAR) {
    if (warp == 0) {
      const double lc = scalar_scan(r.lw, r.ws, C, p.excl, Lr, nullptr,
                                    lane);
      if (lane == 0) {
        *Lc = lc;
        if (m == 0) decay[0] = expf(static_cast<float>(lc));
      }
    }
    __syncthreads();
    const double lc = *Lc;
    // lanes: 8 rows i by 4 columns s, so the stores fall in 32 banks
    const int ql = R == 128 ? 5 : 4;        // log2 (R / 4)
    auto at = [&](int e, int& row, int& s) {
      row = 8 * ((e >> 5) >> ql) + (e & 7);
      s = 4 * ((e >> 5) & ((R >> 2) - 1)) + ((e >> 3) & 3);
    };
    batched<kMaxC / 4>(tid, kTile * R, kStateThreads,
        [&](int e) {
          int row, s;
          at(e, row, s);
          const float x = ld(r.k + min(s, C - 1) * r.ks
                             + min(i0 + row, p.dk - 1));
          return i0 + row < p.dk ? x : 0.0f;
        },
        [&](int e, float x) {
          int row, s;
          at(e, row, s);
          put<true>(KH, KL, swz(kTile, row, s),
                    s < C ? x * fexp(static_cast<float>(lc - Lr[s])) : 0.0f);
        });
  } else {
    for (int task = warp; task < kTile / 8; task += kStateThreads / 32) {
      const int row = task * 8 + (lane & 7), i = i0 + row;
      const bool live = i < p.dk;
      const float lc = channel_scan(
          r.lw + (live ? i : 0), r.ws, C, p.excl, live, 1, lane,
          [&](int t) {
            return make_float2(ld(r.k + t * r.ks + (live ? i : 0)), 0.0f);
          },
          [&](int t, float Lt, float, float Lct, float2 f, bool valid) {
            put<true>(KH, KL, swz(kTile, row, t), f.x * fexp(Lct - Lt),
                      valid);
          });
      if (live && lane < 8) decay[i] = expf(lc);
      if (!live) {
        for (int t = lane >> 3; t < C; t += 4)
          put<true>(KH, KL, swz(kTile, row, t), 0.0f);
      }
    }
  }
  if (p.prof != nullptr) __syncthreads();
  lp.lap(kStK);
  // zero columns s in [C, R): the reduction's padding
  for (int e = tid; e < kTile * (R - C); e += kStateThreads) {
    const int row = e % kTile, s = C + e / kTile;
    put<true>(KH, KL, swz(kTile, row, s), 0.0f);
  }
  if (p.vec)
    vh.store(tid, vt.pieces(), kStateThreads,
             [&](int e, const uint4& x) { vt.use(e, x); });
  else
    vt.stage(false, tid, kStateThreads);
  if (p.prof != nullptr) __syncthreads();
  lp.lap(kStV);
  fence_async_smem();
  __syncthreads();
  lp.lap(kStStage);
  if (m == 0 && blockIdx.x + ahead < gridDim.x)
    prefetch_chunk<T>(p, (blockIdx.x + ahead) / mt, false, tid,
                      kStateThreads);

  // this warpgroup's columns of v: j0 ..
  constexpr int N = DVP / 2;
  const int j0 = wg * N;
  float acc[N / 2];
  const int ksteps = (C + 7) / 8;
  wgmma_fence();
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint64_t vh = kdesc(VH, DVP, j0, kk);
    mma_ss<N>(acc, kdesc(KH, kTile, 0, kk), vh, kk > 0);
    mma_ss<N>(acc, kdesc(KL, kTile, 0, kk), vh);
    if constexpr (kVLo) mma_ss<N>(acc, kdesc(KH, kTile, 0, kk),
                                  kdesc(VL, DVP, j0, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if (p.prof != nullptr) __syncthreads();
  lp.lap(kStMma);

  // rows i of the fragment: 16 (warp) + lane / 4 (+ 8); columns j0 + 8 j
  // + 2 (lane % 4) (+ 1)
  float* out = p.kv + bc * p.dk * p.ld;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 16 * wl + lane / 4 + 8 * (e / 2);
      const int col = j0 + 8 * j + 2 * (lane % 4) + e % 2;
      if (i < p.dk && col < p.dv) out[(long long)i * p.ld + col] = acc[4 * j + e];
    }
  lp.lap(kStStore);
  lp.total(kStTotal);
}

// ----------------------------------------------------------- 2. fold pass

// One thread per (b, h, i, j): S <- exp(L_C) S + k_dec^T v over the
// chunks in order, each chunk's slot left holding the state it starts from.
__global__ void __launch_bounds__(kFoldThreads)
gla_fold(const Params p, long long total) {
  __shared__ long long slots[kSlots];
  Laps lp = laps(p.prof, blockIdx.x, slots);
  const long long e = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  if (e < total) {
    const int per = p.dk * p.dv;
    const long long bh = e / per;
    const int i = (e % per) / p.dv, j = (e % per) % p.dv;
    float* slot = p.kv + bh * p.dk * p.ld + (long long)i * p.ld + j;
    const float* dec = p.decay + bh * p.dw + (p.dw == 1 ? 0 : i);
    const long long step = (long long)p.BH * p.dk * p.ld;   // a chunk
    constexpr int kU = 32;                 // every chunk's loads at once
    float s = 0.0f;
    for (int c0 = 0; c0 < p.n; c0 += kU) {
      float x[kU], d[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int cu = min(c0 + u, p.n - 1);
        x[u] = ld_volatile(slot + cu * step);
        d[u] = ld_volatile(dec + (long long)cu * p.BH * p.dw);
      }

#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (c0 + u < p.n) {
          slot[(c0 + u) * step] = s;
          s = __fadd_rn(__fmul_rn(d[u], s), x[u]);
        }
      }
    }
    p.sfin[bh * per + (long long)i * p.dv + j] = s;
  }
  if (p.prof != nullptr) __syncthreads();
  lp.total(0);
}

// ------------------------------------------------------------ 3. out pass

template <typename T, bool SCALAR, int DVP>
struct OutSmem {
  // q, k (or their decayed forms) need a lo part unless exact in TF32
  static constexpr bool kQKLo = !SCALAR || sizeof(T) == 4;
  static constexpr bool kVLo = sizeof(T) == 4;
  // floats, from a 1024-aligned base: q_t and k_t hi (and lo) (kRows x
  // 64 each, one dk slice; a tile's size is fixed, so its hi and lo parts
  // sit at constant offsets), v^T over them after the products (DVP x R,
  // hi and lo), then S^T hi and lo (DVP x 64), then the scalar scan
  static constexpr int kRows = kMaxC;
  static constexpr int kTileFloats = kRows * kTile;
  static constexpr int kQKFloats = kTileFloats * (kQKLo ? 4 : 2);
  // v^T fits where q and k were
  static_assert(DVP * (kVLo ? 2 : 1) <= kTile * (kQKLo ? 4 : 2), "v^T");
  static constexpr int kBytes = 4 * (kQKFloats + 2 * DVP * kTile + 4 * kMaxC)
                                + 1024;
};

// One block per (b, h, chunk), a warpgroup per 64 rows of the chunk.
// WIDE: dk > 64, in two slices (else one, and the accumulators are not
// live while the block stages).
template <typename T, bool SCALAR, int DVP, bool WIDE>
__global__ void __launch_bounds__(2 * kWarpgroup, 1)
gla_out(const Params p, int ahead) {
  using L = OutSmem<T, SCALAR, DVP>;
  constexpr bool kQKLo = L::kQKLo, kVLo = L::kVLo;
  constexpr int VT = 16 / sizeof(T);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  float* sm = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int C = p.C, nthreads = blockDim.x, R = nthreads / kWarpgroup * kTile;
  __shared__ long long slots[kSlots];
  // blocks in (chunk, b h) order: the blocks in flight share rows
  const long long bc = blockIdx.x;                  // c (B H) + b h
  const int c = bc / p.BH, bh = bc % p.BH;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the warpgroup, provably the same on every lane of a warp
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0), wl = warp % 4;
  constexpr int kRows = L::kRows, tile = L::kTileFloats;
  float* QH = sm;
  float* QL = QH + tile;                            // kQKLo only
  float* KH = QH + (kQKLo ? 2 : 1) * tile;
  float* KL = KH + tile;                            // kQKLo only
  float* VH = sm;                                   // over q and k
  float* VL = VH + DVP * R;                         // kVLo only
  float* SH = sm + L::kQKFloats;
  float* SL = SH + DVP * kTile;
  double* Lr = reinterpret_cast<double*>(SL + DVP * kTile);
  double* Lq = Lr + kMaxC;
  Laps lp = laps(p.prof, bc, slots);
  const Rows<T> r = rows_of<T>(p, b, h, (long long)c * C);
  const float* S0 = p.kv + bc * p.dk * p.ld;        // the chunk's S_{c-1}

  if constexpr (SCALAR) {
    if (warp == 0) scalar_scan(r.lw, r.ws, C, p.excl, Lr, Lq, lane);
  }

  // v's tile (over q and k once the products are done) and S_{c-1}^T,
  // row j, column i - i0 (lanes take consecutive i): their loads go out
  // with the staging loads of q and k, held in registers until stored
  const VTile<T, DVP, kVLo, true> vt(r, VH, VL, C, R, p.dv);
  Held<DVP / (2 * VT), uint4> vh;              // R * DVP / VT / nthreads
  Held<DVP / 8, F4> sh;                        // 64 * DVP / 4 / (128 NT)
  const int s_end = kTile * (DVP / 4);
  // y and A's s-tiles 0 and 1 (the second warpgroup's, one N = 128 product;
  // the first warpgroup's s-tile 0, N = 64): the first product of the
  // first slice overwrites them
  float y[DVP / 2], a[64];
  float (&a0)[32] = *reinterpret_cast<float (*)[32]>(a);
  float (&a1)[32] = *reinterpret_cast<float (*)[32]>(a + 32);

  for (int i0 = 0; i0 < (WIDE ? p.dk : 1); i0 += kTile) {
    const int ni = min(kTile, p.dk - i0);
    if (i0 > 0) __syncthreads();     // the last slice's products are done
    if (p.vec && i0 + kTile >= p.dk)
      vh.load(tid, vt.pieces(), nthreads, [&](int e) { return vt.get(e); });
    sh.load(tid, s_end, nthreads, [&](int e) {
      const int col = e % kTile, j0 = (e / kTile) * 4;
      const uint4 f = ld16(S0 + (long long)(i0 + min(col, ni - 1)) * p.ld
                           + (j0 < p.dv ? j0 : 0));
      F4 x;
      unpack(f, x.v, 0.0f);
      if (!(col < ni && j0 < p.dv)) x = F4{{0.0f, 0.0f, 0.0f, 0.0f}};
      return x;
    });
    // q and k's operands of A and of q S, row t, column i - i0
    if constexpr (SCALAR) {
      if (p.vec) {
        batched<kTile / (2 * VT)>(tid, C * (kTile / VT), nthreads,
            [&](int e) {
              const int t = e / (kTile / VT), col = (e % (kTile / VT)) * VT;
              const int cc = i0 + (col < ni ? col : 0);
              QK x{ld16(r.q + t * r.qs + cc), ld16(r.k + t * r.ks + cc)};
              if (col >= ni) x.q = x.k = make_uint4(0, 0, 0, 0);
              return x;
            },
            [&](int e, const QK& x) {
              const int t = e / (kTile / VT), col = (e % (kTile / VT)) * VT;
              float xq[VT], xk[VT];
              unpack(x.q, xq, T());
              unpack(x.k, xk, T());
#pragma unroll
              for (int u = 0; u < VT; ++u) {
                put<kQKLo>(QH, QL, swz(kRows, t, col + u), xq[u]);
                put<kQKLo>(KH, KL, swz(kRows, t, col + u), xk[u]);
              }
            });
      } else {
        batched<kTile / 2>(tid, C * kTile, nthreads,
            [&](int e) {
              const int t = e / kTile, col = e % kTile;
              const int cc = i0 + (col < ni ? col : 0);
              const float2 x = make_float2(ld(r.q + t * r.qs + cc),
                                           ld(r.k + t * r.ks + cc));
              return col < ni ? x : make_float2(0.0f, 0.0f);
            },
            [&](int e, float2 x) {
              const int at = swz(kRows, e / kTile, e % kTile);
              put<kQKLo>(QH, QL, at, x.x);
              put<kQKLo>(KH, KL, at, x.y);
            });
      }
    } else {
      for (int task = warp; task < kTile / 8; task += nthreads / 32) {
        const int col = task * 8 + (lane & 7), i = i0 + col;
        const bool live = col < ni;
        const int ic = live ? i : i0;
        channel_scan(r.lw + ic, r.ws, C, p.excl, live, 2, lane,
                     [&](int t) {
                       return make_float2(ld(r.q + t * r.qs + ic),
                                          ld(r.k + t * r.ks + ic));
                     },
                     [&](int t, float Lt, float Lqt, float, float2 f,
                         bool valid) {
                       const int at = swz(kRows, t, col);
                       put<true>(QH, QL, at, f.x * fexp(Lqt), valid);
                       put<true>(KH, KL, at,
                                 f.y * fexp(-fmaxf(Lt, -kClamp)), valid);
                     });
        if (!live) {
          for (int t = lane >> 3; t < C; t += 4) {
            put<true>(QH, QL, swz(kRows, t, col), 0.0f);
            put<true>(KH, KL, swz(kRows, t, col), 0.0f);
          }
        }
      }
    }
    if (p.prof != nullptr) __syncthreads();
    lp.lap(kOutQKStage);
    sh.store(tid, s_end, nthreads, [&](int e, const F4& x) {
      const int col = e % kTile, j0 = (e / kTile) * 4;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        put<true>(SH, SL, swz(DVP, j0 + u, col),
                  j0 + u < p.dv ? x.v[u] : 0.0f);
    });
    if (p.prof != nullptr) __syncthreads();
    lp.lap(kOutSStage);
    fence_async_smem();
    __syncthreads();
    lp.lap(kOutStage);

    if (i0 == 0 && bc + ahead < gridDim.x)
      prefetch_chunk<T>(p, bc + ahead, true, tid, nthreads);
    // y += q S, a0 += A's s-tile 0, a1 += s-tile 1 (the second warpgroup)
    const int ksteps = (ni + 7) / 8, r0 = kTile * wg;
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk) {
      const int acc = i0 > 0 || kk > 0;
      const uint64_t qh = kdesc(QH, kRows, r0, kk);
      const uint64_t sh = kdesc(SH, DVP, 0, kk);
      mma_ss<DVP>(y, qh, sh, acc);
      mma_ss<DVP>(y, qh, kdesc(SL, DVP, 0, kk));
      if constexpr (kQKLo) mma_ss<DVP>(y, kdesc(QL, kRows, r0, kk), sh);
      const uint64_t kh = kdesc(KH, kRows, 0, kk);
      if (wg == 0) {
        mma_ss<kTile>(a0, qh, kh, acc);
        if constexpr (kQKLo) {
          mma_ss<kTile>(a0, qh, kdesc(KL, kRows, 0, kk));
          mma_ss<kTile>(a0, kdesc(QL, kRows, r0, kk), kh);
        }
      } else {
        mma_ss<2 * kTile>(a, qh, kh, acc);
        if constexpr (kQKLo) {
          mma_ss<2 * kTile>(a, qh, kdesc(KL, kRows, 0, kk));
          mma_ss<2 * kTile>(a, kdesc(QL, kRows, r0, kk), kh);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    fence_regs(a);
    if (p.prof != nullptr) __syncthreads();
    lp.lap(kOutQK);
  }
  __syncthreads();                   // every product has read q and k
  if (p.vec)
    vh.store(tid, vt.pieces(), nthreads,
             [&](int e, const uint4& x) { vt.use(e, x); });
  else
    vt.stage(false, tid, nthreads);
  fence_async_smem();
  __syncthreads();
  lp.lap(kOutV);

  // this thread's rows of y: t0 and t0 + 8
  const int t0 = kTile * wg + 16 * wl + lane / 4;
  if constexpr (SCALAR) {            // q_t S = exp(Lq_t) (q S)
    const float g0 = t0 < C ? fexp(static_cast<float>(Lq[t0])) : 0.0f;
    const float g1 = t0 + 8 < C ? fexp(static_cast<float>(Lq[t0 + 8])) : 0.0f;
#pragma unroll
    for (int e = 0; e < DVP / 2; ++e) y[e] *= (e % 4) < 2 ? g0 : g1;
  }
  // y += A v for s-tile st: A masked (and decayed), split into A fragments
  auto a_times_v = [&](float (&a)[32], int st) {
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * (e / 2);
        const int s = kTile * st + 8 * j + 2 * (lane % 4) + e % 2;
        float x = a[4 * j + e];
        const bool keep = s < C && t < C && (p.excl ? s < t : s <= t);
        if (SCALAR && keep)
          x *= fexp(fminf(static_cast<float>(Lq[t] - Lr[s]), 0.0f));
        x = keep ? x : 0.0f;
        const float hi = tf32(x);
        // column 2 (lane % 4) + e % 2 is logical column lane % 4 + 4 (e % 2)
        const int at = 2 * (e % 2) + e / 2;
        ah[j][at] = __float_as_uint(hi);
        al[j][at] = __float_as_uint(x - hi);
      }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t vh = kdesc(VH, DVP, 0, 8 * st + j);
      mma_rs<DVP>(y, ah[j], vh);
      mma_rs<DVP>(y, al[j], vh);
      if constexpr (kVLo) mma_rs<DVP>(y, ah[j], kdesc(VL, DVP, 0, 8 * st + j));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
  };
  a_times_v(a0, 0);
  if (wg == 1) a_times_v(a1, 1);
  if (p.prof != nullptr) __syncthreads();
  lp.lap(kOutY);

  // y through shared memory (over v's tile and, at dv > 64, S's), rows of
  // DVP + 8 floats, so rows go out in 16-byte pieces
  constexpr int YP = DVP + 8;
  float* Ys = sm;
  __syncthreads();                   // every A v has read v's tile
#pragma unroll
  for (int j = 0; j < DVP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      *reinterpret_cast<float2*>(Ys + (t0 + 4 * e) * YP + 8 * j
                                 + 2 * (lane % 4)) =
          make_float2(y[4 * j + e], y[4 * j + e + 1]);
  float* out = p.y + ((long long)b * p.S + (long long)c * C) * p.H * p.dv
               + (long long)h * p.dv;
  const long long ys = (long long)p.H * p.dv;
  if (p.dv % 4 == 0) {
    // a bulk copy a row (dv * 4 bytes, from and to 16-byte aligned rows):
    // the block waits only for the copies to read shared memory
    fence_async_smem();
    __syncthreads();
    if (tid < C)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          :: "l"(out + tid * ys), "r"(smem_u32(Ys + tid * YP)),
             "r"(p.dv * 4) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    __syncthreads();
    for (int e = tid; e < C * p.dv; e += nthreads) {
      const int t = e / p.dv, j = e % p.dv;
      out[t * ys + j] = Ys[t * YP + j];
    }
  }
  lp.lap(kOutStore);
  lp.total(kOutTotal);
}

// ------------------------------------------------------------- launching

template <typename T, bool SCALAR, int DVP>
int state_smem(int C) {
  return StateSmem<T, DVP>::bytes((C + kTile - 1) / kTile * kTile);
}

template <typename T, bool SCALAR, int DVP>
int out_smem(int) {
  return OutSmem<T, SCALAR, DVP>::kBytes;
}

// the three passes; prof (the profiled build) takes kSlots int64 a block,
// the state pass's blocks, then the fold's, then the out pass's; pass_ms,
// when not null, the time of each pass (CUDA events, synchronized)
template <typename T, bool SCALAR, int DVP>
cudaError_t run(Params p, int B, float* pass_ms, cudaStream_t st) {
  const int mt = (p.dk + kTile - 1) / kTile, nt = (p.C + kTile - 1) / kTile;
  const long long chunks = (long long)B * p.H * p.n;
  const long long fold_total = (long long)B * p.H * p.dk * p.dv;
  const long long fold_blocks = (fold_total + kFoldThreads - 1) / kFoldThreads;
  const int s1 = state_smem<T, SCALAR, DVP>(p.C);
  const int s3 = out_smem<T, SCALAR, DVP>(p.C);
  auto out = p.dk > kTile ? gla_out<T, SCALAR, DVP, true>
                          : gla_out<T, SCALAR, DVP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      gla_state<T, SCALAR, DVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      s1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(out, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s3);
  if (err != cudaSuccess) return err;
  // blocks in flight on the card: how far ahead a block prefetches
  int device = 0, sms = 0, occ1 = 0, occ3 = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ1, gla_state<T, SCALAR, DVP>, kStateThreads, s1);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ3, out, nt * kWarpgroup, s3);
  if (err != cudaSuccess) return err;
  cudaEvent_t ev[4];
  if (pass_ms != nullptr) {
    for (int i = 0; i < 4; ++i) {
      err = cudaEventCreate(&ev[i]);
      if (err != cudaSuccess) return err;
    }
    cudaEventRecord(ev[0], st);
  }
  long long* prof = p.prof;
  gla_state<T, SCALAR, DVP>
      <<<(unsigned)(chunks * mt), kStateThreads, s1, st>>>(p, sms * occ1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (pass_ms != nullptr) cudaEventRecord(ev[1], st);
  if (prof != nullptr) p.prof = prof + chunks * mt * kSlots;
  gla_fold<<<(unsigned)fold_blocks, kFoldThreads, 0, st>>>(p, fold_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (pass_ms != nullptr) cudaEventRecord(ev[2], st);
  if (prof != nullptr) p.prof = prof + (chunks * mt + fold_blocks) * kSlots;
  out<<<(unsigned)chunks, nt * kWarpgroup, s3, st>>>(p, sms * occ3);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (pass_ms != nullptr) {
    cudaEventRecord(ev[3], st);
    err = cudaEventSynchronize(ev[3]);
    for (int i = 0; i < 3 && err == cudaSuccess; ++i)
      err = cudaEventElapsedTime(&pass_ms[i], ev[i], ev[i + 1]);
    for (int i = 0; i < 4; ++i) cudaEventDestroy(ev[i]);
  }
  return err;
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, float* pass_ms,
                     cudaStream_t st) {
  const bool scalar = p.dw == 1;
  if (p.dv <= 64)
    return scalar ? run<T, true, 64>(p, B, pass_ms, st)
                  : run<T, false, 64>(p, B, pass_ms, st);
  return scalar ? run<T, true, 128>(p, B, pass_ms, st)
                : run<T, false, 128>(p, B, pass_ms, st);
}

int entry(const void* q, const void* k, const void* v, const void* lw,
          void* y, void* sfin, void* kv, void* decay, int B, int S, int H,
          int dk, int dv, int dw, int C, int flags, const long long* strides,
          void* prof, float* pass_ms, void* stream) {
  if (dk < 1 || dv < 1 || dk > 128 || dv > 128 || C < 1 || C > kMaxC ||
      S % C || (dw != 1 && dw != dk))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.lw = static_cast<const float*>(lw);
  p.y = static_cast<float*>(y);
  p.sfin = static_cast<float*>(sfin);
  p.kv = static_cast<float*>(kv);
  p.decay = static_cast<float*>(decay);
  p.prof = static_cast<long long*>(prof);
  p.S = S;
  p.H = H;
  p.BH = B * H;
  p.dk = dk;
  p.dv = dv;
  p.dw = dw;
  p.C = C;
  p.n = S / C;
  p.ld = (dv + 3) / 4 * 4;
  p.excl = flags & 1;
  p.vec = (flags >> 2) & 1;
  for (int d = 0; d < 3; ++d) {
    p.qs[d] = strides[d];
    p.ks[d] = strides[3 + d];
    p.vs[d] = strides[6 + d];
    p.ws[d] = strides[9 + d];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return flags & 2 ? (int)dispatch<__nv_bfloat16>(p, B, pass_ms, st)
                   : (int)dispatch<float>(p, B, pass_ms, st);
}

}  // namespace

// flags: bit 0 exclusive, bit 1 q/k/v are bf16 (else f32), bit 2 every
// row of q, k, v (and of a per-channel log_w) starts on 16 bytes and dk and
// dv are multiples of 16 bytes, so staging takes 16-byte loads.  dw is
// log_w's last dim: 1 (scalar decay) or dk.  kv is f32 scratch of
// (S/C) x B*H x dk x ld, ld = dv rounded up to 4, and decay of (S/C) x B*H
// x dw.  Launches the three passes on `stream` and returns the first
// non-zero cudaGetLastError() (0 on success).
extern "C" int repro_gla_scan(const void* q, const void* k, const void* v,
                              const void* lw, void* y, void* sfin, void* kv,
                              void* decay, int B, int S, int H, int dk,
                              int dv, int dw, int C, int flags, long long qs0,
                              long long qs1, long long qs2, long long ks0,
                              long long ks1, long long ks2, long long vs0,
                              long long vs1, long long vs2, long long ws0,
                              long long ws1, long long ws2, void* stream) {
  const long long strides[12] = {qs0, qs1, qs2, ks0, ks1, ks2,
                                 vs0, vs1, vs2, ws0, ws1, ws2};
  return entry(q, k, v, lw, y, sfin, kv, decay, B, S, H, dk, dv, dw, C, flags,
               strides, nullptr, nullptr, stream);
}

// The same launch, profiled: prof takes 8 int64 a block (the state pass's
// (S/C)*B*H*ceil(dk/64) blocks: StatePhase; then the fold's
// ceil(B*H*dk*dv/256): the whole; then the out pass's (S/C)*B*H:
// OutPhase), SM cycles of thread 0; pass_ms takes the three passes' times
// in ms (CUDA events; the call synchronizes).
extern "C" int repro_gla_scan_profile(
    const void* q, const void* k, const void* v, const void* lw, void* y,
    void* sfin, void* kv, void* decay, int B, int S, int H, int dk, int dv,
    int dw, int C, int flags, long long qs0, long long qs1, long long qs2,
    long long ks0, long long ks1, long long ks2, long long vs0, long long vs1,
    long long vs2, long long ws0, long long ws1, long long ws2, void* prof,
    void* pass_ms, void* stream) {
  const long long strides[12] = {qs0, qs1, qs2, ks0, ks1, ks2,
                                 vs0, vs1, vs2, ws0, ws1, ws2};
  return entry(q, k, v, lw, y, sfin, kv, decay, B, S, H, dk, dv, dw, C, flags,
               strides, prof, static_cast<float*>(pass_ms), stream);
}

// the dynamic shared memory of the state (pass 1) and out (pass 3)
// blocks, in bytes, for the given operands
extern "C" int repro_gla_scan_smem(int pass, int bf16, int scalar, int dv,
                                   int C) {
  const bool wide = dv > 64;
#define SSM_SMEM(T, S, D) \
  (pass == 1 ? state_smem<T, S, D>(C) : out_smem<T, S, D>(C))
  if (bf16) {
    if (scalar) return wide ? SSM_SMEM(__nv_bfloat16, true, 128)
                            : SSM_SMEM(__nv_bfloat16, true, 64);
    return wide ? SSM_SMEM(__nv_bfloat16, false, 128)
                : SSM_SMEM(__nv_bfloat16, false, 64);
  }
  if (scalar) return wide ? SSM_SMEM(float, true, 128)
                          : SSM_SMEM(float, true, 64);
  return wide ? SSM_SMEM(float, false, 128) : SSM_SMEM(float, false, 64);
#undef SSM_SMEM
}
