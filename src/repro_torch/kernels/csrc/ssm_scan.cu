// Chunked gated-linear-attention scan (Mamba2 SSD / RWKV-6 core) for
// Hopper (sm_90a).
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
// final state), 0.14 ms at 3.35 TB/s, against some 26 GFLOP, 0.026 ms on
// the bf16 tensor cores: bytes bound it.  This first kernel runs every
// product on the f32 FMA units (67 TFLOP/s), as the TPU kernel takes f32
// dots, so its own FMA rate bounds it, well above the card's bound.
//
// Design.  The TPU grid walks (B*H, chunks) in order with the state in VMEM
// scratch.  Here one block of 256 threads owns one (b, h) and a slice of
// dvs columns of v and of the state, and loops over the chunks itself; the
// state stays in shared memory and never goes to device memory between
// chunks.  The columns of the state are independent (y[:, j] needs only
// S[:, j] and v[:, j]), so a block owning a slice recomputes A and needs no
// reduction across blocks; the wrapper picks the widest slice of 64, 32,
// 16 or 8 columns that fits in shared memory (at rwkv6's shape the whole
// 64: one block per (b, h)).  Per chunk the block stages q, k and log_w as
// f32 (C x (dk + 1) each, the pitch keeps column reads free of bank
// conflicts; 16-byte loads where every row is 16-byte aligned, as in the
// model), scans L down each column (four row groups, each from the sum of
// the groups above it), turns q into q_t and k into its two decayed forms
// in place, then makes y 32 rows at a time:
// the 32 x C rows of A (only the columns the causal mask can keep) go
// through shared memory, so all of A (64 KB at C 128) is never held.  Each
// thread of a 16 x 16 grid keeps a register tile of each product; the
// tiles of A and of the state update are sized at compile time (a switch
// on the column groups the mask keeps and on ceil(dk / 16)), so no FMA in
// their loops is predicated off.  No atomics, and every sum runs in a
// fixed order, so two launches give identical bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;        // rows of A held at once
constexpr int kBatch = 8;        // staging loads in flight per thread
constexpr int kVec = 4;          // 16-byte staging loads per array in flight
constexpr int kScanGroups = 4;   // row groups of the per-channel L scan
constexpr int kPhases = 7;       // profiled phases (see Params::prof)
constexpr float kClamp = 20.0f;  // the safe-gate clamp (models/ssm CLAMP)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* lw;
  float* y;
  float* sfin;
  // optional: per block, the SM clock cycles spent in each phase (stage,
  // L scan, k decay, A, y, state update, total), measured by thread 0
  // between barriers; null skips it
  long long* prof;
  int S, H, dk, dv, C, dvs;
  int vec;            // stage with 16-byte loads (all rows 16-byte aligned)
  long long qs[3], ks[3], vs[3], ws[3];   // (b, s, h) strides in elements
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// the 16 / sizeof(T) values of a 16-byte load, as f32, to dst[0..)
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

__host__ __device__ inline int a_size(int C, int dk) {
  const int rows = kRows * (C + 1), sums = kScanGroups * dk;
  return rows > sums ? rows : sums;
}

// One block's chunk in shared memory (see gla_kernel).
struct Tile {
  float* Qs;
  float* Ks;
  float* Ws;
  float* As;
  float* Vs;
  float* Ss;
  const float* Lc;
  const float* Lr;
  const float* Lqr;
  int C, dk, P, PA, dvs;
};

// Rows r0 .. r0 + kRows of A into As, the columns s < send that the causal
// mask can keep.  Thread (ty, tx) owns rows ty and ty + 16 and columns
// tx + 16c, c < NB = ceil(send / 16): a compile-time tile, so no FMA of
// the loop over i is predicated off.
template <int NB, bool SCALAR, bool EXCL>
__device__ __forceinline__ void a_rows(const Tile& m, int r0, int send,
                                       int tx, int ty) {
  float acc[2][NB];
  int ko[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    acc[0][c] = acc[1][c] = 0.0f;
    ko[c] = min(tx + 16 * c, m.C - 1) * m.P;
  }
  const int qa0 = min(r0 + ty, m.C - 1) * m.P;
  const int qb0 = min(r0 + ty + 16, m.C - 1) * m.P;
#pragma unroll 4
  for (int i = 0; i < m.dk; ++i) {
    const float qa = m.Qs[qa0 + i], qb = m.Qs[qb0 + i];
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const float kv = m.Ks[ko[c] + i];
      acc[0][c] = fmaf(qa, kv, acc[0][c]);
      acc[1][c] = fmaf(qb, kv, acc[1][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int t = r0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const int s = tx + 16 * c;
      if (s < send) {
        float val = 0.0f;
        if (t < m.C && (EXCL ? s < t : s <= t)) {
          val = acc[a][c];
          if (SCALAR) val *= expf(fminf(m.Lqr[t] - m.Lr[s], 0.0f));
        }
        m.As[(ty + 16 * a) * m.PA + s] = val;
      }
    }
  }
}

// S <- exp(Lc) * S + (k * exp(Lc - L))^T v.  Thread (ty, tx) owns rows
// ty + 16a, a < RS = ceil(dk / 16), and columns tx + 16c of the state.
template <int RS, bool SCALAR>
__device__ __forceinline__ void state_update(const Tile& m, int tx, int ty) {
  float acc[RS][4];
  int wo[RS];
#pragma unroll
  for (int a = 0; a < RS; ++a) {
    wo[a] = min(ty + 16 * a, m.dk - 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  }
  int vo[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) vo[c] = min(tx + 16 * c, m.dvs - 1);
#pragma unroll 4
  for (int s = 0; s < m.C; ++s) {
    float vv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) vv[c] = m.Vs[s * m.dvs + vo[c]];
#pragma unroll
    for (int a = 0; a < RS; ++a) {
      const float kd = m.Ws[s * m.P + wo[a]];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(kd, vv[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < RS; ++a) {
    const int i = ty + 16 * a;
    if (i >= m.dk) continue;
    const float decay = expf(m.Lc[SCALAR ? 0 : i]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      if (j < m.dvs) {
        float* sij = m.Ss + i * m.dvs + j;
        *sij = decay * *sij + acc[a][c];
      }
    }
  }
}

template <typename T, bool SCALAR, bool EXCL>
__global__ void __launch_bounds__(kThreads) gla_kernel(Params p) {
  extern __shared__ float smem[];
  const int C = p.C, dk = p.dk, P = dk + 1, dvs = p.dvs, PA = C + 1;
  const int nslice = (p.dv + dvs - 1) / dvs;
  const int bh = blockIdx.x / nslice;
  const int b = bh / p.H, h = bh % p.H;
  const int j0 = (blockIdx.x % nslice) * dvs;
  const int nj = min(dvs, p.dv - j0);       // columns this block owns
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float* Qs = smem;              // C x P: q, then q_t (per-channel decay)
  float* Ks = Qs + C * P;        // C x P: k, then k * exp(-max(L, -clamp))
  float* Ws = Ks + C * P;        // C x P: log_w, then L, then k * exp(Lc - L)
  float* As = Ws + C * P;        // kRows x PA: rows of A (first the L scan's
                                 // group sums)
  float* Vs = As + a_size(C, dk);  // C x dvs: the block's columns of v
  float* Ss = Vs + C * dvs;      // dk x dvs: the state
  float* Lc = Ss + dk * dvs;     // dk: L at the chunk's last row
  float* Lr = Lc + dk;           // C: scalar L of each row
  float* Lqr = Lr + C;           // C: scalar Lq of each row
  const Tile m{Qs, Ks, Ws, As, Vs, Ss, Lc, Lr, Lqr, C, dk, P, PA, dvs};

  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[2] + j0;
  const float* lw = p.lw + b * p.ws[0] + h * p.ws[2];
  // y is (B,S,H,dv) contiguous: row t of this (b, h) starts at y0 + t*H*dv
  float* y = p.y + ((long long)b * p.S * p.H + h) * p.dv + j0;
  const long long ys = (long long)p.H * p.dv;

  const bool prof = p.prof != nullptr && tid == 0;
  long long cycles[kPhases] = {0, 0, 0, 0, 0, 0, 0};
  long long mark = prof ? clock64() : 0;
  const long long start = mark;
  auto lap = [&](int phase) {
    if (prof) {
      const long long now = clock64();
      cycles[phase] += now - mark;
      mark = now;
    }
  };

  for (int e = tid; e < dk * dvs; e += kThreads) Ss[e] = 0.0f;

  // 16-byte staging (the wrapper checks alignment): vectors per row of q
  // and k, of log_w, and of the block's columns of v
  constexpr int VT = 16 / sizeof(T);
  const int vq = dk / VT, vw = SCALAR ? 1 : dk / 4, vv = dvs / VT;
  const int nvec = max(C * vq, max(SCALAR ? 0 : C * vw, C * vv));

  for (int t0 = 0; t0 < p.S; t0 += C) {
    // 1. stage the chunk as f32
    if (p.vec) {
      for (int e0 = tid; e0 < nvec; e0 += kThreads * kVec) {
        uint4 rq[kVec], rk[kVec], rw[kVec], rv[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const int e = e0 + u * kThreads;
          if (e < C * vq) {
            const long long t = t0 + e / vq;
            const int i = (e % vq) * VT;
            rq[u] = load16(q + t * p.qs[1] + i);
            rk[u] = load16(k + t * p.ks[1] + i);
          }
          if (!SCALAR && e < C * vw) {
            rw[u] = load16(lw + (t0 + e / vw) * p.ws[1] + (e % vw) * 4);
          }
          if (e < C * vv) {
            const int j = (e % vv) * VT;
            rv[u] = j < nj ? load16(v + (t0 + e / vv) * p.vs[1] + j)
                           : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const int e = e0 + u * kThreads;
          if (e < C * vq) {
            const int o = (e / vq) * P + (e % vq) * VT;
            unpack(rq[u], Qs + o, T());
            unpack(rk[u], Ks + o, T());
          }
          if (!SCALAR && e < C * vw)
            unpack(rw[u], Ws + (e / vw) * P + (e % vw) * 4, 0.0f);
          if (e < C * vv) unpack(rv[u], Vs + e * VT, T());
        }
      }
    }
    for (int e0 = tid; !p.vec && e0 < C * dk; e0 += kThreads * kBatch) {
      float rq[kBatch], rk[kBatch], rw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < C * dk) {
          const long long t = t0 + e / dk;
          const int i = e % dk;
          rq[u] = load(q + t * p.qs[1] + i);
          rk[u] = load(k + t * p.ks[1] + i);
          if (!SCALAR) rw[u] = __ldg(lw + t * p.ws[1] + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < C * dk) {
          const int o = (e / dk) * P + e % dk;
          Qs[o] = rq[u];
          Ks[o] = rk[u];
          if (!SCALAR) Ws[o] = rw[u];
        }
      }
    }
    for (int e0 = tid; !p.vec && e0 < C * dvs; e0 += kThreads * kBatch) {
      float rv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads, j = e % dvs;
        rv[u] = (e < C * dvs && j < nj)
                    ? load(v + (long long)(t0 + e / dvs) * p.vs[1] + j) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < C * dvs) Vs[e] = rv[u];
      }
    }
    if (SCALAR) {
      for (int t = tid; t < C; t += kThreads)
        Lr[t] = __ldg(lw + (long long)(t0 + t) * p.ws[1]);
    }
    __syncthreads();
    lap(0);

    // 2. L = cumsum(lw) down each column, in a fixed order
    if (SCALAR) {
      if (tid == 0) {
        float run = 0.0f;
        for (int t = 0; t < C; ++t) {
          const float l = Lr[t];
          run += l;
          Lqr[t] = EXCL ? run - l : run;
          Lr[t] = run;
        }
        Lc[0] = run;
      }
    } else {
      // G groups of R rows per column: each group sums its rows, then scans
      // them from the sum of the groups above it (As holds the G x dk sums)
      const int G = max(1, min(kScanGroups, kThreads / dk));
      const int R = (C + G - 1) / G;
      const int i = tid % dk, g = tid / dk;
      const int lo = min(C, g * R), hi = min(C, lo + R);
      if (g < G) {
        float sum = 0.0f;
        for (int t = lo; t < hi; ++t) sum += Ws[t * P + i];
        As[g * dk + i] = sum;
      }
      __syncthreads();
      if (g < G) {
        float run = 0.0f;
        for (int gg = 0; gg < g; ++gg) run += As[gg * dk + i];
        for (int t = lo; t < hi; ++t) {
          const float l = Ws[t * P + i];
          run += l;
          Qs[t * P + i] *= expf(EXCL ? run - l : run);
          Ws[t * P + i] = run;
        }
        if (g == G - 1) Lc[i] = run;
      }
    }
    __syncthreads();
    lap(1);

    // 3. k's two decayed forms: for A (per-channel) and for the state
    for (int e = tid; e < C * dk; e += kThreads) {
      const int s = e / dk, i = e % dk, o = s * P + i;
      const float kk = Ks[o];
      if (SCALAR) {
        Ws[o] = kk * expf(Lc[0] - Lr[s]);
      } else {
        const float l = Ws[o];
        Ks[o] = kk * expf(-fmaxf(l, -kClamp));
        Ws[o] = kk * expf(Lc[i] - l);
      }
    }
    __syncthreads();
    lap(2);

    // 4. y, kRows rows at a time; thread (ty, tx) owns rows ty + 16a
    for (int r0 = 0; r0 < C; r0 += kRows) {
      const int send = min(C, r0 + kRows);  // A[., s] is masked for s >= send
      switch ((send + 15) / 16) {  // 4a. rows r0.. of A
        case 1: a_rows<1, SCALAR, EXCL>(m, r0, send, tx, ty); break;
        case 2: a_rows<2, SCALAR, EXCL>(m, r0, send, tx, ty); break;
        case 3: a_rows<3, SCALAR, EXCL>(m, r0, send, tx, ty); break;
        case 4: a_rows<4, SCALAR, EXCL>(m, r0, send, tx, ty); break;
        case 5: a_rows<5, SCALAR, EXCL>(m, r0, send, tx, ty); break;
        case 6: a_rows<6, SCALAR, EXCL>(m, r0, send, tx, ty); break;
        case 7: a_rows<7, SCALAR, EXCL>(m, r0, send, tx, ty); break;
        default: a_rows<8, SCALAR, EXCL>(m, r0, send, tx, ty); break;
      }
      __syncthreads();
      lap(3);
      {  // 4b. y = A v + q_t S for rows r0.., columns tx + 16c
        float yi[2][4], ye[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) yi[a][c] = ye[a][c] = 0.0f;
        int vo[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) vo[c] = min(tx + 16 * c, dvs - 1);
#pragma unroll 4
        for (int s = 0; s < send; ++s) {
          const float aa = As[ty * PA + s], ab = As[(ty + 16) * PA + s];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float vv = Vs[s * dvs + vo[c]];
            yi[0][c] = fmaf(aa, vv, yi[0][c]);
            yi[1][c] = fmaf(ab, vv, yi[1][c]);
          }
        }
        const int ra = min(r0 + ty, C - 1), rb = min(r0 + ty + 16, C - 1);
#pragma unroll 4
        for (int i = 0; i < dk; ++i) {
          const float qa = Qs[ra * P + i], qb = Qs[rb * P + i];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float sv = Ss[i * dvs + vo[c]];
            ye[0][c] = fmaf(qa, sv, ye[0][c]);
            ye[1][c] = fmaf(qb, sv, ye[1][c]);
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int t = r0 + ty + 16 * a;
          if (t >= C) continue;
          // scalar decay: q_t S = exp(Lq_t) (q S), q itself fed A
          const float g = SCALAR ? expf(Lqr[t]) : 1.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tx + 16 * c;
            if (j < nj)
              y[(long long)(t0 + t) * ys + j] = yi[a][c] + g * ye[a][c];
          }
        }
      }
      __syncthreads();
      lap(4);
    }

    // 5. the state update
    switch ((dk + 15) / 16) {
      case 1: state_update<1, SCALAR>(m, tx, ty); break;
      case 2: state_update<2, SCALAR>(m, tx, ty); break;
      case 3: state_update<3, SCALAR>(m, tx, ty); break;
      case 4: state_update<4, SCALAR>(m, tx, ty); break;
      case 5: state_update<5, SCALAR>(m, tx, ty); break;
      case 6: state_update<6, SCALAR>(m, tx, ty); break;
      case 7: state_update<7, SCALAR>(m, tx, ty); break;
      default: state_update<8, SCALAR>(m, tx, ty); break;
    }
    __syncthreads();
    lap(5);
  }

  float* sfin = p.sfin + (long long)bh * dk * p.dv + j0;
  for (int e = tid; e < dk * dvs; e += kThreads) {
    const int i = e / dvs, j = e % dvs;
    if (j < nj) sfin[(long long)i * p.dv + j] = Ss[e];
  }
  if (prof) {
    cycles[6] = clock64() - start;
    for (int k = 0; k < kPhases; ++k)
      p.prof[(long long)blockIdx.x * kPhases + k] = cycles[k];
  }
}

template <typename T, bool SCALAR, bool EXCL>
cudaError_t launch(const Params& p, int blocks, size_t smem,
                   cudaStream_t stream) {
  auto kernel = gla_kernel<T, SCALAR, EXCL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, bool scalar, bool excl, int blocks,
                     size_t smem, cudaStream_t stream) {
  if (scalar) {
    return excl ? launch<T, true, true>(p, blocks, smem, stream)
                : launch<T, true, false>(p, blocks, smem, stream);
  }
  return excl ? launch<T, false, true>(p, blocks, smem, stream)
              : launch<T, false, false>(p, blocks, smem, stream);
}

size_t smem_bytes(int C, int dk, int dvs) {
  return sizeof(float) * (3 * (size_t)C * (dk + 1) + (size_t)a_size(C, dk) +
                          (size_t)C * dvs + (size_t)dk * dvs + dk + 2 * C);
}

}  // namespace

// flags: bit 0 exclusive, bit 1 q/k/v are bf16 (else f32), bit 2 every
// row of q, k, v (and of a per-channel log_w) starts on 16 bytes and dk and
// dv are multiples of 16 bytes, so staging takes 16-byte loads.  dw is
// log_w's last dim: 1 (scalar decay) or dk.  A block owns the widest slice
// of 64, 32, 16 or 8 columns of v (at most dv) that fits in the card's
// shared memory.  prof, when not null, takes 7 int64 per block
// (Params::prof); there are B * H * ceil(dv / slice) blocks.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_gla_scan(const void* q, const void* k, const void* v,
                              const void* lw, void* y, void* sfin, int B,
                              int S, int H, int dk, int dv, int dw, int C,
                              int flags, long long qs0,
                              long long qs1, long long qs2, long long ks0,
                              long long ks1, long long ks2, long long vs0,
                              long long vs1, long long vs2, long long ws0,
                              long long ws1, long long ws2, void* prof,
                              void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.lw = static_cast<const float*>(lw);
  p.y = static_cast<float*>(y);
  p.sfin = static_cast<float*>(sfin);
  p.prof = static_cast<long long*>(prof);
  p.S = S;
  p.H = H;
  p.dk = dk;
  p.dv = dv;
  p.C = C;
  p.vec = (flags >> 2) & 1;
  const long long strides[4][3] = {{qs0, qs1, qs2}, {ks0, ks1, ks2},
                                   {vs0, vs1, vs2}, {ws0, ws1, ws2}};
  for (int d = 0; d < 3; ++d) {
    p.qs[d] = strides[0][d];
    p.ks[d] = strides[1][d];
    p.vs[d] = strides[2][d];
    p.ws[d] = strides[3][d];
  }
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  int dvs = 0;
  for (int width = 64; width >= 8 && !dvs; width /= 2) {
    const int d = width < dv ? width : dv;
    if (smem_bytes(C, dk, d) <= (size_t)limit) dvs = d;
  }
  if (!dvs) return (int)cudaErrorInvalidValue;
  p.dvs = dvs;
  const size_t smem = smem_bytes(C, dk, dvs);
  const int blocks = B * H * ((dv + dvs - 1) / dvs);
  const bool scalar = dw == 1, excl = flags & 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return flags & 2
             ? (int)dispatch<__nv_bfloat16>(p, scalar, excl, blocks, smem, st)
             : (int)dispatch<float>(p, scalar, excl, blocks, smem, st);
}
