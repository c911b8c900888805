// Packed segmented (||a-b||^2, ||a||^2) reduction for Hopper (sm_90a).
//
// Replaces repro/kernels/relerr.py::packed_sq_norms, the Pallas TPU kernel
// (_packed_relerr_kernel) that the checker's reduction runs on.  N tensor
// pairs are packed into two block-aligned f32 buffers (layout from
// repro_torch.core.relerr_engine.pack_device): block i belongs to pair
// seg_ids[i], holds counts[i] valid elements, and the blocks of one pair
// are contiguous with seg_ids non-decreasing.  The result is an (N, 2) f32
// array of (||a-b||^2, ||a||^2) per pair.
//
// Bound: device memory.  Every packed element is read once from each
// buffer (8 bytes) for 3 flops, far below the ~20 flops per byte where
// H100's f32 rate would take over; the least time is 8 * elements / 3.35
// TB/s.
//
// Design.  The TPU kernel walks the grid in order and carries each pair's
// sum in its output block across grid steps; Hopper's blocks run in no
// order, so the reduction is two fixed-order passes instead:
//   stage 1: one thread block per packed block; 16-byte loads; the padding
//            is masked by select against counts[i] (never by multiply, so
//            NaN garbage in the pad cannot leak while a NaN in a real
//            element propagates); a fixed warp-shuffle tree gives the
//            block's (dd, aa) partial;
//   stage 2: one thread block per pair finds its contiguous run of
//            partials by binary search and sums it in a fixed order, in
//            double, then rounds to f32.
// No float atomics: the result is bit-identical from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order block reduction of two values; thread 0 holds the result.
template <typename T>
__device__ __forceinline__ void block_sum2(T& x, T& y, T* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  y = warp_sum(y);
  if (lane == 0) {
    smem[warp] = x;
    smem[kWarps + warp] = y;
  }
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? smem[lane] : T(0);
    y = lane < kWarps ? smem[kWarps + lane] : T(0);
    x = warp_sum(x);
    y = warp_sum(y);
  }
}

__device__ __forceinline__ void accumulate(float a, float b, bool valid,
                                           float& dd, float& aa) {
  const float d = valid ? a - b : 0.0f;
  const float av = valid ? a : 0.0f;
  dd += d * d;
  aa += av * av;
}

__global__ void __launch_bounds__(kThreads)
block_partials(const float* __restrict__ a, const float* __restrict__ b,
               const int* __restrict__ counts, float2* __restrict__ partial,
               int block) {
  __shared__ float smem[2 * kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * block;
  const int cnt = counts[blockIdx.x];
  const float4* a4 = reinterpret_cast<const float4*>(a + base);
  const float4* b4 = reinterpret_cast<const float4*>(b + base);
  float dd = 0.0f, aa = 0.0f;
  for (int v = threadIdx.x; v < block / 4; v += kThreads) {
    const float4 x = __ldcs(a4 + v);
    const float4 y = __ldcs(b4 + v);
    const int e = 4 * v;
    accumulate(x.x, y.x, e + 0 < cnt, dd, aa);
    accumulate(x.y, y.y, e + 1 < cnt, dd, aa);
    accumulate(x.z, y.z, e + 2 < cnt, dd, aa);
    accumulate(x.w, y.w, e + 3 < cnt, dd, aa);
  }
  block_sum2(dd, aa, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = make_float2(dd, aa);
}

// First index i in [0, n) with seg_ids[i] >= s (n if none).
__device__ int first_at_least(const int* __restrict__ seg_ids, int n, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (seg_ids[mid] < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_sums(const int* __restrict__ seg_ids,
             const float2* __restrict__ partial, float* __restrict__ out,
             int nb) {
  __shared__ double smem[2 * kWarps];
  __shared__ int range[2];
  const int s = blockIdx.x;
  if (threadIdx.x == 0) {
    range[0] = first_at_least(seg_ids, nb, s);
    range[1] = first_at_least(seg_ids, nb, s + 1);
  }
  __syncthreads();
  double dd = 0.0, aa = 0.0;
  for (int i = range[0] + threadIdx.x; i < range[1]; i += kThreads) {
    const float2 p = partial[i];
    dd += p.x;
    aa += p.y;
  }
  block_sum2(dd, aa, smem);
  if (threadIdx.x == 0) {
    out[2 * s] = static_cast<float>(dd);
    out[2 * s + 1] = static_cast<float>(aa);
  }
}

}  // namespace

// a, b: nb * block f32 (16-byte aligned, block % 4 == 0); seg_ids, counts:
// nb int32; partial: nb * 2 f32 scratch; out: n_segments * 2 f32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_packed_sq_norms(const float* a, const float* b,
                                     const int* seg_ids, const int* counts,
                                     float* partial, float* out, int nb,
                                     int block, int n_segments,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* part = reinterpret_cast<float2*>(partial);
  block_partials<<<nb, kThreads, 0, st>>>(a, b, counts, part, block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_sums<<<n_segments, kThreads, 0, st>>>(seg_ids, part, out, nb);
  return static_cast<int>(cudaGetLastError());
}
