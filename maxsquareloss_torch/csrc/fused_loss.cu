// Fused softmax + (image-wise weighted) max-square loss, forward and
// backward, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernels of experiments/retired_pallas/fused_loss.py:
// _iw_fwd_kernel / _iw_bwd_kernel (launched by _iw_call) and _ms_fwd_kernel
// / _ms_bwd_kernel. For NHWC logits x (P = N*H*W pixels of C <= 32 classes),
// p = softmax_c(x), s = sum_c p^2 and a per-pixel weight w_pix:
//
//   forward   loss = scale * sum_pix w_pix * s
//   backward  dx_c = coef * g * w_pix * (p_c^2 - p_c * s)
//
// IW max-squares: w_pix = weights[n, argmax_c p] (the FIRST max: a strict >
// scan in ascending c), scale = -1/(N*C), coef = -2/(N*C). Max-squares: no
// weights (w_pix = 1), scale = -1/(2*P*C), coef = -1/(P*C). The weights
// get no gradient (the reference detaches them). g is read from device
// memory, so the backward needs no host sync.
//
// What bounds it: per pixel about 10*C FLOP (max, exp, divide, squares,
// the backward's products) against 4*C bytes read (and 4*C written by the
// backward), 2.5 FLOP/B, far under the H100's 20 FLOP/B fp32 ridge, so
// both directions are bound by device memory: the forward reads the logits
// once, the backward reads them once and writes dx once. Nothing else is
// saved: the backward recomputes the softmax.
//
// Design:
// - A block of 256 threads owns a contiguous run of pixels and walks it in
//   tiles of 256 pixels. A tile (256*C floats) is staged through shared
//   memory with coalesced loads; thread t then reads pixel t's C logits
//   (stride C is odd for C = 19, so 32 lanes hit 32 banks) into registers.
// - expf and a true division, as the reference's softmax; no fast math.
// - Deterministic reduction: each block sums its pixels in a fixed order
//   (thread, warp xor tree, warps in order) into one partial; a second
//   kernel of one block sums the partials in a fixed order and applies
//   the scale. The same shape gives bitwise the same loss on every run.
// - The backward writes dx over the staged tile in shared memory (each
//   thread only its own pixel's C values) and stores the tile coalesced.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 32;

// The pixel's softmax into p[0..C), its sum of squares and first argmax.
__device__ __forceinline__ float softmax_sq(const float* v, int C,
                                            float (&p)[kMaxC], int& amax) {
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) {
      p[c] = v[c];
      m = fmaxf(m, p[c]);
    }
  float z = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) {
      p[c] = expf(p[c] - m);
      z += p[c];
    }
  float s = 0.f, best = -1.f;
  amax = 0;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) {
      p[c] = p[c] / z;
      s = fmaf(p[c], p[c], s);
      if (p[c] > best) {
        best = p[c];
        amax = c;
      }
    }
  return s;
}

__device__ __forceinline__ float pixel_weight(const float* __restrict__ w,
                                              long long pix, int HW, int C,
                                              int amax) {
  return w ? __ldg(w + (pix / HW) * C + amax) : 1.f;
}

// Sum of v over the block, in a fixed order; the result in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  return total;
}

// Stage pixels [base, base + np) of x into the tile (coalesced).
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ x,
                                          long long base, int np, int C) {
  const float* src = x + base * C;
  const int nf = np * C;
#pragma unroll 4
  for (int i = threadIdx.x; i < nf; i += kThreads) tile[i] = __ldg(src + i);
}

// grid: one block per run of px_per_block pixels; partial[blockIdx.x].
__global__ void __launch_bounds__(kThreads)
    ms_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  long long P, int HW, int C, int px_per_block,
                  float* __restrict__ partial) {
  extern __shared__ float tile[];
  const long long p0 = (long long)blockIdx.x * px_per_block;
  float acc = 0.f;
  for (int it = 0; it < px_per_block; it += kThreads) {
    const long long base = p0 + it;
    if (base >= P) break;  // the same for every thread of the block
    const int np = (int)min((long long)kThreads, P - base);
    __syncthreads();  // the previous tile is no longer read
    load_tile(tile, x, base, np, C);
    __syncthreads();
    if (threadIdx.x < np) {
      float p[kMaxC];
      int amax;
      const float s = softmax_sq(tile + threadIdx.x * C, C, p, amax);
      acc += pixel_weight(w, base + threadIdx.x, HW, C, amax) * s;
    }
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// One block: out[0] = scale * sum of the partials, in a fixed order.
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const float* __restrict__ partial, int n, float scale,
                        float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partial[i];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[0] = scale * total;
}

__global__ void __launch_bounds__(kThreads)
    ms_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ g, long long P, int HW, int C,
                  int px_per_block, float coef, float* __restrict__ dx) {
  extern __shared__ float tile[];
  const float cg = coef * __ldg(g);
  const long long p0 = (long long)blockIdx.x * px_per_block;
  for (int it = 0; it < px_per_block; it += kThreads) {
    const long long base = p0 + it;
    if (base >= P) break;
    const int np = (int)min((long long)kThreads, P - base);
    __syncthreads();
    load_tile(tile, x, base, np, C);
    __syncthreads();
    if (threadIdx.x < np) {
      float p[kMaxC];
      int amax;
      float* v = tile + threadIdx.x * C;
      const float s = softmax_sq(v, C, p, amax);
      const float k = cg * pixel_weight(w, base + threadIdx.x, HW, C, amax);
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C) v[c] = k * (p[c] * p[c] - p[c] * s);
    }
    __syncthreads();
    float* dst = dx + base * C;
    const int nf = np * C;
#pragma unroll 4
    for (int i = threadIdx.x; i < nf; i += kThreads) dst[i] = tile[i];
  }
}

}  // namespace

// weights: (N, C) or null (max-squares). partial: `blocks` floats of
// scratch; out: one float. The two kernels run in order on `stream`.
extern "C" int msl_fused_max_square_fwd_f32(const void* x, const void* weights,
                                            long long P, int HW, int C,
                                            int px_per_block, int blocks,
                                            float scale, void* partial,
                                            void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * kThreads * C;
  ms_fwd_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(weights), P, HW,
      C, px_per_block, static_cast<float*>(partial));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<<<1, kThreads, 0, s>>>(static_cast<const float*>(partial),
                                             blocks, scale,
                                             static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// g: one float, the loss's cotangent, on the device.
extern "C" int msl_fused_max_square_bwd_f32(const void* x, const void* weights,
                                            const void* g, long long P, int HW,
                                            int C, int px_per_block, int blocks,
                                            float coef, void* dx, void* stream) {
  const size_t smem = sizeof(float) * kThreads * C;
  ms_bwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(weights),
      static_cast<const float*>(g), P, HW, C, px_per_block, coef,
      static_cast<float*>(dx));
  return (int)cudaGetLastError();
}

extern "C" const char* msl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
