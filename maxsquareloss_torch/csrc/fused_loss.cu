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
// saved: the backward recomputes the softmax. expf and the division are
// many instructions each, so the arithmetic of a tile takes about as long
// as its bytes: the two must overlap.
//
// Design:
// - A block of 256 threads owns a contiguous run of pixels and walks it in
//   tiles of 256 pixels. A tile is one contiguous run of 256*C floats, so
//   one thread fetches it with a single bulk asynchronous copy
//   (cp.async.bulk, no tensor map) that reports to an mbarrier, into a ring
//   of tile buffers in shared memory: two in the forward, three in the
//   backward. The copies run one or two tiles ahead of the arithmetic, and
//   no thread spends instructions or registers on them. Thread t then
//   reads pixel t's C logits (stride C is odd for C = 19, so 32 lanes hit
//   32 banks) into registers.
// - A bulk copy moves multiples of 16 bytes between 16-byte aligned
//   addresses. A ragged last tile whose np*C floats are no such multiple
//   (or any tile, when x or dx is not 16-byte aligned) is staged by all
//   threads with plain loads and stores instead.
// - The class count is a compile-time constant for 19, 16 and 13 classes
//   (the label sets of the datasets); other counts up to 32 take a body
//   with a run-time count.
// - The pixel's image (the row of the weights) comes without a division
//   per pixel: one at the block's first pixel, then a compare per pixel
//   (a tile of 256 pixels crosses at most one image boundary when
//   H*W >= 256; smaller images take a 32-bit division).
// - expf and a true division, as the reference's softmax; no fast math.
// - Deterministic reduction: each block sums its pixels in a fixed order
//   (thread, warp xor tree, warps in order) into one partial; a second
//   kernel of one block sums the partials in a fixed order and applies
//   the scale. The same shape gives bitwise the same loss on every run.
// - The backward writes dx over the staged tile in shared memory (each
//   thread only its own pixel's C values); one thread sends the tile to
//   device memory with a bulk store, and refills a buffer only when the
//   store that read it has finished.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 32;
constexpr int kFwdStages = 2;  // tile buffers of the forward
constexpr int kBwdStages = 3;  // of the backward: one more, a store is in flight

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes: a multiple of 16; dst, src 16-byte aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Until every bulk store of this thread is complete.
__device__ __forceinline__ void bulk_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to bulk copies.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The pixel's softmax into p[0..C), its sum of squares and first argmax.
// CT: the class count at compile time, or 0 for the run-time count C.
template <int CT>
__device__ __forceinline__ float softmax_sq(const float* v, int C,
                                            float (&p)[CT ? CT : kMaxC], int& amax) {
  constexpr int U = CT ? CT : kMaxC;
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < U; ++c)
    if (CT || c < C) {
      p[c] = v[c];
      m = fmaxf(m, p[c]);
    }
  float z = 0.f;
#pragma unroll
  for (int c = 0; c < U; ++c)
    if (CT || c < C) {
      p[c] = expf(p[c] - m);
      z += p[c];
    }
  float s = 0.f, best = -1.f;
  amax = 0;
#pragma unroll
  for (int c = 0; c < U; ++c)
    if (CT || c < C) {
      p[c] = p[c] / z;
      s = fmaf(p[c], p[c], s);
      if (p[c] > best) {
        best = p[c];
        amax = c;
      }
    }
  return s;
}

// The image that holds each pixel of the current tile, for a block whose
// first pixel is p0: one 64-bit division here, none per pixel
// (tests/test_torch_fused_loss.py restates this arithmetic).
struct ImageIndex {
  long long n0;  // the image of the tile's first pixel
  int r0;        // that pixel's index in its image
  int HW;
  __device__ ImageIndex(long long p0, int hw) : n0(p0 / hw), r0((int)(p0 - (p0 / hw) * hw)), HW(hw) {}
  __device__ __forceinline__ long long of(int t) const {
    const int off = r0 + t;
    return HW >= kThreads ? n0 + (off >= HW) : n0 + off / HW;
  }
  __device__ __forceinline__ void next_tile() {
    r0 += kThreads;
    if (HW >= kThreads) {
      if (r0 >= HW) {
        r0 -= HW;
        ++n0;
      }
    } else {
      n0 += r0 / HW;
      r0 %= HW;
    }
  }
};

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

// The tiles of one block: a ring of STAGES buffers that one thread fills
// with bulk copies, each reporting to its buffer's mbarrier.
template <int STAGES>
struct TileRing {
  float* tiles;
  uint64_t* full;
  const float* x;
  long long p0, P;
  int C, ntiles;
  bool bulk_ok;

  __device__ TileRing(float* tiles_, uint64_t* full_, const float* x_, long long P_, int C_,
                      int px_per_block, bool bulk_ok_)
      : tiles(tiles_), full(full_), x(x_), p0((long long)blockIdx.x * px_per_block), P(P_),
        C(C_), bulk_ok(bulk_ok_) {
    const long long mine = min((long long)px_per_block, P - p0);
    ntiles = (int)((mine + kThreads - 1) / kThreads);
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int it = 0; it < STAGES && it < ntiles; ++it) fetch(it);
  }
  __device__ __forceinline__ long long base(int it) const {
    return p0 + (long long)it * kThreads;
  }
  __device__ __forceinline__ int pixels(int it) const {
    return (int)min((long long)kThreads, P - base(it));
  }
  // Whether a tile of np pixels moves by bulk copy (the same for every thread).
  __device__ __forceinline__ bool bulk(int np) const { return bulk_ok && (np * C) % 4 == 0; }
  __device__ __forceinline__ float* slot(int it) const {
    return tiles + (size_t)(it % STAGES) * kThreads * C;
  }
  // One thread: start the copy of tile `it` into its buffer, if it moves in bulk.
  __device__ __forceinline__ void fetch(int it) const {
    const int np = pixels(it);
    if (!bulk(np)) return;
    const uint32_t bytes = (uint32_t)np * C * sizeof(float);
    mbar_expect_tx(full + it % STAGES, bytes);
    bulk_load(slot(it), x + base(it) * C, bytes, full + it % STAGES);
  }
  // Every thread: return once tile `it` lies in its buffer.
  __device__ __forceinline__ void arrive(int it) const {
    const int np = pixels(it);
    if (bulk(np)) {
      mbar_wait(full + it % STAGES, (it / STAGES) & 1);
    } else {  // the buffer is free: its last reader met a barrier since
      const float* src = x + base(it) * C;
      float* dst = slot(it);
      for (int i = threadIdx.x; i < np * C; i += kThreads) dst[i] = __ldg(src + i);
      __syncthreads();
    }
  }
};

// grid: one block per run of px_per_block pixels; partial[blockIdx.x].
template <int CT>
__global__ void __launch_bounds__(kThreads)
    ms_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w, long long P, int HW,
                  int C, int px_per_block, bool bulk_ok, float* __restrict__ partial) {
  extern __shared__ __align__(128) float tiles[];
  __shared__ __align__(8) uint64_t full[kFwdStages];
  if (CT) C = CT;
  TileRing<kFwdStages> ring(tiles, full, x, P, C, px_per_block, bulk_ok);
  ImageIndex image(w ? ring.p0 : 0, HW);
  float acc = 0.f;
  for (int it = 0; it < ring.ntiles; ++it) {
    ring.arrive(it);
    if (threadIdx.x < ring.pixels(it)) {
      float p[CT ? CT : kMaxC];
      int amax;
      const float s = softmax_sq<CT>(ring.slot(it) + threadIdx.x * C, C, p, amax);
      acc += (w ? __ldg(w + image.of(threadIdx.x) * C + amax) : 1.f) * s;
    }
    if (w) image.next_tile();
    if (it + kFwdStages < ring.ntiles) {  // the same for every thread
      __syncthreads();                    // the buffer is read
      if (threadIdx.x == 0) ring.fetch(it + kFwdStages);
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

template <int CT>
__global__ void __launch_bounds__(kThreads)
    ms_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ g, long long P, int HW, int C, int px_per_block,
                  bool bulk_ok, float coef, float* __restrict__ dx) {
  extern __shared__ __align__(128) float tiles[];
  __shared__ __align__(8) uint64_t full[kBwdStages];
  if (CT) C = CT;
  TileRing<kBwdStages> ring(tiles, full, x, P, C, px_per_block, bulk_ok);
  ImageIndex image(w ? ring.p0 : 0, HW);
  const float cg = coef * __ldg(g);
  for (int it = 0; it < ring.ntiles; ++it) {
    ring.arrive(it);
    const int np = ring.pixels(it);
    const bool bulk = ring.bulk(np);
    float* tile = ring.slot(it);
    if (threadIdx.x < np) {
      float p[CT ? CT : kMaxC];
      int amax;
      float* v = tile + threadIdx.x * C;
      const float s = softmax_sq<CT>(v, C, p, amax);
      const float k = cg * (w ? __ldg(w + image.of(threadIdx.x) * C + amax) : 1.f);
#pragma unroll
      for (int c = 0; c < (CT ? CT : kMaxC); ++c)
        if (CT || c < C) v[c] = k * (p[c] * p[c] - p[c] * s);
    }
    if (w) image.next_tile();
    if (bulk) fence_async_proxy();
    __syncthreads();  // the tile holds dx
    float* dst = dx + ring.base(it) * C;
    if (!bulk) {
      for (int i = threadIdx.x; i < np * C; i += kThreads) dst[i] = tile[i];
    } else if (threadIdx.x == 0) {
      bulk_store(dst, tile, (uint32_t)np * C * sizeof(float));
    }
    if (threadIdx.x == 0) {
      // the store of tile it-1 has read its buffer: tile it+2 may land there
      bulk_store_wait_read<1>();
      if (it >= 1 && it + 2 < ring.ntiles) ring.fetch(it + 2);
    }
  }
  if (threadIdx.x == 0) bulk_store_wait_all();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int CT>
int launch_fwd(const float* x, const float* w, long long P, int HW, int C, int px_per_block,
               int blocks, float* partial, cudaStream_t s) {
  const size_t smem = sizeof(float) * kFwdStages * kThreads * C;
  cudaError_t e = cudaFuncSetAttribute(ms_fwd_kernel<CT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ms_fwd_kernel<CT><<<blocks, kThreads, smem, s>>>(x, w, P, HW, C, px_per_block, aligned16(x),
                                                   partial);
  return (int)cudaGetLastError();
}

template <int CT>
int launch_bwd(const float* x, const float* w, const float* g, long long P, int HW, int C,
               int px_per_block, int blocks, float coef, float* dx, cudaStream_t s) {
  const size_t smem = sizeof(float) * kBwdStages * kThreads * C;
  cudaError_t e = cudaFuncSetAttribute(ms_bwd_kernel<CT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ms_bwd_kernel<CT><<<blocks, kThreads, smem, s>>>(x, w, g, P, HW, C, px_per_block,
                                                   aligned16(x) && aligned16(dx), coef, dx);
  return (int)cudaGetLastError();
}

}  // namespace

// weights: (N, C) or null (max-squares). partial: `blocks` floats of
// scratch; out: one float. The two kernels run in order on `stream`.
// px_per_block: a multiple of 256.
extern "C" int msl_fused_max_square_fwd_f32(const void* x, const void* weights,
                                            long long P, int HW, int C,
                                            int px_per_block, int blocks,
                                            float scale, void* partial,
                                            void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(weights);
  float* pf = static_cast<float*>(partial);
  if (C < 1 || C > kMaxC || px_per_block % kThreads) return (int)cudaErrorInvalidValue;
  int e;
  switch (C) {
    case 19: e = launch_fwd<19>(xf, wf, P, HW, C, px_per_block, blocks, pf, s); break;
    case 16: e = launch_fwd<16>(xf, wf, P, HW, C, px_per_block, blocks, pf, s); break;
    case 13: e = launch_fwd<13>(xf, wf, P, HW, C, px_per_block, blocks, pf, s); break;
    default: e = launch_fwd<0>(xf, wf, P, HW, C, px_per_block, blocks, pf, s);
  }
  if (e != 0) return e;
  sum_partials_kernel<<<1, kThreads, 0, s>>>(pf, blocks, scale, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// g: one float, the loss's cotangent, on the device.
extern "C" int msl_fused_max_square_bwd_f32(const void* x, const void* weights,
                                            const void* g, long long P, int HW,
                                            int C, int px_per_block, int blocks,
                                            float coef, void* dx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(weights);
  const float* gf = static_cast<const float*>(g);
  float* df = static_cast<float*>(dx);
  if (C < 1 || C > kMaxC || px_per_block % kThreads) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 19: return launch_bwd<19>(xf, wf, gf, P, HW, C, px_per_block, blocks, coef, df, s);
    case 16: return launch_bwd<16>(xf, wf, gf, P, HW, C, px_per_block, blocks, coef, df, s);
    case 13: return launch_bwd<13>(xf, wf, gf, P, HW, C, px_per_block, blocks, coef, df, s);
    default: return launch_bwd<0>(xf, wf, gf, P, HW, C, px_per_block, blocks, coef, df, s);
  }
}

extern "C" const char* msl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
