// The device-memory accesses of the fused bottleneck's conv3 epilogue on the
// tc route (fused_bottleneck.cu, conv3_row_tc), replayed without the
// convolutions, for Hopper (sm_90a).
//
// out = relu(x + 1) in bf16 (NHWC, Cin channels), over the output rows each
// block of the fused kernel finishes: the same grid (column strips of TW, N *
// d * S chains of RS rows), block size, passes of bn3 columns with a barrier
// before each, and dynamic shared memory (unused here) so that as many blocks
// share an SM as there. Two orders of the same accesses:
// - fragment (pieces 0): as conv3_row_tc's epilogue, from the wgmma
//   accumulator fragment: thread t of warpgroup g reads and writes 4 bytes
//   (channels n0 + g NW + 8j + 2(t%4), +1) of pixels 64 tile + 16 (t/32)%4 +
//   8h + (t%32)/4, so one warp instruction touches 8 pixels x 16 bytes;
// - pieces (1): each pass's pixels and channels in 16-byte pieces, the
//   threads of a pixel on its consecutive pieces (the order an epilogue
//   staged through shared memory would store in).
// Their difference bounds what staging conv3's epilogue could win.
// kernels are launched by maxsquareloss_torch/experiments/tc_tiles.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const uint32_t* x;  // bf16 pairs
  uint32_t* out;
  int N, H, W, Cin, d, TW, RS, S, bn3;
};

// relu(v + 1) rounded to bf16, as fp32
__device__ __forceinline__ float step(float v) {
  return fmaxf(__bfloat162float(__float2bfloat16_rn(v + 1.f)), 0.f);
}

// a pair of bf16 (low address in the low half) through step
__device__ __forceinline__ uint32_t step2(uint32_t u) {
  return (__float_as_uint(step(__uint_as_float(u << 16))) >> 16) |
         (__float_as_uint(step(__uint_as_float(u & 0xffff0000u))) & 0xffff0000u);
}

template <int MT, int NW>
__device__ __forceinline__ void fragment_row(const Args& a, size_t row, int col0) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, tq = tid & 3;
  for (int n0 = 0; n0 < a.Cin; n0 += a.bn3) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int ch = n0 + wg * NW + 8 * j + 2 * tq;
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pix = 64 * t + 16 * warp + 8 * h + g;
          const int col = col0 + pix;
          if (pix < a.TW && col < a.W) {
            const size_t o = ((row * a.W + col) * a.Cin + ch) / 2;
            a.out[o] = step2(__ldg(a.x + o));
          }
        }
    }
  }
}

__device__ __forceinline__ void pieces_row(const Args& a, size_t row, int col0) {
  const int per_px = a.bn3 / 8;
  for (int n0 = 0; n0 < a.Cin; n0 += a.bn3) {
    __syncthreads();
    for (int i = threadIdx.x; i < a.TW * per_px; i += blockDim.x) {
      const int pix = i / per_px;
      const int col = col0 + pix;
      if (col < a.W) {
        const size_t o = ((row * a.W + col) * a.Cin + n0 + 8 * (i - pix * per_px)) / 2;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(a.x + o));
        *reinterpret_cast<uint4*>(a.out + o) =
            make_uint4(step2(v.x), step2(v.y), step2(v.z), step2(v.w));
      }
    }
  }
}

// the fused kernel's walk: block y = ((n * d) + residue) * S + segment
template <int MT, int NW, bool Pieces>
__global__ void epilogue_probe_kernel(const Args a) {
  int chain = blockIdx.y;
  const int seg = chain % a.S;
  chain /= a.S;
  const int res = chain % a.d;
  const int n = chain / a.d;
  const int col0 = blockIdx.x * a.TW;
  for (int j = seg * a.RS; j < (seg + 1) * a.RS; ++j) {
    const int r = res + a.d * j;
    if (r >= a.H) break;
    const size_t row = (size_t)n * a.H + r;
    if (Pieces)
      pieces_row(a, row, col0);
    else
      fragment_row<MT, NW>(a, row, col0);
  }
}

template <int MT, int NW, bool Pieces>
cudaError_t launch(const Args& a, int threads, int smem, cudaStream_t stream) {
  auto* k = epilogue_probe_kernel<MT, NW, Pieces>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  k<<<dim3((a.W + a.TW - 1) / a.TW, a.N * a.d * a.S), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool Pieces>
cudaError_t dispatch(const Args& a, int mt, int nw, int threads, int smem, cudaStream_t s) {
  if (nw == 128 && mt == 1) return launch<1, 128, Pieces>(a, threads, smem, s);
  if (nw == 64 && mt == 1) return launch<1, 64, Pieces>(a, threads, smem, s);
  if (nw == 64 && mt == 2) return launch<2, 64, Pieces>(a, threads, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: (N, H, W, Cin) bf16, 16-byte aligned; TW, RS, S, bn3, mt3 and
// threads as the fused kernel's plan (kernels/fused_block.py plan_tiles),
// nw = bn3 / (threads / 128); smem: the dynamic shared memory a block asks.
extern "C" int msl_epilogue_probe(const void* x, void* out, int N, int H, int W, int Cin,
                                  int d, int TW, int RS, int S, int bn3, int mt3, int threads,
                                  int smem, int pieces, void* stream) {
  if (threads % 128 || Cin % bn3 || bn3 % (threads / 128 * 8) || TW > 64 * mt3)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), N, H, W, Cin, d,
               TW, RS, S, bn3};
  const int nw = bn3 / (threads / 128);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pieces ? dispatch<true>(a, mt3, nw, threads, smem, s)
                      : dispatch<false>(a, mt3, nw, threads, smem, s));
}

extern "C" const char* msl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
