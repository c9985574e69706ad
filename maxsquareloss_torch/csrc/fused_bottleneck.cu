// Fused stride-1 identity bottleneck, forward, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel experiments/retired_pallas/fused_block.py
// (_kernel_body, launched by _call_kernel from fused_bottleneck_padded with
// emit=False, and from the training forward _fwd with emit=True). It
// computes, for x and out in NHWC (channels-last) fp32,
//
//   out = relu(bn3(conv3(relu(bn2(conv2_d(relu(bn1(conv1 x))))))) + x)
//
// with conv1/conv3 1x1, conv2 3x3 with dilation d and zero padding d, and
// every frozen BN folded to y*s + b. With emit off (eval), h1 and h2 never
// go to device memory. With emit on (training), the kernel also writes
// h1 = relu(bn1(conv1 x)) and h2 = relu(bn2(conv2 h1)) as unpadded NHWC
// (N, H, W, Cmid), which the backward reads: each element once, by the
// block that owns its output pixel, never from the column halo or from the
// extra h1 rows a segment recomputes (see Emit below).
//
// What bounds it. Per output pixel the block does
//   2 * (2*Cin*Cmid + 9*Cmid^2) FLOP
// against 8*Cin bytes of x read and out written: layer3 (Cin 1024, Cmid 256,
// d 2) is 2.23 MFLOP per 8 KB, 272 FLOP/B; layer1 (256/64) 68 FLOP/B. The
// fp32 CUDA-core ridge of an H100 is 67 TFLOP/s / 3.35 TB/s = 20 FLOP/B, so
// every layer is compute-bound. The weights (w2 alone is 9.4 MB at layer4)
// stay in L2 and are streamed from there.
//
// Design (simple and exact; wgmma, TMA and bf16 are later work):
// - A block owns a strip of TW output columns and walks down a chain of
//   output rows r, r+d, r+2d, ... (one residue class of the rows mod d, cut
//   into segments of RS rows). conv2 of row r reads h1 rows r-d, r, r+d, so
//   consecutive rows of a chain share two of their three h1 rows: a ring of
//   three h1 rows in shared memory takes one new conv1 row per output row.
//   conv1 is recomputed only on the column halo, (TW+2d)/TW, and on two
//   extra rows at the start of each segment.
// - h1 (3 x (TW+2d) x Cmid) and h2 (TW x Cmid) live in dynamic shared
//   memory. h1 is written as exact zeros outside the image: conv2's zero
//   padding applies to h1, not to x (relu(b1) != 0 at a padded pixel).
// - Each of the three stages is a small product on the CUDA cores: a thread
//   owns an 8-pixel x 4-channel register tile and accumulates in fp32 FMA,
//   weights stream from L2 as float4 (coalesced over output channels), and
//   the activation operand is a broadcast float4 read (every lane of a warp
//   reads the same pixel).
// - Tiles (chosen by kernels/fused_block.py plan_tiles): TW up to
//   min(64, 8192/Cmid) columns, balanced over the width; layer4 (Cmid 512,
//   d 4) takes TW 16: 3*24*2 KB of h1 + 16*2 KB of h2 = 176 KB, above the
//   48 KB default, so the launch sets MaxDynamicSharedMemorySize first.
// - The products are latency-bound at this tile: a warp waits on its loads
//   between bursts of FMAs, so resident warps matter. Blocks that leave room
//   for two per SM (layers 1-2) take 256 threads, blocks that fill an SM's
//   shared memory alone (layers 3-4) take 512: 16 warps per SM either way
//   (on an H100, 512 threads ran layers 3-4 29-31 % faster; PERF.md).
// - Ragged edges are masked on load and store; a conv1 tile wholly past the
//   right edge writes zeros without computing.
// - Emit (a template flag, so the eval kernel is unchanged): a block owns
//   the output pixels of its strip [col0, col0+TW) on the rows of its
//   segment. h2 goes to device memory from registers where conv2 makes it,
//   for those pixels. h1 of row j is copied from its ring slot while the
//   slot holds it (between the two barriers of row j), from the slot's
//   columns [d, d+TW), which are the strip itself: the halo columns and
//   the rows j0-1 and j0+RS that a segment computes only as conv2's
//   neighbours are never written.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kPx = 8;  // pixels per thread tile (4 channels each)

struct Args {
  const float* x;
  const float* w1;  // (Cin, Cmid)
  const float* w2;  // (3, 3, Cmid, Cmid), HWIO
  const float* w3;  // (Cmid, Cin)
  const float* s1;
  const float* b1;
  const float* s2;
  const float* b2;
  const float* s3;
  const float* b3;
  float* out;
  float* h1;  // (N, H, W, Cmid) with emit, else null
  float* h2;  // (N, H, W, Cmid) with emit, else null
  int N, H, W, Cin, Cmid, d, TW, RS, S;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ int ring_slot(int j) { return (j + 3) % 3; }

// acc[p][c] += sum_k A(p, k) * b[k * ldb + c] for c < 4, k < K, where
// A(p, k) is a0[p * lda + k] when arow is null, else arow[p][k].
__device__ __forceinline__ void tile_mac(float (&acc)[kPx][4], const float* a0,
                                         int lda, const float* const* arow,
                                         const float* __restrict__ b, int ldb,
                                         int K) {
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    const float4 w0 = ldg4(b + (size_t)(k + 0) * ldb);
    const float4 w1 = ldg4(b + (size_t)(k + 1) * ldb);
    const float4 w2 = ldg4(b + (size_t)(k + 2) * ldb);
    const float4 w3 = ldg4(b + (size_t)(k + 3) * ldb);
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const float* ap = arow ? arow[p] : a0 + (size_t)p * lda;
      const float4 a = *reinterpret_cast<const float4*>(ap + k);
      acc[p][0] = fmaf(a.x, w0.x, acc[p][0]);
      acc[p][1] = fmaf(a.x, w0.y, acc[p][1]);
      acc[p][2] = fmaf(a.x, w0.z, acc[p][2]);
      acc[p][3] = fmaf(a.x, w0.w, acc[p][3]);
      acc[p][0] = fmaf(a.y, w1.x, acc[p][0]);
      acc[p][1] = fmaf(a.y, w1.y, acc[p][1]);
      acc[p][2] = fmaf(a.y, w1.z, acc[p][2]);
      acc[p][3] = fmaf(a.y, w1.w, acc[p][3]);
      acc[p][0] = fmaf(a.z, w2.x, acc[p][0]);
      acc[p][1] = fmaf(a.z, w2.y, acc[p][1]);
      acc[p][2] = fmaf(a.z, w2.z, acc[p][2]);
      acc[p][3] = fmaf(a.z, w2.w, acc[p][3]);
      acc[p][0] = fmaf(a.w, w3.x, acc[p][0]);
      acc[p][1] = fmaf(a.w, w3.y, acc[p][1]);
      acc[p][2] = fmaf(a.w, w3.z, acc[p][2]);
      acc[p][3] = fmaf(a.w, w3.w, acc[p][3]);
    }
  }
}

__device__ __forceinline__ float4 bn_relu(const float (&v)[4], float4 s,
                                          float4 b) {
  return make_float4(fmaxf(v[0] * s.x + b.x, 0.f), fmaxf(v[1] * s.y + b.y, 0.f),
                     fmaxf(v[2] * s.z + b.z, 0.f), fmaxf(v[3] * s.w + b.w, 0.f));
}

// h1 for image row r at columns [col0 - d, col0 + TW + d) into one ring slot;
// exact zeros at pixels outside the image.
template <int NT>
__device__ void conv1_row(const Args& a, float* slot, int n, int r, int col0) {
  const int P1 = a.TW + 2 * a.d;
  const int nq = a.Cmid / 4;
  const int items = nq * ((P1 + kPx - 1) / kPx);
  const bool row_ok = r >= 0 && r < a.H;
  for (int item = threadIdx.x; item < items; item += NT) {
    const int q = item % nq;
    const int t = item / nq;
    const float* arow[kPx];
    bool ok[kPx];
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const int col = col0 - a.d + t * kPx + p;
      ok[p] = row_ok && t * kPx + p < P1 && col >= 0 && col < a.W;
      const int rc = min(max(r, 0), a.H - 1);
      const int cc = min(max(col, 0), a.W - 1);
      arow[p] = a.x + ((size_t)(n * a.H + rc) * a.W + cc) * a.Cin;
    }
    float acc[kPx][4] = {};
    if (row_ok && col0 - a.d + t * kPx < a.W)  // not a tile wholly past the edge
      tile_mac(acc, nullptr, 0, arow, a.w1 + q * 4, a.Cmid, a.Cin);
    const float4 s = ldg4(a.s1 + q * 4);
    const float4 b = ldg4(a.b1 + q * 4);
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const int c = t * kPx + p;
      if (c < P1) {
        *reinterpret_cast<float4*>(slot + (size_t)c * a.Cmid + q * 4) =
            ok[p] ? bn_relu(acc[p], s, b) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// h2 for output row j of the chain (h1 rows j-1, j, j+1 in the ring); with
// Emit also into device memory at image row r.
template <int NT, bool Emit>
__device__ void conv2_row(const Args& a, const float* h1, float* h2, int j,
                          int n, int r, int col0) {
  const int P1 = a.TW + 2 * a.d;
  const int nq = a.Cmid / 4;
  const int items = nq * (a.TW / kPx);
  for (int item = threadIdx.x; item < items; item += NT) {
    const int q = item % nq;
    const int t = item / nq;
    if (col0 + t * kPx >= a.W) continue;  // whole tile past the image edge
    float acc[kPx][4] = {};
#pragma unroll 1
    for (int ra = 0; ra < 3; ++ra) {
      const float* slot = h1 + (size_t)ring_slot(j - 1 + ra) * P1 * a.Cmid;
#pragma unroll 1
      for (int cb = 0; cb < 3; ++cb) {
        tile_mac(acc, slot + (size_t)(t * kPx + cb * a.d) * a.Cmid, a.Cmid,
                 nullptr, a.w2 + (size_t)(ra * 3 + cb) * a.Cmid * a.Cmid + q * 4,
                 a.Cmid, a.Cmid);
      }
    }
    const float4 s = ldg4(a.s2 + q * 4);
    const float4 b = ldg4(a.b2 + q * 4);
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const float4 y = bn_relu(acc[p], s, b);
      *reinterpret_cast<float4*>(h2 + (size_t)(t * kPx + p) * a.Cmid + q * 4) = y;
      const int col = col0 + t * kPx + p;
      if (Emit && col < a.W)
        *reinterpret_cast<float4*>(
            a.h2 + ((size_t)(n * a.H + r) * a.W + col) * a.Cmid + q * 4) = y;
    }
  }
}

// With Emit: h1 of image row r, the strip's own columns of its ring slot.
template <int NT>
__device__ void store_h1_row(const Args& a, const float* slot, int n, int r,
                             int col0) {
  const int nq = a.Cmid / 4;
  const int items = nq * a.TW;
  for (int item = threadIdx.x; item < items; item += NT) {
    const int q = item % nq;
    const int c = item / nq;
    const int col = col0 + c;
    if (col < a.W)
      *reinterpret_cast<float4*>(
          a.h1 + ((size_t)(n * a.H + r) * a.W + col) * a.Cmid + q * 4) =
          *reinterpret_cast<const float4*>(slot + (size_t)(c + a.d) * a.Cmid + q * 4);
  }
}

// out row r = relu(bn3(conv3 h2) + x).
template <int NT>
__device__ void conv3_row(const Args& a, const float* h2, int n, int r,
                          int col0) {
  const int nq = a.Cin / 4;
  const int items = nq * (a.TW / kPx);
  for (int item = threadIdx.x; item < items; item += NT) {
    const int q = item % nq;
    const int t = item / nq;
    if (col0 + t * kPx >= a.W) continue;
    float acc[kPx][4] = {};
    tile_mac(acc, h2 + (size_t)t * kPx * a.Cmid, a.Cmid, nullptr, a.w3 + q * 4,
             a.Cin, a.Cmid);
    const float4 s = ldg4(a.s3 + q * 4);
    const float4 b = ldg4(a.b3 + q * 4);
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const int col = col0 + t * kPx + p;
      if (col < a.W) {
        const size_t o = ((size_t)(n * a.H + r) * a.W + col) * a.Cin + q * 4;
        const float4 xr = ldg4(a.x + o);
        float4 y;
        y.x = fmaxf(acc[p][0] * s.x + b.x + xr.x, 0.f);
        y.y = fmaxf(acc[p][1] * s.y + b.y + xr.y, 0.f);
        y.z = fmaxf(acc[p][2] * s.z + b.z + xr.z, 0.f);
        y.w = fmaxf(acc[p][3] * s.w + b.w + xr.w, 0.f);
        *reinterpret_cast<float4*>(a.out + o) = y;
      }
    }
  }
}

// grid: (column strips, N * d * S); block y = ((n * d) + residue) * S + segment.
template <int NT, bool Emit>
__global__ void __launch_bounds__(NT) fused_bottleneck_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* h1 = reinterpret_cast<float*>(smem4);
  const int P1 = a.TW + 2 * a.d;
  float* h2 = h1 + (size_t)3 * P1 * a.Cmid;

  const int col0 = blockIdx.x * a.TW;
  int chain = blockIdx.y;
  const int seg = chain % a.S;
  chain /= a.S;
  const int res = chain % a.d;
  const int n = chain / a.d;
  const int j0 = seg * a.RS;
  if (res + a.d * j0 >= a.H) return;  // the whole block: no row of this segment

  const size_t slot_len = (size_t)P1 * a.Cmid;
  conv1_row<NT>(a, h1 + ring_slot(j0 - 1) * slot_len, n, res + a.d * (j0 - 1), col0);
  conv1_row<NT>(a, h1 + ring_slot(j0) * slot_len, n, res + a.d * j0, col0);
  for (int j = j0; j < j0 + a.RS; ++j) {
    const int r = res + a.d * j;
    if (r >= a.H) break;
    conv1_row<NT>(a, h1 + ring_slot(j + 1) * slot_len, n, r + a.d, col0);
    __syncthreads();
    if (Emit) store_h1_row<NT>(a, h1 + ring_slot(j) * slot_len, n, r, col0);
    conv2_row<NT, Emit>(a, h1, h2, j, n, r, col0);
    __syncthreads();
    conv3_row<NT>(a, h2, n, r, col0);
  }
}

template <int NT, bool Emit>
cudaError_t launch(const Args& a, int smem_bytes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_bottleneck_kernel<NT, Emit>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.W + a.TW - 1) / a.TW, a.N * a.d * a.S);
  fused_bottleneck_kernel<NT, Emit><<<grid, NT, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// threads: 256 or 512 threads per block (the wrapper takes 512 where the
// shared memory allows one block per SM, to keep 16 warps resident).
// h1, h2: both null (eval) or both (N, H, W, Cmid) outputs (training).
extern "C" int msl_fused_bottleneck_f32(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* s1, const void* b1, const void* s2, const void* b2,
    const void* s3, const void* b3, void* out, void* h1, void* h2, int N,
    int H, int W, int Cin, int Cmid, int d, int TW, int RS, int S, int threads,
    int smem_bytes, void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.w1 = static_cast<const float*>(w1);
  a.w2 = static_cast<const float*>(w2);
  a.w3 = static_cast<const float*>(w3);
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.s3 = static_cast<const float*>(s3);
  a.b3 = static_cast<const float*>(b3);
  a.out = static_cast<float*>(out);
  a.h1 = static_cast<float*>(h1);
  a.h2 = static_cast<float*>(h2);
  if ((h1 == nullptr) != (h2 == nullptr)) return (int)cudaErrorInvalidValue;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cmid = Cmid;
  a.d = d;
  a.TW = TW;
  a.RS = RS;
  a.S = S;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool emit = h1 != nullptr;
  if (threads == 256)
    return (int)(emit ? launch<256, true>(a, smem_bytes, s)
                      : launch<256, false>(a, smem_bytes, s));
  if (threads == 512)
    return (int)(emit ? launch<512, true>(a, smem_bytes, s)
                      : launch<512, false>(a, smem_bytes, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* msl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
