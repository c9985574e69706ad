// Fused stride-1 identity bottleneck, forward, fp32 or bf16, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel experiments/retired_pallas/fused_block.py
// (_kernel_body, launched by _call_kernel from fused_bottleneck_padded with
// emit=False, and from the training forward _fwd with emit=True). It
// computes, for x and out in NHWC (channels-last) in the compute dtype,
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
// What bounds it. Against device memory every layer is compute-bound: per
// output pixel 2 * (2*Cin*Cmid + 9*Cmid^2) FLOP for 8*Cin bytes of x read
// and out written (layer3, Cin 1024, Cmid 256: 272 FLOP/B; the fp32 ridge of
// an H100 is 67 TFLOP/s / 3.35 TB/s = 20 FLOP/B). The traffic that counts is
// the weights': they stay in L2 (w2 alone is 9.4 MB at layer4) and a block
// streams all of w1, w2 and w3 from there once per output row of its strip,
// so one pass over 4 * (2*Cin*Cmid + 9*Cmid^2) bytes serves TW pixels:
// TW / 2 FLOP per byte of L2 traffic. With the tiles below that is 32 FLOP/B
// at layers 1-2 (TW 64), 24-28 at layer3 (TW 48 or 56, whichever wastes less
// of the width) and 12 at layer4 (TW 24, pinned by its 3 x 32 x 2 KB h1
// ring). Measured on an H100 (PERF.md): layer3 does 25-27 TFLOP/s of useful
// work, drawing about 1 TB/s from L2, and is bound by operations (the FMA
// instruction rate and the shared-memory reads that feed it: the bare inner
// loop on a resident tile reaches 34-38); layer4 does 17-22, and there the
// L2 weight traffic counts: the bare loop at layer4's widths gives 25-29
// TFLOP/s on 16 rows and 32 on 24.
//
// Design:
// - A block owns a strip of TW output columns and walks down a chain of
//   output rows r, r+d, r+2d, ... (one residue class of the rows mod d, cut
//   into segments of RS rows). conv2 of row r reads h1 rows r-d, r, r+d, so
//   consecutive rows of a chain share two of their three h1 rows: a ring of
//   three h1 rows in shared memory takes one new conv1 row per output row.
//   conv1 is recomputed only on the column halo, (TW+2d)/TW, and on two
//   extra rows at the start of each segment.
// - h1 (3 x (TW+2d) x Cmid) lives in dynamic shared memory, written as exact
//   zeros outside the image: conv2's zero padding applies to h1, not to x
//   (relu(b1) != 0 at a padded pixel). h2 (TW x Cmid) needs no room of its
//   own: conv2 of row j is the last reader of h1 row j-1, so after a barrier
//   its epilogue writes h2 into that ring slot, where conv3 reads it before
//   the next trip's conv1 refills the slot. That room buys wider strips: TW
//   56 at layer3 and 24 at layer4.
// - Each of the three convs is a product [pixels x K] x [K x channels] with
//   both operands in shared memory. The weights (w1; w2 as a (9*Cmid, Cmid)
//   matrix, tap by tap; w3 in passes of BN3 columns) stream from L2 in
//   stages of KB k-rows by BN columns (KB 16 where the shared memory has
//   room, as at layers 1-3; 8 at layer4), double buffered with cp.async:
//   wait for stage i, one barrier, start the copy of stage i+1, multiply
//   stage i. Each weight byte crosses L2 -> SM once per block and row.
//   conv1's x operand comes the same way: the row's TW+2d pixels by KB
//   channels per stage, 4*KB contiguous bytes a pixel, zero filled outside
//   the image. conv2 reads the ring, conv3 reads h2.
// - A thread owns a register tile of PX pixels x 8 channels (two float4s,
//   BN/2 columns apart), fp32 FMA on the CUDA cores, the k loop unrolled
//   over a whole stage. The BN/8 threads of one pixel tile read the same
//   activations (a broadcast float4) and consecutive weight columns (a
//   quarter warp on 128 contiguous bytes: no bank conflict, so the stage rows
//   need no padding). Where a warp spans several pixel tiles (Cmid < 256) the
//   h1/h2 pixel stride is padded by 16 bytes (4 floats, 8 bf16).
// - Every thread has a tile in every conv: threads = T pixel tiles x BN/8
//   channel groups exactly, with PX = ceil(pixels / T) chosen per conv by
//   kernels/fused_block.py plan_tiles (which owns the shared-memory budget:
//   at most 232,448 B with the stages). Layer3: 256 threads, TW 48 with
//   tiles of 7, 6 and 6 pixels or TW 56 with 8, 7 and 7; layer4: 256 threads,
//   BN 512, TW 24 with tiles of 8, 6 and 6 pixels, so all 8 warps work in
//   conv2 (the 3x3 is 53 % of the FLOPs); layer2: 256 threads, 5, 4 and 8
//   pixels; layer1: 128 threads, 5, 4 and 8. Only conv1 at layers 1-2, whose
//   TW + 2 pixels are no whole number of tiles, leaves up to a fifth of the
//   threads without pixels. The widest instances (8 pixels, 16 k-rows
//   unrolled) take all 255 registers a thread, so an SM holds 256 threads:
//   8 warps.
// - Ragged edges are masked on load and store; a tile wholly past the right
//   edge skips its arithmetic but keeps copying and meeting the barriers.
// - Emit (a template flag, so the eval kernel is unchanged): a block owns
//   the output pixels of its strip [col0, col0+TW) on the rows of its
//   segment. h2 goes to device memory from registers where conv2 makes it,
//   for those pixels. h1 of row j is copied from its ring slot while the
//   slot holds it (between the two barriers of row j), from the slot's
//   columns [d, d+TW), which are the strip itself: the halo columns and
//   the rows j0-1 and j0+RS that a segment computes only as conv2's
//   neighbours are never written. No atomics: two calls give the same bits.
// - Masked canvas (valid non-null, N x 2 ints: image n's valid rows and
//   columns on a canvas batch of unequal crops, the JAX package's
//   _bottleneck(..., mask=...)): h1 is exact zeros past image n's valid
//   rows and columns, as it is outside the image. conv1_row is the only
//   place h1 is made, so the ring, conv2's input and the emitted h1 are all
//   the masked h1; conv2, conv3, h2 and out run over the whole canvas as
//   before. A runtime argument: no template instance of its own.
// - bf16 (the library built with -DMSL_BF16, kernels/fused_block.py): the
//   same body with every tensor but the BN vectors in bf16 (the weights the
//   caller's HWIO copies cast from fp32, as the TPU kernel's _prep casts
//   them). Operands are staged as bf16 (a 16-byte cp.async moves 8 of
//   them; an x stage and an h1/h2 pixel are padded by 16 bytes, 8
//   elements), widened to fp32 in registers where mac_stage reads them, and
//   the fp32 FMA loop accumulates. Results are rounded to bf16 where the
//   Pallas body casts to the compute dtype: each conv's fp32 sum; the BN's
//   product and its sum (the BN vectors rounded to bf16 as they are read);
//   the residual add; the ReLU is exact. h1 and h2 are stored as bf16, the
//   ring and the emitted copies alike. No tensor cores yet: against
//   device memory and L2 the work is the fp32 kernel's at half the bytes,
//   and it stays bound by the FMA issue rate (plus one widening per operand
//   element read), far from the card's 989 TFLOP/s bf16 rate.
// - Left for later: more pixels per weight pass at layer4 (thread block
//   clusters with multicast weight stages) and the tensor cores. Split-TF32
//   mma.sync (three products) was measured at this structure: 1.17x the FMA
//   loop at layer3's widths, 0.94x at layer4's, with 9-12x the error
//   (PERF.md), so it needs wgmma and the wider tiles first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// KB, a template parameter below: k rows per weight stage and channels per x
// stage, 16 where the shared memory has room for it, else 8 (plan_tiles).
// An x stage keeps KB + kVec elements (16 bytes more) between two pixels.
constexpr int kMaxThreads = 256;
constexpr int kCh = 8;         // channels per thread tile

#ifdef MSL_BF16
using Elem = __nv_bfloat16;    // the type of every tensor but the BN vectors
#else
using Elem = float;
#endif
constexpr int kVec = 16 / sizeof(Elem);  // elements per 16-byte copy

struct Args {
  const Elem* x;
  const Elem* w1;  // (Cin, Cmid)
  const Elem* w2;  // (3, 3, Cmid, Cmid), HWIO: a (9*Cmid, Cmid) matrix
  const Elem* w3;  // (Cmid, Cin)
  const float* s1;  // the folded frozen-BN vectors, fp32
  const float* b1;
  const float* s2;
  const float* b2;
  const float* s3;
  const float* b3;
  Elem* out;
  Elem* h1;  // (N, H, W, Cmid) with emit, else null
  Elem* h2;  // (N, H, W, Cmid) with emit, else null
  const int* valid;  // (N, 2) valid rows and columns of each image, or null
  int N, H, W, Cin, Cmid, d, TW, RS, S;
  // from plan_tiles: conv3's columns per pass, the pixels per thread tile of
  // each conv, the pixel stride of h1/h2, the elements of one weight stage
  // buffer, the pixels of one x stage buffer and the k rows of a stage
  int bn3, px1, px2, px3, ldh, wstage, xs_px, kb;
};

// Four bf16 (8 bytes, the lower address in the low half of each word) as
// fp32: a bf16 is the high half of the fp32 of the same value.
__device__ __forceinline__ float4 widen_bf16x4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// four consecutive elements in shared memory, as fp32
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  return widen_bf16x4(*reinterpret_cast<const uint2*>(p));
}

// four consecutive elements in device memory, through the read-only cache
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return widen_bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// four values that are exact in Elem (rounded by the epilogue), stored
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  // exact in bf16: each value's low 16 bits are 0, its high half is its bits
  *reinterpret_cast<uint2*>(p) =
      make_uint2((__float_as_uint(v.x) >> 16) | (__float_as_uint(v.y) & 0xffff0000u),
                 (__float_as_uint(v.z) >> 16) | (__float_as_uint(v.w) & 0xffff0000u));
}

// v rounded to Elem (to nearest, ties to even), as fp32
__device__ __forceinline__ float rnd(float v) {
#ifdef MSL_BF16
  return __bfloat162float(__float2bfloat16_rn(v));
#else
  return v;
#endif
}

// The frozen BN y * s + b of a conv's fp32 sum z, in the compute dtype's
// arithmetic: in fp32 one fused multiply-add; in bf16 the Pallas body's
// casts: z rounded (the conv's output), then the product and the sum each
// rounded (s and b are bf16 values already, bn_vec).
__device__ __forceinline__ float frozen_bn(float z, float s, float b) {
#ifdef MSL_BF16
  return rnd(rnd(rnd(z) * s) + b);
#else
  return fmaf(z, s, b);
#endif
}

// Four BN scale or bias values from the fp32 vector, rounded to Elem as the
// TPU kernel's _prep casts them.
__device__ __forceinline__ float4 bn_vec(const float* p) {
  const float4 v = ldg4(p);
  return make_float4(rnd(v.x), rnd(v.y), rnd(v.z), rnd(v.w));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false the 16 bytes are zero filled and
// src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int ring_slot(int j) { return (j + 3) % 3; }

// Start the copy of the weight stage W[k0 : k0+KB, n0 : n0+bn) (row-major,
// ld = ldw) into ws (dense, ld = bn). blockDim.x is a multiple of bn / kVec.
template <int KB>
__device__ __forceinline__ void stage_weights(Elem* ws, const Elem* __restrict__ w,
                                              int ldw, int n0, int k0, int bn) {
  const int per_row = bn / kVec;
  const int col = (threadIdx.x % per_row) * kVec;
  const int step = blockDim.x / per_row;
  for (int r = threadIdx.x / per_row; r < KB; r += step)
    cp_async16(ws + r * bn + col, w + (size_t)(k0 + r) * ldw + n0 + col);
}

// acc[p][c] += sum over the stage's KB k of A(p, k) * W(k, c): A(p, k) at
// ap[p * lda + k] (the same address for every thread of a pixel tile), W at
// wp[k * bn + c] for c < 4 and wp[k * bn + bn/2 + c - 4] for c >= 4; both
// widened to fp32 as they are read.
template <int PX, int KB>
__device__ __forceinline__ void mac_stage(float (&acc)[PX][kCh], const Elem* ap, int lda,
                                          const Elem* wp, int bn) {
  const int half = bn >> 1;
#pragma unroll
  for (int kk = 0; kk < KB; kk += 4) {
    float4 av[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) av[p] = lds4(ap + p * lda + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b0 = lds4(wp + (kk + j) * bn);
      const float4 b1 = lds4(wp + (kk + j) * bn + half);
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const float v = j == 0 ? av[p].x : j == 1 ? av[p].y : j == 2 ? av[p].z : av[p].w;
        acc[p][0] = fmaf(v, b0.x, acc[p][0]);
        acc[p][1] = fmaf(v, b0.y, acc[p][1]);
        acc[p][2] = fmaf(v, b0.z, acc[p][2]);
        acc[p][3] = fmaf(v, b0.w, acc[p][3]);
        acc[p][4] = fmaf(v, b1.x, acc[p][4]);
        acc[p][5] = fmaf(v, b1.y, acc[p][5]);
        acc[p][6] = fmaf(v, b1.z, acc[p][6]);
        acc[p][7] = fmaf(v, b1.w, acc[p][7]);
      }
    }
  }
}

template <int PX>
__device__ __forceinline__ void clear(float (&acc)[PX][kCh]) {
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[p][c] = 0.f;
}

__device__ __forceinline__ float4 bn_relu(const float* v, float4 s, float4 b) {
  return make_float4(fmaxf(frozen_bn(v[0], s.x, b.x), 0.f), fmaxf(frozen_bn(v[1], s.y, b.y), 0.f),
                     fmaxf(frozen_bn(v[2], s.z, b.z), 0.f), fmaxf(frozen_bn(v[3], s.w, b.w), 0.f));
}

// h1 for image row r at columns [col0 - d, col0 + TW + d) into one ring slot;
// exact zeros at pixels outside the image, and outside its valid rows and
// columns on a masked canvas. One pass over w1: BN = Cmid.
template <int PX, int KB>
__device__ __forceinline__ void conv1_row(const Args& a, Elem* slot, Elem* wst,
                                          Elem* xst, int n, int r, int col0) {
  const int P1 = a.TW + 2 * a.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  // image n's valid extent (the wrapper keeps it within [1, H] x [1, W])
  const int vh = a.valid ? __ldg(a.valid + 2 * n) : a.H;
  const int vw = a.valid ? __ldg(a.valid + 2 * n + 1) : a.W;
  // the slot held the last trip's h2 and the stage buffers its weights: their
  // readers (conv3) are done
  __syncthreads();
  if (r < 0 || r >= vh) {  // the same for the whole block: a block has one image
    const int nq = a.Cmid / kVec;
    for (int i = tid; i < P1 * nq; i += nt)
      *reinterpret_cast<uint4*>(slot + (i / nq) * a.ldh + (i % nq) * kVec) =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int bn = a.Cmid;
  const int groups = bn / kCh;
  const int q = tid % groups, c0 = (tid / groups) * PX;  // first pixel of the tile
  const int colf = col0 - a.d + c0;                        // its image column
  const bool active = c0 < P1 && colf < vw && colf + PX > 0;
  const Elem* xrow = a.x + (size_t)(n * a.H + r) * a.W * a.Cin;
  constexpr int kXLd = KB + kVec;
  constexpr int kParts = KB / kVec;  // 16-byte copies per pixel and stage
  const int xlen = a.xs_px * kXLd;

  auto start_stage = [&](int i) {
    const int k0 = i * KB;
    stage_weights<KB>(wst + (i & 1) * a.wstage, a.w1, a.Cmid, 0, k0, bn);
    Elem* xs = xst + (i & 1) * xlen;
    for (int j = tid; j < P1 * kParts; j += nt) {
      const int pix = j / kParts, part = (j % kParts) * kVec;
      const int col = col0 - a.d + pix;
      const bool ok = col >= 0 && col < a.W;
      cp_async16(xs + pix * kXLd + part,
                 xrow + (size_t)(ok ? col : 0) * a.Cin + k0 + part, ok);
    }
    cp_async_commit();
  };

  float acc[PX][kCh];
  clear<PX>(acc);
  const int stages = a.Cin / KB;
  start_stage(0);
  for (int i = 0; i < stages; ++i) {
    cp_async_wait_all();  // stage i has landed (this thread's copies)
    __syncthreads();      // ... and everyone's; stage i-1 is read
    if (i + 1 < stages) start_stage(i + 1);
    if (active)
      mac_stage<PX, KB>(acc, xst + (i & 1) * xlen + c0 * kXLd, kXLd,
                        wst + (i & 1) * a.wstage + q * 4, bn);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int ch = hf * (bn >> 1) + q * 4;
    const float4 s = bn_vec(a.s1 + ch);
    const float4 b = bn_vec(a.b1 + ch);
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int c = c0 + p;
      const int col = col0 - a.d + c;
      if (c < P1)
        store4(slot + c * a.ldh + ch, (col >= 0 && col < vw)
                                          ? bn_relu(&acc[p][hf * 4], s, b)
                                          : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

// h2 for output row j of the chain (h1 rows j-1, j, j+1 in the ring); with
// Emit also into device memory at image row r. One pass over w2: BN = Cmid,
// K = 9 * Cmid tap by tap; TW = pixel tiles x PX exactly.
template <int PX, int KB, bool Emit>
__device__ __forceinline__ void conv2_row(const Args& a, const Elem* h1, Elem* h2,
                                          Elem* wst, int j, int n, int r, int col0) {
  const int P1 = a.TW + 2 * a.d;
  const int tid = threadIdx.x;
  const int bn = a.Cmid;
  const int groups = bn / kCh;
  const int q = tid % groups, c0 = (tid / groups) * PX;
  const bool active = col0 + c0 < a.W;
  const int slot_len = P1 * a.ldh;

  float acc[PX][kCh];
  clear<PX>(acc);
  const int stages = 9 * a.Cmid / KB;
  __syncthreads();
  stage_weights<KB>(wst, a.w2, a.Cmid, 0, 0, bn);
  cp_async_commit();
  int tap = 0, kc = 0;  // stage i covers channels [kc, kc + KB) of tap
  for (int i = 0; i < stages; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < stages) {
      stage_weights<KB>(wst + ((i + 1) & 1) * a.wstage, a.w2, a.Cmid, 0, (i + 1) * KB, bn);
      cp_async_commit();
    }
    if (active) {
      const int ra = tap / 3, cb = tap - 3 * ra;
      const Elem* ap = h1 + ring_slot(j - 1 + ra) * slot_len + (c0 + cb * a.d) * a.ldh + kc;
      mac_stage<PX, KB>(acc, ap, a.ldh, wst + (i & 1) * a.wstage + q * 4, bn);
    }
    kc += KB;
    if (kc == a.Cmid) {
      kc = 0;
      ++tap;
    }
  }
  __syncthreads();  // h2 takes the place of h1 row j-1: its last readers are done
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int ch = hf * (bn >> 1) + q * 4;
    const float4 s = bn_vec(a.s2 + ch);
    const float4 b = bn_vec(a.b2 + ch);
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const float4 y = bn_relu(&acc[p][hf * 4], s, b);
      store4(h2 + (c0 + p) * a.ldh + ch, y);
      const int col = col0 + c0 + p;
      if (Emit && col < a.W)
        store4(a.h2 + ((size_t)(n * a.H + r) * a.W + col) * a.Cmid + ch, y);
    }
  }
}

// With Emit: h1 of image row r, the strip's own columns of its ring slot.
__device__ void store_h1_row(const Args& a, const Elem* slot, int n, int r, int col0) {
  const int nq = a.Cmid / kVec;
  const int items = nq * a.TW;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int q = item % nq;
    const int c = item / nq;
    const int col = col0 + c;
    if (col < a.W)
      *reinterpret_cast<uint4*>(a.h1 + ((size_t)(n * a.H + r) * a.W + col) * a.Cmid + q * kVec) =
          *reinterpret_cast<const uint4*>(slot + (c + a.d) * a.ldh + q * kVec);
  }
}

// out row r = relu(bn3(conv3 h2) + x), in Cin / bn3 passes over the columns
// of w3; the stages of all passes form one pipeline.
template <int PX, int KB>
__device__ __forceinline__ void conv3_row(const Args& a, const Elem* h2, Elem* wst,
                                          int n, int r, int col0) {
  const int tid = threadIdx.x;
  const int bn = a.bn3;
  const int groups = bn / kCh;
  const int q = tid % groups, c0 = (tid / groups) * PX;
  const bool active = col0 + c0 < a.W;
  const int per_pass = a.Cmid / KB;
  const int stages = (a.Cin / bn) * per_pass;

  float acc[PX][kCh];
  clear<PX>(acc);
  __syncthreads();
  stage_weights<KB>(wst, a.w3, a.Cin, 0, 0, bn);
  cp_async_commit();
  int n0 = 0, ks = 0;  // stage i: columns [n0, n0 + bn), k rows [ks*KB, ..)
  for (int i = 0; i < stages; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < stages) {
      const bool wrap = ks + 1 == per_pass;
      stage_weights<KB>(wst + ((i + 1) & 1) * a.wstage, a.w3, a.Cin, wrap ? n0 + bn : n0,
                        wrap ? 0 : (ks + 1) * KB, bn);
      cp_async_commit();
    }
    if (active)
      mac_stage<PX, KB>(acc, h2 + c0 * a.ldh + ks * KB, a.ldh,
                        wst + (i & 1) * a.wstage + q * 4, bn);
    if (++ks == per_pass) {
      if (active) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int ch = n0 + hf * (bn >> 1) + q * 4;
          const float4 s = bn_vec(a.s3 + ch);
          const float4 b = bn_vec(a.b3 + ch);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const int col = col0 + c0 + p;
            if (col < a.W) {
              const size_t o = ((size_t)(n * a.H + r) * a.W + col) * a.Cin + ch;
              const float4 xr = ldg4(a.x + o);
              const float* v = &acc[p][hf * 4];
              // the residual add rounds once more in bf16
              float4 y;
              y.x = fmaxf(rnd(frozen_bn(v[0], s.x, b.x) + xr.x), 0.f);
              y.y = fmaxf(rnd(frozen_bn(v[1], s.y, b.y) + xr.y), 0.f);
              y.z = fmaxf(rnd(frozen_bn(v[2], s.z, b.z) + xr.z), 0.f);
              y.w = fmaxf(rnd(frozen_bn(v[3], s.w, b.w) + xr.w), 0.f);
              store4(a.out + o, y);
            }
          }
        }
      }
      clear<PX>(acc);
      ks = 0;
      n0 += bn;
    }
  }
}

// The pixels per thread tile are compile-time (the accumulators are
// registers): one instance per value, picked by the planner's px.
#define DISPATCH_PX(px, CALL)  \
  switch (px) {                \
    case 1: { constexpr int PX = 1; CALL; } break; \
    case 2: { constexpr int PX = 2; CALL; } break; \
    case 3: { constexpr int PX = 3; CALL; } break; \
    case 4: { constexpr int PX = 4; CALL; } break; \
    case 5: { constexpr int PX = 5; CALL; } break; \
    case 6: { constexpr int PX = 6; CALL; } break; \
    case 7: { constexpr int PX = 7; CALL; } break; \
    default: { constexpr int PX = 8; CALL; } break; \
  }

// grid: (column strips, N * d * S); block y = ((n * d) + residue) * S + segment.
// shared: h1 ring (h2 in its oldest slot) | two weight stages | two x stages.
template <bool Emit>
__global__ void __launch_bounds__(kMaxThreads) fused_bottleneck_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  Elem* h1 = reinterpret_cast<Elem*>(smem4);
  const int P1 = a.TW + 2 * a.d;
  const int slot_len = P1 * a.ldh;
  Elem* wst = h1 + 3 * slot_len;
  Elem* xst = wst + 2 * a.wstage;  // a.kb + kVec elements a pixel

  const int col0 = blockIdx.x * a.TW;
  int chain = blockIdx.y;
  const int seg = chain % a.S;
  chain /= a.S;
  const int res = chain % a.d;
  const int n = chain / a.d;
  const int j0 = seg * a.RS;
  if (res + a.d * j0 >= a.H) return;  // the whole block: no row of this segment

  // rows j0-1 and j0 of the chain only fill the ring; from j0 on, every trip
  // adds h1 row j+1 and finishes output row j
  for (int j = j0 - 2; j < j0 + a.RS; ++j) {
    const int r = res + a.d * j;
    if (j >= j0 && r >= a.H) break;
    Elem* fill = h1 + ring_slot(j + 1) * slot_len;
    if (a.kb == 16) {
      DISPATCH_PX(a.px1, (conv1_row<PX, 16>(a, fill, wst, xst, n, r + a.d, col0)))
    } else {
      DISPATCH_PX(a.px1, (conv1_row<PX, 8>(a, fill, wst, xst, n, r + a.d, col0)))
    }
    if (j < j0) continue;
    __syncthreads();
    if (Emit) store_h1_row(a, h1 + ring_slot(j) * slot_len, n, r, col0);
    // conv2 of row j is the last reader of h1 row j-1, so h2 goes into that
    // slot, where it stays until the next trip's conv1 refills it
    Elem* h2 = h1 + ring_slot(j - 1) * slot_len;
    if (a.kb == 16) {
      DISPATCH_PX(a.px2, (conv2_row<PX, 16, Emit>(a, h1, h2, wst, j, n, r, col0)))
    } else {
      DISPATCH_PX(a.px2, (conv2_row<PX, 8, Emit>(a, h1, h2, wst, j, n, r, col0)))
    }
    __syncthreads();
    if (a.kb == 16) {
      DISPATCH_PX(a.px3, (conv3_row<PX, 16>(a, h2, wst, n, r, col0)))
    } else {
      DISPATCH_PX(a.px3, (conv3_row<PX, 8>(a, h2, wst, n, r, col0)))
    }
  }
}

template <bool Emit>
cudaError_t launch(const Args& a, int threads, int smem_bytes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_bottleneck_kernel<Emit>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.W + a.TW - 1) / a.TW, a.N * a.d * a.S);
  fused_bottleneck_kernel<Emit><<<grid, threads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

bool px_ok(int px) { return px >= 1 && px <= 8; }

}  // namespace

// The launch function of this library's element type: fp32, or bf16 when
// built with -DMSL_BF16 (kernels/fused_block.py loads each by its name).
#ifdef MSL_BF16
#define MSL_FUSED_BOTTLENECK msl_fused_bottleneck_bf16
#else
#define MSL_FUSED_BOTTLENECK msl_fused_bottleneck_f32
#endif

// The tile arguments come from kernels/fused_block.py plan_tiles, which owns
// their arithmetic: threads (128 or 256) = pixel tiles x Cmid/8 = pixel
// tiles x bn3/8; TW = px2 x Cmid-tiles = px3 x bn3-tiles; px1 x tiles >=
// TW + 2d; ldh >= Cmid, a multiple of 16 bytes; kb 8 or 16; wstage >= kb *
// max(Cmid, bn3) elements; xs_px >= TW + 2d.
// x, the weights, out, h1 and h2 are Elem; the six BN vectors fp32.
// h1, h2: both null (eval) or both (N, H, W, Cmid) outputs (training).
// valid: null, or N x 2 ints on the device, each image's valid rows in
// [1, H] and columns in [1, W] (kernels/fused_block.py _check); it must be
// 4-byte aligned.
extern "C" int MSL_FUSED_BOTTLENECK(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* s1, const void* b1, const void* s2, const void* b2,
    const void* s3, const void* b3, void* out, void* h1, void* h2,
    const void* valid, int N,
    int H, int W, int Cin, int Cmid, int d, int TW, int RS, int S, int threads,
    int smem_bytes, int bn3, int px1, int px2, int px3, int ldh, int wstage,
    int xs_px, int kb, void* stream) {
  Args a;
  a.x = static_cast<const Elem*>(x);
  a.w1 = static_cast<const Elem*>(w1);
  a.w2 = static_cast<const Elem*>(w2);
  a.w3 = static_cast<const Elem*>(w3);
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.s3 = static_cast<const float*>(s3);
  a.b3 = static_cast<const float*>(b3);
  a.out = static_cast<Elem*>(out);
  a.h1 = static_cast<Elem*>(h1);
  a.h2 = static_cast<Elem*>(h2);
  if ((h1 == nullptr) != (h2 == nullptr)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(valid) % alignof(int)) return (int)cudaErrorInvalidValue;
  a.valid = static_cast<const int*>(valid);
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cmid = Cmid;
  a.d = d;
  a.TW = TW;
  a.RS = RS;
  a.S = S;
  a.bn3 = bn3;
  a.px1 = px1;
  a.px2 = px2;
  a.px3 = px3;
  a.ldh = ldh;
  a.wstage = wstage;
  a.xs_px = xs_px;
  a.kb = kb;
  // the mapping the kernel relies on; a plan that breaks it is refused
  if (threads != 128 && threads != 256) return (int)cudaErrorInvalidValue;
  if (!px_ok(px1) || !px_ok(px2) || !px_ok(px3)) return (int)cudaErrorInvalidValue;
  if (kb != 8 && kb != 16) return (int)cudaErrorInvalidValue;
  if (Cmid % 32 || Cin % 32 || bn3 % 32 || Cin % bn3) return (int)cudaErrorInvalidValue;
  if (threads % (Cmid / 4) || threads % (bn3 / 4)) return (int)cudaErrorInvalidValue;
  if (TW != px2 * (threads / (Cmid / 8)) || TW != px3 * (threads / (bn3 / 8)) ||
      px1 * (threads / (Cmid / 8)) < TW + 2 * d)
    return (int)cudaErrorInvalidValue;
  if (ldh < Cmid || ldh % kVec || wstage < kb * (Cmid > bn3 ? Cmid : bn3) ||
      xs_px < TW + 2 * d)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(h1 != nullptr ? launch<true>(a, threads, smem_bytes, s)
                             : launch<false>(a, threads, smem_bytes, s));
}

extern "C" const char* msl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
