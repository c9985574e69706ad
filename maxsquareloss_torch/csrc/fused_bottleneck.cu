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
//   segment. h2 goes to device memory for those pixels: on the FMA route
//   from registers where conv2 makes it, on the tc route copied from the
//   plane after conv2. h1 of row j is copied from shared memory while it is
//   there (before conv2 of its trip), from the columns [d, d+TW) of its
//   row, which are the strip itself: the halo columns and the rows j0-1 and
//   j0+RS that a segment computes only as conv2's neighbours are never
//   written. No atomics: two calls give the same bits.
// - Masked canvas (valid non-null, N x 2 ints: image n's valid rows and
//   columns on a canvas batch of unequal crops, the JAX package's
//   _bottleneck(..., mask=...)): h1 is exact zeros past image n's valid
//   rows and columns, as it is outside the image. conv1_row (conv1_row_tc)
//   is the only place h1 is made, so the ring, conv2's input and the emitted
//   h1 are all the masked h1; conv2, conv3, h2 and out run over the whole
//   canvas as before. A runtime argument: no template instance of its own.
// - bf16 (the library built with -DMSL_BF16, kernels/fused_block.py): every
//   tensor but the BN vectors in bf16 (the weights the caller's HWIO copies
//   cast from fp32, as the TPU kernel's _prep casts them), and all three
//   convs on the tensor cores: the tc route, chosen at compile time
//   (kTensorCores), so the fp32 build runs the FMA route above unchanged.
//   Results are rounded to bf16 where the Pallas body casts to the compute
//   dtype: each conv's fp32 sum; the BN's product and its sum (the BN
//   vectors rounded to bf16 as they are read); the residual add; the ReLU
//   is exact. h1 and h2 are stored as bf16, in shared memory and the emitted
//   copies alike. Only the order of each fp32 sum differs from the plain
//   version.
// - The tc route: conv1 ([TW+2d pixels x Cin] x [Cin x Cmid]), conv2 (nine
//   shifted [pixels x Cmid] x [Cmid x Cmid] products) and conv3 ([TW x Cmid]
//   x [Cmid x Cin]) are wgmma.mma_async m64nNk16 bf16 -> fp32 products from
//   shared memory without swizzle. conv1 and conv3 run in passes of bn1 or
//   bn3 columns: each warpgroup takes the pass's columns over the
//   warpgroups, 128 over one m64 tile of pixels or 64 over two, 64 fp32
//   accumulators a thread (DISPATCH_TC: 3 instances a conv). The epilogue
//   follows each pass's k loop (tc_pass: ptxas serializes the wgmma of a
//   loop whose body reads the accumulators). The operands are staged by
//   cp.async double buffers of kb1 (conv1) or kb3 (conv3) k-rows, up to 64
//   (one barrier a stage, four k16 steps per barrier), the x stage in the
//   k-major core-matrix layout (8 pixels x 16 bytes a core matrix,
//   channel block c/8 of pixel p at 8 (stride * c/8 + p), the pixel stride
//   odd so 16-byte reads of one pixel's channel blocks avoid bank
//   conflicts), the weight stages in the n-major one (8 k-rows x 8 columns
//   a core matrix, read with the transpose flag), which the 16-byte pieces
//   of each weight row fill by address alone: no host-side packing.
// - conv2 on the tc route (tc_segment, conv2_rows_tc): a block's w2 (a
//   (9*Cmid, Cmid) matrix, 1.2 MB at layer3 and 4.7 MB at layer4) streams
//   from L2 once a pass, and the passes are bound by that stream (about 2
//   TB/s over the card's SMs, PERF.md): FLOP per L2 byte = the pass's
//   pixels. So a pass takes two output rows of the chain at once: h1 lives
//   in a window of four rows (j-1 .. j+2) at positions P1 = TW + 2d
//   pixels apart in one core-matrix plane (pixel stride ldh, odd), where
//   conv1's epilogue writes it. Tap (ra, cb) of both rows is then one A
//   descriptor, started at position ra shifted by cb*d pixels: tile rows m
//   < TW are output row j, rows P1 <= m < P1 + TW row j+1, rows between and
//   past them read inside the block's shared memory and are dropped. One
//   pass over all Cmid (a warpgroup takes Cmid / warpgroups columns: 256 at
//   layer4, 128 accumulators a thread, which fit with no FMA loop in the
//   bf16 build; DISPATCH_CONV2), 9 Cmid / kb stages in a ring of
//   kConv2Buffers (three in flight while one is multiplied). After every
//   product h2 of the trip's rows takes positions 0 and 1 (tile row m is
//   plane pixel m), where conv3 reads it row by row; then the window's last
//   two rows move to positions 0, 1 and conv1 fills the rest. Measured on an
//   H100 (PERF.md): conv2 alone 3.5-5.6x the FMA loop's rate at layers 3-4,
//   the block 1.8-2.2x faster than with conv2 on the FMA loop.
// - A stage's cp.async writes and the plain stores of h1 and h2 are fenced
//   into the async proxy (fence.proxy.async) before the barrier that hands
//   them to wgmma; every thread waits for its warpgroup's products
//   (wgmma.wait_group 0) before the next barrier lets a buffer be
//   overwritten, so one stage's products run while the next stages land.
//   Rows of an m64 tile past the pixels (layer4: 28 of 64 in conv3) read
//   whatever lies at their addresses inside the block's shared memory and
//   are dropped. The epilogues take the accumulator fragment (thread t of a
//   warpgroup holds columns 8j + 2(t%4) + {0,1} of rows 16(t/32) + (t%32)/4
//   and 8 below): conv1 and conv2 write h1 and h2 into the plane as 4-byte
//   pairs (8 pixels x 4 threads a warp store: 32 words, no bank conflict);
//   conv3 writes bn3 of its fragment into a tile of 64 columns a warpgroup
//   in the x stages (free during conv3, a swizzle of 16-byte pieces against
//   bank conflicts) and then reads the residual and stores out in 16-byte
//   pieces along each pixel's channels: in the fragment's order, 8 pixels x
//   16 bytes a warp instruction, those accesses took 2.3x as long (PERF.md);
//   with Emit, h1 and h2 go to device memory the same way, copied from the
//   plane (store_row). The planner (plan_tiles) picks TW by the m64 tiles
//   of conv1 and conv3: R101 at 1024x512 layer1 TW 96 (P1 98: two tiles),
//   layer2 48 (1024x512) or 96 (1280x640), layer3 48 or 56 (one tile),
//   layer4 28 (P1 36; conv2's two rows are rows 0-27 and 36-63 of one tile),
//   in 90-224 KB of shared memory.
// - Left for later: conv1 and conv3 over two rows a weight pass as conv2
//   (their L2 stream is now most of the block's time), a fetching warp with
//   mbarriers in place of the block barrier a stage, more pixels per weight
//   pass at layer4 (thread block clusters with multicast weight stages), and
//   the tensor cores in fp32 (split-TF32 mma.sync at this structure: 1.17x
//   the FMA loop at layer3's widths, 0.94x at layer4's, with 9-12x the
//   error, PERF.md).

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
constexpr bool kTensorCores = true;   // every conv on wgmma (the tc route)
#else
using Elem = float;
constexpr bool kTensorCores = false;  // every conv on the FMA loop
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
  // the tc route's: the k rows of a conv1 and a conv3 stage, the m64 tiles
  // of conv1 (TW + 2d pixels) and conv3 (TW), the pixel stride of h2's
  // core-matrix layout, conv1's columns per pass and the m64 tiles of a
  // conv2 pass (kb1 = kb3 = kb, the others 0, on the FMA route)
  int kb1, kb3, mt1, mt3, h2p, bn1, mt2;
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

// Waits until at most N of this thread's newest cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
      store4(h2 + (c0 + p) * a.ldh + ch, y);  // pixel-major for conv3_row
      const int col = col0 + c0 + p;
      if (Emit && col < a.W)
        store4(a.h2 + ((size_t)(n * a.H + r) * a.W + col) * a.Cmid + ch, y);
    }
  }
}

// With Emit: the strip's TW pixels of one row in shared memory (pixel c at
// src's pixel first + c) to dst's image row r, (N, H, W, Cmid) in device
// memory, in 16-byte pieces along each pixel's channels. src is pixel-major
// with pixel stride ld (the FMA route's h1), or with CoreMatrices in the
// k-major core-matrix layout of pixel stride ld (the tc route's h1 and h2:
// ld odd, so the pieces a quarter warp reads, one pixel's consecutive
// channel blocks, fall on distinct banks).
template <bool CoreMatrices>
__device__ void store_row(const Args& a, const Elem* src, int ld, int first, Elem* dst, int n,
                          int r, int col0) {
  const int nq = a.Cmid / kVec;
  const int items = nq * a.TW;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int q = item % nq;
    const int c = item / nq;
    const int col = col0 + c;
    if (col < a.W)
      *reinterpret_cast<uint4*>(dst + ((size_t)(n * a.H + r) * a.W + col) * a.Cmid + q * kVec) =
          *reinterpret_cast<const uint4*>(
              src + (CoreMatrices ? kVec * (ld * q + first + c) : (first + c) * ld + q * kVec));
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

// ---------------------------------------------------------------------------
// The tc route (the bf16 build): every conv on the tensor cores with wgmma
// (bf16 x bf16 -> fp32). The shared-memory maps are restated in
// kernels/fused_block.py (x_stage_offset, w_stage_offset, h1_offset,
// h2_offset, conv2_a_start, fragment_rows_cols) and checked there on the CPU.

// Makes this thread's writes to shared memory (plain stores and cp.async)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// a wgmma fence or wait (no instruction).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor without swizzle: core matrices of 8 rows
// x 16 bytes (128 contiguous bytes); lbo is the byte step between core
// matrices along k, sbo the step along m (A) or n (B).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x NW, fp32) = (accumulate ? d : 0) + A (64 x 16, k-major) @ B (16 x
// NW, n-major), both bf16 in shared memory. Thread t of the warpgroup holds
// d[4j + 2h + e] = D[16 (t / 32) + 8h + (t % 32) / 4][8j + 2 (t % 4) + e].
template <int NW>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

// Start the copy of the weight stage W[k0 : k0+kb, n0 : n0+bn) (row-major,
// ld = ldw) into ws in wgmma's n-major core-matrix layout: a core matrix is
// 8 k-rows x 8 columns (16 bytes a row), the bn/8 core matrices of one block
// of 8 k-rows side by side, so the 16-byte piece idx (k-row idx % 8 of column
// block (idx / 8) % (bn / 8), k block idx / bn) lands at ws + 8 idx, and eight
// neighbouring threads fill one core matrix. Descriptor: lbo = 16 bn bytes
// (k), sbo = 128 (n).
__device__ __forceinline__ void stage_weights_tc(Elem* ws, const Elem* __restrict__ w, int ldw,
                                                 int n0, int k0, int bn, int kb) {
  const int blocks = bn / 8;
  for (int idx = threadIdx.x; idx < kb * blocks; idx += blockDim.x) {
    const int kg = (idx >> 3) / blocks, cb = (idx >> 3) - kg * blocks;
    cp_async16(ws + 8 * idx, w + (size_t)(k0 + 8 * kg + (idx & 7)) * ldw + n0 + 8 * cb);
  }
}

// Two BN scale or bias values (fp32 vector, ch even), rounded as bn_vec.
__device__ __forceinline__ float2 bn_vec2(const float* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(rnd(v.x), rnd(v.y));
}

// Two values exact in bf16 (rounded by the epilogue), stored as 4 bytes.
__device__ __forceinline__ void store2(Elem* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) =
      (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// relu(rnd(z + x)) of two bf16 pairs (the residual add rounds once more in
// bf16), as a bf16 pair.
__device__ __forceinline__ uint32_t add_relu2(uint32_t z, uint32_t x) {
  const float lo = fmaxf(rnd(__uint_as_float(z << 16) + __uint_as_float(x << 16)), 0.f);
  const float hi =
      fmaxf(rnd(__uint_as_float(z & 0xffff0000u) + __uint_as_float(x & 0xffff0000u)), 0.f);
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// conv3's epilogue stages kEpiCols columns of a warpgroup's fragment at a
// time in a tile of TW pixels x kEpiCols (128 bytes a pixel), in the x
// stages, which conv3 leaves free: column c of pixel p at piece (c/8) ^ (p%8)
// of the pixel's eight 16-byte pieces, so a warp's fragment stores (8 pixels,
// one piece) and its 16-byte reads (a pixel's 8 pieces a quarter warp) fall
// on distinct banks.
constexpr int kEpiCols = 64;

__device__ __forceinline__ int epi_offset(int p, int c) {
  return p * kEpiCols + 8 * ((c >> 3) ^ (p & 7)) + (c & 7);
}

// The barrier of this thread's warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

// One pass of a tc product: acc[t] = (64 rows of m64 tile t) x (this
// warpgroup's NW of the pass's bn columns), summed over `stages` stages of
// kb k-rows in a ring of Depth buffers (a power of 2) filled by cp.async.
// load(i) starts and commits stage i's copies into buffer i % Depth (the
// weight stage at wst + (i % Depth) * wstage, kb x bn in the n-major
// core-matrix layout); a_at(i, s, t) is the A descriptor of k16 step s of
// stage i for tile t. One barrier a stage; the products of stage i run
// while stages i+1 .. i+Depth-1 land. The epilogue reads acc after the
// pass, outside its k loop: a read of the accumulators inside the loop
// makes ptxas serialize every wgmma. Returns with all products done.
template <int MT, int NW, int Depth = 2, class Load, class ADesc>
__device__ __forceinline__ void tc_pass(float (&acc)[MT][NW / 2], int stages, int kb, int bn,
                                        const Elem* wst, int wstage, Load load, ADesc a_at) {
  static_assert(Depth >= 2 && (Depth & (Depth - 1)) == 0, "a power of 2 of buffers");
  const Elem* wcol = wst + 8 * (threadIdx.x >> 7) * NW;  // this warpgroup's columns
  __syncthreads();  // the buffers' last readers (the last pass's products) are done
  // one commit group a stage, empty past the last, so that stage i has
  // landed once at most Depth - 2 newer groups are pending
  for (int i = 0; i < Depth - 1; ++i) {
    if (i < stages) load(i);
    else cp_async_commit();
  }
  for (int i = 0; i < stages; ++i) {
    cp_async_wait<Depth - 2>();  // stage i has landed (this thread's copies)
    fence_proxy_async();         // ... visible to wgmma
    wgmma_wait_all();            // stage i-1's products are done with its buffers
    __syncthreads();             // ... everyone's: stage i+Depth-1 may take them
    if (i + Depth - 1 < stages) load(i + Depth - 1);
    else cp_async_commit();
    const Elem* ws = wcol + (i & (Depth - 1)) * wstage;
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_acc(acc[t]);
    wgmma_fence();
    for (int s = 0; s < kb / 16; ++s) {
      const uint64_t db = wgmma_desc(ws + 16 * s * bn, 16 * bn, 128);
#pragma unroll
      for (int t = 0; t < MT; ++t) Wgmma<NW>::mma(acc[t], a_at(i, s, t), db, i | s);
    }
    wgmma_commit();
  }
  wgmma_wait_all();
#pragma unroll
  for (int t = 0; t < MT; ++t) fence_acc(acc[t]);
}

// conv1 on the tensor cores: h1 for image row r at columns [col0 - d, col0 +
// TW + d) into one window position, as conv1_row. [P1 pixels x Cin] x [Cin x Cmid]
// in Cmid / bn1 passes of kb1-channel stages of x and w1: warpgroup g takes
// the pass's columns [g NW, (g+1) NW) over MT m64 tiles of pixels. An x
// stage holds channel block c/8 of pixel p at 8 (xs_px (c/8) + p) (lbo =
// 16 xs_px bytes, sbo = 128): the tiles' rows past P1 read whatever lies
// there (inside the block's shared memory, plan_tiles) and are never stored.
// h1 goes to its window position (slot: pixel 0 of the position in the
// plane) in the same k-major core-matrix layout with pixel stride ldh
// (channel block c/8 of pixel p at slot + 8 (ldh (c/8) + p)), which
// conv2_rows_tc reads as its A operand; all P1 pixels are zeros for a row
// outside the image.
template <int MT, int NW>
__device__ __forceinline__ void conv1_row_tc(const Args& a, Elem* slot, Elem* wst, Elem* xst,
                                             int n, int r, int col0) {
  const int P1 = a.TW + 2 * a.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int vh = a.valid ? __ldg(a.valid + 2 * n) : a.H;
  const int vw = a.valid ? __ldg(a.valid + 2 * n + 1) : a.W;
  // the slot held the last trip's h2 and the stage buffers its weights: their
  // readers (conv3's wgmma, waited for) are done
  __syncthreads();
  if (r < 0 || r >= vh) {  // the same for the whole block: a block has one image
    for (int i = tid; i < P1 * a.Cmid / 8; i += nt)
      *reinterpret_cast<uint4*>(slot + 8 * (a.ldh * (i / P1) + i % P1)) =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int kb = a.kb1, parts = kb / 8;
  const int xlen = a.xs_px * kb;
  const Elem* xrow = a.x + (size_t)(n * a.H + r) * a.W * a.Cin;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, tq = tid & 3;
  float acc[MT][NW / 2] = {};
  for (int n0 = 0; n0 < a.Cmid; n0 += a.bn1) {
    auto load = [&](int i) {
      const int k0 = i * kb;
      stage_weights_tc(wst + (i & 1) * a.wstage, a.w1, a.Cmid, n0, k0, a.bn1, kb);
      Elem* xs = xst + (i & 1) * xlen;
      for (int j = tid; j < P1 * parts; j += nt) {
        const int pix = j / parts, part = j - pix * parts;
        const int col = col0 - a.d + pix;
        const bool ok = col >= 0 && col < a.W;
        cp_async16(xs + 8 * (part * a.xs_px + pix),
                   xrow + (size_t)(ok ? col : 0) * a.Cin + k0 + 8 * part, ok);
      }
      cp_async_commit();
    };
    auto a_at = [&](int i, int s, int t) {
      return wgmma_desc(xst + (i & 1) * xlen + 8 * (2 * s * a.xs_px + 64 * t), 16 * a.xs_px, 128);
    };
    tc_pass<MT, NW>(acc, a.Cin / kb, kb, a.bn1, wst, a.wstage, load, a_at);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int ch = n0 + wg * NW + 8 * j + 2 * tq;
      const float2 s = bn_vec2(a.s1 + ch);
      const float2 b = bn_vec2(a.b1 + ch);
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pix = 64 * t + 16 * warp + 8 * h + g;
          const int col = col0 - a.d + pix;
          if (pix < P1) {
            const bool in = col >= 0 && col < vw;
            store2(slot + 8 * (a.ldh * (ch >> 3) + pix) + (ch & 7),
                   in ? fmaxf(frozen_bn(acc[t][4 * j + 2 * h], s.x, b.x), 0.f) : 0.f,
                   in ? fmaxf(frozen_bn(acc[t][4 * j + 2 * h + 1], s.y, b.y), 0.f) : 0.f);
          }
        }
    }
  }
}

// conv2's ring of w2 stages: the two weight buffers of conv1 and conv3 (2
// wstage elements) cut into this many, so that three stages are in flight
// while one is multiplied (the L2 latency of w2, which every block streams
// once an output row, is what bounds conv2).
constexpr int kConv2Buffers = 4;

// conv2 on the tensor cores: h2 of the output rows j and j+1 of a trip from
// the h1 rows j-1 .. j+2 at positions 0 .. 3 of the window (tc_segment).
// [2 rows x Cmid] x [9 Cmid x Cmid] in one pass over all Cmid columns
// (warpgroup g takes [g NW, (g+1) NW) over MT m64 tiles) and 9 Cmid / kb
// stages of w2's k-rows (kb divides Cmid, so a stage lies in one tap). The A
// operand of tap (ra, cb) starts at position ra shifted by cb*d pixels: row
// m of tile t, channel block c/8 at 8 (ldh (c/8) + ra P1 + cb d + 64 t + m),
// a descriptor shifted by 16 (ra P1 + cb d) bytes (lbo = 16 ldh, sbo = 128).
// Rows m < TW are output row j, rows P1 <= m < P1 + TW row j+1: the
// positions lie P1 pixels apart, so the taps of both rows are one descriptor
// and every w2 stage that a block streams from L2 serves two rows. Rows
// between and past them read whatever lies at their addresses inside the
// block's shared memory and are dropped. One pass, so h2 takes positions 0
// and 1 (h1 rows j-1 and j, which no later product reads) only after every
// product: row m of the tiles is plane pixel m, the layout conv3_row_tc
// reads.
template <int MT, int NW>
__device__ __forceinline__ void conv2_rows_tc(const Args& a, Elem* plane, Elem* wst) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, tq = tid & 3;
  const int P1 = a.TW + 2 * a.d, kb = a.kb;
  const int wbuf = 2 * a.wstage / kConv2Buffers;
  float acc[MT][NW / 2] = {};
  fence_proxy_async();  // conv1's epilogues and the window's shift wrote h1 with plain stores
  auto load = [&](int i) {
    stage_weights_tc(wst + (i & (kConv2Buffers - 1)) * wbuf, a.w2, a.Cmid, 0, i * kb, a.Cmid,
                     kb);
    cp_async_commit();
  };
  auto a_at = [&](int i, int s, int t) {
    const int tap = i * kb / a.Cmid, kc = i * kb - tap * a.Cmid;
    const int ra = tap / 3, cb = tap - 3 * ra;
    return wgmma_desc(plane + 8 * (a.ldh * (kc / 8 + 2 * s) + ra * P1 + cb * a.d + 64 * t),
                      16 * a.ldh, 128);
  };
  tc_pass<MT, NW, kConv2Buffers>(acc, 9 * a.Cmid / kb, kb, a.Cmid, wst, wbuf, load, a_at);
  __syncthreads();  // h2 takes positions 0, 1: every warpgroup's products are done
#pragma unroll
  for (int jj = 0; jj < NW / 8; ++jj) {
    const int ch = wg * NW + 8 * jj + 2 * tq;
    const float2 s = bn_vec2(a.s2 + ch);
    const float2 b = bn_vec2(a.b2 + ch);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = 64 * t + 16 * warp + 8 * h + g;
        if (pix < a.TW || (pix >= P1 && pix < P1 + a.TW))  // output row j or j+1
          store2(plane + 8 * (a.ldh * (ch >> 3) + pix) + (ch & 7),
                 fmaxf(frozen_bn(acc[t][4 * jj + 2 * h], s.x, b.x), 0.f),
                 fmaxf(frozen_bn(acc[t][4 * jj + 2 * h + 1], s.y, b.y), 0.f));
      }
  }
}

// conv3 on the tensor cores: out row r = relu(bn3(conv3 h2) + x), as
// conv3_row. h2 lies at its window position in the core-matrix layout
// (channel block c/8 of pixel p at h2 + 8 (h2p (c/8) + p), h2p = ldh,
// written by conv2_rows_tc), whole:
// [TW x Cmid] x [Cmid x Cin] in Cin / bn3 passes of kb3-row stages of w3;
// warpgroup g takes the pass's columns [g NW, (g+1) NW) over MT m64 tiles.
// The epilogue goes through shared memory (epi_offset): bn3 of the fragment
// into the warpgroup's tile at xst + g TW kEpiCols, then the residual add
// and the ReLU in 16-byte pieces along each pixel's channels, so the reads
// of x and the stores of out take whole sectors.
template <int MT, int NW>
__device__ __forceinline__ void conv3_row_tc(const Args& a, const Elem* h2, Elem* wst,
                                             Elem* xst, int n, int r, int col0) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, tq = tid & 3;
  const int kb = a.kb3;
  float acc[MT][NW / 2] = {};
  fence_proxy_async();  // conv2's epilogue wrote h2 with plain stores
  for (int n0 = 0; n0 < a.Cin; n0 += a.bn3) {
    auto load = [&](int i) {
      stage_weights_tc(wst + (i & 1) * a.wstage, a.w3, a.Cin, n0, i * kb, a.bn3, kb);
      cp_async_commit();
    };
    auto a_at = [&](int i, int s, int t) {
      return wgmma_desc(h2 + 8 * (a.h2p * (i * kb / 8 + 2 * s) + 64 * t), 16 * a.h2p, 128);
    };
    tc_pass<MT, NW>(acc, a.Cmid / kb, kb, a.bn3, wst, a.wstage, load, a_at);
    Elem* tile = xst + wg * a.TW * kEpiCols;
#pragma unroll
    for (int c = 0; c < NW / kEpiCols; ++c) {
      if (c > 0) warpgroup_sync();  // the last chunk's reads of the tile are done
#pragma unroll
      for (int jj = 0; jj < kEpiCols / 8; ++jj) {
        const int j = c * (kEpiCols / 8) + jj;
        const int ch = n0 + wg * NW + 8 * j + 2 * tq;
        const float2 s = bn_vec2(a.s3 + ch);
        const float2 b = bn_vec2(a.b3 + ch);
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pix = 64 * t + 16 * warp + 8 * h + g;
            if (pix < a.TW)
              store2(tile + epi_offset(pix, 8 * jj + 2 * tq),
                     frozen_bn(acc[t][4 * j + 2 * h], s.x, b.x),
                     frozen_bn(acc[t][4 * j + 2 * h + 1], s.y, b.y));
          }
      }
      warpgroup_sync();  // the chunk's tile is whole
      const int ch0 = n0 + wg * NW + c * kEpiCols;
      constexpr int kPieces = kEpiCols / 8;  // 16-byte pieces a pixel
      for (int i = tid & 127; i < a.TW * kPieces; i += 128) {
        const int pix = i / kPieces, q = i % kPieces;
        const int col = col0 + pix;
        if (col < a.W) {
          const size_t o = ((size_t)(n * a.H + r) * a.W + col) * a.Cin + ch0 + 8 * q;
          const uint4 z = *reinterpret_cast<const uint4*>(tile + epi_offset(pix, 8 * q));
          const uint4 xr = __ldg(reinterpret_cast<const uint4*>(a.x + o));
          *reinterpret_cast<uint4*>(a.out + o) =
              make_uint4(add_relu2(z.x, xr.x), add_relu2(z.y, xr.y), add_relu2(z.z, xr.z),
                         add_relu2(z.w, xr.w));
        }
      }
    }
  }
}

// The tc route's instances: MT m64 tiles x NW columns a warpgroup, at most
// 64 fp32 accumulators a thread (plan_tiles; 128 spill beside the FMA loop).
#define DISPATCH_TC(mt, nw, CALL)                                   \
  if ((nw) == 128) {                                                \
    constexpr int MT = 1, NW = 128; CALL;                           \
  } else if ((mt) == 1) {                                           \
    constexpr int MT = 1, NW = 64; CALL;                            \
  } else {                                                          \
    constexpr int MT = 2, NW = 64; CALL;                            \
  }

// conv2's instances on the tc route: one pass over all Cmid columns, NW =
// Cmid / warpgroups, over MT m64 tiles of the trip's rows (plan_tiles:
// layers 1-2 64 columns over 2 or 4 tiles, layer3 128 over 1 or 2, layer4 256
// over 1, whose 128 accumulators a thread fit beside the rest of the kernel
// with no FMA loop in the bf16 build).
#define DISPATCH_CONV2(mt, nw, CALL)                                \
  if ((nw) == 256) {                                                \
    constexpr int MT = 1, NW = 256; CALL;                           \
  } else if ((nw) == 128 && (mt) == 1) {                            \
    constexpr int MT = 1, NW = 128; CALL;                           \
  } else if ((nw) == 128) {                                         \
    constexpr int MT = 2, NW = 128; CALL;                           \
  } else if ((mt) == 1) {                                           \
    constexpr int MT = 1, NW = 64; CALL;                            \
  } else if ((mt) == 2) {                                           \
    constexpr int MT = 2, NW = 64; CALL;                            \
  } else {                                                          \
    constexpr int MT = 4, NW = 64; CALL;                            \
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

// The tc route's walk down a segment of a chain, two output rows a trip: a
// window of four h1 rows at positions 0 .. 3 of one core-matrix plane (ldh
// pixels a channel block, P1 pixels a position), holding rows j-1 .. j+2
// for the trip of output rows j and j+1. conv2_rows_tc multiplies both rows
// at once, its h2 takes positions 0 and 1, conv3 runs row by row; then rows
// j+1 and j+2 move from positions 2, 3 to 0, 1 and conv1 fills positions 2
// and 3 with rows j+3 and j+4 of the next trip. A trip with one row (the
// segment's or the image's last) leaves position 3 as it was and drops the
// h2 of its second row, the only one that reads it; conv1 thus makes RS + 2
// rows a segment, as on the FMA route.
template <bool Emit>
__device__ __forceinline__ void tc_segment(const Args& a, Elem* plane, Elem* wst, Elem* xst,
                                           int n, int res, int j0, int col0) {
  const int P1 = a.TW + 2 * a.d;
  auto conv1 = [&](int k, int j) {  // h1 row j of the chain into position k
    DISPATCH_TC(a.mt1, a.bn1 * 128 / (int)blockDim.x,
                (conv1_row_tc<MT, NW>(a, plane + 8 * k * P1, wst, xst, n, res + a.d * j, col0)))
  };
  for (int j = j0; j < j0 + a.RS; j += 2) {
    const int r = res + a.d * j;
    if (r >= a.H) break;
    const int rows = j + 1 < j0 + a.RS && r + a.d < a.H ? 2 : 1;
    // the window holds rows j-1 .. j+rows: the first trip makes them all, a
    // later one those past the two it moved to positions 0, 1
    for (int k = j == j0 ? 0 : 2; k < rows + 2; ++k) conv1(k, j - 1 + k);
    __syncthreads();  // the window's h1 is whole
    if constexpr (Emit)
      for (int q = 0; q < rows; ++q)
        store_row<true>(a, plane, a.ldh, (q + 1) * P1 + a.d, a.h1, n, r + q * a.d, col0);
    DISPATCH_CONV2(a.mt2, a.Cmid * 128 / (int)blockDim.x,
                   (conv2_rows_tc<MT, NW>(a, plane, wst)))
    __syncthreads();  // h2 is whole
    for (int q = 0; q < rows; ++q) {
      if constexpr (Emit) store_row<true>(a, plane, a.ldh, q * P1, a.h2, n, r + q * a.d, col0);
      DISPATCH_TC(a.mt3, a.bn3 * 128 / (int)blockDim.x,
                  (conv3_row_tc<MT, NW>(a, plane + 8 * q * P1, wst, xst, n, r + q * a.d, col0)))
    }
    if (rows < 2 || j + 2 >= j0 + a.RS || r + 2 * a.d >= a.H) break;  // no next trip
    __syncthreads();  // conv3's reads of h2 are done
    for (int i = threadIdx.x; i < 2 * P1 * a.Cmid / 8; i += blockDim.x) {
      const int e = 8 * (a.ldh * (i / (2 * P1)) + i % (2 * P1));  // positions 2, 3 to 0, 1
      *reinterpret_cast<uint4*>(plane + e) = *reinterpret_cast<const uint4*>(plane + e + 16 * P1);
    }
  }
}

// The FMA route's walk down a segment of a chain: a ring of three h1 rows;
// rows j0-1 and j0 of the chain only fill it; from j0 on, every trip adds h1
// row j+1 and finishes output row j.
template <bool Emit>
__device__ __forceinline__ void fma_segment(const Args& a, Elem* h1, Elem* wst, Elem* xst,
                                            int n, int res, int j0, int col0) {
  const int slot_len = (a.TW + 2 * a.d) * a.ldh;
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
    if (Emit) store_row<false>(a, h1 + ring_slot(j) * slot_len, a.ldh, a.d, a.h1, n, r, col0);
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

// grid: (column strips, N * d * S); block y = ((n * d) + residue) * S + segment.
// shared: h1 ring (FMA: h2 in its oldest slot; tc: tc_segment's window) |
// two weight stages | two x stages.
template <bool Emit>
__global__ void __launch_bounds__(kMaxThreads) fused_bottleneck_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  Elem* h1 = reinterpret_cast<Elem*>(smem4);
  // the FMA route's ring: three slots of P1 pixels, pixel stride ldh; the tc
  // route's window: one core-matrix plane of ldh pixels a channel block
  Elem* wst = h1 + (kTensorCores ? a.ldh * a.Cmid : 3 * (a.TW + 2 * a.d) * a.ldh);
  Elem* xst = wst + 2 * a.wstage;  // fma: a.kb + kVec elements a pixel; tc: core matrices

  const int col0 = blockIdx.x * a.TW;
  int chain = blockIdx.y;
  const int seg = chain % a.S;
  chain /= a.S;
  const int res = chain % a.d;
  const int n = chain / a.d;
  const int j0 = seg * a.RS;
  if (res + a.d * j0 >= a.H) return;  // the whole block: no row of this segment
  if constexpr (kTensorCores) {
    tc_segment<Emit>(a, h1, wst, xst, n, res, j0, col0);
  } else {
    fma_segment<Emit>(a, h1, wst, xst, n, res, j0, col0);
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

// The mapping the kernel relies on (kernels/fused_block.py plan_tiles owns
// the arithmetic); a plan that breaks it is refused.
bool plan_ok(const Args& a, int threads) {
  const int P1 = a.TW + 2 * a.d;
  if (threads != 128 && threads != 256) return false;
  if (a.Cmid % 32 || a.Cin % 32 || a.bn3 % 32 || a.Cin % a.bn3) return false;
  if (a.wstage < a.kb * a.Cmid) return false;
  if constexpr (kTensorCores) {
    const int wgs = threads / 128, nw1 = a.bn1 / wgs, nw3 = a.bn3 / wgs;
    const int nw2 = a.Cmid / wgs;
    auto tile_ok = [](int mt, int nw) {  // a DISPATCH_TC instance
      return (nw == 64 && (mt == 1 || mt == 2)) || (nw == 128 && mt == 1);
    };
    // conv2: a DISPATCH_CONV2 instance over the m64 tiles of its two rows
    // (P1 apart), stages of kb k-rows inside one tap, the window of four
    // rows in one plane, h2 in it at pixel stride ldh
    const bool conv2_ok =
        a.mt2 == (P1 + a.TW + 63) / 64 &&
        ((nw2 == 64 && (a.mt2 == 1 || a.mt2 == 2 || a.mt2 == 4)) ||
         (nw2 == 128 && (a.mt2 == 1 || a.mt2 == 2)) || (nw2 == 256 && a.mt2 == 1)) &&
        a.Cmid % wgs == 0 && a.kb % 16 == 0 && a.kb > 0 && a.Cmid % a.kb == 0 &&
        kConv2Buffers * a.kb * a.Cmid <= 2 * a.wstage && a.ldh >= 4 * P1 &&
        a.h2p == a.ldh;
    return conv2_ok && tile_ok(a.mt1, nw1) && tile_ok(a.mt3, nw3) && a.bn1 % wgs == 0 &&
           a.bn3 % wgs == 0 && a.Cmid % a.bn1 == 0 &&
           a.mt1 == (P1 + 63) / 64 && a.mt3 == (a.TW + 63) / 64 &&
           a.kb1 % 16 == 0 && a.kb1 > 0 && a.Cin % a.kb1 == 0 &&
           a.kb3 % 16 == 0 && a.kb3 > 0 && a.Cmid % a.kb3 == 0 &&
           a.wstage >= a.kb1 * a.bn1 && a.wstage >= a.kb3 * a.bn3 && a.xs_px >= P1 &&
           wgs * a.TW * kEpiCols <= 2 * a.xs_px * a.kb1;
  } else {
    // conv2 on the FMA loop
    if (!px_ok(a.px2) || (a.kb != 8 && a.kb != 16) || threads % (a.Cmid / 4) ||
        a.TW != a.px2 * (threads / (a.Cmid / 8)))
      return false;
    if (a.ldh < a.Cmid || a.ldh % kVec) return false;
    return px_ok(a.px1) && px_ok(a.px3) && threads % (a.bn3 / 4) == 0 &&
           a.TW == a.px3 * (threads / (a.bn3 / 8)) &&
           a.px1 * (threads / (a.Cmid / 8)) >= P1 && a.wstage >= a.kb * a.bn3 &&
           a.xs_px >= P1;
  }
}

}  // namespace

// The launch function of this library's element type: fp32, or bf16 when
// built with -DMSL_BF16 (kernels/fused_block.py loads each by its name).
#ifdef MSL_BF16
#define MSL_FUSED_BOTTLENECK msl_fused_bottleneck_bf16
#else
#define MSL_FUSED_BOTTLENECK msl_fused_bottleneck_f32
#endif

// The tile arguments come from kernels/fused_block.py plan_tiles, which owns
// their arithmetic (plan_ok lists what the kernel relies on): threads 128 or
// 256. The FMA route (fp32): threads = pixel tiles x Cmid/8 = pixel tiles x
// bn3/8, TW = px2 x tiles = px3 x tiles, px1 x tiles >= TW + 2d, ldh >= Cmid
// a multiple of 16 bytes, kb (every stage) 8 or 16, wstage >= kb * max(Cmid,
// bn3) elements, xs_px >= TW + 2d, and kb1, kb3, mt1, mt3, h2p, bn1, mt2
// unused. The tc route (bf16): bn1 (dividing Cmid) and bn3 (dividing Cin)
// over the warpgroups 128 columns with one m64 tile or 64 with one or two,
// mt1 = ceil((TW + 2d) / 64) and mt3 = ceil(TW / 64), kb1 and kb3 multiples
// of 16 dividing Cin and Cmid, wstage >= kb1 * bn1 and kb3 * bn3, xs_px >=
// TW + 2d; conv2 over two output rows a pass, mt2 = ceil((2 TW + 2d) / 64)
// tiles of Cmid / warpgroups columns (a DISPATCH_CONV2 instance), kb (its
// stages) a multiple of 16 dividing Cmid with kConv2Buffers * kb * Cmid <= 2
// wstage, ldh >= 4 (TW + 2d) the window plane's pixel stride, h2p = ldh;
// px1, px2, px3 unused.
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
    int xs_px, int kb, int kb1, int kb3, int mt1, int mt3, int h2p, int bn1, int mt2,
    void* stream) {
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
  a.kb1 = kb1;
  a.kb3 = kb3;
  a.mt1 = mt1;
  a.mt3 = mt3;
  a.h2p = h2p;
  a.bn1 = bn1;
  a.mt2 = mt2;
  if (!plan_ok(a, threads)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(h1 != nullptr ? launch<true>(a, threads, smem_bytes, s)
                             : launch<false>(a, threads, smem_bytes, s));
}

extern "C" const char* msl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
