// Matmul-chain calibration probe, fp32 (CUDA cores) and bf16 (tensor cores),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` of experiments/bench_pallas_matmul.py
// (:42, launched by the pallas_call at :60), the MXU calibration probe. For
// cell c of x (C, M, K), weights A (K, N) and B (N, K) in one type T (fp32 or
// bf16), an output type O (fp32 or bf16) and a scalar t:
//
//   y = x[c] + (T) t
//   for i in 0 .. chain-1:   y = (T) relu((O) (y @ W_i)),   W_i = A (i even), B (i odd)
//   out[c, 0, :] = sum over the M rows of (float) y
//
// Each product accumulates in fp32. The chain is odd, so the last product is
// N wide (the reference's out spec (1, 1, N) only fits an odd chain).
//
// What bounds it. 2*M*K*N FLOP per link and cell against 2*M*K bytes of x
// (bf16) read once: at the defaults (M 1728, K 1024, N 256, C 72, chain 3)
// 195.7 GFLOP against 255 MB, 768 FLOP/B, far above the H100's ridge in
// either type (bf16 tensor cores 989 TFLOP/s / 3.35 TB/s = 295 FLOP/B; fp32
// CUDA cores 67 TFLOP/s, 20 FLOP/B). So the bound is the operations: 0.198
// ms in bf16, 2.92 ms in fp32. Inside the card the weights are the traffic:
// every block streams each whole weight from L2 for its own TM rows, 2*TM
// FLOP per weight element.
//
// Design (the fused bottleneck's structure without its halo, dilation and
// masks: a row tile resident in shared memory, the weights streamed from L2):
// - On the TPU one grid cell holds all M x K of its activations in VMEM.
//   Here a cell's activations are 3.5 MB in bf16, so a block owns TM rows of
//   one cell instead (the chain is row-local) and keeps them in shared memory
//   through the whole chain: a TM x K buffer and a TM x N buffer, each link
//   reading one and writing the other. The grid is (ceil(M/TM), C): 27 x 72
//   blocks at the defaults. kernels/matmul_probe.py plan_probe picks the
//   route, TM and the weight ring and hands them to the launch.
// - A block is 8 warps that multiply and one warp that fetches. The weights
//   stream from L2 through a ring of `depth` stages of KB k-rows by BN
//   columns that fills what the activation buffers leave of the block's 227
//   KB. The wrapper packs a and b once per call into stage order
//   (pack_weight), each stage laid out as the multiplying warps read it, so
//   one lane of the fetching warp fills a slot with a single bulk
//   asynchronous copy (cp.async.bulk, no tensor map) that completes the
//   slot's `full` mbarrier; copies of a stage's rows one by one reached a
//   third of that rate. A multiplying warp waits for `full`, multiplies, and
//   arrives on the slot's `empty` mbarrier, which the fetching lane waits for
//   before it refills the slot. No barrier of the whole block stands between
//   two stages, the warps drift apart, and the ring runs on across column
//   passes and links: a pass's first stages land during the epilogue before.
// - x arrives by 16-byte cp.async, every piece of the tile in flight at once;
//   then the thread that copied a piece adds t to it in place.
// - Each link's epilogue applies the casts and the ReLU in the reference's
//   order and writes the next link's operand to shared memory in T; the
//   multiplying warps meet one barrier of their own between two links.
// - Ragged M: rows past M are zeros and are left out of the row sum.
// - Deterministic row sum, no atomics: each block sums its rows in order into
//   one partial per (cell, row tile, column); a second kernel, one thread per
//   (cell, column), sums the row tiles' partials in order.
//
// Route "wgmma" (bf16, K and N multiples of 256, a 64-row tile that fits):
// - Two warpgroups, each 128 of a pass's 256 output columns, issue
//   wgmma.mma_async m64n128k16 (fp32 accumulators in registers) with both
//   operands read from shared memory through descriptors.
// - The activation tiles lie in the layout wgmma reads without swizzle: core
//   matrices of 8 rows x 16 bytes, 128 contiguous bytes each (act_offset).
//   The fill from x, every epilogue and the final row sum use that map.
// - The weights are (K, N) row-major, n-major for wgmma's B: packed as 8 x 8
//   core matrices, 32 k-rows of one pass in 16 contiguous KB, they are read
//   with the transpose flag of the instruction.
// - One stage's products stay in flight while the next stage's are issued; a
//   slot is released when its products have completed.
//
// Routes "mma_sync" (bf16 elsewhere: TM 64 or 32) and "fma" (fp32: TM 32 or
// 16): row-major activations and weight stages in rows padded by 16 bytes
// (packed so, the last pass of a weight padded by zero columns).
// - bf16: each warp a 32 x 64 output tile as 2 x 8 mma.sync m16n8k16 (bf16
//   in, fp32 accumulators). A fragments come by ldmatrix.x4 from the
//   activations, B fragments by ldmatrix.x4.trans from the weight stage; the
//   padding keeps the fragment loads and the epilogue's stores off each
//   other's banks.
// - fp32: a thread owns an 8-row x 4-column register tile (32 fp32
//   accumulators, FMA on the CUDA cores). All lanes of a warp share their 8
//   rows, so the activation operand is a broadcast float4 read (4 k-steps);
//   the weight operand is one float4 read a k-step, a warp on 512 contiguous
//   bytes: 12 shared-memory reads for 128 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                // the 8 warps that multiply
constexpr int kWarps = kThreads / 32;
constexpr int kBlockThreads = kThreads + 32;  // and one warp that fetches the weights
constexpr int kPadBytes = 16;   // padding at the end of every padded shared row
constexpr int kMaxDepth = 8;    // stages of the weight ring, at most

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16(v);  // round to nearest even, as astype
  }
};

// The activation of one link's fp32 sum: (O) -> relu; the caller casts to T.
__device__ __forceinline__ float act(float v, bool out_bf16) {
  if (out_bf16) v = __bfloat162float(__float2bfloat16(v));
  return fmaxf(v, 0.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies and the barriers they report to

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

// Until every cp.async of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
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

// One bulk copy of `bytes` (a multiple of 16; dst, src 16-byte aligned) that
// reports to bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The multiplying warps' own barrier (id 1): the fetching warp never joins.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The weight ring of one block: `depth` stages, each with a barrier that its
// copies complete (full) and one that its readers release (empty). One warp
// fetches; the 8 multiplying warps release.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int depth;
  int slot = 0;
  uint32_t parity;  // a fetcher starts at 1: a fresh slot is free

  // One thread, then a barrier of the block.
  __device__ static void init(uint64_t* full, uint64_t* empty, int depth) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < depth; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  __device__ __forceinline__ void advance() {
    if (++slot == depth) {
      slot = 0;
      parity ^= 1;
    }
  }
  // A reader's warp is done with slot s.
  __device__ __forceinline__ void release(int s) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + s);
  }
};

// The fetching warp's one working lane: the wrapper has packed a and b into
// stage order (kernels/matmul_probe.py pack_weight), so stage s of a link is
// the s-th run of stage_bytes in its weight, and one bulk copy fills a slot.
__device__ void fetch_stages(const void* wa, const void* wb, int stages_a, int stages_b,
                             uint32_t stage_bytes, int chain, unsigned char* slots, Ring ring) {
  ring.parity = 1;
  for (int link = 0; link < chain; ++link) {
    const unsigned char* w = static_cast<const unsigned char*>((link & 1) ? wb : wa);
    const int stages = (link & 1) ? stages_b : stages_a;
    for (int s = 0; s < stages; ++s) {
      mbar_wait(ring.empty + ring.slot, ring.parity);
      mbar_expect_tx(ring.full + ring.slot, stage_bytes);
      bulk_load(slots + (size_t)ring.slot * stage_bytes, w + (size_t)s * stage_bytes,
                stage_bytes, ring.full + ring.slot);
      ring.advance();
    }
  }
}

template <typename T>
__host__ __device__ constexpr int pad_elems() {
  return kPadBytes / static_cast<int>(sizeof(T));
}

// Output columns one block computes per pass: bf16 warps are 32 x 64 tiles,
// fp32 warps cover 8 rows x 128 columns.
template <typename T, int TM>
__host__ __device__ constexpr int block_cols() {
  return sizeof(T) == 2 ? 64 * (kWarps / (TM / 32)) : 128 * (kWarps / (TM / 8));
}

// ---------------------------------------------------------------------------
// Routes "mma_sync" (bf16) and "fma" (fp32): row-major activations and weight
// stages in padded rows. A stage is W[k0 : k0+KB, n0 : n0+BN) in rows of
// BN + pad; the wrapper pads a weight's last pass with zero columns.

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// One bf16 link: out[TM, nout] = act(in[TM, kin] @ w[kin, nout]), in T.
template <int TM, int KB>
__device__ void link_bf16(const __nv_bfloat16* in, int ldin, int kin, int nout,
                          __nv_bfloat16* out, int ldout, bool out_bf16,
                          const __nv_bfloat16* ring_base, Ring& ring) {
  constexpr int kWarpsM = TM / 32;
  constexpr int kWarpsN = kWarps / kWarpsM;
  constexpr int BN = 64 * kWarpsN;
  constexpr int ldw = BN + pad_elems<__nv_bfloat16>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix addresses: A matrices are rows 0-7 / 8-15 at k 0-7, then at k
  // 8-15; B matrices k 0-7 / 8-15 of n-tile 2nj, then of n-tile 2nj+1
  const int arow = wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8, bcol = wn * 64 + (lane >> 4) * 8;

  for (int n0 = 0; n0 < nout; n0 += BN) {
    const bool active = n0 + wn * 64 < nout;  // the same for the whole warp
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

    for (int k0 = 0; k0 < kin; k0 += KB) {
      mbar_wait(ring.full + ring.slot, ring.parity);
      const __nv_bfloat16* wsk = ring_base + (size_t)ring.slot * KB * ldw;
      if (active) {
#pragma unroll
        for (int kk = 0; kk < KB; kk += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldmatrix_x4(a[mi], in + (arow + mi * 16) * ldin + k0 + kk + acol);
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, wsk + (kk + brow) * ldw + bcol + nj * 16);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
              mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
      __syncwarp();  // every lane's fragments are in registers
      ring.release(ring.slot);
      ring.advance();
    }

    if (active) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int row = wm * 32 + mi * 16 + g;
          const int col = n0 + wn * 64 + ni * 8 + 2 * tq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162 v;
            v.x = __float2bfloat16(act(acc[mi][ni][2 * h], out_bf16));
            v.y = __float2bfloat16(act(acc[mi][ni][2 * h + 1], out_bf16));
            *reinterpret_cast<__nv_bfloat162*>(out + (row + 8 * h) * ldout + col) = v;
          }
        }
    }
  }
}

// One fp32 link: out[TM, nout] = act(in[TM, kin] @ w[kin, nout]).
template <int TM, int KB>
__device__ void link_f32(const float* in, int ldin, int kin, int nout, float* out, int ldout,
                         bool out_bf16, const float* ring_base, Ring& ring) {
  constexpr int kGroups = TM / 8;  // 8-row groups, one per warp set
  constexpr int kWarpsPerGroup = kWarps / kGroups;
  constexpr int BN = 128 * kWarpsPerGroup;
  constexpr int ldw = BN + pad_elems<float>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / kWarpsPerGroup) * 8;
  const int cb = (warp % kWarpsPerGroup) * 128 + 4 * lane;

  for (int n0 = 0; n0 < nout; n0 += BN) {
    const bool active = n0 + cb < nout;  // columns past nout would read a stale stage
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

    for (int k0 = 0; k0 < kin; k0 += KB) {
      mbar_wait(ring.full + ring.slot, ring.parity);
      const float* wsk = ring_base + (size_t)ring.slot * KB * ldw;
      if (active) {
#pragma unroll
        for (int kk = 0; kk < KB; kk += 4) {
          float4 av[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            av[r] = *reinterpret_cast<const float4*>(in + (r0 + r) * ldin + k0 + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 bv = *reinterpret_cast<const float4*>(wsk + (kk + j) * ldw + cb);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float a = j == 0 ? av[r].x : j == 1 ? av[r].y : j == 2 ? av[r].z : av[r].w;
              acc[r][0] = fmaf(a, bv.x, acc[r][0]);
              acc[r][1] = fmaf(a, bv.y, acc[r][1]);
              acc[r][2] = fmaf(a, bv.z, acc[r][2]);
              acc[r][3] = fmaf(a, bv.w, acc[r][3]);
            }
          }
        }
      }
      __syncwarp();  // every lane has read the stage
      ring.release(ring.slot);
      ring.advance();
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        *reinterpret_cast<float4*>(out + (r0 + r) * ldout + n0 + cb) =
            make_float4(act(acc[r][0], out_bf16), act(acc[r][1], out_bf16),
                        act(acc[r][2], out_bf16), act(acc[r][3], out_bf16));
    }
  }
}

// grid (row tiles, C). wa, wb: the weights in stage order. partial: (C,
// tiles, N) fp32.
template <typename T, int TM, int KB>
__global__ void __launch_bounds__(kBlockThreads, 1)
    chain_kernel(const float* __restrict__ t, const T* __restrict__ x,
                 const T* __restrict__ wa, const T* __restrict__ wb, int M, int K, int N,
                 int chain, bool out_bf16, int depth, float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxDepth], empty[kMaxDepth];
  constexpr int pad = pad_elems<T>();
  constexpr int BN = block_cols<T, TM>();
  const int ldk = K + pad, ldn = N + pad;
  T* buf_k = reinterpret_cast<T*>(smem_raw);
  T* buf_n = buf_k + TM * ldk;
  T* ring_base = buf_n + TM * ldn;

  const int tile = blockIdx.x, cell = blockIdx.y;
  const int row0 = tile * TM;
  const int rows = min(TM, M - row0);

  Ring::init(full, empty, depth);
  Ring ring{full, empty, depth, 0, 0};
  if (threadIdx.x >= kThreads) {
    if (threadIdx.x == kThreads)
      fetch_stages(wa, wb, (N + BN - 1) / BN * (K / KB), (K + BN - 1) / BN * (N / KB),
                   KB * (BN + pad) * sizeof(T), chain,
                   reinterpret_cast<unsigned char*>(ring_base), ring);
  } else {
    // y = x + (T) t, rows past M as zeros: every 16-byte piece is copied
    // asynchronously, all at once; then the thread that copied a piece adds t
    // to it in place
    const float tt = Elem<T>::to_float(Elem<T>::from_float(__ldg(t)));
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = K / kVec;
    const T* xc = x + ((size_t)cell * M + row0) * K;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, col = (i % per_row) * kVec;
      cp_async16(buf_k + r * ldk + col, xc + (size_t)r * K + col);
    }
    cp_async_wait_all();
    for (int i = threadIdx.x; i < TM * per_row; i += kThreads) {
      const int r = i / per_row, col = (i % per_row) * kVec;
      alignas(16) T v[kVec];
      uint4* piece = reinterpret_cast<uint4*>(buf_k + r * ldk + col);
      if (r < rows) {
        *reinterpret_cast<uint4*>(v) = *piece;
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          v[j] = Elem<T>::from_float(Elem<T>::to_float(v[j]) + tt);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = Elem<T>::from_float(0.f);
      }
      *piece = *reinterpret_cast<uint4*>(v);
    }

    T* in = buf_k;
    T* out = buf_n;
    int ldin = ldk, ldout = ldn, kin = K, nout = N;
    for (int i = 0; i < chain; ++i) {
      consumer_sync();  // the tile (x, or the link before) is whole
      if constexpr (sizeof(T) == 2)
        link_bf16<TM, KB>(in, ldin, kin, nout, out, ldout, out_bf16, ring_base, ring);
      else
        link_f32<TM, KB>(in, ldin, kin, nout, out, ldout, out_bf16, ring_base, ring);
      T* tp = in; in = out; out = tp;
      int ti = ldin; ldin = ldout; ldout = ti;
      ti = kin; kin = nout; nout = ti;
    }
    consumer_sync();

    // in holds the last link's (TM, N) output: sum its valid rows in order
    float* pc = partial + ((size_t)cell * gridDim.x + tile) * N;
    for (int col = threadIdx.x; col < N; col += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += Elem<T>::to_float(in[r * ldin + col]);
      pc[col] = s;
    }
  }
}

// out[c, n] = sum over tiles of partial[c, tile, n], tiles in order.
__global__ void __launch_bounds__(kThreads)
    sum_tiles_kernel(const float* __restrict__ partial, int C, int tiles, int N,
                     float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= C * N) return;
  const int c = i / N, n = i % N;
  const float* p = partial + (size_t)c * tiles * N + n;
  float s = 0.f;
  for (int tile = 0; tile < tiles; ++tile) s += p[(size_t)tile * N];
  out[i] = s;
}

// Launch `kernel` on (tiles, C) blocks of kBlockThreads threads, then the sum
// over the row tiles.
template <typename Kernel, typename... Args>
int launch_chain(Kernel kernel, size_t smem, int tiles, int C, int N, void* partial, void* out,
                 cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(tiles, C), kBlockThreads, smem, s>>>(args..., static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_tiles_kernel<<<(C * N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), C, tiles, N, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T, int TM, int KB>
int launch(const void* t, const void* x, const void* wa, const void* wb, int C, int M,
           int K, int N, int chain, bool out_bf16, int depth, void* partial, void* out,
           cudaStream_t s) {
  constexpr int pad = pad_elems<T>();
  if (depth < 2 || depth > kMaxDepth || K % KB || N % KB) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * ((size_t)TM * (K + pad) + (size_t)TM * (N + pad) +
                                   (size_t)depth * KB * (block_cols<T, TM>() + pad));
  return launch_chain(chain_kernel<T, TM, KB>, smem, (M + TM - 1) / TM, C, N, partial, out, s,
                      static_cast<const float*>(t), static_cast<const T*>(x),
                      static_cast<const T*>(wa), static_cast<const T*>(wb), M, K, N, chain,
                      out_bf16, depth);
}

// ---------------------------------------------------------------------------
// Route "wgmma" (bf16, TM 64, K and N multiples of 256).

constexpr int kWgBN = 256;  // output columns a pass: 128 a warpgroup
constexpr int kWgKB = 32;   // k-rows of a weight stage
constexpr int kWgStageBytes = kWgKB * kWgBN * 2;

// Makes this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A shared-memory matrix descriptor without swizzle: core matrices of 8 rows
// x 16 bytes, 128 contiguous bytes each; lbo is the byte step between core
// matrices along k, sbo the step along m (or n).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 128, fp32) = or += A (64 x 16, k-major) @ B (16 x 128, n-major),
// both bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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

// Byte offset of element (r, c) of a 64-row activation tile in the layout
// wgmma reads without swizzle: core matrices of 8 rows x 8 columns (128
// contiguous bytes), the 8 row groups of one column group side by side.
__device__ __forceinline__ int act_offset(int r, int c) {
  return (((c >> 3) * 8 + (r >> 3)) << 7) + ((r & 7) << 4) + ((c & 7) << 1);
}

// grid (row tiles, C). wa, wb: the weights in stage order
// (kernels/matmul_probe.py pack_weight). partial: (C, tiles, N) fp32.
__global__ void __launch_bounds__(kBlockThreads, 1)
    chain_wgmma_kernel(const float* __restrict__ t, const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wa,
                       const __nv_bfloat16* __restrict__ wb, int M, int K, int N, int chain,
                       bool out_bf16, int depth, float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxDepth], empty[kMaxDepth];
  unsigned char* buf_k = smem_raw;            // 64 x K
  unsigned char* buf_n = buf_k + 128 * K;     // 64 x N
  unsigned char* stages_base = buf_n + 128 * N;  // depth stages

  const int tile = blockIdx.x, cell = blockIdx.y;
  const int row0 = tile * 64;
  const int rows = min(64, M - row0);

  Ring::init(full, empty, depth);
  Ring ring{full, empty, depth, 0, 0};
  if (threadIdx.x >= kThreads) {
    // ---- the fetching warp
    if (threadIdx.x == kThreads) {
      const int stages = (K / kWgKB) * (N / kWgBN);  // the same for a and b
      fetch_stages(wa, wb, stages, stages, kWgStageBytes, chain, stages_base, ring);
    }
  } else {
    // ---- the two multiplying warpgroups
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;

    // y = x + (bf16) t in the activation layout, rows past M as zeros. A
    // thread owns 16-byte pieces (8 columns of one row; a warp 8 rows x 64
    // bytes): all of them are copied asynchronously at once, then each gets
    // t added in place by the thread that copied it
    {
      const float tt = __bfloat162float(__float2bfloat16(__ldg(t)));
      const __nv_bfloat16* xc = x + ((size_t)cell * M + row0) * K;
      const int r = ((tid >> 5) << 3) + (tid & 7);
      const int c0 = ((tid >> 3) & 3) * 8;
      if (r < rows)
        for (int c = c0; c < K; c += 32)
          cp_async16(buf_k + act_offset(r, c), xc + (size_t)r * K + c);
      cp_async_wait_all();
      for (int c = c0; c < K; c += 32) {
        alignas(16) __nv_bfloat16 v[8];
        uint4* piece = reinterpret_cast<uint4*>(buf_k + act_offset(r, c));
        if (r < rows) {
          *reinterpret_cast<uint4*>(v) = *piece;
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(__bfloat162float(v[j]) + tt);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(0.f);
        }
        *piece = *reinterpret_cast<uint4*>(v);
      }
    }

    unsigned char* in = buf_k;
    unsigned char* out = buf_n;
    int kin = K, nout = N;
    int held = -1;  // the slot whose products are still in flight
    float acc[64];

    for (int link = 0; link < chain; ++link) {
      // the tile's writes (x, or the link before) reach wgmma's reads
      fence_async_proxy();
      consumer_sync();
      for (int n0 = 0; n0 < nout; n0 += kWgBN) {
        for (int k0 = 0; k0 < kin; k0 += kWgKB) {
          mbar_wait(ring.full + ring.slot, ring.parity);
          const unsigned char* ws = stages_base + (size_t)ring.slot * kWgStageBytes;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kWgKB / 16; ++ks) {
            // A: k-step ks of the tile, two column groups of 8 x 128 bytes
            const uint64_t da = wgmma_desc(in + (((k0 >> 3) + 2 * ks) << 10), 1024, 128);
            // B: the stage's k-blocks 2ks, 2ks+1 (32 x 128 bytes each), this
            // warpgroup's 16 column blocks
            const uint64_t db = wgmma_desc(ws + ((2 * ks * (kWgBN / 8) + wg * 16) << 7),
                                           (kWgBN / 8) * 128, 128);
            wgmma_m64n128k16(acc, da, db, (k0 | ks) != 0);
          }
          wgmma_commit();
          if (held >= 0) {  // one stage's products stay in flight
            wgmma_wait<1>();
            ring.release(held);
          }
          held = ring.slot;
          ring.advance();
        }
        wgmma_wait<0>();
        ring.release(held);
        held = -1;

        // (T) relu((O) acc) into the next link's operand
        const int cb = ((n0 + wg * 128) >> 3);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162 v;
            v.x = __float2bfloat16(act(acc[4 * j + 2 * h], out_bf16));
            v.y = __float2bfloat16(act(acc[4 * j + 2 * h + 1], out_bf16));
            *reinterpret_cast<__nv_bfloat162*>(
                out + (((cb + j) * 8 + 2 * warp + h) << 7) + (g << 4) + (tq << 2)) = v;
          }
      }
      unsigned char* tp = in; in = out; out = tp;
      const int ti = kin; kin = nout; nout = ti;
    }
    consumer_sync();

    // in holds the last link's (64, N) output: sum its valid rows in order
    float* pc = partial + ((size_t)cell * gridDim.x + tile) * N;
    for (int col = tid; col < N; col += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r)
        s += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(in + act_offset(r, col)));
      pc[col] = s;
    }
  }
}

int launch_wgmma(const void* t, const void* x, const void* wa, const void* wb, int C, int M,
                 int K, int N, int chain, bool out_bf16, int depth, void* partial, void* out,
                 cudaStream_t s) {
  if (depth < 2 || depth > kMaxDepth || K % kWgBN || N % kWgBN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)128 * (K + N) + (size_t)depth * kWgStageBytes;
  return launch_chain(chain_wgmma_kernel, smem, (M + 63) / 64, C, N, partial, out, s,
                      static_cast<const float*>(t), static_cast<const __nv_bfloat16*>(x),
                      static_cast<const __nv_bfloat16*>(wa),
                      static_cast<const __nv_bfloat16*>(wb), M, K, N, chain, out_bf16, depth);
}

}  // namespace

// x (C, M, K) contiguous and 16-byte aligned; wa, wb: a (K, N) and b (N, K)
// in stage order (kernels/matmul_probe.py pack_weight); all bf16 (bf16 != 0)
// or all fp32; t one fp32 on the device; K and N multiples of 64; chain odd.
// The plan of kernels/matmul_probe.py plan_probe: tm the row tile (bf16: 64
// or 32, fp32: 32 or 16), kb the k-rows of a weight stage (32 or 16), depth
// the stages of the ring. partial: C * ceil(M/tm) * N fp32 of scratch; out
// (C, 1, N) fp32. Both kernels run in order on stream.
extern "C" int msl_matmul_probe(int bf16, int out_bf16, int tm, int kb, int depth,
                                const void* t, const void* x, const void* wa, const void* wb,
                                int C, int M, int K, int N, int chain, void* partial,
                                void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 64 || N % 64 || chain % 2 == 0) return (int)cudaErrorInvalidValue;
#define MSL_PROBE_CASE(T, TM, KB)  \
  if (tm == TM && kb == KB)        \
    return launch<T, TM, KB>(t, x, wa, wb, C, M, K, N, chain, out_bf16, depth, partial, out, s);
  if (bf16) {
    MSL_PROBE_CASE(__nv_bfloat16, 64, 16)
    MSL_PROBE_CASE(__nv_bfloat16, 32, 16)
  } else {
    MSL_PROBE_CASE(float, 32, 32)
    MSL_PROBE_CASE(float, 32, 16)
    MSL_PROBE_CASE(float, 16, 16)
  }
#undef MSL_PROBE_CASE
  return (int)cudaErrorInvalidValue;
}

// The same chain on the "wgmma" route: bf16, TM 64, K and N multiples of 256;
// wa, wb in that route's stage order. partial: C * ceil(M/64) * N fp32.
extern "C" int msl_matmul_probe_wgmma(int out_bf16, int depth, const void* t, const void* x,
                                      const void* wa, const void* wb, int C, int M, int K,
                                      int N, int chain, void* partial, void* out,
                                      void* stream) {
  if (chain % 2 == 0) return (int)cudaErrorInvalidValue;
  return launch_wgmma(t, x, wa, wb, C, M, K, N, chain, out_bf16, depth, partial, out,
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* msl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
