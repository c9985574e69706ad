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
// ms in bf16, 2.92 ms in fp32.
//
// Design (the fused bottleneck's structure without its halo, dilation and
// masks: a row tile resident in shared memory, the weights streamed from L2):
// - On the TPU one grid cell holds all M x K of its activations in VMEM.
//   Here a cell's activations are 3.5 MB in bf16, so a block owns TM rows of
//   one cell instead (the chain is row-local) and keeps them in shared memory
//   through the whole chain: a TM x K buffer and a TM x N buffer, each link
//   reading one and writing the other. bf16 takes TM 64 (K 1024) or 32
//   (K 2048); fp32 TM 32 or 16 (kernels/matmul_probe.py plan_rows). The grid
//   is (ceil(M/TM), C): 27 x 72 blocks at the defaults.
// - The weights stream from L2 in stages of 16 k-rows by BN columns, double
//   buffered with cp.async, the next stage's copy in flight while the
//   current one is multiplied.
// - bf16: 8 warps, each a 32 x 64 output tile as 2 x 8 mma.sync m16n8k16
//   (bf16 in, fp32 accumulators). A fragments are 32-bit shared loads from
//   the row-major activations; B fragments come by ldmatrix.trans from the
//   row-major weight stage. Shared rows are padded by 16 bytes, so neither
//   the fragment loads nor the epilogue's stores conflict on banks.
// - fp32: 8 warps; a thread owns a 4-row x 8-column register tile (32 fp32
//   accumulators, FMA on the CUDA cores, the bottleneck's inner loop). All
//   lanes of a warp share their 4 rows, so the activation operand is a
//   broadcast float4 read; the weight operand is two float4 reads, each
//   quarter warp on 128 contiguous bytes.
// - Each link's epilogue applies the casts and the ReLU in the reference's
//   order and writes the next link's operand to shared memory in T.
// - Ragged M: rows past M load as zeros and are left out of the row sum.
// - Deterministic row sum, no atomics: each block sums its rows in order into
//   one partial per (cell, row tile, column); a second kernel, one thread per
//   (cell, column), sums the row tiles' partials in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 16;         // k rows per weight stage
constexpr int kPadBytes = 16;   // padding at the end of every shared row

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__host__ __device__ constexpr int pad_elems() {
  return kPadBytes / static_cast<int>(sizeof(T));
}

// Output columns one block computes per pass: bf16 warps are 32 x 64 tiles,
// fp32 warps cover 4 rows x 256 columns.
template <typename T, int TM>
__host__ __device__ constexpr int block_cols() {
  return sizeof(T) == 2 ? 64 * (kWarps / (TM / 32)) : 256 * (kWarps / (TM / 4));
}

// Copy the weight stage W[k0 : k0+kBK, n0 : n0+BN) (row-major, ld = nout)
// into ws (ld = BN + pad); columns at or past nout are left alone.
template <typename T, int BN>
__device__ __forceinline__ void stage_weights(T* ws, const T* __restrict__ w,
                                              int nout, int n0, int k0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = BN / kVec;
  constexpr int ld = BN + pad_elems<T>();
  for (int i = threadIdx.x; i < kBK * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int col = (i % kPerRow) * kVec;
    if (n0 + col < nout)
      cp_async16(ws + r * ld + col, w + (size_t)(k0 + r) * nout + n0 + col);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// One bf16 link: out[TM, nout] = act(in[TM, kin] @ w[kin, nout]), in T.
template <int TM>
__device__ void link_bf16(const __nv_bfloat16* in, int ldin, int kin,
                          const __nv_bfloat16* __restrict__ w, int nout,
                          __nv_bfloat16* out, int ldout, __nv_bfloat16* ws,
                          bool out_bf16) {
  constexpr int kWarpsM = TM / 32;
  constexpr int kWarpsN = kWarps / kWarpsM;
  constexpr int BN = 64 * kWarpsN;
  constexpr int ldw = BN + pad_elems<__nv_bfloat16>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, tq = lane & 3;

  for (int n0 = 0; n0 < nout; n0 += BN) {
    const bool active = n0 + wn * 64 < nout;  // the same for the whole warp
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

    stage_weights<__nv_bfloat16, BN>(ws, w, nout, n0, 0);
    cp_async_commit();
    int s = 0;
    for (int k0 = 0; k0 < kin; k0 += kBK, s ^= 1) {
      if (k0 + kBK < kin)
        stage_weights<__nv_bfloat16, BN>(ws + (s ^ 1) * kBK * ldw, w, nout, n0, k0 + kBK);
      cp_async_commit();
      cp_async_wait<1>();  // stage k0 has landed (this thread's copies)
      __syncthreads();     // ... and everyone's
      if (active) {
        const __nv_bfloat16* wsk = ws + s * kBK * ldw;
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* p = in + (wm * 32 + mi * 16 + g) * ldin + k0 + 2 * tq;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ldin);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ldin + 8);
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          // matrices: k 0-7 / 8-15 of n-tile 2nj, then of n-tile 2nj+1
          const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
          const int ncol = wn * 64 + nj * 16 + (lane >> 4) * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(b, wsk + krow * ldw + ncol);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
          }
        }
      }
      __syncthreads();  // stage s is read; the next iteration refills it
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
template <int TM>
__device__ void link_f32(const float* in, int ldin, int kin, const float* __restrict__ w,
                         int nout, float* out, int ldout, float* ws, bool out_bf16) {
  constexpr int kGroups = TM / 4;              // 4-row groups, one per warp set
  constexpr int kWarpsPerGroup = kWarps / kGroups;
  constexpr int BN = 256 * kWarpsPerGroup;
  constexpr int ldw = BN + pad_elems<float>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / kWarpsPerGroup) * 4;
  const int cb = (warp % kWarpsPerGroup) * 256 + 4 * lane;  // and cb + 128

  for (int n0 = 0; n0 < nout; n0 += BN) {
    const bool c0 = n0 + cb < nout, c1 = n0 + cb + 128 < nout;
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

    stage_weights<float, BN>(ws, w, nout, n0, 0);
    cp_async_commit();
    int s = 0;
    for (int k0 = 0; k0 < kin; k0 += kBK, s ^= 1) {
      if (k0 + kBK < kin) stage_weights<float, BN>(ws + (s ^ 1) * kBK * ldw, w, nout, n0, k0 + kBK);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (c0) {  // c1 implies c0; columns past nout read a stale stage, unused
        const float* wsk = ws + s * kBK * ldw;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 4) {
          float4 av[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            av[r] = *reinterpret_cast<const float4*>(in + (r0 + r) * ldin + k0 + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 b0 = *reinterpret_cast<const float4*>(wsk + (kk + j) * ldw + cb);
            const float4 b1 = *reinterpret_cast<const float4*>(wsk + (kk + j) * ldw + cb + 128);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float a = j == 0 ? av[r].x : j == 1 ? av[r].y : j == 2 ? av[r].z : av[r].w;
              acc[r][0] = fmaf(a, b0.x, acc[r][0]);
              acc[r][1] = fmaf(a, b0.y, acc[r][1]);
              acc[r][2] = fmaf(a, b0.z, acc[r][2]);
              acc[r][3] = fmaf(a, b0.w, acc[r][3]);
              acc[r][4] = fmaf(a, b1.x, acc[r][4]);
              acc[r][5] = fmaf(a, b1.y, acc[r][5]);
              acc[r][6] = fmaf(a, b1.z, acc[r][6]);
              acc[r][7] = fmaf(a, b1.w, acc[r][7]);
            }
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* o = out + (r0 + r) * ldout + n0 + cb;
      if (c0)
        *reinterpret_cast<float4*>(o) =
            make_float4(act(acc[r][0], out_bf16), act(acc[r][1], out_bf16),
                        act(acc[r][2], out_bf16), act(acc[r][3], out_bf16));
      if (c1)
        *reinterpret_cast<float4*>(o + 128) =
            make_float4(act(acc[r][4], out_bf16), act(acc[r][5], out_bf16),
                        act(acc[r][6], out_bf16), act(acc[r][7], out_bf16));
    }
  }
}

template <typename T, int TM>
__device__ __forceinline__ void link(const T* in, int ldin, int kin, const T* w, int nout,
                                     T* out, int ldout, T* ws, bool out_bf16) {
  if constexpr (sizeof(T) == 2)
    link_bf16<TM>(in, ldin, kin, w, nout, out, ldout, ws, out_bf16);
  else
    link_f32<TM>(in, ldin, kin, w, nout, out, ldout, ws, out_bf16);
}

// grid (row tiles, C). partial: (C, tiles, N) fp32.
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads, 1)
    chain_kernel(const float* __restrict__ t, const T* __restrict__ x,
                 const T* __restrict__ a, const T* __restrict__ b, int M, int K, int N,
                 int chain, bool out_bf16, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int pad = pad_elems<T>();
  const int ldk = K + pad, ldn = N + pad;
  T* buf_k = reinterpret_cast<T*>(smem_raw);
  T* buf_n = buf_k + TM * ldk;
  T* ws = buf_n + TM * ldn;

  const int tile = blockIdx.x, cell = blockIdx.y;
  const int row0 = tile * TM;
  const int rows = min(TM, M - row0);

  // y = x + (T) t, rows past M as zeros
  const float tt = Elem<T>::to_float(Elem<T>::from_float(__ldg(t)));
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = K / kVec;
  const T* xc = x + ((size_t)cell * M + row0) * K;
  for (int i = threadIdx.x; i < TM * per_row; i += kThreads) {
    const int r = i / per_row, col = (i % per_row) * kVec;
    alignas(16) T v[kVec];
    if (r < rows) {
      *reinterpret_cast<uint4*>(v) =
          __ldg(reinterpret_cast<const uint4*>(xc + (size_t)r * K + col));
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[j] = Elem<T>::from_float(Elem<T>::to_float(v[j]) + tt);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = Elem<T>::from_float(0.f);
    }
    *reinterpret_cast<uint4*>(buf_k + r * ldk + col) = *reinterpret_cast<uint4*>(v);
  }
  __syncthreads();

  T* in = buf_k;
  T* out = buf_n;
  int ldin = ldk, ldout = ldn, kin = K, nout = N;
  for (int i = 0; i < chain; ++i) {
    link<T, TM>(in, ldin, kin, (i & 1) ? b : a, nout, out, ldout, ws, out_bf16);
    __syncthreads();
    T* tp = in; in = out; out = tp;
    int ti = ldin; ldin = ldout; ldout = ti;
    ti = kin; kin = nout; nout = ti;
  }

  // in holds the last link's (TM, N) output: sum its valid rows in order
  float* pc = partial + ((size_t)cell * gridDim.x + tile) * N;
  for (int col = threadIdx.x; col < N; col += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += Elem<T>::to_float(in[r * ldin + col]);
    pc[col] = s;
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

template <typename T, int TM>
size_t smem_bytes(int K, int N) {
  constexpr int pad = pad_elems<T>();
  return sizeof(T) * ((size_t)TM * (K + pad) + (size_t)TM * (N + pad) +
                      2 * (size_t)kBK * (block_cols<T, TM>() + pad));
}

template <typename T, int TM>
int launch(const void* t, const void* x, const void* a, const void* b, int C, int M,
           int K, int N, int chain, bool out_bf16, void* partial, void* out,
           cudaStream_t s) {
  const size_t smem = smem_bytes<T, TM>(K, N);
  cudaError_t e = cudaFuncSetAttribute(chain_kernel<T, TM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return (int)e;
  const int tiles = (M + TM - 1) / TM;
  chain_kernel<T, TM><<<dim3(tiles, C), kThreads, smem, s>>>(
      static_cast<const float*>(t), static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), M, K, N, chain, out_bf16, static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_tiles_kernel<<<(C * N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), C, tiles, N, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// x (C, M, K), a (K, N), b (N, K) contiguous, all bf16 (bf16 != 0) or all
// fp32; t one fp32 on the device; K and N multiples of 64; chain odd; tm the
// row tile (bf16: 64 or 32, fp32: 32 or 16). partial: C * ceil(M/tm) * N
// fp32 of scratch; out (C, 1, N) fp32. Both kernels run in order on stream.
extern "C" int msl_matmul_probe(int bf16, int out_bf16, int tm, const void* t,
                                const void* x, const void* a, const void* b, int C,
                                int M, int K, int N, int chain, void* partial,
                                void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 64 || N % 64 || chain % 2 == 0) return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (tm == 64)
      return launch<__nv_bfloat16, 64>(t, x, a, b, C, M, K, N, chain, out_bf16, partial, out, s);
    if (tm == 32)
      return launch<__nv_bfloat16, 32>(t, x, a, b, C, M, K, N, chain, out_bf16, partial, out, s);
  } else {
    if (tm == 32)
      return launch<float, 32>(t, x, a, b, C, M, K, N, chain, out_bf16, partial, out, s);
    if (tm == 16)
      return launch<float, 16>(t, x, a, b, C, M, K, N, chain, out_bf16, partial, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* msl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
