// Fused Woodbury assembly on Hopper (sm_90a).
//
// Replaces the TPU kernel pta_replicator_tpu/ops/pallas_gp.py::
// fused_woodbury_update (:160, kernel body _fused_woodbury_kernel :123,
// tile gp_tile_terms): for T (Np, Nt, Q), w and r (Np, Nt),
//
//   TNT[p] = T[p]^T diag(w[p]) T[p]   (Np, Q, Q)
//   d[p]   = T[p]^T diag(w[p]) r[p]   (Np, Q)
//   rnr[p] = r[p]^T diag(w[p]) r[p]   (Np,)
//
// in one pass over the Nt axis, accumulated in the input dtype. The
// (Np, Nt, Q) product w*T never reaches device memory. All three sums are
// the lower triangle of the Gram matrix G = A^T diag(w) A of the augmented
// columns A = [T | r] (Q + 1 of them): row Q of G holds d, its corner rnr.
//
// Bound. The work is Np*Nt*(Q(Q+1) + 4Q + 3) operations against reading
// T, w and r once and writing the outputs once. At 68 x 7,758 on the H100
// SXM (3.35 TB/s; 67 TFLOP/s, which is both the FP64 tensor-core rate and
// the FP32 rate outside the tensor cores):
//   Q = 123: 8.3e9 operations (0.124 ms) against 519 MB in float64
//            (0.160 ms, bound by bytes) or 260 MB in float32 (bound by
//            operations);
//   Q = 183: 1.8e10 operations (0.271 ms) against 780 MB in float64
//            (0.233 ms): bound by operations.
// The FP64 FMA pipe outside the tensor cores runs at half that rate, so
// float64 must use the tensor cores (DMMA) to reach either bound.
//
// Design. The output is tiled over column panels of 64 (Q + 1 padded up):
// one block owns one lower-triangle panel pair (i >= j) of one pulsar over
// one range of TOAs, and computes the 64 x 64 tile
//   C[a][b] = sum_n A[n][64 i + a] * (w[n] * A[n][64 j + b])
// on the grid (pair, TOA split, pulsar), the pair fastest, so that the
// blocks reading one pulsar's panels run together and share them in L2.
// Any Q runs: the pairs grow as ((Q + 1) / 64)^2 / 2, and the caller
// picks fewer TOA splits as they do (ops/gp.py::woodbury_plan).
// * Staging: a ring of kStages chunks of kChunk TOA rows, each holding
//   row panel i of A, column panel j of A (none on a diagonal pair, whose
//   column panel is its row panel) and w, filled by cp.async in element
//   copies that mask the ragged Nt edge, the r column and the padding
//   columns themselves (zero fill; no padded copy of T). Rows are padded to
//   kStride elements so that the fragment loads below are free of bank
//   conflicts. One barrier per chunk in float64.
// * float64: four warps each own a 32 x 32 quarter of the tile and run
//   mma.sync m16n8k8 f64 (DMMA) on fragments read straight from the staged
//   [k][column] tiles: A operand = row panel i transposed, B operand =
//   column panel j, each element scaled by its row's w as it is loaded
//   (the FP64 pipe is otherwise idle; this saves a pass over the chunk and
//   a barrier). Accumulators stay in registers. On a diagonal pair the
//   warp whose quarter is strictly upper skips its products.
// * float32: IEEE float32 has no tensor-core route (TF32 is not float32),
//   so each thread accumulates a 4 x 8 register tile with FFMA from the
//   same staged panels (three 16-byte shared loads per 32 FMAs), after a
//   pass in which each thread scales the column-panel entries it copied by
//   w, once (the FFMA pipe does the products, so w stays off it).
// * Every product is T_q * (T_s * w), the plain version's rounding
//   (ops/gp.py::gp_tile_terms); the sums run in TOA order within a split.
//   With one split the block scatters its tile into TNT (mirrored, so it
//   is exactly symmetric), d and rnr itself; with several it writes a
//   (Np, pair, split, 64, 64) workspace and a second kernel adds the
//   splits in order and scatters. No atomics: every run gives the same
//   bits. The sums run in another order than the plain version's
//   tile-sequential einsum, so kernel and plain agree to a tolerance.
//
// The bf16 rung (precision="bf16"; the second half of this file) runs
// the same staging into bf16 tensor-core tiles with float32 accumulators
// over every ordered panel pair: JAX's bf16 T^T W T is not symmetric. At
// 68 x 7,758 x 123 it is bound by bytes: reading T in its input dtype
// takes 0.157 ms in float64 and 0.079 ms in float32 at 3.35 TB/s, while
// the full Gram, 2 Np Nt (Q + 1)^2 = 1.6e10 operations, takes 0.016 ms at
// 989 TFLOP/s.
//
// What holds it back (measured by kernels/woodbury_study.py; PERF.md):
// staging. Each of the P panels is staged by P blocks, so at Q = 123 the
// blocks pull twice T's bytes into shared memory, and a build that only
// stages takes about as long as the whole kernel. The products alone run
// near 60% of the DMMA rate (their fragment loads share the shared-memory
// pipe with the copies).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kPanel = 64;              // columns of a panel; tiles are kPanel x kPanel
constexpr int kTile = kPanel * kPanel;  // workspace entries of one tile
constexpr int kThreads = 128;           // four warps
constexpr int kChunk = 16;              // TOA rows per pipeline stage
constexpr int kStride = kPanel + 4;     // padded row stride of a staged panel
constexpr int kStageElems = 2 * kChunk * kStride + kChunk;  // A panel, w A panel, w
constexpr int kCopyRows = kThreads / kPanel;                // rows one copy step covers
constexpr int kRowsPerThread = kChunk / kCopyRows;
constexpr int kMmaK = 8;                // DMMA depth: m16n8k8
constexpr int kReduceThreads = 256;

template <typename T>
struct Stages;
template <>
struct Stages<double> { static constexpr int value = 3; };  // 53 KB: four blocks per SM
template <>
struct Stages<float> { static constexpr int value = 4; };   // 35 KB: six blocks per SM

// Where w multiplies the column panel: in the DMMA B fragments for float64
// (the FP64 pipe is otherwise idle there), in a pass over the staged chunk
// for float32 (whose FFMA pipe does the products).
template <typename T>
struct ScaleInStage { static constexpr bool value = sizeof(T) == 4; };

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * static_cast<size_t>(kStageElems) * Stages<T>::value;
}

__host__ __device__ inline int num_panels(int q) { return (q + 1 + kPanel - 1) / kPanel; }
__host__ __device__ inline int num_pairs(int q) {
  const int p = num_panels(q);
  return p * (p + 1) / 2;
}
// TOA rows of each split (the last may have fewer)
__host__ __device__ inline int split_rows(int nt, int nsplit) { return (nt + nsplit - 1) / nsplit; }

// pair k -> panels (i, j), j <= i, with k = i (i + 1) / 2 + j
__device__ __forceinline__ void tri_pair(int k, int& i, int& j) {
  int b = static_cast<int>((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
  while (b * (b + 1) / 2 > k) --b;
  while ((b + 1) * (b + 2) / 2 <= k) ++b;
  i = b;
  j = k - b * (b + 1) / 2;
}

// One element from device to shared memory; zero filled when !valid (the
// source is then not read, but must still be a device address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(gmem), "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Where column c of A = [T | r] lives for pulsar p: T's column, r, or a
// padding column (never read).
template <typename T>
struct Column {
  const T* ptr;
  int stride;
  bool live;
};
template <typename T>
__device__ __forceinline__ Column<T> column(const T* tmat, const T* r, int p, int nt, int q, int c) {
  if (c < q) return {tmat + static_cast<size_t>(p) * nt * q + c, q, true};
  if (c == q) return {r + static_cast<size_t>(p) * nt, 1, true};
  return {tmat, 0, false};
}

// Stage chunk `chunk` of the TOA rows [row0, row1) into its ring slot:
// this thread's column c of row panel `ca` and of column panel `cb` (none
// on a diagonal pair, whose column panel is its row panel), rows k0,
// k0 + kCopyRows, ..., and w. Rows past row1 and padding columns are
// zero filled, so no padded copy of T exists.
template <typename T, int kStages>
__device__ __forceinline__ void stage_chunk(T* smem, int chunk, int row0, int row1,
                                            const Column<T>& ca, const Column<T>& cb, bool diag,
                                            const T* tmat, const T* w, const T* wp, int c,
                                            int k0) {
  constexpr int kBytes = static_cast<int>(sizeof(T));
  T* As = smem + (chunk % kStages) * kStageElems;
  T* Bs = As + kChunk * kStride;
  T* Ws = Bs + kChunk * kStride;
  const int n0 = row0 + chunk * kChunk;
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int k = k0 + kCopyRows * m, n = n0 + k;
    const bool in = n < row1;
    cp_async<kBytes>(As + k * kStride + c,
                     in && ca.live ? ca.ptr + static_cast<size_t>(n) * ca.stride : tmat,
                     in && ca.live);
    if (!diag)
      cp_async<kBytes>(Bs + k * kStride + c,
                       in && cb.live ? cb.ptr + static_cast<size_t>(n) * cb.stride : tmat,
                       in && cb.live);
  }
  if (threadIdx.x < kChunk) {
    const int n = n0 + threadIdx.x;
    cp_async<kBytes>(Ws + threadIdx.x, n < row1 ? wp + n : w, n < row1);
  }
}

// Entry (a, b), b <= a <= q, of pulsar p's Gram matrix into its output:
// TNT (both halves), d (row q) or rnr (the corner).
template <typename T>
__device__ __forceinline__ void scatter(T* tnt, T* d, T* rnr, int p, int q, int a, int b, T v) {
  if (a < q) {
    tnt[(static_cast<size_t>(p) * q + a) * q + b] = v;
    tnt[(static_cast<size_t>(p) * q + b) * q + a] = v;
  } else if (b < q) {
    d[static_cast<size_t>(p) * q + b] = v;
  } else {
    rnr[p] = v;
  }
}

// Entry (al, bl) of pair (pi, pj)'s tile: scattered when it lies in the
// lower triangle of the (q + 1)-square Gram matrix, dropped otherwise.
template <typename T>
__device__ __forceinline__ void emit(T* tnt, T* d, T* rnr, int p, int q, int pi, int pj, int al,
                                     int bl, T v) {
  if (pi == pj && bl > al) return;
  const int a = pi * kPanel + al;
  if (a > q) return;
  scatter(tnt, d, rnr, p, q, a, pj * kPanel + bl, v);
}

__device__ __forceinline__ void dmma_16x8x8(double (&c)[4], const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// float64: a warp's 32 x 32 quarter as 2 x 4 DMMA tiles of 16 x 8. With
// g = lane / 4, t = lane % 4, fragment element a[2j + h] is the A operand's
// (row g + 8h, k t + 4j), b[j] the B operand's (k t + 4j, column g), and
// c[2h + i] the sum at (row g + 8h, column 2t + i). A staged row stride of
// 68 = 4 (mod 16) eight-byte words puts the 16 lanes of each half warp on
// 16 distinct bank pairs.
struct AccF64 {
  double c[2][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] = 0.0;
  }

  // Bs is the unscaled column panel: each B fragment element is scaled by
  // its row's w as it is loaded, T_s * w, before the product with T_q.
  __device__ __forceinline__ void step(const double* As, const double* Bs, const double* Ws,
                                       bool diag) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    if (diag && wn > wm) return;  // a strictly upper quarter
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += kMmaK) {
      double a[2][4], b[4][2];
#pragma unroll
      for (int j = 0; j < kMmaK / 4; ++j) {
        const int k = k0 + t + 4 * j;
        const double* ar = As + k * kStride + wm + g;
        const double* br = Bs + k * kStride + wn + g;
        const double wk = Ws[k];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][2 * j] = ar[m * 16];
          a[m][2 * j + 1] = ar[m * 16 + 8];
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) b[n][j] = br[n * 8] * wk;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) dmma_16x8x8(c[m][n], a[m], b[n]);
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(wm + m * 16 + g + 8 * (e >> 1), wn + n * 8 + 2 * t + (e & 1), c[m][n][e]);
  }
};

// float32: thread (ty, tx) = (tid / 8, tid % 8) owns rows 4 ty .. 4 ty + 3
// and columns 4 tx .. 4 tx + 3 and 32 + 4 tx .. 32 + 4 tx + 3, so each
// quarter warp reads one broadcast float4 of A and two contiguous 128-byte
// runs of B per row.
struct AccF32 {
  float c[4][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.0f;
  }

  // Bs is the column panel already scaled by w.
  __device__ __forceinline__ void step(const float* As, const float* Bs, const float*, bool) {
    const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * kStride + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kStride + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * kStride + 32 + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) f(4 * ty + i, (j < 4 ? 0 : 28) + 4 * tx + j, c[i][j]);
  }
};

template <typename T>
struct AccFor;
template <>
struct AccFor<double> { using type = AccF64; };
template <>
struct AccFor<float> { using type = AccF32; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
woodbury_tile_kernel(const T* __restrict__ tmat, const T* __restrict__ w,
                     const T* __restrict__ r, T* __restrict__ ws, T* __restrict__ tnt,
                     T* __restrict__ d, T* __restrict__ rnr, int nt, int q, int nsplit) {
  constexpr int kStages = Stages<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int pair = blockIdx.x, split = blockIdx.y, p = blockIdx.z;
  int pi, pj;
  tri_pair(pair, pi, pj);
  const bool diag = pi == pj;
  const int rows = split_rows(nt, nsplit);
  const int row0 = split * rows;
  const int row1 = min(nt, row0 + rows);
  const int nchunks = row1 > row0 ? (row1 - row0 + kChunk - 1) / kChunk : 0;

  // each thread copies one column c of each panel, rows k0, k0 + kCopyRows, ...
  const int c = threadIdx.x % kPanel, k0 = threadIdx.x / kPanel;
  const Column<T> ca = column(tmat, r, p, nt, q, pi * kPanel + c);
  const Column<T> cb = column(tmat, r, p, nt, q, pj * kPanel + c);
  const T* wp = w + static_cast<size_t>(p) * nt;

  typename AccFor<T>::type acc;
  acc.zero();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) stage_chunk<T, kStages>(smem, s, row0, row1, ca, cb, diag, tmat, w, wp, c, k0);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `chunk` landed
    __syncthreads();  // everyone's landed; everyone is done with chunk - 1's slot
    if (chunk + kStages - 1 < nchunks)
      stage_chunk<T, kStages>(smem, chunk + kStages - 1, row0, row1, ca, cb, diag, tmat, w, wp,
                              c, k0);
    cp_async_commit();
    T* As = smem + (chunk % kStages) * kStageElems;
    T* Bs = As + kChunk * kStride;
    const T* Ws = Bs + kChunk * kStride;
    if constexpr (ScaleInStage<T>::value) {
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {  // w A, once per entry
        const int e = (k0 + kCopyRows * m) * kStride + c;
        Bs[e] = (diag ? As[e] : Bs[e]) * Ws[k0 + kCopyRows * m];
      }
      __syncthreads();
      acc.step(As, Bs, Ws, diag);
    } else {
      acc.step(As, diag ? As : Bs, Ws, diag);
    }
  }

  if (nsplit == 1) {
    acc.each([&](int al, int bl, T v) { emit(tnt, d, rnr, p, q, pi, pj, al, bl, v); });
  } else {
    T* o = ws + ((static_cast<size_t>(p) * gridDim.x + pair) * nsplit + split) * kTile;
    acc.each([&](int al, int bl, T v) { o[al * kPanel + bl] = v; });
  }
}

// Sum the splits of each tile entry in order and scatter it. Every output
// entry is written once (TNT's mirrored diagonal twice, with one value).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
woodbury_reduce_kernel(const T* __restrict__ ws, T* __restrict__ tnt, T* __restrict__ d,
                       T* __restrict__ rnr, int q, int nsplit, int npairs) {
  const int p = blockIdx.y;
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= npairs * kTile) return;
  const int pair = e / kTile, loc = e % kTile;
  int pi, pj;
  tri_pair(pair, pi, pj);
  const T* src = ws + (static_cast<size_t>(p) * npairs + pair) * nsplit * kTile + loc;
  T v = T(0);
  for (int s = 0; s < nsplit; ++s) v += src[static_cast<size_t>(s) * kTile];
  emit(tnt, d, rnr, p, q, pi, pj, loc / kPanel, loc % kPanel, v);
}

template <typename T>
int launch(const void* tmat, const void* w, const void* r, void* ws, void* tnt, void* d,
           void* rnr, int np, int nt, int q, int nsplit, cudaStream_t stream) {
  if (np < 1 || np > 65535 || nt < 1 || q < 1 || nsplit < 1 || nsplit > nt ||
      nsplit > 65535 || (nsplit > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int npairs = num_pairs(q);
  const size_t smem = smem_bytes<T>();
  auto kernel = woodbury_tile_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  T* o = static_cast<T*>(ws);
  T* t = static_cast<T*>(tnt);
  T* dd = static_cast<T*>(d);
  T* c = static_cast<T*>(rnr);
  kernel<<<dim3(npairs, nsplit, np), kThreads, smem, stream>>>(
      static_cast<const T*>(tmat), static_cast<const T*>(w), static_cast<const T*>(r), o, t, dd,
      c, nt, q, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const int entries = npairs * kTile;
  woodbury_reduce_kernel<T><<<dim3((entries + kReduceThreads - 1) / kReduceThreads, np),
                              kReduceThreads, 0, stream>>>(o, t, dd, c, q, nsplit, npairs);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------- bf16
//
// The bf16 rung (precision="bf16", pallas_gp.py:99-112): the same staged
// chunks, converted after they land into bf16 operand tiles that the
// tensor cores multiply with float32 accumulators (mma.sync m16n8k16).
// JAX's bf16 T^T W T is not symmetric, so the grid runs every ordered
// panel pair (i, j) and writes its tile unmirrored:
//   C[a][b] = sum_n bf16(A[n][64 i + a]) * bf16(w[n] * A[n][64 j + b]),
// each product w * A formed in the input dtype and rounded as
// x.to(torch.bfloat16) rounds (float64 through float32). d is column Q
// (rows bf16(T), column bf16(w r)); row Q (bf16(r) against w T) is
// dropped. r^T W r never touches bf16: the thread that stages the r
// column sums float(r) * float(w r) with FFMA beside the tensor cores.
// Outputs and the split workspace are float32; the splits are added in
// order, with no atomics, so every run gives the same bits.

constexpr int kBfStride = kChunk + 8;  // bf16 tile row: 12 words, conflict-free fragment loads
constexpr int kBfTile = kPanel * kBfStride;

__device__ __forceinline__ unsigned short to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// float64 rounds through float32, as PyTorch's cast to bfloat16 does
__device__ __forceinline__ unsigned short to_bf16(double x) {
  return to_bf16(static_cast<float>(x));
}

template <typename T>
constexpr size_t smem_bytes_bf16() {
  return smem_bytes<T>() + 2 * kBfTile * sizeof(unsigned short) + 16;
}

__device__ __forceinline__ void mma_bf16_16x8x16(float (&c)[4], const unsigned (&a)[4],
                                                 const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's 32 x 32 quarter of the 64 x 64 tile as 2 x 4 MMA tiles of
// 16 x 8, one k16 step per staged chunk. The bf16 tiles are [column][k]
// with k contiguous: the A operand (row panel, "row") and the B operand
// (scaled column panel, "col") both read two k in one 32-bit word. With
// g = lane / 4 and t = lane % 4, a[h] holds (row g + 8 (h & 1), k 2t + 8
// (h >> 1)) and its k + 1, b[h] (k 2t + 8h and k + 1, column g), c[e] the
// sum at (row g + 8 (e >> 1), column 2t + (e & 1)).
struct AccBf16 {
  float c[2][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] = 0.0f;
  }

  __device__ __forceinline__ void step(const unsigned short* A16, const unsigned short* B16) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, t = lane & 3;
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        a[m][h] = *reinterpret_cast<const unsigned*>(
            A16 + (wm + 16 * m + g + 8 * (h & 1)) * kBfStride + 2 * t + 8 * (h >> 1));
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b[n][h] = *reinterpret_cast<const unsigned*>(B16 + (wn + 8 * n + g) * kBfStride + 2 * t + 8 * h);
    // each chunk's 16 products start from zero in the tensor core and are
    // added to the running sums by FADD, which rounds to nearest: an
    // accumulator carried through the tensor cores across all chunks
    // drifts (its additions do not round to nearest), by 3e-5 of the
    // largest entry over 485 chunks
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16_16x8x16(part, a[m], b[n]);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] += part[e];
      }
  }

  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(wm + m * 16 + g + 8 * (e >> 1), wn + n * 8 + 2 * t + (e & 1), c[m][n][e]);
  }
};

// Entry (a, b) of pulsar p's bf16 Gram matrix into its output: T^T W T for
// a, b < q, d for column q; row q (bf16(r) rows) and padding are dropped,
// and the corner (q, q) is r^T W r, summed beside the tensor cores.
__device__ __forceinline__ void emit_bf16(float* tnt, float* d, float* rnr, int p, int q, int a,
                                          int b, float v) {
  if (a > q || b > q || (a == q && b < q)) return;
  if (a == q) rnr[p] = v;
  else if (b < q) tnt[(static_cast<size_t>(p) * q + a) * q + b] = v;
  else d[static_cast<size_t>(p) * q + a] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
woodbury_bf16_kernel(const T* __restrict__ tmat, const T* __restrict__ w,
                     const T* __restrict__ r, float* __restrict__ ws, float* __restrict__ tnt,
                     float* __restrict__ d, float* __restrict__ rnr, int nt, int q, int nsplit) {
  constexpr int kStages = Stages<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  unsigned short* A16 = reinterpret_cast<unsigned short*>(
      smem_raw + sizeof(T) * static_cast<size_t>(kStageElems) * kStages);  // after the ring
  unsigned short* B16 = A16 + kBfTile;
  float* rnr_half = reinterpret_cast<float*>(B16 + kBfTile);
  const int panels = num_panels(q);
  const int pair = blockIdx.x, split = blockIdx.y, p = blockIdx.z;
  const int pi = pair / panels, pj = pair % panels;
  const bool diag = pi == pj;
  const int rows = split_rows(nt, nsplit);
  const int row0 = split * rows;
  const int row1 = min(nt, row0 + rows);
  const int nchunks = row1 > row0 ? (row1 - row0 + kChunk - 1) / kChunk : 0;

  const int c = threadIdx.x % kPanel, k0 = threadIdx.x / kPanel;
  const Column<T> ca = column(tmat, r, p, nt, q, pi * kPanel + c);
  const Column<T> cb = column(tmat, r, p, nt, q, pj * kPanel + c);
  const T* wp = w + static_cast<size_t>(p) * nt;
  // the r column's panel and column; its diagonal pair sums r^T W r
  const int rq = q / kPanel, rc = q % kPanel;
  const bool rnr_pair = diag && pi == rq;
  const bool rnr_thread = rnr_pair && c == rc;
  float racc = 0.0f;

  AccBf16 acc;
  acc.zero();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) stage_chunk<T, kStages>(smem, s, row0, row1, ca, cb, diag, tmat, w, wp, c, k0);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `chunk` landed
    __syncthreads();  // everyone's landed; everyone is done with chunk - 1's slot and tiles
    if (chunk + kStages - 1 < nchunks)
      stage_chunk<T, kStages>(smem, chunk + kStages - 1, row0, row1, ca, cb, diag, tmat, w, wp,
                              c, k0);
    cp_async_commit();
    const T* As = smem + (chunk % kStages) * kStageElems;
    const T* Bs = diag ? As : As + kChunk * kStride;
    const T* Ws = As + 2 * kChunk * kStride;
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {  // the entries this thread staged
      const int k = k0 + kCopyRows * m;
      const T a = As[k * kStride + c], wk = Ws[k];
      A16[c * kBfStride + k] = to_bf16(a);
      B16[c * kBfStride + k] = to_bf16(Bs[k * kStride + c] * wk);
      if (rnr_thread) racc = fmaf(static_cast<float>(a), static_cast<float>(wk * a), racc);
    }
    __syncthreads();
    acc.step(A16, B16);
  }

  // the two threads staging the r column hold its even and odd rows
  if (rnr_thread && k0 == 1) *rnr_half = racc;
  __syncthreads();
  const float rnr_sum = rnr_thread && k0 == 0 ? racc + *rnr_half : 0.0f;
  if (nsplit == 1) {
    acc.each([&](int al, int bl, float v) {
      const int a = pi * kPanel + al, b = pj * kPanel + bl;
      if (a != q || b != q) emit_bf16(tnt, d, rnr, p, q, a, b, v);
    });
    if (rnr_thread && k0 == 0) rnr[p] = rnr_sum;
  } else {
    float* o = ws + ((static_cast<size_t>(p) * gridDim.x + pair) * nsplit + split) * kTile;
    acc.each([&](int al, int bl, float v) {
      if (!rnr_pair || al != rc || bl != rc) o[al * kPanel + bl] = v;
    });
    if (rnr_thread && k0 == 0) o[rc * kPanel + rc] = rnr_sum;
  }
}

// Sum the splits of each bf16 tile entry in order and scatter it.
__global__ void __launch_bounds__(kReduceThreads)
woodbury_bf16_reduce_kernel(const float* __restrict__ ws, float* __restrict__ tnt,
                            float* __restrict__ d, float* __restrict__ rnr, int q, int nsplit,
                            int panels) {
  const int p = blockIdx.y, npairs = panels * panels;
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= npairs * kTile) return;
  const int pair = e / kTile, loc = e % kTile;
  const float* src = ws + (static_cast<size_t>(p) * npairs + pair) * nsplit * kTile + loc;
  float v = 0.0f;
  for (int s = 0; s < nsplit; ++s) v += src[static_cast<size_t>(s) * kTile];
  emit_bf16(tnt, d, rnr, p, q, (pair / panels) * kPanel + loc / kPanel,
            (pair % panels) * kPanel + loc % kPanel, v);
}

template <typename T>
int launch_bf16(const void* tmat, const void* w, const void* r, void* ws, void* tnt, void* d,
                void* rnr, int np, int nt, int q, int nsplit, cudaStream_t stream) {
  if (np < 1 || np > 65535 || nt < 1 || q < 1 || nsplit < 1 || nsplit > nt ||
      nsplit > 65535 || (nsplit > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int panels = num_panels(q);
  const size_t smem = smem_bytes_bf16<T>();
  auto kernel = woodbury_bf16_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* o = static_cast<float*>(ws);
  float* t = static_cast<float*>(tnt);
  float* dd = static_cast<float*>(d);
  float* c = static_cast<float*>(rnr);
  kernel<<<dim3(panels * panels, nsplit, np), kThreads, smem, stream>>>(
      static_cast<const T*>(tmat), static_cast<const T*>(w), static_cast<const T*>(r), o, t, dd,
      c, nt, q, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const int entries = panels * panels * kTile;
  woodbury_bf16_reduce_kernel<<<dim3((entries + kReduceThreads - 1) / kReduceThreads, np),
                                kReduceThreads, 0, stream>>>(o, t, dd, c, q, nsplit, panels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entries of the partial-sum workspace per pulsar for Q columns split
// over `nsplit` TOA ranges: none with one split.
extern "C" long long fused_woodbury_workspace(int q, int nsplit) {
  if (q < 1 || nsplit <= 1) return 0;
  return static_cast<long long>(num_pairs(q)) * nsplit * kTile;
}

// Launch on `stream` (NULL: the default stream). dtype 0 is float32, 1
// float64; `ws` holds np * fused_woodbury_workspace(q, nsplit) entries.
// Returns the first launch's cudaError_t; 0 means launched.
extern "C" int fused_woodbury_launch(const void* tmat, const void* w, const void* r, void* ws,
                                     void* tnt, void* d, void* rnr, int np, int nt, int q,
                                     int nsplit, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(tmat, w, r, ws, tnt, d, rnr, np, nt, q, nsplit, s);
  if (dtype == 1) return launch<double>(tmat, w, r, ws, tnt, d, rnr, np, nt, q, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 rung: float32 workspace entries per pulsar (every ordered
// panel pair), none with one split.
extern "C" long long fused_woodbury_bf16_workspace(int q, int nsplit) {
  if (q < 1 || nsplit <= 1) return 0;
  return static_cast<long long>(num_panels(q)) * num_panels(q) * nsplit * kTile;
}

// Launch the bf16 rung on `stream`: T, w and r in float32 (dtype 0) or
// float64 (1); the workspace and the outputs are float32.
extern "C" int fused_woodbury_bf16_launch(const void* tmat, const void* w, const void* r, void* ws,
                                          void* tnt, void* d, void* rnr, int np, int nt, int q,
                                          int nsplit, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bf16<float>(tmat, w, r, ws, tnt, d, rnr, np, nt, q, nsplit, s);
  if (dtype == 1) return launch_bf16<double>(tmat, w, r, ws, tnt, d, rnr, np, nt, q, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fused_woodbury_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
