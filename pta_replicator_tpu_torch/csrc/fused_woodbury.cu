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
// The bf16 rung (precision="bf16"; the second half of this file) has a
// kernel of its own, described there.
//
// What holds the highest kernel back (measured by kernels/woodbury_study.py;
// PERF.md): staging. Each of the P panels is staged by P blocks, so at
// Q = 123 the blocks pull twice T's bytes into shared memory, and a build
// that only stages takes about as long as the whole kernel. The products
// alone run near 60% of the DMMA rate (their fragment loads share the
// shared-memory pipe with the copies).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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
// The bf16 rung (precision="bf16", pallas_gp.py:99-112). For the Q + 1
// augmented columns A = [T | r], padded to P panels of 64, it sums
//   C[a][b] = sum_n bf16(A[n][a]) * bf16(w[n] * A[n][b])
// in float32 over every entry of the padded (64 P)-square Gram matrix:
// JAX's bf16 T^T W T is not symmetric, so nothing is mirrored. Each
// product w A is formed in the input dtype and rounded as
// x.to(torch.bfloat16) rounds (float64 through float32). d is column Q
// (rows bf16(T), column bf16(w r)); row Q is dropped. r^T W r never
// touches bf16: the thread that converts an r entry adds float(r) *
// float(w r) by FFMA beside the tensor cores.
//
// Bound. At 68 x 7,758 the rung is bound by reading T once in its input
// dtype: 0.157 ms (float64) and 0.079 ms (float32) at Q = 123, 0.367 ms
// (float64) at Q = 286, at 3.35 TB/s; the full Gram on the tensor cores,
// 2 Np Nt (Q + 1)^2 operations, takes 0.016 and 0.11 ms at 989 TFLOP/s
// (mma.sync reaches a fraction of that rate).
//
// Design. The unit of work is one (pulsar, TOA split), taken in chunks of
// kBfRows = 64 TOA rows by all Q columns: one contiguous span of T. A
// block is three warpgroups: the first issues the copies, the other two
// multiply, and all three convert, so that conversion and products run
// side by side.
// * Staging: a span goes into a ring of raw slots by 16-byte
//   cp.async.cg. Element copies remain only for its unaligned head and
//   tail (one element in float64, up to three in float32): the span
//   starts 16-byte aligned only when (p Nt + n0) Q sizeof(T) is. A slot
//   keeps the span at its own offset modulo 16, so the interior copies
//   are aligned on both sides. w and r of the chunk's rows are spans too.
//   The ring holds as many slots as shared memory allows, so that 1.5 to
//   3 chunks' bytes are in flight while one is converted.
// * Converting once: each staged (row pair, column) becomes one 32-bit
//   word of bf16(T) and one of bf16(w T), packed k pairs, stored into X
//   (the A operand: the block's row panels) and Y (the B operand: its
//   column panels). Both are [k pair][column] at a pitch of 8 (mod 32)
//   words, so the conversion's stores (a warp's lanes on consecutive
//   columns) and the fragment loads (lanes (g, t) on words (t, g)) are
//   free of bank conflicts. Rows past the split and padding columns
//   convert to zeros. X and Y are double buffered. A thread converts one
//   column of the block's (a part of its k pairs when the columns are
//   fewer than the threads) and loads kConvUnroll k pairs before it
//   converts any.
// * Reading each byte of T once per (pulsar, split): while P <= 2 (Q <=
//   127) one block owns the unit, all P^2 tiles (64 float32 accumulators
//   per multiplying thread), and stages its chunks in 32-row pieces, so
//   that three pieces (1.5 float64 chunks at Q = 123) are in flight
//   beside its bf16 buffers. For 3 <= P <= 8 a thread-block cluster of P
//   blocks owns it, block i the 64 x 64 P strip of row panel i (16 P
//   accumulators per multiplying thread): each block stages and converts a
//   1/P share of the chunk's row pairs and stores its words through
//   distributed shared memory into every block's Y and into X of the block
//   whose row panel holds the column. Past the portable cluster size (P >
//   8, Q >= 512) the unit runs as strips without a cluster: block (i,
//   group) owns row panel i against a group of 8 column panels and
//   converts its columns straight from device memory, so those blocks read
//   T's bytes about 9 ceil(P / 8) times over (no path runs such a width).
// * Pipeline: one barrier phase per chunk (the cluster's barrier when the
//   unit is a cluster). After it the first warpgroup issues the copies of
//   later pieces while the other two multiply chunk c - 1 (mma.sync
//   m16n8k16 bf16, float32 accumulators); then all three convert chunk c.
// * The tensor cores sum a chunk's kFaddSteps k16 steps from zero, and
//   FADD adds that partial to the running float32 sums, which round to
//   nearest: an accumulator carried through the tensor cores over a whole
//   split drifts (3.1e-5 of the largest entry over 7,758 rows;
//   kernels/woodbury_study.py measures each granularity).
// * With one split each block writes its entries, unmirrored, into TNT, d
//   and rnr; with several it writes its part of an (Np, split, 64 P, 64 P)
//   workspace and a second kernel adds the splits in order. No atomics:
//   every run gives the same bits.
//
// What holds it back (kernels/woodbury_study.py at 68 x 7,758, H100;
// PERF.md). At Q = 123 in float64 the kernel takes 0.34 ms against a
// 0.159 ms bound: the copies alone take 0.24 ms (about 1.5 chunks in
// flight per SM), the conversion alone 0.21 and the products alone 0.13,
// of which 0.07 is the barriers, the epilogue and the reduction; they
// overlap only in part. At Q = 286 (clusters of 5) it takes 1.85 ms
// against 0.369: the barriers, epilogue and reduction alone take 0.46 (a
// cluster barrier costs over 1 us a chunk), the conversion alone 1.15 and
// the products alone 1.00; storing the words through distributed shared
// memory costs next to nothing beside that.

constexpr int kBfRows = 64;               // TOA rows of a chunk: four k16 steps
constexpr int kBfPairs = kBfRows / 2;     // k-pair words of a column per chunk
constexpr int kWarpgroup = 128;           // threads of a warpgroup: one stages, two multiply
constexpr int kBfThreads = 3 * kWarpgroup;
constexpr int kConvUnroll = 4;            // k pairs a thread loads before converting
// a part's share of the conversion when parts are whole warpgroups: the
// staging warpgroup's weight, and a multiplying one's
constexpr int kStagerWeight = 1;
constexpr int kMultiplierWeight = 2;
constexpr int kBfMaxCluster = 8;          // the portable cluster size
constexpr int kBfGroup = 8;               // column panels of a strip (P > kBfMaxCluster)
constexpr int kBfPad = 8;                 // X / Y pitch = 8 (mod 32) words
constexpr int kBfMaxSlots = 6;            // raw slots of the staging ring, at most
constexpr int kBfSingleMax = 2;           // panels up to which one block owns the unit
constexpr int kBfPieceRows = 32;          // rows of a raw slot when one block owns the unit
constexpr int kFaddSteps = 4;             // k16 steps the tensor cores sum before FADD
constexpr long long kSmemLimit = 232448;  // shared memory one block can use (227 KB)
constexpr long long kBfScratch = 128;     // partials of r^T W r: 12 warps, 8 cluster blocks

enum BfMode { kBfSingle = 0, kBfCluster = 1, kBfStrips = 2 };

// The bf16 launch for Q columns of `size`-byte inputs, mirrored by
// ops/gp.py::woodbury_bf16_grid (which the CPU tests check).
struct BfGrid {
  int panels;            // P
  int mode;              // BfMode
  int cluster;           // blocks of a cluster (1: no cluster)
  int blocks;            // blocks of one (pulsar, split)
  int rpan, cpan;        // row / column panels one block owns (a strip's group)
  int slots;             // raw slots (0: strips convert from device memory)
  int share_rows;        // most chunk rows one block stages
  int piece_rows;        // rows of one raw slot: a piece of the block's share
  int npiece;            // pieces of the share
  long long xbuf, ybuf;  // bytes of one X / Y buffer
  long long raw, wr;     // bytes of one raw slot, of one w or r slot
  long long smem;        // dynamic shared memory of a block
};

__host__ __device__ inline long long round16(long long b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline BfGrid bf_grid(int q, int size) {
  BfGrid g{};
  g.panels = num_panels(q);
  const int P = g.panels;
  if (P <= kBfSingleMax) {
    g.mode = kBfSingle, g.cluster = 1, g.blocks = 1, g.rpan = P, g.cpan = P;
  } else if (P <= kBfMaxCluster) {
    g.mode = kBfCluster, g.cluster = P, g.blocks = P, g.rpan = 1, g.cpan = P;
  } else {
    g.mode = kBfStrips, g.cluster = 1, g.rpan = 1, g.cpan = kBfGroup;
    g.blocks = P * ((P + kBfGroup - 1) / kBfGroup);
  }
  g.xbuf = 4LL * kBfPairs * (kPanel * g.rpan + kBfPad);
  g.ybuf = 4LL * kBfPairs * (kPanel * g.cpan + kBfPad);
  const long long fixed = 2 * (g.xbuf + g.ybuf) + kBfScratch;
  if (g.mode == kBfStrips) {
    g.smem = fixed;
    return g;
  }
  g.share_rows = 2 * ((kBfPairs + g.cluster - 1) / g.cluster);
  g.piece_rows = g.mode == kBfSingle ? kBfPieceRows : g.share_rows;
  g.npiece = g.share_rows / g.piece_rows;
  g.raw = round16(static_cast<long long>(g.piece_rows) * q * size + 16);
  g.wr = round16(static_cast<long long>(g.piece_rows) * size + 16);
  g.slots = kBfMaxSlots;
  while (g.slots > 2 * g.npiece && fixed + g.slots * (g.raw + 2 * g.wr) > kSmemLimit) --g.slots;
  g.smem = fixed + g.slots * (g.raw + 2 * g.wr);
  return g;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem) : "memory");
}

// Copy `nbytes` from `src` (aligned to SIZE) to dst16 + (src mod 16), dst16
// 16-byte aligned, by the staging warpgroup (ct = 0 .. kWarpgroup - 1):
// the interior by 16-byte copies, the unaligned head and tail by SIZE-byte
// element copies, issued by the last of those threads.
template <int SIZE>
__device__ __forceinline__ void stage_span(unsigned char* dst16, const unsigned char* src,
                                           int nbytes, int ct) {
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* dst = dst16 + head;
  const int hb = head ? min(16 - head, nbytes) : 0;  // head bytes
  const int n16 = (nbytes - hb) >> 4;
  const int tb = nbytes - hb - (n16 << 4);           // tail bytes
  for (int u = ct; u < n16; u += kWarpgroup) cp_async16(dst + hb + 16 * u, src + hb + 16 * u);
  const int he = hb / SIZE, e = kWarpgroup - 1 - ct;
  if (e < he + tb / SIZE) {
    const int off = e < he ? e * SIZE : hb + 16 * n16 + (e - he) * SIZE;
    cp_async<SIZE>(dst + off, src + off, true);
  }
}

// two values rounded to bf16, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the same shared-memory address in block `rank` of the cluster
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_local(unsigned addr, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}
// every thread of the unit: the block's barrier, or the cluster's
__device__ __forceinline__ void unit_sync(int cluster) {
  if (cluster == 1) {
    __syncthreads();
    return;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Not volatile: the products depend on their operands alone, so the
// compiler may interleave independent ones.
__device__ __forceinline__ void mma_bf16_16x8x16(float (&c)[4], const unsigned (&a)[4],
                                                 const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A multiplying warp's share of the block's tile (64 rows, or 128 when one
// block owns two panels): warp mw = 0..7 (wm = mw / 4, wn = mw % 4) owns
// MT m-tiles of 16 rows from 16 MT wm against the n-tiles j = wn + 4 jj of 8 columns, so that the columns of
// any P spread evenly over the four warp columns. Word (kp, c) of X or Y
// holds rows 2 kp and 2 kp + 1 of column c. With g = lane / 4 and t =
// lane % 4, a k16 step's fragments are a = X words (t, row g), (t, g + 8),
// (t + 4, g), (t + 4, g + 8) and b = Y words (t, column g), (t + 4, g);
// c[e] is the sum at (row g + 8 (e >> 1), column 2t + (e & 1)).
template <int MT, int NT>
struct BfAcc {
  // k16 steps summed in the tensor cores before FADD (two past 40 n-tiles or
  // two m-tiles a warp, to keep the fragments within the registers)
  static constexpr int KS = (NT > 10 || MT > 2) && kFaddSteps > 2 ? 2 : kFaddSteps;
  // n-tiles multiplied together (NT is even; a block's n-tiles come in
  // panels of 8, so a warp's come in pairs)
  static constexpr int kJB = 2;
  static_assert(NT % kJB == 0, "n-tiles in pairs");
  float c[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] = 0.0f;
  }

  // One chunk from X (pitch xp words) and Y (pitch yp) for warp mw; the
  // block's tile has `ntiles` n-tiles.
  __device__ __forceinline__ void step(const unsigned* X, int xp, const unsigned* Y, int yp,
                                       int ntiles, int mw, int lane) {
    const int wm = mw >> 2, wn = mw & 3;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks0 = 0; ks0 < kBfRows / 16; ks0 += KS) {
      unsigned a[MT][KS][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const unsigned* x = X + (8 * (ks0 + s) + t) * xp + (wm * MT + m) * 16 + g;
          a[m][s][0] = x[0];
          a[m][s][1] = x[8];
          a[m][s][2] = x[4 * xp];
          a[m][s][3] = x[4 * xp + 8];
        }
      // kJB n-tiles at a time, so that MT * kJB independent products are in
      // flight between two dependent ones
#pragma unroll
      for (int jj0 = 0; jj0 < NT; jj0 += kJB) {
        if (wn + 4 * jj0 < ntiles) {
          unsigned b[kJB][KS][2];
#pragma unroll
          for (int jb = 0; jb < kJB; ++jb)
#pragma unroll
            for (int s = 0; s < KS; ++s) {
              const unsigned* y = Y + (8 * (ks0 + s) + t) * yp + 8 * (wn + 4 * (jj0 + jb)) + g;
              b[jb][s][0] = y[0];
              b[jb][s][1] = y[4 * yp];
            }
          float part[MT][kJB][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int jb = 0; jb < kJB; ++jb)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[m][jb][e] = 0.0f;
#pragma unroll
          for (int s = 0; s < KS; ++s)
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int jb = 0; jb < kJB; ++jb) mma_bf16_16x8x16(part[m][jb], a[m][s], b[jb][s]);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int jb = 0; jb < kJB; ++jb)
#pragma unroll
              for (int e = 0; e < 4; ++e) c[m][jj0 + jb][e] += part[m][jb][e];
        }
      }
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(int ntiles, int mw, int lane, F f) const {
    const int wm = mw >> 2, wn = mw & 3;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = wn + 4 * jj;
          if (j < ntiles)
            f((wm * MT + m) * 16 + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1), c[m][jj][e]);
        }
  }
};

// Entry (a, b) of pulsar p's bf16 Gram matrix into its output: T^T W T for
// a, b < q, d for column q; row q (bf16(r) rows) and padding are dropped,
// and the corner (q, q) is r^T W r.
__device__ __forceinline__ void emit_bf16(float* tnt, float* d, float* rnr, int p, int q, int a,
                                          int b, float v) {
  if (a > q || b > q || (a == q && b < q)) return;
  if (a == q) rnr[p] = v;
  else if (b < q) tnt[(static_cast<size_t>(p) * q + a) * q + b] = v;
  else d[static_cast<size_t>(p) * q + a] = v;
}

// One block of a (pulsar, split) unit: block (x, split, p), x the rank in
// the unit's cluster (kBfCluster) or the strip (kBfStrips; kDirect: the
// columns converted straight from device memory, no staging ring). NT
// n-tiles per multiplying warp cover the block's columns.
template <typename T, int MT, int NT, bool kDirect>
__global__ void __launch_bounds__(kBfThreads, 1)
woodbury_bf16_kernel(const T* __restrict__ tmat, const T* __restrict__ w,
                     const T* __restrict__ r, float* __restrict__ ws, float* __restrict__ tnt,
                     float* __restrict__ d, float* __restrict__ rnr, int nt, int q, int nsplit,
                     BfGrid g) {
  constexpr int kSize = static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned* const X = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* const Y = reinterpret_cast<unsigned*>(smem_raw + 2 * g.xbuf);
  float* const scratch = reinterpret_cast<float*>(smem_raw + 2 * (g.xbuf + g.ybuf));
  unsigned char* const ring = smem_raw + 2 * (g.xbuf + g.ybuf) + kBfScratch;
  const long long slot_bytes = g.raw + 2 * g.wr;
  const int xwords = static_cast<int>(g.xbuf / 4), ywords = static_cast<int>(g.ybuf / 4);
  const int xp = kPanel * g.rpan + kBfPad, yp = kPanel * g.cpan + kBfPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool stager = threadIdx.x < kWarpgroup;     // the staging warpgroup
  const int ct = threadIdx.x;                       // a stager's index
  const int mw = warp - kWarpgroup / 32;            // a multiplying warp's index

  const int unit = blockIdx.x, split = blockIdx.y, p = blockIdx.z;
  const int cs = g.cluster;
  const int rank = g.mode == kBfCluster ? unit : 0;
  // the block's row panel ip and first column panel jp
  const int groups = (g.panels + kBfGroup - 1) / kBfGroup;
  const int ip = g.mode == kBfStrips ? unit / groups : rank;
  const int jp = g.mode == kBfStrips ? (unit % groups) * kBfGroup : 0;
  const int cpanels = min(g.cpan, g.panels - jp);
  const int ntiles = cpanels * (kPanel / 8);
  // this block's share of each chunk's k pairs, and the columns it converts:
  // all of them, or (strips) row panel ip's, then its group's
  const int pr0 = kBfPairs * rank / cs, pr1 = kBfPairs * (rank + 1) / cs;
  const int cpan_conv = g.mode == kBfStrips ? 1 + cpanels : g.panels;
  const int ncols = kPanel * cpan_conv;
  // the conversion's work split: nparts threads share a column, each a
  // part of every piece's k pairs; or, past kBfThreads columns, a thread
  // takes every kBfThreads-th column whole
  const int nparts = max(1, kBfThreads / ncols);
  const int part = static_cast<int>(threadIdx.x) / ncols;  // >= nparts: no column
  const int col0 = static_cast<int>(threadIdx.x) % ncols;
  // parts [0, sparts) are the staging warpgroup's; cum(k) is the weight of
  // parts before k
  const int sparts = ncols <= kWarpgroup ? kWarpgroup / ncols : 0;
  auto cum = [&](int k) {
    return min(k, sparts) * kStagerWeight + max(0, k - sparts) * kMultiplierWeight;
  };

  const int span = split_rows(nt, nsplit);
  const int row0 = split * span, row1 = min(nt, row0 + span);
  const int nch = row1 > row0 ? (row1 - row0 + kBfRows - 1) / kBfRows : 0;
  const size_t prow = static_cast<size_t>(p) * nt;  // pulsar p's first row

  // the copies of piece pc (chunk pc / npiece): rows [ka, kb) of its chunk,
  // all columns, where this block's rows [2 pr0, 2 pr1) come in npiece
  // pieces of piece_rows
  auto piece_rows = [&](int pc, int& ka, int& kb) {
    const int c = pc / g.npiece, j = pc % g.npiece;
    ka = 2 * pr0 + j * g.piece_rows;
    kb = min(min(2 * pr1, ka + g.piece_rows), row1 - (row0 + c * kBfRows));
  };
  auto stage = [&](int pc) {  // by the first warpgroup
    int ka, kb;
    piece_rows(pc, ka, kb);
    if (kb <= ka) return;
    unsigned char* slot = ring + (pc % g.slots) * slot_bytes;
    const size_t e0 = prow + row0 + (pc / g.npiece) * kBfRows + ka;
    stage_span<kSize>(slot, reinterpret_cast<const unsigned char*>(tmat + e0 * q),
                      (kb - ka) * q * kSize, ct);
    stage_span<kSize>(slot + g.raw, reinterpret_cast<const unsigned char*>(w + e0),
                      (kb - ka) * kSize, ct);
    stage_span<kSize>(slot + g.raw + g.wr, reinterpret_cast<const unsigned char*>(r + e0),
                      (kb - ka) * kSize, ct);
  };

  float racc = 0.0f;
  // this thread's part of chunk c into buffer c & 1 of X and Y (of every
  // block of the cluster)
  auto convert = [&](int c) {
    if (part >= nparts) return;
    const int n0 = row0 + c * kBfRows;
    const int khi = min(2 * pr1, row1 - n0);  // rows from khi on are zeros
    auto at = [&](const T* ptr) -> T {
      if constexpr (kDirect) return __ldg(ptr);
      else return *ptr;
    };
    for (int j = 0; j < (kDirect ? 1 : g.npiece); ++j) {
      // the piece's k pairs [pa, pb), the chunk row of its staged row 0, and
      // where its T, w and r rows are
      const int pa = pr0 + j * (g.piece_rows / 2);
      const int pb = kDirect ? pr1 : min(pr1, pa + g.piece_rows / 2);
      const int kbase = 2 * pa;
      const T* tv;
      const T* wv;
      const T* rv;
      if constexpr (kDirect) {
        tv = tmat + (prow + n0) * q;
        wv = w + prow + n0;
        rv = r + prow + n0;
      } else {
        const int pc = c * g.npiece + j;
        const unsigned char* slot = ring + (pc % g.slots) * slot_bytes;
        const size_t e0 = prow + n0 + kbase;
        tv = reinterpret_cast<const T*>(slot + (reinterpret_cast<uintptr_t>(tmat + e0 * q) & 15));
        wv = reinterpret_cast<const T*>(slot + g.raw + (reinterpret_cast<uintptr_t>(w + e0) & 15));
        rv = reinterpret_cast<const T*>(slot + g.raw + g.wr +
                                        (reinterpret_cast<uintptr_t>(r + e0) & 15));
      }
      const int i0 = kDirect ? 2 * pa : 0;  // staged row of the piece's first pair
      const int qa = pa + (pb - pa) * cum(part) / cum(nparts);
      const int qb = pa + (pb - pa) * cum(part + 1) / cum(nparts);
      const int npairs = qb - qa;  // this thread's pairs [qa, qb)
      for (int col = col0; col < ncols; col += kBfThreads) {
        // the column's source: T's column tc, r, or nothing (padding)
        int tc = col, xcol = col, ycol = col;  // X's and Y's column (-1: none)
        if (kDirect) {
          tc = col < kPanel ? ip * kPanel + col : jp * kPanel + col - kPanel;
          xcol = col < kPanel ? col : -1;
          ycol = col < kPanel ? -1 : col - kPanel;
        }
        const T* src = tc < q ? tv + tc : rv;
        const int stride = tc < q ? q : 1;
        const bool live = tc <= q, rcol = tc == q && xcol >= 0;
        // destinations of k pair 0, as shared-window addresses (each word
        // of a pair kp lies kp pitches on)
        const int owner = cs == 1 ? 0 : col / kPanel;
        const unsigned xa = xcol < 0 ? 0u
            : smem_addr(X + (c & 1) * xwords + (cs == 1 ? xcol : col - owner * kPanel));
        const unsigned ya = ycol < 0 ? 0u : smem_addr(Y + (c & 1) * ywords + ycol);
        for (int kp0 = 0; kp0 < npairs; kp0 += kConvUnroll) {
          T x0[kConvUnroll], x1[kConvUnroll], w0[kConvUnroll], w1[kConvUnroll];
#pragma unroll
          for (int u = 0; u < kConvUnroll; ++u) {  // every load first
            const int k = 2 * (qa + kp0 + u), i = i0 + 2 * (qa - pa + kp0 + u);
            const bool v0 = kp0 + u < npairs && k < khi, v1 = kp0 + u < npairs && k + 1 < khi;
            w0[u] = v0 ? at(wv + i) : T(0);
            w1[u] = v1 ? at(wv + i + 1) : T(0);
            x0[u] = v0 && live ? at(src + i * stride) : T(0);
            x1[u] = v1 && live ? at(src + (i + 1) * stride) : T(0);
          }
#pragma unroll
          for (int u = 0; u < kConvUnroll; ++u) {
            if (kp0 + u >= npairs) break;
            const int kp = qa + kp0 + u;
            const T y0 = w0[u] * x0[u], y1 = w1[u] * x1[u];
            if (rcol) {
              racc = fmaf(static_cast<float>(x0[u]), static_cast<float>(y0), racc);
              racc = fmaf(static_cast<float>(x1[u]), static_cast<float>(y1), racc);
            }
            const unsigned xw = pack_bf16(static_cast<float>(x0[u]), static_cast<float>(x1[u]));
            const unsigned yw = pack_bf16(static_cast<float>(y0), static_cast<float>(y1));
            const unsigned xo = 4u * kp * xp, yo = 4u * kp * yp;
            if (cs == 1) {
              if (xcol >= 0) st_local(xa + xo, xw);
              if (ycol >= 0) st_local(ya + yo, yw);
            } else {
              st_cluster(map_rank(xa + xo, owner), xw);
#pragma unroll
              for (int m = 0; m < kBfMaxCluster; ++m)
                if (m < cs) st_cluster(map_rank(ya + yo, m), yw);
            }
          }
        }
      }
    }
  };

  BfAcc<MT, NT> acc;
  acc.zero();
  // the ring: pieces [0, slots - npiece) ahead of chunk 0; each phase c the
  // npiece pieces slots - npiece on, into the slots chunk c - 1 freed; one
  // commit group a piece
  const int ahead = g.slots - g.npiece, npieces = nch * g.npiece;
  auto issue = [&](int c) {  // phase c's pieces, into the slots chunk c - 1 freed
    if constexpr (!kDirect) {
      for (int j = 0; j < g.npiece; ++j) {
        const int pc = c * g.npiece + ahead + j;
        if (pc < npieces) stage(pc);
        cp_async_commit();
      }
    }
  };
  if constexpr (!kDirect) {
    if (stager)
      for (int pc = 0; pc < ahead; ++pc) {
        if (pc < npieces) stage(pc);
        cp_async_commit();
      }
  }
  for (int c = 0; c <= nch; ++c) {
    if constexpr (!kDirect) {
      if (stager && c < nch) {  // this thread's copies of chunk c landed
        switch (g.slots - 2 * g.npiece) {  // pieces still allowed in flight
          case 0: cp_async_wait<0>(); break;
          case 1: cp_async_wait<1>(); break;
          case 2: cp_async_wait<2>(); break;
          case 3: cp_async_wait<3>(); break;
          default: cp_async_wait<4>(); break;
        }
      }
    }
    // chunk c landed in every block of the unit; c - 1 is converted
    // everywhere; no block still reads the buffers chunk c goes into or
    // the slots its later pieces go into
    unit_sync(cs);
    if (stager) issue(c);
    else if (c > 0)
      acc.step(X + ((c - 1) & 1) * xwords, xp, Y + ((c - 1) & 1) * ywords, yp, ntiles, mw, lane);
    if (c < nch) convert(c);
  }

  // r^T W r: the warp sums, the block's, then the unit's in the corner's
  // block, each in a fixed order
  {
    float v = racc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[warp] = v;
  }
  __syncthreads();
  const int qp = q / kPanel;  // the panel of the corner (q, q)
  bool corner;
  float rsum = 0.0f;
  if (cs == 1) {
    corner = g.mode == kBfSingle || (ip == qp && qp >= jp && qp < jp + kBfGroup);
    if (threadIdx.x == 0)
      for (int i = 0; i < kBfThreads / 32; ++i) rsum += scratch[i];
  } else {
    corner = rank == qp;
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int i = 0; i < kBfThreads / 32; ++i) s += scratch[i];
      asm volatile("st.shared::cluster.f32 [%0], %1;\n"
                   :: "r"(map_rank(smem_addr(scratch + 16 + rank), qp)), "f"(s) : "memory");
    }
    unit_sync(cs);  // also keeps every block's shared memory alive until the last remote store
    if (threadIdx.x == 0 && corner)
      for (int m = 0; m < cs; ++m) rsum += scratch[16 + m];
  }

  const int a0 = ip * kPanel, b0 = jp * kPanel;
  if (nsplit == 1) {
    if (!stager)
      acc.each(ntiles, mw, lane, [&](int rl, int cl, float v) {
        const int a = a0 + rl, b = b0 + cl;
        if (a != q || b != q) emit_bf16(tnt, d, rnr, p, q, a, b, v);
      });
    if (threadIdx.x == 0 && corner) rnr[p] = rsum;
  } else {
    const int n = kPanel * g.panels;
    float* o = ws + (static_cast<size_t>(p) * nsplit + split) * n * n;
    if (!stager)
      acc.each(ntiles, mw, lane, [&](int rl, int cl, float v) {
        const int a = a0 + rl, b = b0 + cl;
        if (a != q || b != q) o[static_cast<size_t>(a) * n + b] = v;
      });
    if (threadIdx.x == 0 && corner) o[static_cast<size_t>(q) * n + q] = rsum;
  }
}

// Sum the splits of each padded Gram entry (n = 64 P) in order and scatter it.
__global__ void __launch_bounds__(kReduceThreads)
woodbury_bf16_reduce_kernel(const float* __restrict__ ws, float* __restrict__ tnt,
                            float* __restrict__ d, float* __restrict__ rnr, int q, int nsplit,
                            int n) {
  const int p = blockIdx.y;
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= n * n) return;
  const size_t plane = static_cast<size_t>(n) * n;
  const float* src = ws + static_cast<size_t>(p) * nsplit * plane + e;
  float v = 0.0f;
  for (int s = 0; s < nsplit; ++s) v += src[s * plane];
  emit_bf16(tnt, d, rnr, p, q, e / n, e % n, v);
}

template <typename T, int MT, int NT, bool kDirect>
cudaError_t launch_bf16_kernel(const BfGrid& g, dim3 grid, cudaStream_t stream, const T* tmat,
                               const T* w, const T* r, float* ws, float* tnt, float* d,
                               float* rnr, int nt, int q, int nsplit) {
  auto kernel = woodbury_bf16_kernel<T, MT, NT, kDirect>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  if (g.cluster == 1) {
    kernel<<<grid, kBfThreads, g.smem, stream>>>(tmat, w, r, ws, tnt, d, rnr, nt, q, nsplit, g);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kBfThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(g.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tmat, w, r, ws, tnt, d, rnr, nt, q, nsplit, g);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int launch_bf16(const void* tmat, const void* w, const void* r, void* ws, void* tnt, void* d,
                void* rnr, int np, int nt, int q, int nsplit, cudaStream_t stream) {
  if (np < 1 || np > 65535 || nt < 1 || q < 1 || nsplit < 1 || nsplit > nt ||
      nsplit > 65535 || (nsplit > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BfGrid g = bf_grid(q, static_cast<int>(sizeof(T)));
  if (g.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const T* tt = static_cast<const T*>(tmat);
  const T* ww = static_cast<const T*>(w);
  const T* rr = static_cast<const T*>(r);
  float* o = static_cast<float*>(ws);
  float* t = static_cast<float*>(tnt);
  float* dd = static_cast<float*>(d);
  float* c = static_cast<float*>(rnr);
  const dim3 grid(g.blocks, nsplit, np);
  // m-tiles of a multiplying warp: two per row panel of the block; n-tiles:
  // two per column panel
  cudaError_t err;
  if (g.mode == kBfStrips)
    err = launch_bf16_kernel<T, 2, 16, true>(g, grid, stream, tt, ww, rr, o, t, dd, c, nt, q, nsplit);
  else if (g.panels == 1)
    err = launch_bf16_kernel<T, 2, 2, false>(g, grid, stream, tt, ww, rr, o, t, dd, c, nt, q, nsplit);
  else if (g.panels == 2)
    err = launch_bf16_kernel<T, 4, 4, false>(g, grid, stream, tt, ww, rr, o, t, dd, c, nt, q, nsplit);
  else if (g.panels <= 5)
    err = launch_bf16_kernel<T, 2, 10, false>(g, grid, stream, tt, ww, rr, o, t, dd, c, nt, q, nsplit);
  else
    err = launch_bf16_kernel<T, 2, 16, false>(g, grid, stream, tt, ww, rr, o, t, dd, c, nt, q, nsplit);
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const int n = kPanel * g.panels;
  woodbury_bf16_reduce_kernel<<<dim3((n * n + kReduceThreads - 1) / kReduceThreads, np),
                                kReduceThreads, 0, stream>>>(o, t, dd, c, q, nsplit, n);
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

// The bf16 rung: float32 workspace entries per pulsar (the padded (64 P)-
// square Gram matrix of each split), none with one split.
extern "C" long long fused_woodbury_bf16_workspace(int q, int nsplit) {
  if (q < 1 || nsplit <= 1) return 0;
  const long long n = static_cast<long long>(kPanel) * num_panels(q);
  return n * n * nsplit;
}

// The bf16 launch for Q columns of dtype 0 (float32) or 1 (float64):
// out[0..5] = panels, mode (0 one block, 1 a cluster, 2 strips), cluster
// size, blocks of one (pulsar, split), raw slots, shared bytes of a block.
extern "C" int fused_woodbury_bf16_grid(int q, int dtype, long long* out) {
  if (q < 1 || (dtype != 0 && dtype != 1) || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const BfGrid g = bf_grid(q, dtype == 1 ? 8 : 4);
  const long long v[6] = {g.panels, g.mode, g.cluster, g.blocks, g.slots, g.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
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
