// Blocked-Cholesky trailing update on Hopper (sm_90a).
//
// Replaces the TPU kernel pta_replicator_tpu/ops/pallas_cw.py::
// cov_syrk_update (:484, kernel body _cov_syrk_kernel :467, tile
// cov_tile_update :458): for a trailing matrix C (Np, m, m) and a panel L
// (Np, m, b),
//
//   C[p][I][J] <- C[p][I][J] - L[p][I] L[p][J]^T   for tiles I >= J
//
// over the (tile x tile) grid of C, diagonal tiles whole; strictly-upper
// tiles are left as they are (only the lower triangle is read downstream),
// as the TPU kernel leaves them. C is updated in place and may be a view
// into a larger matrix: rows are `ldc` entries apart and pulsars `batch_c`
// entries, and a view may start at any entry (8-byte aligned in float64).
//
// Bound. A launch does 2 b operations per entry of the lower tiles, about
// m^2 b per pulsar, against reading those tiles of C once, writing them
// once and reading L once. In the dense covariance rung (68 pulsars, m =
// 2048 - 128 k, b = 128, tile 128) the 15 launches of one factorization do
// 1.9e11 FP64 operations (2.9 ms at the 67 TFLOP/s FP64 tensor-core rate)
// and move 13.2 GB (3.9 ms at 3.35 TB/s): early launches are bound by
// bytes (C's tiles), late ones by operations and by latency. The FP64 FMA
// pipe outside the tensor cores runs at half the tensor-core rate, so
// float64 has to run on the tensor cores (DMMA) to reach either bound.
//
// Design. A block of eight warps owns a 128 x 64 sub-tile of one lower
// tile pair of one pulsar, masked at the tile's edge: grid (tile pair x
// sub-tiles, Np), the pair fastest, so that the blocks reading one
// pulsar's panel (m b 8 <= 2 MB) run together and find it in L2
// (ops/cw.py::syrk_plan counts the grid).
// * Staging: a ring of kStages chunks of kChunk contraction columns, each
//   holding the block's rows of L_I and of L_J in one [row][k] layout,
//   filled by cp.async straight from L's contiguous rows (16-byte copies,
//   element copies when b or L's address does not allow them). Rows past a
//   tile's edge and k past b are zero filled. The row stride of kChunk + 4
//   words puts each half warp's f64 fragment loads on 16 distinct bank
//   pairs, and each quarter warp's f32 16-byte loads on 32 banks.
// * float64: each warp owns 32 x 32 outputs as 2 x 4 mma.sync m16n8k8 f64
//   (DMMA) tiles. L runs along k in both operands, so the A fragment (rows
//   of L_I) and the B fragment (rows of L_J, column-major) load from the
//   same staged layout with no transposed copy.
// * float32: IEEE float32 has no tensor-core route (TF32 is not float32),
//   so each thread keeps an 8 x 4 register tile and runs FFMA on 16-byte
//   shared loads (12 loads per 128 FMAs).
// * C: a block first asks L2 for its window of C (prefetch.global.L2, two
//   or three instructions a thread), accumulates L_I L_J^T from zero, and
//   at the end writes C - sum, reading C from L2 eight entries at a time
//   (a read may not pass an earlier write that could alias it, so entry by
//   entry each read would wait for the write before it). Each entry of C is
//   read once and written once, and its read from device memory overlaps
//   the contraction.
// * The sums run in k order (no atomics: the same bits on every run), in
//   another order than the plain version's, so the two agree to a
//   tolerance; C - sum is the plain version's last rounding.
//
// What holds it back (kernels/syrk_study.py on an H100 SXM at 700 W, f64,
// 68 x 1,920 x 128; PERF.md): the kernel takes 1.30 ms against a 0.678 ms
// bound; a build that only stages (and reads and writes C) takes 1.13 ms,
// one that only multiplies (and reads and writes C) 1.03 ms. Staging pulls
// 3.2 GB of L's rows from L2 per launch beside C's 2.1 GB through HBM, and
// the DMMA products alone run at ~50% of the tensor-core rate. Tried and
// slower: accumulating from C loaded at the start (1.45-1.60 ms: every
// block waited for C before its first product), one block per SM without
// the 128-register cap (1.9 ms), 32-column stages (2.2 ms), 16-byte
// fragment loads pairing two k slots (2.34 ms: 120 bytes of spills), and
// 64 x 64 blocks where the grid is small (at the last launch, 68 x 128 x
// 128, no gain beyond run-to-run spread).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpsM = 4;                // warps down a block's rows
constexpr int kWarpsN = 2;                // warps across a block's columns
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kRowsA = 32 * kWarpsM;      // output rows of a block
constexpr int kBlockCols = 32 * kWarpsN;  // output columns of a block
constexpr int kChunk = 16;                // contraction columns per pipeline stage
constexpr int kStride = kChunk + 4;       // padded row stride of the staged rows
constexpr int kMmaK = 8;                  // DMMA depth: m16n8k8

template <typename T>
struct Stages;
template <>
struct Stages<double> { static constexpr int value = 3; };  // 90 KB
template <>
struct Stages<float> { static constexpr int value = 4; };   // 60 KB

template <typename T>
struct Shape {
  static constexpr int kRows = kRowsA + kBlockCols;    // staged rows: L_I's, then L_J's
  static constexpr int kStageElems = kRows * kStride;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements of a 16-byte copy
  static constexpr int kPieces = kChunk / kVec;                   // copies per staged row
  static constexpr int kCopies = kRows * kPieces / kThreads;      // copies per thread
  static_assert(kRows * kPieces % kThreads == 0, "copies must divide among the threads");
  static constexpr size_t kSmem = sizeof(T) * static_cast<size_t>(kStageElems) * Stages<T>::value;
};

// pair -> (ti, tj), tj <= ti, with pair = ti (ti + 1) / 2 + tj
__device__ __forceinline__ void tri_pair(int pair, int& ti, int& tj) {
  int t = static_cast<int>((sqrt(8.0 * pair + 1.0) - 1.0) * 0.5);
  while (t * (t + 1) / 2 > pair) --t;
  while ((t + 1) * (t + 2) / 2 <= pair) ++t;
  ti = t;
  tj = pair - t * (t + 1) / 2;
}

// BYTES from device to shared memory; zero filled when !valid (the source
// is then not read, but must still be a device address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
  else
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

__device__ __forceinline__ void dmma_16x8x8(double (&c)[4], const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The block's output window: rows [r0, r1), columns [c0, c1) of pulsar p's C.
template <typename T>
struct Window {
  T* c;
  long long ldc;
  int r0, r1, c0, c1;

  // Ask L2 for every 128-byte line of the window (a row may straddle one
  // more line than it fills), the block's threads sharing the work: C's
  // read then overlaps the contraction instead of preceding or following it.
  __device__ __forceinline__ void prefetch() const {
    constexpr int kStep = 128 / static_cast<int>(sizeof(T));  // elements of a line
    constexpr int kLines = kBlockCols / kStep + 1;
    for (int e = threadIdx.x; e < kRowsA * kLines; e += kThreads) {
      const int r = e / kLines, col = min((e - r * kLines) * kStep, c1 - c0 - 1);
      if (r0 + r < r1)
        asm volatile("prefetch.global.L2 [%0];\n"
                     :: "l"(c + static_cast<size_t>(r0 + r) * ldc + c0 + col));
    }
  }
  __device__ __forceinline__ T load(int r, int col) const {
    return (r0 + r < r1 && c0 + col < c1) ? c[static_cast<size_t>(r0 + r) * ldc + c0 + col] : T(0);
  }
  __device__ __forceinline__ void store(int r, int col, T v) const {
    if (r0 + r < r1 && c0 + col < c1) c[static_cast<size_t>(r0 + r) * ldc + c0 + col] = v;
  }
};

// float64: warp (wr, wc) owns rows 32 wr.. and columns 32 wc.. as 2 x 4
// DMMA tiles of 16 x 8. With g = lane / 4, t = lane % 4, fragment element
// a[2j + h] is the A operand's (row g + 8h, k t + 4j), b[j] the B
// operand's (k t + 4j, column g), and c[2h + i] the sum at (row g + 8h,
// column 2t + i). Staged element (row, k) lies at row * kStride + k.
struct AccF64 {
  static constexpr int kCount = 32;  // sums a thread holds
  double c[2][4][4];

  // sum i = 16 m + 4 n + e and its (row, column) in the block's window
  __device__ __forceinline__ double& value(int i) { return c[i >> 4][(i >> 2) & 3][i & 3]; }
  __device__ __forceinline__ void coord(int i, int& r, int& col) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    r = (warp / kWarpsN) * 32 + (i >> 4) * 16 + (lane >> 2) + 8 * ((i & 3) >> 1);
    col = (warp % kWarpsN) * 32 + ((i >> 2) & 3) * 8 + 2 * (lane & 3) + (i & 1);
  }

  __device__ __forceinline__ void step(const double* s) {
    const double* As = s;
    const double* Bs = s + kRowsA * kStride;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp / kWarpsN) * 32, wn = (warp % kWarpsN) * 32;
    const int g = lane >> 2, t = lane & 3;
    const double* ar = As + (wm + g) * kStride + t;
    const double* br = Bs + (wn + g) * kStride + t;
    // one k step's B fragments, then one 16-row A fragment at a time: 24
    // fragment registers live beside the 64 of the accumulators
#pragma unroll
    for (int k = 0; k < kChunk; k += kMmaK) {
      double b[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        b[n][0] = br[(n * 8) * kStride + k];
        b[n][1] = br[(n * 8) * kStride + k + 4];
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const double a[4] = {ar[(m * 16) * kStride + k], ar[(m * 16 + 8) * kStride + k],
                             ar[(m * 16) * kStride + k + 4], ar[(m * 16 + 8) * kStride + k + 4]};
#pragma unroll
        for (int n = 0; n < 4; ++n) dmma_16x8x8(c[m][n], a, b[n]);
      }
    }
  }
};

// float32: thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i
// (i < 8) and columns tx + 16 j (j < 4). A quarter warp's eight B loads
// hit eight consecutive staged rows: a row stride of 20 words puts them on
// 32 distinct banks; the A loads are broadcasts.
struct AccF32 {
  static constexpr int kTy = kThreads / 16;  // rows between a thread's rows
  static constexpr int kCount = 32;  // sums a thread holds
  float c[8][4];

  // sum 4 i + j and its (row, column) in the block's window
  __device__ __forceinline__ float& value(int k) { return c[k >> 2][k & 3]; }
  __device__ __forceinline__ void coord(int k, int& r, int& col) const {
    r = (threadIdx.x >> 4) + kTy * (k >> 2);
    col = (threadIdx.x & 15) + 16 * (k & 3);
  }

  __device__ __forceinline__ void step(const float* s) {
    const float* As = s;
    const float* Bs = s + kRowsA * kStride;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int k = 0; k < kChunk; k += 4) {
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + kTy * i) * kStride + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * kStride + k);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
          c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
          c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
          c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
        }
    }
  }
};

template <typename T>
struct AccFor;
template <>
struct AccFor<double> { using type = AccF64; };
template <>
struct AccFor<float> { using type = AccF32; };

// Chunk `chunk` of the block's rows of L into stage `s`: staged rows
// [0, kRowsA) are L rows r0.., rows [kRowsA, kRows) are L rows c0...
template <typename T>
__device__ __forceinline__ void stage_chunk(T* s, const T* lp, int b, int chunk, int r0, int r1,
                                            int c0, int c1, bool vec) {
  using S = Shape<T>;
  const int k0 = chunk * kChunk;
#pragma unroll
  for (int i = 0; i < S::kCopies; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = e / S::kPieces, k = k0 + (e - row * S::kPieces) * S::kVec;
    const bool a_row = row < kRowsA;
    const int g = a_row ? r0 + row : c0 + row - kRowsA;
    const bool live = g < (a_row ? r1 : c1);
    T* dst = s + row * kStride + k - k0;
    const T* src = lp + (live ? static_cast<size_t>(g) * b : 0);
    if (vec) {
      const bool ok = live && k < b;  // b is a multiple of kVec: all in or all out
      cp_async<16>(dst, ok ? src + k : lp, ok);
    } else {
#pragma unroll
      for (int v = 0; v < S::kVec; ++v) {
        const bool ok = live && k + v < b;
        cp_async<sizeof(T)>(dst + v, ok ? src + k + v : lp, ok);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
cov_syrk_kernel(T* __restrict__ c, long long batch_c, long long ldc, const T* __restrict__ l,
                int m, int b, int tile, int nsr, int nsc, int vec) {
  using S = Shape<T>;
  constexpr int kStages = Stages<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int per = nsr * nsc;
  const int pair = blockIdx.x / per, sub = blockIdx.x - pair * per;
  int ti, tj;
  tri_pair(pair, ti, tj);
  const int r0 = ti * tile + (sub / nsc) * kRowsA;  // < (ti + 1) tile: nsr = ceil(tile / kRowsA)
  const int c0 = tj * tile + (sub % nsc) * kBlockCols;
  const int r1 = min(r0 + kRowsA, (ti + 1) * tile);
  const int c1 = min(c0 + kBlockCols, (tj + 1) * tile);
  const int p = blockIdx.y;
  const T* lp = l + static_cast<size_t>(p) * m * b;
  const Window<T> win{c + static_cast<size_t>(p) * batch_c, ldc, r0, r1, c0, c1};
  const int nchunks = (b + kChunk - 1) / kChunk;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) stage_chunk<T>(smem + s * S::kStageElems, lp, b, s, r0, r1, c0, c1, vec);
    cp_async_commit();
  }
  win.prefetch();
  using Acc = typename AccFor<T>::type;
  Acc acc;
#pragma unroll
  for (int i = 0; i < Acc::kCount; ++i) acc.value(i) = T(0);
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `chunk` landed
    __syncthreads();  // everyone's landed; everyone is done with chunk - 1's slot
    const int next = chunk + kStages - 1;
    if (next < nchunks)
      stage_chunk<T>(smem + (next % kStages) * S::kStageElems, lp, b, next, r0, r1, c0, c1, vec);
    cp_async_commit();
    acc.step(smem + (chunk % kStages) * S::kStageElems);
  }
  // C - sum, kGroup entries at a time: the group's reads go out together
  // (a read may not pass an earlier write of this thread, which the
  // compiler cannot tell apart from it), then its writes.
  constexpr int kGroup = 8;
#pragma unroll
  for (int i0 = 0; i0 < Acc::kCount; i0 += kGroup) {
    T cv[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      int r, col;
      acc.coord(i0 + j, r, col);
      cv[j] = win.load(r, col);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      int r, col;
      acc.coord(i0 + j, r, col);
      win.store(r, col, cv[j] - acc.value(i0 + j));
    }
  }
}

template <typename T>
int launch(void* c, long long batch_c, long long ldc, const void* l, int np, int m, int b,
           int tile, cudaStream_t stream) {
  using S = Shape<T>;
  if (np < 1 || np > 65535 || m < 1 || b < 1 || tile < 1 || m % tile != 0 || ldc < m ||
      batch_c < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = m / tile;
  const int nsr = (tile + kRowsA - 1) / kRowsA;
  const int nsc = (tile + kBlockCols - 1) / kBlockCols;
  const long long blocks = static_cast<long long>(nt) * (nt + 1) / 2 * nsr * nsc;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = cov_syrk_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = b % S::kVec == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0;
  kernel<<<dim3(static_cast<unsigned>(blocks), np), kThreads, S::kSmem, stream>>>(
      static_cast<T*>(c), batch_c, ldc, static_cast<const T*>(l), m, b, tile, nsr, nsc,
      vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Update C in place on `stream` (NULL: the default stream). dtype 0 is
// float32, 1 float64. C's rows are `ldc` entries apart, its pulsars
// `batch_c`; L is contiguous (np, m, b). Returns the launch's cudaError_t;
// 0 means launched.
extern "C" int cov_syrk_launch(void* c, long long batch_c, long long ldc, const void* l, int np,
                               int m, int b, int tile, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(c, batch_c, ldc, l, np, m, b, tile, s);
  if (dtype == 1) return launch<double>(c, batch_c, ldc, l, np, m, b, tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cov_syrk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
