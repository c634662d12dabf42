// Blocked-Cholesky trailing update on Hopper (sm_90a).
//
// Replaces the TPU kernel pta_replicator_tpu/ops/pallas_cw.py::
// cov_syrk_update (kernel body _cov_syrk_kernel, tile cov_tile_update):
// for a trailing matrix C (Np, m, m) and a panel L (Np, m, b),
//
//   C[p][I][J] <- C[p][I][J] - L[p][I] L[p][J]^T   for tiles I >= J
//
// over the (tile x tile) grid of C; strictly-upper tiles are left as they
// are (only the lower triangle is read downstream), as the TPU kernel
// leaves them. C is updated in place and may be a view into a larger
// matrix: rows are `ldc` entries apart and pulsars `batch_c` entries.
//
// Bound. A launch does 2 b per lower-tile entry, about m^2 b operations
// per pulsar, against reading the lower tiles of C once, writing them
// once and reading L once. In the dense covariance rung (68 pulsars,
// m = 2048 - 128 k, b = 128) the 15 launches of one factorization do
// ~1.9e11 FP64 operations (2.9 ms at the 67 TFLOP/s FP64 tensor rate)
// and move ~12 GB (3.6 ms at 3.35 TB/s): a launch sits near the ridge,
// bound by bytes early in the factorization and by operations late.
//
// Design. The TPU kernel runs one (tile x tile) output per grid step from
// two (tile, b) panel slices. Here a block of 256 threads owns one 64 x 64
// sub-tile of one lower tile pair of one pulsar: grid (tile pairs x
// sub-tiles, Np). It stages 64 x 16 slabs of the panel's row blocks i and
// j in shared memory and accumulates a 4 x 4 register block per thread
// over the contraction in a fixed order (no atomics: the same bits on
// every run), then writes C - sum once. Sub-tiles past the edge of a tile
// smaller than 64 are masked. The FP64 FMA pipe outside the tensor cores
// carries the products; DMMA/wgmma tiles are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 64;  // output sub-tile edge
constexpr int kKc = 16;   // contraction columns staged per step

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// pair -> (ti, tj), tj <= ti, with pair = ti (ti + 1) / 2 + tj
__device__ __forceinline__ void tri_pair(int pair, int& ti, int& tj) {
  int t = static_cast<int>((sqrt(8.0 * pair + 1.0) - 1.0) * 0.5);
  while (t * (t + 1) / 2 > pair) --t;
  while ((t + 1) * (t + 2) / 2 <= pair) ++t;
  ti = t;
  tj = pair - t * (t + 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cov_syrk_kernel(T* __restrict__ c, long long batch_c, long long ldc,
                const T* __restrict__ l, int m, int b, int tile, int nsub) {
  __shared__ T s_i[kKc][kSub];
  __shared__ T s_j[kKc][kSub];
  const int per = nsub * nsub;
  const int pair = blockIdx.x / per;
  const int sub = blockIdx.x - pair * per;
  int ti, tj;
  tri_pair(pair, ti, tj);
  const int r0 = ti * tile + (sub / nsub) * kSub;
  const int c0 = tj * tile + (sub % nsub) * kSub;
  const int r1 = min(r0 + kSub, (ti + 1) * tile);  // rows [r0, r1)
  const int c1 = min(c0 + kSub, (tj + 1) * tile);  // cols [c0, c1)
  if (r0 >= r1 || c0 >= c1) return;  // a sub-tile beyond a small tile

  const int p = blockIdx.y;
  const T* lp = l + static_cast<size_t>(p) * m * b;
  T* cp = c + static_cast<size_t>(p) * batch_c;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < b; k0 += kKc) {
    __syncthreads();  // the previous slab is consumed
    for (int e = threadIdx.x; e < kSub * kKc; e += kThreads) {
      const int rr = e / kKc, kk = e - rr * kKc;
      const int k = k0 + kk;
      const int ri = r0 + rr, cj = c0 + rr;
      s_i[kk][rr] = (ri < r1 && k < b) ? lp[static_cast<size_t>(ri) * b + k] : T(0);
      s_j[kk][rr] = (cj < c1 && k < b) ? lp[static_cast<size_t>(cj) * b + k] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKc; ++kk) {
      T a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_i[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_j[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_t(a[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= r1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= c1) continue;
      T* x = cp + static_cast<size_t>(r) * ldc + col;
      *x = *x - acc[i][j];
    }
  }
}

template <typename T>
int launch(void* c, long long batch_c, long long ldc, const void* l, int np,
           int m, int b, int tile, cudaStream_t stream) {
  if (np < 1 || np > 65535 || m < 1 || b < 1 || tile < 1 || m % tile != 0 ||
      ldc < m || batch_c < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = m / tile;
  const int nsub = (tile + kSub - 1) / kSub;
  const long long blocks = static_cast<long long>(nt) * (nt + 1) / 2 * nsub * nsub;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cov_syrk_kernel<T><<<dim3(static_cast<unsigned>(blocks), np), kThreads, 0, stream>>>(
      static_cast<T*>(c), batch_c, ldc, static_cast<const T*>(l), m, b, tile, nsub);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Update C in place on `stream` (NULL: the default stream). dtype 0 is
// float32, 1 float64. C's rows are `ldc` entries apart, its pulsars
// `batch_c`; L is contiguous (np, m, b). Returns the launch's cudaError_t;
// 0 means launched.
extern "C" int cov_syrk_launch(void* c, long long batch_c, long long ldc,
                               const void* l, int np, int m, int b, int tile,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(c, batch_c, ldc, l, np, m, b, tile, s);
  if (dtype == 1) return launch<double>(c, batch_c, ldc, l, np, m, b, tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cov_syrk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
