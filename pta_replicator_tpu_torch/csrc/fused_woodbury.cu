// Fused Woodbury assembly on Hopper (sm_90a).
//
// Replaces the TPU kernel pta_replicator_tpu/ops/pallas_gp.py::
// fused_woodbury_update (kernel body _fused_woodbury_kernel, tile
// gp_tile_terms): for T (Np, Nt, Q), w and r (Np, Nt),
//
//   TNT[p] = T[p]^T diag(w[p]) T[p]   (Np, Q, Q)
//   d[p]   = T[p]^T diag(w[p]) r[p]   (Np, Q)
//   rnr[p] = r[p]^T diag(w[p]) r[p]   (Np,)
//
// in one pass over the Nt axis, accumulated in the input dtype. The
// (Np, Nt, Q) product w*T never reaches device memory. All three sums are
// the lower triangle of the Gram matrix of the augmented columns
// A = [T | r] (Q + 1 of them): row Q holds d, its corner rnr.
//
// Bound. The work is Np*Nt*(Q(Q+1) + 4Q + 3) operations against reading
// T, w and r once: at the flagship 68 x 7,758 x 123 that is 8.3e9
// operations and 527 MB (float64) or 264 MB (float32). At 3.35 TB/s and
// 67 TFLOP/s (the FP32 rate, and the FP64 tensor-core rate) float64 is
// bound by bytes (~0.16 ms) and float32 by operations (~0.12 ms).
//
// Design. The TPU kernel walks Nt tiles in order and adds each tile into
// revisited output blocks; Hopper's blocks run in parallel and in no
// order. Here grid (nsplit, Np): each block owns one contiguous range of
// one pulsar's TOAs and stages it tile by tile (64 rows of the padded
// augmented columns, plus w) in dynamic shared memory, masking the ragged
// Nt edge itself (no padded copy of T). The lower triangle of the
// augmented Gram matrix is cut into 4 x 4 register blocks; each thread
// owns up to kMaxSlots of them and accumulates 16 sums per block in
// registers, row by row in TOA order: per row and block, 4 + 4 shared
// loads feed 16 fused multiply-adds. Each block writes its partial sums to
// a (Np, nsplit, blocks, 16) workspace, and a second kernel adds the
// splits in a fixed order and mirrors the triangle into TNT. No atomics:
// every run gives the same bits. Products are T_q * (T_s * w), the plain
// version's rounding (ops/gp.py::gp_tile_terms); the sums are fused
// multiply-adds in another order than the plain version's tile-sequential
// einsum, which is why kernel and plain agree to a tolerance, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRB = 4;                  // register block edge
constexpr int kMaxSlots = 4;            // register blocks per thread
constexpr int kMaxTile = 64;            // TOA rows staged per step
constexpr int kMaxSmem = 96 * 1024;     // bytes of dynamic shared memory

__host__ __device__ inline int col_blocks(int q) { return (q + 1 + kRB - 1) / kRB; }
__host__ __device__ inline int tri_blocks(int q) {
  const int nb = col_blocks(q);
  return nb * (nb + 1) / 2;
}

// k -> (bq, bs), bs <= bq, with k = bq (bq + 1) / 2 + bs
__device__ __forceinline__ void tri_block(int k, int& bq, int& bs) {
  int b = static_cast<int>((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
  while (b * (b + 1) / 2 > k) --b;
  while ((b + 1) * (b + 2) / 2 <= k) ++b;
  bq = b;
  bs = k - b * (b + 1) / 2;
}

template <typename T, int SLOTS>
__global__ void __launch_bounds__(kThreads)
woodbury_partial_kernel(const T* __restrict__ tmat, const T* __restrict__ w,
                        const T* __restrict__ r, T* __restrict__ ws, int nt,
                        int q, int nsplit, int tile, int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qp = col_blocks(q) * kRB;
  T* s_a = reinterpret_cast<T*>(smem_raw);  // [tile][qp]: T's columns, r, zeros
  T* s_w = s_a + static_cast<size_t>(tile) * qp;  // [tile]
  const int p = blockIdx.y;
  const int split = blockIdx.x;
  const int nblk = tri_blocks(q);
  const int row0 = split * rows_per_split;
  const int row1 = min(nt, row0 + rows_per_split);

  int bq[SLOTS], bs[SLOTS];
  bool own[SLOTS];
  T acc[SLOTS][kRB][kRB];
#pragma unroll
  for (int slot = 0; slot < SLOTS; ++slot) {
    const int k = threadIdx.x + slot * kThreads;
    own[slot] = k < nblk;
    bq[slot] = bs[slot] = 0;
    if (own[slot]) tri_block(k, bq[slot], bs[slot]);
#pragma unroll
    for (int i = 0; i < kRB; ++i)
#pragma unroll
      for (int j = 0; j < kRB; ++j) acc[slot][i][j] = T(0);
  }

  const T* tp = tmat + static_cast<size_t>(p) * nt * q;
  const T* wp = w + static_cast<size_t>(p) * nt;
  const T* rp = r + static_cast<size_t>(p) * nt;
  for (int n0 = row0; n0 < row1; n0 += tile) {
    const int rows = min(tile, row1 - n0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < tile * qp; i += kThreads) {
      const int n = i / qp, c = i - n * qp;
      T v = T(0);
      if (n < rows) {
        if (c < q) v = tp[static_cast<size_t>(n0 + n) * q + c];
        else if (c == q) v = rp[n0 + n];
      }
      s_a[i] = v;
    }
    for (int n = threadIdx.x; n < tile; n += kThreads)
      s_w[n] = n < rows ? wp[n0 + n] : T(0);
    __syncthreads();
#pragma unroll
    for (int slot = 0; slot < SLOTS; ++slot) {
      if (!own[slot]) continue;
      const T* cq = s_a + bq[slot] * kRB;
      const T* cs = s_a + bs[slot] * kRB;
      for (int n = 0; n < rows; ++n) {
        const T wn = s_w[n];
        T a[kRB], b[kRB];
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          a[i] = cq[n * qp + i];
          b[i] = cs[n * qp + i] * wn;
        }
#pragma unroll
        for (int i = 0; i < kRB; ++i)
#pragma unroll
          for (int j = 0; j < kRB; ++j) acc[slot][i][j] += a[i] * b[j];
      }
    }
  }

  T* out = ws + (static_cast<size_t>(p) * nsplit + split) * nblk * (kRB * kRB);
#pragma unroll
  for (int slot = 0; slot < SLOTS; ++slot) {
    if (!own[slot]) continue;
    T* o = out + static_cast<size_t>(threadIdx.x + slot * kThreads) * (kRB * kRB);
#pragma unroll
    for (int i = 0; i < kRB; ++i)
#pragma unroll
      for (int j = 0; j < kRB; ++j) o[i * kRB + j] = acc[slot][i][j];
  }
}

// Sum the splits in order and scatter the lower triangle: TNT (mirrored),
// d (row Q) and rnr (the corner). Every output entry is written once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
woodbury_reduce_kernel(const T* __restrict__ ws, T* __restrict__ tnt,
                       T* __restrict__ d, T* __restrict__ rnr, int q,
                       int nsplit) {
  const int nblk = tri_blocks(q);
  const int per = nblk * kRB * kRB;
  const int p = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= per) return;
  const int k = e / (kRB * kRB);
  const int i = (e / kRB) % kRB, j = e % kRB;
  int bq, bs;
  tri_block(k, bq, bs);
  if (bq == bs && j > i) return;  // the upper half of a diagonal block
  const int a = bq * kRB + i, b = bs * kRB + j;  // b <= a
  if (a > q) return;  // padding columns
  const T* src = ws + static_cast<size_t>(p) * nsplit * per + e;
  T v = T(0);
  for (int s = 0; s < nsplit; ++s) v += src[static_cast<size_t>(s) * per];
  if (a < q) {
    tnt[(static_cast<size_t>(p) * q + a) * q + b] = v;
    tnt[(static_cast<size_t>(p) * q + b) * q + a] = v;
  } else if (b < q) {
    d[static_cast<size_t>(p) * q + b] = v;
  } else {
    rnr[p] = v;
  }
}

template <typename T, int SLOTS>
cudaError_t launch_partial(const T* t, const T* w, const T* r, T* ws, int np,
                           int nt, int q, int nsplit, int tile,
                           int rows_per_split, size_t smem,
                           cudaStream_t stream) {
  auto kernel = woodbury_partial_kernel<T, SLOTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nsplit, np), kThreads, smem, stream>>>(t, w, r, ws, nt, q, nsplit,
                                                       tile, rows_per_split);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* tmat, const void* w, const void* r, void* ws, void* tnt,
           void* d, void* rnr, int np, int nt, int q, int nsplit,
           cudaStream_t stream) {
  const int qp = col_blocks(q) * kRB;
  const int slots = (tri_blocks(q) + kThreads - 1) / kThreads;
  if (np < 1 || np > 65535 || nt < 1 || q < 1 || nsplit < 1 || nsplit > nt ||
      slots > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = min(kMaxTile, static_cast<int>(kMaxSmem / ((qp + 1) * sizeof(T))));
  const size_t smem = static_cast<size_t>(tile) * (qp + 1) * sizeof(T);
  const int rows_per_split = (nt + nsplit - 1) / nsplit;
  const T* a = static_cast<const T*>(tmat);
  const T* b = static_cast<const T*>(w);
  const T* c = static_cast<const T*>(r);
  T* o = static_cast<T*>(ws);
  cudaError_t err;
  switch (slots) {
    case 1: err = launch_partial<T, 1>(a, b, c, o, np, nt, q, nsplit, tile, rows_per_split, smem, stream); break;
    case 2: err = launch_partial<T, 2>(a, b, c, o, np, nt, q, nsplit, tile, rows_per_split, smem, stream); break;
    case 3: err = launch_partial<T, 3>(a, b, c, o, np, nt, q, nsplit, tile, rows_per_split, smem, stream); break;
    default: err = launch_partial<T, 4>(a, b, c, o, np, nt, q, nsplit, tile, rows_per_split, smem, stream); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = tri_blocks(q) * kRB * kRB;
  woodbury_reduce_kernel<T><<<dim3((per + kThreads - 1) / kThreads, np), kThreads, 0, stream>>>(
      o, static_cast<T*>(tnt), static_cast<T*>(d), static_cast<T*>(rnr), q, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entries of the partial-sum workspace per (pulsar, split) for Q columns;
// 0 when Q exceeds what a block's registers hold.
extern "C" int fused_woodbury_workspace(int q) {
  if (q < 1 || (tri_blocks(q) + kThreads - 1) / kThreads > kMaxSlots) return 0;
  return tri_blocks(q) * kRB * kRB;
}

// Launch both kernels on `stream` (NULL: the default stream). dtype 0 is
// float32, 1 float64; `ws` holds np * nsplit * fused_woodbury_workspace(q)
// entries. Returns the first launch's cudaError_t; 0 means launched.
extern "C" int fused_woodbury_launch(const void* tmat, const void* w,
                                     const void* r, void* ws, void* tnt,
                                     void* d, void* rnr, int np, int nt, int q,
                                     int nsplit, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(tmat, w, r, ws, tnt, d, rnr, np, nt, q, nsplit, s);
  if (dtype == 1) return launch<double>(tmat, w, r, ws, tnt, d, rnr, np, nt, q, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fused_woodbury_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
