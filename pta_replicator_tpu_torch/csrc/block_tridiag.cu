// Block-tridiagonal factor and solve on Hopper (sm_90a).
//
// Replaces the two TPU kernels of pta_replicator_tpu/ops/pallas_gp.py::
// tridiag_factor_solve. For a symmetric positive-definite block-
// tridiagonal matrix with diagonal blocks D (Np, nb, b, b) and sub-
// diagonal blocks E (Np, nb - 1, b, b) (E[k] is the (k+1, k) block), and
// right-hand sides X (Np, nb, b, Q):
//
// * forward (body _tridiag_fwd_kernel), sequential over block columns k:
//     M_k = E_{k-1} L_{k-1}^-T   (M_0 = 0)
//     L_k = chol(D_k - M_k M_k^T)
//     y_k = L_k^-1 (x_k - M_k y_{k-1})
//   templated on FACTOR: true computes Ld, M and Y in one sweep (Q = 0 is
//   the factor alone); false reads a given Ld and M and only forward-
//   substitutes (factor once, solve many);
// * backward (body _tridiag_bwd_kernel), over reversed block columns:
//     z_k = L_k^-T (y_k - M_{k+1}^T z_{k+1})   (M_nb = 0).
//
// Bound. Bytes: each of D, E, X (or Ld, M, Y) read once and each output
// written once; at 68 x 485 x 16 with Q = 123 (float64) the forward sweep
// moves ~1.3 GB (~0.4 ms at 3.35 TB/s) against ~3.4e9 operations. But the
// recurrence is sequential over the 485 block columns with only 68
// independent chains, so latency bounds it first: each step waits for a
// b-pivot Cholesky and two triangular solves.
//
// Design. One block per pulsar walks the block columns in the FACTOR
// sweep; its 256 threads split each b x b step (rows of M_k, entries of
// the Schur complement, the rank-1 updates of the pivots) and then the Q
// right-hand-side columns. The three b x b working tiles (L_{k-1}, M_k,
// L_k) sit in shared memory when they fit (b = 16: 6 KB in float64);
// larger blocks (b = 128 or 256 in float64) work in the outputs Ld and M
// in device memory instead, so every block size from 1 to 256 runs here.
// In the substitution-only forward sweep and in the backward sweep the
// right-hand-side columns are independent: one thread owns one column of
// one pulsar for the whole sweep, grid (column groups, Np), with no
// barrier at all. Sums run in a fixed order and there are no atomics:
// every run gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kFactorThreads = 256;
constexpr int kColumnThreads = 128;
constexpr size_t kMaxSmem = 200 * 1024;

// y_k[:, col] of the forward substitution, in place in yk:
//   y_k = L_k^-1 (x_k - M_k y_{k-1}); mk == nullptr means M_k = 0.
template <typename T>
__device__ __forceinline__ void forward_column(const T* lk, const T* mk,
                                               const T* xk, const T* yprev,
                                               T* yk, int b, int q, int col) {
  for (int i = 0; i < b; ++i) {
    T v = xk[static_cast<size_t>(i) * q + col];
    if (mk != nullptr) {
      T s = T(0);
      for (int l = 0; l < b; ++l) s += mk[i * b + l] * yprev[static_cast<size_t>(l) * q + col];
      v = v - s;
    }
    for (int j = 0; j < i; ++j) v -= lk[i * b + j] * yk[static_cast<size_t>(j) * q + col];
    yk[static_cast<size_t>(i) * q + col] = v / lk[i * b + i];
  }
}

// z_k[:, col] of the backward substitution, in place in zk:
//   z_k = L_k^-T (y_k - M_{k+1}^T z_{k+1}); mnext == nullptr at the end.
template <typename T>
__device__ __forceinline__ void backward_column(const T* lk, const T* mnext,
                                                const T* yk, const T* znext,
                                                T* zk, int b, int q, int col) {
  for (int i = b - 1; i >= 0; --i) {
    T v = yk[static_cast<size_t>(i) * q + col];
    if (mnext != nullptr) {
      T s = T(0);
      for (int j = 0; j < b; ++j) s += mnext[j * b + i] * znext[static_cast<size_t>(j) * q + col];
      v = v - s;
    }
    for (int j = b - 1; j > i; --j) v -= lk[j * b + i] * zk[static_cast<size_t>(j) * q + col];
    zk[static_cast<size_t>(i) * q + col] = v / lk[i * b + i];
  }
}

template <typename T, bool FACTOR>
__global__ void tridiag_fwd_kernel(const T* __restrict__ d, const T* __restrict__ e,
                                   const T* __restrict__ x, T* ld, T* m, T* y,
                                   int nb, int b, int q, int use_smem) {
  const int p = blockIdx.y;
  const size_t bb = static_cast<size_t>(b) * b;
  const size_t bq = static_cast<size_t>(b) * q;
  const size_t pulsar = static_cast<size_t>(p) * nb;
  ld += pulsar * bb;
  m += pulsar * bb;
  x += pulsar * bq;
  y += pulsar * bq;

  if constexpr (!FACTOR) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= q) return;
    for (int k = 0; k < nb; ++k)
      forward_column<T>(ld + k * bb, k ? m + k * bb : nullptr, x + k * bq,
                        k ? y + (k - 1) * bq : nullptr, y + k * bq, b, q, col);
    return;
  } else {
    d += pulsar * bb;
    e += static_cast<size_t>(p) * (nb - 1) * bb;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tiles = reinterpret_cast<T*>(smem_raw);
    const int tid = threadIdx.x, nth = blockDim.x;
    T* lp = tiles;           // L_{k-1}
    T* mk = tiles + bb;      // M_k
    T* lk = tiles + 2 * bb;  // L_k
    for (int k = 0; k < nb; ++k) {
      if (!use_smem) {
        lp = k ? ld + (k - 1) * bb : nullptr;
        mk = m + k * bb;
        lk = ld + k * bb;
      }
      const T* dk = d + k * bb;
      // M_k: row i solves L_{k-1} M_k[i, :]^T = E_{k-1}[i, :]^T
      if (k == 0) {
        for (size_t t = tid; t < bb; t += nth) mk[t] = T(0);
      } else {
        const T* ek = e + (k - 1) * bb;
        for (int i = tid; i < b; i += nth) {
          for (int j = 0; j < b; ++j) {
            T v = ek[i * b + j];
            for (int l = 0; l < j; ++l) v -= lp[j * b + l] * mk[i * b + l];
            mk[i * b + j] = v / lp[j * b + j];
          }
        }
      }
      __syncthreads();
      // the Schur complement S = D_k - M_k M_k^T, lower triangle; zero above
      for (size_t t = tid; t < bb; t += nth) {
        const int i = static_cast<int>(t / b), j = static_cast<int>(t % b);
        if (j > i) {
          lk[t] = T(0);
        } else {
          T s = T(0);
          if (k)
            for (int l = 0; l < b; ++l) s += mk[i * b + l] * mk[j * b + l];
          lk[t] = dk[t] - s;
        }
      }
      __syncthreads();
      // L_k = chol(S) in place: b right-looking rank-1 steps
      for (int j = 0; j < b; ++j) {
        const T dj = lk[j * b + j];
        const T inv = T(1) / sqrt(dj);
        for (int i = j + 1 + tid; i < b; i += nth) lk[i * b + j] *= inv;
        __syncthreads();
        const int n = b - j - 1;
        for (int t = tid; t < n * n; t += nth) {
          const int ii = t / n, jj = t - ii * n;
          if (jj <= ii) {
            const int r = j + 1 + ii, c = j + 1 + jj;
            lk[r * b + c] -= lk[r * b + j] * lk[c * b + j];
          }
        }
        if (tid == 0) lk[j * b + j] = dj * inv;
        __syncthreads();
      }
      // y_k, one right-hand-side column per thread
      for (int col = tid; col < q; col += nth)
        forward_column<T>(lk, k ? mk : nullptr, x + k * bq,
                          k ? y + (k - 1) * bq : nullptr, y + k * bq, b, q, col);
      if (use_smem) {
        for (size_t t = tid; t < bb; t += nth) {
          ld[k * bb + t] = lk[t];
          m[k * bb + t] = mk[t];
        }
      }
      __syncthreads();
      if (use_smem) {
        T* swap = lp;
        lp = lk;
        lk = swap;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kColumnThreads)
tridiag_bwd_kernel(const T* __restrict__ ld, const T* __restrict__ m,
                   const T* __restrict__ y, T* z, int nb, int b, int q) {
  const int p = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= q) return;
  const size_t bb = static_cast<size_t>(b) * b;
  const size_t bq = static_cast<size_t>(b) * q;
  const size_t pulsar = static_cast<size_t>(p) * nb;
  ld += pulsar * bb;
  m += pulsar * bb;
  y += pulsar * bq;
  z += pulsar * bq;
  for (int k = nb - 1; k >= 0; --k)
    backward_column<T>(ld + k * bb, k + 1 < nb ? m + (k + 1) * bb : nullptr, y + k * bq,
                       k + 1 < nb ? z + (k + 1) * bq : nullptr, z + k * bq, b, q, col);
}

bool bad_shape(int np, int nb, int b, int q) {
  return np < 1 || np > 65535 || nb < 1 || b < 1 || b > 256 || q < 0;
}

template <typename T>
int factor_fwd(const void* d, const void* e, const void* x, void* ld, void* m,
               void* y, int np, int nb, int b, int q, cudaStream_t stream) {
  if (bad_shape(np, nb, b, q)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * static_cast<size_t>(b) * b * sizeof(T);
  const int use_smem = smem <= kMaxSmem;
  auto kernel = tridiag_fwd_kernel<T, true>;
  const size_t dyn = use_smem ? smem : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(1, np), kFactorThreads, dyn, stream>>>(
      static_cast<const T*>(d), static_cast<const T*>(e), static_cast<const T*>(x),
      static_cast<T*>(ld), static_cast<T*>(m), static_cast<T*>(y), nb, b, q, use_smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve_fwd(const void* ld, const void* m, const void* x, void* y, int np,
              int nb, int b, int q, cudaStream_t stream) {
  if (bad_shape(np, nb, b, q) || q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (q + kColumnThreads - 1) / kColumnThreads;
  tridiag_fwd_kernel<T, false><<<dim3(groups, np), kColumnThreads, 0, stream>>>(
      nullptr, nullptr, static_cast<const T*>(x), const_cast<T*>(static_cast<const T*>(ld)),
      const_cast<T*>(static_cast<const T*>(m)), static_cast<T*>(y), nb, b, q, 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve_bwd(const void* ld, const void* m, const void* y, void* z, int np,
              int nb, int b, int q, cudaStream_t stream) {
  if (bad_shape(np, nb, b, q) || q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (q + kColumnThreads - 1) / kColumnThreads;
  tridiag_bwd_kernel<T><<<dim3(groups, np), kColumnThreads, 0, stream>>>(
      static_cast<const T*>(ld), static_cast<const T*>(m), static_cast<const T*>(y),
      static_cast<T*>(z), nb, b, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launches below run on `stream` (NULL: the default stream); dtype 0
// is float32, 1 float64; every operand is contiguous. Each returns the
// launch's cudaError_t; 0 means launched.

// FACTOR sweep: Ld, M (np, nb, b, b) and, for q > 0, Y (np, nb, b, q)
// from D (np, nb, b, b), E (np, nb - 1, b, b) and X (np, nb, b, q).
extern "C" int tridiag_factor_fwd_launch(const void* d, const void* e, const void* x,
                                         void* ld, void* m, void* y, int np, int nb,
                                         int b, int q, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return factor_fwd<float>(d, e, x, ld, m, y, np, nb, b, q, s);
  if (dtype == 1) return factor_fwd<double>(d, e, x, ld, m, y, np, nb, b, q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Substitution-only forward sweep: Y from a given Ld, M and X.
extern "C" int tridiag_solve_fwd_launch(const void* ld, const void* m, const void* x,
                                        void* y, int np, int nb, int b, int q,
                                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return solve_fwd<float>(ld, m, x, y, np, nb, b, q, s);
  if (dtype == 1) return solve_fwd<double>(ld, m, x, y, np, nb, b, q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward sweep: Z from Ld, M and the forward sweep's Y.
extern "C" int tridiag_bwd_launch(const void* ld, const void* m, const void* y,
                                  void* z, int np, int nb, int b, int q, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return solve_bwd<float>(ld, m, y, z, np, nb, b, q, s);
  if (dtype == 1) return solve_bwd<double>(ld, m, y, z, np, nb, b, q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* block_tridiag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
