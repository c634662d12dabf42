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
//   either factoring (Ld, M and, for Q > 0, Y in one sweep; Q = 0 is the
//   factor alone) or only forward-substituting from a given Ld and M
//   (factor once, solve many);
// * backward (body _tridiag_bwd_kernel), over reversed block columns:
//     z_k = L_k^-T (y_k - M_{k+1}^T z_{k+1})   (M_nb = 0).
//
// Bound. Bytes: each of D, E, X (or Ld, M, Y) read once and each output
// written once; at 68 x 485 x 16 with Q = 123 (float64) a substitution
// sweep moves 1.17 GB (0.35 ms at 3.35 TB/s) against 3.1e9 operations.
// But each sweep is a recurrence over the 485 block columns with 68
// independent chains (times Q in the substitution sweeps), so latency
// bounds it first: each step of the factor waits for a b-step triangular
// solve and a b-pivot Cholesky, each step of a substitution for a b-step
// triangular solve.
//
// Design for b <= 32 (the banded covariance's 16); ops/gp.py::tridiag_plan
// picks the route and the launch shape, and the CPU tests check it.
// * Substitution sweeps (the forward sweep from a given factor, and the
//   backward sweep). A group of LANES lanes carries one right-hand-side
//   column in registers, each lane R = b' / LANES of its rows (b' is b
//   rounded up to a power of two): R = 1, a lane per row, for few columns
//   (Q = 1, 7), or R = min(b', 16), the fewest lanes, for many (Q = 123,
//   200), as measured fastest. A block column's triangular solve passes
//   each y_j from its owner lane by __shfl_sync, and each y_j also goes
//   straight into the next block column's M product, so that product runs
//   inside the solve's chain and nothing returns through memory. The
//   columns of one pulsar in a block share a ring of four shared-memory
//   stages, each holding L_k and an M block padded to b' x b' (identity and
//   zero padding) and 1/L_ii, filled by cp.async three block columns ahead;
//   x_k (y_k backward) is loaded two block columns ahead into registers.
//   One __syncthreads per block column.
// * Factor sweep without right-hand sides. One warp per pulsar, lane i
//   owning row i of M_k and of L_k in registers, with no block barrier
//   (only __syncwarp). M_k is a right-looking triangular solve against
//   L_{k-1}, read as broadcasts from the warp's shared memory; S = D_k -
//   M_k M_k^T reads M_k's rows the same way, each row's columns split over
//   two lanes where b' <= 16; the Cholesky runs b pivots as rank-1 steps:
//   the pivot passes by __shfl_sync from the lane that keeps it apart (its
//   own diagonal), the next column's entry by __shfl_sync too, the rest of
//   the column through a shared buffer, with no per-lane tests. D_k and
//   E_{k-1} arrive by cp.async two block columns ahead; L_k and M_k leave
//   through shared memory in 16-byte stores. A non-positive pivot gives
//   NaN (rsqrt), as the reference's route does, and raises nothing.
// Blocks of 33..256, and the fused factor + forward sweep (right-hand sides
// given to the factor; on no path of the port), keep the per-thread route:
// in the factor sweep one block of 256 threads per pulsar splits each
// step's entries, with the working tiles in shared memory when they fit
// (and in the outputs in device memory when they do not: b = 128 or 256 in
// float64), then solves a column per thread; in the substitution sweeps
// one thread owns one column for the whole sweep. Every sum runs in a fixed
// order and there are no atomics: every run gives the same bits.
//
// What holds them back (kernels/tridiag_study.py on an H100 SXM at 700 W,
// float64, config B's 68 x 485 x 16; PERF.md): the substitution sweep at
// Q = 123 takes 1.06 ms, 0.69 without its M product and 0.91 without the
// triangular solve's updates, against a 0.35 ms bound: each block column
// is a chain of b dependent steps, with ~2 us per block column at one
// warp per SM scheduler. The factor sweep takes 2.57 ms (5.3 us per block
// column): its Cholesky 1.35 ms of it, then the Schur complement (0.41),
// the M_k solve (0.34) and the stores (0.22), each a chain on a single
// warp per SM.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kFactorThreads = 256;    // per-thread route: the factor sweep's block
constexpr int kColumnThreads = 128;    // per-thread route: the solves' block
constexpr size_t kMaxSmem = 200 * 1024;
constexpr int kStagedMaxBlock = 32;    // the largest b of the staged routes
constexpr int kSolveStages = 4;        // ring slots of a staged substitution sweep
constexpr int kSolveMaxThreads = 128;  // threads of a staged substitution block, at most
constexpr int kFactorStages = 3;       // ring slots of (D_k, E_{k-1}) in the factor warp
constexpr int kSolveMaxRows = 16;     // rows of a staged substitution lane, at most
constexpr size_t kDefaultSmem = 48 * 1024;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(dst), "l"(gmem), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }
__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }

// The padding of a b' x b' tile (rows `st` entries apart) around its b x b
// block: `diag` on the padded diagonal, zero elsewhere.
template <typename T>
__device__ void pad_tile(T* tile, int b, int bp, int st, T diag, int tid, int nth) {
  for (int e = tid; e < bp * bp; e += nth) {
    const int i = e / bp, j = e - i * bp;
    if (i >= b || j >= b) tile[i * st + j] = i == j ? diag : T(0);
  }
}

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

// ------------------------------------------------ staged route, b <= 32

// The copies that move one b x b block (rows b entries apart) to or from a
// tile (rows `st` entries apart): 16-byte pieces (`unit` entries) when
// every address allows them, else single entries. A thread takes copies
// first, first + step, ...; it tracks each copy's (row, piece) by adding
// the step's (drow, dcol), with no division in the loop.
struct Pieces {
  int unit, per_row, count, first, step, row0, col0, drow, dcol;
};

__device__ __forceinline__ Pieces pieces(int b, int unit, int first, int step) {
  Pieces p;
  p.unit = unit;
  p.per_row = b / unit;
  p.count = b * p.per_row;
  p.first = first;
  p.step = step;
  p.row0 = first / p.per_row;
  p.col0 = first % p.per_row;
  p.drow = step / p.per_row;
  p.dcol = step % p.per_row;
  return p;
}

template <typename T>
__device__ __forceinline__ void stage_block(T* tile, int st, const T* src, int b, const Pieces& p) {
  int i = p.row0, c = p.col0;
  for (int n = p.first; n < p.count; n += p.step) {
    if (p.unit == 1)
      cp_async<sizeof(T)>(tile + i * st + c, src + i * b + c);
    else
      cp_async16(tile + i * st + c * p.unit, src + i * b + c * p.unit);
    c += p.dcol;
    i += p.drow;
    if (c >= p.per_row) {
      c -= p.per_row;
      ++i;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_block(T* dst, int b, const T* tile, int st, const Pieces& p) {
  int i = p.row0, c = p.col0;
  for (int n = p.first; n < p.count; n += p.step) {
    if (p.unit == 1)
      dst[i * b + c] = tile[i * st + c];
    else
      *reinterpret_cast<uint4*>(dst + i * b + c * p.unit) =
          *reinterpret_cast<const uint4*>(tile + i * st + c * p.unit);
    c += p.dcol;
    i += p.drow;
    if (c >= p.per_row) {
      c -= p.per_row;
      ++i;
    }
  }
}

// The tiles' row stride: b' plus 16 bytes, so that 16-byte pieces stay
// aligned and lanes reading one column of neighbouring rows hit distinct
// banks (up to eight rows in float64 and float32).
template <typename T, int BP>
constexpr int kStride = BP + 16 / static_cast<int>(sizeof(T));

// Two neighbouring entries of a tile in one shared-memory load (16 bytes
// in float64, 8 in float32); the first must sit at an even offset.
template <typename T>
struct Pair;
template <>
struct Pair<double> { using type = double2; };
template <>
struct Pair<float> { using type = float2; };
template <typename T>
__device__ __forceinline__ typename Pair<T>::type ld2(const T* p) {
  return *reinterpret_cast<const typename Pair<T>::type*>(p);
}

__device__ __forceinline__ double rcp_t(double v) { return __drcp_rn(v); }
__device__ __forceinline__ float rcp_t(float v) { return __frcp_rn(v); }

// One substitution sweep (FWD: forward from a given factor; else the
// backward sweep): grid (column blocks, Np), `cols` right-hand-side
// columns per block, LANES = BP / R lanes per column; `vec`: 16-byte
// staging copies. Lane g owns rows g + LANES i forward (so that the lanes
// of a column read neighbouring rows of a tile) and g R + i backward (so
// that each lane reads its rows of a tile row in pairs). Each step j of a
// block column's triangular solve also feeds y_j into the next block
// column's M product, so that product runs inside the solve's chain
// instead of after it.
template <typename T, int BP, int R, bool FWD>
__global__ void __launch_bounds__(kSolveMaxThreads)
tridiag_staged_solve_kernel(const T* __restrict__ ld, const T* __restrict__ m,
                            const T* __restrict__ x, T* __restrict__ y,
                            int nb, int b, int q, int cols, int vec) {
  constexpr int LANES = BP / R, st = kStride<T, BP>, tile = BP * st;
  constexpr int pad = 16 / static_cast<int>(sizeof(T));
  constexpr int slot = (2 * tile + BP + pad - 1) / pad * pad;  // L, the M block, then 1/L_ii
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int g = tid % LANES;
  const int col = blockIdx.x * cols + tid / LANES;
  const bool live = tid / LANES < cols && col < q;
  const unsigned full = 0xffffffffu;
  const size_t bb = static_cast<size_t>(b) * b, bq = static_cast<size_t>(b) * q;
  const size_t pulsar = static_cast<size_t>(blockIdx.y) * nb;
  ld += pulsar * bb;
  m += pulsar * bb;
  x += pulsar * bq;
  y += pulsar * bq;
  auto row = [&](int i) { return FWD ? g + LANES * i : g * R + i; };

  for (int s = 0; s < kSolveStages; ++s) {
    T* base = ring + s * slot;
    pad_tile(base, b, BP, st, T(1), tid, nth);
    pad_tile(base + tile, b, BP, st, T(0), tid, nth);
    for (int i = b + tid; i < BP; i += nth) base[2 * tile + i] = T(1);
  }
  // step s runs block column column(s); its stage holds L of that column
  // and the M block that multiplies the column carried into it: M_k
  // forward, M_{k+1} backward (none at the first step)
  auto column = [&](int s) { return FWD ? s : nb - 1 - s; };
  const Pieces copies = pieces(b, vec ? pad : 1, tid, nth);
  auto stage = [&](int s) {
    if (s < nb) {
      const int k = column(s);
      T* base = ring + (s % kSolveStages) * slot;
      stage_block(base, st, ld + k * bb, b, copies);
      if (s) stage_block(base + tile, st, m + (FWD ? k : k + 1) * bb, b, copies);
    }
    cp_async_commit();
  };
  // 1/L_ii of step s's stage, once it has landed
  auto invert = [&](int s) {
    T* base = ring + (s % kSolveStages) * slot;
    for (int i = tid; i < b; i += nth) base[2 * tile + i] = rcp_t(base[i * st + i]);
  };
  // the right-hand side of the lane's rows at step s: zero off the
  // matrix, past the last column or past the sweep
  auto load = [&](T (&v)[R], int s) {
    const T* src = s < nb ? x + column(s) * bq : x;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = row(i);
      v[i] = live && r < b && s < nb ? src[static_cast<size_t>(r) * q + col] : T(0);
    }
  };

  T v[R], xa[R], xb[R];
  stage(0);
  stage(1);
  stage(2);
  load(v, 0);
  load(xa, 1);
  load(xb, 2);
  cp_async_wait<2>();
  __syncthreads();
  invert(0);
  for (int s = 0; s < nb; ++s) {
    // vn: the next step's x minus its M product, summed here over j
    T vn[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      vn[i] = xa[i];
      xa[i] = xb[i];
    }
    load(xb, s + 3);
    cp_async_wait<1>();  // stages s and s + 1 have landed
    __syncthreads();     // ... for every thread, and step s - 1's slot is free
    stage(s + 3);
    if (s + 1 < nb) invert(s + 1);
    const T* Ls = ring + (s % kSolveStages) * slot;
    const T* inv = Ls + 2 * tile;
    const T* Mn = ring + ((s + 1) % kSolveStages) * slot + tile;
    const bool next = s + 1 < nb;
    // step j: row j's owner scales it and passes it on; the lane's rows
    // still to come subtract it (lrj[i]: L[r][j] forward, L[j][r]
    // backward, for its row r = row(i)), and so do the next step's rows
    // (mrj[i]: M_{k+1}[r][j] forward, M_k[j][r] backward)
    auto step = [&](int j, const T (&lrj)[R], const T (&mrj)[R]) {
      const int owner = FWD ? j % LANES : j / R, io = FWD ? j / LANES : j % R;
      const T own = v[io] * inv[j];
      const T yj = LANES == 1 ? own : __shfl_sync(full, own, owner, LANES);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = row(i);
        if (FWD ? r > j : r < j) v[i] -= lrj[i] * yj;
        if (next) vn[i] -= mrj[i] * yj;
      }
      if (g == owner) v[io] = yj;
    };
    if constexpr (FWD && BP > 1 && R < 8) {
#pragma unroll
      for (int j = 0; j < BP; j += 2) {
        if (j < b) {
          T l0[R], l1[R], m0[R], m1[R];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const auto l2 = ld2(Ls + row(i) * st + j);
            const auto m2 = ld2(Mn + row(i) * st + j);
            l0[i] = l2.x;
            l1[i] = l2.y;
            m0[i] = m2.x;
            m1[i] = m2.y;
          }
          step(j, l0, m0);
          if (j + 1 < b) step(j + 1, l1, m1);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < BP; ++t) {
        const int j = FWD ? t : BP - 1 - t;
        if (j < b) {
          T lj[R], mj[R];
          if constexpr (FWD) {
#pragma unroll
            for (int i = 0; i < R; ++i) {
              lj[i] = Ls[row(i) * st + j];
              mj[i] = Mn[row(i) * st + j];
            }
          } else if constexpr (R == 1) {
            lj[0] = Ls[j * st + row(0)];
            mj[0] = Mn[j * st + row(0)];
          } else {
#pragma unroll
            for (int i = 0; i < R; i += 2) {
              const auto l2 = ld2(Ls + j * st + row(i));
              const auto m2 = ld2(Mn + j * st + row(i));
              lj[i] = l2.x;
              lj[i + 1] = l2.y;
              mj[i] = m2.x;
              mj[i + 1] = m2.y;
            }
          }
          step(j, lj, mj);
        }
      }
    }
    T* dst = y + column(s) * bq;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = row(i);
      if (live && r < b) dst[static_cast<size_t>(r) * q + col] = v[i];
      v[i] = vn[i];
    }
  }
}

// The factor sweep without right-hand sides: one warp per pulsar, grid
// (Np), BP = b rounded up to a power of two; `vec`: 16-byte staging copies
// and stores.
template <typename T, int BP>
__global__ void __launch_bounds__(32)
tridiag_factor_warp_kernel(const T* __restrict__ d, const T* __restrict__ e,
                           T* __restrict__ ld, T* __restrict__ m, int nb, int b, int vec) {
  constexpr int st = kStride<T, BP>, tile = BP * st;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);     // kFactorStages x (D_k, E_{k-1})
  T* lbuf = ring + kFactorStages * 2 * tile;    // L_k at k % 2
  T* mbuf = lbuf + 2 * tile;                    // M_k at k % 2
  T* colbuf = mbuf + 2 * tile;                  // two columns of L_k, for the Cholesky
  T* invbuf = colbuf + 2 * st;                  // 1/L_ii of L_k at k % 2
  const int lane = threadIdx.x, i = lane % BP;  // lanes past BP repeat rows, store nothing
  const unsigned full = 0xffffffffu;
  const size_t bb = static_cast<size_t>(b) * b;
  const size_t p = blockIdx.x;
  d += p * nb * bb;
  e += p * (nb - 1) * bb;
  ld += p * nb * bb;
  m += p * nb * bb;

  for (int s = 0; s < kFactorStages; ++s) {
    pad_tile(ring + s * 2 * tile, b, BP, st, T(1), lane, 32);
    pad_tile(ring + s * 2 * tile + tile, b, BP, st, T(0), lane, 32);
  }
  for (int t = b + lane; t < BP; t += 32) invbuf[t] = invbuf[BP + t] = T(1);
  const Pieces copies = pieces(b, vec ? 16 / static_cast<int>(sizeof(T)) : 1, lane, 32);
  auto stage = [&](int k) {
    if (k < nb) {
      T* base = ring + (k % kFactorStages) * 2 * tile;
      stage_block(base, st, d + k * bb, b, copies);
      if (k) stage_block(base + tile, st, e + (k - 1) * bb, b, copies);
    }
    cp_async_commit();
  };

  stage(0);
  stage(1);
  for (int k = 0; k < nb; ++k) {
    cp_async_wait<1>();  // stage k has landed
    __syncwarp();        // ... for every lane, and step k - 1 is done with its slot
    stage(k + 2);
    const T* ds = ring + (k % kFactorStages) * 2 * tile;
    const T* es = ds + tile;
    const T* lp = lbuf + ((k + 1) & 1) * tile;  // L_{k-1}
    const T* invp = invbuf + ((k + 1) & 1) * BP;
    T* lc = lbuf + (k & 1) * tile;
    T* ms = mbuf + (k & 1) * tile;
    T* invc = invbuf + (k & 1) * BP;
    // row i of M_k: L_{k-1} m^T = e^T, right-looking
    T mrow[BP];
#pragma unroll
    for (int j = 0; j < BP; ++j) mrow[j] = k ? es[i * st + j] : T(0);
    if (k) {
#pragma unroll
      for (int j = 0; j < BP; ++j) {
        if (j < b) {
          mrow[j] *= invp[j];
#pragma unroll
          for (int l = j + 1; l < BP; ++l) mrow[l] -= mrow[j] * lp[l * st + j];
        }
      }
    }
    if (lane < BP) {
#pragma unroll
      for (int j = 0; j < BP; ++j) ms[i * st + j] = mrow[j];
    }
    __syncwarp();
    // row i of S = D_k - M_k M_k^T; for b' <= 16 lanes i and i + b' each
    // sum half of the row's columns and swap halves
    T srow[BP];
    if constexpr (BP >= 2 && 2 * BP <= 32) {
      constexpr int H = BP / 2;
      const int half = (lane / BP) & 1;
      T mine[H];
#pragma unroll
      for (int cc = 0; cc < H; ++cc) {
        const int c = half * H + cc;
        T acc = T(0);
        if (k && c < b) {
#pragma unroll
          for (int l = 0; l < BP; ++l) acc += mrow[l] * ms[c * st + l];
        }
        mine[cc] = ds[i * st + c] - acc;
      }
#pragma unroll
      for (int cc = 0; cc < H; ++cc) {
        const T other = __shfl_xor_sync(full, mine[cc], BP);
        srow[cc] = half ? other : mine[cc];
        srow[H + cc] = half ? mine[cc] : other;
      }
    } else {
#pragma unroll
      for (int c = 0; c < BP; ++c) {
        T acc = T(0);
        if (k && c < b) {
#pragma unroll
          for (int l = 0; l < BP; ++l) acc += mrow[l] * ms[c * st + l];
        }
        srow[c] = ds[i * st + c] - acc;
      }
    }
    // L_k = chol(S) by rows: lane i keeps row i in srow and its diagonal
    // apart in dg, which it updates alone; pivot j passes from lane j by
    // __shfl_sync, column j through the warp's column buffer in shared
    // memory (two, alternating, so one __syncwarp a pivot suffices)
    T dg = T(0);
#pragma unroll
    for (int c = 0; c < BP; ++c)
      if (c == i) dg = srow[c];
#pragma unroll
    for (int j = 0; j < BP; ++j) {
      if (j < b) {
        const T piv = __shfl_sync(full, dg, j, BP);
        const T inv = rsqrt_t(piv);
        const T lij = i > j ? srow[j] * inv : (i == j ? piv * inv : T(0));
        srow[j] = lij;
        dg -= lij * lij;  // used again only where i > j
        if (lane == j) invc[j] = inv;
        // S[i][c] -= L[i][j] L[c][j] for c > j: the next column's entry (on
        // the chain to the next pivot) by shuffle, the others in pairs from
        // the column buffer. Entries with c >= i are updated too, with no
        // test: the diagonal is dg's, and step c overwrites them.
        if (j + 1 < b) srow[j + 1] -= lij * __shfl_sync(full, lij, j + 1, BP);
        T* colj = colbuf + (j & 1) * st;
        if (lane < BP) colj[i] = lij;
        __syncwarp();
#pragma unroll
        for (int c0 = (j + 2) & ~1; c0 < BP; c0 += 2) {
          if (c0 < b) {
            const auto l2 = ld2(colj + c0);
            if (c0 > j + 1) srow[c0] -= lij * l2.x;
            srow[c0 + 1] -= lij * l2.y;
          }
        }
      }
    }
    if (lane < BP) {
#pragma unroll
      for (int c = 0; c < BP; ++c) lc[i * st + c] = srow[c];
    }
    __syncwarp();
    store_block(ld + k * bb, b, lc, st, copies);
    store_block(m + k * bb, b, ms, st, copies);
  }
}

// ------------------------- per-thread route: b > 32, and the fused sweep

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

// ------------------------------------------------------------ launches

bool bad_shape(int np, int nb, int b, int q) {
  return np < 1 || np > 65535 || nb < 1 || b < 1 || b > 256 || q < 0;
}

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// 16-byte staging copies: whole pieces in every row of b, and every block
// base 16-byte aligned
template <typename T>
int whole_pieces(int b, std::initializer_list<const void*> ptrs) {
  if (b * sizeof(T) % 16) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return 1;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Each launch below is given the threads and dynamic shared bytes of the
// plan (ops/gp.py::tridiag_plan) and refuses a plan that differs from what
// its kernel needs, so that the plan the CPU tests check is the launch.
bool bad_launch(int threads, int smem, int want_threads, size_t want_smem) {
  return threads != want_threads || smem < 0 || static_cast<size_t>(smem) != want_smem;
}

template <typename T, int BP>
int factor_warp(const T* d, const T* e, T* ld, T* m, int np, int nb, int b, int threads,
                int smem, cudaStream_t stream) {
  constexpr size_t tile = static_cast<size_t>(BP) * kStride<T, BP>;
  const size_t want = sizeof(T) * ((2 * kFactorStages + 4) * tile + 2 * kStride<T, BP> + 2 * BP);
  if (bad_launch(threads, smem, 32, want)) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = tridiag_factor_warp_kernel<T, BP>;
  cudaError_t err = allow_smem(kernel, want);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<np, 32, want, stream>>>(d, e, ld, m, nb, b, whole_pieces<T>(b, {d, e, ld, m}));
  return static_cast<int>(cudaGetLastError());
}

// The factor sweep: the warp per pulsar when staged (b <= 32, no
// right-hand sides), else the per-thread route, which also takes the fused
// factor + forward sweep (q > 0).
template <typename T>
int factor_fwd(const void* dv, const void* ev, const void* xv, void* ldv, void* mv,
               void* yv, int np, int nb, int b, int q, int staged, int threads, int smem,
               cudaStream_t stream) {
  if (bad_shape(np, nb, b, q) || (staged && (b > kStagedMaxBlock || q > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* d = static_cast<const T*>(dv);
  const T* e = static_cast<const T*>(ev);
  T* ld = static_cast<T*>(ldv);
  T* m = static_cast<T*>(mv);
  if (staged) {
    switch (pow2_ceil(b)) {
      case 1: return factor_warp<T, 1>(d, e, ld, m, np, nb, b, threads, smem, stream);
      case 2: return factor_warp<T, 2>(d, e, ld, m, np, nb, b, threads, smem, stream);
      case 4: return factor_warp<T, 4>(d, e, ld, m, np, nb, b, threads, smem, stream);
      case 8: return factor_warp<T, 8>(d, e, ld, m, np, nb, b, threads, smem, stream);
      case 16: return factor_warp<T, 16>(d, e, ld, m, np, nb, b, threads, smem, stream);
      default: return factor_warp<T, 32>(d, e, ld, m, np, nb, b, threads, smem, stream);
    }
  }
  const size_t tiles = 3 * static_cast<size_t>(b) * b * sizeof(T);
  const int use_smem = tiles <= kMaxSmem;
  const size_t dyn = use_smem ? tiles : 0;
  if (bad_launch(threads, smem, kFactorThreads, dyn))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = tridiag_fwd_kernel<T, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(1, np), kFactorThreads, dyn, stream>>>(d, e, static_cast<const T*>(xv), ld, m,
                                                      static_cast<T*>(yv), nb, b, q, use_smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BP, int R, bool FWD>
int staged_solve(const T* ld, const T* m, const T* in, T* out, int np, int nb, int b, int q,
                 int cols, int threads, int smem, cudaStream_t stream) {
  constexpr int pad = 16 / static_cast<int>(sizeof(T));
  constexpr int tile = BP * kStride<T, BP>;
  const size_t want = sizeof(T) * kSolveStages * ((2 * tile + BP + pad - 1) / pad * pad);
  if (bad_launch(threads, smem, (cols * (BP / R) + 31) / 32 * 32, want))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = tridiag_staged_solve_kernel<T, BP, R, FWD>;
  cudaError_t err = allow_smem(kernel, want);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((q + cols - 1) / cols, np), threads, want, stream>>>(
      ld, m, in, out, nb, b, q, cols, whole_pieces<T>(b, {ld, m}));
  return static_cast<int>(cudaGetLastError());
}

// A staged substitution sweep over blocks rounded up to BP: a lane per row
// (R = 1) or the fewest lanes, each owning R = min(BP, 16) rows.
template <typename T, int BP, bool FWD>
int staged_solve_rows(const T* ld, const T* m, const T* in, T* out, int np, int nb, int b,
                      int q, int lanes, int cols, int threads, int smem, cudaStream_t stream) {
  constexpr int RMAX = BP < kSolveMaxRows ? BP : kSolveMaxRows;
  if (lanes == BP)
    return staged_solve<T, BP, 1, FWD>(ld, m, in, out, np, nb, b, q, cols, threads, smem, stream);
  if (lanes == BP / RMAX)
    return staged_solve<T, BP, RMAX, FWD>(ld, m, in, out, np, nb, b, q, cols, threads, smem,
                                          stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A substitution sweep: the staged route when lanes > 0 (b <= 32, lanes
// b' or b' / min(b', 16), at most kSolveMaxThreads threads a block), the
// per-thread route when lanes is 0.
template <typename T, bool FWD>
int solve(const void* ldv, const void* mv, const void* inpv, void* outv, int np, int nb,
          int b, int q, int lanes, int cols, int threads, int smem, cudaStream_t stream) {
  if (bad_shape(np, nb, b, q) || q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* ld = static_cast<const T*>(ldv);
  const T* m = static_cast<const T*>(mv);
  const T* in = static_cast<const T*>(inpv);
  T* out = static_cast<T*>(outv);
  if (lanes == 0) {
    if (cols != kColumnThreads || bad_launch(threads, smem, kColumnThreads, 0))
      return static_cast<int>(cudaErrorInvalidConfiguration);
    const int groups = (q + kColumnThreads - 1) / kColumnThreads;
    if constexpr (FWD)
      tridiag_fwd_kernel<T, false><<<dim3(groups, np), kColumnThreads, 0, stream>>>(
          nullptr, nullptr, in, const_cast<T*>(ld), const_cast<T*>(m), out, nb, b, q, 0);
    else
      tridiag_bwd_kernel<T><<<dim3(groups, np), kColumnThreads, 0, stream>>>(
          ld, m, in, out, nb, b, q);
    return static_cast<int>(cudaGetLastError());
  }
  if (b > kStagedMaxBlock || lanes < 1 || cols < 1 || cols * lanes > kSolveMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pow2_ceil(b)) {
    case 1: return staged_solve_rows<T, 1, FWD>(ld, m, in, out, np, nb, b, q, lanes, cols, threads, smem, stream);
    case 2: return staged_solve_rows<T, 2, FWD>(ld, m, in, out, np, nb, b, q, lanes, cols, threads, smem, stream);
    case 4: return staged_solve_rows<T, 4, FWD>(ld, m, in, out, np, nb, b, q, lanes, cols, threads, smem, stream);
    case 8: return staged_solve_rows<T, 8, FWD>(ld, m, in, out, np, nb, b, q, lanes, cols, threads, smem, stream);
    case 16: return staged_solve_rows<T, 16, FWD>(ld, m, in, out, np, nb, b, q, lanes, cols, threads, smem, stream);
    default: return staged_solve_rows<T, 32, FWD>(ld, m, in, out, np, nb, b, q, lanes, cols, threads, smem, stream);
  }
}

// ------------------------------- the factor sweep's adjoint, float64
//
// Two kernels that replace no TPU kernel: the JAX package differentiates
// its factor's scan with XLA, and these are how the port differentiates
// the factor sweep (ops/gp.py::TridiagFactor, TridiagFactorAdjoint) with no
// Python loop over block columns on the card. L = tril(Ld_k), Lp = L_{k-1},
// Li = L^-1, Phi(X) = tril(X) with its diagonal halved, Sym(X) = Phi(X) +
// Phi(X)^T (X's lower triangle mirrored).
//
// Kernel 1 (tridiag_factor_adjoint_kernel) is the reverse sweep k = nb - 1
// ... 0 with the carry C (zero at first): Lbar = tril(gLd_k + C) (written:
// kernel 2 reads it), X = L^T Lbar, G = Li^T Phi(X) Li, S2 = G + G^T, gD_k =
// tril(S2) - diag(G) and, for k >= 1, W = (gM_k - S2 M_k) Lp^-1 = gE_{k-1}
// and the next carry -W^T M_k. With the input-only terms of column k
//   A = gM_k Lp^-1, B = M_k Lp^-1, V1 = Li M_k, U1 = V1 Lp^-1, P = A^T M_k,
// W = A - S2 B and the carry is -P + U1^T (Sym(X) V1): the chain from one
// block column to the next is three dependent b x b products, T = Sym(X)
// V1, C = -P + U1^T T and X = L^T tril(gLd + C).
//
// Kernel 2 (tridiag_factor_adjoint_vjp_kernel) is kernel 1's adjoint, the
// forward sweep k = 0 ... nb - 1 of the cotangents hD, hE of its outputs.
// It reads kernel 1's outputs for S2 = gD + gD^T (bit for bit kernel 1's
// G + G^T) and W = gE_{k-1}, so it recomputes nothing of kernel 1's column.
// With the pending cotangent Ch = tril(Lp Ah_{k-1}) of the last column,
// Lp^-1 Ch = Ah_{k-1}, so with the input-only terms
//   Q0 = hE_{k-1} Lp^-T, Vm = Li M_k, Q1 = Li Q0, H0 = Li Sym(hD_k) Li^T
// the chain is two dependent products a column:
//   X2 = Q1 - Vm Ah_{k-1}^T,  Z = H0 - X2 Vm^T - Vm X2^T,  Ah = Phi(Z)
// (Z_0 = H0_0), and what feeds the outputs but no later column is off it:
//   V = Q0 - M_k Ah_{k-1}^T = hgM_k,  Ch = tril(L Ah) = hgLd_k,  Y = L Sym(Z),
//   hM_k = -W Ch_{k-1} - S2 V,  hLd_{k-1} = P_{k-1} - tril(W^T V),
//   P_k = tril(-S2 Y + Lbar Ah^T),  hLd_{nb-1} = P_{nb-1}.
//
// Bound. Bytes (each input read once, each output written once: 0.121 ms
// for kernel 1 and 0.202 for kernel 2 at config B's 68 x 485 x 16 on an
// H100), but each sweep is a recurrence over the block columns, so the
// chain's latency comes first: every block column waits for the last.
//
// Design (b' = 16 for b <= 16, else 32: a template width, whole m16n8k8
// tiles, every loop unrolled). One block of 16 warps per pulsar, in steps
// of one block column:
// * the chain, 2 warps, one 16 x 8 output tile each at b' = 16: every
//   product on DMMA (mma.sync m16n8k8 f64, the two k steps of a tile in
//   separate accumulators), a barrier over these warps only between its
//   products;
// * 2 inverse warps: L^-1 by substitution, a lane per column and the
//   diagonal's reciprocals, each inverse split over two steps on one warp
//   (one warp starts a column while the other finishes the last), done
//   three columns ahead of the chain in kernel 1, two in kernel 2;
// * 12 worker warps, one 16 x 8 tile of one product a job: every
//   input-only product one column ahead of the chain (kernel 1's A, B,
//   V1, U1, P; kernel 2's Q0, Vm, Q1, H0) and the outputs one column
//   behind it (kernel 1's G, gD, W; kernel 2's V, Ch, Y, P, hM, hLd), with
//   a barrier over the workers only between their phases;
// * each block column's input tiles arrive by cp.async (16 bytes a copy,
//   issued by every thread) seven block columns ahead in kernel 1, six in
//   kernel 2, into a ring of eight slots whose padding (identity on L's
//   diagonal, zero elsewhere) is written once; two steps' copies stay in
//   flight at a barrier.
// One block barrier per step joins the roles. The input-only terms run in
// the chain's block, not in a pre-pass kernel over every (pulsar, column)
// pair: kernels/tridiag_study.py's build without them saves 0.20 ms of
// kernel 1 and 0.19 of kernel 2 at config B on an H100, no more than a
// pre-pass would spend writing them to device memory and reading them back
// (6 and 5 tiles a column: 0.24 and 0.20 ms at 3.35 TB/s). The explicit
// L^-1 products round otherwise than substitution; against the plain
// versions they stay within 1e-12 of the largest |entry| at condition
// numbers up to 1e12 (tests/test_torch_adjoint_redesign.py). Tiles are b'
// x (b' + 4) doubles, a pitch that makes the fragment loads conflict-free.
// At b' = 32 they do not fit in shared memory (kernel 2 holds 88), so
// those blocks keep them in a device scratch the wrapper allocates (the
// same code, L2's latency in place of shared memory's; on no path of the
// port). Every sum runs in a fixed order and there are no atomics: every
// run gives the same bits. A non-positive pivot upstream (a NaN L) gives
// NaN, as the plain version does.
//
// What holds them back (the study on an H100 SXM at 700 W, config B's 68 x
// 485 x 16; PERF.md): kernel 1 takes 0.96 ms (2.0 us a block column) and
// kernel 2 1.42 ms (2.9 us), against 0.121 and 0.202 ms bounds. The chain
// alone (a build without the loads, the inverses and the workers) takes
// 0.25 and 0.30 ms; the workers' phases are the longest role (2,300 and
// 2,860 cycles a step by clock64, the chain's 1,680 and 1,720), and every
// part the partial builds skip takes its share of the one SM per pulsar
// (68 of 132 busy): the outputs most, 0.34 and 0.56 ms.

constexpr int kAdjChainWarps = 2;
constexpr int kAdjInverseWarps = 2;
constexpr int kAdjWorkerWarps = 12;
constexpr int kAdjThreads = 32 * (kAdjChainWarps + kAdjInverseWarps + kAdjWorkerWarps);
constexpr int kAdjLoadRing = 8;        // slots of the input tiles, by block column
constexpr int kAdjRing = 6;            // slots of the computed tiles, by block column
constexpr int kAdjLoadWait = 2;        // load groups left in flight at a block barrier
constexpr int kAdjSharedMaxBlock = 16; // the largest b' whose tiles sit in shared memory
constexpr int kAdj1Loads = 4, kAdj1Slot = 8;  // kernel 1: input and computed tiles a column
constexpr int kAdj1Tiles = kAdjLoadRing * kAdj1Loads + kAdjRing * kAdj1Slot + 3;
constexpr int kAdj2Loads = 7, kAdj2Slot = 3;  // kernel 2: the same
constexpr int kAdj2Pairs = 5;          // kernel 2: tiles kept for two block columns
constexpr int kAdj2Tiles = kAdjLoadRing * kAdj2Loads + kAdjRing * kAdj2Slot + 2 * kAdj2Pairs + 4;
constexpr int kChainBarrier = 1, kWorkerBarrier = 2;

template <int BP>
struct AdjTile {
  static constexpr int ST = BP + 4;       // the row pitch: 4 mod 16 doubles
  static constexpr int SIZE = BP * ST;
  static constexpr int CT = BP / 8;       // 16 x 8 output tiles: CT a tile row,
  static constexpr int TILES = BP / 16 * CT;  // TILES a product
};

// Views of a tile (rows ST entries apart) as a DMMA operand
template <int ST> struct Mat {
  const double* p;
  __device__ __forceinline__ double operator()(int i, int j) const { return p[i * ST + j]; }
};
template <int ST> struct Tr {
  const double* p;
  __device__ __forceinline__ double operator()(int i, int j) const { return p[j * ST + i]; }
};
template <int ST> struct SymL {  // the lower triangle mirrored
  const double* p;
  __device__ __forceinline__ double operator()(int i, int j) const {
    return i >= j ? p[i * ST + j] : p[j * ST + i];
  }
};
template <int ST> struct PhiL {  // Phi
  const double* p;
  __device__ __forceinline__ double operator()(int i, int j) const {
    return i > j ? p[i * ST + j] : (i == j ? 0.5 * p[i * ST + i] : 0.0);
  }
};
template <int ST> struct PhiT {  // Phi transposed
  const double* p;
  __device__ __forceinline__ double operator()(int i, int j) const {
    return j > i ? p[j * ST + i] : (i == j ? 0.5 * p[i * ST + i] : 0.0);
  }
};
template <int ST> struct PlusT {  // G + G^T
  const double* p;
  __device__ __forceinline__ double operator()(int i, int j) const {
    return p[i * ST + j] + p[j * ST + i];
  }
};
template <int ST> struct S2FromGD {  // gD + gD^T, gD = tril(G + G^T) - diag(G)
  const double* p;
  __device__ __forceinline__ double operator()(int i, int j) const {
    return i == j ? 2.0 * p[i * ST + i] : (i > j ? p[i * ST + j] : p[j * ST + i]);
  }
};
template <class F> struct Neg {
  F f;
  __device__ __forceinline__ double operator()(int i, int j) const { return -f(i, j); }
};
template <class F> __device__ __forceinline__ Neg<F> neg(F f) { return {f}; }

__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// d += A[16 ti.., :] B[:, 8 tj..], the 16 x 8 output tile (ti, tj) on DMMA
// m16n8k8: with g = lane / 4 and t = lane % 4, d[2 h + i] is the sum at
// (row 16 ti + g + 8 h, column 8 tj + 2 t + i). The k steps of 8 alternate
// between two chains summed at the end, so a tile at b' = 16 is two
// independent instructions.
template <int BP, class FA, class FB>
__device__ __forceinline__ void mma_tile(double (&d)[4], FA a, FB b, int ti, int tj) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = 16 * ti + g, c = 8 * tj + g;
  double e[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 0; k < BP; k += 8) {
    const double af[4] = {a(r, k + t), a(r + 8, k + t), a(r, k + t + 4), a(r + 8, k + t + 4)};
    const double bf[2] = {b(k + t, c), b(k + t + 4, c)};
    dmma(k & 8 ? e : d, af, bf);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += e[i];
}

// Where a thread's fragment entries lie, and what it does with them
__device__ __forceinline__ void frag_coord(int ti, int tj, int i, int& row, int& col) {
  const int lane = threadIdx.x & 31;
  row = 16 * ti + (lane >> 2) + 8 * (i >> 1);
  col = 8 * tj + 2 * (lane & 3) + (i & 1);
}
template <int ST>
__device__ __forceinline__ void frag_load(double (&d)[4], const double* t, int ti, int tj,
                                          double s = 1.0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c;
    frag_coord(ti, tj, i, r, c);
    d[i] = s * t[r * ST + c];
  }
}
template <int ST>
__device__ __forceinline__ void frag_store(double* t, const double (&d)[4], int ti, int tj) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c;
    frag_coord(ti, tj, i, r, c);
    t[r * ST + c] = d[i];
  }
}
// Zero the fragment's entries above the diagonal
__device__ __forceinline__ void frag_tril(double (&d)[4], int ti, int tj) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c;
    frag_coord(ti, tj, i, r, c);
    if (c > r) d[i] = 0.0;
  }
}
// The fragment's entries inside the b x b block `g` (rows b apart)
__device__ __forceinline__ void frag_out(double* g, const double (&d)[4], int ti, int tj, int b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c;
    frag_coord(ti, tj, i, r, c);
    if (r < b && c < b) g[r * b + c] = d[i];
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// A b x b block (rows b apart) into a tile, its lower triangle only when
// `lower`: by cp.async into shared memory (16 bytes a copy where b = b'),
// or copied into the scratch. `part` staggers the threads over the tiles
// of one step.
template <int BP, bool SCRATCH>
__device__ __forceinline__ void adj_stage(double* dst, const double* src, int b, bool lower,
                                          int part) {
  constexpr int ST = AdjTile<BP>::ST;
  int first = static_cast<int>(threadIdx.x) - part * (BP * BP / 2) % kAdjThreads;
  if (first < 0) first += kAdjThreads;
  if (!SCRATCH && b == BP) {
    for (int e = first; e < BP * BP / 2; e += kAdjThreads) {
      const int i = e / (BP / 2), j = 2 * (e % (BP / 2));
      if (lower && j > i) continue;
      if (lower && j == i) cp_async<8>(dst + i * ST + j, src + i * BP + j);  // j + 1 > i
      else cp_async16(dst + i * ST + j, src + i * BP + j);
    }
    return;
  }
  for (int e = first; e < b * b; e += kAdjThreads) {
    const int i = e / b, j = e - i * b;
    if (lower && j > i) continue;
    if constexpr (SCRATCH) dst[i * ST + j] = src[e];
    else cp_async<8>(dst + i * ST + j, src + e);
  }
}

// Every tile zero, then 1 on the padded diagonal of each load slot's L
// (the first tile of each slot)
template <int BP>
__device__ void adj_init(double* base, int tiles, int loads, int b) {
  constexpr int ST = AdjTile<BP>::ST, SIZE = AdjTile<BP>::SIZE;
  for (int e = threadIdx.x; e < tiles * SIZE; e += kAdjThreads) base[e] = 0.0;
  __syncthreads();
  for (int e = threadIdx.x; e < kAdjLoadRing * (BP - b); e += kAdjThreads) {
    const int s = e / (BP - b), i = b + e % (BP - b);
    base[s * loads * SIZE + i * ST + i] = 1.0;
  }
}

// Substitution steps J0 .. J1 - 1 of li = l^-1 for a lower-triangular
// tile: lane c carries column c in registers, each step its own
// diagonal's reciprocal times the running sum, starting from the identity
// (J0 = 0) or from li's column as the last part left it (lanes past b'
// repeat a column). One inverse takes two parts on two steps.
template <int BP, int J0, int J1>
__device__ __forceinline__ void adj_invert(double* li, const double* l) {
  constexpr int ST = AdjTile<BP>::ST;
  const int lane = threadIdx.x & 31, c = lane & (BP - 1);
  const double rd = 1.0 / l[c * ST + c];
  double x[BP];
#pragma unroll
  for (int i = 0; i < BP; ++i) x[i] = J0 == 0 ? (i == c ? 1.0 : 0.0) : li[i * ST + c];
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    x[j] *= __shfl_sync(0xffffffffu, rd, j);
#pragma unroll
    for (int i = j + 1; i < BP; ++i) x[i] = fma(-l[i * ST + j], x[j], x[i]);
  }
  if (lane < BP)
#pragma unroll
    for (int i = J0; i < BP; ++i) li[i * ST + c] = x[i];
}

// The inverse warps' share of step k: warp k % 2 starts L_q^-1 (q = the
// column it is given), the other warp finishes the one it started a step
// before (q_last)
template <int BP>
__device__ __forceinline__ void adj_inverse_step(int k, int iw, int q, int q_last, int nb,
                                                 double* li_q, const double* l_q,
                                                 double* li_last, const double* l_last) {
  if ((k & 1) == iw) {
    if (q >= 0 && q < nb) adj_invert<BP, 0, BP / 2>(li_q, l_q);
  } else if (q_last >= 0 && q_last < nb) {
    adj_invert<BP, BP / 2, BP>(li_last, l_last);
  }
}

template <int BP, bool SCRATCH>
__global__ void __launch_bounds__(kAdjThreads, 1)
tridiag_factor_adjoint_kernel(const double* __restrict__ ld, const double* __restrict__ m,
                              const double* __restrict__ gld, const double* __restrict__ gm,
                              double* __restrict__ gd, double* __restrict__ ge,
                              double* __restrict__ lbar, double* scratch, int nb, int b) {
  using AT = AdjTile<BP>;
  constexpr int ST = AT::ST, CT = AT::CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const base = SCRATCH ? scratch + blockIdx.x * static_cast<size_t>(kAdj1Tiles) * AT::SIZE
                               : reinterpret_cast<double*>(smem_raw);
  const size_t bb = static_cast<size_t>(b) * b, p = blockIdx.x;
  ld += p * nb * bb;
  m += p * nb * bb;
  gld += p * nb * bb;
  gm += p * nb * bb;
  gd += p * nb * bb;
  lbar += p * nb * bb;
  ge += p * (nb - 1) * bb;
  // a column's input tiles ...
  enum { kL, kM, kGLd, kGM };
  const auto in = [&](int col, int which) {
    return base + ((col % kAdjLoadRing) * kAdj1Loads + which) * AT::SIZE;
  };
  // ... its computed tiles (L^-1, the input-only terms, X, Lbar) ...
  enum { kLi, kA, kB, kV1, kU1, kP, kX, kLbar };
  double* const ring = base + kAdjLoadRing * kAdj1Loads * AT::SIZE;
  const auto at = [&](int col, int which) {
    return ring + ((col % kAdjRing) * kAdj1Slot + which) * AT::SIZE;
  };
  // ... and those of one step
  double* const tT = ring + kAdjRing * kAdj1Slot * AT::SIZE;  // the chain's Sym(X) V1
  double* const tF = tT + AT::SIZE;                           // Phi(X) Li
  double* const tG = tF + AT::SIZE;                           // G
  const int warp = threadIdx.x >> 5;
  adj_init<BP>(base, kAdj1Tiles, kAdj1Loads, b);
  __syncthreads();
  // Step k: the chain runs column k, the inverse warps columns k - 4 and k
  // - 3, the workers the input-only terms of column k - 1 and the outputs
  // of column k + 1; column k - 7 is loaded.
  for (int k = nb + 6; k >= -1; --k) {
    if (k >= 7 && k - 7 < nb) {
      const int q = k - 7;
      adj_stage<BP, SCRATCH>(in(q, kL), ld + q * bb, b, true, 0);
      adj_stage<BP, SCRATCH>(in(q, kGLd), gld + q * bb, b, false, 1);
      if (q) {
        adj_stage<BP, SCRATCH>(in(q, kM), m + q * bb, b, false, 2);
        adj_stage<BP, SCRATCH>(in(q, kGM), gm + q * bb, b, false, 3);
      }
    }
    cp_async_commit();
    if (warp < kAdjChainWarps) {
      if (k >= 0 && k < nb) {
        const bool carry = k + 1 < nb;
        if (carry)
          for (int t = warp; t < AT::TILES; t += kAdjChainWarps) {
            double d[4] = {};
            mma_tile<BP>(d, SymL<ST>{at(k + 1, kX)}, Mat<ST>{at(k + 1, kV1)}, t / CT, t % CT);
            frag_store<ST>(tT, d, t / CT, t % CT);
          }
        named_barrier(kChainBarrier, 32 * kAdjChainWarps);
        for (int t = warp; t < AT::TILES; t += kAdjChainWarps) {
          const int ti = t / CT, tj = t % CT;
          double c[4] = {}, g[4];
          if (carry) {
            frag_load<ST>(c, at(k + 1, kP), ti, tj, -1.0);
            mma_tile<BP>(c, Tr<ST>{at(k + 1, kU1)}, Mat<ST>{tT}, ti, tj);
          }
          frag_load<ST>(g, in(k, kGLd), ti, tj);
#pragma unroll
          for (int i = 0; i < 4; ++i) g[i] += c[i];
          frag_tril(g, ti, tj);  // Lbar = tril(gLd + C)
          frag_store<ST>(at(k, kLbar), g, ti, tj);
          frag_out(lbar + k * bb, g, ti, tj, b);
        }
        named_barrier(kChainBarrier, 32 * kAdjChainWarps);
        for (int t = warp; t < AT::TILES; t += kAdjChainWarps) {
          double d[4] = {};
          mma_tile<BP>(d, Tr<ST>{in(k, kL)}, Mat<ST>{at(k, kLbar)}, t / CT, t % CT);
          frag_store<ST>(at(k, kX), d, t / CT, t % CT);
        }
      }
    } else if (warp < kAdjChainWarps + kAdjInverseWarps) {
      const int q = k - 4, q_last = k - 3;  // L_q^-1 is done by step q + 3
      adj_inverse_step<BP>(k, warp - kAdjChainWarps, q, q_last, nb, at(max(q, 0), kLi),
                           in(max(q, 0), kL), at(max(q_last, 0), kLi), in(max(q_last, 0), kL));
    } else {
      // a worker job: one 16 x 8 tile of one product
      const int w = warp - kAdjChainWarps - kAdjInverseWarps, pc = k - 1, oc = k + 1;
      const bool prep = pc >= 1 && pc < nb, out = oc >= 0 && oc < nb;
      // A = gM Lp^-1, B = M Lp^-1, V1 = Li M of column pc; Phi(X) Li of column oc
      const int na = (prep ? 3 : 0) + (out ? 1 : 0);
      for (int t = w; t < na * AT::TILES; t += kAdjWorkerWarps) {
        const int job = t / AT::TILES + (prep ? 0 : 3), ti = t % AT::TILES / CT, tj = t % CT;
        double d[4] = {};
        if (job == 0) {
          mma_tile<BP>(d, Mat<ST>{in(pc, kGM)}, Mat<ST>{at(pc - 1, kLi)}, ti, tj);
          frag_store<ST>(at(pc, kA), d, ti, tj);
        } else if (job == 1) {
          mma_tile<BP>(d, Mat<ST>{in(pc, kM)}, Mat<ST>{at(pc - 1, kLi)}, ti, tj);
          frag_store<ST>(at(pc, kB), d, ti, tj);
        } else if (job == 2) {
          mma_tile<BP>(d, Mat<ST>{at(pc, kLi)}, Mat<ST>{in(pc, kM)}, ti, tj);
          frag_store<ST>(at(pc, kV1), d, ti, tj);
        } else {
          mma_tile<BP>(d, PhiL<ST>{at(oc, kX)}, Mat<ST>{at(oc, kLi)}, ti, tj);
          frag_store<ST>(tF, d, ti, tj);
        }
      }
      named_barrier(kWorkerBarrier, 32 * kAdjWorkerWarps);
      // U1 = V1 Lp^-1, P = A^T M of column pc; G = Li^T Phi(X) Li of column oc
      const int nbj = (prep ? 2 : 0) + (out ? 1 : 0);
      for (int t = w; t < nbj * AT::TILES; t += kAdjWorkerWarps) {
        const int job = t / AT::TILES + (prep ? 0 : 2), ti = t % AT::TILES / CT, tj = t % CT;
        double d[4] = {};
        if (job == 0) {
          mma_tile<BP>(d, Mat<ST>{at(pc, kV1)}, Mat<ST>{at(pc - 1, kLi)}, ti, tj);
          frag_store<ST>(at(pc, kU1), d, ti, tj);
        } else if (job == 1) {
          mma_tile<BP>(d, Tr<ST>{at(pc, kA)}, Mat<ST>{in(pc, kM)}, ti, tj);
          frag_store<ST>(at(pc, kP), d, ti, tj);
        } else {
          mma_tile<BP>(d, Tr<ST>{at(oc, kLi)}, Mat<ST>{tF}, ti, tj);
          frag_store<ST>(tG, d, ti, tj);
        }
      }
      named_barrier(kWorkerBarrier, 32 * kAdjWorkerWarps);
      // gD of column oc and, for oc >= 1, W = A - S2 B = gE_{oc-1}
      if (out) {
        for (int e = threadIdx.x - 32 * (kAdjChainWarps + kAdjInverseWarps); e < b * b;
             e += 32 * kAdjWorkerWarps) {
          const int i = e / b, j = e - i * b;
          gd[oc * bb + e] = i > j ? tG[i * ST + j] + tG[j * ST + i] : (i == j ? tG[i * ST + i] : 0.0);
        }
        if (oc >= 1)
          for (int t = w; t < AT::TILES; t += kAdjWorkerWarps) {
            double d[4];
            frag_load<ST>(d, at(oc, kA), t / CT, t % CT);
            mma_tile<BP>(d, neg(PlusT<ST>{tG}), Mat<ST>{at(oc, kB)}, t / CT, t % CT);
            frag_out(ge + (oc - 1) * bb, d, t / CT, t % CT, b);
          }
      }
    }
    cp_async_wait<kAdjLoadWait>();
    __syncthreads();
  }
}

template <int BP, bool SCRATCH>
__global__ void __launch_bounds__(kAdjThreads, 1)
tridiag_factor_adjoint_vjp_kernel(const double* __restrict__ ld, const double* __restrict__ m,
                                  const double* __restrict__ lbar, const double* __restrict__ gdv,
                                  const double* __restrict__ gev, const double* __restrict__ hd,
                                  const double* __restrict__ he, double* __restrict__ hld,
                                  double* __restrict__ hm, double* __restrict__ hgld,
                                  double* __restrict__ hgm, double* scratch, int nb, int b) {
  using AT = AdjTile<BP>;
  constexpr int ST = AT::ST, CT = AT::CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const base = SCRATCH ? scratch + blockIdx.x * static_cast<size_t>(kAdj2Tiles) * AT::SIZE
                               : reinterpret_cast<double*>(smem_raw);
  const size_t bb = static_cast<size_t>(b) * b, p = blockIdx.x;
  ld += p * nb * bb;
  m += p * nb * bb;
  lbar += p * nb * bb;
  gdv += p * nb * bb;
  hd += p * nb * bb;
  hld += p * nb * bb;
  hm += p * nb * bb;
  hgld += p * nb * bb;
  hgm += p * nb * bb;
  gev += p * (nb - 1) * bb;
  he += p * (nb - 1) * bb;
  // a column's input tiles (W = gE_{k-1}) ...
  enum { kL, kM, kLbar, kGD, kW, kHD, kHE };
  const auto in = [&](int col, int which) {
    return base + ((col % kAdjLoadRing) * kAdj2Loads + which) * AT::SIZE;
  };
  // ... its computed tiles kept for up to three steps ...
  enum { kLi, kQ0, kZ };
  double* const ring = base + kAdjLoadRing * kAdj2Loads * AT::SIZE;
  const auto at = [&](int col, int which) {
    return ring + ((col % kAdjRing) * kAdj2Slot + which) * AT::SIZE;
  };
  // ... those kept for two block columns ...
  enum { kVm, kQ1, kH0, kP, kCh };
  double* const pairs = ring + kAdjRing * kAdj2Slot * AT::SIZE;
  const auto pair = [&](int col, int which) {
    return pairs + (2 * which + (col & 1)) * AT::SIZE;
  };
  // ... and those of one step
  double* const tH1 = pairs + 2 * kAdj2Pairs * AT::SIZE;  // Sym(hD) Li^T
  double* const tV = tH1 + AT::SIZE;
  double* const tY = tV + AT::SIZE;
  double* const tX2 = tY + AT::SIZE;
  const int warp = threadIdx.x >> 5;
  adj_init<BP>(base, kAdj2Tiles, kAdj2Loads, b);
  __syncthreads();
  // Step k: the chain runs column k, the inverse warps columns k + 3 and k
  // + 2, the workers the input-only terms of column k + 1 and the outputs
  // of column k - 1; column k + 6 is loaded.
  for (int k = -6; k <= nb; ++k) {
    if (k + 6 >= 0 && k + 6 < nb) {
      const int q = k + 6;
      adj_stage<BP, SCRATCH>(in(q, kL), ld + q * bb, b, true, 0);
      adj_stage<BP, SCRATCH>(in(q, kLbar), lbar + q * bb, b, true, 1);
      adj_stage<BP, SCRATCH>(in(q, kGD), gdv + q * bb, b, false, 2);
      adj_stage<BP, SCRATCH>(in(q, kHD), hd + q * bb, b, false, 3);
      if (q) {
        adj_stage<BP, SCRATCH>(in(q, kM), m + q * bb, b, false, 4);
        adj_stage<BP, SCRATCH>(in(q, kW), gev + (q - 1) * bb, b, false, 5);
        adj_stage<BP, SCRATCH>(in(q, kHE), he + (q - 1) * bb, b, false, 6);
      }
    }
    cp_async_commit();
    if (warp < kAdjChainWarps) {
      if (k >= 0 && k < nb) {
        if (k)
          for (int t = warp; t < AT::TILES; t += kAdjChainWarps) {
            double d[4];
            frag_load<ST>(d, pair(k, kQ1), t / CT, t % CT);
            mma_tile<BP>(d, neg(Mat<ST>{pair(k, kVm)}), PhiT<ST>{at(k - 1, kZ)}, t / CT, t % CT);
            frag_store<ST>(tX2, d, t / CT, t % CT);
          }
        named_barrier(kChainBarrier, 32 * kAdjChainWarps);
        for (int t = warp; t < AT::TILES; t += kAdjChainWarps) {
          const int ti = t / CT, tj = t % CT;
          double d[4];
          frag_load<ST>(d, pair(k, kH0), ti, tj);
          if (k) {  // the two products' chains side by side
            double u[4] = {}, v[4] = {};
            mma_tile<BP>(u, Mat<ST>{tX2}, Tr<ST>{pair(k, kVm)}, ti, tj);
            mma_tile<BP>(v, Mat<ST>{pair(k, kVm)}, Tr<ST>{tX2}, ti, tj);
#pragma unroll
            for (int i = 0; i < 4; ++i) d[i] = d[i] - u[i] - v[i];
          }
          frag_store<ST>(at(k, kZ), d, ti, tj);
        }
      }
    } else if (warp < kAdjChainWarps + kAdjInverseWarps) {
      const int q = k + 3, q_last = k + 2;  // L_q^-1 is done by step q - 2
      adj_inverse_step<BP>(k, warp - kAdjChainWarps, q, q_last, nb, at(max(q, 0), kLi),
                           in(max(q, 0), kL), at(max(q_last, 0), kLi), in(max(q_last, 0), kL));
    } else {
      // a worker job: one 16 x 8 tile of one product
      const int w = warp - kAdjChainWarps - kAdjInverseWarps, pc = k + 1, oc = k - 1;
      const bool prep = pc >= 0 && pc < nb, out = oc >= 0 && oc < nb;
      // Sym(hD) Li^T and, for pc >= 1, Q0 = hE Lp^-T and Vm = Li M of column
      // pc; Ch = tril(L Ah), Y = L Sym(Z) and, for oc >= 1, V = Q0 - M
      // Ah_{oc-1}^T of column oc
      const int npa = prep ? (pc ? 3 : 1) : 0, noa = out ? (oc ? 3 : 2) : 0;
      for (int t = w; t < (npa + noa) * AT::TILES; t += kAdjWorkerWarps) {
        const int j = t / AT::TILES, job = j < npa ? j : 3 + j - npa;
        const int ti = t % AT::TILES / CT, tj = t % CT;
        double d[4] = {};
        if (job == 0) {
          mma_tile<BP>(d, SymL<ST>{in(pc, kHD)}, Tr<ST>{at(pc, kLi)}, ti, tj);
          frag_store<ST>(tH1, d, ti, tj);
        } else if (job == 1) {
          mma_tile<BP>(d, Mat<ST>{in(pc, kHE)}, Tr<ST>{at(pc - 1, kLi)}, ti, tj);
          frag_store<ST>(at(pc, kQ0), d, ti, tj);
        } else if (job == 2) {
          mma_tile<BP>(d, Mat<ST>{at(pc, kLi)}, Mat<ST>{in(pc, kM)}, ti, tj);
          frag_store<ST>(pair(pc, kVm), d, ti, tj);
        } else if (job == 3) {
          mma_tile<BP>(d, Mat<ST>{in(oc, kL)}, PhiL<ST>{at(oc, kZ)}, ti, tj);
          frag_tril(d, ti, tj);
          frag_store<ST>(pair(oc, kCh), d, ti, tj);
          frag_out(hgld + oc * bb, d, ti, tj, b);
        } else if (job == 4) {
          mma_tile<BP>(d, Mat<ST>{in(oc, kL)}, SymL<ST>{at(oc, kZ)}, ti, tj);
          frag_store<ST>(tY, d, ti, tj);
        } else {
          frag_load<ST>(d, at(oc, kQ0), ti, tj);
          mma_tile<BP>(d, neg(Mat<ST>{in(oc, kM)}), PhiT<ST>{at(oc - 1, kZ)}, ti, tj);
          frag_store<ST>(tV, d, ti, tj);
          frag_out(hgm + oc * bb, d, ti, tj, b);
        }
      }
      if (out && oc == 0)  // M_0 is never read: its cotangents are zero
        for (int e = threadIdx.x - 32 * (kAdjChainWarps + kAdjInverseWarps); e < b * b;
             e += 32 * kAdjWorkerWarps)
          hm[e] = hgm[e] = 0.0;
      named_barrier(kWorkerBarrier, 32 * kAdjWorkerWarps);
      // H0 = Li Sym(hD) Li^T and, for pc >= 1, Q1 = Li Q0 of column pc;
      // P = tril(-S2 Y + Lbar Ah^T) and, for oc >= 1, hLd_{oc-1} and hM of
      // column oc
      const int npb = prep ? (pc ? 2 : 1) : 0, nob = out ? (oc ? 3 : 1) : 0;
      for (int t = w; t < (npb + nob) * AT::TILES; t += kAdjWorkerWarps) {
        const int j = t / AT::TILES, job = j < npb ? j : 2 + j - npb;
        const int ti = t % AT::TILES / CT, tj = t % CT;
        double d[4] = {};
        if (job == 0) {
          mma_tile<BP>(d, Mat<ST>{at(pc, kLi)}, Mat<ST>{tH1}, ti, tj);
          frag_store<ST>(pair(pc, kH0), d, ti, tj);
        } else if (job == 1) {
          mma_tile<BP>(d, Mat<ST>{at(pc, kLi)}, Mat<ST>{at(pc, kQ0)}, ti, tj);
          frag_store<ST>(pair(pc, kQ1), d, ti, tj);
        } else if (job == 2) {
          double e[4] = {};
          mma_tile<BP>(d, neg(S2FromGD<ST>{in(oc, kGD)}), Mat<ST>{tY}, ti, tj);
          mma_tile<BP>(e, Mat<ST>{in(oc, kLbar)}, PhiT<ST>{at(oc, kZ)}, ti, tj);
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i] += e[i];
          frag_tril(d, ti, tj);
          frag_store<ST>(pair(oc, kP), d, ti, tj);
          if (oc == nb - 1) frag_out(hld + oc * bb, d, ti, tj, b);
        } else if (job == 3) {
          frag_load<ST>(d, pair(oc - 1, kP), ti, tj);
          mma_tile<BP>(d, neg(Tr<ST>{in(oc, kW)}), Mat<ST>{tV}, ti, tj);
          frag_tril(d, ti, tj);
          frag_out(hld + (oc - 1) * bb, d, ti, tj, b);
        } else {
          double e[4] = {};
          mma_tile<BP>(d, neg(Mat<ST>{in(oc, kW)}), Mat<ST>{pair(oc - 1, kCh)}, ti, tj);
          mma_tile<BP>(e, neg(S2FromGD<ST>{in(oc, kGD)}), Mat<ST>{tV}, ti, tj);
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i] += e[i];
          frag_out(hm + oc * bb, d, ti, tj, b);
        }
      }
    }
    cp_async_wait<kAdjLoadWait>();
    __syncthreads();
  }
}

// The adjoint kernels' layout: b' and the bytes of their tiles (in shared
// memory for b' <= 16, else in the scratch, one block's share each)
int adjoint_width(int b) { return b <= kAdjSharedMaxBlock ? kAdjSharedMaxBlock : 32; }
size_t adjoint_tile_bytes(int b, bool second) {
  const int bp = adjoint_width(b);
  return sizeof(double) * (second ? kAdj2Tiles : kAdj1Tiles) * bp * (bp + 4);
}

int adjoint_launch_check(int np, int nb, int b, int threads, int smem, bool second,
                         const void* scratch) {
  if (np < 1 || np > 65535 || nb < 1 || b < 1 || b > kStagedMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = adjoint_width(b) <= kAdjSharedMaxBlock;
  if (bad_launch(threads, smem, kAdjThreads, shared ? adjoint_tile_bytes(b, second) : 0))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

const double* in(const void* p) { return static_cast<const double*>(p); }
double* out(void* p) { return static_cast<double*>(p); }

template <int BP, bool SCRATCH>
int factor_adjoint(const void* ld, const void* m, const void* gld, const void* gm, void* gd,
                   void* ge, void* lbar, void* scratch, int np, int nb, int b, int smem,
                   cudaStream_t stream) {
  auto kernel = tridiag_factor_adjoint_kernel<BP, SCRATCH>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<np, kAdjThreads, smem, stream>>>(in(ld), in(m), in(gld), in(gm), out(gd), out(ge),
                                            out(lbar), out(scratch), nb, b);
  return static_cast<int>(cudaGetLastError());
}

template <int BP, bool SCRATCH>
int factor_adjoint_vjp(const void* ld, const void* m, const void* lbar, const void* gd,
                       const void* ge, const void* hd, const void* he, void* hld, void* hm,
                       void* hgld, void* hgm, void* scratch, int np, int nb, int b, int smem,
                       cudaStream_t stream) {
  auto kernel = tridiag_factor_adjoint_vjp_kernel<BP, SCRATCH>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<np, kAdjThreads, smem, stream>>>(in(ld), in(m), in(lbar), in(gd), in(ge), in(hd),
                                            in(he), out(hld), out(hm), out(hgld), out(hgm),
                                            out(scratch), nb, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// The launches below run on `stream` (NULL: the default stream); dtype 0
// is float32, 1 float64; every operand is contiguous. Each returns the
// launch's cudaError_t; 0 means launched. The route, lanes, columns,
// threads and shared bytes are ops/gp.py::tridiag_plan's.

// FACTOR sweep: Ld, M (np, nb, b, b) and, for q > 0, Y (np, nb, b, q)
// from D (np, nb, b, b), E (np, nb - 1, b, b) and X (np, nb, b, q);
// staged = 1 runs the warp per pulsar (b <= 32, q = 0), 0 the per-thread
// route.
extern "C" int tridiag_factor_fwd_launch(const void* d, const void* e, const void* x,
                                         void* ld, void* m, void* y, int np, int nb,
                                         int b, int q, int staged, int threads, int smem,
                                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return factor_fwd<float>(d, e, x, ld, m, y, np, nb, b, q, staged, threads, smem, s);
  if (dtype == 1)
    return factor_fwd<double>(d, e, x, ld, m, y, np, nb, b, q, staged, threads, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Substitution-only forward sweep: Y from a given Ld, M and X; `lanes`
// lanes per column and `cols` columns per block (lanes = 0: the
// per-thread route).
extern "C" int tridiag_solve_fwd_launch(const void* ld, const void* m, const void* x,
                                        void* y, int np, int nb, int b, int q, int lanes,
                                        int cols, int threads, int smem, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return solve<float, true>(ld, m, x, y, np, nb, b, q, lanes, cols, threads, smem, s);
  if (dtype == 1) return solve<double, true>(ld, m, x, y, np, nb, b, q, lanes, cols, threads, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward sweep: Z from Ld, M and the forward sweep's Y, launched as the
// substitution-only forward sweep is.
extern "C" int tridiag_bwd_launch(const void* ld, const void* m, const void* y,
                                  void* z, int np, int nb, int b, int q, int lanes,
                                  int cols, int threads, int smem, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return solve<float, false>(ld, m, y, z, np, nb, b, q, lanes, cols, threads, smem, s);
  if (dtype == 1) return solve<double, false>(ld, m, y, z, np, nb, b, q, lanes, cols, threads, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The factor sweep's adjoint (kernel 1), float64: gD, gE and Lbar from Ld,
// M, gLd, gM (every operand (np, nb, b, b) but gE, (np, nb - 1, b, b)); b <=
// 32, threads and shared bytes those of ops/gp.py::tridiag_adjoint_plan,
// `scratch` the plan's device scratch (null where the plan has none).
extern "C" int tridiag_factor_adjoint_launch(const void* ld, const void* m, const void* gld,
                                             const void* gm, void* gd, void* ge, void* lbar,
                                             void* scratch, int np, int nb, int b, int threads,
                                             int smem, void* stream) {
  const int rc = adjoint_launch_check(np, nb, b, threads, smem, false, scratch);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (adjoint_width(b)) {
    case 16: return factor_adjoint<16, false>(ld, m, gld, gm, gd, ge, lbar, scratch, np, nb, b, smem, s);
    default: return factor_adjoint<32, true>(ld, m, gld, gm, gd, ge, lbar, scratch, np, nb, b, smem, s);
  }
}

// Kernel 1's adjoint (kernel 2), float64: the cotangents hLd, hM, hgLd,
// hgM of kernel 1's inputs from Ld, M, kernel 1's outputs Lbar, gD, gE and
// the cotangents hD, hE of gD and gE; launched as kernel 1 is.
extern "C" int tridiag_factor_adjoint_vjp_launch(const void* ld, const void* m, const void* lbar,
                                                 const void* gd, const void* ge, const void* hd,
                                                 const void* he, void* hld, void* hm, void* hgld,
                                                 void* hgm, void* scratch, int np, int nb, int b,
                                                 int threads, int smem, void* stream) {
  const int rc = adjoint_launch_check(np, nb, b, threads, smem, true, scratch);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (adjoint_width(b)) {
    case 16:
      return factor_adjoint_vjp<16, false>(ld, m, lbar, gd, ge, hd, he, hld, hm, hgld, hgm,
                                           scratch, np, nb, b, smem, s);
    default:
      return factor_adjoint_vjp<32, true>(ld, m, lbar, gd, ge, hd, he, hld, hm, hgld, hgm,
                                          scratch, np, nb, b, smem, s);
  }
}

extern "C" const char* block_tridiag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
