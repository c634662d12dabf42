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

extern "C" const char* block_tridiag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
