// CW-catalog response on Hopper (sm_90a).
//
// Replaces the TPU kernel pta_replicator_tpu/ops/pallas_cw.py::
// cw_catalog_response (kernel body _cw_kernel) and its scan twin
// pta_replicator_tpu/models/batched.py::_cw_scan_response:
//
//   out[p, t] = sum_s valid[s] * nan_to_zero(response(p, s, t))
//
// on the epoch-folded planes of ops/cw.py::cw_catalog_planes. The wrapper
// (ops/cw.py::cw_catalog_response_cuda) launches two kernels: the first
// (cw_fold_planes_kernel, one thread per (pulsar, source), in float64)
// folds those planes into the kernel's planes, bit for bit what
// ops/cw.py::cw_kernel_planes computes (its plain version): per (pulsar,
// source) and term, the phase words in half-turns and the two coefficients
//
//   q1 = valid amp inc1 (F+ cos2psi - Fx sin2psi)
//   q2 = valid amp inc2 (F+ sin2psi + Fx cos2psi)
//
// so that one term's response is a (s q1 + c q2), where (s, c) =
// sincospi(h), h = 2 phase / pi, and a = exp(l / 8) when chirped (else
// 1). The element is r_pulsar - r_earth (or -r_earth), then the NaN guard,
// then the sum in catalog order. This is the reference's function in
// another order of rounding: the polarization mix and the antenna
// products are folded out of the loop over TOAs.
//
// Bound. Every (pulsar, source, TOA) element costs ~100 floating-point
// operations of the function in the chirped pulsar-term mode, each
// transcendental counted as one (ops/cw.py::OPS_PER_ELEMENT), against
// bytes of only the (Np, Nt) times in, the (Np, Nt) sum out and 15 planes
// per source: at the flagship 68 x 7,758 x 100 that is 5.3e9 operations
// against 4.4 MB, so the function is bound by operations (~79 us at 67
// TFLOP/s float32), not by memory (~1.3 us at 3.35 TB/s). What bounds
// this code is instruction issue: each counted transcendental is tens of
// instructions. kernels/cw_study.py counts the SASS of the loop over
// sources by class (cuobjdump), every path in it once and each routine it
// calls at its call site, and turns the count into an issue time at the
// card's SM clock; chip_smoke.py prints both beside the bound. The static
// count includes code that no element of a realistic catalog takes (a
// Payne-Hanek reduction, a division's slow path, the library's log1p and
// exp past the series below), so the issue time is an upper estimate.
// Counted so, the first port of this kernel held 1,320 (float32) and
// 2,288 (float64) instructions an element in the chirped pulsar-term mode
// (504 and 978 in the loop itself, the rest in the slow paths of the
// divisions it calls): fourteen IEEE divisions (the expm1 series), two
// general sincos of ~100 rad (Cody-Waite reduction with a Payne-Hanek
// path), the library's log1p (a division in float64) and exp, and ~15
// shared loads and products an element that do not depend on the TOA.
//
// Design: what cuts the instructions (NVIDIA H100 80GB HBM3: 246 float32
// and 1,065 float64 instructions an element, counted the same way, 246
// and 349 of them in the loop itself; the flagship's response from 0.70 to
// 0.26 ms in float32 and from 1.46 to 0.62 ms in float64, PERF.md):
// * the expm1 Horner series runs on FMAs with the coefficients 1/k!, not
//   seven IEEE divisions per call;
// * log1p and exp of the chirp, whose arguments are small far from
//   merger, are short Taylor series on FMAs (|x| <= 1/32 and 1/128, under
//   half an ulp of truncation); the library's routines take the rest (near
//   merger, NaN), inlined in float32 and called in float64, as measured
//   fastest;
// * sin/cos of 2 phase is sincospi of the phase in half-turns: an exact,
//   branch-free reduction at any phase. The 2/pi scale sits in the kernel
//   planes, never in the loop;
// * the polarization and antenna products and the valid mask are folded
//   per (pulsar, source) into q1, q2 by the fold kernel, so an element
//   reads 5 staged words a term (16-byte shared loads) and combines with 3
//   products. The fold is one launch, not a PyTorch pass: ~30 small
//   PyTorch launches took ~0.45 ms of host time a call, longer than the
//   response itself at the flagship's 100 sources;
// * one TOA a thread (kToasPerThread): two or four, which read each staged
//   word once for all of them, were slower in both dtypes;
// * at most 64 registers a thread: no instance spills.
// The accumulating launch (accumulate = 1; ops/cw.py's ``out=``) starts
// each thread's sum from out[p, t] instead of zero, for the streamed
// catalog (models/batched.py::cw_stream_response), which launches once per
// tile of sources into one (Np, Nt) accumulator. The sum still runs source
// by source in catalog order, and a value stored and reloaded is exact, so
// a catalog streamed in tiles of any width gives the bits of one launch
// over the whole catalog, in both dtypes.
// A block of 128 threads covers 128 TOAs of one pulsar (grid
// (ceil(Nt / 128), Np)) and stages its pulsar's kernel planes in shared
// memory, 128 sources at a time, by 16-byte copies; every thread of a warp
// then reads the same word (a broadcast). Each thread accumulates in the
// working precision in catalog order and writes once: no atomics, and the
// same result on every run. The TPU's lane/sublane padding and VMEM budget
// have no counterpart. Built without --use_fast_math (see
// kernels/build.py): the NaN guard stays, and no transcendental is swapped
// for an approximate intrinsic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// TOAs of one pulsar a thread carries: one was the fastest in both dtypes
// (kernels/cw_study.py builds two and four, k2 and k4)
constexpr int kToasPerThread = 1;
constexpr int kSrcChunk = 128;
constexpr int kFoldThreads = 256;
// half-turns per radian of phase (h = 2 phase / pi), as ops/cw.py's
// _HALF_TURNS: the same double
constexpr double kHalfTurns = 2.0 / 3.141592653589793;
// plane rows of ops/cw.py: SRC_PLANES (phi0_e rate_e pn_e amp_e incfac1
// incfac2 sin2psi cos2psi valid) and PSR_PLANES (fplus fcross phi0_p
// rate_p pn_p amp_p)
enum { kPhi0E, kRateE, kPnE, kAmpE, kInc1, kInc2, kSin2Psi, kCos2Psi, kValid };
enum { kFplus, kFcross, kPhi0P, kRateP, kPnP, kAmpP };

// Words of the kernel planes per (pulsar, source), as
// ops/cw.py::kernel_plane_names orders them: per term (earth, then the
// pulsar's) the phase words (phi0 in half-turns; the chirp rate in 1/s
// and the chirp scale pn in half-turns when chirped, else the rate in
// half-turns per second), then q1 and q2; padded to a multiple of four.
template <bool PSR_TERM, bool EVOLVE>
struct Layout {
  static constexpr int kPhase = EVOLVE ? 3 : 2;
  static constexpr int kTerm = kPhase + 2;
  static constexpr int kWidth = ((PSR_TERM ? 2 : 1) * kTerm + 3) / 4 * 4;
};

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ void m_sincospi(float x, float* s, float* c) { sincospif(x, s, c); }
__device__ __forceinline__ void m_sincospi(double x, double* s, double* c) { sincospi(x, s, c); }

// The library's log1p and exp where the series below do not reach (near
// merger, or a NaN): inlined in float32 and called out of line in float64,
// each the faster in its dtype (kernels/cw_study.py, far_flipped).
__device__ __forceinline__ float log1p_far(float x) { return log1pf(x); }
__device__ __noinline__ double log1p_far(double x) { return log1p(x); }
__device__ __forceinline__ float exp_far(float x) { return expf(x); }
__device__ __noinline__ double exp_far(double x) { return exp(x); }

// exp(z) - 1 as the reference computes it (pallas_cw.py::_expm1_stable):
// the 8-term series above -0.5, exp(z) - 1 below; NaN stays NaN. The
// series sum_{k=1..8} z^k / k! is the reference's Horner form
// z (1 + z/2 (1 + z/3 (... (1 + z/8)))) with its divisions folded into
// the coefficients.
template <typename T>
__device__ __forceinline__ T expm1_stable(T z) {
  if (!(z > T(-0.5))) return exp_far(z) - T(1);
  T p = T(1.0 / 40320.0);
  p = fma(p, z, T(1.0 / 5040.0));
  p = fma(p, z, T(1.0 / 720.0));
  p = fma(p, z, T(1.0 / 120.0));
  p = fma(p, z, T(1.0 / 24.0));
  p = fma(p, z, T(1.0 / 6.0));
  p = fma(p, z, T(0.5));
  p = fma(p, z, T(1));
  return z * p;
}

// Terms of the Taylor series below (|argument| at most kSmallLog1p and
// kSmallExp): each truncation error is under 1e-17 relative in float64
// and 1e-8 in float32, below half an ulp.
template <typename T> struct Terms;
template <> struct Terms<float> { static constexpr int kLog1p = 5, kExp = 3; };
template <> struct Terms<double> { static constexpr int kLog1p = 11, kExp = 6; };
constexpr double kSmallLog1p = 1.0 / 32;
constexpr double kSmallExp = 1.0 / 128;

// log1p(x): for |x| <= 1/32 (x = -rate u, small far from merger) the
// series sum_{k=1..N} (-1)^(k+1) x^k / k in Horner form on FMAs, else the
// library's log1p (NaN goes there too).
template <typename T>
__device__ __forceinline__ T log1p_small(T x) {
  if (!(fabs(x) <= T(kSmallLog1p))) return log1p_far(x);
  constexpr int N = Terms<T>::kLog1p;
  T p = T(1.0 / N);
#pragma unroll
  for (int k = N - 1; k >= 1; --k) p = fma(-x, p, T(1.0 / k));
  return x * p;
}

// 1 / K!, a compile-time constant
template <int K>
struct InvFactorial { static constexpr double value = InvFactorial<K - 1>::value / K; };
template <>
struct InvFactorial<0> { static constexpr double value = 1.0; };

// sum_{k=K..N} x^(k-K) / k! in Horner form on FMAs
template <typename T, int K, int N>
__device__ __forceinline__ T exp_horner(T x) {
  if constexpr (K == N) {
    return T(InvFactorial<N>::value);
  } else {
    return fma(exp_horner<T, K + 1, N>(x), x, T(InvFactorial<K>::value));
  }
}

// exp(x): for |x| <= 1/128 the series sum_{k=0..N} x^k / k!, else the
// library's exp.
template <typename T>
__device__ __forceinline__ T exp_small(T x) {
  if (!(fabs(x) <= T(kSmallExp))) return exp_far(x);
  return exp_horner<T, 0, Terms<T>::kExp>(x);
}

// one term's response a (s q1 + c q2) at fold-relative time u, from its
// words w of the kernel planes
template <typename T, bool EVOLVE>
__device__ __forceinline__ T term_response(T u, const T* w) {
  T h, s, c;
  if (EVOLVE) {
    const T l = log1p_small(-w[1] * u);  // NaN past merger -> NaN guard
    h = w[0] - w[2] * expm1_stable(T(0.625) * l);
    m_sincospi(h, &s, &c);
    return exp_small(T(0.125) * l) * (s * w[3] + c * w[4]);
  }
  h = w[0] + w[1] * u;
  m_sincospi(h, &s, &c);
  return s * w[2] + c * w[3];
}

// The kernel planes of one (pulsar, source) per thread: ops/cw.py::
// cw_kernel_planes's float64 products in its order, each rounded (no
// contraction into FMAs), cast to T last; padding words zero.
template <typename T, bool PSR_TERM, bool EVOLVE>
__global__ void __launch_bounds__(kFoldThreads)
cw_fold_planes_kernel(const T* __restrict__ src, const T* __restrict__ psr,
                      T* __restrict__ planes, int np, int ns) {
  using L = Layout<PSR_TERM, EVOLVE>;
  const long long i = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= (long long)np * ns) return;
  const int p = static_cast<int>(i / ns), s = static_cast<int>(i % ns);
  const auto sp = [&](int c) { return static_cast<double>(src[(size_t)c * ns + s]); };
  const auto pp = [&](int c) { return static_cast<double>(psr[((size_t)c * np + p) * ns + s]); };
  const double fplus = pp(kFplus), fcross = pp(kFcross);
  const double s2p = sp(kSin2Psi), c2p = sp(kCos2Psi), valid = sp(kValid);
  const double p1 = __dmul_rn(sp(kInc1), __dsub_rn(__dmul_rn(fplus, c2p), __dmul_rn(fcross, s2p)));
  const double p2 = __dmul_rn(sp(kInc2), __dadd_rn(__dmul_rn(fplus, s2p), __dmul_rn(fcross, c2p)));
  T* row = planes + (size_t)i * L::kWidth;
  int col = 0;
#pragma unroll
  for (int term = 0; term < (PSR_TERM ? 2 : 1); ++term) {
    const double phi0 = term ? pp(kPhi0P) : sp(kPhi0E);
    const double rate = term ? pp(kRateP) : sp(kRateE);
    const double amp = __dmul_rn(term ? pp(kAmpP) : sp(kAmpE), valid);
    row[col++] = static_cast<T>(__dmul_rn(phi0, kHalfTurns));
    if (EVOLVE) {
      row[col++] = static_cast<T>(rate);
      row[col++] = static_cast<T>(__dmul_rn(term ? pp(kPnP) : sp(kPnE), kHalfTurns));
    } else {
      row[col++] = static_cast<T>(__dmul_rn(rate, kHalfTurns));
    }
    row[col++] = static_cast<T>(__dmul_rn(amp, p1));
    row[col++] = static_cast<T>(__dmul_rn(amp, p2));
  }
#pragma unroll
  for (int c = (PSR_TERM ? 2 : 1) * L::kTerm; c < L::kWidth; ++c) row[c] = T(0);
}

// At most 64 registers a thread (8 blocks an SM asked for): no instance
// spills. ptxas's own budget (48) spilled in some instances, and was no
// faster (kernels/cw_study.py, regs_own).
template <typename T, bool PSR_TERM, bool EVOLVE>
__global__ void __launch_bounds__(kThreads, 8)
cw_catalog_kernel(const T* __restrict__ toas_rel, const T* __restrict__ planes,
                  T* __restrict__ out, int nt, int ns, int accumulate) {
  using L = Layout<PSR_TERM, EVOLVE>;
  constexpr int K = kToasPerThread;
  using V = typename Vec16<T>::type;
  constexpr int W = L::kWidth;
  constexpr int kVecs = W * sizeof(T) / sizeof(V);  // 16-byte words per source
  __shared__ __align__(16) T s_w[kSrcChunk * W];
  const int p = blockIdx.y;
  const int t0 = blockIdx.x * (kThreads * K) + threadIdx.x;
  // threads past the ragged edge still stage planes and meet the barriers
  T u[K], acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k * kThreads;
    u[k] = t < nt ? toas_rel[(size_t)p * nt + t] : T(0);
    acc[k] = accumulate && t < nt ? out[(size_t)p * nt + t] : T(0);
  }
  const V* g = reinterpret_cast<const V*>(planes + (size_t)p * ns * W);
  V* sv = reinterpret_cast<V*>(s_w);
  for (int s0 = 0; s0 < ns; s0 += kSrcChunk) {
    const int n = min(kSrcChunk, ns - s0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n * kVecs; i += kThreads) sv[i] = g[(size_t)s0 * kVecs + i];
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      V wv[kVecs];
#pragma unroll
      for (int v = 0; v < kVecs; ++v) wv[v] = sv[j * kVecs + v];
      const T* w = reinterpret_cast<const T*>(wv);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T earth = term_response<T, EVOLVE>(u[k], w);
        T res = PSR_TERM ? term_response<T, EVOLVE>(u[k], w + L::kTerm) - earth : -earth;
        // the guard comes before the sum (and q1, q2 carry the valid
        // mask): a NaN term of a masked source still adds nothing
        acc[k] += isnan(res) ? T(0) : res;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k * kThreads;
    if (t < nt) out[(size_t)p * nt + t] = acc[k];
  }
}

template <typename T, bool PSR_TERM, bool EVOLVE>
int response_mode(const T* toas_rel, const T* planes, T* out, int np, int nt, int ns,
                  int accumulate, cudaStream_t stream) {
  constexpr int kSpan = kThreads * kToasPerThread;
  cw_catalog_kernel<T, PSR_TERM, EVOLVE><<<dim3((nt + kSpan - 1) / kSpan, np), kThreads, 0,
                                           stream>>>(toas_rel, planes, out, nt, ns, accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PSR_TERM, bool EVOLVE>
int fold_mode(const T* src, const T* psr, T* planes, int np, int ns, cudaStream_t stream) {
  const long long n = (long long)np * ns;
  cw_fold_planes_kernel<T, PSR_TERM, EVOLVE>
      <<<static_cast<unsigned>((n + kFoldThreads - 1) / kFoldThreads), kFoldThreads, 0, stream>>>(
          src, psr, planes, np, ns);
  return static_cast<int>(cudaGetLastError());
}

// the instance of `Fn` for (dtype, psr_term, evolve)
template <template <typename, bool, bool> class Fn, typename... Args>
int dispatch(int dtype, bool psr_term, bool evolve, Args... args) {
  if (dtype == 0) {
    if (psr_term && evolve) return Fn<float, true, true>::run(args...);
    if (psr_term) return Fn<float, true, false>::run(args...);
    if (evolve) return Fn<float, false, true>::run(args...);
    return Fn<float, false, false>::run(args...);
  }
  if (dtype == 1) {
    if (psr_term && evolve) return Fn<double, true, true>::run(args...);
    if (psr_term) return Fn<double, true, false>::run(args...);
    if (evolve) return Fn<double, false, true>::run(args...);
    return Fn<double, false, false>::run(args...);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool PSR_TERM, bool EVOLVE>
struct Response {
  static int run(const void* toas_rel, const void* planes, void* out, int np, int nt, int ns,
                 int accumulate, cudaStream_t stream) {
    return response_mode<T, PSR_TERM, EVOLVE>(static_cast<const T*>(toas_rel),
                                              static_cast<const T*>(planes), static_cast<T*>(out),
                                              np, nt, ns, accumulate, stream);
  }
};

template <typename T, bool PSR_TERM, bool EVOLVE>
struct Fold {
  static int run(const void* src, const void* psr, void* planes, int np, int ns,
                 cudaStream_t stream) {
    return fold_mode<T, PSR_TERM, EVOLVE>(static_cast<const T*>(src), static_cast<const T*>(psr),
                                          static_cast<T*>(planes), np, ns, stream);
  }
};

}  // namespace

// Both launch on `stream` (NULL: the default stream); dtype 0 is float32,
// 1 float64. Each returns the launch's cudaError_t; 0 means launched.
//
// The fold: the reference planes src (9, ns) and psr (6, np, ns) into the
// kernel planes (np, ns, cw_kernel_plane_width).
extern "C" int cw_fold_planes_launch(const void* src, const void* psr, void* planes, int np,
                                     int ns, int dtype, int psr_term, int evolve, void* stream) {
  return dispatch<Fold>(dtype, psr_term, evolve, src, psr, planes, np, ns,
                        static_cast<cudaStream_t>(stream));
}

// The response: `planes` 16-byte aligned; accumulate != 0 adds the sum to
// `out` (the accumulating launch), else writes it.
extern "C" int cw_catalog_launch(const void* toas_rel, const void* planes, void* out,
                                 int np, int nt, int ns, int dtype, int psr_term,
                                 int evolve, int accumulate, void* stream) {
  return dispatch<Response>(dtype, psr_term, evolve, toas_rel, planes, out, np, nt, ns,
                            accumulate, static_cast<cudaStream_t>(stream));
}

// The kernel planes' words per (pulsar, source) in a mode.
extern "C" int cw_kernel_plane_width(int psr_term, int evolve) {
  if (psr_term && evolve) return Layout<true, true>::kWidth;
  if (psr_term) return Layout<true, false>::kWidth;
  if (evolve) return Layout<false, true>::kWidth;
  return Layout<false, false>::kWidth;
}

extern "C" const char* cw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
