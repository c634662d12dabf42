// CW-catalog response on Hopper (sm_90a).
//
// Replaces the TPU kernel pta_replicator_tpu/ops/pallas_cw.py::
// cw_catalog_response (kernel body _cw_kernel) and its scan twin
// pta_replicator_tpu/models/batched.py::_cw_scan_response:
//
//   out[p, t] = sum_s valid[s] * nan_to_zero(response(p, s, t))
//
// on the epoch-folded planes of ops/cw.py::cw_catalog_planes, with the
// reference's op sequence (term response through log1p and the Horner
// expm1, polarization mix, F+/Fx antenna combination, the NaN guard
// applied before the valid mask).
//
// Bound. Every (pulsar, source, TOA) element costs ~100 floating-point
// operations in the chirped pulsar-term mode, each transcendental counted
// as one (ops/cw.py::OPS_PER_ELEMENT), while the bytes are only the
// (Np, Nt) times in and the (Np, Nt) sum out plus 15 planes per source:
// at the flagship 68 x 7,758 x 100 that is 5.3e9 operations against
// 4.4 MB, so the kernel is bound by operations (~79 us at 67 TFLOP/s
// float32) and not by memory (~1.3 us at 3.35 TB/s).
//
// Design. One thread per (pulsar, TOA), grid (ceil(Nt/256), Np): the
// flagship gives ~2,100 blocks over 132 SMs. A block stages the source
// planes and its own pulsar's planes in shared memory, a chunk of sources
// at a time; every thread of a warp then reads the same word (a
// broadcast), so the loop over sources runs from registers and shared
// memory only. Each thread accumulates in the working precision in
// catalog order and writes once: no atomics, and the same result on every
// run. The TPU's lane/sublane padding and VMEM budget have no counterpart.
// Built without --use_fast_math (see kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSrcChunk = 128;
// planes of ops/cw.py: SRC_PLANES and PSR_PLANES, in that order
constexpr int kSrcPlanes = 9;  // phi0_e rate_e pn_e amp_e incfac1 incfac2 sin2psi cos2psi valid
constexpr int kPsrPlanes = 6;  // fplus fcross phi0_p rate_p pn_p amp_p

__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ void m_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void m_sincos(double x, double* s, double* c) { sincos(x, s, c); }

// exp(z) - 1 as the reference computes it (pallas_cw.py::_expm1_stable):
// 8-term Horner series above -0.5, exp(z) - 1 below; NaN stays NaN.
template <typename T>
__device__ __forceinline__ T expm1_stable(T z) {
  if (!(z > T(-0.5))) return m_exp(z) - T(1);
  T series = T(1) + z / T(8);
  series = T(1) + z / T(7) * series;
  series = T(1) + z / T(6) * series;
  series = T(1) + z / T(5) * series;
  series = T(1) + z / T(4) * series;
  series = T(1) + z / T(3) * series;
  series = T(1) + z / T(2) * series;
  return z * series;
}

// phase and amplitude of one term (earth or pulsar) at fold-relative u
template <typename T, bool EVOLVE>
__device__ __forceinline__ void term_response(T u, T phi0, T rate, T pn, T amp,
                                              T& phase, T& alpha) {
  if (EVOLVE) {
    const T l = m_log1p(-rate * u);  // NaN past merger -> NaN guard
    phase = phi0 - pn * expm1_stable(T(0.625) * l);
    alpha = amp * m_exp(T(0.125) * l);
  } else {
    phase = phi0 + rate * u;
    alpha = amp;
  }
}

template <typename T>
__device__ __forceinline__ void polarized(T phase, T alpha, T inc1, T inc2,
                                          T s2p, T c2p, T& rplus, T& rcross) {
  T s, c;
  m_sincos(T(2) * phase, &s, &c);
  const T at = s * inc1;
  const T bt = c * inc2;
  rplus = alpha * (at * c2p + bt * s2p);
  rcross = alpha * (bt * c2p - at * s2p);
}

template <typename T, bool PSR_TERM, bool EVOLVE>
__global__ void __launch_bounds__(kThreads)
cw_catalog_kernel(const T* __restrict__ toas_rel, const T* __restrict__ src,
                  const T* __restrict__ psr, T* __restrict__ out,
                  int np, int nt, int ns) {
  __shared__ T s_src[kSrcPlanes][kSrcChunk];
  __shared__ T s_psr[kPsrPlanes][kSrcChunk];
  const int p = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool active = t < nt;
  // threads past the ragged edge still stage planes and meet the barriers
  const T u = active ? toas_rel[(size_t)p * nt + t] : T(0);
  T acc = T(0);
  for (int s0 = 0; s0 < ns; s0 += kSrcChunk) {
    const int n = min(kSrcChunk, ns - s0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kSrcPlanes * kSrcChunk; i += kThreads) {
      const int c = i / kSrcChunk, j = i % kSrcChunk;
      if (j < n) s_src[c][j] = src[(size_t)c * ns + s0 + j];
    }
    for (int i = threadIdx.x; i < kPsrPlanes * kSrcChunk; i += kThreads) {
      const int c = i / kSrcChunk, j = i % kSrcChunk;
      if (j < n) s_psr[c][j] = psr[((size_t)c * np + p) * ns + s0 + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const T inc1 = s_src[4][j], inc2 = s_src[5][j];
      const T s2p = s_src[6][j], c2p = s_src[7][j];
      T phase, alpha, rplus, rcross;
      term_response<T, EVOLVE>(u, s_src[0][j], s_src[1][j], s_src[2][j],
                               s_src[3][j], phase, alpha);
      polarized(phase, alpha, inc1, inc2, s2p, c2p, rplus, rcross);
      const T fplus = s_psr[0][j], fcross = s_psr[1][j];
      T res;
      if (PSR_TERM) {
        T phase_p, alpha_p, rplus_p, rcross_p;
        term_response<T, EVOLVE>(u, s_psr[2][j], s_psr[3][j], s_psr[4][j],
                                 s_psr[5][j], phase_p, alpha_p);
        polarized(phase_p, alpha_p, inc1, inc2, s2p, c2p, rplus_p, rcross_p);
        res = fplus * (rplus_p - rplus) + fcross * (rcross_p - rcross);
      } else {
        res = -fplus * rplus - fcross * rcross;
      }
      // the guard comes before the mask: NaN * 0 is NaN
      res = isnan(res) ? T(0) : res;
      acc += res * s_src[8][j];
    }
  }
  if (active) out[(size_t)p * nt + t] = acc;
}

template <typename T>
int launch(const void* toas_rel, const void* src, const void* psr, void* out,
           int np, int nt, int ns, bool psr_term, bool evolve,
           cudaStream_t stream) {
  const dim3 grid((nt + kThreads - 1) / kThreads, np);
  const dim3 block(kThreads);
  const T* a = static_cast<const T*>(toas_rel);
  const T* b = static_cast<const T*>(src);
  const T* c = static_cast<const T*>(psr);
  T* o = static_cast<T*>(out);
  if (psr_term && evolve)
    cw_catalog_kernel<T, true, true><<<grid, block, 0, stream>>>(a, b, c, o, np, nt, ns);
  else if (psr_term)
    cw_catalog_kernel<T, true, false><<<grid, block, 0, stream>>>(a, b, c, o, np, nt, ns);
  else if (evolve)
    cw_catalog_kernel<T, false, true><<<grid, block, 0, stream>>>(a, b, c, o, np, nt, ns);
  else
    cw_catalog_kernel<T, false, false><<<grid, block, 0, stream>>>(a, b, c, o, np, nt, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (NULL: the default stream). dtype 0 is float32,
// 1 float64. Returns the launch's cudaError_t; 0 means launched.
extern "C" int cw_catalog_launch(const void* toas_rel, const void* src,
                                 const void* psr, void* out, int np, int nt,
                                 int ns, int dtype, int psr_term, int evolve,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(toas_rel, src, psr, out, np, nt, ns, psr_term, evolve, s);
  if (dtype == 1)
    return launch<double>(toas_rel, src, psr, out, np, nt, ns, psr_term, evolve, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
