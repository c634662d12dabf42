"""CW-catalog response and the blocked-Cholesky trailing update: host
plane build, plain versions and CUDA kernels.

Counterpart of ``pta_replicator_tpu/ops/pallas_cw.py``: the (Nsrc x Ntoa)
continuous-wave response sum of a source catalog, and (at the end of the
module) the SYRK trailing update of ``covariance/kernels.py::
blocked_cholesky``, whose CUDA kernel is ``csrc/cov_syrk.cu``.

* :func:`cw_catalog_planes` builds the epoch-folded coefficient planes in
  float64 numpy on the host; the caller casts them last. The fold keeps
  every device time at |u| <~ 2e8 s, which is what makes the float32
  response accurate (~7.5e-4 relative RMS against float64, set by sin() of
  ~100-radian chirp phases). The planes are never recomputed on the
  device in float32.
* :func:`cw_catalog_response_plain` is the plain PyTorch version: the
  reference's per-tile op sequence over (Np, S, Nt) blocks of ``chunk``
  sources. CPU tensors run it; the on-card comparison holds the kernel
  against it.
* :func:`cw_catalog_response` dispatches: CPU tensors go to the plain
  version, CUDA tensors to the hand-written kernel in
  ``csrc/cw_catalog.cu``, which launches or raises.
* :func:`cw_catalog_plane_tiles` is the generator form of the plane build:
  host tiles of at most ``chunk`` sources, each bit for bit the column
  slice of the whole catalog's planes, for the streamed catalog.
* ``out=`` accumulates: the response of a tile of sources is added to a
  running (Np, Nt) sum, by the kernel's accumulating launch on the card
  and from that sum on, source by source in catalog order, so a catalog
  streamed tile by tile gives the monolithic launch's bits.
* :func:`cw_kernel_planes` folds the planes into the kernel's: the phase
  words in half-turns and the polarization, antenna and valid products as
  two coefficients per (pulsar, source) and term. It is the plain version
  of the fold kernel that the CUDA wrapper launches before the response.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..constants import KPC2S, MPC2S, SOLAR2S
from ..kernels import build, launches

#: per-source plane order of the (NC_SRC, Ns) earth-term operand
SRC_PLANES = (
    "phi0_e", "rate_e", "pn_e", "amp_e",
    "incfac1", "incfac2", "sin2psi", "cos2psi", "valid",
)
NC_SRC = len(SRC_PLANES)
#: per-(pulsar, source) plane order of the (NC_PSR, Np, Ns) operand
PSR_PLANES = ("fplus", "fcross", "phi0_p", "rate_p", "pn_p", "amp_p")
NC_PSR = len(PSR_PLANES)

#: floating-point operations per (pulsar, source, TOA) element, each
#: transcendental counted as one, by (psr_term, evolve). A term costs 33
#: chirped (rate*u, negate, log1p, 0.625*l, the 24-op Horner expm1,
#: pn*e, phi0-, 0.125*l, exp, amp*) or 2 linear (rate*u, +phi0); the
#: polarization mix 13 (2*phase, sin, cos, 2 products, 2 three-op
#: combinations, 2 amplitude products); the antenna combination 5 with the
#: pulsar term, else 4; the NaN guard, valid mask and accumulation 3.
OPS_PER_ELEMENT = {
    (True, True): 33 + 13 + 33 + 13 + 5 + 3,
    (False, True): 33 + 13 + 4 + 3,
    (True, False): 2 + 13 + 2 + 13 + 5 + 3,
    (False, False): 2 + 13 + 4 + 3,
}


def cw_catalog_planes(phat, gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc,
                      pdist=1.0, pphase=None, t_fold: float = 0.0,
                      evolve: bool = True, phase_approx: bool = False):
    """Epoch-folded float64 coefficient planes for the CW-catalog response.

    Parameters follow the reference API: mc in solar masses, dist in Mpc,
    fgw in Hz, pdist in kpc (scalar, (Ns,) or (Np, Ns)), optional pphase
    (pulsar-term phase, (Ns,) or (Np, Ns)), angles in radians. ``t_fold``
    is the fold epoch in absolute source-frame seconds; response times are
    ``u = t_abs - t_fold``.

    Returns numpy ``(src (NC_SRC, Ns), psr (NC_PSR, Np, Ns))`` in float64.
    """
    f64 = lambda v: np.asarray(v, dtype=np.float64)
    gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc = map(
        f64, (gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc)
    )
    phat = f64(phat)  # (Np, 3)

    from ..models.cgw import principal_axes

    m, n, omhat = principal_axes(gwtheta, gwphi)  # (Ns, 3) each
    mp = phat @ m.T  # (Np, Ns)
    np_ = phat @ n.T
    op = phat @ omhat.T
    fplus = 0.5 * (mp**2 - np_**2) / (1.0 + op)
    fcross = mp * np_ / (1.0 + op)
    cosmu = -op

    mc_s = mc * SOLAR2S
    w0 = np.pi * fgw
    phi0_orb = phase0 / 2.0
    pn = 1.0 / 32.0 / mc_s ** (5.0 / 3.0)
    amp = mc_s ** (5.0 / 3.0) / (dist * MPC2S)
    chirp = 256.0 / 5.0 * mc_s ** (5.0 / 3.0) * w0 ** (8.0 / 3.0)
    w053 = w0 ** (-5.0 / 3.0)

    if pphase is not None:
        pd_s = f64(pphase) / (2.0 * np.pi * fgw * (1.0 - cosmu))
    else:
        pd_s = f64(pdist) * KPC2S
        if pd_s.ndim < 2:
            pd_s = np.broadcast_to(pd_s, cosmu.shape)
    pd_term = pd_s * (1.0 - cosmu)  # (Np, Ns) light-travel offset [s]

    npsr = phat.shape[0]
    ones = np.ones_like(w0)

    if evolve:
        # earth term folded to t_fold; y_f <= 0 => merged before any
        # observation => source zeroed via valid (the reference's earth
        # NaN poisons the whole row)
        y_f = 1.0 - chirp * t_fold
        valid = np.where(y_f > 0.0, ones, np.zeros_like(ones))
        y_safe = np.where(y_f > 0.0, y_f, ones)
        w0e = w0 * y_safe ** (-3.0 / 8.0)
        rate_e = chirp / y_safe
        pn_e = pn * w0e ** (-5.0 / 3.0)
        amp_e = amp * w0e ** (-1.0 / 3.0)
        phi0_e = np.mod(phi0_orb + pn * (w053 - w0e ** (-5.0 / 3.0)), np.pi)

        # pulsar term: emitted earlier, so y at the fold epoch is larger
        y_fp = y_safe + chirp * pd_term  # (Np, Ns)
        w0p = w0 * y_fp ** (-3.0 / 8.0)
        rate_p = chirp / y_fp
        pn_p = pn * w0p ** (-5.0 / 3.0)
        amp_p = amp * w0p ** (-1.0 / 3.0)
        phi0_p = np.mod(phi0_orb + pn * (w053 - w0p ** (-5.0 / 3.0)), np.pi)
    elif phase_approx:
        valid = ones
        rate_e = w0 * ones
        pn_e = np.zeros_like(ones)
        amp_e = amp * w0 ** (-1.0 / 3.0)
        phi0_e = np.mod(phi0_orb + w0 * t_fold, np.pi)

        # constant pulsar-term frequency from the light-travel offset
        omega_p = w0 * (1.0 + chirp * pd_term) ** (-3.0 / 8.0)
        rate_p = omega_p
        pn_p = np.zeros_like(omega_p)
        amp_p = amp * omega_p ** (-1.0 / 3.0)
        phi0_p = np.mod(
            phi0_orb + pn * (w053 - omega_p ** (-5.0 / 3.0)) + omega_p * t_fold,
            np.pi,
        )
    else:  # monochromatic
        valid = ones
        rate_e = w0 * ones
        pn_e = np.zeros_like(ones)
        amp_e = amp * w0 ** (-1.0 / 3.0)
        phi0_e = np.mod(phi0_orb + w0 * t_fold, np.pi)

        rate_p = np.broadcast_to(w0, pd_term.shape)
        pn_p = np.zeros_like(pd_term)
        amp_p = np.broadcast_to(amp_e, pd_term.shape)
        phi0_p = np.mod(phi0_orb + w0 * (t_fold - pd_term), np.pi)

    src = np.stack([
        phi0_e, rate_e, pn_e, amp_e,
        0.5 * (3.0 + np.cos(2.0 * inc)), 2.0 * np.cos(inc),
        np.sin(2.0 * psi), np.cos(2.0 * psi),
        valid,
    ])
    bc = lambda v: np.broadcast_to(v, (npsr,) + v.shape[-1:]) if v.ndim < 2 else v
    psr = np.stack([fplus, fcross, bc(phi0_p), bc(rate_p), bc(pn_p), bc(amp_p)])
    return src, psr


def cw_catalog_plane_tiles(phat, gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc,
                           pdist=1.0, pphase=None, t_fold: float = 0.0,
                           evolve: bool = True, phase_approx: bool = False,
                           chunk: int = 65536, dtype=None):
    """Generator form of :func:`cw_catalog_planes`: host numpy tiles ``(src
    (NC_SRC, cs), psr (NC_PSR, Np, cs))`` of at most ``chunk`` sources, in
    catalog order.

    Every plane value is computed per source (the one contraction, ``phat
    @ m.T``, runs over the 3-vector axis), so each tile is bit for bit the
    column slice of the whole catalog's planes: each source window goes
    through :func:`cw_catalog_planes` with the sliced parameters. Host
    memory is O(Np x chunk). ``dtype`` (numpy) casts each tile on the host,
    rounding to nearest as the monolithic path's cast does. Counterpart of
    ``pta_replicator_tpu/ops/pallas_cw.py::cw_catalog_plane_tiles``."""
    params = [np.atleast_1d(np.asarray(x, np.float64))
              for x in (gwtheta, gwphi, mc, dist, fgw, phase0, psi, inc)]
    phat = np.asarray(phat, np.float64)
    nsrc = max(p.shape[0] for p in params)
    params = [np.broadcast_to(p, (nsrc,)) for p in params]
    pdist = np.asarray(pdist, np.float64)
    pphase = None if pphase is None else np.asarray(pphase, np.float64)
    window = lambda v, lo, hi: v if v.ndim == 0 else v[..., lo:hi]
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    for lo in range(0, nsrc, chunk):
        hi = min(lo + chunk, nsrc)
        src, psr = cw_catalog_planes(
            phat, *[p[lo:hi] for p in params], pdist=window(pdist, lo, hi),
            pphase=None if pphase is None else window(pphase, lo, hi),
            t_fold=t_fold, evolve=evolve, phase_approx=phase_approx,
        )
        if dtype is not None:
            src, psr = np.asarray(src, dtype), np.asarray(psr, dtype)
        yield src, psr


def _expm1_stable(z):
    """exp(z) - 1 as the reference computes it: an 8-term Horner series
    for z > -0.5 (the chirp domain), exp(z) - 1 below, where nothing is
    left to cancel. NaN z (past merger) stays NaN for the guard. Kept
    instead of the native expm1 because it is the reference's op
    sequence, which is what lets float64 parity reach ~1e-12."""
    small = z > -0.5
    zs = torch.where(small, z, 0.0)
    series = 1.0 + zs / 8.0
    for k in (7.0, 6.0, 5.0, 4.0, 3.0, 2.0):
        series = 1.0 + zs / k * series
    series = zs * series
    far = torch.exp(torch.where(small, 0.0, z)) - 1.0
    return torch.where(small, series, far)


def _term_response(u, phi0, rate, pn, amp, evolve: bool):
    """Phase and amplitude of one term (earth or pulsar) at fold-relative
    times ``u``; all operands broadcast against each other."""
    if evolve:
        l = torch.log1p(-rate * u)  # NaN past merger -> NaN->0 guard
        phase = phi0 - pn * _expm1_stable(0.625 * l)
        alpha = amp * torch.exp(0.125 * l)
    else:
        phase = phi0 + rate * u
        alpha = amp
    return phase, alpha


def _polarized(phase, alpha, inc1, inc2, s2p, c2p):
    At = torch.sin(2.0 * phase) * inc1
    Bt = torch.cos(2.0 * phase) * inc2
    rplus = alpha * (At * c2p + Bt * s2p)
    rcross = alpha * (Bt * c2p - At * s2p)
    return rplus, rcross


def cw_catalog_response_plain(toas_rel, src, psr, psr_term: bool = True,
                              evolve: bool = True, chunk: int = 64, out=None):
    """Summed CW response (Np, Nt) in plain PyTorch, over (Np, S, Nt)
    blocks of ``chunk`` sources in catalog order.

    ``toas_rel``: (Np, Nt) seconds relative to the fold epoch of the
    planes; ``src`` (NC_SRC, Ns) and ``psr`` (NC_PSR, Np, Ns) from
    :func:`cw_catalog_planes`, cast to the dtype of ``toas_rel``. ``out``
    (Np, Nt), when given, is the running sum the blocks are added to (it
    is not written; a new tensor is returned): tiles whose widths are
    multiples of ``chunk`` then sum bit for bit as one call over the whole
    catalog."""
    u = toas_rel[:, None, :]  # (Np, 1, Nt)
    out = torch.zeros_like(toas_rel) if out is None else out
    for lo in range(0, src.shape[1], chunk):
        s_tile = src[:, lo:lo + chunk]
        p_tile = psr[:, :, lo:lo + chunk]
        sp = lambda name: s_tile[SRC_PLANES.index(name)][None, :, None]
        pp = lambda name: p_tile[PSR_PLANES.index(name)][:, :, None]
        inc1, inc2 = sp("incfac1"), sp("incfac2")
        s2p, c2p = sp("sin2psi"), sp("cos2psi")
        phase, alpha = _term_response(
            u, sp("phi0_e"), sp("rate_e"), sp("pn_e"), sp("amp_e"), evolve
        )
        rplus, rcross = _polarized(phase, alpha, inc1, inc2, s2p, c2p)
        if psr_term:
            phase_p, alpha_p = _term_response(
                u, pp("phi0_p"), pp("rate_p"), pp("pn_p"), pp("amp_p"), evolve
            )
            rplus_p, rcross_p = _polarized(phase_p, alpha_p, inc1, inc2, s2p, c2p)
            res = pp("fplus") * (rplus_p - rplus) + pp("fcross") * (rcross_p - rcross)
        else:
            res = -pp("fplus") * rplus - pp("fcross") * rcross
        # the guard comes before the mask: NaN * 0 is NaN
        res = torch.where(torch.isnan(res), 0.0, res) * sp("valid")
        out = out + res.sum(dim=1)
    return out


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


#: the kernel planes' rows are padded to this many words (16-byte copies)
KERNEL_PLANE_ALIGN = 4
#: half-turns of sin(2 phase) per radian of phase: the kernel's sincospi
#: takes h = 2 phase / pi
_HALF_TURNS = 2.0 / math.pi


def kernel_plane_names(psr_term: bool, evolve: bool):
    """Names of the kernel planes' words per (pulsar, source), in order:
    for the earth term, then (with the pulsar term) the pulsar's, the
    phase words (``phi0h`` the phase offset in half-turns; chirped:
    ``rate`` the chirp rate in 1/s and ``pnh`` the chirp scale in
    half-turns; else ``rateh`` the rate in half-turns per second), then the
    coefficients ``q1`` and ``q2``."""
    phase = ("phi0h", "rate", "pnh") if evolve else ("phi0h", "rateh")
    return tuple(f"{name}_{term}" for term in ("e", "p")[:2 if psr_term else 1]
                 for name in (*phase, "q1", "q2"))


def kernel_plane_width(psr_term: bool, evolve: bool) -> int:
    """Words per (pulsar, source) of the kernel planes, padding included."""
    n = len(kernel_plane_names(psr_term, evolve))
    return -(-n // KERNEL_PLANE_ALIGN) * KERNEL_PLANE_ALIGN


def cw_kernel_planes(src, psr, psr_term: bool = True, evolve: bool = True):
    """The kernel's planes, (Np, Ns, kernel_plane_width) in the dtype of
    ``src``, computed in float64 from :func:`cw_catalog_planes`' planes
    (cast to the working dtype): per term (earth ``e``, pulsar ``p``)

    * the phase in half-turns, ``h = 2 phase / pi``: ``phi0h`` and, when
      chirped, ``pnh`` scaled by 2/pi (``h = phi0h - pnh expm1(...)``, and
      ``rate`` as it is for the log1p), else ``rateh`` (``h = phi0h +
      rateh u``), so the kernel reduces ``sin(2 phase)`` exactly with
      sincospi;
    * ``q1 = valid amp inc1 (F+ cos2psi - Fx sin2psi)`` and ``q2 = valid
      amp inc2 (F+ sin2psi + Fx cos2psi)``: one term's response is then
      ``a (sin(pi h) q1 + cos(pi h) q2)`` with ``a = exp(l / 8)`` chirped,
      else 1, and the element is the pulsar's minus the earth's (or minus
      the earth's), NaN-guarded.

    The padding words are zero. The CUDA wrapper computes the same
    products in the same order in its fold kernel (``csrc/cw_catalog.cu::
    cw_fold_planes_kernel``), so the two agree bit for bit."""
    s, p = src.double(), psr.double()
    sp = lambda name: s[SRC_PLANES.index(name)]  # (Ns,)
    pp = lambda name: p[PSR_PLANES.index(name)]  # (Np, Ns)
    fplus, fcross = pp("fplus"), pp("fcross")
    s2p, c2p = sp("sin2psi"), sp("cos2psi")
    valid = sp("valid")
    p1 = sp("incfac1") * (fplus * c2p - fcross * s2p)
    p2 = sp("incfac2") * (fplus * s2p + fcross * c2p)
    terms = {"e": (sp("phi0_e"), sp("rate_e"), sp("pn_e"), sp("amp_e")),
             "p": (pp("phi0_p"), pp("rate_p"), pp("pn_p"), pp("amp_p"))}
    npsr, nsrc = fplus.shape
    out = torch.zeros((npsr, nsrc, kernel_plane_width(psr_term, evolve)),
                      dtype=torch.float64, device=src.device)
    col = 0
    for term in ("e", "p")[:2 if psr_term else 1]:
        phi0, rate, pn, amp = terms[term]
        amp = amp * valid
        words = ((phi0 * _HALF_TURNS, rate, pn * _HALF_TURNS) if evolve
                 else (phi0 * _HALF_TURNS, rate * _HALF_TURNS))
        for word in (*words, amp * p1, amp * p2):
            out[..., col] = word
            col += 1
    return out.to(src.dtype)


def _bind(lib):
    lib.cw_catalog_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.cw_catalog_launch.restype = ctypes.c_int
    lib.cw_fold_planes_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.cw_fold_planes_launch.restype = ctypes.c_int
    lib.cw_kernel_plane_width.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cw_kernel_plane_width.restype = ctypes.c_int
    lib.cw_error_string.argtypes = [ctypes.c_int]
    lib.cw_error_string.restype = ctypes.c_char_p


def _check(lib, rc):
    if rc != 0:
        raise RuntimeError(
            f"cw_catalog kernel launch failed: {lib.cw_error_string(rc).decode()}"
        )


def _cw_fold(lib, src, psr, psr_term: bool, evolve: bool):
    """The kernel planes from ``lib``'s fold kernel (a build of
    ``csrc/cw_catalog.cu``), launched on the current stream over contiguous
    reference planes: :func:`cw_kernel_planes` on the card."""
    npsr, nsrc = psr.shape[1:]
    planes = torch.empty((npsr, nsrc, lib.cw_kernel_plane_width(int(psr_term), int(evolve))),
                         dtype=src.dtype, device=src.device)
    if planes.numel() == 0:  # an empty catalog: nothing to fold
        return planes
    with torch.cuda.device(src.device):
        _check(lib, lib.cw_fold_planes_launch(
            src.data_ptr(), psr.data_ptr(), planes.data_ptr(), npsr, nsrc,
            _DTYPE_CODES[src.dtype], int(psr_term), int(evolve),
            torch.cuda.current_stream().cuda_stream))
    launches["cw_fold_planes"] += 1
    return planes


def _cw_launch(lib, toas_rel, planes, psr_term: bool, evolve: bool, out=None):
    """Launch ``lib``'s response kernel (a build of ``csrc/cw_catalog.cu``)
    on the current stream over the kernel planes ``planes`` and return the
    (Np, Nt) sum; with ``out`` (a contiguous (Np, Nt) tensor of the same
    dtype and device) the accumulating launch, which adds the sum to
    ``out`` in place and returns it. Raise when the planes do not fit the
    mode or the launch is refused."""
    npsr, ntoa = toas_rel.shape
    width = lib.cw_kernel_plane_width(int(psr_term), int(evolve))
    if planes.shape != (npsr, planes.shape[1], width) or not planes.is_contiguous() \
            or planes.data_ptr() % 16:
        raise ValueError(
            f"cw_catalog_response: kernel planes {tuple(planes.shape)} do not fit "
            f"(want a contiguous, 16-byte aligned ({npsr}, Ns, {width}))"
        )
    accumulate = out is not None
    if accumulate:
        if (out.shape != toas_rel.shape or out.dtype != toas_rel.dtype
                or out.device != toas_rel.device or not out.is_contiguous()):
            raise ValueError(
                f"cw_catalog_response: the accumulator {tuple(out.shape)} {out.dtype} "
                f"does not fit (want a contiguous {tuple(toas_rel.shape)} {toas_rel.dtype} "
                f"on {toas_rel.device})"
            )
    else:
        out = torch.empty_like(toas_rel)
    with torch.cuda.device(toas_rel.device):
        _check(lib, lib.cw_catalog_launch(
            toas_rel.data_ptr(), planes.data_ptr(), out.data_ptr(),
            npsr, ntoa, planes.shape[1], _DTYPE_CODES[toas_rel.dtype], int(psr_term),
            int(evolve), int(accumulate), torch.cuda.current_stream().cuda_stream))
    launches["cw_catalog_response"] += 1
    if accumulate:
        launches["cw_catalog_accumulate"] += 1
    return out


def cw_catalog_response_cuda(toas_rel, src, psr, psr_term: bool = True,
                             evolve: bool = True, out=None):
    """Summed CW response (Np, Nt) from the CUDA kernels
    (``csrc/cw_catalog.cu``: the fold into the kernel planes, then the
    response), launched on the current stream. With ``out`` the response's
    accumulating launch adds the sum to ``out`` in place and returns it.
    Raises on a malformed input, a failed build or a refused launch."""
    tensors = (toas_rel, src, psr)
    dtype = toas_rel.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"cw_catalog_response: dtype {dtype} is neither float32 nor float64")
    if any(x.dtype != dtype or x.device != toas_rel.device for x in tensors):
        raise TypeError("cw_catalog_response: toas_rel, src and psr must share dtype and device")
    if toas_rel.device.type != "cuda":
        raise ValueError(f"cw_catalog_response_cuda needs CUDA tensors, got {toas_rel.device}")
    npsr, ntoa = toas_rel.shape
    nsrc = src.shape[1]
    if src.shape != (NC_SRC, nsrc) or psr.shape != (NC_PSR, npsr, nsrc):
        raise ValueError(
            f"cw_catalog_response: planes {tuple(src.shape)} / {tuple(psr.shape)} "
            f"do not fit {npsr} pulsars (want ({NC_SRC}, Ns) and ({NC_PSR}, {npsr}, Ns))"
        )
    if npsr > 65535:
        raise ValueError(f"cw_catalog_response: {npsr} pulsars exceed the grid's 65535 rows")
    if toas_rel.numel() == 0:
        return torch.empty_like(toas_rel) if out is None else out
    lib = build.load("cw_catalog", _bind)
    planes = _cw_fold(lib, src.contiguous(), psr.contiguous(), psr_term, evolve)
    return _cw_launch(lib, toas_rel.contiguous(), planes, psr_term, evolve, out=out)


def cw_catalog_response(toas_rel, src, psr, psr_term: bool = True,
                        evolve: bool = True, chunk: int = 64, out=None):
    """Summed CW response (Np, Nt) of the catalog, added to the running sum
    ``out`` when given. CPU tensors run the plain version (``chunk``
    sources per block; ``out`` is not written); CUDA tensors run the
    kernel, which launches (accumulating into ``out`` in place) or
    raises."""
    if toas_rel.device.type == "cpu":
        return cw_catalog_response_plain(toas_rel, src, psr, psr_term, evolve, chunk, out=out)
    return cw_catalog_response_cuda(toas_rel, src, psr, psr_term, evolve, out=out)


# --------------------------------------------------------------------
# Blocked-Cholesky trailing update (covariance/kernels.py::blocked_cholesky)
#
# The O(n^3) bulk of a blocked Cholesky factorization is the SYRK trailing
# update C <- C - L L^T after each panel factorization. Counterpart of the
# reference's ``cov_tile_update`` / ``cov_syrk_update``: only lower tiles
# are updated; strictly-upper tiles pass through (only the lower triangle
# is consumed downstream).

def cov_syrk_operations(npsr: int, m: int, b: int, tile: int) -> int:
    """Floating-point operations of one trailing update: 2 b per entry of
    the lower tiles (a multiply and an add per contraction column)."""
    nt = m // tile
    return npsr * (nt * (nt + 1) // 2) * tile * tile * 2 * b


def cov_syrk_bytes(npsr: int, m: int, b: int, tile: int, itemsize: int) -> int:
    """Bytes one trailing update must move: the entries of C's lower tiles
    read once and written once, and the panel L read once."""
    nt = m // tile
    return itemsize * npsr * (2 * (nt * (nt + 1) // 2) * tile * tile + m * b)


#: the kernel's output block (``csrc/cov_syrk.cu``: kRowsA x kBlockCols)
SYRK_BLOCK_ROWS = 128
SYRK_BLOCK_COLS = 64


def syrk_plan(m: int, tile: int):
    """The kernel's grid along one pulsar, as ``csrc/cov_syrk.cu`` launches
    it: ``(row_blocks, col_blocks, grid_x)``. Each lower tile pair is cut
    into ``row_blocks`` x ``col_blocks`` blocks of ``SYRK_BLOCK_ROWS`` x
    ``SYRK_BLOCK_COLS`` outputs (masked at the tile's edge); ``grid_x``
    blocks per pulsar, pair-major."""
    nt = m // tile
    row_blocks, col_blocks = -(-tile // SYRK_BLOCK_ROWS), -(-tile // SYRK_BLOCK_COLS)
    return row_blocks, col_blocks, nt * (nt + 1) // 2 * row_blocks * col_blocks


def cov_tile_update(c, li, lj):
    """One trailing-update tile: ``c - li @ lj^T`` over the panel's
    contraction axis, batched over the leading pulsar axis."""
    return c - torch.einsum("pik,pjk->pij", li, lj)


def _check_syrk(C, L, tile: int):
    if C.ndim != 3 or C.shape[1] != C.shape[2] or L.ndim != 3 or L.shape[:2] != C.shape[:2]:
        raise ValueError(
            f"cov_syrk_update: C {tuple(C.shape)} and L {tuple(L.shape)} do not fit "
            "(want (Np, m, m) and (Np, m, b))"
        )
    m = C.shape[-1]
    if tile < 1 or m % tile:
        raise ValueError(f"trailing dim {m} not a multiple of tile {tile}")
    if C.dtype not in _DTYPE_CODES:
        raise TypeError(f"cov_syrk_update: dtype {C.dtype} is neither float32 nor float64")
    if L.dtype != C.dtype or L.device != C.device:
        raise TypeError("cov_syrk_update: C and L must share dtype and device")


def cov_syrk_plain(C, L, tile: int = 128):
    """``C - L L^T`` on the lower (tile x tile) tiles in plain PyTorch,
    looped over the static tile grid; strictly-upper tiles pass through.
    Returns a new tensor."""
    _check_syrk(C, L, tile)
    nt = C.shape[-1] // tile
    rows = []
    for i in range(nt):
        li = L[:, i * tile:(i + 1) * tile, :]
        rows.append(torch.cat([
            cov_tile_update(C[:, i * tile:(i + 1) * tile, j * tile:(j + 1) * tile],
                            li, L[:, j * tile:(j + 1) * tile, :])
            if j <= i else C[:, i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
            for j in range(nt)
        ], dim=-1))
    return torch.cat(rows, dim=-2)


def _bind_syrk(lib):
    lib.cov_syrk_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.cov_syrk_launch.restype = ctypes.c_int
    lib.cov_syrk_error_string.argtypes = [ctypes.c_int]
    lib.cov_syrk_error_string.restype = ctypes.c_char_p


def _syrk_launch(lib, C, L, tile: int):
    """Launch ``lib``'s kernel (the build of ``csrc/cov_syrk.cu``) on the
    current stream; raise when the launch is refused."""
    npsr, m, b = L.shape
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cov_syrk_launch(C.data_ptr(), C.stride(0), C.stride(1), L.data_ptr(),
                                 npsr, m, b, tile, _DTYPE_CODES[C.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"cov_syrk kernel launch failed: {lib.cov_syrk_error_string(rc).decode()}")
    launches["cov_syrk_update"] += 1
    return C


def cov_syrk_cuda(C, L, tile: int = 128):
    """``C - L L^T`` on the lower tiles from the CUDA kernel
    (``csrc/cov_syrk.cu``), IN PLACE: C may be a view whose last axis is
    contiguous (a trailing block of a larger matrix), and is returned.
    Raises on a malformed input, a failed build or a refused launch."""
    _check_syrk(C, L, tile)
    if C.device.type != "cuda":
        raise ValueError(f"cov_syrk_cuda needs CUDA tensors, got {C.device}")
    npsr, m, b = L.shape
    if C.stride(2) != 1 or C.stride(1) < m or not 1 <= npsr <= 65535:
        raise ValueError(
            "cov_syrk_update: C needs contiguous rows (stride 1 along the last "
            f"axis, rows at least m apart) and 1..65535 pulsars; got strides "
            f"{C.stride()} for shape {tuple(C.shape)}"
        )
    return _syrk_launch(build.load("cov_syrk", _bind_syrk), C, L.contiguous(), tile)


def cov_syrk_update(C, L, tile: int = 128):
    """SYRK trailing update ``C - L L^T`` on the lower (tile x tile) tiles
    of ``C`` (Np, m, m) for the panel ``L`` (Np, m, b); ``m`` must be a
    multiple of ``tile``. CPU tensors run the plain version and get a new
    tensor; CUDA tensors run the kernel, which updates ``C`` in place (and
    returns it) or raises."""
    if C.device.type == "cpu":
        return cov_syrk_plain(C, L, tile)
    return cov_syrk_cuda(C, L, tile)
