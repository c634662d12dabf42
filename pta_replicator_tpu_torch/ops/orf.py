"""Overlap reduction functions, on the host in float64: the closed-form
Hellings-Downs matrix and the anisotropic spherical-harmonic basis.

Counterpart of ``pta_replicator_tpu/ops/orf.py``. The ORF depends only on
the pulsar sky positions, so it is built once per dataset in numpy; its
Cholesky factor is what the GWB mix puts on the device. The anisotropic
basis is the closed-form computational-frame integrals of Gair et al. 2014
rotated to the cosmic frame with Wigner-D matrices (Mingarelli et al. 2013,
eq. 47): alternating factorial sums and 2F1 evaluations, numerically
delicate, so they stay in float64 numpy and ``scipy.special`` as in the
JAX package. The basis is the JAX package's bit for bit: every value goes
through the same floating-point operations, and the work that depends on
one pulsar alone (its Wigner d values) or on one pair alone (its third
Euler angle) is done once rather than once per multipole.
"""
from __future__ import annotations

import functools

import numpy as np
from scipy import special as sp

#: overall ORF normalization 3/(8 pi)
NORM = 3.0 / (8.0 * np.pi)

#: n! as ``scipy.special.factorial`` gives it, for the basis's arguments
#: (all >= 0 and at most 2 lmax + 2); a table, since one scalar call of
#: scipy's costs ~30 us and the basis makes ~10^5 of them per dataset
_FACTORIALS = sp.factorial(np.arange(64))


def hellings_downs(zeta, same_pulsar: bool = False):
    """Closed-form Hellings-Downs correlation with Gamma(0+) = 1/2; for
    coincident pulsars the pulsar term doubles the value to 1."""
    x = (1.0 - np.cos(zeta)) / 2.0
    # guard log(0) at zeta=0; the x*log(x) limit is 0 there
    safe = np.where(x > 0, x, 1.0)
    val = 0.5 - x / 4.0 + 1.5 * x * np.log(safe)
    if same_pulsar:
        return np.ones_like(val)
    return val


def hellings_downs_matrix(psr_phi_theta: np.ndarray) -> np.ndarray:
    """Np x Np Hellings-Downs ORF matrix (diag = 2, off-diag =
    2 * Gamma_HD) from (Np, 2) pulsar (phi, theta) positions."""
    phi = np.asarray(psr_phi_theta[:, 0])
    theta = np.asarray(psr_phi_theta[:, 1])
    n = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
        axis=-1,
    )
    zeta = np.arccos(np.clip(n @ n.T, -1.0, 1.0))
    off = 2.0 * hellings_downs(zeta)
    eye = np.eye(len(psr_phi_theta))
    return off * (1.0 - eye) + 2.0 * eye


def angular_separation(phi1, phi2, theta1, theta2) -> float:
    """Angle between two sky positions given as (azimuth phi, polar theta)."""
    if phi1 == phi2 and theta1 == theta2:
        return 0.0
    cosz = (
        np.sin(theta1) * np.sin(theta2) * np.cos(phi1 - phi2)
        + np.cos(theta1) * np.cos(theta2)
    )
    return float(np.arccos(np.clip(cosz, -1.0, 1.0)))


# ------------------------------------------------ Gair et al. 2014 integrals

def _fact(n):
    return _FACTORIALS[n]


@functools.cache
def _gair_terms(qq, mm, ll, p_offset, i_stop, sign_base):
    """The factors of :func:`_gair_core`'s summand that do not depend on x,
    over the (i, j) grid: the numerator's lead 2^(i-j) (-1)^(...) q! (l+j)!,
    the exponents P, 2^P and the denominator."""
    ii = np.arange(i_stop)[:, None]
    jj = np.arange(mm, ll + 1)[None, :]
    P = qq - ii + jj - mm + p_offset
    sign = np.where((sign_base + jj - ii) % 2 == 0, 1.0, -1.0)
    lead = 2.0 ** (ii - jj) * sign * _fact(qq) * _fact(ll + jj)
    den = _fact(ii) * _fact(qq - ii) * _fact(jj) * _fact(ll - jj) * _fact(jj - mm) * P
    return lead, P, 2.0**P, den


def _gair_core(qq, mm, ll, x, p_offset, i_stop, sign_base):
    """Vectorized double sum shared by the four Gair integral families.

    sum over i in [0, i_stop), j in [mm, ll] of
      2^(i-j) (-1)^(sign_base + j - i) q! (l+j)! (2^P - x^P)
      / ( i! (q-i)! j! (l-j)! (j-m)! P ),   P = q - i + j - m + p_offset

    The x-free factors are evaluated once per integer signature, in the
    same order as the whole product, so the sum keeps its bits.
    """
    if i_stop <= 0 or ll < mm:
        return 0.0
    lead, P, two_p, den = _gair_terms(qq, mm, ll, p_offset, i_stop, sign_base)
    num = lead * (two_p - x**P)
    return float(np.sum(num / den))


def _f_minus00(qq, mm, ll, zeta):
    return _gair_core(qq, mm, ll, 1.0 + np.cos(zeta), 1, qq + 1, qq + mm)


def _f_minus01(qq, mm, ll, zeta):
    return _gair_core(qq, mm, ll, 1.0 + np.cos(zeta), 2, qq + 1, qq + mm)


def _f_plus00(qq, mm, ll, zeta):
    return _gair_core(qq, mm, ll, 1.0 - np.cos(zeta), 1, qq + 1, ll + qq)


def _f_plus01(qq, mm, ll, zeta):
    x = 1.0 - np.cos(zeta)
    total = _gair_core(qq, mm, ll, x, 0, qq, ll + qq)
    # boundary j-sum (the i = q term integrates to a log-free piece)
    if ll > mm:
        jj = np.arange(mm + 1, ll + 1)
        sign = np.where((ll + jj) % 2 == 0, 1.0, -1.0)
        total += float(
            np.sum(
                2.0 ** (qq - jj)
                * sign
                * _fact(ll + jj)
                * (2.0 ** (jj - mm) - x ** (jj - mm))
                / (_fact(jj) * _fact(ll - jj) * _fact(jj - mm) * (jj - mm))
            )
        )
    # logarithmic piece
    log_sign = 1.0 if (ll + mm) % 2 == 0 else -1.0
    total += (
        log_sign
        * 2.0 ** (qq - mm)
        * _fact(ll + mm)
        * np.log(2.0 / x)
        / (_fact(mm) * _fact(ll - mm))
    )
    return total


def _computational_frame_orf(mm: int, ll: int, zeta: float) -> float:
    """ORF of the (l, m) power multipole in the computational frame where
    pulsar 1 is at the pole and pulsar 2 at azimuth 0 (Gair et al. 2014),
    with the zeta = 0 / pi coincident- and antipodal-pulsar limits."""
    cz = np.cos(zeta)

    if zeta == 0.0:
        # coincident pulsars: pulsar-term doubling, only l <= 2 survive
        if ll == 0:
            return 2.0 * NORM * 0.25 * np.sqrt(4.0 * np.pi) * (1.0 + cz / 3.0)
        if ll == 1 and mm == 0:
            return -2.0 * 0.5 * NORM * np.sqrt(np.pi / 3.0) * (1.0 + cz)
        if ll == 2 and mm == 0:
            return 2.0 * 0.25 * NORM * (4.0 / 3.0) * np.sqrt(np.pi / 5.0) * cz
        return 0.0

    if zeta == np.pi and ll in (1, 2) and mm != 0:
        return 0.0
    if zeta == np.pi and ll > 2:
        return 0.0

    pref = NORM * np.sqrt((2.0 * ll + 1.0) * np.pi)

    if mm == 0:
        # the delta term exists only for l <= 2
        delta = 0.0
        if ll == 0:
            delta = 1.0 + cz / 3.0
        elif ll == 1:
            delta = -(1.0 + cz) / 3.0
        elif ll == 2:
            delta = 2.0 * cz / 15.0
        val = delta - (1.0 + cz) * _f_minus00(0, 0, ll, zeta)
        if zeta != 0.0:
            val -= (1.0 - cz) * _f_plus01(1, 0, ll, zeta)
        return 0.5 * pref * val

    if mm == 1:
        delta = 0.0
        if ll == 1:
            delta = 2.0 * np.sin(zeta) / 3.0
        elif ll == 2:
            delta = -2.0 * np.sin(zeta) / 5.0
        ratio = np.sqrt(_fact(ll - 1) / _fact(ll + 1))
        val = (
            delta
            - ((1.0 + cz) ** 1.5 / np.sqrt(1.0 - cz)) * _f_minus00(1, 1, ll, zeta)
            - ((1.0 - cz) ** 1.5 / np.sqrt(1.0 + cz)) * _f_plus01(2, 1, ll, zeta)
        )
        return 0.25 * pref * ratio * val

    # general m >= 2
    ratio = np.sqrt(_fact(ll - mm) / _fact(ll + mm))
    half = mm / 2.0
    val = (
        ((1.0 + cz) ** (half + 1.0) / (1.0 - cz) ** half) * _f_minus00(mm, mm, ll, zeta)
        - ((1.0 + cz) ** half / (1.0 - cz) ** (half - 1.0)) * _f_minus01(mm - 1, mm, ll, zeta)
        + ((1.0 - cz) ** (half + 1.0) / (1.0 + cz) ** half) * _f_plus01(mm + 1, mm, ll, zeta)
        - ((1.0 - cz) ** half / (1.0 + cz) ** (half - 1.0)) * _f_plus00(mm, mm, ll, zeta)
    )
    return -0.25 * pref * ratio * val


# ------------------------------------------- Wigner rotation to cosmic frame

def _wigner_d(l: int, m: int, k: int, theta1: float) -> float:
    """Small Wigner d^l_mk (Allen & Ottewill 1997) via the 2F1 closed form."""
    if m < k:
        return (-1.0) ** (m - k) * _wigner_d(l, k, m, theta1)
    factor = np.sqrt(
        _fact(l - k) * _fact(l + m) / (_fact(l + k) * _fact(l - m))
    )
    half = theta1 / 2.0
    part2 = (
        np.cos(half) ** (2 * l + k - m) * (-np.sin(half)) ** (m - k) / _fact(m - k)
    )
    part3 = sp.hyp2f1(m - l, -k - l, m - k + 1, -np.tan(half) ** 2)
    return float(factor * part2 * part3)


def _third_euler_angle(phi1, phi2, theta1, theta2) -> float:
    """Third rotation angle aligning the computational frame with the
    cosmic frame (branch chosen so the rotated pulsar-2 azimuth is zero)."""
    if phi1 == phi2 and theta1 == theta2:
        g = 0.0
    else:
        g = np.arctan(
            np.sin(theta2) * np.sin(phi2 - phi1)
            / (
                np.cos(theta1) * np.sin(theta2) * np.cos(phi1 - phi2)
                - np.sin(theta1) * np.cos(theta2)
            )
        )
    branch_test = (
        np.cos(g) * np.cos(theta1) * np.sin(theta2) * np.cos(phi1 - phi2)
        + np.sin(g) * np.sin(theta2) * np.sin(phi2 - phi1)
        - np.cos(g) * np.sin(theta1) * np.cos(theta2)
    )
    return float(g if branch_test >= 0 else np.pi + g)


def _rotated_gamma(m, l, phi1, g3, wigner, gamma_comp):
    """Rotate computational-frame Gamma^m'_l into the cosmic frame:
    sum_k conj(D^l_mk) Gamma_k (complex). ``g3`` is the pair's third Euler
    angle, ``wigner[(l, m, k)]`` pulsar 1's small Wigner d values."""
    total = 0.0 + 0.0j
    for idx in range(2 * l + 1):
        k = idx - l
        D = (
            np.exp(-1j * m * phi1)
            * wigner[l, m, k]
            * np.exp(-1j * k * g3)
        )
        total += np.conj(D) * gamma_comp[idx]
    return total


def _real_basis_value(m, l, phi1, g3, wigner, gamma_comp) -> float:
    """Real spherical-harmonic combination (Mingarelli et al. 2013 eq. 47)."""
    if m == 0:
        return float(_rotated_gamma(0, l, phi1, g3, wigner, gamma_comp).real)
    plus = _rotated_gamma(abs(m), l, phi1, g3, wigner, gamma_comp)
    minus = _rotated_gamma(-abs(m), l, phi1, g3, wigner, gamma_comp)
    sgn = (-1.0) ** abs(m)
    if m > 0:
        return float(((plus + sgn * minus) / np.sqrt(2.0)).real)
    return float(((plus - sgn * minus) / (np.sqrt(2.0) * 1j)).real)


def correlated_basis(psr_locs: np.ndarray, lmax: int) -> np.ndarray:
    """Stack of (lmax+1)^2 real-basis ORF matrices, shape (nlm, Np, Np).

    ``psr_locs``: (Np, 2) array of (azimuth phi, polar theta). Order of the
    leading axis is (l, m) = (0,0), (1,-1), (1,0), (1,1), (2,-2), ...,
    the order of the ``clm`` coefficients.
    """
    npsr = len(psr_locs)
    out = np.zeros(((lmax + 1) ** 2, npsr, npsr))
    # each pulsar's small Wigner d values: a function of its colatitude alone
    wigner = [
        {(ll, m, k): _wigner_d(ll, m, k, psr_locs[aa][1])
         for ll in range(lmax + 1) for m in range(-ll, ll + 1) for k in range(-ll, ll + 1)}
        for aa in range(npsr)
    ]
    for aa in range(npsr):
        for bb in range(aa, npsr):
            phi1, theta1 = psr_locs[aa]
            phi2, theta2 = psr_locs[bb]
            zeta = angular_separation(phi1, phi2, theta1, theta2)
            g3 = _third_euler_angle(phi1, phi2, theta1, theta2)
            for ll in range(lmax + 1):
                base = ll * ll  # index of (ll, m=-ll)
                # computational-frame values for m' = -l..l via
                # Gamma^{-m} = (-1)^m Gamma^{m}
                pos = [_computational_frame_orf(mm, ll, zeta) for mm in range(ll + 1)]
                neg = [(-1.0) ** mm * g for mm, g in enumerate(pos)][1:]
                gamma_comp = neg[::-1] + pos
                for idx in range(2 * ll + 1):
                    val = _real_basis_value(idx - ll, ll, phi1, g3, wigner[aa], gamma_comp)
                    out[base + idx, aa, bb] = val
                    out[base + idx, bb, aa] = val
    return out


def assemble_orf(psr_locs: np.ndarray, clm=None, lmax: int = 0) -> np.ndarray:
    """ORF matrix = 2 * sum_k clm[k] basis_k.

    Default clm = [sqrt(4 pi)] (lmax = 0) gives the isotropic
    Hellings-Downs matrix with diagonal 2.
    """
    if clm is None:
        clm = [np.sqrt(4.0 * np.pi)]
    clm = np.asarray(clm, dtype=np.float64)
    nlm = (lmax + 1) ** 2
    if clm.shape != (nlm,):
        raise ValueError(
            f"clm must have (lmax+1)^2 = {nlm} coefficients for lmax={lmax}, "
            f"got {clm.shape}"
        )
    basis = correlated_basis(psr_locs, lmax)
    return 2.0 * np.tensordot(clm, basis, axes=1)
