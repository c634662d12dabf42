"""CW kernel planes: the CUDA kernel's rearranged formula, evaluated in
PyTorch from ``ops/cw.py::cw_kernel_planes``, against the plain response
and the JAX package's scan twin of its Pallas kernel.

The formula below is written out here, not taken from the package: per
term, the phase in half-turns ``h``, ``(s, c) = sincospi(h)`` by an exact
reduction, ``a (s q1 + c q2)`` with ``a = exp(l / 8)`` chirped; the element
is the pulsar's term minus the earth's (or minus the earth's), NaN-guarded,
summed over sources. It is what ``csrc/cw_catalog.cu`` computes."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from _torch_parity import rel_rms
from pta_replicator_tpu.models import batched as JB
from pta_replicator_tpu_torch import flagship_workload
from pta_replicator_tpu_torch.ops import cw as tcw

#: plane modes: (evolve, phase_approx); the kernel has two phase models,
#: chirped (evolve) and linear (both of the others)
PLANE_MODES = {
    "evolve": (True, False),
    "phase_approx": (False, True),
    "monochromatic": (False, False),
}
#: fold references of the stress catalog (tests/test_torch_cw.py): one
#: half folds before the data (merging inside the span: the NaN guard),
#: one at the absolute epoch (merged: valid = 0)
TREF_MERGING = 53000 * 86400.0
TREF_MERGED = 0.0
SHAPE = dict(npsr=4, ntoa=600, ncw=24)


@pytest.fixture(scope="module")
def workload():
    batch, recipe = flagship_workload(**SHAPE, dtype=torch.float64, device="cpu")
    return batch, recipe


def _stress_catalog(n):
    """chip_smoke.py's stress ranges (heavy, high-frequency binaries) plus
    tests/test_torch_cw.py's two extra sources, one of which merges."""
    rng = np.random.default_rng(6)
    drawn = np.stack([
        np.arccos(rng.uniform(-1, 1, n)), rng.uniform(0, 2 * np.pi, n),
        10 ** rng.uniform(8.5, 9.8, n), rng.uniform(10, 500, n),
        10 ** rng.uniform(-8.0, -7.0, n), rng.uniform(0, 2 * np.pi, n),
        rng.uniform(0, np.pi, n), np.arccos(rng.uniform(-1, 1, n)),
    ])
    extra = np.array([[1.0, 2.0], [0.5, 4.0], [5e9, 1e9], [20.0, 100.0],
                      [3e-7, 1e-8], [0.3, 2.0], [0.1, 1.1], [0.7, 2.2]])
    return np.concatenate([drawn, extra], axis=1)


def _planes(batch, params, mode, tref_s):
    evolve, phase_approx = PLANE_MODES[mode]
    t_fold = batch.tref_mjd * 86400.0 - tref_s + batch.start_s
    return tcw.cw_catalog_planes(batch.phat.numpy(), *params, pdist=1.0, t_fold=t_fold,
                                 evolve=evolve, phase_approx=phase_approx)


def _catalog(batch, recipe, name, mode):
    """float64 numpy planes of the workload's own catalog, or of the
    stress catalog (its merging half beside its merged half)."""
    if name == "flagship":
        return _planes(batch, recipe.cgw_params.numpy(), mode, 0.0)
    stress = _stress_catalog(SHAPE["ncw"] // 2)
    halves = [_planes(batch, stress, mode, tref) for tref in (TREF_MERGING, TREF_MERGED)]
    return tuple(np.concatenate(p, axis=-1) for p in zip(*halves))


def _sincospi(h):
    """sin(pi h), cos(pi h) by the exact reduction in half-turns: h = n + r
    with n the nearest integer, |r| <= 1/2 (exact in floating point), and
    sin(pi h) = (-1)^n sin(pi r)."""
    n = torch.round(h)
    r = h - n
    sign = 1.0 - 2.0 * torch.remainder(n, 2.0)
    return sign * torch.sin(math.pi * r), sign * torch.cos(math.pi * r)


def _expm1_series(z):
    """exp(z) - 1 as the reference computes it: the 8-term series above
    -0.5 as a polynomial in 1/k! on multiply-adds, exp(z) - 1 below."""
    p = torch.full_like(z, 1.0 / math.factorial(8))
    for k in range(7, 0, -1):
        p = p * z + 1.0 / math.factorial(k)
    return torch.where(z > -0.5, z * p, torch.exp(z) - 1.0)


#: the kernel's short series (csrc/cw_catalog.cu): their ranges, and their
#: terms by dtype (log1p, exp)
SMALL_LOG1P, SMALL_EXP = 1.0 / 32, 1.0 / 128
SERIES_TERMS = {torch.float64: (11, 6), torch.float32: (5, 3)}


def _log1p_small(x):
    """The kernel's log1p: for |x| <= 1/32 the series sum (-1)^(k+1) x^k / k
    in Horner form, else log1p."""
    n = SERIES_TERMS[x.dtype][0]
    p = torch.full_like(x, 1.0 / n)
    for k in range(n - 1, 0, -1):
        p = -x * p + 1.0 / k
    return torch.where(x.abs() <= SMALL_LOG1P, x * p, torch.log1p(x))


def _exp_small(x):
    """The kernel's exp: for |x| <= 1/128 the series sum x^k / k! in Horner
    form, else exp."""
    n = SERIES_TERMS[x.dtype][1]
    p = torch.full_like(x, 1.0 / math.factorial(n))
    for k in range(n - 1, -1, -1):
        p = p * x + 1.0 / math.factorial(k)
    return torch.where(x.abs() <= SMALL_EXP, p, torch.exp(x))


def _kernel_formula(u, kp, psr_term, evolve, guard=True):
    """The CUDA kernel's sum over sources from the kernel planes, in the
    dtype of the inputs; ``guard=False`` skips the NaN guard."""
    names = tcw.kernel_plane_names(psr_term, evolve)
    w = lambda name: kp[..., names.index(name)][:, :, None]  # (Np, Ns, 1)
    u = u[:, None, :]  # (Np, 1, Nt)

    def term(t):
        if evolve:
            l = _log1p_small(-w(f"rate_{t}") * u)
            h = w(f"phi0h_{t}") - w(f"pnh_{t}") * _expm1_series(0.625 * l)
            a = _exp_small(0.125 * l)
        else:
            h = w(f"phi0h_{t}") + w(f"rateh_{t}") * u
            a = 1.0
        s, c = _sincospi(h)
        return a * (s * w(f"q1_{t}") + c * w(f"q2_{t}"))

    res = term("p") - term("e") if psr_term else -term("e")
    if guard:
        res = torch.where(torch.isnan(res), 0.0, res)
    return res.sum(dim=1)


@pytest.mark.parametrize("dtype,ulps", [(torch.float64, 2.0), (torch.float32, 2.0)])
def test_short_series_within_two_ulps(dtype, ulps):
    """The kernel's log1p and exp series over their whole ranges (and the
    library past them) against torch's log1p and exp in float64: within two
    ulps of the dtype, so swapping them for the library moves no digit the
    tolerances see."""
    eps = torch.finfo(dtype).eps
    x = torch.linspace(-2 * SMALL_LOG1P, 2 * SMALL_LOG1P, 40001, dtype=torch.float64)
    x = x[x != 0].to(dtype)
    want = torch.log1p(x.double())
    assert float(((_log1p_small(x).double() - want) / want).abs().max()) <= ulps * eps
    w = torch.linspace(-2 * SMALL_EXP, 2 * SMALL_EXP, 40001, dtype=torch.float64).to(dtype)
    want = torch.exp(w.double())
    assert float(((_exp_small(w).double() - want) / want).abs().max()) <= ulps * eps
    # NaN (past merger) takes the library's path and stays NaN
    nan = torch.tensor([float("nan")], dtype=dtype)
    assert bool(torch.isnan(_log1p_small(nan)).all() and torch.isnan(_exp_small(nan)).all())


def test_kernel_plane_layout():
    """Each mode's words: 5 a term chirped, 4 linear, padded to 16-byte rows
    in both dtypes (csrc/cw_catalog.cu's Layout)."""
    for psr_term in (True, False):
        for evolve in (True, False):
            names = tcw.kernel_plane_names(psr_term, evolve)
            assert len(names) == (2 if psr_term else 1) * (5 if evolve else 4)
            assert len(set(names)) == len(names)
            width = tcw.kernel_plane_width(psr_term, evolve)
            assert width % tcw.KERNEL_PLANE_ALIGN == 0 and 0 <= width - len(names) < 4
    assert tcw.kernel_plane_width(True, True) == 12
    assert tcw.kernel_plane_width(False, False) == 4


@pytest.mark.parametrize("psr_term", [True, False])
@pytest.mark.parametrize("mode", list(PLANE_MODES))
@pytest.mark.parametrize("catalog", ["flagship", "stress"])
def test_kernel_formula_float64_matches_plain_and_scan(workload, catalog, mode, psr_term):
    batch, recipe = workload
    evolve = PLANE_MODES[mode][0]
    src, psr = _catalog(batch, recipe, catalog, mode)
    u = batch.toas_s - batch.start_s
    src_t, psr_t = torch.from_numpy(src), torch.from_numpy(psr)
    kp = tcw.cw_kernel_planes(src_t, psr_t, psr_term, evolve)
    assert kp.dtype == torch.float64
    assert kp.shape == (SHAPE["npsr"], src.shape[1], tcw.kernel_plane_width(psr_term, evolve))
    got = _kernel_formula(u, kp, psr_term, evolve)
    plain = tcw.cw_catalog_response_plain(u, src_t, psr_t, psr_term, evolve)
    scan = JB._cw_scan_response(jnp.asarray(u.numpy()), jnp.asarray(src), jnp.asarray(psr),
                                psr_term, evolve, 8)
    assert bool(torch.isfinite(got).all()) and bool((got != 0).any())
    assert rel_rms(got, plain) <= 1e-12
    assert rel_rms(got, scan) <= 1e-12
    if catalog == "stress" and evolve:
        # the catalog reaches both guards: merged sources (valid = 0), and
        # elements past merger whose terms are NaN before the guard
        valid = src[tcw.SRC_PLANES.index("valid")]
        assert (valid == 0).any() and (valid == 1).any()
        assert bool(torch.isnan(_kernel_formula(u, kp, psr_term, evolve, guard=False)).any())


@pytest.mark.parametrize("psr_term", [True, False])
@pytest.mark.parametrize("mode", list(PLANE_MODES))
@pytest.mark.parametrize("catalog", ["flagship", "stress"])
def test_kernel_formula_float32_within_cw_tolerance(workload, catalog, mode, psr_term):
    """float32 planes (cast last, as the path gives them), float32 kernel
    planes and times: within the cw family tolerance of the float64 plain
    version."""
    batch, recipe = workload
    evolve = PLANE_MODES[mode][0]
    src, psr = _catalog(batch, recipe, catalog, mode)
    u64 = batch.toas_s - batch.start_s
    want = tcw.cw_catalog_response_plain(u64, torch.from_numpy(src), torch.from_numpy(psr),
                                         psr_term, evolve)
    u32 = batch.toas_s.float() - torch.tensor(batch.start_s, dtype=torch.float32)
    kp = tcw.cw_kernel_planes(torch.from_numpy(src).float(), torch.from_numpy(psr).float(),
                              psr_term, evolve)
    assert kp.dtype == torch.float32
    got = _kernel_formula(u32, kp, psr_term, evolve)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert rel_rms(got.double(), want) <= 3e-3


@pytest.mark.parametrize("mode", list(PLANE_MODES))
def test_kernel_phase_in_half_turns(workload, mode):
    """The kernel's phase words are the plain version's 2 phase / pi: at
    every (pulsar, source, TOA), pi h / 2 is the plain phase, and
    sincospi(h) by the exact reduction is sin and cos of 2 phase."""
    batch, recipe = workload
    evolve = PLANE_MODES[mode][0]
    src, psr = (torch.from_numpy(a) for a in _catalog(batch, recipe, "flagship", mode))
    kp = tcw.cw_kernel_planes(src, psr, True, evolve)
    names = tcw.kernel_plane_names(True, evolve)
    w = lambda name: kp[..., names.index(name)][:, :, None]
    sp = lambda name: src[tcw.SRC_PLANES.index(name)][None, :, None]
    pp = lambda name: psr[tcw.PSR_PLANES.index(name)][:, :, None]
    u = (batch.toas_s - batch.start_s)[:, None, :]
    for t, phase_of in (("e", sp), ("p", pp)):
        phase, _ = tcw._term_response(u, phase_of(f"phi0_{t}"), phase_of(f"rate_{t}"),
                                      phase_of(f"pn_{t}"), phase_of(f"amp_{t}"), evolve)
        if evolve:
            l = torch.log1p(-w(f"rate_{t}") * u)
            h = w(f"phi0h_{t}") - w(f"pnh_{t}") * _expm1_series(0.625 * l)
        else:
            h = w(f"phi0h_{t}") + w(f"rateh_{t}") * u
        assert float((h * (math.pi / 2) - phase).abs().max()) <= 1e-12 * float(phase.abs().max())
        s, c = _sincospi(h)
        assert float((s - torch.sin(2.0 * phase)).abs().max()) <= 1e-11
        assert float((c - torch.cos(2.0 * phase)).abs().max()) <= 1e-11
    assert float(phase.abs().max()) > 10.0  # the phases wrap many half-turns


def test_kernel_planes_fold_the_mask_and_polarization(workload):
    """q1 and q2 carry valid, amp and the polarization and antenna mix:
    a merged source (valid = 0) has zero coefficients in both terms, and
    the padding words are zero."""
    batch, recipe = workload
    src, psr = (torch.from_numpy(a) for a in _catalog(batch, recipe, "stress", "evolve"))
    kp = tcw.cw_kernel_planes(src, psr, True, True)
    names = tcw.kernel_plane_names(True, True)
    valid = src[tcw.SRC_PLANES.index("valid")]
    for q in ("q1_e", "q2_e", "q1_p", "q2_p"):
        col = kp[..., names.index(q)]
        assert bool((col[:, valid == 0] == 0).all())
        assert bool((col[:, valid == 1] != 0).all())
    assert bool((kp[..., len(names):] == 0).all())
    sp = lambda name: src[tcw.SRC_PLANES.index(name)]
    pp = lambda name: psr[tcw.PSR_PLANES.index(name)]
    want = (sp("amp_e") * sp("valid") * sp("incfac1")
            * (pp("fplus") * sp("cos2psi") - pp("fcross") * sp("sin2psi")))
    torch.testing.assert_close(kp[..., names.index("q1_e")], want, rtol=1e-15, atol=0)


def test_study_variants_edit_the_kernel_source():
    """Each partial build of kernels/cw_study.py finds the text it replaces
    in csrc/cw_catalog.cu (a build on the card raises otherwise)."""
    from pta_replicator_tpu_torch.kernels import build, cw_study

    source = (build.CSRC_DIR / "cw_catalog.cu").read_text()
    for name, edits in cw_study.VARIANTS.items():
        for old, new in edits:
            assert source.count(old) == 1, (name, old)
            assert old != new


def test_study_counts_the_source_loop_of_a_listing():
    """The SASS account on a listing of one instance: the loop over sources
    is the largest loop that reads shared memory and holds no barrier; its
    instructions are classed by opcode, a routine it calls is counted at
    each call site, and the counts are divided by the TOAs a thread."""
    from pta_replicator_tpu_torch.kernels import cw_study

    lines = ["\t\tFunction : _ZN12_GLOBAL__N_117cw_catalog_kernelIdLb1ELb1EEEvPKT_S3_PS1_ii"]
    body = ["BAR.SYNC.DEFER_BLOCKING 0x0", "STS.128 [R2], R4",
            "BRA 0x10",                                   # the staging loop: stores only
            "LDS.128 R4, [R3]", "DFMA R6, R4, R4, R6",
            "UMOV UR4, 0x1", "MUFU.RCP64H R9, R5", "FFMA R1, R2, R3, R4",
            "HFMA2.MMA R5, -RZ, RZ, 0, 0", "F2I.NTZ R2, R3",
            "CALL.REL.NOINC 0x100", "@!P2 CALL.REL.NOINC 0x100",
            "ISETP.GE.AND P0, PT, R2, R3, PT", "@P0 BRA 0x30",  # the source loop
            "@P1 BRA 0x0",                                # the chunk loop: holds the barrier
            "EXIT",
            "DMUL R2, R2, R4", "@P3 RET.REL.NODEC R0 0x0",  # the called routine, 0x100-0x130
            "DADD R2, R2, R4", "RET.REL.NODEC R0 0x0",
            "BRA 0x140"]
    for i, text in enumerate(body):
        lines.append(f"        /*{i * 16:04x}*/                   {text} ;     /* 0x0 */")
    counts = cw_study.loop_counts("\n".join(lines))
    got = counts["float64", True, True]
    assert got == {"lds": 1, "fp64": 1 + 2 * 2, "other": 3, "mufu": 1, "fp32": 1,
                   "conversion": 1, "branch": 3 + 2 * 2, "total": 11 + 2 * 4, "called": 8}
    per = cw_study.per_element(got, 2)
    assert per["total"] == 9.5 and cw_study.per_element(got)["total"] == 19
    # 528,000 warps of 4.5 instructions on 132 SMs at 1,000 MHz: issue
    # (4 a clock) takes 4,500 clocks an SM, MUFU (0.5 a clock, 0.5 an
    # element) 4,000 and FP64 (2 a clock) 1,000
    per = {"total": 4.5, "fp64": 1.0, "mufu": 0.5}
    ms, pipe = cw_study.issue_ms(per, 32 * 132 * 4 * 1000, 132, 1000.0)
    assert pipe == "issue" and ms == pytest.approx(4500 / 1e6)
    ms, pipe = cw_study.issue_ms(dict(per, mufu=1.0), 32 * 132 * 4 * 1000, 132, 1000.0)
    assert pipe == "mufu" and ms == pytest.approx(8000 / 1e6)
