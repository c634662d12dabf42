"""The dataset path as a whole, port against the JAX package: a ragged
par/tim dataset loaded, idealized and frozen, its full timing design
built (``design_tensor``), a recipe from JSON (per-backend white noise and
ECORR, red noise, an HD GWB and a CW catalog), then ``realize`` with the
quadratic fit, the full-model WLS refit and the GLS refit, the JAX draws
handed over as explicit noise: both packages in float64 agree to <= 1e-9
of the RMS. And the command line: ``info`` prints the JAX CLI's JSON;
a deterministic-only recipe (CW catalog + ``--full-fit``) gives the port's
float32 cube within 1e-3 relative RMS of JAX's float64 cube; the
checkpointed ``--write-partim`` datasets carry their cube rows; the flags
of unported modules exit non-zero before ingest; without a card the
command fails and names ``--device cpu``."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax

from pta_replicator_tpu import simulate as jsim
from pta_replicator_tpu.__main__ import _build_recipe as jax_build_recipe
from pta_replicator_tpu.__main__ import main as jax_main
from pta_replicator_tpu.batch import freeze as jax_freeze
from pta_replicator_tpu.models.batched import realize as jax_realize
from pta_replicator_tpu.timing.fit import design_tensor as jax_design_tensor
from pta_replicator_tpu_torch import realize
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.__main__ import _build_recipe, main
from pta_replicator_tpu_torch.batch import freeze
from pta_replicator_tpu_torch.timing.fit import design_tensor
from pta_replicator_tpu_torch.utils.fabricate import ng15_like_recipe

from _torch_dataset import small_pulsars, write_with
from _torch_parity import jax_realize_draws, rel_rms

#: the slice in float64, port against JAX, relative to the RMS
TOL_SLICE = 1e-9
#: the port's float32 cube against JAX's float64 cube (the card's bound)
TOL_F32 = 1e-3
#: dataset r <-> cube row r (tests/test_cli.py)
TOL_SHIFT_S = 5e-9
NREAL = 3


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return write_with(tsim, small_pulsars(), str(tmp_path_factory.mktemp("dataset")))


def _ideal(module, dirs):
    psrs = module.load_from_directories(*dirs)
    for p in psrs:
        module.make_ideal(p)
    return psrs


def _spec(npsr, ncw=5):
    spec = ng15_like_recipe(npsr, ncw=ncw, gwb_npts=100, gwb_howml=4.0)
    spec["rn_nmodes"] = 10
    return spec


@pytest.fixture(scope="module")
def slice_(dirs):
    """Both packages' batches, designs and recipes from one dataset."""
    tp, jp = _ideal(tsim, dirs), _ideal(jsim, dirs)
    tb, jb = freeze(tp, dtype=torch.float64, device="cpu"), jax_freeze(jp)
    D, names = design_tensor(tp, ntoa_max=tb.ntoa_max)
    jD, jnames = jax_design_tensor(jp, ntoa_max=jb.ntoa_max)
    assert names == jnames and np.array_equal(D, jD)
    spec = _spec(tb.npsr)
    return tb, jb, _build_recipe(spec, tp), jax_build_recipe(spec, jp), D


@pytest.mark.parametrize("mode", ["quadratic", "wls", "gls"])
def test_the_slice_matches_jax_in_float64(slice_, mode):
    import jax.numpy as jnp

    tb, jb, tr, jr, D = slice_
    assert tb.backend_names == jb.backend_names and len(tb.backend_names) == 4
    if mode != "quadratic":
        gls = mode == "gls"
        tr = dataclasses.replace(tr, fit_design=torch.from_numpy(D), fit_gls=gls)
        jr = dataclasses.replace(jr, fit_design=jnp.asarray(D), fit_gls=gls)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_realize(key, jb, jr, NREAL, fit=True))
    got = realize(None, tb, tr, NREAL, fit=True, noise=jax_realize_draws(key, jb, jr, NREAL),
                  device="cpu").numpy()
    assert np.isfinite(got).all() and np.sqrt(np.mean(want**2)) > 1e-7
    assert rel_rms(got, want) <= TOL_SLICE
    # padding rows stay zero
    for i, n in enumerate(tb.ntoas.tolist()):
        assert not got[:, i, n:].any()


def _solve_ld(A, B):
    """A^-1 B in longdouble: Gaussian elimination with partial pivoting."""
    A, B = A.astype(np.longdouble), B.astype(np.longdouble)
    for k in range(A.shape[0]):
        p = k + int(np.argmax(np.abs(A[k:, k])))
        A[[k, p]], B[[k, p]] = A[[p, k]], B[[p, k]]
        f = A[k + 1:, k] / A[k, k]
        A[k + 1:, k:] -= f[:, None] * A[k, k:][None, :]
        B[k + 1:] -= f[:, None] * B[k][None, :]
    X = np.zeros_like(B)
    for k in range(A.shape[0] - 1, -1, -1):
        X[k] = (B[k] - A[k, k + 1:] @ X[k + 1:]) / A[k, k]
    return X


def _gls_refit_80_bit(tb, tr, design, delays):
    """The port's GLS refit algebra in 80-bit longdouble, pulsar by pulsar:
    C^-1 as C0^-1 (white + per-epoch ECORR Woodbury) minus the GP blocks'
    nested Woodbury term, A = N^-1 M^T C^-1 M N^-1 with the padding unit
    rows and the 1e-10 ridge, then the weighted-mean subtraction."""
    from pta_replicator_tpu_torch.models import batched as TB

    ld = np.longdouble
    sigma2, ecorr2, U, phi = (None if x is None else x.numpy().astype(ld)
                              for x in TB.gls_noise_model(tb, tr))
    mask, epoch = tb.mask.numpy().astype(ld), tb.epoch_index.numpy()
    out = np.zeros(delays.shape)
    for i in range(tb.npsr):
        winv = np.where(mask[i] > 0, 1 / np.where(mask[i] > 0, sigma2[i], 1), 0)
        s_e = np.zeros(ecorr2.shape[1], ld)
        np.add.at(s_e, epoch[i], winv * mask[i])
        gain = ecorr2[i] / (1 + ecorr2[i] * s_e)

        def c0inv(X):
            y = winv[:, None] * X
            seg = np.zeros((len(gain), X.shape[1]), ld)
            np.add.at(seg, epoch[i], y * mask[i][:, None])
            return y - winv[:, None] * (gain[:, None] * seg)[epoch[i]]

        Ui = U[i] * (phi[i] > 0)[None, :]
        G = c0inv(Ui)
        S = Ui.T @ G + np.diag(1 / np.where(phi[i] > 0, phi[i], 1))

        def cinv(X):
            X0 = c0inv(X)
            return X0 - G @ _solve_ld(S, Ui.T @ X0)

        M = design[i].astype(ld) * mask[i][:, None]
        CiM = cinv(M)
        norms = np.sqrt(np.maximum(np.einsum("nk,nk->k", M, CiM), 0))
        zero = norms == 0
        norms = np.where(zero, 1, norms)
        A = (M.T @ CiM) / norms[:, None] / norms[None, :] + np.diag(zero.astype(ld)) \
            + ld(1e-10) * np.eye(M.shape[1], dtype=ld)
        w = mask[i] / tb.errors_s[i].numpy().astype(ld) ** 2
        for r in range(delays.shape[0]):
            y = delays[r, i].astype(ld)
            b = (M.T @ cinv(y[:, None])[:, 0]) / norms
            post = (y - M @ (_solve_ld(A, b[:, None])[:, 0] / norms)) * mask[i]
            out[r, i] = (post - np.sum(w * post) / np.sum(w)) * mask[i]
    return out


def test_the_float64_gls_refit_sits_at_an_80_bit_reference(slice_):
    """The same algebra in longdouble: the port's float64 GLS refit of the
    real design within 1e-10 of the RMS (its one step of iterative
    refinement; without the step it reads ~1e-9 here, where cond(A)
    reaches ~2e7, and JAX's ~1e-10-4e-10)."""
    from pta_replicator_tpu_torch.models import batched as TB

    tb, _, tr, _, D = slice_
    tr = dataclasses.replace(tr, fit_design=torch.from_numpy(D), fit_gls=True)
    draws = TB.draw_noise(torch.Generator().manual_seed(3), tb, tr, 2)
    delays = TB.realization_delays(tb, tr, draws) + TB.deterministic_delays(tb, tr, device="cpu")
    got = TB.finalize_residuals(delays, tb, tr, True).numpy()
    want = _gls_refit_80_bit(tb, dataclasses.replace(tr, fit_design=None), D, delays.numpy())
    assert rel_rms(got, want) <= 1e-10


def _run(fn, argv, capsys):
    fn(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_info_prints_the_jax_json(dirs, capsys):
    args = ["info", "--pardir", dirs[0], "--timdir", dirs[1]]
    got = _run(main, args + ["--device", "cpu"], capsys)
    want = _run(jax_main, args, capsys)
    assert got == want and got["npsr"] == 4 and got["ntoa_max"] == 400
    assert _run(main, args + ["--num-psrs", "2", "--device", "cpu"], capsys)["npsr"] == 2


def test_a_deterministic_recipe_with_the_full_fit_matches_jax_float64(dirs, tmp_path, capsys):
    spec = {"cgw_params": _spec(4, ncw=8)["cgw_params"], "orf": "none"}
    recipe = tmp_path / "cw.json"
    recipe.write_text(json.dumps(spec))
    args = ["realize", "--pardir", dirs[0], "--timdir", dirs[1], "--recipe", str(recipe),
            "--nreal", "2", "--full-fit"]
    got = _run(main, args + ["--out", str(tmp_path / "p.npz"), "--device", "cpu"], capsys)
    want = _run(jax_main, args + ["--out", str(tmp_path / "j.npz")], capsys)
    assert got["shape"] == want["shape"] == [2, 4, 400]
    K = jax_design_tensor(_ideal(jsim, dirs))[0].shape[-1]
    assert (got["fit"], got["design_columns"]) == ("wls", K) and K > 30
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert p["residuals"].dtype == np.float32 and j["residuals"].dtype == np.float64
        assert np.array_equal(p["mask"], j["mask"]) and list(p["names"]) == list(j["names"])
        assert str(p["fit"]) == "wls" and len(json.loads(str(p["design_names"]))) == 4
        assert np.sqrt(np.mean(j["residuals"] ** 2)) > 1e-9
        assert rel_rms(p["residuals"], j["residuals"]) <= TOL_F32


def test_checkpointed_write_partim_datasets_carry_their_cube_rows(dirs, tmp_path, capsys):
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps(_spec(4)))
    out = tmp_path / "o.npz"
    summary = _run(main, [
        "realize", "--pardir", dirs[0], "--timdir", dirs[1], "--recipe", str(recipe),
        "--nreal", "4", "--chunk", "2", "--checkpoint", str(tmp_path / "ck.npz"),
        "--out", str(out), "--write-partim", str(tmp_path / "ds"), "--write-max", "3",
        "--device", "cpu"], capsys)
    assert summary["partim_dirs"] == 3 and summary["fit"] == "none"
    template = _ideal(tsim, dirs)
    with np.load(out) as z:
        cube = z["residuals"]
    for r in (0, 2):  # r = 2 falls in the sweep's second chunk
        for i, p in enumerate(template):
            rdir = tmp_path / "ds" / f"real{r:05d}"
            back = tsim.load_pulsar(str(rdir / f"{p.name}.par"), str(rdir / f"{p.name}.tim"))
            shift = np.asarray((back.toas.mjd - p.toas.mjd) * np.longdouble(86400.0), np.float64)
            w = 1.0 / p.toas.errors_s**2
            np.testing.assert_allclose(shift - np.sum(w * shift) / np.sum(w),
                                       cube[r, i, : p.toas.ntoas], atol=TOL_SHIFT_S, rtol=0)


@pytest.mark.parametrize("flag,item", [
    (["--sharded"], "A.17"), (["--mesh-shape", "2x2"], "A.17"),
    (["--device-trace"], r"A\.16\.4"), (["--faults", "drain:raise@chunk=1"], r"A\.16\.2"),
])
def test_flags_of_unported_modules_exit_before_ingest(tmp_path, flag, item):
    missing = str(tmp_path / "no-such-dir")
    with pytest.raises(SystemExit, match=item):
        main(["realize", "--pardir", missing, "--timdir", missing, "--recipe", "r.json",
              "--out", "o.npz", "--device", "cpu", *flag])
    # refused before a capture starts, too
    with pytest.raises(SystemExit, match=item):
        main(["realize", "--pardir", missing, "--timdir", missing, "--recipe", "r.json",
              "--out", "o.npz", "--device", "cpu", "--telemetry", str(tmp_path / "t"), *flag])
    assert not (tmp_path / "t").exists()
    if flag[0] == "--faults":
        with pytest.raises(SystemExit, match=item):
            main(["info", "--pardir", missing, "--timdir", missing, *flag])


def test_the_jax_cli_guards_hold_before_ingest(tmp_path):
    missing = str(tmp_path / "no-such-dir")
    base = ["realize", "--pardir", missing, "--timdir", missing, "--recipe", "r.json",
            "--out", "o.npz", "--device", "cpu"]
    with pytest.raises(SystemExit, match="needs --checkpoint"):
        main(base + ["--fused-stream"])
    with pytest.raises(SystemExit, match="pipeline-depth"):
        main(base + ["--fused-stream", "--checkpoint", "c.npz", "--pipeline-depth", "1"])
    with pytest.raises(SystemExit, match="multiple of --chunk"):
        main(base + ["--checkpoint", "c.npz", "--nreal", "5", "--chunk", "2"])


def test_an_unknown_recipe_key_and_a_bad_orf_are_refused(dirs, tmp_path):
    for spec, match in (({"efacc": 1.0}, "efacc"), ({"orf": "dipole"}, "orf")):
        recipe = tmp_path / "bad.json"
        recipe.write_text(json.dumps(spec))
        with pytest.raises(SystemExit, match=match):
            main(["realize", "--pardir", dirs[0], "--timdir", dirs[1], "--recipe", str(recipe),
                  "--out", str(tmp_path / "o.npz"), "--device", "cpu"])


def test_without_a_card_the_command_fails_and_names_device_cpu(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["info", "--pardir", dirs[0], "--timdir", dirs[1]])
