"""``python -m pta_replicator_tpu_torch likelihood`` against the JAX
package's CLI on the CPU: a bank written by the port's ``realize
--checkpoint`` on a small ragged par/tim dataset is priced by both CLIs
over a 3 x 3 GWB grid, with a MAP fit and the serving demo (grid means
<= 1e-10 relative, the same best point, MAP values <= 1e-6 relative, the
JAX serve block's keys and no failed request); the same over a synthetic
batch (``--synthetic 4x128``) and an ``.npy`` bank; a bank of another
shape is refused by both. On a bank its noise model describes, the port
CLI's MAP finds the injected GWB amplitude. The port's batch is frozen in torch's default
float dtype, set to float64 here as JAX's x64 mode sets JAX's."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu.__main__ import main as jax_main
from pta_replicator_tpu_torch import realize
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.__main__ import _build_recipe, main
from pta_replicator_tpu_torch.batch import synthetic_batch
from pta_replicator_tpu_torch.models import batched as B
from pta_replicator_tpu_torch.utils.fabricate import ng15_like_recipe

from _torch_dataset import small_pulsars, write_with

TOL_GRID = 1e-10
TOL_MAP = 1e-6
#: the chip check's truth gate: the MAP within 5 Fisher sigmas of the
#: injected GWB amplitude
TOL_TRUTH_SIGMAS = 5.0
GRID = ["--grid", "gwb_log10_amplitude=-14.6:-13.6:3", "--grid", "gwb_gamma=3.5:5.0:3"]
MAP = ["--map", "gwb_log10_amplitude=-14.2"]
SERVE = ["--serve", "8", "--clients", "2"]
SYNTHETIC_RECIPE = {"efac": 1.1, "log10_ecorr": -6.8, "rn_log10_amplitude": -14.0,
                    "rn_gamma": 3.0, "rn_nmodes": 10, "gwb_log10_amplitude": -14.3,
                    "gwb_gamma": 4.33, "gwb_npts": 100, "gwb_howml": 4.0}


@pytest.fixture
def float64_default():
    """The port's analog of JAX's x64 mode for the CLI's batch."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(before)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A small dataset, its recipe, and the bank the port's CLI wrote."""
    root = tmp_path_factory.mktemp("likelihood_cli")
    pardir, timdir = write_with(tsim, small_pulsars(), str(root))
    # the noise model alone: a CW catalog in the bank would be a signal the
    # likelihood does not model, and the MAP fit would chase it
    spec = {k: v for k, v in ng15_like_recipe(4, ncw=1, gwb_npts=100, gwb_howml=4.0).items()
            if not k.startswith("cgw_")}
    spec["rn_nmodes"] = 10
    recipe = root / "r.json"
    recipe.write_text(json.dumps(spec))
    ck = str(root / "ck.npz")
    # fitted (the quadratic), as the grid and the MAP fit price it without
    # a design: unfitted, the GWB's power below 1/T would pull the MAP
    # amplitude far from the truth
    main(["realize", "--pardir", pardir, "--timdir", timdir, "--recipe", str(recipe),
          "--out", str(root / "cube.npz"), "--checkpoint", ck, "--nreal", "8", "--chunk", "4",
          "--fit", "--device", "cpu"])
    return root, ["--bank", ck, "--recipe", str(recipe), "--pardir", pardir, "--timdir", timdir]


def _both(argv, tmp_path, capsys):
    """The port's result (through --out) and the JAX CLI's (stdout)."""
    out = tmp_path / "port.json"
    main(["likelihood", *argv, "--out", str(out), "--device", "cpu"])
    jax_main(["likelihood", *argv])
    return json.loads(out.read_text()), json.loads(capsys.readouterr().out)


def _same_result(got, want, nserve):
    assert got.keys() == want.keys()
    assert (got["nreal"], got["npsr"]) == (want["nreal"], want["npsr"])
    g, w = got["grid"], want["grid"]
    assert (g["axes"], g["shape"]) == (w["axes"], w["shape"])
    a, b = np.array(g["loglikelihood_mean"]), np.array(w["loglikelihood_mean"])
    assert np.abs(a - b).max() <= TOL_GRID * np.abs(b).max()
    assert g["best"]["index"] == w["best"]["index"]
    m, n = got["map"], want["map"]
    assert m["names"] == n["names"] and m["converged"] and n["converged"]
    for key in ("x", "loglikelihood", "sigma"):
        x, y = np.atleast_1d(m[key]), np.atleast_1d(n[key])
        assert np.abs(x - y).max() <= TOL_MAP * np.abs(y).max(), key
    s, t = got["serve"], want["serve"]
    assert s.keys() == t.keys() and "failures" not in s
    assert s["latency"].keys() == t["latency"].keys()
    assert s["batch_fill"].keys() == t["batch_fill"].keys()
    assert s["requests"] == t["requests"] == nserve


def test_the_bank_of_realize_checkpoint_prices_as_in_jax(dataset, tmp_path, capsys,
                                                         float64_default):
    _, argv = dataset
    got, want = _both(argv + GRID + MAP + SERVE, tmp_path, capsys)
    _same_result(got, want, 8)
    assert got["nreal"] == 8 and got["grid"]["shape"] == [3, 3]


def test_a_synthetic_batch_and_an_npy_bank_price_as_in_jax(tmp_path, capsys, float64_default):
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps(SYNTHETIC_RECIPE))
    batch = synthetic_batch(npsr=4, ntoa=128, seed=0, dtype=torch.float64, device="cpu")
    phat = batch.phat.numpy()
    locs = np.stack([np.arctan2(phat[:, 1], phat[:, 0]), np.arccos(phat[:, 2])], axis=-1)
    rec = _build_recipe(SYNTHETIC_RECIPE, None, locs=locs)
    cube = realize(torch.Generator().manual_seed(4), batch, rec, 6, device="cpu")
    bank = str(tmp_path / "bank.npy")
    np.save(bank, cube.numpy())
    argv = ["--bank", bank, "--recipe", str(recipe), "--synthetic", "4x128"]
    got, want = _both(argv + GRID + MAP + SERVE, tmp_path, capsys)
    _same_result(got, want, 8)


def test_the_map_finds_the_injected_gwb_on_a_bank_the_recipe_models(tmp_path, float64_default):
    """The chip check's truth arm at a small width: a synthetic batch
    whose pulsars span the array's years, the NG15-like noise without its
    CW catalog, a GWB without cross-correlations or power below 1/T on a
    fine synthesis grid, the summed stochastic delays (nothing fitted or
    removed); the CLI's MAP
    lands inside the grid within TOL_TRUTH_SIGMAS of the injection."""
    spec = {k: v for k, v in ng15_like_recipe(16).items() if not k.startswith("cgw_")}
    spec.update(orf="none", gwb_howml=1.0, gwb_npts=4800)
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps(spec))
    batch = synthetic_batch(npsr=16, ntoa=1200, seed=0, dtype=torch.float64, device="cpu")
    rec = _build_recipe(spec, None)
    delays = B.realization_delays(batch, rec, B.draw_noise(torch.Generator().manual_seed(7),
                                                           batch, rec, 4))
    bank = str(tmp_path / "bank.npy")
    np.save(bank, delays.numpy())
    out = tmp_path / "port.json"
    main(["likelihood", "--bank", bank, "--recipe", str(recipe), "--synthetic", "16x1200",
          *GRID, *MAP, "--out", str(out), "--device", "cpu"])
    fit = json.loads(out.read_text())["map"]
    assert fit["converged"]
    assert -14.6 < fit["x"][0] < -13.6
    assert abs(fit["x"][0] - spec["gwb_log10_amplitude"]) <= TOL_TRUTH_SIGMAS * fit["sigma"][0]


def test_a_bank_of_another_dataset_is_refused_by_both(tmp_path):
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps(SYNTHETIC_RECIPE))
    bank = str(tmp_path / "bank.npy")
    np.save(bank, np.zeros((2, 3, 128)))
    argv = ["likelihood", "--bank", bank, "--recipe", str(recipe), "--synthetic", "4x128"]
    for run, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        with pytest.raises(SystemExit, match="synthesized from a different dataset"):
            run(argv + GRID + extra)


@pytest.mark.parametrize("argv,message", [
    (["--bank", "b.npy", "--recipe", "r.json"], "needs a dataset"),
    (["--bank", "b.npy", "--recipe", "r.json", "--synthetic", "4by128"], "must look like"),
])
def test_the_jax_clis_dataset_guards(argv, message):
    with pytest.raises(SystemExit, match=message):
        main(["likelihood", *argv, "--device", "cpu"])
    with pytest.raises(SystemExit, match=message):
        jax_main(["likelihood", *argv])
