"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import pta_replicator_tpu_torch as port
from pta_replicator_tpu_torch import likelihood as lk
from pta_replicator_tpu_torch.models import batched as TB

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pta_replicator_tpu")


def _port_sources():
    return sorted((REPO / "pta_replicator_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"
    ]


def test_the_scan_covers_the_covariance_modules():
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for module in ("covariance/__init__.py", "covariance/kernels.py",
                   "covariance/structure.py", "convert.py", "ops/cw.py", "ops/gp.py"):
        assert f"pta_replicator_tpu_torch/{module}" in names


def test_the_scan_covers_the_scenario_modules():
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for module in ("__main__.py", "scenarios/__init__.py", "scenarios/spec.py",
                   "scenarios/compile.py", "models/population.py", "ops/orf.py",
                   "utils/cosmology.py", "utils/prng.py"):
        assert f"pta_replicator_tpu_torch/{module}" in names


def test_the_scan_covers_the_dataset_modules():
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for module in ("io/__init__.py", "io/par.py", "io/tim.py", "io/native.py",
                   "io/noise_dict.py", "timing/__init__.py", "timing/time_scales.py",
                   "timing/model.py", "timing/components.py", "timing/fit.py", "simulate.py",
                   "batch.py", "ops/coords.py", "ops/quantize.py", "utils/checkpoint.py",
                   "utils/export.py", "utils/fabricate.py"):
        assert f"pta_replicator_tpu_torch/{module}" in names


def test_the_scan_covers_the_oracle_modules():
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for module in ("models/__init__.py", "models/white_noise.py", "models/red_noise.py",
                   "models/cgw.py", "models/bursts.py", "models/gwb.py",
                   "models/population.py", "ops/fourier.py", "timing/fit.py", "simulate.py"):
        assert f"pta_replicator_tpu_torch/{module}" in names


def test_toa_epochs_never_pass_through_a_torch_tensor():
    """The modules that hold longdouble epochs import no torch; freeze
    (batch.py) and export take epochs to float64 or seconds first."""
    for module in ("io/par.py", "io/tim.py", "io/native.py", "timing/time_scales.py",
                   "timing/model.py", "timing/components.py", "timing/fit.py", "simulate.py",
                   "ops/coords.py", "ops/quantize.py", "models/white_noise.py",
                   "models/red_noise.py", "models/bursts.py"):
        tree = ast.parse((REPO / "pta_replicator_tpu_torch" / module).read_text())
        imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names}
        imported |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert "torch" not in imported, module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}: {n}" for n in names if _forbidden(n)]
    assert len(_port_sources()) > 10
    assert not offenders, offenders


def test_importing_every_port_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pta_replicator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pta_replicator_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.flagship_workload(npsr=2, ntoa=64, ncw=2)
    batch, recipe = port.flagship_workload(npsr=2, ntoa=64, ncw=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.deterministic_delays(batch, recipe)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.realize(torch.Generator(), batch, recipe, 1)
    static = port.deterministic_delays(batch, recipe, device="cpu")
    out = port.realize(torch.Generator().manual_seed(0), batch, recipe, 2,
                       static=static, device="cpu")
    assert out.shape == (2, 2, 64) and out.device.type == "cpu"

    grid = {"gwb_gamma": [4.0, 4.5]}
    bank = lk.RealizationBank.from_array(out)
    for call in (lambda **d: lk.bank_loglikelihood(out, batch, recipe, grid=grid, **d),
                 lambda **d: lk.grid_loglikelihood(out[0], batch, recipe, grid, **d),
                 lambda **d: lk.LikelihoodServer(bank, batch, recipe, ("gwb_gamma",), **d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    ll = lk.bank_loglikelihood(out, batch, recipe, grid=grid, fused=True, device="cpu")
    assert ll.shape == (2, 2) and ll.device.type == "cpu"
    assert lk.grid_loglikelihood(out[0], batch, recipe, grid, device="cpu").shape == (2,)
    assert lk.LikelihoodServer(bank, batch, recipe, ("gwb_gamma",), device="cpu").nreal == 2


def test_chip_smoke_refuses_without_a_card_and_alone(tmp_path):
    """No card: exit non-zero and print no result. Alone in a directory
    (the port absent): the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert out.stdout == ""


def test_tf32_is_refused_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        TB._require_ieee_float32(torch.device("cuda"))
    TB._require_ieee_float32(torch.device("cpu"))
