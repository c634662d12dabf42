"""The port's multi-process helpers (``pta_replicator_tpu_torch/parallel/
distributed.py``) with real processes: two and four processes join a gloo
group on 127.0.0.1 (``parallel/rehearsal.py``), each holds a mesh over its
local ``cpu`` devices, and their stitched ``local_realizations`` equal the
single-process sweep bitwise for the elementwise recipe (and to 1e-12 of
the largest entry for the flagship recipe with its fit, whose products are
windowed). Unlike jaxlib, whose CPU client cannot run a multi-process
computation (``tests/test_distributed_multiprocess.py`` skips there),
nothing here is skipped. Every process has its own 120 s timeout."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pta_replicator_tpu_torch.parallel import distributed
from pta_replicator_tpu_torch.parallel import rehearsal
from pta_replicator_tpu_torch.utils.sweep import sweep

NREAL, CHUNK, SEED = 16, 8, 5
TOL_WINDOWED = 1e-12


def _reference(tmp_path, kind, fit):
    batch, recipe = rehearsal.workload(kind, 4, 64, torch.float64, "cpu")
    return sweep(SEED, batch, recipe, NREAL, str(tmp_path / "ref.npz"), chunk=CHUNK,
                 reduce_fn=None, fit=fit, device="cpu")


@pytest.mark.parametrize("nproc,mesh,kind", [
    (2, "2x1", "white"), (2, "1x2", "white"), (4, "1x2", "white"), (2, "1x2", "flagship"),
])
def test_processes_stitch_to_the_single_process_sweep(tmp_path, nproc, mesh, kind):
    fit = kind == "flagship"
    # one intra-op thread a process: the test runs beside other test workers
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    results = rehearsal.launch(nproc, str(tmp_path), mesh=mesh, device="cpu", workload=kind,
                               nreal=NREAL, chunk=CHUNK, seed=SEED, fit=fit, timeout_s=120.0,
                               env=env)
    ref = _reference(tmp_path, kind, fit).reshape(NREAL // CHUNK, CHUNK, 4, 64)
    rows = CHUNK // nproc
    n_real, n_psr = (int(x) for x in mesh.split("x"))
    for rank, got in enumerate(results):
        assert int(got["process_index"]) == rank and int(got["process_count"]) == nproc
        assert int(got["local_device_count"]) == n_real * n_psr
        assert int(got["global_device_count"]) == nproc * n_real * n_psr
        want = ref[:, rank * rows:(rank + 1) * rows]
        if kind == "white":
            np.testing.assert_array_equal(got["local"], want)
        else:
            assert np.max(np.abs(got["local"] - want)) <= TOL_WINDOWED * np.max(np.abs(want))


def test_single_process_topology_and_seeds():
    topo = distributed.initialize(devices=["cpu"] * 3)
    assert topo == {"process_index": 0, "process_count": 1, "local_device_count": 3,
                    "global_device_count": 3}
    mesh = distributed.global_mesh(3, 1)
    assert (mesh.process_index, mesh.process_count, mesh.shape) == (0, 1, {"real": 3, "psr": 1})
    distributed.shutdown()
    seeds = {distributed.process_seed(7, r) for r in range(4)}
    assert len(seeds) == 4 and distributed.process_seed(7, 1) == distributed.process_seed(7, 1)
    assert distributed.process_seed(7) == distributed.process_seed(7, 0)
    assert all(0 <= s < 2**63 for s in seeds)


def test_local_realizations_stitches_pulsar_windows():
    from pta_replicator_tpu_torch.parallel import mesh as M

    x = np.arange(8 * 4 * 3, dtype=np.float64).reshape(8, 4, 3)
    arr = M.put_sharded(x, M.make_mesh(2, 2, devices=["cpu"] * 4), ("real", "psr"))
    np.testing.assert_array_equal(distributed.local_realizations(arr), x)
    # one process's half of a global 4 x 2 mesh: its rows, pulsars joined
    part = M.Mesh(M.make_mesh(2, 2, devices=["cpu"] * 4).devices, process_index=1,
                  process_count=2)
    np.testing.assert_array_equal(
        distributed.local_realizations(M.put_sharded(x, part, ("real", "psr"))), x[4:])


def test_an_explicit_join_that_fails_raises():
    """A failed explicit join raises (it never carries on as one process):
    here rank 1 of 4 finds no group at a port nobody serves."""
    port = rehearsal.free_port()
    with pytest.raises((RuntimeError, ValueError)):
        distributed.initialize(f"tcp://127.0.0.1:{port}", 4, 1, devices=["cpu"], timeout_s=2.0)
    assert not torch.distributed.is_initialized()
    assert distributed.topology()["process_count"] == 1
