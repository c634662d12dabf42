"""``batch.freeze`` of the port against the JAX package's, field by field,
bit for bit, on a ragged array: fed the port's pulsars, the JAX package's
pulsars, and JAX pulsars carried across by ``convert.pulsar_from_jax``.
Index tensors are int64 in the port (int32 in JAX): values are compared.
Without a card, ``freeze()`` raises unless asked for the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pta_replicator_tpu import simulate as jsim
from pta_replicator_tpu.batch import freeze as jax_freeze
from pta_replicator_tpu_torch import convert
from pta_replicator_tpu_torch import simulate as tsim
from pta_replicator_tpu_torch.batch import PulsarBatch, freeze

from _torch_dataset import small_pulsars, write_with

STATIC = ("tref_mjd", "names", "backend_names", "start_s", "stop_s")
INDEX = ("epoch_index", "epoch_backend_index", "backend_index", "ntoas")


@pytest.fixture(scope="module")
def pulsars(tmp_path_factory):
    """(port pulsars, JAX pulsars), both make_ideal'd, from one dataset."""
    pardir, timdir = write_with(tsim, small_pulsars(), str(tmp_path_factory.mktemp("freeze")))
    ports, jaxs = tsim.load_from_directories(pardir, timdir), jsim.load_from_directories(
        pardir, timdir)
    for p in ports:
        tsim.make_ideal(p)
    for p in jaxs:
        jsim.make_ideal(p)
    return ports, jaxs


def assert_batch_equals_jax(got: PulsarBatch, want, dtype):
    for f in dataclasses.fields(PulsarBatch):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name in STATIC:
            assert a == b, f.name
            continue
        b = np.asarray(b)
        assert a.device.type == "cpu" and tuple(a.shape) == b.shape, f.name
        if f.name in INDEX:
            assert a.dtype == torch.int64 and np.array_equal(a.numpy(), b), f.name
        else:
            assert a.dtype == dtype and a.numpy().dtype == b.dtype, f.name
            assert np.array_equal(a.numpy(), b), f.name


@pytest.mark.parametrize("source", ["port", "jax", "converted"])
def test_freeze_equals_jax_bit_for_bit_on_a_ragged_array(pulsars, source):
    ports, jaxs = pulsars
    psrs = {"port": ports, "jax": jaxs,
            "converted": [convert.pulsar_from_jax(p) for p in jaxs]}[source]
    got = freeze(psrs, dtype=torch.float64, device="cpu")
    want = jax_freeze(jaxs)
    assert_batch_equals_jax(got, want, torch.float64)
    # ragged: padding rows repeat the last TOA with unit errors and no mask
    ntoas = got.ntoas.numpy()
    assert len(set(ntoas)) == len(ntoas) and got.ntoa_max == ntoas.max()
    for i, n in enumerate(ntoas):
        assert (got.mask[i, n:] == 0).all() and (got.errors_s[i, n:] == 1).all()
        assert (got.toas_s[i, n:] == got.toas_s[i, n - 1]).all()
    assert got.backend_names == ("ASP", "PUPPI", "GASP", "GUPPI")


def test_freeze_float32_and_options_equal_jax(pulsars):
    import jax.numpy as jnp

    ports, jaxs = pulsars
    kw = dict(flagid="fe", coarsegrain=0.5, tref_mjd=55555.5)
    got = freeze(ports, dtype=torch.float32, device="cpu", **kw)
    assert_batch_equals_jax(got, jax_freeze(jaxs, dtype=jnp.float32, **kw), torch.float32)
    assert got.backend_names == ("430", "L-wide", "Rcvr_800", "Rcvr1_2")


def test_converted_pulsars_keep_their_epochs_ledger_and_residuals(pulsars):
    _, jaxs = pulsars
    for want in jaxs:
        got = convert.pulsar_from_jax(want)
        assert isinstance(got, tsim.SimulatedPulsar)
        assert got.toas.mjd.dtype == np.longdouble and np.array_equal(got.toas.mjd, want.toas.mjd)
        assert got.toas.mjd is not want.toas.mjd
        assert np.array_equal(got.residuals.resids_value, want.residuals.resids_value)
        assert got.par.lines == want.par.lines and got.par.params == want.par.params
        assert got.added_signals == want.added_signals == {}


def test_freeze_without_a_card_raises_unless_asked_for_the_cpu(pulsars, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        freeze(pulsars[0])
    assert freeze(pulsars[0], device="cpu").dtype == torch.float32


def test_the_epoch_table_of_a_ragged_batch_holds_its_real_epochs_only(pulsars):
    """Padding rows all carry epoch index 0; the ECORR segment sums'
    table must not count them (at 68 x 7,758 ragged it asked the card for
    332 GiB), and its sums equal a masked scatter-add."""
    from pta_replicator_tpu_torch.models import batched as TB

    b = freeze(pulsars[0], dtype=torch.float64, device="cpu")
    table = TB._epoch_table(b)
    index, valid = b.epoch_index.numpy(), b.mask.numpy() > 0
    largest = max(np.bincount(index[i][valid[i]]).max() for i in range(b.npsr))
    assert tuple(table.shape) == (b.npsr, b.max_epochs, largest) and largest <= 16
    assert (b.ntoa_max - b.ntoas.numpy()).max() > largest
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((b.npsr, b.ntoa_max, 3)))
    _, seg_sum, _, _ = TB.white_ecorr_parts(b, torch.ones_like(b.mask), None, torch.float64)
    want = torch.zeros((b.npsr, b.max_epochs, 3), dtype=torch.float64).scatter_add_(
        1, b.epoch_index[..., None].expand(-1, -1, 3), x * b.mask[..., None])
    assert torch.allclose(seg_sum(x), want, rtol=0, atol=1e-13)
