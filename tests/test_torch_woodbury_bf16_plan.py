"""The bf16 Woodbury kernel's launch plan, on the CPU.

``ops/gp.py`` mirrors ``csrc/fused_woodbury.cu``'s ``bf_grid`` (who owns a
(pulsar, split) unit: one block, a cluster or strips; the staging ring's
slots and the shared memory) and its ``stage_span`` arithmetic (where a
span of T starts against 16 bytes). The card tests hold the built
kernel's own grid against this mirror; these tests hold the mirror to
the kernel's contract.
"""
import pytest

torch = pytest.importorskip("torch")

from pta_replicator_tpu_torch.ops import gp

#: the widths the plan must take: one panel, two (the flagship's 123 and
#: the most one block owns), a cluster of 3, the GLS-fitted bank's 286
#: (a cluster of 5), a cluster of 8 and strips past it
COLUMNS = [7, 123, 127, 128, 286, 511, 520]
WANT = {7: ("single", 1, 1), 123: ("single", 1, 1), 127: ("single", 1, 1),
        128: ("cluster", 3, 3), 286: ("cluster", 5, 5), 511: ("cluster", 8, 8),
        520: ("strips", 1, 18)}
SMS = 132


@pytest.mark.parametrize("q", COLUMNS)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_grid_and_workspace(q, itemsize):
    npsr, ntoa = 68, 7758
    panels, pairs, nsplit, workspace = gp.woodbury_plan(npsr, ntoa, q, SMS, "bf16")
    grid = gp.woodbury_bf16_grid(npsr, q, nsplit, itemsize)
    assert (grid.mode, grid.cluster, grid.blocks) == WANT[q]
    assert grid.panels == panels == -(-(q + 1) // 64) and pairs == panels**2
    assert grid.grid == (grid.blocks, nsplit, npsr)
    # every entry of the padded Gram matrix of every split, once
    assert workspace == (npsr * nsplit * (64 * panels) ** 2 if nsplit > 1 else 0)
    assert grid.shared_bytes <= gp.WOODBURY_SMEM_LIMIT
    if grid.mode == "strips":
        assert grid.slots == grid.share_rows == grid.piece_rows == 0
    else:
        npiece = grid.share_rows // grid.piece_rows
        assert grid.share_rows % grid.piece_rows == 0
        assert 2 * npiece <= grid.slots <= gp.WOODBURY_BF16_MAX_SLOTS
        assert grid.share_rows * grid.cluster >= gp.WOODBURY_BF16_ROWS


def test_cluster_within_the_portable_size_and_strips_past_it():
    """Every width from 1 to 1,100 columns: a cluster never exceeds 8
    blocks; past 8 panels the unit is strips of row panel x 8 column
    panels; the shared memory always fits a block."""
    for q in range(1, 1101):
        for itemsize in (4, 8):
            grid = gp.woodbury_bf16_grid(3, q, 2, itemsize)
            assert grid.cluster <= gp.WOODBURY_BF16_MAX_CLUSTER
            assert grid.shared_bytes <= gp.WOODBURY_SMEM_LIMIT
            if grid.panels > gp.WOODBURY_BF16_MAX_CLUSTER:
                assert grid.mode == "strips" and grid.cluster == 1
                assert grid.blocks == grid.panels * -(-grid.panels // gp.WOODBURY_BF16_GROUP)
            elif grid.panels > gp.WOODBURY_BF16_SINGLE_MAX:
                assert grid.mode == "cluster" and grid.cluster == grid.blocks == grid.panels
            else:
                assert grid.mode == "single" and grid.blocks == 1


@pytest.mark.parametrize("ntoa", [1, 5, 16, 63, 64, 100, 997, 7758])
def test_no_empty_split(ntoa):
    """The plan's split count and every candidate the tuner scores give
    each split ceil(Nt / nsplit) rows, none of them empty."""
    for q in COLUMNS:
        for npsr in (1, 3, 68):
            cands = gp.woodbury_split_candidates(npsr, ntoa, q, SMS, "bf16")
            plan = gp.woodbury_plan(npsr, ntoa, q, SMS, "bf16")[2]
            assert plan in cands and cands[0] == 1
            for n in cands:
                rows = -(-ntoa // n)
                assert 1 <= n <= ntoa and (n - 1) * rows < ntoa


def _span_bytes(offset, count, itemsize):
    """The bytes of a span sorted into what stage_span copies, by brute
    force: 16-byte units that lie wholly inside the span, the rest one by
    one."""
    lo, hi = offset * itemsize, (offset + count) * itemsize
    units = [(b, b + 16) for b in range(-(-lo // 16) * 16, hi - 15, 16)]
    first = units[0][0] if units else hi
    last = units[-1][1] if units else hi
    return (first - lo) // itemsize, len(units), (hi - last) // itemsize


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("q", [122, 123, 286, 287])
@pytest.mark.parametrize("p", [0, 1, 2, 3])
def test_span_head_and_tail(itemsize, q, p):
    """Chunk spans of pulsar p's rows (offset (p Nt + n0) Q): head and
    tail elements are fewer than 16 bytes each, the 16-byte copies start
    on a 16-byte boundary, and together they cover the span once."""
    for nt in (7758, 997):
        for n0, rows in ((0, 64), (32, 32), (64, 14), (nt - 5, 5), (0, 1)):
            offset, count = (p * nt + n0) * q, rows * q
            head, units, tail = gp.woodbury_bf16_span(offset, count, itemsize)
            assert (head, units, tail) == _span_bytes(offset, count, itemsize)
            assert head * itemsize < 16 and tail * itemsize < 16
            assert head + units * 16 // itemsize + tail == count
            if units:
                assert (offset + head) * itemsize % 16 == 0


def test_span_alignment_cases():
    """float64 spans at Nt = 7,758 start aligned (p Nt + n0 is even); in
    float32 with odd Q, odd pulsars start 8 bytes off (two head
    elements); even Q never misaligns float64."""
    for p in range(4):
        assert gp.woodbury_bf16_span((p * 7758 + 64) * 123, 64 * 123, 8)[0] == 0
        want = 2 if p % 2 else 0
        assert gp.woodbury_bf16_span((p * 7758 + 64) * 123, 64 * 123, 4)[0] == want
        assert gp.woodbury_bf16_span((p * 997 + 32) * 122, 32 * 122, 8)[0] == 0


@pytest.mark.parametrize("cluster", range(1, 9))
def test_shares_cover_a_chunk_once(cluster):
    shares = gp.woodbury_bf16_shares(cluster)
    assert shares[0][0] == 0 and shares[-1][1] == gp.WOODBURY_BF16_ROWS // 2
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [b - a for a, b in shares]
    assert max(sizes) - min(sizes) <= 1
    if cluster > gp.WOODBURY_BF16_SINGLE_MAX:  # the grid's share rows hold the largest share
        grid = gp.woodbury_bf16_grid(1, 64 * cluster - 1, 1, 8)
        assert grid.cluster == cluster and 2 * max(sizes) <= grid.share_rows


def _ring(slots, npiece, nch):
    """The kernel's ring schedule: pieces [0, slots - npiece) before chunk
    0; at phase c the pieces slots - npiece on (npiece of them) into slot
    piece % slots. Returns, per phase, the pieces issued and the pieces
    converted."""
    ahead = slots - npiece
    phases = []
    for c in range(nch):
        issued = range(c * npiece + ahead, c * npiece + ahead + npiece)
        phases.append((list(issued), list(range(c * npiece, (c + 1) * npiece))))
    return ahead, phases


@pytest.mark.parametrize("q", [7, 123, 127, 128, 286, 511])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_ring_reuses_a_slot_only_after_its_piece_was_converted(q, itemsize):
    """A slot takes a new piece only in a phase after the one that
    converted its last piece; the wait before phase c leaves at most
    slots - 2 npiece pieces in flight, none of them chunk c's."""
    grid = gp.woodbury_bf16_grid(2, q, 1, itemsize)
    npiece = grid.share_rows // grid.piece_rows
    nch = 9
    ahead, phases = _ring(grid.slots, npiece, nch)
    holder = {pc % grid.slots: pc for pc in range(ahead)}  # slot -> piece in it
    converted_at = {}
    committed = ahead
    for c, (issued, converting) in enumerate(phases):
        pending = committed - (c + 1) * npiece  # groups after chunk c's last piece
        assert pending == grid.slots - 2 * npiece >= 0
        assert all(holder[pc % grid.slots] == pc for pc in converting)
        for pc in issued:
            old = holder.get(pc % grid.slots)
            assert old is None or converted_at[old] < c
            holder[pc % grid.slots] = pc
        committed += npiece
        for pc in converting:
            converted_at[pc] = c


def test_staged_bytes_once_per_unit():
    """One block or a cluster brings T, w and r in once per call (within
    1.5 T's bytes; a kernel staging each panel pair took 3x and 9x at Q =
    123 and 286); strips read T about 9 ceil(P / 8) times."""
    for q in (123, 286):
        for itemsize in (4, 8):
            t = 68 * 7758 * q * itemsize
            assert gp.woodbury_bf16_staged_bytes(68, 7758, q, itemsize) <= 1.5 * t
    t = 68 * 7758 * 520 * 8
    assert gp.woodbury_bf16_staged_bytes(68, 7758, 520, 8) > 9 * t


def test_study_variants_edit_the_kernel_as_it_is():
    """Every partial build of kernels/woodbury_study.py replaces text the
    kernel's source still holds, so the study builds on the card; the
    parent's staging multiple is 2P - 1 (3 and 9 at Q = 123 and 286)."""
    from pta_replicator_tpu_torch.kernels import build, woodbury_study

    source = (build.CSRC_DIR / "fused_woodbury.cu").read_text()
    for name, edits in woodbury_study.VARIANTS.items():
        for old, new in edits:
            assert old in source and old != new, (name, old)
    assert [woodbury_study.parent_bf16_staged(q) for q in (123, 286)] == [3, 9]
