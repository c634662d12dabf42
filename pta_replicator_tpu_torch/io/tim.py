"""Tempo2-format ``.tim`` TOA file reader/writer.

Counterpart of ``pta_replicator_tpu/io/tim.py``, a copy (the port imports
nothing of the JAX package): the same epochs, bit for bit, and the same
bytes out. TOA epochs stay ``np.longdouble`` on the host and never pass
through a torch tensor (torch has no 80-bit float). Unlike the JAX
package, the native reader and writer (``io/native.py``) do not fall back
quietly: a failed build raises. Replaces the reference's use of ``pint.toa.get_TOAs``
(pta_replicator/simulate.py:155). TOA epochs are held as
``np.longdouble`` MJDs (~18 significant digits, sub-nanosecond at MJD 5e4),
the precision PINT achieves with its pair-of-doubles representation.

Mutation model: the framework never rewrites parsed strings in place; TOA
adjustments (`adjust_seconds`) accumulate in the longdouble MJD array, which
is the single source of truth for epochs, and `write_tim` re-serializes it.
"""
from __future__ import annotations

import os
import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..constants import DAY_IN_SEC


@dataclass
class TOAData:
    """Columnar TOA container (the device-independent CPU representation)."""

    #: observation epochs, UTC MJD, longdouble
    mjd: np.ndarray = None
    #: TOA uncertainties [s], float64
    errors_s: np.ndarray = None
    #: observing radio frequency [MHz]
    freqs_mhz: np.ndarray = None
    #: observatory codes
    observatories: List[str] = field(default_factory=list)
    #: per-TOA flag dicts, e.g. {"pta": "PPTA", "f": "L-wide_PUPPI"}
    flags: List[dict] = field(default_factory=list)
    #: TOA label column (usually source file or profile name)
    labels: List[str] = field(default_factory=list)

    @property
    def ntoas(self) -> int:
        return 0 if self.mjd is None else len(self.mjd)

    def get_mjds(self) -> np.ndarray:
        """Epochs as float64 MJD (reference analog: ``toas.get_mjds().value``)."""
        return np.asarray(self.mjd, dtype=np.float64)

    def get_errors_s(self) -> np.ndarray:
        return self.errors_s

    def get_flag(self, flagid: str, default: str = "") -> np.ndarray:
        """Vector of one flag's values across TOAs."""
        return np.array([f.get(flagid, default) for f in self.flags])

    @property
    def first_mjd(self) -> float:
        return float(self.mjd.min())

    @property
    def last_mjd(self) -> float:
        return float(self.mjd.max())

    def adjust_seconds(self, dt_s: np.ndarray) -> None:
        """Shift TOA epochs by ``dt_s`` seconds (the injection primitive).

        Reference analog: ``toas.adjust_TOAs(TimeDelta(...))``
        (e.g. pta_replicator/white_noise.py:124).
        """
        dt_s = np.asarray(dt_s)
        if dt_s.shape != self.mjd.shape:
            raise ValueError(
                f"delay shape {dt_s.shape} does not match ntoas {self.mjd.shape}"
            )
        self.mjd = self.mjd + dt_s.astype(np.longdouble) / np.longdouble(DAY_IN_SEC)

    def copy(self) -> "TOAData":
        return TOAData(
            mjd=self.mjd.copy(),
            errors_s=self.errors_s.copy(),
            freqs_mhz=self.freqs_mhz.copy(),
            observatories=list(self.observatories),
            flags=[dict(f) for f in self.flags],
            labels=list(self.labels),
        )


class _TimParserState:
    """Mutable directive state threaded through INCLUDE recursion.

    Tempo-style commands honored: SKIP/NOSKIP blocks, ``TIME <s>``
    cumulative offsets, ``EFAC <k>`` / ``EQUAD <us>`` error rescaling, and
    ``INCLUDE <file>`` (resolved relative to the including file).
    """

    def __init__(self):
        self.skipping = False
        self.time_offset_s = 0.0
        self.efac = 1.0
        self.equad_us = 0.0
        self.mjds: List[np.longdouble] = []
        self.errs: List[float] = []
        self.freqs: List[float] = []
        self.obs: List[str] = []
        self.flags: List[dict] = []
        self.labels: List[str] = []


def _parse_tim_into(path: str, st: _TimParserState, depth: int = 0) -> None:
    if depth > 10:
        raise RecursionError(f"tim INCLUDE nesting too deep at {path}")
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as fh:
        for line in fh:
            stripped = line.strip()
            if not stripped:
                continue
            tokens = stripped.split()
            head = tokens[0].upper()
            if head == "NOSKIP":
                st.skipping = False
                continue
            if head == "SKIP":
                st.skipping = True
                continue
            if st.skipping:
                continue
            if head == "INCLUDE" and len(tokens) >= 2:
                _parse_tim_into(os.path.join(base, tokens[1]), st, depth + 1)
                continue
            if head == "TIME" and len(tokens) >= 2:
                st.time_offset_s += float(tokens[1])
                continue
            if head == "EFAC" and len(tokens) >= 2:
                st.efac = float(tokens[1])
                continue
            if head == "EQUAD" and len(tokens) >= 2:
                st.equad_us = float(tokens[1])
                continue
            if head in ("FORMAT", "MODE", "JUMP") or stripped.startswith(("C ", "#")):
                continue
            if len(tokens) < 5:
                continue
            st.labels.append(tokens[0])
            st.freqs.append(float(tokens[1]))
            # longdouble parse keeps ~18 digits (sub-ns at MJD ~5e4)
            mjd = np.longdouble(tokens[2])
            if st.time_offset_s:
                mjd = mjd + np.longdouble(st.time_offset_s) / np.longdouble(DAY_IN_SEC)
            st.mjds.append(mjd)
            err_us = float(tokens[3])
            err_us = np.hypot(st.efac * err_us, st.equad_us)
            st.errs.append(err_us * 1e-6)  # us -> s
            st.obs.append(tokens[4])
            st.flags.append(_parse_flag_tail(tokens[5:]))


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _is_flag_key(tok: str) -> bool:
    """'-fe' is a flag key; '-1.5e-6'-style negative numbers are values.
    The char-class prefilter keeps the exception-driven float() probe off
    the hot path (keys start with letters in practice)."""
    if len(tok) < 2 or tok[0] != "-":
        return False
    c = tok[1]
    # only '-<digit>', '-.', '-inf'/'-nan' spellings can parse as floats;
    # anything else is a key without paying the float() probe
    if not (c.isdigit() or c in ".iInN"):
        return True
    return not _is_number(tok)


def _parse_flag_tail(toks) -> dict:
    """'-key value ...' pairs from a token list (or raw string)."""
    if isinstance(toks, str):
        toks = toks.split()
    out = {}
    i, n = 0, len(toks)
    while i < n:
        tok = toks[i]
        if _is_flag_key(tok):
            if i + 1 < n and not _is_flag_key(toks[i + 1]):
                out[tok[1:]] = toks[i + 1]
                i += 2
                continue
            out[tok[1:]] = ""
        i += 1
    return out


#: files read since the last ``clear()``, by parser ("native" or "python")
reads: Counter = Counter()
_READS_LOCK = threading.Lock()


def read_tim(path: str, use_native: bool = True) -> TOAData:
    """Parse a Tempo2 ``FORMAT 1`` tim file (with SKIP/NOSKIP, INCLUDE,
    TIME, EFAC, EQUAD command handling), under a ``read_tim`` span with the
    ``io.tim.files`` and ``io.tim.toas`` counters.

    Plain files go through the native C++ tokenizer (csrc/fast_tim.cpp,
    built at first use; a failed build raises); files with stateful
    directives, or every file with ``use_native=False``, go through the
    Python parser. :data:`reads` counts the files each parser read.
    """
    from ..obs import counter, span

    with span("read_tim", file=os.path.basename(path)) as sp:
        toas = _read_tim_impl(path, use_native, sp)
        sp["ntoa"] = toas.ntoas
        counter("io.tim.files").inc()
        counter("io.tim.toas").inc(toas.ntoas)
    return toas


def _read_tim_impl(path: str, use_native: bool, span_attrs: dict) -> TOAData:
    if use_native:
        from .native import fast_read_tim

        fast = fast_read_tim(path)
        if fast is not None:
            mjd, errs, freqs, labels, obs, flag_strs = fast
            with _READS_LOCK:
                reads["native"] += 1
            span_attrs["parser"] = "native"
            return TOAData(
                mjd=mjd,
                errors_s=errs,
                freqs_mhz=freqs,
                observatories=obs,
                flags=[_parse_flag_tail(s) for s in flag_strs],
                labels=labels,
            )
    st = _TimParserState()
    _parse_tim_into(path, st)
    with _READS_LOCK:
        reads["python"] += 1
    span_attrs["parser"] = "python"
    return TOAData(
        mjd=np.array(st.mjds, dtype=np.longdouble),
        errors_s=np.array(st.errs, dtype=np.float64),
        freqs_mhz=np.array(st.freqs, dtype=np.float64),
        observatories=st.obs,
        flags=st.flags,
        labels=st.labels,
    )


def _static_line_parts(
    toas: TOAData, name: Optional[str], reuse_cache: bool = False,
    pairs_only: bool = False,
):
    """Pre-rendered epoch-invariant parts of every tim line: a list of
    ``(prefix, suffix)`` pairs (prefix = " label freq", suffix =
    "err obs flags") plus the ``"prefix\\x1fsuffix\\n"`` byte stream the
    native writer consumes. Returns ``(pairs, stream_bytes)``; ``pairs``
    is None on a cache hit (only the bytes are retained — so the
    static-cache speedup is a native-writer feature; the Python writer
    re-renders pairs per write, with ``pairs_only=True`` skipping the
    then-unused byte join), and ``stream_bytes`` is None when
    ``pairs_only``.

    ``reuse_cache`` is an *opt-in* contract for callers that rewrite the
    same TOAs with only the epochs changed (the dataset-materialization
    sweep, utils/export.py, where rendering these parts — flag joins +
    float formatting — was ~70% of the write cost). Default off: plain
    ``write_tim`` callers may mutate flag/error/label elements in place
    between writes, which no cheap cache key can detect."""
    cached = getattr(toas, "_write_parts_cache", None)
    if reuse_cache and cached is not None and cached[0] == (name, toas.ntoas):
        return None, cached[1]
    pairs = []
    for i in range(toas.ntoas):
        label = name or (toas.labels[i] if toas.labels else "toa")
        flag_str = "".join(
            f" -{k} {v}" for k, v in (toas.flags[i] if toas.flags else {}).items()
        )
        pre = f" {label} {toas.freqs_mhz[i]:.8f}"
        suf = f"{toas.errors_s[i]*1e6:.10g} {toas.observatories[i]}{flag_str}"
        # Control characters in metadata would corrupt FORMAT-1 output:
        # '\n' injects bogus records (the Python writer would silently
        # write a malformed line), '\x1f' is the native writer's field
        # separator (it would abort mid-file, leaving a truncated tim),
        # '\r' splits lines on round-trip. Fail loudly before any file
        # byte is written.
        bad = pre + suf
        if "\n" in bad or "\x1f" in bad or "\r" in bad:
            raise ValueError(
                f"TOA {i}: label/observatory/flag metadata contains a "
                "control character (\\n, \\r, or \\x1f) that would corrupt "
                f"the tim file: {bad!r}"
            )
        pairs.append((pre, suf))
    if pairs_only:
        return pairs, None
    text = "".join(f"{p}\x1f{s}\n" for p, s in pairs).encode()
    if reuse_cache:
        toas._write_parts_cache = ((name, toas.ntoas), text)
    return pairs, text


def _mjd_day_frac15(mjd):
    """Split longdouble MJD epochs into (int day, int 1e-15-day fraction)
    — 86 ps resolution, exact to carry."""
    day = np.floor(mjd).astype(np.int64)
    frac = (mjd - day.astype(np.longdouble)) * np.longdouble(1e15)
    f15 = np.rint(frac).astype(np.int64)
    carry = f15 >= 10**15
    return day + carry, np.where(carry, 0, f15)


def write_tim(
    toas: TOAData,
    path: str,
    name: Optional[str] = None,
    reuse_static_parts: bool = False,
    use_native: bool = True,
) -> None:
    """Serialize TOAs back to a Tempo2 ``FORMAT 1`` tim file.

    Reference analog: ``toas.write_TOA_file(outtim, format='Tempo2')``
    (pta_replicator/simulate.py:75). Uses the native (C++) writer (the
    egress mirror of the parse fast path; a failed build raises), or the
    Python writer with ``use_native=False``; both emit epochs at fixed
    15-decimal (86 ps) precision, the same bytes. ``reuse_static_parts``:
    opt-in cache of the epoch-invariant line parts for callers that
    guarantee only the epochs change between writes (see
    _static_line_parts).
    """
    if toas.ntoas == 0:  # empty set: a valid header-only file
        with open(path, "w") as fh:
            fh.write("FORMAT 1\nMODE 1\n")
        return
    day, f15 = _mjd_day_frac15(toas.mjd)
    if use_native:
        from .native import fast_write_tim

        _, text = _static_line_parts(toas, name, reuse_cache=reuse_static_parts)
        fast_write_tim(path, day, f15, text)
        return
    pairs, _ = _static_line_parts(toas, name, pairs_only=True)
    with open(path, "w") as fh:
        fh.write("FORMAT 1\nMODE 1\n")
        fh.writelines(
            f"{pre} {d}.{f:015d} {suf}\n"
            for (pre, suf), d, f in zip(pairs, day, f15)
        )


def fabricate_toas(
    mjds,
    error_us,
    freq_mhz=1440.0,
    observatory: str = "AXIS",
    flags: Optional[dict] = None,
) -> TOAData:
    """Build a synthetic evenly-specified TOA set.

    Reference analog: ``pint.simulation.make_fake_toas_fromMJDs`` as used by
    ``simulate_pulsar`` (pta_replicator/simulate.py:119-123).
    """
    mjds = np.asarray(mjds, dtype=np.longdouble)
    n = len(mjds)
    err = np.broadcast_to(np.asarray(error_us, dtype=np.float64) * 1e-6, (n,)).copy()
    frq = np.broadcast_to(np.asarray(freq_mhz, dtype=np.float64), (n,)).copy()
    flagdicts = [dict(flags) if flags else {} for _ in range(n)]
    return TOAData(
        mjd=mjds.copy(),
        errors_s=err,
        freqs_mhz=frq,
        observatories=[observatory] * n,
        flags=flagdicts,
        labels=["fake"] * n,
    )
