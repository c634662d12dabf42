"""Tempo/Tempo2/PINT-style ``.par`` timing-model file parser.

Counterpart of ``pta_replicator_tpu/io/par.py``, a copy (the port imports
nothing of the JAX package): the same accessors, and ``write`` emits the
same bytes. The reference framework delegates par parsing to PINT
(``pint.models.get_model``, pta_replicator/simulate.py:118,154).
This framework is standalone: it carries its own parser that extracts the
parameters the simulation layer needs (spin, astrometry, DM) while preserving
every line verbatim for lossless round-tripping via :func:`ParModel.write`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# Keys whose values are plain floats we want typed access to.
_FLOAT_KEYS = {
    "F0", "F1", "F2", "F3",
    "PEPOCH", "POSEPOCH", "DMEPOCH",
    "DM", "DM1", "DM2",
    "PX", "PMRA", "PMDEC", "PMELONG", "PMELAT",
    "ELONG", "ELAT",
    "START", "FINISH", "TZRMJD", "NTOA", "CHI2R",
}


def _parse_hms(text: str) -> float:
    """Parse ``hh:mm:ss.s`` into decimal hours (sign-aware)."""
    sign = -1.0 if text.lstrip().startswith("-") else 1.0
    parts = [abs(float(p)) for p in text.split(":")]
    while len(parts) < 3:
        parts.append(0.0)
    return sign * (parts[0] + parts[1] / 60.0 + parts[2] / 3600.0)


def _parse_dms(text: str) -> float:
    """Parse ``dd:mm:ss.s`` into decimal degrees (sign-aware)."""
    return _parse_hms(text)  # same sexagesimal structure


def _parse_float(token) -> float:
    """Float with tempo's legacy D/d exponent style normalized — the ONE
    numeric-token parser for par values (JUMP offsets, FD terms, DMX
    values and ranges), so no site can forget the normalization."""
    return float(str(token).replace("D", "E").replace("d", "e"))


@dataclass
class ParModel:
    """A parsed pulsar timing model.

    Angles follow the conventions of the reference's ``loc`` dicts
    (pta_replicator/simulate.py:127-132): RAJ in decimal
    *hours*, DECJ in decimal *degrees*, ELONG/ELAT in decimal degrees.
    """

    name: str = ""
    raj_hours: Optional[float] = None
    decj_deg: Optional[float] = None
    elong_deg: Optional[float] = None
    elat_deg: Optional[float] = None
    f0: float = 1.0
    f1: float = 0.0
    f2: float = 0.0
    pepoch_mjd: float = 0.0
    dm: float = 0.0
    params: dict = field(default_factory=dict)
    lines: list = field(default_factory=list)
    path: Optional[str] = None

    @property
    def loc(self) -> dict:
        """Sky-location dict in the reference's units convention."""
        if self.raj_hours is not None and self.decj_deg is not None:
            return {"RAJ": self.raj_hours, "DECJ": self.decj_deg}
        if self.elong_deg is not None and self.elat_deg is not None:
            return {"ELONG": self.elong_deg, "ELAT": self.elat_deg}
        raise AttributeError(
            "No pulsar location information (RAJ/DECJ or ELONG/ELAT) in parfile."
        )

    def set_param(self, key: str, value: float, fmt: str = ".20g") -> None:
        """Update a parameter value, keeping typed fields and the verbatim
        line store in sync (so :meth:`write` persists post-fit models)."""
        key = key.upper()
        text = format(value, fmt)
        if key == "F0":
            self.f0 = value
        elif key == "F1":
            self.f1 = value
        elif key == "F2":
            self.f2 = value
        elif key == "PEPOCH":
            self.pepoch_mjd = value
        elif key == "DM":
            self.dm = value
        elif key == "RAJ":  # decimal hours (colon-free floats re-parse fine)
            self.raj_hours = value
        elif key == "DECJ":  # decimal degrees
            self.decj_deg = value
        updated = False
        for i, line in enumerate(self.lines):
            tokens = line.split()
            if tokens and tokens[0].upper() == key:
                tokens[1] = text
                self.lines[i] = "\t\t".join(tokens[:2]) + (
                    ("\t" + " ".join(tokens[2:])) if len(tokens) > 2 else ""
                )
                updated = True
                break
        if not updated:
            self.lines.append(f"{key}\t\t{text}")
        self.params[key] = [text] + self.params.get(key, [None, None])[1:]

    def set_param_error(self, key: str, error: float, fmt: str = ".20g") -> None:
        """Write a parameter's 1-sigma uncertainty into the par line's
        error column (tempo/PINT layout ``KEY value fit_flag error``).
        A missing fit flag is filled with "1" — errors are only written
        for parameters the fit actually varied. The error is in the
        par file's native display units for that key (e.g. RAJ in
        seconds of right ascension, PX in mas)."""
        key = key.upper()
        text = format(error, fmt)
        for i, line in enumerate(self.lines):
            tokens = line.split()
            if tokens and tokens[0].upper() == key:
                if len(tokens) < 3:
                    tokens.append("1")
                if len(tokens) < 4:
                    tokens.append(text)
                else:
                    tokens[3] = text
                self.lines[i] = "\t".join(
                    [tokens[0], tokens[1]] + tokens[2:]
                )
                vals = self.params.get(key, [tokens[1]])
                vals = list(vals) + [None] * (3 - len(vals))
                vals[1] = tokens[2]
                vals[2] = text
                self.params[key] = vals
                return

    def param_error(self, key: str):
        """1-sigma uncertainty from the par line's error column
        (``KEY value fit_flag error``), or None when absent/unparseable.
        Units are the par file's native display units for the key."""
        toks = self.params.get(key.upper())
        if toks and len(toks) >= 3 and toks[2] is not None:
            try:
                return _parse_float(toks[2])
            except ValueError:
                return None
        return None

    def _jump_lines(self):
        """(line_index, tokens) of every flag-matched JUMP declaration —
        the single filter behind :attr:`jumps` and :meth:`set_jump`, so
        their index mappings can never drift apart."""
        for i, line in enumerate(self.lines):
            tokens = line.split()
            if (
                len(tokens) >= 4
                and tokens[0].upper() == "JUMP"
                and tokens[1].startswith("-")
            ):
                try:
                    _parse_float(tokens[3])
                except ValueError:
                    continue
                yield i, tokens

    @property
    def jumps(self):
        """Flag-matched JUMP declarations, in par-file order.

        Each entry is ``(flag_name, flag_value, offset_s)`` parsed from
        ``JUMP -<flag> <value> <offset> [fit] [err]`` lines — the NANOGrav
        convention all three reference fixtures use (e.g.
        test_partim/par/B1855+09.par "JUMP -fe L-wide ...").
        ``params`` cannot hold these (multiple JUMP lines would collide on
        one key), so they parse from the verbatim line store. MJD-range /
        frequency-range JUMP forms are skipped.
        """
        return [
            (tokens[1].lstrip("-"), tokens[2], _parse_float(tokens[3]))
            for _, tokens in self._jump_lines()
        ]

    def set_jump(self, index: int, offset_s: float) -> None:
        """Update the ``index``-th flag-matched JUMP line's offset value."""
        for seen, (i, tokens) in enumerate(self._jump_lines()):
            if seen == index:
                tokens[3] = format(offset_s, ".20g")
                self.lines[i] = "\t".join(tokens)
                return
        raise IndexError(f"par file has no flag-matched JUMP #{index}")

    def set_jump_error(self, index: int, error_s: float) -> None:
        """Write the ``index``-th flag-matched JUMP line's 1-sigma
        uncertainty (``JUMP -flag value offset fit error`` layout)."""
        for seen, (i, tokens) in enumerate(self._jump_lines()):
            if seen == index:
                if len(tokens) < 5:
                    tokens.append("1")
                if len(tokens) < 6:
                    tokens.append(format(error_s, ".20g"))
                else:
                    tokens[5] = format(error_s, ".20g")
                self.lines[i] = "\t".join(tokens)
                return
        raise IndexError(f"par file has no flag-matched JUMP #{index}")

    # ----------------------------------------------------------- WAVE model
    @property
    def wave_om(self):
        """WAVE fundamental frequency [rad/day], or None when the par
        declares no waves (tempo2/PINT harmonic-whitening model)."""
        if "WAVE_OM" in self.params:
            try:
                return _parse_float(self.params["WAVE_OM"][0])
            except ValueError:
                return None
        return None

    @property
    def wave_epoch(self):
        """WAVEEPOCH [MJD] (PEPOCH when absent, the tempo2 default)."""
        for key in ("WAVEEPOCH", "WAVE_EPOCH"):
            if key in self.params:
                try:
                    return _parse_float(self.params[key][0])
                except ValueError:
                    pass
        return self.pepoch_mjd

    @property
    def waves(self):
        """[(A_sin, B_cos), ...] for WAVE1..WAVEn [s]: harmonic k of
        WAVE_OM contributes A sin(k om (t - epoch)) + B cos(...). Two
        values share one ``WAVEk`` line, so (like JUMPs) these parse from
        the verbatim line store, not ``params``."""
        by_k = {}
        for line in self.lines:
            tokens = line.split()
            if len(tokens) >= 3 and tokens[0].upper().startswith("WAVE"):
                tail = tokens[0][4:]
                if tail.isdigit():
                    try:
                        by_k[int(tail)] = (
                            _parse_float(tokens[1]), _parse_float(tokens[2])
                        )
                    except ValueError:
                        pass
        if not by_k:
            return []
        # a numbering gap (hand-edited par) becomes a zero-amplitude
        # placeholder rather than silently truncating every higher
        # harmonic out of the model/fit/write-back
        return [by_k.get(k, (0.0, 0.0)) for k in range(1, max(by_k) + 1)]

    def set_wave(self, index: int, a_sin: float, b_cos: float) -> None:
        """Update (or append) the ``WAVE{index+1}`` harmonic amplitudes."""
        key = f"WAVE{index + 1}"
        text = f"{format(a_sin, '.20g')} {format(b_cos, '.20g')}"
        for i, line in enumerate(self.lines):
            tokens = line.split()
            if tokens and tokens[0].upper() == key:
                self.lines[i] = f"{key}\t\t{text}"
                return
        self.lines.append(f"{key}\t\t{text}")

    def ensure_waves(self, n: int, om: float = None, epoch: float = None):
        """Declare ``n`` zero-amplitude WAVE harmonics (adding WAVE_OM /
        WAVEEPOCH when absent) so a fit can use the harmonic-whitening
        columns as a nuisance basis on models that had none.

        ``om`` [rad/day] is required when the par has no WAVE_OM
        (2*pi/(1.05*span_days) is the usual choice); when the par
        already declares WAVE_OM, a conflicting ``om`` raises instead of
        silently keeping the old basis under the caller's nose."""
        existing = self.wave_om
        if existing is None:
            if om is None:
                raise ValueError(
                    "par has no WAVE_OM; pass om=2*pi/span_days explicitly"
                )
            self.set_param("WAVE_OM", om)
        elif om is not None and abs(om - existing) > 1e-12 * abs(existing):
            raise ValueError(
                f"par already declares WAVE_OM={existing!r}; refusing to "
                f"rebase the existing harmonics onto om={om!r} (drop the "
                "om argument to extend the existing basis)"
            )
        if epoch is not None:
            self.set_param("WAVEEPOCH", epoch)
        have = len(self.waves)
        for k in range(have, n):
            self.set_wave(k, 0.0, 0.0)

    @property
    def fd_terms(self):
        """[FD1, FD2, ...] profile-evolution coefficients [s], in order.
        PINT/tempo2 convention: delay = sum_k FDk * ln(f_GHz)^k."""
        out = []
        k = 1
        while f"FD{k}" in self.params:
            try:
                out.append(_parse_float(self.params[f"FD{k}"][0]))
            except ValueError:
                break
            k += 1
        return out

    @property
    def dmx_windows(self):
        """NANOGrav DMX dispersion windows: [(label, dmx, r1_mjd, r2_mjd)]
        sorted by label, parsed from DMX_xxxx / DMXR1_xxxx / DMXR2_xxxx
        parameter triples."""
        out = []
        for key, tokens in self.params.items():
            if not key.startswith("DMX_"):
                continue
            idx = key[4:]
            r1 = self.params.get(f"DMXR1_{idx}")
            r2 = self.params.get(f"DMXR2_{idx}")
            if not (r1 and r2):
                continue
            try:
                out.append((
                    idx,
                    _parse_float(tokens[0]),
                    _parse_float(r1[0]),
                    _parse_float(r2[0]),
                ))
            except ValueError:
                continue
        # time order (not label order): the delay model's searchsorted
        # pass requires monotonic window starts, and labels need not be
        # zero-padded ('10' sorts before '2' lexicographically)
        return sorted(out, key=lambda w: w[2])

    def write(self, path: str) -> None:
        """Write the par file back out, preserving original content."""
        with open(path, "w") as fh:
            for line in self.lines:
                fh.write(line.rstrip("\n") + "\n")


def read_par(path: str) -> ParModel:
    """Parse a ``.par`` file into a :class:`ParModel` (a ``read_par`` span
    and the ``io.par.files`` counter)."""
    from ..obs import counter, span

    with span("read_par", file=os.path.basename(path)) as sp:
        with open(path) as fh:
            model = parse_par_lines(fh.read().splitlines(), path=path)
        sp["nparams"] = len(model.params)
        counter("io.par.files").inc()
    return model


def parse_par_lines(lines, path: Optional[str] = None) -> ParModel:
    """A :class:`ParModel` from the lines of a par file (``ParModel.lines``
    of another model, e.g. one carried across from the JAX package)."""
    model = ParModel(path=path)
    for line in lines:
        model.lines.append(line)
        stripped = line.strip()
        if not stripped or stripped.startswith(("#", "C ")):
            continue
        tokens = stripped.split()
        key = tokens[0].upper()
        if len(tokens) < 2:
            continue
        value = tokens[1]
        model.params[key] = tokens[1:]
        if key in ("PSR", "PSRJ", "PSRB"):
            model.name = value
        elif key == "RAJ":
            model.raj_hours = _parse_hms(value)
        elif key == "DECJ":
            model.decj_deg = _parse_dms(value)
        elif key in _FLOAT_KEYS:
            try:
                fval = _parse_float(value)
            except ValueError:
                continue
            if key == "F0":
                model.f0 = fval
            elif key == "F1":
                model.f1 = fval
            elif key == "F2":
                model.f2 = fval
            elif key == "PEPOCH":
                model.pepoch_mjd = fval
            elif key == "DM":
                model.dm = fval
            elif key == "ELONG":
                model.elong_deg = fval
            elif key == "ELAT":
                model.elat_deg = fval
    return model
