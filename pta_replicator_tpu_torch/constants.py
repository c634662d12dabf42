"""Physical constants in the units used throughout the port.

A copy of ``pta_replicator_tpu/constants.py`` (the port imports nothing of
the JAX package), so that injected amplitudes agree bit for bit.
"""
import scipy.constants as _sc

DAY_IN_SEC = 86400.0
YEAR_IN_SEC = 365.25 * DAY_IN_SEC

#: radians <-> milliarcseconds (the par files' proper-motion and parallax
#: units)
RAD_TO_MAS = (180.0 / _sc.pi) * 3.6e6
MAS_TO_RAD = 1.0 / RAD_TO_MAS

#: Geometrized solar mass: G M_sun / c^3 [s]
SOLAR2S = _sc.G / _sc.c**3 * 1.98855e30
#: kiloparsec in light-seconds
KPC2S = _sc.parsec / _sc.c * 1e3
#: megaparsec in light-seconds
MPC2S = _sc.parsec / _sc.c * 1e6
#: astronomical unit in parsec (solar-wind dispersion geometry)
AU_PC = _sc.au / _sc.parsec
