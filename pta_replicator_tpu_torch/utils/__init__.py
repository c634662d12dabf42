"""Resumable realization sweeps (``sweep.py``), batch persistence
(``checkpoint.py``), the scenario compiler's key derivation (``prng.py``)
and the population path's cosmology (``cosmology.py``)."""
