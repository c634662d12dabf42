"""Resumable realization sweeps (``sweep.py``) and batch persistence
(``checkpoint.py``)."""
