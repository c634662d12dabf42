"""Observability of the port: the numerics ledger (``numerics.py``) that
gates the bf16 rung of the fused likelihood. Spans, counters and traces
are not ported yet (ROADMAP A.16)."""
