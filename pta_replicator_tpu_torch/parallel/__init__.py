"""The bounded-window stage-graph executor (``stages.py``), the sweep's
dispatch -> readback -> write pipeline (``pipeline.py``) and the
host-to-device tile prefetcher with its plane-tile cache
(``prefetch.py``)."""
