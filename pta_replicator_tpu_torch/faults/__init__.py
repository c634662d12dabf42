"""Error classification and retry policy shared by the sweep's supervised
retry and the prefetcher's staging retry (``retry.py``)."""
