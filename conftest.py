"""Each pytest-xdist worker takes its share of the host's cores.

The workers of one run share the machine. Left alone, each sizes torch's
intra-op thread pool (and MKL's, which follows it) for every core, and the
run spends most of its time in threads that wait for a core. Under xdist a
worker sets ``OMP_NUM_THREADS`` to ``cpu_count // workers`` (at least one)
unless the environment sets it; the processes a test starts inherit it. A
serial run is left as it is. Pytest loads this file before
``tests/conftest.py`` and before any test module imports torch, so the pool
starts at that size.
"""

import os

workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if workers:
    os.environ.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // workers)))
