"""Cap torch's intra-op threads for the port's CPU tests.

Every ``tests/test_torch_*.py`` file imports this module. The suite runs
under pytest-xdist with six workers, and each worker imports every test
file; left alone, torch gives each worker a pool of as many threads as the
machine has cores, so six workers running port tests oversubscribe the
cores and slow the timing-sensitive tests that share the machine with them.
The cap gives each worker an equal share of the cores (at least one).
"""

import os

import torch

WORKERS = 6  # the tier-1 run's ``-p xdist -n 6``
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)

if torch.get_num_threads() > THREADS:
    torch.set_num_threads(THREADS)
