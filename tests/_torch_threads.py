"""One intra-op thread for PyTorch in each test process.

The suite runs under ``pytest -n 6 --dist loadfile``: one worker process
per core, each running whole files. PyTorch's default intra-op pool takes
every core in every worker, so six workers time-share 8 cores with ~50
spinning threads, and a CPU-bound port test ran 10-17x slower under the
suite than alone. Every ``tests/test_torch_*.py`` file imports this module;
scripts the tests start as subprocesses get ``OMP_NUM_THREADS=1``
(:data:`SUBPROCESS_ENV`) for the same reason.
"""
import torch

torch.set_num_threads(1)

SUBPROCESS_ENV = {"OMP_NUM_THREADS": "1"}
