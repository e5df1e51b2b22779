"""Tests of the benchmark harness.  They run on the CPU through the
program's plain PyTorch kernels at a tiny size; the tests marked ``gpu``
need a CUDA card and skip without one.

    python -m pytest bench_port/tests -q
"""

import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))           # the harness's modules
sys.path.insert(0, str(HERE.parent.parent))    # the program

@pytest.fixture
def cuda():
    """Skips the test when there is no CUDA card (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def driver_of(workload: str):
    """(the workload's driver, its configuration dict)."""
    import harness
    _, cfg, traffic = harness.cell(harness.load_spec(), workload)
    return harness.driver(traffic["loop"]), cfg


def tiny(workload: str) -> dict:
    """The size a CPU run of the workload is cut to: its driver's
    ``TINY``, as a fresh copy."""
    import copy
    return copy.deepcopy(driver_of(workload)[0].TINY)
