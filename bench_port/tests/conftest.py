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

# the tiny size every CPU run of a cell is cut to
TINY = {"config": {"height": 72, "width": 96, "num_components": 24},
        "traffic": {"clip_frames": 4, "pool": 3, "warmup_calls": 1,
                    "trace_calls": 2}}


@pytest.fixture
def cuda():
    """Skips the test when there is no CUDA card (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny() -> dict:
    """TINY, as a fresh copy."""
    import copy
    return copy.deepcopy(TINY)
