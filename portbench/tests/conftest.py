"""CPU tests of the benchmark; tests marked ``gpu`` need a CUDA card and
skip elsewhere (the card is looked for in a fixture, never at import)."""

import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# a configuration small enough for the CPU: every stage of the cells' step
# runs, on 120x160 frames and a window of 6 + 1 + 3
TINY = dict(frame_height=120, frame_width=160, working_height=96, past_frames=6,
            future_frames=3, stabilizer={"gftt": {"max_features": 130}}, chunk=4)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skipped elsewhere")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def cpu_context(cell, seed=2**31 + 12345, seconds=1.0, trace=False):
    import torch

    from portbench import harness

    return harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                           device=torch.device("cpu"), t_process=time.monotonic(),
                           overrides=TINY)
