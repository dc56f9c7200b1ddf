"""Shared helpers of the benchmark's tests: cells cut to a size the CPU
runs in seconds, driven through the harness with the plain versions."""
import dataclasses

import pytest
import torch

from portbench import harness


def small(name: str, columns: int = 8, **spec) -> harness.Cell:
    """Cell ``name`` at ``columns`` columns (its configuration's NGPTOT),
    its file's fields overridden by ``spec``."""
    cell = harness.load_cell(name)
    return dataclasses.replace(cell, config={**cell.config, "ngptot": columns}, spec={**cell.spec, **spec})


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
