# Frozen copy of cloudsc2_tpu_torch/physics/diagnostics.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Eta levels; the port of :mod:`cloudsc2_tpu.physics.diagnostics`."""
from __future__ import annotations

import torch

from .fastmath import div


def eta_levels(ap: torch.Tensor, aph: torch.Tensor) -> torch.Tensor:
    """The 1-D eta coordinate from column 0: ``ap[:, 0] / aph[-1, 0]``."""
    return div(ap[:, 0], aph[-1, 0])
