# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Eta levels; the port of :mod:`cloudsc2_tpu.physics.diagnostics`."""
from __future__ import annotations

import torch

from cloudsc2_tpu_torch.physics.fastmath import div


def eta_levels(ap: torch.Tensor, aph: torch.Tensor) -> torch.Tensor:
    """The 1-D eta coordinate from column 0: ``ap[:, 0] / aph[-1, 0]``."""
    return div(ap[:, 0], aph[-1, 0])
