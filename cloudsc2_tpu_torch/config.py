# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Execution configuration: the PyTorch analogue of
:class:`cloudsc2_tpu.config.JaxConfig` (device + precision).

The driver-level :class:`cloudsc2_tpu.config.Config` (precision, column
count, runs, validation files) is numpy-only and is reused as it is; it is
re-exported here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from cloudsc2_tpu.config import Config

__all__ = ["Config", "DTYPES", "TorchConfig"]

DTYPES = {"double": torch.float64, "single": torch.float32}


@dataclass(frozen=True)
class TorchConfig:
    """Where and in what precision the port runs.

    ``device`` is explicit ("cuda", "cuda:1", "cpu"): nothing is guessed
    from the environment, and a CUDA device on a machine without one is
    an error, never a silent fall back to the CPU.
    """

    device: str = "cuda"
    precision: str = "double"

    def __post_init__(self) -> None:
        if self.precision not in DTYPES:
            raise ValueError(f"precision must be double|single, got {self.precision!r}")

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.precision]

    def apply(self) -> torch.device:
        """Return the checked device."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device!r} requested but torch.cuda.is_available() "
                "is False (use --device cpu for the plain CPU path)"
            )
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r} (cuda | cpu)")
        return dev
