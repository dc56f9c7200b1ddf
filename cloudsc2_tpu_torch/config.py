# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Configuration of the port's drivers.

:class:`Config` is the driver configuration (precision, column count,
runs, threads, checks, validation, files, sharding) with ``with_*``
methods, restated from :class:`cloudsc2_tpu.config.Config` without its JAX
execution settings: where and in what precision the scheme runs is
:class:`TorchConfig` (its ``device`` answers JAX's ``with_backend``).
:class:`IOConfig` (the CSV outputs and the host name written into them) is
:class:`cloudsc2_tpu.config.IOConfig`.  :data:`DEFAULT_CONFIG`,
:data:`DEFAULT_IO_CONFIG` and the default file paths are those of
``drivers/config.py``.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "Config", "DEFAULT_CONFIG", "DEFAULT_IO_CONFIG", "DTYPES", "IOConfig", "TorchConfig",
    "default_input_file", "default_reference_file",
]

DTYPES = {"double": torch.float64, "single": torch.float32}

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data")


@dataclass(frozen=True)
class IOConfig:
    """Driver I/O configuration (reference ``IOConfig``)."""

    output_csv_file: Optional[str] = None
    output_csv_file_stencils: Optional[str] = None
    host_name: str = "localhost"

    def with_output_csv_file(self, f: Optional[str]) -> "IOConfig":
        return dataclasses.replace(self, output_csv_file=f)

    def with_output_csv_file_stencils(self, f: Optional[str]) -> "IOConfig":
        return dataclasses.replace(self, output_csv_file_stencils=f)

    def with_host_name(self, h: str) -> "IOConfig":
        return dataclasses.replace(self, host_name=h)


@dataclass(frozen=True)
class Config:
    """Driver configuration (reference ``drivers/config.py:25-48``)."""

    precision: str = "double"  # "double" | "single"
    num_cols: int = 100
    num_runs: int = 1
    num_threads: int = 1
    enable_checks: bool = False
    enable_validation: bool = True
    input_file: Optional[str] = None
    reference_file: Optional[str] = None
    sharded: bool = False
    #: join a process group (multi-process); implies ``sharded``
    distributed: bool = False

    @property
    def dtype(self) -> Any:
        return np.float64 if self.precision == "double" else np.float32

    def with_precision(self, p: str) -> "Config":
        if p not in DTYPES:
            raise ValueError(f"precision must be double|single, got {p!r}")
        return dataclasses.replace(self, precision=p)

    def with_checks(self, enabled: bool) -> "Config":
        return dataclasses.replace(self, enable_checks=enabled)

    def with_validation(self, enabled: bool) -> "Config":
        return dataclasses.replace(self, enable_validation=enabled)

    def with_num_cols(self, n: int) -> "Config":
        return dataclasses.replace(self, num_cols=n)

    def with_num_runs(self, n: int) -> "Config":
        return dataclasses.replace(self, num_runs=n)

    def with_input_file(self, f: Optional[str]) -> "Config":
        return dataclasses.replace(self, input_file=f)

    def with_reference_file(self, f: Optional[str]) -> "Config":
        return dataclasses.replace(self, reference_file=f)

    def with_sharded(self, s: bool) -> "Config":
        return dataclasses.replace(self, sharded=s)

    def with_distributed(self, d: bool) -> "Config":
        return dataclasses.replace(self, distributed=d, sharded=self.sharded or d)


DEFAULT_CONFIG = Config()
DEFAULT_IO_CONFIG = IOConfig()


def default_input_file() -> Optional[str]:
    """``data/input_synth.h5`` (the upstream ``input.h5`` schema), if it
    exists; drivers tile its columns to ``--num-cols``."""
    path = os.path.normpath(os.path.join(_DATA_DIR, "input_synth.h5"))
    return path if os.path.exists(path) else None


def default_reference_file(precision: str) -> str:
    """The golden outputs of the synthetic workload for ``precision``."""
    return os.path.normpath(os.path.join(_DATA_DIR, f"reference_synth_{precision}.h5"))


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
