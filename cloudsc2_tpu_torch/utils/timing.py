# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Wall-clock timing: a process-wide :class:`Timer` accumulated by
``timing(label)`` blocks (the surface of the reference drivers' timing,
restated from :mod:`cloudsc2_tpu.utils.timing`), and :func:`device_sync`.

PyTorch returns from a CUDA call before the device has finished, so a
``timing`` block around device work must end in :func:`device_sync`.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator

import torch

__all__ = ["Timer", "timing", "device_sync"]

_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6}


class Timer:
    """Process-wide accumulating timer keyed by label."""

    _times: Dict[str, float] = {}
    _counts: Dict[str, int] = {}

    @classmethod
    def reset(cls) -> None:
        cls._times = {}
        cls._counts = {}

    @classmethod
    def add(cls, label: str, seconds: float) -> None:
        cls._times[label] = cls._times.get(label, 0.0) + seconds
        cls._counts[label] = cls._counts.get(label, 0) + 1

    @classmethod
    def get_time(cls, label: str, units: str = "ms") -> float:
        return cls._times.get(label, 0.0) * _UNITS[units]

    @classmethod
    def get_count(cls, label: str) -> int:
        return cls._counts.get(label, 0)

    @classmethod
    def labels(cls):
        return tuple(cls._times)


@contextmanager
def timing(label: str) -> Iterator[None]:
    """Accumulate the wall time of the block under ``label``."""
    start = time.perf_counter()
    try:
        yield
    finally:
        Timer.add(label, time.perf_counter() - start)


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def device_sync(tree: Any) -> Any:
    """``torch.cuda.synchronize()`` on every CUDA device holding a tensor of
    ``tree`` (nested dicts / tuples / lists); CPU tensors need nothing.
    Returns ``tree`` unchanged."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree
