# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Timing: the shared :class:`~cloudsc2_tpu.utils.timing.Timer` and
``timing`` block, plus a torch :func:`device_sync`.

PyTorch returns from a CUDA call before the device has finished, so a
``timing`` block around device work must end in :func:`device_sync`.
"""
from __future__ import annotations

from typing import Any, Iterator

import torch

from cloudsc2_tpu.utils.timing import Timer, timing

__all__ = ["Timer", "timing", "device_sync"]


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
