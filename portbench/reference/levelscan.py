# Frozen copy of cloudsc2_tpu_torch/kernels/levelscan.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The level-scan harness, plain version; the port of
:func:`cloudsc2_tpu.pallas.levelscan.level_scan_pallas` (top-down form).

Its device counterpart is ``csrc/levelscan.cuh``: one thread per column,
the carry in registers, the levels in a loop.  Here the same contract is a
Python loop over levels on ``(ncols,)`` rows, with the carry zeroed at the
top.  The bottom-up ``reverse`` form and the fused forward + reverse form
(the port of ``level_scan_fwdrev_pallas``) run only in the kernels (the
AD's reverse kernel ``csrc/adjoint.cu``, the fused AD ``csrc/ad_fused.cu``);
the AD's plain version needs neither, it is ``torch.func.vjp`` of the plain
TL.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

Carry = Tuple[torch.Tensor, ...]
Body = Callable[
    [Carry, Dict[str, torch.Tensor], Mapping[str, torch.Tensor]],
    Tuple[Carry, Dict[str, torch.Tensor]],
]


def level_scan(
    body: Body,
    level_inputs: Mapping[str, torch.Tensor],
    col_inputs: Mapping[str, torch.Tensor],
    scalar_inputs: Mapping[str, torch.Tensor],
    ncarry: int,
) -> Dict[str, torch.Tensor]:
    """Run ``body(carry, x, col)`` over the levels, top down.

    ``level_inputs`` are ``(nlev, ncols)`` streams; ``x`` holds their row
    for the level plus the level's entry of each ``(nlev,)`` tensor of
    ``scalar_inputs`` (0-d).  ``col_inputs`` are ``(ncols,)`` and passed
    through.  The carry is a tuple of ``ncarry`` ``(ncols,)`` tensors,
    zero at the top.  Returns each output of ``body`` stacked to
    ``(nlev, ncols)``.
    """
    ref = next(iter(level_inputs.values()))
    nlev, ncols = ref.shape
    for name, v in level_inputs.items():
        if tuple(v.shape) != (nlev, ncols):
            raise ValueError(f"level input {name!r} has shape {tuple(v.shape)}, want {(nlev, ncols)}")
    for name, v in scalar_inputs.items():
        if tuple(v.shape) != (nlev,):
            raise ValueError(f"scalar input {name!r} has shape {tuple(v.shape)}, want {(nlev,)}")
    carry: Carry = tuple(torch.zeros(ncols, dtype=ref.dtype, device=ref.device) for _ in range(ncarry))
    rows: Dict[str, list] = {}
    for k in range(nlev):
        x = {n: v[k] for n, v in level_inputs.items()}
        x.update({n: v[k] for n, v in scalar_inputs.items()})
        carry, outs = body(carry, x, col_inputs)
        for n, v in outs.items():
            rows.setdefault(n, []).append(v)
    return {n: torch.stack(v) for n, v in rows.items()}
