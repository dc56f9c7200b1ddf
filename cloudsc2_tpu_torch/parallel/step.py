# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Step functions: the NL hot-loop step and the full NL + TL + AD pipeline;
the one-device half of :mod:`cloudsc2_tpu.parallel.step` (``forward_step:61``,
``full_step:111``).

The framework's "training step" analogue is the complete symmetry-test
pipeline (reference ``physics/adjoint/validation.py:132-165``): saturation
-> state increment -> tangent-linear -> adjoint -> the two per-column
norms.  Both functions call :mod:`cloudsc2_tpu_torch.dispatch` directly,
not the component layer, whose every call ends in a device sync: on CUDA
tensors they enqueue the kernels on PyTorch's current stream and return
without waiting, so a caller can overlap them with copies
(:func:`cloudsc2_tpu_torch.parallel.stream.stream_columns`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from cloudsc2_tpu_torch import dispatch
from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.validation.symmetry import DIAG_NAMES, TEND_NAMES, SymmetryTest

Tensor = torch.Tensor


def forward_step(
    state: Dict[str, Tensor], dt: float, c: Constants, fuse_saturation: bool = True
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Saturation + nonlinear scheme (the reference hot loop,
    ``drivers/run_nonlinear.py:115-119``); ``diags["qsat"]`` carries the
    saturation.

    With ``fuse_saturation`` (the default) one NL step diagnoses ``qsat``
    itself, a single kernel launch on CUDA tensors; it is bitwise
    ``Saturation`` followed by the unfused step, which ``fuse_saturation=
    False`` runs.  ``kflag`` is 1 and ``c.LPHYLIN`` picks the branch, as in
    the JAX step; ``c.FAST_DIV`` is the kernel's divide mode.

    A caller-provided ``state["eta"]`` is used as-is; eta is derived here
    only when missing.  It is defined from column 0 of the whole state
    (reference ``common/diagnostics.py:28-45``), so a caller that hands in
    a subset of the columns passes it in, as the stream does.
    """
    s = dict(state)
    if "eta" not in s:
        s["eta"] = eta_levels(s["ap"], s["aph"])
    if fuse_saturation:
        s.pop("qsat", None)
        return dispatch.cloudsc2_nl(s, dt, c, fuse_saturation=True, kflag=1)
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    tends, diags = dispatch.cloudsc2_nl(s, dt, c)
    diags["qsat"] = s["qsat"]
    return tends, diags


def full_step(
    state: Dict[str, Tensor], dt: float, c: Constants, factor: float = 0.01
) -> Tuple[Dict[str, Tensor], Tensor, Tensor]:
    """The complete NL + TL + AD pipeline with symmetry norms.

    Returns ``(nl_tendencies, norm1, norm2)``, the norms the per-column
    ``<Mx, Mx>`` and ``<x, M*(Mx)>`` of the symmetry test
    (:meth:`SymmetryTest.get_norm1` / ``get_norm2``), on the state's device.
    The TL computes the forward trajectory beside the directional
    derivative and returns the forward tendencies, so they are the NL
    tendencies: no NL step runs apart (the reference's symmetry protocol
    does the same, ``adjoint/validation.py:132-151``).
    """
    s = dict(state)
    if "eta" not in s:
        s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)

    incr = state_increment(s, factor, ignore_supsat=True)
    s.update(incr)
    tends_tl, diags_tl = dispatch.cloudsc2_tl(s, dt, c)
    tends_nl = {n: tends_tl[n] for n in TEND_NAMES}
    norm1 = SymmetryTest.get_norm1(tends_tl, diags_tl)

    for name in TEND_NAMES:
        s["tnd_" + name] = tends_tl[name]
        s["tnd_" + name + "_i"] = tends_tl[name + "_i"]
    for name in DIAG_NAMES:
        s[name + "_i"] = diags_tl[name + "_i"]
    tends_ad, diags_ad = dispatch.cloudsc2_ad(s, dt, c)
    norm2 = SymmetryTest.get_norm2(incr, tends_ad, diags_ad)
    return tends_nl, norm1, norm2
