# Frozen copy of cloudsc2_tpu_torch/physics/increment.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""State increment and perturbed state of the TL/AD validation protocols;
the port of :mod:`cloudsc2_tpu.physics.increment` (``INCREMENT_FIELDS:23``,
``state_increment:43``, ``perturbed_state:61``).

Pointwise, on state dicts keyed by the reference field names.  The JAX
module imports ``jax.numpy``, so the field tuple is restated here (a test
holds the two equal).
"""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor

#: the 16 perturbed fields, in the JAX package's order
INCREMENT_FIELDS = (
    "aph", "ap", "q", "qsat", "t", "ql", "qi", "lude", "lu", "mfu", "mfd",
    "tnd_cml_t", "tnd_cml_q", "tnd_cml_ql", "tnd_cml_qi", "supsat",
)


def state_increment(
    state: Dict[str, Tensor], factor: float, *, ignore_supsat: bool = False
) -> Dict[str, Tensor]:
    """The perturbation dict ``{name}_i = factor * {name}``;
    ``ignore_supsat`` zeroes the supersaturation increment (symmetry test)."""
    out = {}
    for name in INCREMENT_FIELDS:
        if name == "supsat" and ignore_supsat:
            out[name + "_i"] = torch.zeros_like(state[name])
        else:
            out[name + "_i"] = factor * state[name]
    return out


def perturbed_state(state: Dict[str, Tensor], factor: float) -> Dict[str, Tensor]:
    """``{name} = {name} + factor * {name}_i`` for the 16 fields; the other
    entries (``eta``, the increments) pass through."""
    out = dict(state)
    for name in INCREMENT_FIELDS:
        out[name] = state[name] + factor * state[name + "_i"]
    return out
