# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Component layer; the port of :mod:`cloudsc2_tpu.components`
(``Component``, ``EtaLevels``, ``Saturation``, ``StateIncrement``,
``PerturbedState``, ``Cloudsc2NL``, ``Cloudsc2TL``, ``Cloudsc2AD``).

Components are ``torch.nn.Module``s with the same property declarations
(name -> ``{dims, units}``) and the same output dicts as the JAX
components; ``forward`` takes the state dict (and the timestep for the
scheme).  Unit-tagged inputs are converted and stripped by
:mod:`cloudsc2_tpu_torch.units`.  Each ``forward`` runs in a
:func:`~cloudsc2_tpu_torch.utils.timing.timing` block named after the
component and ends in a device sync, so the label measures execution.
"""
from __future__ import annotations

import functools
import re
from typing import Any, Dict, Mapping, Tuple

import torch

from cloudsc2_tpu_torch.grid import Grid
from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.units import convert, strip_units
from cloudsc2_tpu_torch import dispatch
from cloudsc2_tpu_torch.physics import increment as _increment
from cloudsc2_tpu_torch.physics.adjoint import AD_COTANGENT_FIELDS
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.utils import timing as _timing

Tensor = torch.Tensor
PropertyDict = Dict[str, Dict[str, Any]]

# the property tables of cloudsc2_tpu/components.py:37-81, 226-275, 321-335,
# 351-400 (that module imports jax, so they are restated here)
FULL = ("levels", "columns")
IFACE = ("levels+1", "columns")
VERT = ("levels",)

UNITS = {
    "ap": "Pa", "aph": "Pa", "eta": "", "lu": "g g^-1", "lude": "kg m^-3 s^-1",
    "mfd": "kg m^-2 s^-1", "mfu": "kg m^-2 s^-1", "q": "g g^-1", "qi": "g g^-1",
    "ql": "g g^-1", "qsat": "g g^-1", "supsat": "g g^-1", "t": "K",
    "tnd_cml_q": "g g^-1 s^-1", "tnd_cml_qi": "g g^-1 s^-1",
    "tnd_cml_ql": "g g^-1 s^-1", "tnd_cml_t": "K s^-1", "clc": "", "covptot": "",
    "fhpsl": "J m^-2 s^-1", "fhpsn": "J m^-2 s^-1", "fplsl": "kg m^-2 s^-1",
    "fplsn": "kg m^-2 s^-1",
}
TEND_UNITS = {"t": "K s^-1", "q": "g g^-1 s^-1", "ql": "g g^-1 s^-1", "qi": "g g^-1 s^-1"}

_NL_INPUTS = {
    "ap": FULL, "aph": IFACE, "eta": VERT, "lu": FULL, "lude": FULL,
    "mfd": FULL, "mfu": FULL, "q": FULL, "qi": FULL, "ql": FULL,
    "qsat": FULL, "supsat": FULL, "t": FULL, "tnd_cml_q": FULL,
    "tnd_cml_qi": FULL, "tnd_cml_ql": FULL, "tnd_cml_t": FULL,
}
_NL_DIAGS = {
    "clc": FULL, "covptot": FULL, "fhpsl": IFACE, "fhpsn": IFACE,
    "fplsl": IFACE, "fplsn": IFACE,
}


def _strip_units(value: Any, to_units: str) -> Any:
    """:func:`cloudsc2_tpu_torch.units.strip_units` for unit-tagged tensors:
    the parser and dimension check give the factor, applied as a Python
    number so that the tensor keeps its dtype."""
    data = getattr(value, "data", None)
    units = getattr(value, "units", None)
    if units is None or not isinstance(data, torch.Tensor):
        return strip_units(value, to_units)
    factor = convert(1.0, str(units), to_units)
    return data if factor == 1.0 else data * factor


_INCR = {n: (IFACE if n == "aph" else FULL) for n in _increment.INCREMENT_FIELDS}


def _props(names: Mapping[str, Tuple[str, ...]]) -> PropertyDict:
    """Declarations with units; a perturbation ``*_i`` has its field's."""
    return {
        n: {"dims": d, "units": UNITS.get(n[:-2] if n.endswith("_i") else n, "")}
        for n, d in names.items()
    }


class Component(torch.nn.Module):
    """Base: property declarations and optional shape / dtype checks."""

    input_properties: PropertyDict = {}
    diagnostic_properties: PropertyDict = {}
    tendency_properties: PropertyDict = {}
    name: str = ""

    def __init_subclass__(cls, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        if "forward" in cls.__dict__:
            inner = cls.__dict__["forward"]
            cls.name = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", cls.__name__).lower()

            @functools.wraps(inner)
            def timed(self, *a: Any, **k: Any):
                with _timing.timing(self.name):
                    return _timing.device_sync(inner(self, *a, **k))

            cls.forward = timed

    def __init__(
        self,
        grid: Grid,
        constants: Constants,
        *,
        enable_checks: bool = False,
    ):
        super().__init__()
        self.grid = grid
        self.constants = constants
        self.enable_checks = enable_checks

    def _check_state(self, state: Mapping[str, Tensor]) -> Dict[str, Tensor]:
        """Strip units from the declared inputs and, with ``enable_checks``,
        check their shapes against the grid and that their dtypes are one
        floating dtype.  Returns the state to compute on."""
        out = dict(state)
        shapes = {
            FULL: self.grid.full_shape,
            IFACE: self.grid.iface_shape,
            VERT: (self.grid.nlev,),
        }
        expected = None
        for name, prop in self.input_properties.items():
            if name not in out:
                raise KeyError(f"{type(self).__name__}: missing input field {name!r}")
            v = out[name] = _strip_units(out[name], prop["units"])
            if not self.enable_checks:
                continue
            want = shapes[prop["dims"]]
            if tuple(v.shape) != want:
                raise ValueError(
                    f"{type(self).__name__}: field {name!r} has shape {tuple(v.shape)}, want {want}"
                )
            if not v.is_floating_point():
                raise TypeError(f"{type(self).__name__}: field {name!r} has non-floating dtype {v.dtype}")
            if expected is None:
                expected = v.dtype
            elif v.dtype != expected:
                raise TypeError(
                    f"{type(self).__name__}: field {name!r} has dtype {v.dtype}, want {expected}"
                )
        return out


class EtaLevels(Component):
    """Diagnoses the eta coordinate."""

    input_properties = _props({"ap": FULL, "aph": IFACE})
    diagnostic_properties = _props({"eta": VERT})

    def forward(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        state = self._check_state(state)
        return {"eta": eta_levels(state["ap"], state["aph"])}


class Saturation(Component):
    """Diagnoses ``qsat``."""

    input_properties = _props({"ap": FULL, "t": FULL})
    diagnostic_properties = _props({"qsat": FULL})

    def __init__(self, grid, constants, *, kflag: int = 1, lphylin: bool = True, **kw):
        super().__init__(grid, constants, **kw)
        self.kflag = kflag
        self.lphylin = lphylin

    def forward(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        state = self._check_state(state)
        qsat = saturation(state["ap"], state["t"], kflag=self.kflag, lphylin=self.lphylin, c=self.constants)
        return {"qsat": qsat}


class StateIncrement(Component):
    """Produces the 16-field perturbation ``*_i = factor * field``."""

    input_properties = _props(_INCR)
    diagnostic_properties = _props({n + "_i": d for n, d in _INCR.items()})

    def __init__(self, grid, constants, factor: float, *, ignore_supsat: bool = False, **kw):
        super().__init__(grid, constants, **kw)
        self.factor = factor
        self.ignore_supsat = ignore_supsat

    def forward(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        state = self._check_state(state)
        return _increment.state_increment(state, self.factor, ignore_supsat=self.ignore_supsat)


class PerturbedState(Component):
    """Produces ``field + factor * field_i`` for the 16 fields."""

    input_properties = _props({**_INCR, **{n + "_i": d for n, d in _INCR.items()}})
    diagnostic_properties = _props(_INCR)

    def __init__(self, grid, constants, factor: float, **kw):
        super().__init__(grid, constants, **kw)
        self.factor = factor

    def forward(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        state = self._check_state(state)
        return _increment.perturbed_state(state, self.factor)


class Cloudsc2NL(Component):
    """Nonlinear CLOUDSC2: 17 inputs, 4 tendencies, 6 diagnostics.  CUDA
    tensors run the hand-written kernel, CPU tensors the plain version
    (:func:`cloudsc2_tpu_torch.dispatch.cloudsc2_nl`).

    With ``fuse_saturation`` the step also does the ``Saturation``
    component's work (``kflag``, and the constants' ``LPHYLIN``): ``qsat``
    is no input, and it is a seventh diagnostic (the JAX package's
    ``cloudsc2_nl_pallas(..., fuse_saturation=True)``)."""

    input_properties = _props(_NL_INPUTS)
    tendency_properties = {n: {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()}
    diagnostic_properties = _props(_NL_DIAGS)

    def __init__(self, grid, constants, *, fuse_saturation: bool = False, kflag: int = 1, **kw):
        super().__init__(grid, constants, **kw)
        self.fuse_saturation = fuse_saturation
        self.kflag = kflag
        if fuse_saturation:
            self.input_properties = _props({n: d for n, d in _NL_INPUTS.items() if n != "qsat"})
            self.diagnostic_properties = _props({**_NL_DIAGS, "qsat": FULL})

    def forward(
        self, state: Dict[str, Tensor], timestep: float
    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        state = self._check_state(state)
        return dispatch.cloudsc2_nl(state, timestep, self.constants, self.fuse_saturation, self.kflag)


class Cloudsc2TL(Component):
    """Tangent-linear CLOUDSC2: every field paired with its ``*_i``
    perturbation.  CUDA tensors run the hand-written kernel, CPU tensors
    the plain version (:func:`cloudsc2_tpu_torch.dispatch.cloudsc2_tl`)."""

    input_properties = _props({**_NL_INPUTS, **{n + "_i": d for n, d in _INCR.items()}})
    tendency_properties = {
        **{n: {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()},
        **{n + "_i": {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()},
    }
    diagnostic_properties = _props({**_NL_DIAGS, **{n + "_i": d for n, d in _NL_DIAGS.items()}})

    def forward(
        self, state: Dict[str, Tensor], timestep: float
    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        state = self._check_state(state)
        return dispatch.cloudsc2_tl(state, timestep, self.constants)


class Cloudsc2AD(Component):
    """Adjoint CLOUDSC2: the NL inputs plus the output cotangent seeds in,
    the forward outputs and the input cotangents out.  CUDA tensors run the
    hand-written kernels, CPU tensors the plain version
    (:func:`cloudsc2_tpu_torch.dispatch.cloudsc2_ad`).

    With ``LPHYLIN=False`` the JAX component falls back to its exact scan
    adjoint (``cloudsc2_tpu/components.py:410-423``), because its Pallas
    kernels refuse it.  The AD does not read ``LPHYLIN``, and this
    component's kernels take it (their forward sweep runs under
    linearized physics, the TL's own forward): the same numbers as under
    ``LPHYLIN=True``, as the scan adjoint gives."""

    input_properties = _props({
        **_NL_INPUTS,
        **{"tnd_" + n: FULL for n in TEND_UNITS},
        **{"tnd_" + n + "_i": FULL for n in TEND_UNITS},
        **{n + "_i": d for n, d in _NL_DIAGS.items()},
    })
    tendency_properties = {
        **{n: {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()},
        **{"cml_" + n + "_i": {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()},
    }
    diagnostic_properties = _props({
        **_NL_DIAGS,
        **{n + "_i": (IFACE if n == "aph" else FULL) for n in AD_COTANGENT_FIELDS},
    })

    def forward(
        self, state: Dict[str, Tensor], timestep: float
    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        state = self._check_state(state)
        return dispatch.cloudsc2_ad(state, timestep, self.constants)
