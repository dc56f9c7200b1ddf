# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Symmetry test: validates the adjoint against the tangent-linear; the port
of :mod:`cloudsc2_tpu.validation.symmetry` (``TEND_NAMES:41``,
``DIAG_NAMES:42``, ``FIELD_PAIRS:43``, ``SymmetryTest:60``, with its column
``mesh``).

With ``y = M x`` (TL applied to the increment ``x = f * state``) and
``x* = M* y`` (adjoint applied to the TL outputs), the test checks the
defining identity of the adjoint per column:

    norm1[col] = <Mx, Mx> = sum over the 10 TL outputs of sum_k y^2
    norm2[col] = <x, M*(Mx)> = sum over the 16 input pairs of sum_k x . x*

and passes iff ``max |norm1 - norm2| / (eps * norm2) < 1e4`` machine
epsilons (reference ``adjoint/validation.py:155-165``).  The
supersaturation increment is zeroed (``ignore_supsat=True``).  The schemes
run through :mod:`cloudsc2_tpu_torch.dispatch` (the CUDA kernels for CUDA
tensors), column-sharded with a ``mesh``
(:func:`cloudsc2_tpu_torch.parallel.step.make_sharded_physics`, the outputs
gathered in column order); the per-column norms are reduced on the device,
and only the two ``(ncols,)`` norm vectors are copied to the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from cloudsc2_tpu_torch import dispatch
from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.utils.timing import device_sync, timing

Tensor = torch.Tensor

TEND_NAMES = ("t", "q", "ql", "qi")
DIAG_NAMES = ("clc", "fhpsl", "fhpsn", "fplsl", "fplsn", "covptot")
FIELD_PAIRS = (
    "ap", "aph", "t", "q", "qsat", "ql", "qi", "lu", "lude", "mfd", "mfu", "supsat",
)


@dataclass
class SymmetryTest:
    """Reference symmetry-test orchestration (``validation.py:44-231``)."""

    constants: Constants
    factor: float = 0.01
    kflag: int = 1
    lphylin: bool = True
    #: optional column mesh (:class:`cloudsc2_tpu_torch.parallel.mesh.ColumnMesh`,
    #: single-process): the TL and AD run column-sharded (driver ``--sharded``)
    mesh: object = None
    _fns: tuple = field(default=None, repr=False)  # type: ignore[assignment]

    def _tl_ad(self):
        if self._fns is None:
            fns = (dispatch.cloudsc2_tl, dispatch.cloudsc2_ad)
            if self.mesh is not None:
                from cloudsc2_tpu_torch.parallel.step import make_sharded_physics

                fns = tuple(make_sharded_physics(f, self.mesh) for f in fns)
            self._fns = fns
        return self._fns

    def run(self, state: Dict[str, Tensor], dt: float) -> Tuple[np.ndarray, np.ndarray]:
        """The per-column norms ``(norm1, norm2)`` for ``state`` (the 16
        fields and ``eta``), as numpy arrays of the state's dtype."""
        c = self.constants
        tl_fn, ad_fn = self._tl_ad()
        state = dict(state)
        with timing("saturation"):
            state["qsat"] = device_sync(saturation(
                state["ap"], state["t"], kflag=self.kflag, lphylin=self.lphylin, c=c
            ))

        # x = f * state, with the supsat increment zeroed
        with timing("state_increment"):
            incr = device_sync(state_increment(state, self.factor, ignore_supsat=True))
        state.update(incr)

        # y = M x
        with timing("cloudsc2_tl"):
            tends_tl, diags_tl = device_sync(tl_fn(state, dt, c))
        norm1 = self.get_norm1(tends_tl, diags_tl)

        # the TL outputs become the adjoint's cotangent seeds (reference
        # add_tendencies_to_state, validation.py:222-231)
        for name in TEND_NAMES:
            state["tnd_" + name] = tends_tl[name]
            state["tnd_" + name + "_i"] = tends_tl[name + "_i"]
        for name in DIAG_NAMES:
            state[name + "_i"] = diags_tl[name + "_i"]

        # x* = M* y
        with timing("cloudsc2_ad"):
            tends_ad, diags_ad = device_sync(ad_fn(state, dt, c))
        norm2 = self.get_norm2(incr, tends_ad, diags_ad)
        return norm1.cpu().numpy(), norm2.cpu().numpy()

    @staticmethod
    def get_norm1(tends_tl: Dict[str, Tensor], diags_tl: Dict[str, Tensor]) -> Tensor:
        """Per-column <Mx, Mx> (reference ``validation.py:167-181``)."""
        out = 0.0
        for name in TEND_NAMES:
            out = out + torch.sum(tends_tl[name + "_i"] ** 2, dim=0)
        for name in DIAG_NAMES:
            out = out + torch.sum(diags_tl[name + "_i"] ** 2, dim=0)
        return out

    @staticmethod
    def get_norm2(
        incr: Dict[str, Tensor], tends_ad: Dict[str, Tensor], diags_ad: Dict[str, Tensor]
    ) -> Tensor:
        """Per-column <x, M*(Mx)> (reference ``validation.py:183-215``)."""
        out = 0.0
        for name in TEND_NAMES:
            out = out + torch.sum(incr["tnd_cml_" + name + "_i"] * tends_ad["cml_" + name + "_i"], dim=0)
        for name in FIELD_PAIRS:
            out = out + torch.sum(incr[name + "_i"] * diags_ad[name + "_i"], dim=0)
        return out

    def validate(self, norm1: np.ndarray, norm2: np.ndarray, verbose: bool = True) -> float:
        """Maximum error in machine epsilons (reference ``validation.py:155-165``)."""
        eps = np.finfo(norm2.dtype).eps
        norm3 = np.where(
            norm2 == 0.0,
            np.abs(norm1 - norm2) / eps,
            np.abs(norm1 - norm2) / (eps * np.abs(norm2)),
        )
        err = float(norm3.max())
        if verbose:
            if err < 1e4:
                print("The symmetry test passed. HOORAY!")
            else:
                print("The symmetry test failed.")
            print(f"The maximum error is {err:.10e} times the machine epsilon.")
        return err

    def __call__(self, state: Dict[str, Tensor], dt: float, verbose: bool = True) -> float:
        norm1, norm2 = self.run(state, dt)
        return self.validate(norm1, norm2, verbose=verbose)
