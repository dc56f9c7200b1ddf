"""The benchmark's reference steps, composed from the frozen plain versions
of this package.  Each works out everything the program's set-up derives
(``eta``, ``qsat``, the increment; ``scalm`` inside the schemes) again from
the generated inputs, and returns its outputs under the names the entries
give the program's.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from .adjoint import AD_COTANGENT_FIELDS, AD_TENDENCIES
from .diagnostics import eta_levels
from .increment import INCREMENT_FIELDS, state_increment
from .nonlinear import cloudsc2_nl
from .params import Constants, make_constants
from .saturation import saturation
from .tangent_linear import cloudsc2_tl

Tensor = torch.Tensor


def constants(switches: Mapping[str, object]) -> Constants:
    """The default constant bundle with a configuration's switches."""
    return make_constants().replace(**switches)


def nl_step(inputs: Mapping[str, Tensor], dt: float, c: Constants) -> Dict[str, Tensor]:
    """One NL step with saturation diagnosed in the step (``kflag`` 1, as
    ``forward_step`` runs it), the plain version of the fused kernel:
    tendencies ``tnd_*``, the diagnostics and ``qsat``, each in the
    inputs' dtype."""
    s = dict(inputs)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    tends, diags = cloudsc2_nl(s, dt, c, fuse_saturation=True, kflag=1)
    return {**{"tnd_" + k: v for k, v in tends.items()}, **diags}


def tlad_iteration(inputs: Mapping[str, Tensor], dt: float, c: Constants, factor: float) -> Dict[str, Tensor]:
    """One 4D-Var inner iteration: the TL's tangents at the increment
    ``factor`` times the state (``supsat``'s zero), ``tl.*_i``, then the
    AD's cotangents seeded with those tangents, ``ad.cml_*_i`` and
    ``ad.*_i``.

    The AD is ``torch.func.vjp`` of the plain TL, as ``adjoint.cloudsc2_ad``
    takes it.  The TL is exactly linear in the increment, so its vjp at the
    increment is its vjp at zero, and one vjp gives both the tangents
    (its primal outputs) and the cotangents: the same numbers as
    ``cloudsc2_tl`` then ``cloudsc2_ad``, in the time of the second.
    """
    s = dict(inputs)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    incr = state_increment(s, factor, ignore_supsat=True)
    names = tuple(n + "_i" for n in INCREMENT_FIELDS)

    def tangents(*x: Tensor):
        return cloudsc2_tl({**s, **dict(zip(names, x))}, dt, c, tangent_only=True)

    (tends, diags), vjp_fn = torch.func.vjp(tangents, *(incr[n] for n in names))
    cot = dict(zip(names, vjp_fn((tends, diags))))
    out = {"tl." + k: v for k, v in {**tends, **diags}.items()}
    out.update({"ad.cml_" + n + "_i": cot["tnd_cml_" + n + "_i"] for n in AD_TENDENCIES})
    out.update({"ad." + n + "_i": cot[n + "_i"] for n in AD_COTANGENT_FIELDS})
    return {k: v.detach() for k, v in out.items()}
