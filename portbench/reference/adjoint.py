# Frozen copy of cloudsc2_tpu_torch/physics/adjoint.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLOUDSC2 adjoint scheme, plain PyTorch; the port of
:mod:`cloudsc2_tpu.physics.adjoint` (``AD_TEND_SEEDS:62``,
``AD_DIAG_SEEDS:65``, ``AD_COTANGENT_FIELDS:70``, ``cloudsc2_ad:87``).

The plain TL (:func:`cloudsc2_tpu_torch.physics.tangent_linear.cloudsc2_tl`)
is exactly linear in its 16 perturbation inputs: every branch condition
depends on forward values only.  So ``torch.func.vjp`` of its perturbation
map is the adjoint, the exact transpose of the regularized TL including the
four ``LREGCL`` damping factors, as ``jax.vjp`` of the JAX TL is in the JAX
package.  This is the plain version of the AD kernel
(:mod:`cloudsc2_tpu_torch.kernels.adjoint`).

The supersaturation cotangent keeps coefficient 1 (the first guess adds
``supsat`` unscaled), where the reference adjoint scales it by ``dt``; see
PARITY.md and the JAX module's docstring.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .params import Constants
from .increment import INCREMENT_FIELDS
from .nonlinear import check_constants
from .tangent_linear import cloudsc2_tl

Tensor = torch.Tensor

#: cotangent seeds consumed from the state: TL tendency outputs ...
AD_TEND_SEEDS = ("tnd_t_i", "tnd_q_i", "tnd_ql_i", "tnd_qi_i")
#: ... and TL diagnostic outputs (reference AD inputs ``in_*_i``)
AD_DIAG_SEEDS = ("clc_i", "covptot_i", "fhpsl_i", "fhpsn_i", "fplsl_i", "fplsn_i")
#: input-side cotangents returned among the diagnostics
AD_COTANGENT_FIELDS = (
    "ap", "aph", "t", "q", "qsat", "ql", "qi", "lu", "lude", "mfd", "mfu", "supsat",
)
#: the forward outputs the AD returns beside the cotangents
AD_TENDENCIES = ("t", "q", "ql", "qi")
AD_DIAGNOSTICS = ("clc", "covptot", "fplsl", "fplsn", "fhpsl", "fhpsn")


def cloudsc2_ad(
    state: Dict[str, Tensor], dt: float, c: Constants, cotangent_only: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Run the adjoint CLOUDSC2 scheme.

    ``state`` holds the 16 forward input fields, ``eta`` and ``qsat``, and
    the output cotangent seeds named after the TL outputs:
    ``tnd_{t,q,ql,qi}_i``, ``clc_i``, ``covptot_i`` ``(nlev, ncols)`` and
    ``fhpsl_i, fhpsn_i, fplsl_i, fplsn_i`` ``(nlev + 1, ncols)``.

    Returns ``(tendencies, diagnostics)``: the forward ``t, q, ql, qi`` and
    the cotangents ``cml_{t,q,ql,qi}_i`` of the accumulated tendencies; the
    forward ``clc, covptot, fplsl, fplsn, fhpsl, fhpsn`` and the 12 input
    cotangents ``{ap,aph,t,q,qsat,ql,qi,lu,lude,mfd,mfu,supsat}_i``.  With
    ``cotangent_only`` (``cotangent_only`` of :func:`cloudsc2_tpu.pallas.
    adjoint.cloudsc2_ad_pallas`, for a consumer that has the forward outputs
    from its NL run) only the cotangents: ``cml_*_i`` and the 12 ``*_i``.
    """
    check_constants(c)
    fwd = {k: v for k, v in state.items() if not k.endswith("_i")}
    names = tuple(n + "_i" for n in INCREMENT_FIELDS)

    def tl_pert(*incr: Tensor):
        tends, diags = cloudsc2_tl({**fwd, **dict(zip(names, incr))}, dt, c)
        pert = ({k: v for k, v in tends.items() if k.endswith("_i")},
                {k: v for k, v in diags.items() if k.endswith("_i")})
        forward = ({n: tends[n] for n in AD_TENDENCIES}, {n: diags[n] for n in AD_DIAGNOSTICS})
        return pert, forward

    zeros = tuple(torch.zeros_like(fwd[n]) for n in INCREMENT_FIELDS)
    pert, vjp_fn, (tends_f, diags_f) = torch.func.vjp(tl_pert, *zeros, has_aux=True)
    seeds = ({k: state["tnd_" + k] for k in pert[0]}, {k: state[k] for k in pert[1]})
    cot = dict(zip(names, vjp_fn(seeds)))

    tends = {} if cotangent_only else dict(tends_f)
    for n in AD_TENDENCIES:
        tends["cml_" + n + "_i"] = cot["tnd_cml_" + n + "_i"]
    diags = {} if cotangent_only else dict(diags_f)
    for n in AD_COTANGENT_FIELDS:
        diags[n + "_i"] = cot[n + "_i"]
    return tends, diags
