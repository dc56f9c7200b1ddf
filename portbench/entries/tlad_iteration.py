"""Entry ``tlad_iteration``: one 4D-Var inner iteration through the lean
forms a minimiser runs: ``dispatch.cloudsc2_tl(s, dt, c,
tangent_only=True)``, then ``dispatch.cloudsc2_ad(s_ad, dt, c,
cotangent_only=True)`` seeded with the TL's tangents of the same iteration
(the symmetry protocol's pairing, ``parallel/step.py`` ``full_step``).  On
CUDA tensors: the TL kernel, then the NL kernel's forward sweep and the AD
reverse kernel.  The port's set-up derives the trajectory's ``eta`` and
``qsat`` and the seeded increment."""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping

import torch

from cloudsc2_tpu_torch import dispatch
from cloudsc2_tpu_torch.kernels import adjoint, nonlinear, tangent_linear
from cloudsc2_tpu_torch.params import Constants, make_constants
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.physics.saturation import saturation
from portbench.compare import DTYPES
from portbench.reference import steps

Tensor = torch.Tensor

KIND = "tlad"
COUNTS = ("tl_tangent_only", "ad_cotangent_only")
CHECKS = {
    "tl_err": tuple("tl." + n for n in (
        "t_i", "q_i", "ql_i", "qi_i", "clc_i", "covptot_i", "fplsl_i", "fplsn_i", "fhpsl_i", "fhpsn_i")),
    "ad_err": tuple("ad." + n for n in (
        "cml_t_i", "cml_q_i", "cml_ql_i", "cml_qi_i", "ap_i", "aph_i", "t_i", "q_i", "qsat_i", "ql_i", "qi_i",
        "lu_i", "lude_i", "mfd_i", "mfu_i", "supsat_i")),
}


def constants(config: Mapping) -> Constants:
    """The port's default constant bundle with the configuration's switches."""
    return make_constants().replace(**config["switches"])


def libraries(config: Mapping) -> List[Callable[[], object]]:
    """Loaders of the TL, NL and AD reverse libraries of the iteration's
    form."""
    c = constants(config)
    return [lambda: tangent_linear.load_cuda(c.CUADJ_COMPACT), lambda: nonlinear.load_cuda(c.CUADJ_COMPACT),
            lambda: adjoint.load_cuda(c.CUADJ_COMPACT)]


def prepare(inputs: Mapping[str, Tensor], config: Mapping) -> Dict[str, Tensor]:
    """The program's set-up of one state: the trajectory in the
    configuration's precision with ``eta`` and ``qsat``, and the seeded
    increment (``*_i``)."""
    c = constants(config)
    x = {k: v.to(DTYPES[config["precision"]]) for k, v in inputs.items()}
    x["eta"] = eta_levels(x["ap"], x["aph"])
    x["qsat"] = saturation(x["ap"], x["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    x.update(state_increment(x, config["increment_factor"], ignore_supsat=True))
    return x


def program(config: Mapping) -> Callable[[Dict[str, Tensor]], Dict[str, Tensor]]:
    """The timed iteration on a prepared state; the tangents (``tl.*``)
    and cotangents (``ad.*``) by name."""
    c, dt = constants(config), config["dt"]

    def step(x: Dict[str, Tensor]) -> Dict[str, Tensor]:
        tends, diags = dispatch.cloudsc2_tl(x, dt, c, tangent_only=True)
        s = dict(x)
        s.update({"tnd_" + k: v for k, v in tends.items()})
        s.update(diags)
        cot_tends, cot_diags = dispatch.cloudsc2_ad(s, dt, c, cotangent_only=True)
        out = {"tl." + k: v for k, v in tends.items()}
        out.update({"tl." + k: v for k, v in diags.items()})
        out.update({"ad." + k: v for k, v in cot_tends.items()})
        out.update({"ad." + k: v for k, v in cot_diags.items()})
        return out

    return step


def reference(inputs: Mapping[str, Tensor], config: Mapping, precision: str) -> Dict[str, Tensor]:
    """The plain reference's iteration on the generated inputs, in
    ``precision``."""
    dtype = DTYPES[precision]
    return steps.tlad_iteration({k: v.to(dtype) for k, v in inputs.items()}, config["dt"],
                                steps.constants(config["switches"]), config["increment_factor"])
