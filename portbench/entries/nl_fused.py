"""Entry ``nl_fused``: one NL forecast step with saturation fused into the
step, the port's main path: ``parallel/step.py`` ``forward_step(state, dt,
c, fuse_saturation=True)``, one NL kernel launch on CUDA tensors.  The
port's set-up derives ``eta`` from each state; the wrapper derives
``scalm`` on every call."""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping

import torch

from cloudsc2_tpu_torch.kernels import nonlinear
from cloudsc2_tpu_torch.parallel.step import forward_step
from cloudsc2_tpu_torch.params import Constants, make_constants
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from portbench.compare import DTYPES
from portbench.reference import steps

Tensor = torch.Tensor

KIND = "nl"
#: the count files of the step's launches (``portbench/counts/``)
COUNTS = ("nl_fused",)
#: the numbers the check compares, each over these outputs
CHECKS = {
    "nl_err": ("tnd_t", "tnd_q", "tnd_ql", "tnd_qi", "clc", "covptot", "fplsl", "fplsn", "fhpsl", "fhpsn",
               "qsat"),
}


def constants(config: Mapping) -> Constants:
    """The port's default constant bundle with the configuration's switches."""
    return make_constants().replace(**config["switches"])


def libraries(config: Mapping) -> List[Callable[[], object]]:
    """Loaders of the kernel libraries the step launches."""
    c = constants(config)
    return [lambda: nonlinear.load_cuda(c.CUADJ_COMPACT)]


def prepare(inputs: Mapping[str, Tensor], config: Mapping) -> Dict[str, Tensor]:
    """The program's set-up of one state: the inputs in the configuration's
    precision, ``eta`` derived by the port."""
    x = {k: v.to(DTYPES[config["precision"]]) for k, v in inputs.items()}
    x["eta"] = eta_levels(x["ap"], x["aph"])
    return x


def program(config: Mapping) -> Callable[[Dict[str, Tensor]], Dict[str, Tensor]]:
    """The timed step on a prepared state; its outputs by name."""
    c, dt = constants(config), config["dt"]

    def step(x: Dict[str, Tensor]) -> Dict[str, Tensor]:
        tends, diags = forward_step(x, dt, c, fuse_saturation=True)
        out = {"tnd_" + k: v for k, v in tends.items()}
        out.update(diags)
        return out

    return step


def reference(inputs: Mapping[str, Tensor], config: Mapping, precision: str) -> Dict[str, Tensor]:
    """The plain reference's step on the generated inputs, in ``precision``."""
    dtype = DTYPES[precision]
    return steps.nl_step({k: v.to(dtype) for k, v in inputs.items()}, config["dt"],
                         steps.constants(config["switches"]))
