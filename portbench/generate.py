"""The benchmark's inputs: seeded CLOUDSC2 states made on the device.

:func:`synthesize` restates ``cloudsc2_tpu_torch/iox.py`` ``synthesize_input``
(commit 8632ffd) draw for draw in torch, with a ``torch.Generator`` on the
state's device in place of numpy's ``default_rng``: the same profile (warm
surface, cold tropopause near eta 0.25, re-warming stratosphere), humidity
at 30-95 % RH, patchy liquid and ice cloud, convective fluxes and small
accumulated tendencies, from the same distributions.  The values differ
from the numpy version's (another random stream); the physics sees the same
kind of state.  A state is made in float64 and handed out as such; a cell
casts it to its configuration's precision.

The upstream ``input.h5`` is not public in a form the repository holds, so
the state is synthesized, as the port's drivers do without it.  This module
imports nothing of the port.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.params import YoethfParams, YomcstParams

Tensor = torch.Tensor

#: the time step of the synthetic state, as ``synthesize_input`` sets it
DT = 1800.0

#: the 15 input fields of a state, in ``iox.INPUT_FIELDS``'s order
FIELDS = (
    "ap", "aph", "lu", "lude", "mfd", "mfu", "q", "qi", "ql", "supsat", "t",
    "tnd_cml_q", "tnd_cml_qi", "tnd_cml_ql", "tnd_cml_t",
)


def state_seed(seed: int, index: int) -> int:
    """The generator seed of state ``index`` of a run's pool: a run's seed
    may be any whole number; each state of its pool gets its own stream."""
    return (seed * 1_000_003 + index) % (2**63)


def synthesize(ncols: int, nlev: int, seed: int, index: int, device: torch.device) -> Dict[str, Tensor]:
    """State ``index`` of the pool of run ``seed``: the 15 input fields,
    float64 on ``device``, full levels ``(nlev, ncols)`` and ``aph``
    ``(nlev + 1, ncols)``.  The same arguments give the same state."""
    g = torch.Generator(device=device)
    g.manual_seed(state_seed(seed, index))
    f64 = dict(dtype=torch.float64, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=g, **f64)

    def uniform(*shape):
        return torch.rand(shape, generator=g, **f64)

    ps = 101325.0 * (1.0 + 0.01 * normal(ncols))
    x = (torch.arange(nlev + 1, **f64) / nlev)[:, None]
    aph = ps[None, :] * x**1.9
    ap = 0.5 * (aph[:-1] + aph[1:])
    eta_col = ap / aph[-1]

    t_surf = 288.0 + 10.0 * normal(ncols)
    t_trop = 216.5 + 4.0 * normal(ncols)
    eta_t = 0.25
    tropo = torch.clamp((eta_col - eta_t) / (1.0 - eta_t), min=0.0)
    strato = torch.clamp((eta_t - eta_col) / eta_t, min=0.0)
    t = t_trop[None, :] + (t_surf - t_trop)[None, :] * tropo**1.1 + 45.0 * strato**1.5
    t = t + 0.5 * normal(nlev, ncols)

    # saturation humidity with the IFS constants, for a plausible q
    y, m = YoethfParams(), YomcstParams()
    alfa = torch.clamp(((torch.clamp(t, y.RTICE, y.RTWAT) - y.RTICE) * y.RTWAT_RTICE_R) ** 2, max=1.0)
    foeew = y.R2ES * (
        alfa * torch.exp(y.R3LES * (t - m.RTT) / (t - y.R4LES))
        + (1.0 - alfa) * torch.exp(y.R3IES * (t - m.RTT) / (t - y.R4IES))
    )
    qs = torch.clamp(foeew / ap, max=0.5)
    qsat = qs / (1.0 - m.RETV * qs)

    rh = torch.clamp(0.35 + 0.5 * uniform(nlev, ncols) + 0.2 * tropo, 0.0, 0.98)
    q = rh * qsat

    cloud_mask = (uniform(nlev, ncols) < 0.35) & (eta_col > 0.3) & (eta_col < 0.97)
    qc_tot = cloud_mask * uniform(nlev, ncols) * 3e-4
    fwat = torch.clamp((t - (m.RTT - 23.0)) / 23.0, 0.0, 1.0) ** 2
    ql = qc_tot * fwat
    qi = qc_tot * (1.0 - fwat)

    conv_mask = (uniform(nlev, ncols) < 0.4) & (eta_col > 0.4) & (eta_col < 0.95)
    lu = conv_mask * uniform(nlev, ncols) * 1e-4 + 1e-9
    lude = conv_mask * uniform(nlev, ncols) * 2e-5
    mfu = conv_mask * uniform(nlev, ncols) * 0.1
    mfd = conv_mask * uniform(nlev, ncols) * (-0.05)

    cold = (t < m.RTT - 40.0) & (uniform(nlev, ncols) < 0.2)
    supsat = torch.where(cold, uniform(nlev, ncols) * 1e-5, torch.zeros_like(t))

    tnd_cml_t = 2e-5 * normal(nlev, ncols)
    tnd_cml_q = 1e-8 * normal(nlev, ncols)
    zero = torch.zeros_like(t)
    tnd_cml_ql = torch.where(cloud_mask, 2e-9 * normal(nlev, ncols), zero)
    tnd_cml_qi = torch.where(cloud_mask, 2e-9 * normal(nlev, ncols), zero)

    state = {
        "ap": ap, "aph": aph, "lu": lu, "lude": lude, "mfd": mfd, "mfu": mfu, "q": q, "qi": qi, "ql": ql,
        "supsat": supsat, "t": t, "tnd_cml_q": tnd_cml_q, "tnd_cml_qi": tnd_cml_qi, "tnd_cml_ql": tnd_cml_ql,
        "tnd_cml_t": tnd_cml_t,
    }
    return {k: state[k].contiguous() for k in FIELDS}
