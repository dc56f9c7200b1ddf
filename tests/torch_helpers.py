# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Shared inputs and checks of the PyTorch-port tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port.  The port computes with its own constants, built from the JAX
package's by ``constants_from_mapping`` so that both packages compute with
the same numbers; a JAX function is given :func:`jax_constants` of them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cloudsc2_tpu.params import Constants as JaxConstants
from cloudsc2_tpu.params import make_constants as jax_make_constants
from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.params import constants_from_mapping
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl
from cloudsc2_tpu_torch.state import state_from_numpy
from cloudsc2_tpu_torch.utils.compare import AD_F32_KERNEL_WIDE, ad_errors, field_errors


def port_constants(jc):
    """The port's constants built from the JAX package's ``jc``: the same
    numbers, field by field."""
    return constants_from_mapping(dataclasses.asdict(jc))


def jax_constants(c):
    """The JAX package's constants with the numbers of the port's ``c``."""
    return JaxConstants(**dataclasses.asdict(c))


#: the switch configurations the JAX tests cover (tests/test_nonlinear.py),
#: as the port's constants
CONFIGS = {
    "default": lambda: port_constants(jax_make_constants(lphylin=True, ldrain1d=False)),
    "levapls2": lambda: port_constants(
        jax_make_constants(lphylin=True, ldrain1d=False).replace(LEVAPLS2=True)),
    "ldrain1d": lambda: port_constants(jax_make_constants(lphylin=True, ldrain1d=True)),
}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}

#: f32 against the Pallas AD (two-kernel and fused) at 1024 x 53: the
#: fields held wider than the Pallas gate of 2e-6 of the scale
#: (tests/test_pallas.py:263; there both sides are XLA's f32 vjp of one
#: TL), in units of the field's largest magnitude.  The port's plain AD is
#: an f32 autograd tape over the plain TL, its kernels the TL level
#: transposed by hand around the NL trajectory, the Pallas AD an f32 NL
#: trajectory and one vjp per level, and where a cotangent sums terms that
#: cancel the f32 roundings part further.  Measured for the plain AD, worst of the three configurations:
#: lu_i 8.5e-5 (it goes as 1/lu_next**2 through the detrainment's
#: exp(-lude/lu_next)), qsat_i 2.1e-5, q_i, supsat_i, ql_i, qi_i and
#: cml_{q,ql,qi}_i 8.3e-6, clc 5.2e-6, covptot 3.7e-6, qi 2.7e-6, every
#: other field below 1.3e-6; the kernels' host bodies (two-kernel and
#: fused) reach at most 0.62 of these limits (aph_i).  Each f32 side is
#: itself 1e-5 to 1.5e-4 of the scale from the f64 AD on the same inputs in
#: these fields, so the spread is f32 rounding, not a different operator.
#: lu_i and lude_i are also held point by point, as against the kernel.
PALLAS_F32_WIDE = {
    "lu_i": 2e-4, "lude_i": 2e-6, "qsat_i": 5e-5,
    **{n: 2e-5 for n in ("q_i", "supsat_i", "ql_i", "qi_i", "cml_q_i", "cml_ql_i", "cml_qi_i")},
    **{n: 1e-5 for n in ("clc", "covptot", "qi")},
}


def port_state(state_np, dtype, c):
    """The numpy state as CPU tensors of ``dtype`` plus the port's eta and
    qsat (EtaLevels + Saturation)."""
    s = state_from_numpy(state_np, torch.device("cpu"), TORCH[dtype])
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    return s


def port_tl_state(state_np, dtype, c, factor=0.01):
    """:func:`port_state` plus the TL's perturbations ``factor * field``."""
    s = port_state(state_np, dtype, c)
    s.update(state_increment(s, factor))
    return s


def as_jax(state):
    """The port's CPU tensors as JAX arrays, the same numbers."""
    import jax.numpy as jnp

    return {k: jnp.asarray(v.numpy()) for k, v in state.items()}


def jax_state(state_np, dtype, c):
    """The same numpy state for the JAX package, with its eta and qsat
    (``c``: the port's constants)."""
    import jax.numpy as jnp

    from cloudsc2_tpu.physics.diagnostics import eta_levels as j_eta
    from cloudsc2_tpu.physics.saturation import saturation as j_sat

    s = {k: jnp.asarray(v, dtype) for k, v in state_np.items()}
    s["eta"] = j_eta(s["ap"], s["aph"])
    s["qsat"] = j_sat(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=jax_constants(c))
    return s


def port_ad_state(state_np, dtype, c, dt):
    """:func:`port_state` as the symmetry protocol hands it to the AD: the
    increments (supsat zeroed), and the plain TL's outputs as the forward
    tendencies and the cotangent seeds."""
    s = port_state(state_np, dtype, c)
    s.update(state_increment(s, 0.01, ignore_supsat=True))
    tends, diags = cloudsc2_tl(s, dt, c)
    for n in ("t", "q", "ql", "qi"):
        s["tnd_" + n] = tends[n]
        s["tnd_" + n + "_i"] = tends[n + "_i"]
    for n in ("clc", "covptot", "fhpsl", "fhpsn", "fplsl", "fplsn"):
        s[n + "_i"] = diags[n + "_i"]
    return s


ROBUST_CASES = ("saturated", "dry", "threshold_t", "no_convection")


def robust_state(case, dtype, c, ncols=128, nlev=53, increment=False):
    """The pathological states of tests/test_robustness.py (seed 7),
    built on the port's tensors; with ``increment`` the TL's perturbations
    (0.01 times each field) are added."""
    _, st, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=7, dtype=dtype)
    s = port_state(st, dtype, c)
    z = torch.zeros_like(s["q"])
    if case == "saturated":
        s["q"] = 2.0 * s["qsat"]
        s["supsat"] = 0.1 * s["qsat"]
    elif case == "dry":
        for n in ("q", "ql", "qi", "supsat", "tnd_cml_q", "tnd_cml_ql", "tnd_cml_qi"):
            s[n] = z
    elif case == "threshold_t":
        even = (torch.arange(nlev)[:, None] % 2 == 0).expand_as(s["t"])
        s["t"] = torch.where(even, torch.full_like(s["t"], c.RTT), torch.full_like(s["t"], c.RTICE))
        s["tnd_cml_t"] = z
    elif case == "no_convection":
        for n in ("lu", "lude", "mfu", "mfd"):
            s[n] = z
    else:
        raise ValueError(case)
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    if increment:
        s.update(state_increment(s, 0.01))
    return s, dt


def flat(out):
    """``(tendencies, diagnostics)`` as one dict of numpy arrays."""
    tends, diags = out
    return {k: np.asarray(v) for k, v in {**tends, **diags}.items()}


def assert_fields(got, want, tol, label=""):
    """Every field within its ``(rtol, atol)`` of ``tol``."""
    errs = field_errors(got, want, tol)
    bad = {n: e for n, e in errs.items() if not e[2] <= 1.0}
    assert not bad, f"{label}: (max abs, max rel, share of limit) {bad}"


def assert_scaled(got, want, rtol, atol_scale, label=""):
    """Every field of ``want`` within ``rtol`` and an atol of ``atol_scale``
    times the field's largest magnitude (the oracle gates of
    tests/test_tl.py)."""
    tol = {n: (rtol, atol_scale * max(float(np.abs(np.asarray(w, np.float64)).max()), 1e-300))
           for n, w in want.items()}
    assert_fields(got, want, tol, label)


def assert_ad(got, want, dtype, label="", wide=AD_F32_KERNEL_WIDE):
    """Every AD output field within its limits of
    ``cloudsc2_tpu_torch.utils.compare.ad_limit`` (``wide``: the f32 fields
    held wider, and point by point)."""
    assert got.keys() == want.keys(), label
    errs = ad_errors(got, want, dtype, wide)
    bad = {n: e for n, e in errs.items() if not e[2] <= 1.0}
    assert not bad, f"{label}: (scaled, median relative, share of limit) {bad}"


def assert_physical(out, *, strict_fluxes=True):
    """Finite everywhere, clc in [0, 1], fluxes >= 0 (the invariants of
    tests/test_robustness.py)."""
    f = flat(out)
    for k, v in f.items():
        assert np.isfinite(v).all(), f"{k} has non-finite values"
    assert (f["clc"] >= 0).all() and (f["clc"] <= 1).all()
    if strict_fluxes:
        assert (f["fplsl"] >= 0).all() and (f["fplsn"] >= 0).all()
