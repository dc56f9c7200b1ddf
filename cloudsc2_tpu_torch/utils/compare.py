# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Field-by-field comparison of NL, TL and AD outputs with stated tolerances.

Used where the kernel is held against its plain version (``chip_smoke.py``)
and where the port is held against the JAX package (the tests).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from cloudsc2_tpu_torch.params import Constants

TENDENCIES = ("t", "q", "ql", "qi")
DIAGNOSTICS = ("clc", "covptot", "fplsl", "fplsn", "fhpsl", "fhpsn")
Tol = Tuple[float, float]  # (rtol, atol)


def flux_residue(dtype) -> float:
    """16 ulps of a 1e-4 kg m^-2 s^-1 precipitation flux in ``dtype``.

    A flux that evaporates fully (``fplsl = rfln - evapr``) leaves a
    residue of a few ulps of the flux before evaporation, with either sign,
    and two implementations whose ``exp``/``pow`` differ by an ulp leave
    different residues.  ``fhps* = -L * fpls*`` scales that residue by
    ``L`` ~ 2.5e6, which puts it above an absolute tolerance chosen for
    the flux itself."""
    return 16 * float(np.finfo(np.dtype(dtype)).eps) * 1e-4


def nl_tolerances(
    tend: Tol, diag: Tol, c: Constants, dtype, perturbations: bool = False
) -> Dict[str, Tol]:
    """Per-field ``(rtol, atol)``: ``tend`` for the tendencies, ``diag`` for
    ``clc, covptot, fplsl, fplsn``, and for ``fhpsl/fhpsn`` ``diag``'s rtol
    with the atol of :func:`flux_residue` times ``L`` (when larger).  With
    ``perturbations`` (the TL's outputs), each ``*_i`` field gets its
    field's tolerance."""
    tol = {n: tend for n in TENDENCIES}
    tol.update({n: diag for n in DIAGNOSTICS[:4]})
    res = flux_residue(dtype)
    tol["fhpsl"] = (diag[0], max(diag[1], res * c.RLVTT))
    tol["fhpsn"] = (diag[0], max(diag[1], res * c.RLSTT))
    if perturbations:
        tol.update({n + "_i": v for n, v in list(tol.items())})
    return tol


#: The AD kernels against the plain AD (``chip_smoke.py`` and the tests), per
#: field: the largest abs difference in units of the field's largest
#: magnitude.  f64: 1e-10 for every field.  f32: the Pallas AD's gate 2e-6
#: (tests/test_pallas.py:263), except ``AD_F32_KERNEL_WIDE``.  The two sides
#: round differently (the kernel's hand-transposed TL level around the NL
#: trajectory, the plain AD's autograd tape over the plain TL), and three
#: cotangents sum terms that cancel: the detrainment's lu_i and lude_i,
#: which go as 1/lu_next**2 through exp(-lude/lu_next) and span many
#: decades, and qsat_i, through the saturation adjustment.  A few large
#: points set those scales, so the three are also held point by point: the
#: median relative difference over their nonzero points stays below
#: ``AD_F32_MEDIAN_REL`` (measured: 0; a wrong term puts it near 1).
AD_SCALED = {"float64": 1e-10, "float32": 2e-6}
#: The f32 kernels against the f32 plain AD on the same tensors, in those
#: three fields: a few times the largest reading of the sound runs (the card
#: at the shapes of chip_smoke.py's phases 6 and 10 and of
#: tests/test_torch_cuda.py, the kernels' bodies built for the host in the
#: CPU tests): lu_i 1.48e-6 and lude_i 3.25e-6 (4096 x 137, evaporation on,
#: LREGCL off), qsat_i 1.09e-6 (1000 x 137, evaporation and LREGCL on); the
#: runs are in PERF.md, section 2.
AD_F32_KERNEL_WIDE = {"lu_i": 5e-6, "lude_i": 1e-5, "qsat_i": 3e-6}
#: An f32 side against the f64 plain AD on the same inputs (the spread of
#: f32 rounding, not a kernel's error): the plain f32 AD itself lies 1.971e-5
#: of lu_i's scale from the f64 plain AD (4000 x 137, H100).
AD_F32_SPREAD_WIDE = {"lu_i": 5e-5, "lude_i": 1e-5, "qsat_i": 2e-5}
AD_F32_MEDIAN_REL = 1e-3


#: The faithful and approx f32 NL kernels against the plain exact version
#: (``chip_smoke.py``, tests/test_torch_cuda.py): the largest abs difference
#: of each field over its largest magnitude, by the kernel's form, a few
#: times the largest card reading of either mode (the two read alike;
#: readings and runs in PERF.md, section 2).  Unfused, a reciprocal within
#: about an ulp moves no field by more than 2.0e-6 of its scale (q, 1000 x
#: 137), and fused no field but clc by more than 2.4e-4 (t, 4096 x 137).
#: Fused, the kernel divides inside saturation too, and an ulp of
#: qsat moves the step's thresholds and clc = 1 - sqrt(ratio) near ratio 0
#: by far more than an ulp (the exact path does the same,
#: tests/test_torch_nl_fused.py), so clc has its own gate, above the 1e-3
#: of JAX's faithful test (tests/test_pallas.py:286-309, which runs the
#: unfused kernel; clc read 1.45e-3 at 65,536 x 137).  ``"*"`` is every
#: other field.
#: ``"tl"`` and ``"ad"``: the faithful and approx f32 TL kernel and the AD
#: kernels (two-kernel and fused, every output) against the plain exact
#: TL and AD, likewise a few times the card's largest readings, both modes
#: alike (4096 x 137 in the three configurations and 65,536 x 137 in the
#: default, seed 1): every TL field at most 1.323e-6 of its scale (t,
#: 65,536) but q_i, 3.13e-5 with evaporation (the reciprocal's ulp moves an
#: evaporation threshold); every AD output at most 1.323e-6 (t) but lu_i,
#: 2.90e-5 (approx, 65,536), which goes as 1/lu_next**2.
DIV_GATES = {
    "unfused": {"*": 1e-5},
    "fused": {"*": 1e-3, "clc": 5e-3},
    "tl": {"*": 5e-6, "q_i": 1e-4},
    "ad": {"*": 5e-6, "lu_i": 1e-4},
}


def div_gate(field: str, form: str) -> float:
    """The gate of ``DIV_GATES`` for ``field`` in the kernel's form
    (``"unfused"`` or ``"fused"`` NL, ``"tl"``, ``"ad"``)."""
    gates = DIV_GATES[form]
    return gates.get(field, gates["*"])


def dtype_name(dtype) -> str:
    """``"float32"``/``"float64"`` for a numpy or a torch dtype."""
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else np.dtype(dtype).name


def ad_limit(name: str, dtype, wide: Mapping[str, float] = AD_F32_KERNEL_WIDE) -> Tuple[float, float]:
    """``(scaled limit, median relative limit)`` of the AD output ``name``:
    see ``AD_SCALED``; ``wide`` gives the f32 fields held wider, and also
    point by point (an infinite median limit holds nothing): by default the
    kernels' gate against the plain AD, ``AD_F32_KERNEL_WIDE``."""
    if dtype_name(dtype) == "float64":
        return AD_SCALED["float64"], np.inf
    if name in wide:
        return wide[name], AD_F32_MEDIAN_REL
    return AD_SCALED["float32"], np.inf


def ad_errors(
    got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray], dtype,
    wide: Mapping[str, float] = AD_F32_KERNEL_WIDE,
) -> Dict[str, Tuple[float, float, float]]:
    """Per field of ``want``: ``(largest abs difference over the field's
    largest magnitude, median relative difference over the nonzero points
    of want, worst share of the limits of ad_limit)``; a share above 1
    fails.  Non-finite values give an infinite share."""
    out = {}
    for n, w in want.items():
        g = np.asarray(got[n], np.float64)
        w = np.asarray(w, np.float64)
        if g.shape != w.shape:
            raise ValueError(f"{n}: shape {g.shape} vs {w.shape}")
        if not np.isfinite(g).all():
            out[n] = (np.inf, np.inf, np.inf)
            continue
        err = np.abs(g - w)
        scaled = float(err.max()) / max(float(np.abs(w).max()), 1e-300)
        nz = w != 0
        med = float(np.median(err[nz] / np.abs(w[nz]))) if nz.any() else 0.0
        lim, med_lim = ad_limit(n, dtype, wide)
        out[n] = (scaled, med, max(scaled / lim, med / med_lim))
    return out


def field_errors(
    got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray], tol: Mapping[str, Tol]
) -> Dict[str, Tuple[float, float, float]]:
    """Per field ``(max abs error, max rel error, worst share of the limit
    atol + rtol*|want|)``; a share above 1 fails.  Non-finite values give
    an infinite share."""
    out = {}
    for n, (rtol, atol) in tol.items():
        g = np.asarray(got[n], np.float64)
        w = np.asarray(want[n], np.float64)
        if g.shape != w.shape:
            raise ValueError(f"{n}: shape {g.shape} vs {w.shape}")
        if not np.isfinite(g).all():
            out[n] = (np.inf, np.inf, np.inf)
            continue
        err = np.abs(g - w)
        rel = err / np.maximum(np.abs(w), np.finfo(np.float64).tiny)
        out[n] = (float(err.max()), float(rel.max()), float((err / (atol + rtol * np.abs(w))).max()))
    return out
