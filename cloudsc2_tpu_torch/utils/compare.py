# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Field-by-field comparison of NL and TL outputs with stated tolerances.

Used where the kernel is held against its plain version (``chip_smoke.py``)
and where the port is held against the JAX package (the tests).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from cloudsc2_tpu.params import Constants

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
