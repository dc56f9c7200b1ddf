# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Field-wise validation of output dicts against reference data; the port's
own copy of :mod:`cloudsc2_tpu.utils.validation`.

Rebuild of ``ifs_physics_common.utils.validation.validate`` as used by the
reference NL driver (``drivers/run_nonlinear.py:139-147``; contract in
SURVEY.md §2.2): per-field ``allclose`` comparison with a printed report,
returning the list of failing fields.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def validate(
    fields: Dict[str, np.ndarray],
    fields_ref: Dict[str, np.ndarray],
    *,
    atol: float = 1e-18,
    rtol: float = 1e-12,
    verbose: bool = True,
) -> List[str]:
    """Compare ``fields`` against ``fields_ref`` per field.

    Returns the names of fields that failed.  Fields present in only one of
    the two dicts are reported as failures.
    """
    failing: List[str] = []
    for name in sorted(set(fields) | set(fields_ref)):
        if name not in fields or name not in fields_ref:
            failing.append(name)
            if verbose:
                print(f"Validation of {name}: MISSING")
            continue
        a = np.asarray(fields[name])
        b = np.asarray(fields_ref[name])
        if a.shape != b.shape:
            failing.append(name)
            if verbose:
                print(f"Validation of {name}: SHAPE MISMATCH {a.shape} vs {b.shape}")
            continue
        ok = np.allclose(a, b, atol=atol, rtol=rtol, equal_nan=False)
        if not ok:
            failing.append(name)
        if verbose:
            if ok:
                print(f"Validation of {name}: PASSED")
            else:
                denom = np.maximum(np.abs(b), atol / max(rtol, 1e-300))
                rel = np.abs(a - b) / denom
                print(
                    f"Validation of {name}: FAILED "
                    f"(max abs err {np.abs(a - b).max():.3e}, "
                    f"max rel err {rel.max():.3e})"
                )
    return failing
