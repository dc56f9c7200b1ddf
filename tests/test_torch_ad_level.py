# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The AD kernels' reverse level (``ad_level`` of kernels/csrc/ad_level.h,
the hand transpose of ``tl_level``), point by point through the host
build's level entry (``cloudsc2_ad_level_host`` in adjoint_host.cpp).

Duality: at each point, for perturbations d of the level's 14 input
directions and cotangents w of its 9 outputs, ``<w, TL d> == <AD w, d>``.
The points are drawn from a numpy seed over the ranges of the model's
fields, so that every two-way choice of ``tl_level`` is taken both ways
(the mask of branches the entry reports), for EVAP x LREGCL.

The two sides are evaluated in the arrays' type.  Where the level cancels
(the cloud-cover slope near crh2 = 1 or qt = qsat, the detrainment at
large lude / lu_next), both sides round well above the size of the inner
products' terms: by up to 2.1e-11 of them in f64 at 20,000 points.  So the
difference is held relative to the larger of two sizes: the terms
``sum |w_j (TL d)_j| + sum |(AD w)_k d_k|``, and the magnitude the
evaluation rounds, each side's distance from the same code run in long
double on the same inputs (the entry's reference) over the type's machine
epsilon.  A transposition fault moves both evaluations alike and cannot
hide there.  Limits: f64 1e-12, f32 1e-6 (measured: 3.9e-16 and 1.2e-7).
The long double reference itself meets 1e-12 of the terms (measured:
1.8e-14).

The same check holds the level's other forms (``test_ad_level_duality_forms``):
the reference-shaped saturation adjustment (``CUADJ_COMPACT=False``, f64
and f32) and the faithful and approx divides (f32; float64 divides
exactly), at the same limits.  Under a non-exact divide the reference takes
the approximate reciprocal of the same float operands and carries the rest
in long double, so the reciprocals are one function on both sides and the
duality is exact in long double there too.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch.kernels import adjoint as adk
from tests.torch_helpers import CONFIGS

torch.set_num_threads(1)

NPOINTS = 20_000
DT = 1800.0
#: (limit on the duality difference in units of the larger size, machine
#: epsilon) by type
DUALITY = {torch.float64: (1e-12, 2.0 ** -52), torch.float32: (1e-6, 2.0 ** -23)}
#: the branches taken only with evaporation
EVAP_BRANCHES = ("eact", "big", "drained")


def _points(dtype, seed=0, n=NPOINTS):
    """Level inputs, column values, carries and perturbations at n points:
    temperatures across the freezing, ice and melt thresholds, pressures low
    enough to clip the saturation ratio, humidity from dry to supersaturated,
    detrainment and precipitation fluxes on and off over many decades."""
    r = np.random.default_rng(seed)
    t = r.uniform(205.0, 315.0, n)
    ap = 10.0 ** r.uniform(np.log10(2e3), np.log10(1.05e5), n)
    es = 611.2 * np.exp(17.5 * (t - 273.16) / (t - 32.19))
    qsat = np.clip(0.622 * es / ap, 1e-7, 0.5) * r.uniform(0.8, 1.2, n)
    x = {
        "ap": ap, "dp": r.uniform(200.0, 3000.0, n),
        "lu_next": r.uniform(0.0, 1e-3, n) * (r.random(n) < 0.7),
        "lude": r.uniform(0.0, 1e-3, n) * (r.random(n) < 0.6),
        "mf": r.uniform(-0.05, 0.3, n),
        "q2": qsat * r.uniform(0.1, 1.6, n),
        "ql_fg": qsat * r.uniform(0.0, 0.2, n) * (r.random(n) < 0.7),
        "qi_fg": qsat * r.uniform(0.0, 0.2, n) * (r.random(n) < 0.7),
        "qsat": qsat, "t_fg": t, "eta": r.uniform(0.02, 1.0, n), "scalm": r.uniform(0.0, 0.8, n),
    }
    col = {"aph_s": r.uniform(9.5e4, 1.04e5, n), "trpaus": r.uniform(0.1, 0.4, n)}
    traj = {"rfl": 10.0 ** r.uniform(-9.0, -3.0, n) * (r.random(n) < 0.85),
            "sfl": 10.0 ** r.uniform(-9.0, -3.0, n) * (r.random(n) < 0.75),
            "covptot": r.uniform(0.0, 1.0, n)}
    size = {**x, "rfl": traj["rfl"], "sfl": traj["sfl"], "cov": traj["covptot"], "aph_s": col["aph_s"]}
    dirs = {k: 0.01 * (np.abs(size[k]) + 1e-12) * r.standard_normal(n) for k in adk.AD_DIRS}
    as_t = lambda d: {k: torch.tensor(v, dtype=dtype) for k, v in d.items()}
    return as_t(x), as_t(col), as_t(traj), as_t(dirs), r


def _config(evap, lregcl):
    return CONFIGS["levapls2" if evap else "default"]().replace(LREGCL=lregcl)


def _inner(tl, ad, w, dirs):
    """``(<w, TL d>, <AD w, d>, the sum of their terms' magnitudes)`` per point."""
    lt = np.stack([w[k].double().numpy() * tl[k].double().numpy() for k in adk.AD_WEIGHTS])
    rt = np.stack([ad[k].double().numpy() * dirs[k].double().numpy() for k in adk.AD_DIRS])
    return lt.sum(0), rt.sum(0), np.abs(lt).sum(0) + np.abs(rt).sum(0)


#: the level's other forms: (dtype, FAST_DIV, CUADJ_COMPACT)
FORMS = {
    "ref-f64": (torch.float64, "exact", False),
    "ref-f32": (torch.float32, "exact", False),
    "faithful-f32": (torch.float32, "faithful", True),
    "approx-f32": (torch.float32, "approx", True),
    "ref-approx-f32": (torch.float32, "approx", False),
}


@pytest.mark.parametrize("lregcl", [True, False], ids=["lregcl", "nolregcl"])
@pytest.mark.parametrize("evap", [False, True], ids=["noevap", "evap"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_ad_level_duality(dtype, evap, lregcl):
    _check_duality(dtype, _config(evap, lregcl), evap)


@pytest.mark.parametrize("lregcl", [True, False], ids=["lregcl", "nolregcl"])
@pytest.mark.parametrize("evap", [False, True], ids=["noevap", "evap"])
@pytest.mark.parametrize("form", list(FORMS))
def test_ad_level_duality_forms(form, evap, lregcl):
    dtype, mode, compact = FORMS[form]
    _check_duality(dtype, _config(evap, lregcl).replace(FAST_DIV=mode, CUADJ_COMPACT=compact), evap)


def _check_duality(dtype, c, evap):
    x, col, traj, dirs, r = _points(dtype)
    zero = {k: torch.zeros(NPOINTS, dtype=dtype) for k in adk.AD_WEIGHTS}
    tl0 = adk.cloudsc2_ad_level_host(x, col, traj, dirs, zero, DT, c)[0]
    # cotangents of unit size against each output's spread; without
    # evaporation the covptot outputs have none (the AD drops them)
    w = {}
    for k in adk.AD_WEIGHTS:
        rms = float(np.sqrt(np.mean(tl0[k].double().numpy() ** 2))) or 1.0
        w[k] = torch.tensor(r.standard_normal(NPOINTS) / rms, dtype=dtype)
        if not evap and k in ("cov", "covptot"):
            w[k].zero_()
    tl, ad, branches = adk.cloudsc2_ad_level_host(x, col, traj, dirs, w, DT, c)
    ref_tl, ref_ad, ref_branches = adk.cloudsc2_ad_level_host(x, col, traj, dirs, w, DT, c, reference=True)
    lhs, rhs, terms = _inner(tl, ad, w, dirs)
    ref_lhs, ref_rhs, ref_terms = _inner(ref_tl, ref_ad, w, dirs)
    assert np.isfinite(lhs).all() and np.isfinite(rhs).all()
    limit, eps = DUALITY[dtype]
    rounded = (np.abs(lhs - ref_lhs) + np.abs(rhs - ref_rhs)) / eps
    rel = np.abs(lhs - rhs) / np.maximum(terms, rounded)
    worst = int(rel.argmax())
    assert rel.max() <= limit, (f"duality off by {rel.max():.3e} at point {worst}: <w, TL d> {lhs[worst]!r}, "
                                f"<AD w, d> {rhs[worst]!r}, terms {terms[worst]!r}")
    assert (np.abs(ref_lhs - ref_rhs) / ref_terms).max() <= 1e-12
    # the reference takes the same branches, so each side's distance from it
    # is rounding alone; every two-way choice is taken both ways (the
    # evaporation ones only with it)
    np.testing.assert_array_equal(branches.numpy(), ref_branches.numpy())
    mask = branches.numpy()
    for i, name in enumerate(adk.AD_BRANCHES):
        taken = int(((mask >> i) & 1).sum())
        if not evap and name in EVAP_BRANCHES:
            assert taken == 0, name
        else:
            assert 0 < taken < NPOINTS, f"{name} taken at {taken} of {NPOINTS} points"


def test_ad_level_zero_weights_give_zero_cotangents():
    c = _config(True, True)
    x, col, traj, dirs, _ = _points(torch.float64, n=1000)
    zero = {k: torch.zeros(1000, dtype=torch.float64) for k in adk.AD_WEIGHTS}
    ad = adk.cloudsc2_ad_level_host(x, col, traj, dirs, zero, DT, c)[1]
    for k, v in ad.items():
        assert v.abs().max().item() == 0.0, k


def test_ad_level_host_argument_lists():
    """The compiled entry reports the argument lists the wrapper passes."""
    lib = adk._load("host")
    assert lib.cloudsc2_ad_level_signature().decode() == adk.level_signature()
