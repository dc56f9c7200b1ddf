# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The CUDA NL, TL and AD kernels on the card (marker ``cuda``; skipped
without a GPU).

Run on a machine with an NVIDIA Hopper GPU and nvcc:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
(``--noconftest``: tests/conftest.py imports jax, which that machine may
not have; this file imports none).

The kernel against its plain version on the same CUDA tensors, at small
and ragged column counts: both use the device's libm, so they agree to
the f64 double gate (rtol 1e-10, atol 1e-16) and the f32 Pallas gate
(rtol 2e-5, atol 1e-8 / 1e-6), fhps* with the flux-residue atol of
``cloudsc2_tpu_torch.utils.compare.nl_tolerances``.  The TL kernel (every
field and its ``*_i``): the same f64 gate, the f32 TL gate of
tests/test_pallas.py (rtol 3e-5, atol 1e-7 / 1e-5), fhps* likewise; its
``tangent_only`` outputs bitwise equal to the full launch's ``*_i``.  The
NL kernel's ``with_trajectory``: the step's outputs bitwise unchanged, the
carry entering level k bitwise the flux at interface k.  The AD kernels
against the plain AD, every field within the limits of
``cloudsc2_tpu_torch.utils.compare.ad_limit`` (those of chip_smoke.py), and
the symmetry driver's HOORAY through them.  The fused AD kernel, rolled and
resident, bitwise the two-kernel AD and within those limits of the plain
AD; ``cotangent_only`` and ``traj_only`` bitwise the full forms.  The
fused NL kernel bitwise ``Saturation`` + the unfused kernel; the faithful
and approx f32 kernels within ``div_gate`` of the plain exact version and
not bitwise the exact kernel (f64 with FAST_DIV set bitwise exact), the
reciprocal alone (``rcp_cuda``): approx within an ulp, faithful one Newton
step of approx.  ``Cloudsc2AD`` and both AD kernels with LPHYLIN=False run
the kernels, bitwise their LPHYLIN=True launch.  The TL and AD kernels under
faithful and approx (f32) within ``div_gate`` ("tl", "ad") of the plain exact
versions and not bitwise the exact kernels, the fused AD bitwise the
two-kernel AD in the same mode, f64 with FAST_DIV set bitwise exact; the NL,
TL and AD kernels with CUADJ_COMPACT=False against their plain versions in
that form at the gates above.  The probes (``kernels/microbench.py``): the
reader bitwise its plain version at every stream count; every chain
variant bitwise its plain version given the card's approximate reciprocal,
one step within its ulp bound, every variant within 1e-6 of the float64
chain; the chain kernel's record of its blocks' SMs.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
from cloudsc2_tpu_torch.physics.adjoint import cloudsc2_ad
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl
from cloudsc2_tpu_torch.state import state_from_numpy
from cloudsc2_tpu_torch.utils.compare import div_gate, nl_tolerances
from tests.torch_helpers import CONFIGS, assert_ad, assert_fields, flat

pytestmark = pytest.mark.cuda

TOL = {
    torch.float64: ((1e-10, 1e-16), (1e-10, 1e-16)),
    torch.float32: ((2e-5, 1e-8), (2e-5, 1e-6)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def _state(ncols, dtype, c, device, seed=3, increment=False):
    _, st, dt = iox.synthesize_input(ncols=ncols, nlev=137, seed=seed)
    s = state_from_numpy(st, device, dtype)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    if increment:
        s.update(state_increment(s, 0.01))
    return s, dt


def _host(out):
    return flat({k: v.cpu() for k, v in d.items()} for d in out)


@pytest.mark.parametrize("ncols", [1, 100, 1000])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(cuda, ncols, cfg, dtype):
    c = CONFIGS[cfg]()
    s, dt = _state(ncols, dtype, c, cuda)
    before = nlk.cloudsc2_nl_cuda.launches
    got = flat({k: v.cpu() for k, v in d.items()} for d in nlk.cloudsc2_nl_cuda(s, dt, c))
    assert nlk.cloudsc2_nl_cuda.launches == before + 1
    want = flat({k: v.cpu() for k, v in d.items()} for d in cloudsc2_nl(s, dt, c))
    tend, diag = TOL[dtype]
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    assert_fields(got, want, nl_tolerances(tend, diag, c, np_dtype), f"{cfg} {dtype} {ncols}")


def test_kernel_refuses_bad_inputs(cuda):
    c = CONFIGS["default"]()
    s, dt = _state(64, torch.float32, c, cuda)
    with pytest.raises(ValueError, match="is on"):
        nlk.cloudsc2_nl_cuda({**s, "q": s["q"].cpu()}, dt, c)
    with pytest.raises(ValueError, match="contiguous"):
        nlk.cloudsc2_nl_cuda({**s, "t": s["t"].t().contiguous().t()}, dt, c)
    with pytest.raises(TypeError, match="dtype"):
        nlk.cloudsc2_nl_cuda({**s, "lu": s["lu"].double()}, dt, c)


TL_TOL = {
    torch.float64: ((1e-10, 1e-16), (1e-10, 1e-16)),
    torch.float32: ((3e-5, 1e-7), (3e-5, 1e-5)),
}


@pytest.mark.parametrize("lregcl", [True, False])
@pytest.mark.parametrize("ncols", [1, 100, 1000])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tl_kernel_matches_plain_on_card(cuda, ncols, cfg, dtype, lregcl):
    c = CONFIGS[cfg]().replace(LREGCL=lregcl)
    s, dt = _state(ncols, dtype, c, cuda, increment=True)
    before = tlk.cloudsc2_tl_cuda.launches
    got = _host(tlk.cloudsc2_tl_cuda(s, dt, c))
    assert tlk.cloudsc2_tl_cuda.launches == before + 1
    want = _host(cloudsc2_tl(s, dt, c))
    tend, diag = TL_TOL[dtype]
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    tol = nl_tolerances(tend, diag, c, np_dtype, perturbations=True)
    assert_fields(got, want, tol, f"{cfg} {dtype} {ncols} lregcl={lregcl}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tl_kernel_tangent_only_on_card(cuda, dtype):
    c = CONFIGS["levapls2"]()
    s, dt = _state(1000, dtype, c, cuda, increment=True)
    full = _host(tlk.cloudsc2_tl_cuda(s, dt, c))
    only = _host(tlk.cloudsc2_tl_cuda(s, dt, c, tangent_only=True))
    assert sorted(only) == sorted(k for k in full if k.endswith("_i"))
    for k in only:
        np.testing.assert_array_equal(only[k], full[k], err_msg=k)


def test_tl_kernel_refuses_bad_inputs(cuda):
    c = CONFIGS["default"]()
    s, dt = _state(64, torch.float32, c, cuda, increment=True)
    before = tlk.cloudsc2_tl_cuda.launches
    with pytest.raises(ValueError, match="is on"):
        tlk.cloudsc2_tl_cuda({**s, "q_i": s["q_i"].cpu()}, dt, c)
    with pytest.raises(ValueError, match="contiguous"):
        tlk.cloudsc2_tl_cuda({**s, "t_i": s["t_i"].t().contiguous().t()}, dt, c)
    with pytest.raises(TypeError, match="dtype"):
        tlk.cloudsc2_tl_cuda({**s, "lu_i": s["lu_i"].double()}, dt, c)
    with pytest.raises(ValueError, match="shape"):
        tlk.cloudsc2_tl_cuda({**s, "aph_i": s["aph_i"][:-1]}, dt, c, tangent_only=True)
    assert tlk.cloudsc2_tl_cuda.launches == before


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nl_kernel_trajectory_on_card(cuda, cfg, dtype):
    c = CONFIGS[cfg]()
    s, dt = _state(1000, dtype, c, cuda)
    plain = _host(nlk.cloudsc2_nl_cuda(s, dt, c))
    tends, diags, traj = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True)
    got = _host((tends, diags))
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    np.testing.assert_array_equal(traj["c_rfl"].cpu().numpy(), got["fplsl"][:-1])
    np.testing.assert_array_equal(traj["c_sfl"].cpu().numpy(), got["fplsn"][:-1])
    assert ("c_cov" in traj) == bool(c.LEVAPLS2 or c.LDRAIN1D)


def _convective(c):
    """LPHYLIN off and a convective liquid-fraction ramp apart from
    foealfa's, so that saturation's kflag 1 and 2 branches differ."""
    return c.replace(LPHYLIN=False, RTICECU=c.RTT - 38.0, RTWAT_RTICECU_R=1.0 / 38.0)


FUSED_CASES = [(name, make, 1) for name, make in CONFIGS.items()] + [
    ("lphylin=False kflag=1", lambda: _convective(CONFIGS["default"]()), 1),
    ("lphylin=False kflag=2", lambda: _convective(CONFIGS["default"]()), 2),
]


@pytest.mark.parametrize("ncols", [1, 1000])
@pytest.mark.parametrize("label,make,kflag", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_kernel_is_saturation_then_the_kernel_on_card(cuda, label, make, kflag, ncols, dtype):
    """The fused kernel is bitwise ``Saturation`` + the unfused kernel on
    the same tensors (the same level code and the device's libm on both
    sides, --fmad=false), qsat included; one launch, the state's qsat not
    read."""
    c = make()
    s, dt = _state(ncols, dtype, c, cuda)
    qsat = saturation(s["ap"], s["t"], kflag=kflag, lphylin=c.LPHYLIN, c=c)
    want = _host(nlk.cloudsc2_nl_cuda(dict(s, qsat=qsat), dt, c))
    want["qsat"] = qsat.cpu().numpy()
    before = nlk.cloudsc2_nl_cuda.launches
    got = _host(nlk.cloudsc2_nl_cuda({k: v for k, v in s.items() if k != "qsat"}, dt, c,
                                     fuse_saturation=True, kflag=kflag))
    assert nlk.cloudsc2_nl_cuda.launches == before + 1
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", ["faithful", "approx"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_divide_modes_on_card(cuda, cfg, mode, fused):
    """The faithful and approx f32 kernels against the plain exact version,
    per field in units of its largest magnitude, at the gate of their form
    (``cloudsc2_tpu_torch.utils.compare.div_gate``), and not bitwise the
    exact kernel (a divide mode that fell back to the IEEE divide would
    pass the gate); f64 with the mode set is bitwise the exact kernel."""
    c = CONFIGS[cfg]()
    s, dt = _state(1000, torch.float32, c, cuda)
    if fused:
        del s["qsat"]
    before = (nlk.cloudsc2_nl_cuda.launches, nlk.cloudsc2_nl_cuda.fast_div_launches)
    got = nlk.cloudsc2_nl_cuda(s, dt, c.replace(FAST_DIV=mode), fuse_saturation=fused)
    assert (nlk.cloudsc2_nl_cuda.launches, nlk.cloudsc2_nl_cuda.fast_div_launches) == (before[0] + 1, before[1] + 1)
    got, want = _host(got), _host(cloudsc2_nl(s, dt, c, fuse_saturation=fused))
    for k, w in want.items():
        w = w.astype(np.float64)
        scaled = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
        assert scaled <= div_gate(k, "fused" if fused else "unfused"), (k, scaled)
    exact32 = _host(nlk.cloudsc2_nl_cuda(s, dt, c, fuse_saturation=fused))
    assert any(not np.array_equal(got[k], exact32[k]) for k in exact32)
    s64, dt = _state(100, torch.float64, c, cuda)
    if fused:
        del s64["qsat"]
    exact = _host(nlk.cloudsc2_nl_cuda(s64, dt, c, fuse_saturation=fused))
    fast = _host(nlk.cloudsc2_nl_cuda(s64, dt, c.replace(FAST_DIV=mode), fuse_saturation=fused))
    for k in exact:
        np.testing.assert_array_equal(fast[k], exact[k], err_msg=k)


def test_rcp_on_card(cuda):
    """The kernel's reciprocal alone at 2**20 seeded float32 points of either
    sign over 1e-30 to 1e30: exact is the correctly rounded 1/x; approx
    (PTX rcp.approx.ftz.f32) within 1 ulp of 1/x and not the IEEE divide
    everywhere; faithful bitwise approx's r * (2 - x * r) in three rounded
    operations, within 2 ulps, and not approx everywhere."""
    g = torch.Generator(device="cpu").manual_seed(5)
    n = 1 << 20
    x = (10.0 ** (torch.rand(n, generator=g, dtype=torch.float64) * 60 - 30)
         * torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0).double()).float().to(cuda)
    want = (1.0 / x.double()).float()
    r = {m: nlk.rcp_cuda(x, m) for m in ("exact", "faithful", "approx")}
    assert torch.equal(r["exact"], want)
    ulp = (torch.nextafter(want.abs(), torch.tensor(float("inf"), device=cuda)) - want.abs()).double()
    for m, lim in (("approx", 1.0), ("faithful", 2.0)):
        assert float(((r[m].double() - 1.0 / x.double()).abs() / ulp).max()) <= lim, m
    assert not torch.equal(r["approx"], want)
    a = r["approx"]
    assert torch.equal(r["faithful"], a * (2.0 - x * a))
    assert not torch.equal(r["faithful"], a)


def test_ad_component_without_lphylin_refuses_on_card(cuda):
    """Cloudsc2AD with LPHYLIN=False on CUDA tensors runs the kernels (one
    NL and one reverse launch), bitwise the LPHYLIN=True launch on the same
    state, and within ``ad_limit`` of the plain AD under LPHYLIN=False."""
    from cloudsc2_tpu_torch.components import Cloudsc2AD
    from cloudsc2_tpu_torch.grid import Grid

    c = CONFIGS["levapls2"]().replace(LPHYLIN=False)
    s, dt = _ad_state(100, torch.float32, c, cuda)
    for n in ("t", "q", "ql", "qi"):
        s["tnd_" + n] = torch.zeros_like(s["ap"])
    counts = lambda: (nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches)  # noqa: E731
    before = counts()
    got = _host(Cloudsc2AD(Grid(ncols=100, nlev=137), c)(s, dt))
    assert counts() == (before[0] + 1, before[1] + 1)
    want = _host(adk.cloudsc2_ad_cuda(s, dt, c.replace(LPHYLIN=True)))
    assert got.keys() == want.keys() and len(want) == 26
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert_ad(got, _host(cloudsc2_ad(s, dt, c)), torch.float32, "LPHYLIN=False")


def _ad_state(ncols, dtype, c, device):
    s, dt = _state(ncols, dtype, c, device)
    s.update(state_increment(s, 0.01, ignore_supsat=True))
    tends, diags = cloudsc2_tl(s, dt, c)
    for n in ("t", "q", "ql", "qi"):
        s["tnd_" + n + "_i"] = tends[n + "_i"]
    for n in ("clc", "covptot", "fhpsl", "fhpsn", "fplsl", "fplsn"):
        s[n + "_i"] = diags[n + "_i"]
    return s, dt


@pytest.mark.parametrize("lregcl", [True, False])
@pytest.mark.parametrize("ncols", [1, 1000])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ad_kernel_matches_plain_on_card(cuda, ncols, cfg, dtype, lregcl):
    c = CONFIGS[cfg]().replace(LREGCL=lregcl)
    s, dt = _ad_state(ncols, dtype, c, cuda)
    before = (nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches)
    got = _host(adk.cloudsc2_ad_cuda(s, dt, c))
    assert (nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches) == (before[0] + 1, before[1] + 1)
    want = _host(cloudsc2_ad(s, dt, c))
    assert len(want) == 26
    assert_ad(got, want, dtype, f"{cfg} {dtype} {ncols} {lregcl}")


def test_ad_kernel_refuses_bad_inputs(cuda):
    c = CONFIGS["default"]()
    s, dt = _ad_state(64, torch.float32, c, cuda)
    before = adk.cloudsc2_ad_cuda.launches
    with pytest.raises(ValueError, match="FAST_DIV"):
        adk.cloudsc2_ad_cuda(s, dt, c.replace(FAST_DIV="fast"))
    with pytest.raises(ValueError, match="is on"):
        adk.cloudsc2_ad_cuda({**s, "clc_i": s["clc_i"].cpu()}, dt, c)
    with pytest.raises(ValueError, match="shape"):
        adk.cloudsc2_ad_cuda({**s, "fplsl_i": s["fplsl_i"][:-1]}, dt, c)
    with pytest.raises(KeyError):
        adk.cloudsc2_ad_cuda({k: v for k, v in s.items() if k != "tnd_q_i"}, dt, c)
    assert adk.cloudsc2_ad_cuda.launches == before


@pytest.mark.parametrize("precision", ["double", "single"])
def test_symmetry_driver_on_card(cuda, precision, capsys):
    from drivers.run_symmetry_test_torch import main

    before = adk.cloudsc2_ad_cuda.launches
    rc = main(["--device", "cuda", "--precision", precision, "--num-cols", "1000"])
    out = capsys.readouterr().out
    assert rc == 0 and "HOORAY" in out, out
    assert adk.cloudsc2_ad_cuda.launches == before + 1


@pytest.mark.parametrize("ncols", [1000, 333])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ad_fused_kernel_on_card(cuda, ncols, cfg, dtype):
    """The fused kernel, rolled and resident, is bitwise the two-kernel AD
    and within ``ad_limit`` of the plain AD; one launch each."""
    c = CONFIGS[cfg]()
    s, dt = _ad_state(ncols, dtype, c, cuda)
    two = _host(adk.cloudsc2_ad_cuda(s, dt, c))
    want = _host(cloudsc2_ad(s, dt, c))
    for resident in (False, True):
        before = adk.cloudsc2_ad_fused_cuda.launches
        got = _host(adk.cloudsc2_ad_fused_cuda(s, dt, c, resident=resident))
        assert adk.cloudsc2_ad_fused_cuda.launches == before + 1
        label = f"{cfg} {dtype} {ncols} resident={resident}"
        assert got.keys() == two.keys(), label
        for k in two:
            np.testing.assert_array_equal(got[k], two[k], err_msg=f"{label} {k}")
        assert_ad(got, want, dtype, label)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gradient_only_forms_on_card(cuda, dtype):
    """``cotangent_only`` returns the full AD's cotangents bitwise, and
    ``traj_only`` the trajectory of ``with_trajectory``."""
    c = CONFIGS["levapls2"]()
    s, dt = _ad_state(1000, dtype, c, cuda)
    full = _host(adk.cloudsc2_ad_cuda(s, dt, c))
    only = _host(adk.cloudsc2_ad_cuda(s, dt, c, cotangent_only=True))
    assert sorted(only) == sorted(k for k in full if k.endswith("_i")) and len(only) == 16
    for k in only:
        np.testing.assert_array_equal(only[k], full[k], err_msg=k)
    tends, diags, traj = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True, traj_only=True)
    assert tends == {} and diags == {}
    want = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True)[2]
    assert sorted(traj) == sorted(want) == ["c_cov", "c_rfl", "c_sfl"]
    for k in want:
        np.testing.assert_array_equal(traj[k].cpu().numpy(), want[k].cpu().numpy(), err_msg=k)


def test_ad_fused_kernel_refuses_bad_inputs(cuda):
    c = CONFIGS["default"]()
    s, dt = _ad_state(64, torch.float32, c, cuda)
    before = adk.cloudsc2_ad_fused_cuda.launches
    with pytest.raises(ValueError, match="FAST_DIV"):
        adk.cloudsc2_ad_fused_cuda(s, dt, c.replace(FAST_DIV="fast"))
    with pytest.raises(ValueError, match="is on"):
        adk.cloudsc2_ad_fused_cuda({**s, "clc_i": s["clc_i"].cpu()}, dt, c)
    with pytest.raises(ValueError, match="shape"):
        adk.cloudsc2_ad_fused_cuda({**s, "fplsl_i": s["fplsl_i"][:-1]}, dt, c, resident=True)
    assert adk.cloudsc2_ad_fused_cuda.launches == before


def test_ad_reverse_attributes_on_card(cuda):
    """The reverse kernel's registers a thread, as the launch bounds allow,
    and no local memory in the default instantiations."""
    for dtype in (torch.float32, torch.float64):
        att = adk.reverse_attributes(dtype, False, True)
        assert 0 < att["registers"] <= 255 and att["local_bytes"] == 0, att


def test_ad_fused_occupancy_on_card(cuda):
    """The card's pick of the fused kernel's block is the plan's at 137
    levels: its blocks per SM (192 / 96 threads in f32 / f64 rolled, one
    block resident) and its shared memory."""
    for dtype in (torch.float32, torch.float64):
        for resident in (False, True):
            occ = adk.fused_occupancy(dtype, CONFIGS["default"](), resident, 137)
            block, nbytes, per_sm = adk.fused_plan(137, dtype, False, resident)
            assert (occ["block"], occ["shared_bytes"], occ["blocks_per_sm"]) == (block, nbytes, per_sm), occ
            assert occ["threads_per_sm"] == (192 if dtype == torch.float32 else 96) or resident, occ
            assert 0 < occ["registers"] <= 255, occ


# ---- the forms of the TL and AD kernels: divide modes, CUADJ_COMPACT=False, LPHYLIN=False


def _scaled(got, want):
    return {k: float(np.abs(got[k].astype(np.float64) - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-300)
            for k in want}


@pytest.mark.parametrize("mode", ["faithful", "approx"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_tl_and_ad_fast_div_kernels_on_card(cuda, cfg, mode):
    """f32: the TL kernel and the two-kernel AD under ``mode`` within
    ``div_gate`` of the plain exact versions and not bitwise the exact
    kernels; ``tangent_only`` bitwise the full launch; the fused AD, rolled
    and resident, bitwise the two-kernel AD in the mode; f64 with the mode
    set bitwise the exact kernels."""
    c = CONFIGS[cfg]()
    cm = c.replace(FAST_DIV=mode)
    s, dt = _state(1000, torch.float32, c, cuda, increment=True)
    got = _host(tlk.cloudsc2_tl_cuda(s, dt, cm))
    exact = _host(tlk.cloudsc2_tl_cuda(s, dt, c))
    for k, v in _scaled(got, _host(cloudsc2_tl(s, dt, c))).items():
        assert v <= div_gate(k, "tl"), (k, v)
    assert any(not np.array_equal(got[k], exact[k]) for k in got)
    only = _host(tlk.cloudsc2_tl_cuda(s, dt, cm, tangent_only=True))
    for k in only:
        np.testing.assert_array_equal(only[k], got[k], err_msg=k)
    s, dt = _ad_state(1000, torch.float32, c, cuda)
    got = _host(adk.cloudsc2_ad_cuda(s, dt, cm))
    exact = _host(adk.cloudsc2_ad_cuda(s, dt, c))
    for k, v in _scaled(got, _host(cloudsc2_ad(s, dt, c))).items():
        assert v <= div_gate(k, "ad"), (k, v)
    assert any(not np.array_equal(got[k], exact[k]) for k in got)
    for resident in (False, True):
        fused = _host(adk.cloudsc2_ad_fused_cuda(s, dt, cm, resident=resident))
        for k in got:
            np.testing.assert_array_equal(fused[k], got[k], err_msg=f"resident={resident} {k}")
    s, dt = _ad_state(100, torch.float64, c, cuda)
    want = _host(adk.cloudsc2_ad_cuda(s, dt, c))
    for fn in (adk.cloudsc2_ad_cuda, adk.cloudsc2_ad_fused_cuda):
        fast = _host(fn(s, dt, cm))
        for k in want:
            np.testing.assert_array_equal(fast[k], want[k], err_msg=f"{fn.__name__} {k}")


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_compact_false_kernels_on_card(cuda, dtype, cfg):
    """CUADJ_COMPACT=False: the NL, TL and AD kernels against their plain
    versions in that form at the gates of their compact form; the fused AD
    bitwise the two-kernel AD."""
    c = CONFIGS[cfg]().replace(CUADJ_COMPACT=False)
    s, dt = _state(1000, dtype, c, cuda, increment=True)
    tend, diag = TOL[dtype]
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    assert_fields(_host(nlk.cloudsc2_nl_cuda(s, dt, c)), _host(cloudsc2_nl(s, dt, c)),
                  nl_tolerances(tend, diag, c, np_dtype), f"NL {cfg} {dtype}")
    assert_fields(_host(tlk.cloudsc2_tl_cuda(s, dt, c)), _host(cloudsc2_tl(s, dt, c)),
                  nl_tolerances(*TL_TOL[dtype], c, np_dtype, perturbations=True), f"TL {cfg} {dtype}")
    s, dt = _ad_state(1000, dtype, c, cuda)
    got = _host(adk.cloudsc2_ad_cuda(s, dt, c))
    assert_ad(got, _host(cloudsc2_ad(s, dt, c)), dtype, f"AD {cfg} {dtype}")
    fused = _host(adk.cloudsc2_ad_fused_cuda(s, dt, c))
    for k in got:
        np.testing.assert_array_equal(fused[k], got[k], err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ad_kernels_without_lphylin_on_card(cuda, dtype):
    """LPHYLIN=False: the two-kernel AD, ``cotangent_only`` and the fused AD
    (rolled and resident) bitwise their LPHYLIN=True launch."""
    c = CONFIGS["ldrain1d"]()
    off = c.replace(LPHYLIN=False)
    s, dt = _ad_state(1000, dtype, off, cuda)
    want = _host(adk.cloudsc2_ad_cuda(s, dt, c))
    runs = [adk.cloudsc2_ad_cuda(s, dt, off), adk.cloudsc2_ad_fused_cuda(s, dt, off),
            adk.cloudsc2_ad_fused_cuda(s, dt, off, resident=True), adk.cloudsc2_ad_cuda(s, dt, off, cotangent_only=True)]
    for i, out in enumerate(runs):
        got = _host(out)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"run {i} {k}")


def test_form_attributes_on_card(cuda):
    """In every form the reverse kernel fits the register file (no more
    than 255 registers a thread) and the card's pick of the fused block is
    the plan's."""
    for dtype in (torch.float32, torch.float64):
        forms = [("exact", False)] + ([("faithful", True), ("approx", True)] if dtype == torch.float32 else [])
        for mode, _ in forms:
            for compact in (True, False):
                c = CONFIGS["default"]().replace(FAST_DIV=mode, CUADJ_COMPACT=compact)
                div = ("exact", "faithful", "approx").index(mode)
                att = adk.reverse_attributes(dtype, False, True, div, compact)
                assert 0 < att["registers"] <= 255, (mode, compact, att)
                occ = adk.fused_occupancy(dtype, c, False, 137)
                block, nbytes, per_sm = adk.fused_plan(137, dtype, False, False)
                assert (occ["block"], occ["shared_bytes"], occ["blocks_per_sm"]) == (block, nbytes, per_sm), occ


@pytest.mark.parametrize("layout", ["global", "tile"])
def test_reader_kernel_bitwise_plain_on_card(cuda, layout):
    """The reader probe (``kernels/microbench.py``) bitwise its plain version:
    every stream count 1-32 (each a kernel of its own: S is a template
    value) at a ragged 4000 columns, 3 and 32 streams at 4096, 137 levels;
    its launch count grows."""
    from cloudsc2_tpu_torch.kernels import microbench as mb

    before = mb.reader_cuda.launches
    gen = torch.Generator(device=cuda).manual_seed(8)
    cases = [(s, 4000) for s in range(1, mb.MAX_STREAMS + 1)] + [(3, 4096), (32, 4096)]
    for nstreams, ncols in cases:
        big = torch.rand((nstreams, *mb.reader_shape(layout, 137, ncols)), generator=gen, device=cuda)
        parts = list(big.unbind(0))
        got, want = mb.reader_cuda(parts, 3.0, layout, ncols), mb.plain_reader(parts, 3.0, layout, ncols)
        assert torch.equal(got, want), (nstreams, ncols)
    assert mb.reader_cuda.launches == before + len(cases)


def test_chain_kernel_on_card(cuda):
    """The chain probe on the wide operand range: every variant bitwise its
    plain version given the card's approximate reciprocal (``rcp_cuda`` in
    ``approx`` mode; ``div`` and ``rcp`` are IEEE operations under
    ``--fmad=false``) at 0, 1, 5 and 37 steps, and at one warp a block; one
    step of each within its ulp bound of the float64 map
    (``drivers/microbench_div_torch.STEP_ULP_BOUND``), ``rcpx1`` and
    ``rcpx2`` apart from ``rcpx`` at some points; every variant after 64
    one-step launches within 1e-6 of the float64 chain (the map contracts
    errors by 0.445 a step)."""
    from cloudsc2_tpu_torch.kernels import microbench as mb
    from drivers.microbench_div_torch import STEP_ULP_BOUND, step_ulps, wide_operands

    def approx(b):
        return nlk.rcp_cuda(b, "approx")

    row = wide_operands(1, 4096, seed=8)[0]
    x = torch.from_numpy(row.reshape(8, 512)).to(cuda)
    one = {}
    for variant in mb.VARIANTS:
        for n in (0, 1, 5, 37):
            assert torch.equal(mb.chain_cuda(x, variant, n), mb.plain_chain(x, variant, n, approx)), (variant, n)
        assert torch.equal(mb.chain_cuda(x, variant, 5, block=32), mb.plain_chain(x, variant, 5, approx))
        one[variant] = mb.chain_cuda(x, variant, 1)
        assert step_ulps(x, one[variant]) <= STEP_ULP_BOUND[variant], variant
    for variant in ("rcpx1", "rcpx2"):
        assert not torch.equal(one[variant], one["rcpx"]), variant
    ref = row.astype(np.float64)
    for _ in range(64):
        ref = 1.25 / (ref + 1.0)
    for variant in mb.VARIANTS:
        v = x
        for _ in range(64):
            v = mb.chain_cuda(v, variant, 1)
        got = v.cpu().numpy().reshape(-1).astype(np.float64)
        assert float((np.abs(got - ref) / ref).max()) <= 1e-6, variant


def test_chain_records_sm_on_card(cuda):
    """The chain kernel writes the SM of each block where asked, and the
    same values without it: 132 blocks of one warp, each SM index below the
    card's count."""
    from cloudsc2_tpu_torch.kernels import microbench as mb

    x = torch.full((132, 32), 1.2345, device=cuda)
    sm = torch.full((132,), -1, dtype=torch.int32, device=cuda)
    got = mb.chain_cuda(x, "rcpx1", 16, block=32, sm=sm)
    assert torch.equal(got, mb.chain_cuda(x, "rcpx1", 16, block=32))
    count = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert int(sm.min()) >= 0 and int(sm.max()) < count, sm
    with pytest.raises(ValueError):
        mb.chain_cuda(x, "div", 1, block=32, sm=sm[:100])


