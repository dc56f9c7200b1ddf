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
chain; the chain kernel's record of its blocks' SMs.  The NL kernel's
pipelined scan bitwise its plain version where its ring of D slots wraps or
is never full (nlev 2, D, D + 1), and its occupancy entry: the ring's depth
and shared bytes, at least 4 blocks of 128 an SM, the float32 carveout
sized by its rule for 4 blocks at 65,536 columns and for 6 at 262,144,
where the fused outputs stay bitwise the plain ones.  The AD reverse kernel's
pipelined scan likewise bitwise the fused AD's direct reverse sweep at nlev
2, D and D + 1, its occupancy as its plan counts, and its refusal of an
output that overlaps an input.  The sharded forward step
on the card's mesh and on a hand-made mesh of 3 shards of it bitwise the
unsharded step.  The launch plans (``nonlinear.LaunchPlan``) and their
compiled launcher (``launcher/launcher.cpp``): with a warm plan the NL, TL and
AD reverse wrappers refuse what the first call refuses, with its error,
before any output is allocated and without a launch; configurations that
differ in one field the kernel reads, called in turns on warm plans, give
bitwise the outputs of a cold cache; each plan-backed form's outputs are
bitwise those of its C entry called through ctypes on the fields taken by
name.
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


def _state(ncols, dtype, c, device, seed=3, increment=False, nlev=137):
    _, st, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=seed)
    s = state_from_numpy(st, device, dtype)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    if increment:
        s.update(state_increment(s, 0.01))
    return s, dt


def _host(out):
    return flat({k: v.cpu() for k, v in d.items()} for d in out)


#: the NL kernel's forms, as options of cloudsc2_nl_cuda
NL_FORMS = {
    "unfused": {},
    "fused": {"fuse_saturation": True},
    "trajectory": {"with_trajectory": True},
    "traj_only": {"with_trajectory": True, "traj_only": True},
}


@pytest.mark.parametrize("form", list(NL_FORMS))
@pytest.mark.parametrize("at", ["2", "D", "D+1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pipelined_kernel_is_plain_at_the_rings_edges_on_card(cuda, form, at, dtype):
    """The kernel's ring (D levels in flight, the card's depth) at the
    depths where it wraps or is never full: nlev 2, D and D + 1, at a
    ragged 1000 columns, bitwise its plain version in each form."""
    c = CONFIGS["default"]()
    opts = NL_FORMS[form]
    depth = nlk.occupancy(dtype, c, ncols=1000, **opts)["depth"]
    nlev = {"2": 2, "D": max(depth, 2), "D+1": depth + 1}[at]
    _, st, dt = iox.synthesize_input(ncols=1000, nlev=nlev, seed=5)
    s = state_from_numpy(st, cuda, dtype)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    got = nlk.cloudsc2_nl_cuda(s, dt, c, **opts)
    plain = cloudsc2_nl(s, dt, c, **{k: v for k, v in opts.items() if k != "traj_only"})
    want = ({}, {}, plain[2]) if opts.get("traj_only") else plain
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), f"{form} {dtype} {nlev}x1000 {k}"


@pytest.mark.parametrize("ncols", [65_536, 262_144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nl_occupancy_keeps_the_grid_in_one_wave_on_card(cuda, dtype, ncols):
    """The occupancy entry at a launch of ``ncols`` columns: in every form
    the kernel takes the ring depth the host build reports, in shared
    memory in float32 ([slot][field][thread], 16 fields, 15 fused) and in
    registers in float64, after the level table of 137 values, and at least
    4 blocks of 128 fit an SM, so 65,536 columns (512 blocks on 132 SMs)
    run in one wave.  Float32 sizes its carveout by the rule
    (``nlk.carveout_blocks`` at the card's registers and SMs): for 4
    blocks at 65,536 columns, as before the rule, and at 262,144 (2,048
    blocks) for the 6 that the SM's memory holds with each block's ring in
    flight in L1, fewer than the registers allow, which the card then holds;
    float64 asks for none and holds what its registers allow at both
    sizes.  A fused launch counts in ``wide_launches`` where its carveout
    is sized for more than 4 blocks, and at 262,144 columns its float32
    outputs are bitwise its plain version's."""
    c = CONFIGS["default"]()
    depth = nlk.ring_depth(dtype)
    item = torch.empty((), dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for form, opts in NL_FORMS.items():
        o = nlk.occupancy(dtype, c, ncols=ncols, **opts)
        fields = 15 if opts.get("fuse_saturation") else 16
        shared = 137 * item + (depth * fields * 128 * 4 if dtype == torch.float32 else 0)
        assert (o["depth"], o["shared_bytes"]) == (depth, shared), (form, o)
        assert o["blocks_per_sm"] >= 4, (form, o)
        by_registers = adk.register_blocks(o["registers"], 128)
        if dtype == torch.float64:
            assert o["carveout_blocks"] == 0 and o["blocks_per_sm"] == by_registers, (form, o)
            assert o == nlk.occupancy(dtype, c, ncols=65_536, **opts), form
            continue
        in_flight = (depth - 1) * fields * 128 * 4
        want = nlk.carveout_blocks(by_registers, shared, in_flight, -(-ncols // 128), sms)
        assert o["carveout_blocks"] == want, (form, o, want)
        if ncols == 65_536:
            assert want == 4, (form, o)
        else:
            assert o["blocks_per_sm"] == want == 6 < by_registers, (form, o)
    s, dt = _state(ncols, dtype, c, cuda)
    before = nlk.cloudsc2_nl_cuda.launches, nlk.cloudsc2_nl_cuda.wide_launches
    got = nlk.cloudsc2_nl_cuda(s, dt, c, fuse_saturation=True)
    wide = dtype == torch.float32 and ncols == 262_144
    assert (nlk.cloudsc2_nl_cuda.launches, nlk.cloudsc2_nl_cuda.wide_launches) == (before[0] + 1, before[1] + wide)
    if wide:
        want = cloudsc2_nl(s, dt, c, fuse_saturation=True)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert torch.equal(g[k], w[k]), f"fused f32 {ncols}x137 {k}"


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


def _ad_state(ncols, dtype, c, device, nlev=137):
    s, dt = _state(ncols, dtype, c, device, nlev=nlev)
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


@pytest.mark.parametrize("ncols,nlev", [(1000, 137), (333, 137), (333, 2), (333, 3), (333, 200)])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ad_fused_kernel_on_card(cuda, ncols, nlev, cfg, dtype):
    """The fused kernel, rolled and resident, is bitwise the two-kernel AD
    and within ``ad_limit`` of the plain AD; one launch each; at 137
    levels, the shallowest columns the wrappers take, and 200 levels,
    deeper than the stack in shared memory held (f64 resident)."""
    c = CONFIGS[cfg]()
    s, dt = _ad_state(ncols, dtype, c, cuda, nlev)
    two = _host(adk.cloudsc2_ad_cuda(s, dt, c))
    want = _host(cloudsc2_ad(s, dt, c))
    for resident in (False, True):
        before = adk.cloudsc2_ad_fused_cuda.launches
        got = _host(adk.cloudsc2_ad_fused_cuda(s, dt, c, resident=resident))
        assert adk.cloudsc2_ad_fused_cuda.launches == before + 1
        label = f"{cfg} {dtype} {ncols}x{nlev} resident={resident}"
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
    and no local memory in the default instantiations; the card holds it
    as its plan counts (``reverse_occupancy`` raises otherwise): the ring
    depth the host build reports, its shared bytes, and the blocks per SM
    that the registers and the rings leave; in f32 the 4 blocks of 128 that
    65,536 columns need to run in one wave."""
    for dtype in (torch.float32, torch.float64):
        for cfg in CONFIGS:
            c = CONFIGS[cfg]()
            occ = adk.reverse_occupancy(dtype, c)
            evap = bool(c.LEVAPLS2 or c.LDRAIN1D)
            assert 0 < occ["registers"] <= 255, occ
            assert occ["depth"] == adk.reverse_ring_depth(dtype), occ
            plan = adk.reverse_plan(dtype, evap, occ["registers"], occ["depth"])
            assert (occ["blocks_per_sm"], occ["shared_bytes"]) == (plan["blocks_per_sm"], plan["shared_bytes"])
            if dtype == torch.float32:
                assert occ["blocks_per_sm"] == 4, (cfg, occ)
            if not evap:
                assert occ["local_bytes"] == 0, (cfg, occ)


@pytest.mark.parametrize("at", ["2", "D", "D+1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ad_reverse_kernel_at_the_rings_edges_on_card(cuda, at, dtype):
    """The reverse kernel's ring (D levels in flight, the card's depth) at
    the depths where it wraps or is never full: nlev 2, D and D + 1, at a
    ragged 1000 columns, bitwise the fused rolled AD (whose reverse sweep
    is the direct scan of the same level), with and without evaporation;
    one reverse launch each."""
    depth = adk.reverse_occupancy(dtype, CONFIGS["default"]())["depth"]
    nlev = {"2": 2, "D": max(depth, 2), "D+1": depth + 1}[at]
    for cfg in ("default", "levapls2"):
        c = CONFIGS[cfg]()
        s, dt = _ad_state(1000, dtype, c, cuda, nlev)
        before = adk.cloudsc2_ad_cuda.launches
        got = _host(adk.cloudsc2_ad_cuda(s, dt, c))
        assert adk.cloudsc2_ad_cuda.launches == before + 1
        want = _host(adk.cloudsc2_ad_fused_cuda(s, dt, c))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{cfg} {dtype} {nlev}x1000 {k}")


def test_ad_reverse_kernel_refuses_an_overlapping_output_on_card(cuda):
    """The reverse kernel reads the next levels up ahead of its stores, so
    its wrapper refuses an output that overlaps an input (the first output
    allocated as the state's ``t``) before it launches."""
    c = CONFIGS["default"]()
    s, dt = _ad_state(256, torch.float32, c, cuda)
    traj = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True, traj_only=True)[2]
    t0 = s["t"].clone()
    overlapping = nlk.allocated_by(lambda shape, dtype, device: (
        s["t"] if tuple(shape) == tuple(s["t"].shape) else torch.empty(shape, dtype=dtype, device=device)))
    before = adk.cloudsc2_ad_cuda.launches
    with overlapping, pytest.raises(ValueError, match="overlaps input 't'"):
        adk.cloudsc2_ad_reverse_cuda(s, traj, dt, c)
    assert adk.cloudsc2_ad_cuda.launches == before
    assert torch.equal(s["t"], t0)


def test_ad_fused_occupancy_on_card(cuda):
    """The card holds the fused kernel as the plan counts at its registers
    (``fused_occupancy`` raises otherwise), rolled and resident, every
    switch triple: registers, not shared memory (the forward sweep's ring,
    24 KB a block in f32), set its blocks per SM; in the default switches
    512 threads an SM in f32 (128 registers) and 256 in f64, without local
    memory."""
    for dtype in (torch.float32, torch.float64):
        for cfg in CONFIGS:
            for lregcl in (True, False):
                for resident in (False, True):
                    c = CONFIGS[cfg]().replace(LREGCL=lregcl)
                    occ = adk.fused_occupancy(dtype, c, resident, 137)
                    evap = bool(c.LEVAPLS2 or c.LDRAIN1D)
                    plan = adk.fused_plan(137, 1, dtype, evap, resident, occ["registers"])
                    assert (occ["blocks_per_sm"], occ["shared_bytes"]) == (plan["blocks_per_sm"], plan["shared_bytes"])
                    assert occ["blocks_per_sm"] == adk.register_blocks(occ["registers"], 128), occ
                    assert 0 < occ["registers"] <= 255, occ
                    if not evap:
                        want = 512 if dtype == torch.float32 else 256
                        assert occ["threads_per_sm"] == want and occ["local_bytes"] == 0, (cfg, lregcl, occ)


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
    than 255 registers a thread), without local memory in the default form,
    and the card holds it (``reverse_occupancy``) and the fused kernel as
    their plans count at their registers."""
    for dtype in (torch.float32, torch.float64):
        forms = [("exact", False)] + ([("faithful", True), ("approx", True)] if dtype == torch.float32 else [])
        for mode, _ in forms:
            for compact in (True, False):
                c = CONFIGS["default"]().replace(FAST_DIV=mode, CUADJ_COMPACT=compact)
                rev = adk.reverse_occupancy(dtype, c)
                assert 0 < rev["registers"] <= 255, (mode, compact, rev)
                assert rev["depth"] == adk.reverse_ring_depth(dtype), rev
                if mode == "exact" and compact:
                    assert rev["local_bytes"] == 0, rev
                occ = adk.fused_occupancy(dtype, c, False, 137)
                plan = adk.fused_plan(137, 1, dtype, False, False, occ["registers"])
                assert (occ["blocks_per_sm"], occ["shared_bytes"]) == (plan["blocks_per_sm"], plan["shared_bytes"])
                assert occ["blocks_per_sm"] == adk.register_blocks(occ["registers"], 128), occ


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




def test_stream_refuses_pageable_ring_on_card(cuda):
    """A ring that is not pinned is refused before any copy or launch: a copy
    from pageable memory runs synchronously."""
    from cloudsc2_tpu_torch.parallel import stream

    _, st, dt = iox.synthesize_input(ncols=64, nlev=137, seed=3, dtype=np.float32)
    ring = stream.host_ring(stream.build_ring(st, 4096, 2), pin=False)
    before = nlk.cloudsc2_nl_cuda.launches
    with pytest.raises(ValueError, match="pageable"):
        stream.sweep_ring(ring, dt, CONFIGS["default"](), nchunks=3, device=cuda)
    assert nlk.cloudsc2_nl_cuda.launches == before


@pytest.mark.parametrize("outputs", [False, True], ids=["half", "full"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stream_bitwise_one_shot_on_card(cuda, dtype, outputs):
    """Three chunks of 4096 columns over a pinned ring of 2 slots: the
    checksum is bitwise the chunk-order sum of the one-shot outputs of slot
    ``i % 2`` on device-resident copies (``torch.sum`` / ``torch.stack`` in
    half duplex, numpy's sums of the host copies in full duplex), chunk 0's
    sample bitwise slot 0's one-shot output, and the NL kernel launched once
    a chunk and once to warm up."""
    from cloudsc2_tpu_torch.parallel import stream
    from cloudsc2_tpu_torch.parallel.step import forward_step

    _, st, dt = iox.synthesize_input(ncols=100, nlev=137, seed=3, dtype=dtype)
    c = CONFIGS["default"]()
    ring = stream.host_ring(stream.build_ring(st, 4096, 2), pin=True)
    assert all(slot.flat.is_pinned() for slot in ring)
    slots = [{k: v.to(cuda) for k, v in slot.fields.items()} for slot in ring]
    eta = eta_levels(slots[0]["ap"], slots[0]["aph"])
    one = [forward_step(dict(s, eta=eta), dt, c) for s in slots]
    before = nlk.cloudsc2_nl_cuda.launches
    stats, (tends, diags) = stream.sweep_ring(ring, dt, c, nchunks=3, device=cuda, stream_outputs=outputs)
    assert nlk.cloudsc2_nl_cuda.launches - before == 4
    if outputs:
        want = 0.0
        for i in range(3):
            want += float(one[i % 2][0]["t"].cpu().numpy().sum())
    else:
        want = float(torch.sum(torch.stack([torch.sum(one[i % 2][0]["t"]) for i in range(3)])))
    assert stats["checksum"] == want
    ref = {**one[0][0], **one[0][1]}
    for k, v in {**tends, **diags}.items():
        assert torch.equal(v.cpu(), ref[k].cpu()), k


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_full_step_norms_bitwise_symmetry_on_card(cuda, dtype):
    """``full_step`` on CUDA tensors launches the TL and AD kernels, and its
    per-column norms are bitwise the symmetry protocol's on the same state."""
    from cloudsc2_tpu_torch.parallel.step import full_step
    from cloudsc2_tpu_torch.validation.symmetry import SymmetryTest

    c = CONFIGS["default"]()
    s, dt = _state(1000, dtype, c, cuda)
    before = (tlk.cloudsc2_tl_cuda.launches, adk.cloudsc2_ad_cuda.launches)
    _, norm1, norm2 = full_step(s, dt, c)
    assert (tlk.cloudsc2_tl_cuda.launches, adk.cloudsc2_ad_cuda.launches) == (before[0] + 1, before[1] + 1)
    ref1, ref2 = SymmetryTest(constants=c).run(s, dt)
    np.testing.assert_array_equal(norm1.cpu().numpy(), ref1)
    np.testing.assert_array_equal(norm2.cpu().numpy(), ref2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_forward_step_bitwise_on_card(cuda, dtype):
    """The sharded forward step on the card's mesh, and on a hand-made mesh
    of 3 shards of the one card, is bitwise the unsharded fused step, one
    NL launch a shard; a mesh of more cards than the machine has raises."""
    from cloudsc2_tpu_torch.parallel import mesh
    from cloudsc2_tpu_torch.parallel.step import forward_step, make_sharded_forward_step

    c = CONFIGS["default"]()
    s, dt = _state(1152, dtype, c, cuda)
    s.pop("qsat")
    want = {k: v for d in forward_step(s, dt, c) for k, v in d.items()}
    card = mesh.column_mesh(device="cuda")
    assert card.shape == (1, torch.cuda.device_count())
    with pytest.raises(ValueError, match="card"):
        mesh.column_mesh(torch.cuda.device_count() + 1, device="cuda")
    for m in (mesh.column_mesh(1, device="cuda"), mesh.ColumnMesh((1, 3), 0, 1, (cuda,) * 3)):
        before = nlk.cloudsc2_nl_cuda.launches
        got = {k: v for d in make_sharded_forward_step(m, dt=dt, c=c)(s) for k, v in d.items()}
        assert nlk.cloudsc2_nl_cuda.launches == before + len(m.devices)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(mesh.gather_columns(got[k]), v), k


# ---- the launch plans (nonlinear.LaunchPlan)


PLAN_CACHES = (nlk._nl_plan, adk._reverse_plan, tlk._tl_plan)


def _clear_plans():
    for cache in PLAN_CACHES:
        cache.cache_clear()


def _plan_counts():
    """``(builds, hits)`` of the NL, reverse and TL plans together."""
    infos = [cache.cache_info() for cache in PLAN_CACHES]
    return sum(i.misses for i in infos), sum(i.hits for i in infos)


def _launch_counts():
    return nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches, tlk.cloudsc2_tl_cuda.launches


def _non_contiguous(t):
    bad = torch.empty(tuple(reversed(t.shape)), dtype=t.dtype, device=t.device).t()
    bad.copy_(t)
    return bad


PLAN_FAULTS = {
    "shape": lambda s, n: s.__setitem__(n, s[n][:, :-1].contiguous()),
    "dtype": lambda s, n: s.__setitem__(n, s[n].double()),
    "device": lambda s, n: s.__setitem__(n, s[n].cpu()),
    "non-contiguous": lambda s, n: s.__setitem__(n, _non_contiguous(s[n])),
    "missing": lambda s, n: s.__delitem__(n),
}


@pytest.mark.parametrize("target", ["nl fused", "ad reverse", "tl tangent_only"])
@pytest.mark.parametrize("fault", list(PLAN_FAULTS))
def test_warm_plan_refuses_what_the_first_call_refuses_on_card(cuda, fault, target):
    """A fault refused from a cold cache is refused with a warm plan too,
    with the same error, before any output is allocated, and nothing
    launches; the cold call builds the plan of its (sound) ``ap``'s layout,
    the warm one builds none."""
    c = CONFIGS["default"]()
    s, dt = _ad_state(256, torch.float32, c, cuda)
    traj = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True, traj_only=True)[2]
    if target == "nl fused":
        field, call = "q", lambda x: nlk.cloudsc2_nl_cuda(x, dt, c, fuse_saturation=True)
    elif target == "ad reverse":
        field, call = "clc_i", lambda x: adk.cloudsc2_ad_reverse_cuda(x, traj, dt, c)
    else:
        field, call = "q_i", lambda x: tlk.cloudsc2_tl_cuda(x, dt, c, tangent_only=True)
    bad = dict(s)
    PLAN_FAULTS[fault](bad, field)
    _clear_plans()
    launches = _launch_counts()
    allocs = []

    def counting():
        return nlk.allocated_by(lambda shape, dtype, device: allocs.append(shape) or torch.empty(
            shape, dtype=dtype, device=device))

    with counting(), pytest.raises(Exception) as cold:
        call(bad)
    assert _plan_counts() == (1, 0)
    call(s)  # the plan, warm
    builds, hits = _plan_counts()
    with counting(), pytest.raises(Exception) as warm:
        call(bad)
    assert _plan_counts() == (builds, hits + 1)
    assert allocs == []
    assert (type(warm.value), str(warm.value)) == (type(cold.value), str(cold.value))
    assert sum(_launch_counts()) - sum(launches) == 1  # the warm-up call alone


@pytest.mark.parametrize("target", ["nl", "ad reverse"])
def test_warm_plan_refuses_an_overlapping_output_on_card(cuda, target):
    """With the plan warm, an output allocated as the state's ``t`` is
    refused before anything launches."""
    c = CONFIGS["default"]()
    s, dt = _ad_state(256, torch.float32, c, cuda)
    traj = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True, traj_only=True)[2]
    call = ((lambda: nlk.cloudsc2_nl_cuda(s, dt, c)) if target == "nl"
            else (lambda: adk.cloudsc2_ad_reverse_cuda(s, traj, dt, c)))
    call()
    t0 = s["t"].clone()
    overlapping = nlk.allocated_by(lambda shape, dtype, device: (
        s["t"] if tuple(shape) == tuple(s["t"].shape) else torch.empty(shape, dtype=dtype, device=device)))
    before = (nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches)
    with overlapping, pytest.raises(ValueError, match="overlaps input 't'"):
        call()
    assert (nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches) == before
    assert torch.equal(s["t"], t0)


def _per_call(entry, state, dt, c, **opts):
    """A launch as the wrappers marshalled it before the compiled launch
    path: the fields taken by name, fresh outputs, the constant struct
    folded, the CUDA library's C entry called through ctypes on the current
    stream.  The outputs by name."""
    from cloudsc2_tpu_torch.physics.nonlinear import trajectory_names
    from cloudsc2_tpu_torch.state import kernel_constants, tl_kernel_constants

    nlev, ncols = state["ap"].shape
    dtype = state["ap"].dtype
    if entry == "nl":
        fused, traj = opts.get("fuse_saturation", False), opts.get("with_trajectory", False)
        ins = [None if n is None else state[n] for n in (nlk._FUSED_INPUTS if fused else nlk.NL_INPUTS)]
        written = nlk.STEP_OUTPUTS + (trajectory_names(c) if traj else ()) + (("qsat_out",) if fused else ())
        outputs, iface = nlk.NL_OUTPUTS, nlk._IFACE
        consts = kernel_constants(c, dt, dtype, 1)
        switches = nlk.launch_switches(c, dtype, traj, False, fused)
        fn = nlk.load_cuda(c.CUADJ_COMPACT).cloudsc2_nl_launch
    elif entry == "tl":
        ins = [state[n] for n in tlk.TL_INPUTS]
        tangent_only = opts.get("tangent_only", False)
        outputs, iface = tlk.TL_OUTPUTS, tlk._IFACE
        written = tuple(n for n in outputs if not tangent_only or n.endswith("_i"))
        consts = tl_kernel_constants(c, dt, dtype)
        switches = tlk.tl_switches(c, dtype, tangent_only)
        fn = tlk.load_cuda(c.CUADJ_COMPACT, switches[4] != 0).cloudsc2_tl_launch
    else:
        merged = {**state, **opts["traj"]}
        ins = [None if n is None else merged[n] for n in adk._read(adk.AD_INPUTS, False)]
        outputs = written = adk.AD_OUTPUTS
        iface = adk._IFACE
        consts = tl_kernel_constants(c, dt, dtype)
        switches = adk.reverse_switches(dtype, c)
        fn = adk.load_cuda(c.CUADJ_COMPACT, switches[-2] != 0).cloudsc2_ad_launch
    outs = {n: torch.empty((nlev + 1, ncols) if n in iface else (nlev, ncols), dtype=dtype, device=state["ap"].device)
            if n in written else None for n in outputs}
    consts = torch.from_numpy(consts)
    err = fn(*switches, nlk.ptrs(ins), nlk.ptrs(list(outs.values())), consts.data_ptr(), nlev, ncols,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    return {n: v for n, v in outs.items() if v is not None}


COMPILED_FORMS = {
    "nl fused": ("nl", {"fuse_saturation": True}),
    "nl unfused": ("nl", {}),
    "nl with_trajectory": ("nl", {"with_trajectory": True}),
    "tl": ("tl", {}),
    "tl tangent_only": ("tl", {"tangent_only": True}),
    "ad reverse": ("ad", {}),
}


def _compiled(entry, s, dt, c, **opts):
    """The same launch through the wrapper's compiled path, by name."""
    if entry == "nl":
        out = nlk.cloudsc2_nl_cuda(s, dt, c, **opts)
        named = {"tnd_" + k: v for k, v in out[0].items()}
        named.update({("qsat_out" if k == "qsat" else k): v for k, v in out[1].items()})
        if len(out) == 3:
            named.update(out[2])
        return named
    if entry == "tl":
        tends, diags = tlk.cloudsc2_tl_cuda(s, dt, c, **opts)
        return {**{"tnd_" + k: v for k, v in tends.items()}, **diags}
    return adk.cloudsc2_ad_reverse_cuda(s, opts["traj"], dt, c)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("form", list(COMPILED_FORMS))
def test_compiled_launch_path_is_the_per_call_marshalling_on_card(cuda, form, dtype):
    """Each plan-backed launch through the compiled launcher gives bitwise
    the outputs of the same C entry called through ctypes on the fields
    taken by name."""
    entry, opts = COMPILED_FORMS[form]
    c = CONFIGS["default"]()
    s, dt = _ad_state(1000, dtype, c, cuda)
    if entry == "ad":
        opts = {"traj": nlk.cloudsc2_nl_cuda(s, dt, adk.forward_constants(c), with_trajectory=True,
                                             traj_only=True)[2]}
    got = _compiled(entry, s, dt, c, **opts)
    torch.cuda.synchronize()
    want = _per_call(entry, s, dt, c, **opts)
    assert sorted(got) == sorted(want), form
    for k in want:
        assert torch.equal(got[k], want[k]), f"{form} {dtype} {k}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_alternating_forms_on_warm_plans_match_a_cold_cache_on_card(cuda, dtype):
    """The fused NL step and the ``cotangent_only`` AD step under
    configurations that differ in one field the kernel reads (LEVAPLS2,
    dt, FAST_DIV), called in turns on warm plans: each bitwise its cold
    cache's outputs."""
    c = CONFIGS["default"]()
    s, dt = _ad_state(1000, dtype, c, cuda)
    bare = {k: v for k, v in s.items() if k != "qsat"}
    configs = [(c, dt), (c.replace(LEVAPLS2=True), dt), (c, dt * 0.5), (c.replace(FAST_DIV="faithful"), dt)]
    steps = [lambda cf, d: nlk.cloudsc2_nl_cuda(bare, d, cf, fuse_saturation=True),
             lambda cf, d: adk.cloudsc2_ad_cuda(s, d, cf, cotangent_only=True)]
    cold = []
    for step in steps:
        for cf, d in configs:
            _clear_plans()
            cold.append(_host(step(cf, d)))
    _clear_plans()
    for turn in range(2):
        for i, (step, (cf, d)) in enumerate((st, cd) for st in steps for cd in configs):
            got = _host(step(cf, d))
            assert got.keys() == cold[i].keys()
            for k in got:
                np.testing.assert_array_equal(got[k], cold[i][k], err_msg=f"{dtype} case {i} turn {turn} {k}")
    assert _plan_counts()[1] > 0

