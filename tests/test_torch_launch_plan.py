# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The launch plans of the NL, TL, two-kernel AD and fused AD wrappers
(``kernels/nonlinear.py`` ``LaunchPlan``, ``_nl_plan``;
``kernels/tangent_linear.py`` ``_tl_plan``; ``kernels/adjoint.py``
``_reverse_plan``, ``_fused_plan``) and their compiled launcher
(``launcher/launcher.cpp``), through the host builds on the CPU, which take
the same plans and the same launcher as the card's wrappers.

- A warm plan is reused: the caches count one build and then hits, and
  the constant structs are not folded again.
- Constants that differ in one field the kernel reads (``LEVAPLS2``,
  ``dt``, ``FAST_DIV``), alternated between calls, give outputs bitwise
  those of a cold cache: no plan goes stale.  The TL plan's key carries
  ``tangent_only`` and ``dt``'s type.
- Each cache keeps at most its bound, dropping the least recently used.
- Every refusal of the first call still fires with a warm plan, with the
  first call's own error and before any output (or the fused AD's
  scratch) is allocated (the launcher's allocation seam,
  ``nonlinear.allocated_by``, counts none): a
  field of the wrong shape, dtype or device, a non-contiguous field, a
  missing field; and an output that overlaps an input (the seam hands out
  an input's storage).
- The NL, TL and AD outputs are bitwise those of the per-call marshalling
  the plans replace (the fields taken by name, fresh outputs, the constant
  struct folded, the host entry called directly through ctypes), in every
  form.
- The launcher's overlap sweep refuses exactly what the pairwise rule
  refuses, naming the same pair; a ``dt`` that hashes by identity keeps no
  plan.
"""
import functools

import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
from cloudsc2_tpu_torch.params import make_constants
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.nonlinear import trajectory_names
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.state import kernel_constants, state_from_numpy, tl_kernel_constants

torch.set_num_threads(1)

NLEV, NCOLS = 137, 12
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
SEEDS = adk.AD_SEEDS


CACHES = (nlk._nl_plan, adk._reverse_plan, tlk._tl_plan, adk._fused_plan)


def _clear():
    for cache in CACHES:
        cache.cache_clear()


def _counts():
    """``(builds, hits, plans kept)`` of every cache together."""
    infos = [cache.cache_info() for cache in CACHES]
    return sum(i.misses for i in infos), sum(i.hits for i in infos), sum(i.currsize for i in infos)


@pytest.fixture(autouse=True)
def _cold_cache():
    _clear()
    yield
    _clear()


@functools.lru_cache(maxsize=None)
def _state_np(dtype):
    np_dtype = DTYPES[dtype][0]
    _, state, dt = iox.synthesize_input(ncols=NCOLS, nlev=NLEV, seed=5, dtype=np_dtype)
    rng = np.random.default_rng(5)
    for n in SEEDS:
        rows = NLEV + 1 if n[:4] in ("fpls", "fhps") else NLEV
        state[n] = rng.standard_normal((rows, NCOLS)).astype(np_dtype)
    return state, dt


def _state(dtype):
    """A fresh state dict (new tensors) with eta, qsat, the AD's seeds and
    the TL's perturbations (a hundredth of each field)."""
    state, dt = _state_np(dtype)
    s = state_from_numpy(state, torch.device("cpu"), DTYPES[dtype][1])
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=True, c=make_constants())
    for n in tlk.TL_INPUTS:
        if n.endswith("_i"):
            s[n] = 0.01 * s[n[:-2]]
    return s, dt


def _flat(out):
    return {f"{i}.{k}": v for i, d in enumerate(out) for k, v in d.items()}


def _assert_bitwise(got, want, label):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), label
    for k in want:
        assert torch.equal(got[k], want[k]), f"{label} {k}"


def _nl(s, dt, c, **opts):
    return nlk.cloudsc2_nl_host(s, dt, c, **opts)


def _ad(s, dt, c, **opts):
    return adk.cloudsc2_ad_host(s, dt, c, **opts)


def _tl(s, dt, c, **opts):
    return tlk.cloudsc2_tl_host(s, dt, c, **opts)


def _ad_fused(s, dt, c, **opts):
    return adk.cloudsc2_ad_fused_host(s, dt, c, **opts)


CALLS = {"nl": _nl, "ad": _ad, "tl": _tl, "ad fused": _ad_fused}


# ---- reuse


@pytest.mark.parametrize("kind, builds", [("nl", 1), ("ad", 2), ("tl", 1), ("ad fused", 1)])
def test_a_warm_plan_is_reused(kind, builds, monkeypatch):
    """The second call finds its plans (one for the NL, the TL and the fused
    AD, two for the AD's two launches): the cache counts no new build, and
    each constant struct is folded once, at the first call (the fused AD's
    plan folds two, the NL's and the TL's)."""
    folds = []
    for mod, name in ((nlk, "kernel_constants"), (adk, "kernel_constants"), (adk, "tl_kernel_constants"),
                      (tlk, "tl_kernel_constants")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, **k: folds.append(1) or real(*a, **k))
    s, dt = _state("f32")
    c = make_constants()
    call = CALLS[kind]
    structs = 2 if kind == "ad fused" else 1
    first = call(s, dt, c)
    assert (*_counts()[:2], len(folds)) == (builds, 0, builds * structs)
    second = call(s, dt, c)
    assert (*_counts()[:2], len(folds)) == (builds, builds, builds * structs)
    _assert_bitwise(second, first, kind)


# ---- no stale plan


ALTERNATIONS = {
    "LEVAPLS2": lambda c, dt: ((c, dt), (c.replace(LEVAPLS2=True), dt)),
    "dt": lambda c, dt: ((c, dt), (c, dt * 0.5)),
    "FAST_DIV": lambda c, dt: ((c, dt), (c.replace(FAST_DIV="faithful"), dt)),
}


@pytest.mark.parametrize("kind", ["nl", "nl fused", "ad", "cotangent_only", "tl", "tangent_only"])
@pytest.mark.parametrize("field", list(ALTERNATIONS))
def test_alternating_constants_match_a_cold_cache(kind, field):
    """Two configurations that differ in one field the kernel reads,
    called in turns on warm plans, each give bitwise what it gives from a
    cold cache."""
    s, dt0 = _state("f32")
    pair = ALTERNATIONS[field](make_constants(), dt0)
    opts = {"nl fused": {"fuse_saturation": True}, "cotangent_only": {"cotangent_only": True},
            "tangent_only": {"tangent_only": True}}.get(kind, {})
    call = {"ad": _ad, "cotangent_only": _ad, "tl": _tl, "tangent_only": _tl}.get(kind, _nl)
    cold = []
    for c, dt in pair:
        _clear()
        cold.append(call(s, dt, c, **opts))
    _clear()
    for turn in range(4):
        c, dt = pair[turn % 2]
        _assert_bitwise(call(s, dt, c, **opts), cold[turn % 2], f"{kind} {field} turn {turn}")
    assert _counts()[1] > 0


# ---- the bound


def test_plan_cache_keeps_its_bound_least_recently_used_out():
    """70 NL configurations (70 values of dt) leave 64 plans: the six
    oldest are dropped and built again at their next use; a plan used
    since it was built is kept."""
    c = make_constants()
    dts = [1800.0 * (1 + i / 100) for i in range(70)]

    def plan_for(dt):
        return nlk._nl_plan("cloudsc2_nl_host", torch.float32, (NLEV, NCOLS), c, dt, False, False, False, 1)

    first = [plan_for(dt) for dt in dts[:4]]
    for dt in dts[4:64]:
        plan_for(dt)
    assert plan_for(dts[0]) is first[0]  # dts[0] is now the most recent
    for dt in dts[64:]:
        plan_for(dt)
    info = nlk._nl_plan.cache_info()
    assert (info.currsize, info.maxsize, info.misses, info.hits) == (64, 64, 70, 1)
    assert plan_for(dts[0]) is first[0]
    assert plan_for(dts[1]) is not first[1]
    assert nlk._nl_plan.cache_info().misses == 71


def test_the_process_cache_stays_within_its_bound():
    """70 configurations through the NL, AD, TL and fused AD wrappers' host
    builds leave 64 plans of each kernel."""
    s, dt = _state("f32")
    c = make_constants()
    traj = _nl(s, dt, c, with_trajectory=True, traj_only=True)[2]
    for i in range(70):
        adk.cloudsc2_ad_reverse_host(s, traj, dt * (1 + i / 100), c)
    for i in range(70):
        _nl(s, dt * (1 + i / 100), c)
    for i in range(70):
        _tl(s, dt * (1 + i / 100), c, tangent_only=True)
    for i in range(70):
        _ad_fused(s, dt * (1 + i / 100), c)
    for cache in CACHES:
        info = cache.cache_info()
        assert (info.currsize, info.maxsize) == (64, 64), cache
    assert _counts()[0] == 281  # the trajectory's plan, then 70 of each


# ---- refusals on a warm plan


def _non_contiguous(t):
    bad = torch.empty(tuple(reversed(t.shape)), dtype=t.dtype).t()
    bad.copy_(t)
    return bad


FAULTS = {
    "shape": lambda s, n: s.__setitem__(n, s[n][:, :-1].contiguous()),
    "dtype": lambda s, n: s.__setitem__(n, s[n].double()),
    "device": lambda s, n: s.__setitem__(n, torch.empty_like(s[n], device="meta")),
    "non-contiguous": lambda s, n: s.__setitem__(n, _non_contiguous(s[n])),
    "missing": lambda s, n: s.__delitem__(n),
}
#: the wrapper and the field a fault is put in: the NL step reads ``t``,
#: the reverse kernel and the fused AD also a seed, the TL the perturbations
TARGETS = {
    "nl": (lambda s, dt, c, traj: _nl(s, dt, c), "t"),
    "nl fused": (lambda s, dt, c, traj: _nl(s, dt, c, fuse_saturation=True), "q"),
    "ad reverse": (lambda s, dt, c, traj: adk.cloudsc2_ad_reverse_host(s, traj, dt, c), "clc_i"),
    "tl": (lambda s, dt, c, traj: _tl(s, dt, c), "q_i"),
    "tl tangent_only": (lambda s, dt, c, traj: _tl(s, dt, c, tangent_only=True), "t"),
    "ad fused": (lambda s, dt, c, traj: _ad_fused(s, dt, c), "fplsl_i"),
}


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def _counting(allocs):
    """An allocation seam that records each output's shape and hands out
    fresh storage."""
    return lambda shape, dtype, device: allocs.append(tuple(shape)) or torch.empty(shape, dtype=dtype,
                                                                                   device=device)


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_warm_plan_refuses_what_the_first_call_refuses(target, fault):
    """The fault refused from a cold cache is refused with a warm plan too,
    with the same error, and neither call allocates an output (nor the
    fused AD's scratch): the launcher checks the state before it
    allocates.  The plan is looked up
    by the state's ``ap``, which is sound, so the cold call builds the
    plan of its layout and the warm one finds it, building none."""
    call, field = TARGETS[target]
    c = make_constants()
    s, dt = _state("f32")
    traj = _nl(s, dt, c, with_trajectory=True, traj_only=True)[2]
    bad = dict(s)
    FAULTS[fault](bad, field)
    _clear()
    allocs = []
    with nlk.allocated_by(_counting(allocs)):
        cold = _error(lambda: call(bad, dt, c, traj))
    assert _counts() == (1, 0, 1)
    call(s, dt, c, traj)  # the plan, warm
    builds, hits, kept = _counts()
    with nlk.allocated_by(_counting(allocs)):
        warm = _error(lambda: call(bad, dt, c, traj))
    assert _counts() == (builds, hits + 1, kept), "the faulty call built a plan"
    assert allocs == [], "an output was allocated before the refusal"
    assert warm == cold


@pytest.mark.parametrize("target", ["nl", "ad reverse", "tl", "ad fused"])
def test_a_warm_plan_refuses_an_output_that_overlaps_an_input(target):
    """With the plan warm, an output allocated as the state's ``t`` itself
    is refused before anything runs, as at the first call."""
    c = make_constants()
    s, dt = _state("f32")
    traj = _nl(s, dt, c, with_trajectory=True, traj_only=True)[2]
    call = TARGETS[target][0]
    call(s, dt, c, traj)
    hits = _counts()[1]
    t0 = s["t"].clone()
    with nlk.allocated_by(lambda shape, dtype, device: (
            s["t"] if tuple(shape) == tuple(s["t"].shape) else torch.empty(shape, dtype=dtype, device=device))):
        with pytest.raises(ValueError, match="overlaps input 't'"):
            call(s, dt, c, traj)
    assert _counts()[1] == hits + 1
    assert torch.equal(s["t"], t0)


# ---- bitwise the per-call marshalling


def _fields(s, names):
    """The fields named, in order (``None`` for a name that is ``None``),
    and the state's dtype."""
    return [None if n is None else s[n] for n in names], s["ap"].dtype


def _per_call_nl(s, dt, c, with_trajectory=False, traj_only=False, fuse_saturation=False, kflag=1):
    """The NL step as the wrappers marshalled it on every call before the
    plans: the fields taken by name, fresh outputs, the constant struct
    folded, the host entry called on the pointers."""
    ins, dtype = _fields(s, nlk._FUSED_INPUTS if fuse_saturation else nlk.NL_INPUTS)
    written = trajectory_names(c) if with_trajectory else ()
    if not traj_only:
        written = nlk.STEP_OUTPUTS + written + (("qsat_out",) if fuse_saturation else ())
    nlev, ncols = s["ap"].shape
    outs = {n: torch.empty((nlev + 1, ncols) if n in nlk._IFACE else (nlev, ncols), dtype=dtype)
            if n in written else None for n in nlk.NL_OUTPUTS}
    consts = torch.from_numpy(kernel_constants(c, dt, dtype, kflag))
    switches = nlk.launch_switches(c, dtype, with_trajectory, traj_only, fuse_saturation)
    err = nlk._load("host", c.CUADJ_COMPACT).cloudsc2_nl_host(
        *switches, nlk.ptrs(ins), nlk.ptrs(list(outs.values())), consts.data_ptr(), nlev, ncols)
    assert err == 0
    return nlk._assemble(outs, with_trajectory, traj_only)


def _per_call_ad(s, dt, c, cotangent_only=False):
    tends, diags, traj = _per_call_nl(s, dt, adk.forward_constants(c), True, cotangent_only)
    ins, dtype = _fields({**s, **traj}, adk._read(adk.AD_INPUTS, bool(c.LEVAPLS2 or c.LDRAIN1D)))
    nlev, ncols = s["ap"].shape
    outs = [torch.empty((nlev + 1, ncols) if n in adk._IFACE else (nlev, ncols), dtype=dtype)
            for n in adk.AD_OUTPUTS]
    consts = torch.from_numpy(tl_kernel_constants(c, dt, dtype))
    switches = adk.reverse_switches(dtype, c)
    err = adk._form_lib("host", "ad", switches).cloudsc2_ad_host(
        *switches, nlk.ptrs(ins), nlk.ptrs(outs), consts.data_ptr(),
        nlev, ncols)
    assert err == 0
    return adk._assemble(tends, diags, dict(zip(adk.AD_OUTPUTS, outs)))


def _per_call_tl(s, dt, c, tangent_only=False):
    """The TL step as its wrapper marshalled it on every call before its
    plan: the fields taken by name, fresh outputs, the constant struct
    folded, the host entry called on the pointers."""
    ins, dtype = _fields(s, tlk.TL_INPUTS)
    nlev, ncols = s["ap"].shape
    outs = [None if tangent_only and not n.endswith("_i") else torch.empty(
        (nlev + 1, ncols) if n in tlk._IFACE else (nlev, ncols), dtype=dtype) for n in tlk.TL_OUTPUTS]
    consts = torch.from_numpy(tl_kernel_constants(c, dt, dtype))
    switches = tlk.tl_switches(c, dtype, tangent_only)
    err = tlk._load("host", bool(c.CUADJ_COMPACT), switches[4] != 0).cloudsc2_tl_host(
        *switches, nlk.ptrs(ins), nlk.ptrs(outs), consts.data_ptr(), nlev, ncols)
    assert err == 0
    return tlk._assemble(dict(zip(tlk.TL_OUTPUTS, outs)))


NL_FORMS = {
    "unfused": {},
    "fused": {"fuse_saturation": True},
    "fused kflag 2": {"fuse_saturation": True, "kflag": 2},
    "with_trajectory": {"with_trajectory": True},
    "traj_only": {"with_trajectory": True, "traj_only": True},
}
CONSTANTS = {
    "default": lambda: make_constants(),
    "levapls2": lambda: make_constants().replace(LEVAPLS2=True),
    "faithful": lambda: make_constants().replace(FAST_DIV="faithful"),
    "ref": lambda: make_constants().replace(CUADJ_COMPACT=False),
    "lphylin=False": lambda: make_constants().replace(LPHYLIN=False),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cname", list(CONSTANTS))
@pytest.mark.parametrize("form", list(NL_FORMS))
def test_nl_outputs_are_the_per_call_marshalling(dtype, cname, form):
    s, dt = _state(dtype)
    c = CONSTANTS[cname]()
    want = _per_call_nl(s, dt, c, **NL_FORMS[form])
    for turn in ("cold", "warm"):
        _assert_bitwise(_nl(s, dt, c, **NL_FORMS[form]), want, f"{dtype} {cname} {form} {turn}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cname", list(CONSTANTS))
@pytest.mark.parametrize("cotangent_only", [False, True])
def test_ad_outputs_are_the_per_call_marshalling(dtype, cname, cotangent_only):
    s, dt = _state(dtype)
    c = CONSTANTS[cname]()
    want = _per_call_ad(s, dt, c, cotangent_only)
    for turn in ("cold", "warm"):
        _assert_bitwise(_ad(s, dt, c, cotangent_only=cotangent_only), want, f"{dtype} {cname} {turn}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cname", list(CONSTANTS))
@pytest.mark.parametrize("tangent_only", [False, True])
def test_tl_outputs_are_the_per_call_marshalling(dtype, cname, tangent_only):
    s, dt = _state(dtype)
    c = CONSTANTS[cname]()
    want = _per_call_tl(s, dt, c, tangent_only)
    for turn in ("cold", "warm"):
        _assert_bitwise(_tl(s, dt, c, tangent_only=tangent_only), want, f"{dtype} {cname} {turn}")


def test_the_tl_plan_key_carries_tangent_only_and_the_type_of_dt():
    """``tangent_only`` and ``dt``'s type each give a plan of their own: a
    float, a numpy float64 and a numpy float32 of one value, each with and
    without ``tangent_only``, build six plans, and each again finds its
    own."""
    s, dt = _state("f64")
    c = make_constants()
    first = {}
    for kind in (float, np.float64, np.float32):
        for tangent_only in (False, True):
            first[kind, tangent_only] = _tl(s, kind(dt), c, tangent_only=tangent_only)
    assert _counts() == (6, 0, 6)
    for (kind, tangent_only), want in first.items():
        _assert_bitwise(_tl(s, kind(dt), c, tangent_only=tangent_only), want, f"{kind.__name__} {tangent_only}")
    assert _counts() == (6, 6, 6)
    tangents = {"t_i", "q_i", "ql_i", "qi_i"}
    assert set(first[float, True][0]) == tangents and set(first[float, False][0]) == tangents | {"t", "q", "ql", "qi"}


# ---- the parts


def test_overlap_sweep_is_the_pairwise_rule():
    """``check_disjoint`` on views of one buffer at random offsets and
    lengths (absent fields among them) refuses exactly where some output
    overlaps some input, and names the first such output and its first
    input, as the search over every pair does."""
    rng = np.random.default_rng(11)
    buf = torch.empty(256, dtype=torch.uint8)

    def views(k):
        return [buf[lo:lo + n] if rng.integers(0, 4) else None
                for lo, n in zip(rng.integers(0, 200, k), rng.integers(1, 10, k))]

    refused = 0
    for _ in range(2000):
        ins, outs = views(int(rng.integers(1, 30))), views(int(rng.integers(1, 20)))
        names = [f"i{k}" for k in range(len(ins))]
        outd = {f"o{k}": o for k, o in enumerate(outs)}
        pairs = [(o, n) for o, t in outd.items() if t is not None for n, u in zip(names, ins) if u is not None
                 and t.data_ptr() < u.data_ptr() + u.nbytes and u.data_ptr() < t.data_ptr() + t.nbytes]
        if not pairs:
            nlk.check_disjoint(ins, outd, names)
            continue
        refused += 1
        with pytest.raises(ValueError, match=f"output '{pairs[0][0]}' overlaps input '{pairs[0][1]}';"):
            nlk.check_disjoint(ins, outd, names)
    assert 200 < refused < 1800


def test_a_dt_that_hashes_by_identity_keeps_no_plan():
    """A ``dt`` is a key by value for Python and numpy numbers, its type
    included; a tensor's hash is its identity, so its plan is built for
    the call and kept nowhere."""
    s, dt = _state("f64")
    c = make_constants()
    got = _nl(s, torch.tensor(dt, dtype=torch.float64), c)
    assert _counts() == (0, 0, 0)
    _assert_bitwise(got, _nl(s, dt, c), "dt as a float64 tensor")
    _nl(s, np.float64(dt), c)
    _nl(s, np.float32(dt), c)
    assert _counts() == (3, 0, 3)  # float, numpy float64 and float32: three keys


# ---- the compiled launcher


def test_the_launcher_converts_eta_to_the_state_dtype():
    """A float64 ``eta`` in a float32 state is read in float32, converted
    by the launcher: the launch returns the converted ``eta`` and gives
    bitwise the outputs of a state that holds it so."""
    s, dt = _state("f32")
    c = make_constants()
    want = _nl(s, dt, c)
    wide = dict(s, eta=s["eta"].double())
    outs, eta = nlk._run_nl("cloudsc2_nl_host", wide, dt, c, False, False, False, 1)
    assert eta.dtype == torch.float32 and torch.equal(eta, s["eta"])
    _assert_bitwise(nlk._assemble(outs, False, False), want, "eta in float64")


def test_the_launcher_takes_any_mapping():
    """A state that is a mapping but no dict gives bitwise a dict's outputs,
    and a field missing from it the dict's ``KeyError``."""
    from types import MappingProxyType

    s, dt = _state("f32")
    c = make_constants()
    traj = _nl(s, dt, c, with_trajectory=True, traj_only=True)[2]
    _assert_bitwise(_tl(MappingProxyType(s), dt, c), _tl(s, dt, c), "tl")
    got = adk.cloudsc2_ad_reverse_host(MappingProxyType(s), MappingProxyType(traj), dt, c)
    _assert_bitwise([got], [adk.cloudsc2_ad_reverse_host(s, traj, dt, c)], "ad reverse")
    partial = dict(s)
    del partial["q_i"]
    assert _error(lambda: _tl(MappingProxyType(partial), dt, c)) == _error(lambda: _tl(partial, dt, c))
    assert _error(lambda: _tl(partial, dt, c)) == (KeyError, "'q_i'")


def test_a_failed_launcher_build_raises(tmp_path, monkeypatch):
    """A compiler that refuses the launcher raises ``BuildError`` with its
    output and leaves no library behind; nothing falls back."""
    from cloudsc2_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    flags, libs = build.launcher_flags(False)
    with pytest.raises(build.BuildError, match="no-such-option"):
        build._compile("g++", ["launcher.cpp"], (*flags, "--no-such-option"), "cloudsc2_launcher", libs)
    assert not list(tmp_path.glob("*.so"))
