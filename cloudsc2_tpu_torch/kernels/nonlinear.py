# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The CLOUDSC2 nonlinear kernel for Hopper and its wrapper.

Replaces the Pallas kernel :func:`cloudsc2_tpu.pallas.nonlinear.
cloudsc2_nl_pallas` (``pallas/nonlinear.py:76``), its ``with_trajectory``
form (``:214-226``, the adjoint's forward sweep), its ``traj_only`` form
(``:367-392,458``, the forward sweep of a gradient-only adjoint), its
``fuse_saturation`` form (``:105-110,186-212``, ``qsat`` diagnosed inside
the kernel and returned), its ``FAST_DIV`` divide modes
(``physics/fastmath.py:34-78``) and its ``CUADJ_COMPACT=False`` saturation
adjustment (``physics/cuadjtqs.py:75-81``) included, and, for it, the level-scan
harness ``level_scan_pallas`` (``pallas/levelscan.py:402``).  The kernel is
CUDA C++ (``csrc/nonlinear.cu`` over ``csrc/nl_level.h`` and
``csrc/levelscan.cuh``, the exact divide in float and double and the
faithful and approx modes in float): one thread per column, the
carry in registers, the levels in a loop, on the pipelined form of the
harness: while a thread computes level k, the raw inputs of the levels
ahead are in flight into a per-thread ring (float: three slots in shared
memory, filled by ``cp.async``; double: two slots in registers), so the
loads overlap the arithmetic where the direct scan added the two.  The
loads run ahead of the stores of the levels before them, so the wrapper
refuses outputs that overlap an input (:func:`check_disjoint`).  The note
at the top of ``nonlinear.cu`` gives what bounds the kernel, before and
after, and why the ring needs no block synchronisation.

:func:`cloudsc2_nl_cuda` launches it on CUDA tensors and raises for
anything else; its plain version is
:func:`cloudsc2_tpu_torch.physics.nonlinear.cloudsc2_nl`.
:func:`occupancy` reports what the card makes of a form's kernel
(registers, blocks per SM, ring depth, shared bytes).
:func:`cloudsc2_nl_host` runs the same body and harness compiled for the
CPU, for the tests only, and :func:`cloudsc2_nl_direct_host` the body
through the direct scan, the harness's reference.  :func:`rcp_cuda` /
:func:`rcp_host` run the divide policies' reciprocal alone, for the
checks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.kernels import build
from cloudsc2_tpu_torch.physics.fastmath import DIV_MODES
from cloudsc2_tpu_torch.physics.nonlinear import (
    TRAJ_OUTPUTS,
    check_constants,
    scalm_profile,
    trajectory_names,
)
from cloudsc2_tpu_torch.state import NL_CONST_NAMES, kernel_constants

Tensor = torch.Tensor

#: argument orders of ``CLOUDSC2_NL_INPUTS`` / ``_OUTPUTS`` in ``nl_level.h``
NL_INPUTS = (
    "ap", "aph", "lu", "lude", "mfd", "mfu", "q", "qi", "ql", "qsat", "supsat",
    "t", "tnd_cml_q", "tnd_cml_qi", "tnd_cml_ql", "tnd_cml_t", "eta", "scalm",
)
#: (the step's outputs, then the trajectory of ``with_trajectory``, then
#: the ``qsat`` of ``fuse_saturation``)
STEP_OUTPUTS = (
    "tnd_t", "tnd_q", "tnd_ql", "tnd_qi", "clc", "covptot", "fplsl", "fplsn",
    "fhpsl", "fhpsn",
)
NL_OUTPUTS = STEP_OUTPUTS + TRAJ_OUTPUTS + ("qsat_out",)
#: the int switches of the launch, in the order of ``CLOUDSC2_NL_SWITCHES``
NL_SWITCHES = ("is_double", "thermo", "evap", "traj", "fuse", "div", "compact")
_IFACE = ("aph", "fplsl", "fplsn", "fhpsl", "fhpsn")
_VERT = ("eta", "scalm")
_DTYPES = (torch.float32, torch.float64)

_P = ctypes.c_void_p
_ARGS = [ctypes.c_int] * len(NL_SWITCHES) + [_P, _P, _P, ctypes.c_int, ctypes.c_int]


def signature() -> str:
    """The argument lists the Python side passes, in the form the kernel
    library reports them (``nl_signature`` in ``nl_level.h``)."""
    return "".join((
        "switches:", *(n + "," for n in NL_SWITCHES),
        ";consts:", *(n + "," for n in NL_CONST_NAMES),
        ";inputs:", *(n + "," for n in NL_INPUTS),
        ";outputs:", *(n + "," for n in NL_OUTPUTS),
    ))


@functools.lru_cache(maxsize=None)
def _load(kind: str, compact: bool = True) -> ctypes.CDLL:
    suffix, defines = build.form(compact, False, nl=True)
    if kind == "cuda":
        lib = build.load(kind, "cloudsc2_nl" + suffix, ["nonlinear.cu"], defines)
        fn, probe = lib.cloudsc2_nl_launch, lib.cloudsc2_rcp_probe
        fn.argtypes = _ARGS + [_P]
        lib.cloudsc2_nl_occupancy.argtypes = [ctypes.c_int] * len(NL_SWITCHES) + [_P]
        lib.cloudsc2_nl_occupancy.restype = ctypes.c_int
        probe.argtypes = [ctypes.c_int, _P, _P, ctypes.c_int, _P]
    else:
        lib = build.load(kind, "cloudsc2_nl_host" + suffix, ["nonlinear_host.cpp"], defines)
        fn, probe = lib.cloudsc2_nl_host, lib.cloudsc2_rcp_probe_host
        fn.argtypes = lib.cloudsc2_nl_direct_host.argtypes = _ARGS
        lib.cloudsc2_nl_direct_host.restype = lib.cloudsc2_nl_ring_depth.restype = ctypes.c_int
        lib.cloudsc2_nl_ring_depth.argtypes = [ctypes.c_int]
        probe.argtypes = [ctypes.c_int, _P, _P, ctypes.c_int]
    fn.restype = probe.restype = ctypes.c_int
    lib.cloudsc2_nl_signature.restype = ctypes.c_char_p
    got = lib.cloudsc2_nl_signature().decode()
    if got != signature():
        raise RuntimeError(f"kernel argument lists differ from the wrapper's:\n{got}\n{signature()}")
    return lib


def load_cuda(compact: bool = True) -> ctypes.CDLL:
    """Build (first use) and load the CUDA library of one saturation-
    adjustment form (``CUADJ_COMPACT``)."""
    return _load("cuda", compact)


def check_inputs(
    state: Dict[str, Tensor], c: Constants, device_type: str, inputs: Sequence[str],
    iface: Sequence[str],
) -> Tuple[List[Tensor], torch.dtype]:
    """Check the constants (:func:`check_constants`) and the state for a
    kernel, and return its ``inputs`` in order: ``eta`` in the state's dtype and ``scalm``
    computed from it, the other fields as they are.  Fields named in
    ``iface`` are ``(nlev + 1, ncols)``, ``eta``/``scalm`` ``(nlev,)``, the
    rest ``(nlev, ncols)``; all of one float dtype, contiguous, on one
    device of ``device_type``."""
    check_constants(c)
    ap = state["ap"]
    if ap.dim() != 2:
        raise ValueError(f"ap must be (nlev, ncols), got shape {tuple(ap.shape)}")
    nlev, ncols = ap.shape
    if nlev < 2 or ncols < 1:
        raise ValueError(f"need nlev >= 2 and ncols >= 1, got {(nlev, ncols)}")
    dtype = ap.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not supported (float32 | float64)")
    if ap.device.type != device_type:
        raise ValueError(f"tensors must be on {device_type}, got {ap.device}")
    eta = state["eta"]
    if eta.dtype != dtype:
        eta = eta.to(dtype)
    fields = {n: state[n] for n in inputs if n not in _VERT}
    fields["eta"] = eta
    fields["scalm"] = scalm_profile(eta, c)
    for n, v in fields.items():
        want = (nlev,) if n in _VERT else ((nlev + 1, ncols) if n in iface else (nlev, ncols))
        if tuple(v.shape) != want:
            raise ValueError(f"field {n!r} has shape {tuple(v.shape)}, want {want}")
        if v.dtype != dtype:
            raise TypeError(f"field {n!r} has dtype {v.dtype}, want {dtype}")
        if v.device != ap.device:
            raise ValueError(f"field {n!r} is on {v.device}, want {ap.device}")
        if not v.is_contiguous():
            raise ValueError(f"field {n!r} is not contiguous")
    return [fields[n] for n in inputs], dtype


def _marshal(
    state: Dict[str, Tensor], dt: float, c: Constants, device_type: str, with_trajectory: bool,
    traj_only: bool, fuse_saturation: bool, kflag: int,
) -> Tuple[List[Optional[Tensor]], Dict[str, Optional[Tensor]], Tensor, Tuple[int, ...]]:
    """Check the options and the state, and return the kernel's inputs in
    order (``None`` for ``qsat`` when fused), freshly allocated outputs
    (``None`` for one not written), the constant struct and the switches."""
    if traj_only and not with_trajectory:
        raise ValueError("traj_only requires with_trajectory=True")
    names = tuple(n for n in NL_INPUTS if not (fuse_saturation and n == "qsat"))
    ins, dtype = check_inputs(state, c, device_type, names, _IFACE)
    if fuse_saturation:
        ins.insert(NL_INPUTS.index("qsat"), None)
    nlev, ncols = state["ap"].shape
    written = trajectory_names(c) if with_trajectory else ()
    if not traj_only:
        written = STEP_OUTPUTS + written + (("qsat_out",) if fuse_saturation else ())
    outs = {
        n: None if n not in written else _empty(
            (nlev + 1, ncols) if n in _IFACE else (nlev, ncols), dtype, state["ap"].device
        )
        for n in NL_OUTPUTS
    }
    check_disjoint(ins, outs)
    consts = torch.from_numpy(kernel_constants(c, dt, dtype, kflag))
    return ins, outs, consts, launch_switches(c, dtype, with_trajectory, traj_only, fuse_saturation)


def _empty(shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device) -> Tensor:
    """An output's storage (the kernel writes every element)."""
    return torch.empty(shape, dtype=dtype, device=device)


def check_disjoint(ins: Sequence[Optional[Tensor]], outs: Dict[str, Optional[Tensor]],
                   names: Sequence[str] = NL_INPUTS) -> None:
    """Raise ``ValueError`` where an output's bytes overlap an input's (the
    inputs named by ``names``, in order): a pipelined kernel reads a level's
    inputs ahead of the stores of the levels before it, which is the same
    step only when no output is an input."""
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size(), n)
             for t, n in zip(ins, names) if t is not None]
    for name, o in outs.items():
        if o is None:
            continue
        lo, hi = o.data_ptr(), o.data_ptr() + o.numel() * o.element_size()
        for a, b, n in spans:
            if lo < b and a < hi:
                raise ValueError(f"output {name!r} overlaps input {n!r}; the kernel needs them apart")


def div_switch(c: Constants, dtype: torch.dtype) -> int:
    """The kernels' ``div`` switch: ``c.FAST_DIV``'s index in float32, 0
    (exact) in float64, which always divides exactly (fastmath: a non-f32
    operand divides exactly)."""
    return DIV_MODES.index(c.FAST_DIV) if dtype == torch.float32 else 0


def count_launch(entry, switches: Sequence[int]) -> None:
    """Add one launch to ``entry.launches``, and by its form (the switches'
    last two: ``div``, ``compact``) to ``.fast_div_launches`` (a non-exact
    divide) and ``.ref_launches`` (``CUADJ_COMPACT=False``)."""
    entry.launches += 1
    entry.fast_div_launches += int(switches[-2] != 0)
    entry.ref_launches += int(not switches[-1])


def ptrs(tensors) -> ctypes.Array:
    """A C array of the tensors' data pointers (``None`` gives a null pointer)."""
    return (_P * len(tensors))(*(None if t is None else t.data_ptr() for t in tensors))


def _assemble(outs: Dict[str, Optional[Tensor]], with_trajectory: bool, traj_only: bool):
    traj = {n: outs[n] for n in TRAJ_OUTPUTS if outs[n] is not None}
    if traj_only:
        return {}, {}, traj
    tends = {"t": outs["tnd_t"], "q": outs["tnd_q"], "ql": outs["tnd_ql"], "qi": outs["tnd_qi"]}
    diags = {n: outs[n] for n in ("clc", "covptot", "fplsl", "fplsn", "fhpsl", "fhpsn")}
    if outs["qsat_out"] is not None:
        diags["qsat"] = outs["qsat_out"]
    if not with_trajectory:
        return tends, diags
    return tends, diags, traj


def cloudsc2_nl_cuda(
    state: Dict[str, Tensor], dt: float, c: Constants, with_trajectory: bool = False,
    traj_only: bool = False, fuse_saturation: bool = False, kflag: int = 1,
):
    """One NL step through the CUDA kernel, on PyTorch's current stream.

    Same contract as :func:`cloudsc2_tpu_torch.physics.nonlinear.
    cloudsc2_nl`: contiguous CUDA tensors of one float dtype, any
    ``ncols``; ``(tendencies, diagnostics)``, and with ``with_trajectory``
    the trajectory dict as a third element.  ``traj_only`` (which requires
    ``with_trajectory``, ``ValueError`` otherwise) writes the trajectory
    alone and returns ``({}, {}, trajectory)``.  ``fuse_saturation``
    diagnoses ``qsat`` in the kernel (``kflag`` and ``c.LPHYLIN`` pick the
    branch, as for the ``Saturation`` component) instead of reading the
    state's, which may then be absent, and returns it as the diagnostic
    ``qsat`` (not with ``traj_only``).  ``c.FAST_DIV`` picks the divide
    mode (float32; float64 divides exactly), ``c.CUADJ_COMPACT`` the form
    of the saturation adjustment (one library each).  Raises on anything else, on a
    failed build and on a refused launch; never falls back to the plain
    version.  Each launch adds one to ``cloudsc2_nl_cuda.launches``, a
    launch under a non-exact divide also to ``.fast_div_launches``, and one
    with ``CUADJ_COMPACT=False`` to ``.ref_launches``.
    """
    ins, outs, consts, switches = _marshal(
        state, dt, c, "cuda", with_trajectory, traj_only, fuse_saturation, kflag)
    lib = load_cuda(c.CUADJ_COMPACT)
    nlev, ncols = state["ap"].shape
    with torch.cuda.device(state["ap"].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cloudsc2_nl_launch(
            *switches, ptrs(ins), ptrs(list(outs.values())), consts.data_ptr(), nlev, ncols, stream,
        )
    if err != 0:
        raise RuntimeError(f"cloudsc2_nl kernel launch failed: cudaError_t {err}")
    count_launch(cloudsc2_nl_cuda, switches)
    return _assemble(outs, with_trajectory, traj_only)


cloudsc2_nl_cuda.launches = 0  # type: ignore[attr-defined]
cloudsc2_nl_cuda.fast_div_launches = 0  # type: ignore[attr-defined]
cloudsc2_nl_cuda.ref_launches = 0  # type: ignore[attr-defined]


def launch_switches(c: Constants, dtype: torch.dtype, with_trajectory: bool = False, traj_only: bool = False,
             fuse_saturation: bool = False) -> Tuple[int, ...]:
    """The launch's int switches (``NL_SWITCHES``) for constants ``c``, a
    dtype and the options of :func:`cloudsc2_nl_cuda`."""
    return (
        int(dtype == torch.float64),
        int(bool(c.LPHYLIN or c.LDRAIN1D)),
        int(bool(c.LEVAPLS2 or c.LDRAIN1D)),
        2 if traj_only else int(with_trajectory),
        int(fuse_saturation),
        div_switch(c, dtype),
        int(bool(c.CUADJ_COMPACT)),
    )


@functools.lru_cache(maxsize=None)
def _occupancy(sw: Tuple[int, ...]) -> Tuple[int, ...]:
    out = (ctypes.c_int * 5)()
    err = load_cuda(bool(sw[-1])).cloudsc2_nl_occupancy(*sw, out)
    if err != 0:
        raise RuntimeError(f"cloudsc2_nl occupancy query failed: cudaError_t {err}")
    return tuple(out)


def occupancy(dtype: torch.dtype, c: Constants, with_trajectory: bool = False, traj_only: bool = False,
              fuse_saturation: bool = False) -> Dict[str, int]:
    """What the card makes of the kernel that :func:`cloudsc2_nl_cuda`
    launches for these options, at its 128 threads a block:
    ``blocks_per_sm`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    ``registers`` and ``local_bytes`` a thread (``cudaFuncGetAttributes``),
    ``shared_bytes`` a block and the ring ``depth``.  Needs the card; the
    answers are kept per instantiation."""
    sw = launch_switches(c, dtype, with_trajectory, traj_only, fuse_saturation)
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "shared_bytes", "depth"), _occupancy(sw)))


def _host(entry: str, state, dt, c, with_trajectory, traj_only, fuse_saturation, kflag):
    ins, outs, consts, switches = _marshal(
        state, dt, c, "cpu", with_trajectory, traj_only, fuse_saturation, kflag)
    nlev, ncols = state["ap"].shape
    err = getattr(_load("host", c.CUADJ_COMPACT), entry)(
        *switches, ptrs(ins), ptrs(list(outs.values())), consts.data_ptr(), nlev, ncols,
    )
    if err != 0:
        raise RuntimeError(f"{entry} failed: {err}")
    return _assemble(outs, with_trajectory, traj_only)


def cloudsc2_nl_host(
    state: Dict[str, Tensor], dt: float, c: Constants, with_trajectory: bool = False,
    traj_only: bool = False, fuse_saturation: bool = False, kflag: int = 1,
):
    """The kernel compiled for the host, on CPU tensors (tests only): its
    body through the pipelined scan the card runs, at the card's ring
    depth."""
    return _host("cloudsc2_nl_host", state, dt, c, with_trajectory, traj_only, fuse_saturation, kflag)


def cloudsc2_nl_direct_host(
    state: Dict[str, Tensor], dt: float, c: Constants, with_trajectory: bool = False,
    traj_only: bool = False, fuse_saturation: bool = False, kflag: int = 1,
):
    """:func:`cloudsc2_nl_host` through the direct scan (each level's loads,
    arithmetic and stores in turn): the pipelined scan's reference in the
    tests."""
    return _host("cloudsc2_nl_direct_host", state, dt, c, with_trajectory, traj_only, fuse_saturation, kflag)


def ring_depth(dtype: torch.dtype) -> int:
    """The slots of the kernel's ring (``nl_level.h`` ``NLRing``): the level
    running and the levels ahead in flight, as the host build reports
    them."""
    return _load("host").cloudsc2_nl_ring_depth(int(dtype == torch.float64))


def _rcp(x: Tensor, mode: str, device_type: str) -> Tensor:
    if x.dtype != torch.float32 or x.device.type != device_type or not x.is_contiguous() or x.numel() < 1:
        raise ValueError(f"need a non-empty contiguous float32 tensor on {device_type}")
    r = torch.empty_like(x)
    lib = _load(device_type if device_type == "cuda" else "host")
    if device_type == "cuda":
        with torch.cuda.device(x.device):
            err = lib.cloudsc2_rcp_probe(DIV_MODES.index(mode), x.data_ptr(), r.data_ptr(), x.numel(),
                                         torch.cuda.current_stream().cuda_stream)
    else:
        err = lib.cloudsc2_rcp_probe_host(DIV_MODES.index(mode), x.data_ptr(), r.data_ptr(), x.numel())
    if err != 0:
        raise RuntimeError(f"cloudsc2_rcp_probe failed: {err}")
    return r


def rcp_cuda(x: Tensor, mode: str) -> Tensor:
    """The kernel's reciprocal under the divide ``mode`` (``scalar_math.h``
    ``rcp<D>``: on the card PTX ``rcp.approx.ftz.f32``, with one Newton step
    in ``faithful``), point by point on a float32 CUDA tensor.  For the
    checks; the NL kernel inlines it."""
    return _rcp(x, mode, "cuda")


def rcp_host(x: Tensor, mode: str) -> Tensor:
    """:func:`rcp_cuda` of the host build (the approximate reciprocal as
    Pallas interpret mode models it), on a float32 CPU tensor."""
    return _rcp(x, mode, "cpu")
