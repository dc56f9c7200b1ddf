# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The CLOUDSC2 adjoint kernels for Hopper and their wrappers.

Replaces the Pallas kernel :func:`cloudsc2_tpu.pallas.adjoint.
cloudsc2_ad_pallas` (``pallas/adjoint.py:125``), its ``cotangent_only``
form included, with its two kernels:

1. the forward sweep, the NL kernel with its trajectory
   (:func:`cloudsc2_tpu_torch.kernels.nonlinear.cloudsc2_nl_cuda` with
   ``with_trajectory``): the forward outputs and the carry entering each
   level;
2. the reverse sweep (``csrc/adjoint.cu`` over ``csrc/ad_level.h``
   ``ADPipeBody`` and the pipelined scan of ``csrc/levelscan.cuh`` run
   bottom-up): one thread per column runs the levels bottom-up and applies
   the transpose of the TL level, written by hand (one primal pass and one
   adjoint pass, about 700 flops per column-level), around the stored
   carry; it folds the raw fields and seeds and writes the 16 assembled
   input cotangents itself.  Each level's 27 input values (29 with
   evaporation) are copied ahead into a ring in shared memory while the
   levels below it run, so the wrapper refuses outputs that overlap an
   input.  Its launch is worked out once per configuration, a cached
   :class:`~cloudsc2_tpu_torch.kernels.nonlinear.LaunchPlan`
   (:func:`_reverse_plan`), as the NL kernel's is, and launched by one
   compiled call; the two launches of a step share the ``eta`` of the
   first.  Each block of either kernel
   derives ``scalm`` from ``eta`` once, into shared memory before its ring
   (``levelscan.cuh`` "level table"), so no wrapper computes it.

Both are bound by bytes; the reverse level's registers and its ring's
shared bytes set how many columns an SM runs at once
(:func:`reverse_occupancy`, the note at the top of ``adjoint.cu``).
Unlike the Pallas kernel, it takes f32 and f64, any column count, and
``LPHYLIN=False``: the TL, and so the AD, does not read ``LPHYLIN``
(``physics/tangent_linear.py:26-27``), and the forward sweep runs the NL
step under linearized physics
(:func:`forward_constants`), which is the TL's own forward, so both
settings give the same numbers, as the JAX package's scan adjoint does.
It takes the ``FAST_DIV`` divide modes (float32; float64 divides exactly)
and both ``CUADJ_COMPACT`` forms, one library each
(:func:`cloudsc2_tpu_torch.kernels.build.form`).

It also replaces :func:`cloudsc2_tpu.pallas.adjoint.cloudsc2_ad_pallas_fused`
(``pallas/adjoint.py:432``) and its harness ``level_scan_fwdrev_pallas``
(``pallas/levelscan.py:87``) with one kernel (``csrc/ad_fused.cu`` over
``csrc/ad_fused.h`` and the fused form of ``csrc/levelscan.cuh``): the same
two sweeps in one launch, the forward sweep on the NL kernel's pipelined
scan, the trajectory (and with ``resident`` the folded level inputs) on a
stack in a scratch of device memory, fresh for each call.  It launches as
the others do, through a cached launch plan (:func:`_fused_plan`) whose
launcher allocates the scratch as the entry's last output.  Its blocks are
of 128 threads, and the registers set how many an SM holds:
:func:`fused_plan` counts them at a register count, and
:func:`fused_occupancy` asks the card and holds it to the plan.

:func:`cloudsc2_ad_cuda` and :func:`cloudsc2_ad_fused_cuda` launch on CUDA
tensors and raise for anything else; the plain version of both is
:func:`cloudsc2_tpu_torch.physics.adjoint.cloudsc2_ad`.
:func:`cloudsc2_ad_host` and :func:`cloudsc2_ad_fused_host` run the same
bodies compiled for the CPU, for the tests only.  While a profiler runs,
each call records a root span (``ad``, ``ad_fused``; ``ad_reverse`` for the
reverse kernel alone) and its stages (:mod:`cloudsc2_tpu_torch.utils.
timing`): ``plan``, then ``check``, ``alloc``, ``check`` and ``launch``
stamped inside the compiled call, those of both launches under one
``ad``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cloudsc2_tpu_torch.kernels import build, nonlinear
from cloudsc2_tpu_torch.kernels.nonlinear import (
    NL_INPUTS,
    STEP_OUTPUTS,
    LaunchPlan,
    cached,
    check_layout,
    count_launch,
    div_switch,
    layout,
    ptrs,
)
from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.physics.adjoint import AD_COTANGENT_FIELDS, AD_DIAGNOSTICS, AD_TENDENCIES
from cloudsc2_tpu_torch.physics.nonlinear import TRAJ_OUTPUTS, check_constants
from cloudsc2_tpu_torch.state import NL_CONST_NAMES, TL_CONST_NAMES, kernel_constants, tl_kernel_constants
from cloudsc2_tpu_torch.utils.timing import PROFILER, close_span, open_span

Tensor = torch.Tensor

#: the output cotangent seeds the reverse kernel reads
AD_SEEDS = (
    "tnd_t_i", "tnd_q_i", "tnd_ql_i", "tnd_qi_i", "clc_i", "covptot_i",
    "fplsl_i", "fplsn_i", "fhpsl_i", "fhpsn_i",
)
#: argument orders of ``CLOUDSC2_AD_INPUTS`` / ``_OUTPUTS`` in ``ad_level.h``
AD_INPUTS = NL_INPUTS[:-1] + AD_SEEDS + TRAJ_OUTPUTS + NL_INPUTS[-1:]
AD_OUTPUTS = tuple("cml_" + n + "_i" for n in AD_TENDENCIES) + (
    "ap_i", "aph_i", "t_i", "q_i", "qsat_i", "ql_i", "qi_i", "lu_i", "lude_i",
    "mfd_i", "mfu_i", "supsat_i",
)
#: argument orders of ``CLOUDSC2_AD_FUSED_INPUTS`` / ``_OUTPUTS`` in ``ad_fused.h``
AD_FUSED_INPUTS = NL_INPUTS[:-1] + AD_SEEDS + NL_INPUTS[-1:]
AD_FUSED_OUTPUTS = STEP_OUTPUTS + AD_OUTPUTS
#: the folded level inputs the fused kernel's resident form keeps on its
#: stack (``FWD_INPUTS``, ``pallas/adjoint.py:98``)
AD_FUSED_RESIDENT = ("ap", "dp", "lu_next", "lude", "mf", "q2", "ql_fg", "qi_fg", "qsat", "t_fg")
_IFACE = ("aph", "aph_i", "fplsl_i", "fplsn_i", "fhpsl_i", "fhpsn_i", "fplsl", "fplsn", "fhpsl", "fhpsn")
#: read only with the evaporation branch (may be absent otherwise)
_EVAP_ONLY = ("c_cov", "covptot_i")
#: the limits of one SM on sm_90 the plan counts: blocks, threads, and
#: registers, which the card hands out per warp in units of 256 within each
#: of the SM's four sub-partitions (as ``cuda_occupancy.h`` counts them)
MAX_BLOCKS_PER_SM = 32
MAX_THREADS_PER_SM = 2_048
SM_REGISTERS = 65_536
REGISTER_UNIT = 256
SM_PARTITIONS = 4
#: shared memory of one SM on sm_90 (228 KB), and what the card reserves of
#: it for each resident block
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1_024
#: the fused kernel's threads a block (``kBlock`` in ``ad_fused.cu``)
FUSED_BLOCK = 128
#: the reverse kernel's threads a block (``kBlock`` in ``adjoint.cu``)
REVERSE_BLOCK = 128
#: the fused kernel's forward sweep runs the NL kernel's pipelined scan: its
#: ring's slots in shared memory by dtype (``nl_level.h`` ``NLRing``: f32
#: three, f64 two in registers), each of the unfused NL level's 16 raw
#: input fields
FUSED_RING_SLOTS = {torch.float32: 3, torch.float64: 0}
FUSED_RING_FIELDS = 16

#: argument lists of the host build's pointwise level entry
#: (``cloudsc2_ad_level_signature`` in ``adjoint_host.cpp``; tests only): a
#: level's forward inputs, the column's values, the carry entering the level,
#: the input directions of ``ad_level`` (``CLOUDSC2_AD_DIRS``), the outputs it
#: weights (``CLOUDSC2_AD_WEIGHTS``) and the branches it reports
#: (``CLOUDSC2_AD_BRANCHES``)
AD_LEVEL_X = AD_FUSED_RESIDENT + ("eta", "scalm")
AD_LEVEL_COL = ("aph_s", "trpaus")
AD_LEVEL_TRAJ = ("rfl", "sfl", "covptot")
AD_DIRS = ("rfl", "sfl", "cov", "ap", "dp", "lu_next", "lude", "mf", "q2", "ql_fg", "qi_fg", "qsat", "t_fg",
           "aph_s")
AD_WEIGHTS = ("rfl", "sfl", "cov", "tnd_t", "tnd_q", "tnd_ql", "tnd_qi", "clc", "covptot")
AD_BRANCHES = (
    "cold", "noclip", "qlim_sat", "cold_ice", "low", "mid", "high", "lo1", "lo3", "warm", "act", "grow",
    "melt", "snow_all", "coldt", "eact", "big", "drained", "adj_warm", "adj_noclip1", "adj_noclip2",
    "clipped", "coldt2",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: a launch entry's arguments after its int switches: the inputs, the
#: outputs, the constant buffer, nlev and ncols (and a CUDA library's stream)
_TAIL = [_P, _P, _P, _I, _I]


def _names(*groups) -> str:
    return "".join(f"{label}:" + "".join(n + "," for n in names) for label, names in groups)


def signature() -> str:
    """The argument lists the Python side passes, in the form the kernel
    library reports them (``ad_signature`` in ``ad_level.h``)."""
    return _names(("consts", TL_CONST_NAMES), (";inputs", AD_INPUTS), (";outputs", AD_OUTPUTS))


def level_signature() -> str:
    """The same for the host build's pointwise level entry."""
    return _names(("x", AD_LEVEL_X), (";col", AD_LEVEL_COL), (";traj", AD_LEVEL_TRAJ), (";dirs", AD_DIRS),
                  (";weights", AD_WEIGHTS), (";branches", AD_BRANCHES))


def fused_signature() -> str:
    """The same for the fused kernel (``ad_fused_signature`` in
    ``ad_fused.h``): one constant buffer, the NL struct then the TL struct;
    the outputs, then the stack's scratch."""
    return _names(
        ("consts", NL_CONST_NAMES + TL_CONST_NAMES), (";inputs", AD_FUSED_INPUTS),
        (";outputs", AD_FUSED_OUTPUTS + ("scratch",)), (";resident", AD_FUSED_RESIDENT),
    )


#: library name, source, C entry and its arguments, by (kind, kernel)
_LIBRARIES = {
    ("cuda", "ad"): ("cloudsc2_ad", "adjoint.cu", "cloudsc2_ad_launch", [_I] * 5 + _TAIL + [_P]),
    ("host", "ad"): ("cloudsc2_ad_host", "adjoint_host.cpp", "cloudsc2_ad_host", [_I] * 5 + _TAIL),
    ("cuda", "ad_fused"): ("cloudsc2_ad_fused", "ad_fused.cu", "cloudsc2_ad_fused_launch", [_I] * 6 + _TAIL + [_P]),
    ("host", "ad_fused"): ("cloudsc2_ad_fused_host", "ad_fused_host.cpp", "cloudsc2_ad_fused_host", [_I] * 6 + _TAIL),
}


@functools.lru_cache(maxsize=None)
def _load(kind: str, form: str = "ad", compact: bool = True, fast: bool = False) -> ctypes.CDLL:
    name, source, entry, argtypes = _LIBRARIES[kind, form]
    suffix, defines = build.form(compact, fast)
    lib = build.load(kind, name + suffix, [source], defines)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    if kind == "cuda" and form == "ad":
        lib.cloudsc2_ad_occupancy.argtypes = [_I] * 6 + [_P]
        lib.cloudsc2_ad_occupancy.restype = ctypes.c_int
    if kind == "cuda" and form == "ad_fused":
        lib.cloudsc2_ad_fused_occupancy.argtypes = [_I] * 7 + [_P]
        lib.cloudsc2_ad_fused_occupancy.restype = ctypes.c_int
    if kind == "host" and form == "ad":
        lib.cloudsc2_ad_direct_host.argtypes = argtypes
        lib.cloudsc2_ad_direct_host.restype = ctypes.c_int
        lib.cloudsc2_ad_level_host.argtypes = [_I] * 5 + [_P] * 4 + [_I]
        lib.cloudsc2_ad_level_host.restype = ctypes.c_int
        lib.cloudsc2_ad_level_signature.restype = ctypes.c_char_p
        got = lib.cloudsc2_ad_level_signature().decode()
        if got != level_signature():
            raise RuntimeError(f"level entry argument lists differ from the wrapper's:\n{got}\n{level_signature()}")
    sig = getattr(lib, f"cloudsc2_{form}_signature")
    sig.restype = ctypes.c_char_p
    got, want = sig().decode(), (signature() if form == "ad" else fused_signature())
    if got != want:
        raise RuntimeError(f"kernel argument lists differ from the wrapper's:\n{got}\n{want}")
    return lib


def load_cuda(compact: bool = True, fast: bool = False) -> ctypes.CDLL:
    """Build (first use) and load the CUDA library of the two-kernel AD's
    reverse kernel, of one form (:func:`cloudsc2_tpu_torch.kernels.build.form`)."""
    return _load("cuda", "ad", compact, fast)


def load_fused_cuda(compact: bool = True, fast: bool = False) -> ctypes.CDLL:
    """Build (first use) and load the CUDA library of the fused AD kernel,
    of one form."""
    return _load("cuda", "ad_fused", compact, fast)


def _form_lib(kind: str, form: str, switches: Tuple[int, ...]) -> ctypes.CDLL:
    """The library of the form the switches name (their last two: ``div``,
    ``compact``)."""
    return _load(kind, form, bool(switches[-1]), switches[-2] != 0)


def forward_constants(c: Constants) -> Constants:
    """The constants of the AD's forward sweep: ``c`` under linearized
    physics.  The forward sweep is the NL step with ``THERMO = LPHYLIN or
    LDRAIN1D`` on, which is the TL's own forward (the TL always takes the
    tanh water fraction and clips ``esdp``); the TL and AD read no
    ``LPHYLIN``, so ``LPHYLIN=False`` gives bitwise the launch of
    ``LPHYLIN=True``."""
    return c if c.LPHYLIN else c.replace(LPHYLIN=True)


@functools.lru_cache(maxsize=None)
def _read(inputs: Tuple[str, ...], evap: bool) -> Tuple[Optional[str], ...]:
    """``inputs`` with ``None`` for each that the kernel does not read
    (``c_cov`` and ``covptot_i`` only with evaporation, ``evap``)."""
    return tuple(n if evap or n not in _EVAP_ONLY else None for n in inputs)


@functools.lru_cache(maxsize=64, typed=True)
def _reverse_plan(entry: str, dtype: torch.dtype, shape: Tuple[int, ...], c: Constants, dt: float) -> LaunchPlan:
    """The plan of one reverse launch through ``entry`` (``"cuda"``, or a
    host build's entry on the CPU) at ``shape``, ``(nlev, ncols)``: the C
    entry, the switches, the constant struct and the 16 outputs."""
    check_layout(dtype, shape)
    switches = reverse_switches(dtype, c)
    lib = _form_lib("cuda" if entry == "cuda" else "host", "ad", switches)
    if entry == "cuda":
        fn, failure = lib.cloudsc2_ad_launch, "cloudsc2_ad kernel launch failed: cudaError_t {}"
    else:
        fn, failure = getattr(lib, entry), "cloudsc2_ad host body failed: {}"
    return LaunchPlan.make(fn, entry == "cuda", failure, switches,
                           torch.from_numpy(tl_kernel_constants(c, dt, dtype)),
                           _read(AD_INPUTS, bool(c.LEVAPLS2 or c.LDRAIN1D)), AD_OUTPUTS, AD_OUTPUTS, _IFACE, dtype,
                           *shape)


def _run_reverse(entry: str, state: Dict[str, Tensor], traj: Dict[str, Tensor], dt: float, c: Constants,
                 eta: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """One reverse launch through ``entry``: the constants checked, the plan
    looked up by the state's ``ap``, then the launch by its plan, which
    checks the state, its seeds and the trajectory (``traj``'s fields
    first; ``eta`` that of the forward launch on the same state, where
    there is one).  Returns the 16 input cotangents by name (none
    overlapping an input: the kernel reads the next levels up ahead of its
    stores); a launch on the card counts in ``cloudsc2_ad_cuda.launches``.
    Its stages are the span ``plan`` and those of
    :meth:`~cloudsc2_tpu_torch.kernels.nonlinear.LaunchPlan.run`."""
    k = open_span("plan") if PROFILER._is_profiler_enabled else None
    check_constants(c)
    plan = cached(_reverse_plan, dt)(entry, *layout(state, entry), c, dt)
    if k:
        close_span(k)
    outs, _ = plan.run(state, traj, eta)
    if entry == "cuda":
        count_launch(cloudsc2_ad_cuda, plan.switches)
    return outs


def _assemble(
    tends: Dict[str, Tensor], diags: Dict[str, Tensor], cot: Dict[str, Tensor]
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """``(tendencies, diagnostics)`` as :func:`cloudsc2_tpu_torch.physics.
    adjoint.cloudsc2_ad` returns them, from the forward outputs and the
    reverse kernel's cotangents."""
    tends = {**tends, **{n: cot[n] for n in AD_OUTPUTS[:4]}}
    diags = {**diags, **{n + "_i": cot[n + "_i"] for n in AD_COTANGENT_FIELDS}}
    return tends, diags


def cloudsc2_ad_reverse_cuda(
    state: Dict[str, Tensor], traj: Dict[str, Tensor], dt: float, c: Constants
) -> Dict[str, Tensor]:
    """The reverse kernel alone, on PyTorch's current stream: the 16 input
    cotangents (named as in ``AD_OUTPUTS``) from the state, its seeds and
    the forward trajectory ``traj``.  Raises on anything the kernel does
    not take, on a failed build and on a refused launch (its ring's shared
    memory included); never falls back.  Each launch adds one to
    ``cloudsc2_ad_cuda.launches`` (and by its form, see
    :func:`cloudsc2_tpu_torch.kernels.nonlinear.count_launch`)."""
    return _reverse_entry("cuda", state, traj, dt, c)


def _reverse_entry(entry: str, state: Dict[str, Tensor], traj: Dict[str, Tensor], dt: float,
                   c: Constants) -> Dict[str, Tensor]:
    """One call of the reverse kernel alone through ``entry``, the root span
    ``ad_reverse`` while a profiler runs."""
    k = open_span("ad_reverse") if PROFILER._is_profiler_enabled else None
    try:
        return _run_reverse(entry, state, traj, dt, c)
    finally:
        if k:
            close_span(k)


def cloudsc2_ad_cuda(
    state: Dict[str, Tensor], dt: float, c: Constants, cotangent_only: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One AD step through the CUDA kernels, on PyTorch's current stream:
    the NL kernel with its trajectory (counted in
    ``cloudsc2_nl_cuda.launches``), then the reverse kernel (counted in
    ``cloudsc2_ad_cuda.launches``).  With ``cotangent_only`` the NL kernel
    writes the trajectory alone (``traj_only``) and only the cotangents are
    returned.

    Same contract as :func:`cloudsc2_tpu_torch.physics.adjoint.
    cloudsc2_ad`: contiguous CUDA tensors of one float dtype, any
    ``ncols``, any ``LPHYLIN`` (the forward sweep runs under
    :func:`forward_constants`), ``FAST_DIV`` and ``CUADJ_COMPACT``.  Raises
    on anything the kernels do not take, on a failed build and on a refused
    launch; never falls back to the plain version.
    """
    return _two_kernels("cuda", state, dt, c, cotangent_only)


def _two_kernels(entry: str, state: Dict[str, Tensor], dt: float, c: Constants, cotangent_only: bool):
    """The NL launch with its trajectory under :func:`forward_constants`,
    then the reverse launch on the ``eta`` of the first,
    through ``entry`` (``"cuda"`` or ``"host"``); the root span ``ad`` while
    a profiler runs."""
    fwd, rev = ("cuda", "cuda") if entry == "cuda" else ("cloudsc2_nl_host", "cloudsc2_ad_host")
    k = open_span("ad") if PROFILER._is_profiler_enabled else None
    try:
        outs, eta = nonlinear._run_nl(fwd, state, dt, forward_constants(c), True, cotangent_only, False, 1)
        tends, diags, traj = nonlinear._assemble(outs, True, cotangent_only)
        return _assemble(tends, diags, _run_reverse(rev, state, traj, dt, c, eta))
    finally:
        if k:
            close_span(k)


cloudsc2_ad_cuda.launches = 0  # type: ignore[attr-defined]
cloudsc2_ad_cuda.fast_div_launches = 0  # type: ignore[attr-defined]
cloudsc2_ad_cuda.ref_launches = 0  # type: ignore[attr-defined]


def reverse_switches(dtype: torch.dtype, c: Constants) -> Tuple[int, ...]:
    """The reverse kernel's int switches for a dtype and constants ``c``:
    ``is_double``, ``evap``, ``lregcl``, ``div``, ``compact``."""
    return (int(dtype == torch.float64), int(bool(c.LEVAPLS2 or c.LDRAIN1D)), int(bool(c.LREGCL)),
            div_switch(c, dtype), int(bool(c.CUADJ_COMPACT)))


@functools.lru_cache(maxsize=None)
def _reverse_query(switches: Tuple[int, ...], nlev: int) -> Tuple[int, ...]:
    out = (ctypes.c_int * 5)()
    err = _form_lib("cuda", "ad", switches).cloudsc2_ad_occupancy(*switches, nlev, out)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad occupancy query failed: cudaError_t {err}")
    return tuple(out)


def reverse_ring_fields(evap: bool) -> int:
    """Values of one level in a slot of the reverse kernel's ring
    (``ad_level.h`` ``ADRingField``): 16 raw fields, 9 seeds and 2 values
    of the trajectory, and with evaporation ``covptot_i`` and ``c_cov``."""
    return 29 if evap else 27


def reverse_plan(dtype: torch.dtype, evap: bool, registers: int, depth: int, nlev: int = 137) -> Dict[str, int]:
    """The reverse kernel's launch at a register count and ring depth, at
    ``nlev`` levels (the model's 137 unless told): blocks of
    ``REVERSE_BLOCK`` threads, in dynamic shared memory the level table
    (``nlev`` values) and its ring of ``depth`` slots of
    :func:`reverse_ring_fields` values a thread (``shared_bytes``: 28,196 B
    a block in f32 at 2 slots and 137 levels, 56,392 B in f64), and as many
    blocks an SM as the registers (:func:`register_blocks`) and the shared
    bytes leave."""
    item = torch.empty((), dtype=dtype).element_size()
    shared = nlev * item + depth * reverse_ring_fields(evap) * REVERSE_BLOCK * item
    per_sm = min(register_blocks(registers, REVERSE_BLOCK), SM_SHARED_BYTES // (shared + BLOCK_RESERVED_BYTES))
    return {"block": REVERSE_BLOCK, "blocks_per_sm": per_sm, "shared_bytes": shared, "depth": depth}


def reverse_occupancy(dtype: torch.dtype, c: Constants, nlev: int = 137) -> Dict[str, int]:
    """What the card makes of the reverse kernel that
    :func:`cloudsc2_ad_reverse_cuda` launches for constants ``c``, at its
    128 threads a block and ``nlev`` levels (the model's 137 unless told):
    ``blocks_per_sm`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    ``registers`` and ``local_bytes`` a thread (``cudaFuncGetAttributes``),
    ``shared_bytes`` a block and the ring ``depth``.  Raises
    ``RuntimeError`` where the card's blocks per SM or shared bytes are not
    :func:`reverse_plan`'s at the card's registers and depth.  Needs the
    card; the answers are kept per instantiation and depth."""
    switches = reverse_switches(dtype, c)
    per_sm, registers, local, shared, depth = _reverse_query(switches, nlev)
    got = {"blocks_per_sm": per_sm, "registers": registers, "local_bytes": local, "shared_bytes": shared,
           "depth": depth}
    plan = reverse_plan(dtype, bool(switches[1]), registers, depth, nlev)
    if (per_sm, shared) != (plan["blocks_per_sm"], plan["shared_bytes"]):
        raise RuntimeError(f"the card holds the AD reverse kernel otherwise than its plan: {got} against {plan}")
    return got


def cloudsc2_ad_host(
    state: Dict[str, Tensor], dt: float, c: Constants, cotangent_only: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """The kernels' bodies compiled for the host, on CPU tensors (tests
    only): the host NL body with its trajectory, then the reverse body."""
    return _two_kernels("host", state, dt, c, cotangent_only)


def cloudsc2_ad_reverse_host(
    state: Dict[str, Tensor], traj: Dict[str, Tensor], dt: float, c: Constants, direct: bool = False
) -> Dict[str, Tensor]:
    """The reverse kernel's body compiled for the host, on CPU tensors
    (tests only), as :func:`cloudsc2_ad_reverse_cuda` takes them: through
    the pipelined reverse scan the card runs, at the card's ring depth, or
    with ``direct`` through the direct reverse scan, its reference."""
    return _reverse_entry("cloudsc2_ad_direct_host" if direct else "cloudsc2_ad_host", state, traj, dt, c)


def reverse_ring_depth(dtype: torch.dtype) -> int:
    """The slots of the reverse kernel's ring (``ad_level.h`` ``ADRing``):
    the level running and the next levels up in flight, as the host build
    reports them."""
    return _load("host").cloudsc2_ad_ring_depth(int(dtype == torch.float64))


def cloudsc2_ad_level_host(
    x: Dict[str, Tensor], col: Dict[str, Tensor], traj: Dict[str, Tensor], dirs: Dict[str, Tensor],
    weights: Dict[str, Tensor], dt: float, c: Constants, reference: bool = False,
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor], Tensor]:
    """One level at each of a set of points, through the host build (tests
    only): ``tl_level`` at the perturbations ``dirs`` and ``ad_level`` at the
    output cotangents ``weights``.  Every argument is a dict of 1-D CPU
    tensors of one float dtype and one length, named as in ``AD_LEVEL_X``,
    ``AD_LEVEL_COL``, ``AD_LEVEL_TRAJ``, ``AD_DIRS`` and ``AD_WEIGHTS``;
    ``c.FAST_DIV`` (float32) and ``c.CUADJ_COMPACT`` pick the level's form.
    With ``reference`` the same code runs in long double on the same inputs
    and constants (under a non-exact divide, from the approximate
    reciprocal of the same float operands), its results rounded to float64.  Returns the TL level's
    outputs (named as ``AD_WEIGHTS``), the AD level's cotangents (named as
    ``AD_DIRS``) and, per point, the mask of the branches ``ad_level`` took
    (bit i: ``AD_BRANCHES[i]``)."""
    ins = [x[n] for n in AD_LEVEL_X] + [col[n] for n in AD_LEVEL_COL] + [traj[n] for n in AD_LEVEL_TRAJ]
    ins += [dirs[n] for n in AD_DIRS] + [weights[n] for n in AD_WEIGHTS]
    dtype, npoints = ins[0].dtype, ins[0].numel()
    for t in ins:
        if t.dtype != dtype or t.shape != (npoints,) or t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError(f"need contiguous 1-D CPU tensors of one dtype and length, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    consts = torch.from_numpy(tl_kernel_constants(c, dt, dtype))
    precision = int(dtype == torch.float64)
    div, compact = div_switch(c, dtype), int(bool(c.CUADJ_COMPACT))
    if reference:
        ins, consts, dtype, precision = [t.double() for t in ins], consts.double(), torch.float64, 2
    outs = [torch.empty(npoints, dtype=dtype) for _ in AD_WEIGHTS + AD_DIRS]
    branches = torch.zeros(npoints, dtype=torch.int32)
    evap, lregcl = int(bool(c.LEVAPLS2 or c.LDRAIN1D)), int(bool(c.LREGCL))
    err = _load("host", "ad", bool(compact), div != 0).cloudsc2_ad_level_host(
        precision, evap, lregcl, div, compact, ptrs(ins), ptrs(outs), branches.data_ptr(),
        consts.data_ptr(), npoints)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad_level host entry failed: {err}")
    n = len(AD_WEIGHTS)
    return dict(zip(AD_WEIGHTS, outs[:n])), dict(zip(AD_DIRS, outs[n:])), branches


# ---- the fused kernel (cloudsc2_ad_pallas_fused)


def fused_stack_slots(evap: bool, resident: bool) -> int:
    """Values a thread pushes per level: the trajectory (c_rfl, c_sfl, and
    c_cov with evaporation), and with ``resident`` the folded level inputs
    (``ADFusedSlots`` in ``ad_fused.h``)."""
    return (3 if evap else 2) + (len(AD_FUSED_RESIDENT) if resident else 0)


def register_blocks(registers: int, block: int) -> int:
    """Blocks of ``block`` threads that one SM holds at ``registers`` a
    thread, with nothing else bounding them: the register file's count
    (``SM_REGISTERS``, handed out as ``cuda_occupancy.h`` counts: a warp's
    registers rounded up to ``REGISTER_UNIT``, whole warps in each of
    ``SM_PARTITIONS``), at most ``MAX_BLOCKS_PER_SM`` and
    ``MAX_THREADS_PER_SM`` threads."""
    per_warp = -(-registers * 32 // REGISTER_UNIT) * REGISTER_UNIT
    warps = SM_REGISTERS // SM_PARTITIONS // per_warp * SM_PARTITIONS
    return min(warps // -(-block // 32), MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // block)


def fused_plan(nlev: int, ncols: int, dtype: torch.dtype, evap: bool, resident: bool,
               registers: int) -> Dict[str, int]:
    """The fused kernel's launch at a register count: blocks of
    ``FUSED_BLOCK`` threads, as many an SM as the registers allow
    (:func:`register_blocks`: 4 at the 128 registers of the f32 default
    switches, 512 threads; 2 at f64's 238-255, 256 threads), which the
    level table and the forward sweep's ring in shared memory
    (``shared_bytes``: ``nlev`` values, then 24 KB a block in f32, none in
    f64) leave them; no level of the stack in shared
    memory (``levels_in_shared``); the stack's scratch in device memory,
    ``scratch_bytes``: :func:`fused_stack_slots` x ``nlev`` x ``ncols``
    values (71.8 MB in f32 at 65,536 x 137 rolled, 431 MB resident).  Any
    depth: the stack no longer bounds the columns."""
    item = torch.empty((), dtype=dtype).element_size()
    shared = nlev * item + FUSED_RING_SLOTS[dtype] * FUSED_RING_FIELDS * FUSED_BLOCK * item
    per_sm = min(register_blocks(registers, FUSED_BLOCK), SM_SHARED_BYTES // (shared + BLOCK_RESERVED_BYTES))
    return {"block": FUSED_BLOCK, "blocks_per_sm": per_sm, "threads_per_sm": FUSED_BLOCK * per_sm,
            "shared_bytes": shared, "levels_in_shared": 0,
            "scratch_bytes": fused_stack_slots(evap, resident) * nlev * ncols * item}


def fused_switches(dtype: torch.dtype, c: Constants, resident: bool) -> Tuple[int, ...]:
    """The fused kernel's int switches for a dtype, constants ``c`` and
    ``resident``: ``is_double``, ``evap``, ``lregcl``, ``resident``,
    ``div``, ``compact``."""
    return (int(dtype == torch.float64), int(bool(c.LEVAPLS2 or c.LDRAIN1D)), int(bool(c.LREGCL)),
            int(resident), div_switch(c, dtype), int(bool(c.CUADJ_COMPACT)))


@functools.lru_cache(maxsize=64, typed=True)
def _fused_plan(entry: str, dtype: torch.dtype, shape: Tuple[int, ...], c: Constants, dt: float,
                resident: bool) -> LaunchPlan:
    """The plan of one fused launch through ``entry`` (``"cuda"``, or the
    host build's ``"cloudsc2_ad_fused_host"`` on the CPU) at ``shape``,
    ``(nlev, ncols)``: the C entry of the form's library, the switches, one
    constant buffer (the NL struct under :func:`forward_constants`, then
    the TL struct), the 26 outputs and the stack's scratch,
    :func:`fused_stack_slots` x ``nlev`` x ``ncols``, which the launcher
    allocates fresh for each call as it does the outputs."""
    check_layout(dtype, shape)
    switches = fused_switches(dtype, c, resident)
    on_card = entry == "cuda"
    lib = _form_lib("cuda" if on_card else "host", "ad_fused", switches)
    if on_card:
        fn, failure = lib.cloudsc2_ad_fused_launch, "cloudsc2_ad_fused kernel launch failed: cudaError_t {}"
    else:
        fn, failure = getattr(lib, entry), "cloudsc2_ad_fused host body failed: {}"
    consts = np.concatenate((kernel_constants(forward_constants(c), dt, dtype), tl_kernel_constants(c, dt, dtype)))
    evap = bool(switches[1])
    return LaunchPlan.make(fn, on_card, failure, switches, torch.from_numpy(consts), _read(AD_FUSED_INPUTS, evap),
                           AD_FUSED_OUTPUTS, AD_FUSED_OUTPUTS, _IFACE, dtype, *shape,
                           scratch=fused_stack_slots(evap, resident))


def _run_fused(entry: str, state: Dict[str, Tensor], dt: float, c: Constants,
               resident: bool) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One call of the fused kernel through ``entry`` (``"cuda"``: on
    PyTorch's current stream; ``"cloudsc2_ad_fused_host"``: the host build,
    which fills its scratch with NaN before it runs), the root span
    ``ad_fused`` while a profiler runs: the constants checked, the plan
    looked up by the state's ``ap`` (the span ``plan``), then the launch by
    its plan, which checks the state and allocates the outputs and the
    scratch.  The scratch is not returned, so it is freed on return; a
    launch on the card counts in ``cloudsc2_ad_fused_cuda.launches``."""
    k = open_span("ad_fused") if PROFILER._is_profiler_enabled else None
    try:
        s = open_span("plan") if k else None
        check_constants(c)
        plan = cached(_fused_plan, dt)(entry, *layout(state, entry), c, dt, bool(resident))
        if s:
            close_span(s)
        outs, _ = plan.run(state)
        if entry == "cuda":
            count_launch(cloudsc2_ad_fused_cuda, plan.switches)
        return _assemble_fused(outs)
    finally:
        if k:
            close_span(k)


def _assemble_fused(outs: Dict[str, Tensor]) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    tends = {n: outs["tnd_" + n] for n in AD_TENDENCIES}
    return _assemble(tends, {n: outs[n] for n in AD_DIAGNOSTICS}, outs)


def cloudsc2_ad_fused_cuda(
    state: Dict[str, Tensor], dt: float, c: Constants, resident: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One AD step through the fused CUDA kernel, on PyTorch's current
    stream: both sweeps in one launch, the stack in a scratch of device
    memory allocated for the call (:func:`fused_plan` counts its bytes).
    Each launch adds one to ``cloudsc2_ad_fused_cuda.launches`` (and by
    its form, as the reverse kernel's).

    Same contract and outputs as :func:`cloudsc2_ad_cuda`, every form
    included.  ``resident`` keeps the folded level inputs on the kernel's
    stack too.  Raises on anything the kernel does not take, on a failed
    build and on a refused launch; never falls back to the plain version
    or to the two-kernel AD.
    """
    return _run_fused("cuda", state, dt, c, resident)


cloudsc2_ad_fused_cuda.launches = 0  # type: ignore[attr-defined]
cloudsc2_ad_fused_cuda.fast_div_launches = 0  # type: ignore[attr-defined]
cloudsc2_ad_fused_cuda.ref_launches = 0  # type: ignore[attr-defined]


@functools.lru_cache(maxsize=None)
def _occupancy(switches: Tuple[int, ...], nlev: int) -> Tuple[int, int, int, int]:
    out = (ctypes.c_int * 4)()
    err = _form_lib("cuda", "ad_fused", switches).cloudsc2_ad_fused_occupancy(*switches, nlev, out)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad_fused occupancy query failed: cudaError_t {err}")
    return tuple(out)


def fused_occupancy(dtype: torch.dtype, c: Constants, resident: bool, nlev: int) -> Dict[str, int]:
    """What the card makes of the fused kernel's instantiation at ``nlev``
    levels: ``block``, ``blocks_per_sm``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), ``threads_per_sm``,
    ``registers`` and ``local_bytes`` a thread (``cudaFuncGetAttributes``),
    ``shared_bytes`` a block (the level table, then the ring) and
    ``levels_in_shared``.  Raises ``RuntimeError`` where the card's blocks
    per SM or shared bytes are not :func:`fused_plan`'s at ``nlev`` levels
    and the card's registers (which the depth does not change: the stack is
    in device memory).  Needs the card; the answers are kept per
    instantiation and depth."""
    switches = fused_switches(dtype, c, resident)
    per_sm, registers, local, shared = _occupancy(switches, nlev)
    plan = fused_plan(nlev, 1, dtype, bool(switches[1]), resident, registers)
    got = {"block": FUSED_BLOCK, "blocks_per_sm": per_sm, "threads_per_sm": FUSED_BLOCK * per_sm,
           "registers": registers, "local_bytes": local, "shared_bytes": shared, "levels_in_shared": 0}
    if (per_sm, shared) != (plan["blocks_per_sm"], plan["shared_bytes"]):
        raise RuntimeError(f"the card holds the fused AD kernel otherwise than its plan: {got} against {plan}")
    return got


def cloudsc2_ad_fused_host(
    state: Dict[str, Tensor], dt: float, c: Constants, resident: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """The fused kernel's bodies compiled for the host, on CPU tensors
    (tests only): the kernel's scratch layout and index function, the
    scratch NaN before the call, every column's forward sweep before any
    reverse sweep."""
    return _run_fused("cloudsc2_ad_fused_host", state, dt, c, resident)
