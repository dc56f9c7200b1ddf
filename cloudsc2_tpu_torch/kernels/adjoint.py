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
2. the reverse sweep (``csrc/adjoint.cu`` over ``csrc/ad_level.h`` and the
   reverse form of ``csrc/levelscan.cuh``): one thread per column runs the
   levels bottom-up and applies the transpose of the TL level, built from
   its Jacobian columns, around the stored carry; it folds the raw fields
   and seeds and writes the 16 assembled input cotangents itself.

Its bound is set by bytes; this design's own operations (12-14 TL levels
per level) set its time, as the note at the top of ``adjoint.cu`` counts.
As the Pallas kernel, it
requires ``LPHYLIN=True``; unlike it, it takes f32 and f64 and any column
count.

It also replaces :func:`cloudsc2_tpu.pallas.adjoint.cloudsc2_ad_pallas_fused`
(``pallas/adjoint.py:432``) and its harness ``level_scan_fwdrev_pallas``
(``pallas/levelscan.py:87``) with one kernel (``csrc/ad_fused.cu`` over
``csrc/ad_fused.h`` and the fused form of ``csrc/levelscan.cuh``): the same
two sweeps in one launch, the trajectory (and with ``resident`` the folded
level inputs) on a stack in shared memory.  :func:`fused_plan` sizes its
blocks to that stack.

:func:`cloudsc2_ad_cuda` and :func:`cloudsc2_ad_fused_cuda` launch on CUDA
tensors and raise for anything else; the plain version of both is
:func:`cloudsc2_tpu_torch.physics.adjoint.cloudsc2_ad`.
:func:`cloudsc2_ad_host` and :func:`cloudsc2_ad_fused_host` run the same
bodies compiled for the CPU, for the tests only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from cloudsc2_tpu_torch.kernels import build
from cloudsc2_tpu_torch.kernels.nonlinear import (
    NL_INPUTS,
    STEP_OUTPUTS,
    check_inputs,
    cloudsc2_nl_cuda,
    cloudsc2_nl_host,
    ptrs,
)
from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.physics.adjoint import AD_COTANGENT_FIELDS, AD_DIAGNOSTICS, AD_TENDENCIES
from cloudsc2_tpu_torch.physics.nonlinear import TRAJ_OUTPUTS
from cloudsc2_tpu_torch.state import NL_CONST_NAMES, TL_CONST_NAMES, kernel_constants, tl_kernel_constants

Tensor = torch.Tensor

#: the output cotangent seeds the reverse kernel reads
AD_SEEDS = (
    "tnd_t_i", "tnd_q_i", "tnd_ql_i", "tnd_qi_i", "clc_i", "covptot_i",
    "fplsl_i", "fplsn_i", "fhpsl_i", "fhpsn_i",
)
#: argument orders of ``CLOUDSC2_AD_INPUTS`` / ``_OUTPUTS`` in ``ad_level.h``
AD_INPUTS = NL_INPUTS[:-2] + AD_SEEDS + TRAJ_OUTPUTS + NL_INPUTS[-2:]
AD_OUTPUTS = tuple("cml_" + n + "_i" for n in AD_TENDENCIES) + (
    "ap_i", "aph_i", "t_i", "q_i", "qsat_i", "ql_i", "qi_i", "lu_i", "lude_i",
    "mfd_i", "mfu_i", "supsat_i",
)
#: argument orders of ``CLOUDSC2_AD_FUSED_INPUTS`` / ``_OUTPUTS`` in ``ad_fused.h``
AD_FUSED_INPUTS = NL_INPUTS[:-2] + AD_SEEDS + NL_INPUTS[-2:]
AD_FUSED_OUTPUTS = STEP_OUTPUTS + AD_OUTPUTS
#: the folded level inputs the fused kernel's resident form keeps on its
#: stack (``FWD_INPUTS``, ``pallas/adjoint.py:98``)
AD_FUSED_RESIDENT = ("ap", "dp", "lu_next", "lude", "mf", "q2", "ql_fg", "qi_fg", "qsat", "t_fg")
_IFACE = ("aph", "aph_i", "fplsl_i", "fplsn_i", "fhpsl_i", "fhpsn_i", "fplsl", "fplsn", "fhpsl", "fhpsn")
#: read only with the evaporation branch (may be absent otherwise)
_EVAP_ONLY = ("c_cov", "covptot_i")
#: dynamic shared memory one block may opt in to on sm_90 (227 KB)
MAX_SHARED_BYTES = 232_448
#: the fused kernel's block sizes, largest first (``kMaxThreads`` in ``ad_fused.cu``)
FUSED_BLOCKS = (128, 64, 32, 16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I] * 3 + [_P, _P, _P, _I, _I]
_FUSED_ARGS = [_I] * 4 + [_P] * 4 + [_I, _I]


def _names(*groups) -> str:
    return "".join(f"{label}:" + "".join(n + "," for n in names) for label, names in groups)


def signature() -> str:
    """The argument lists the Python side passes, in the form the kernel
    library reports them (``ad_signature`` in ``ad_level.h``)."""
    return _names(("consts", TL_CONST_NAMES), (";inputs", AD_INPUTS), (";outputs", AD_OUTPUTS))


def fused_signature() -> str:
    """The same for the fused kernel (``ad_fused_signature`` in ``ad_fused.h``)."""
    return _names(
        ("nl_consts", NL_CONST_NAMES), (";tl_consts", TL_CONST_NAMES), (";inputs", AD_FUSED_INPUTS),
        (";outputs", AD_FUSED_OUTPUTS), (";resident", AD_FUSED_RESIDENT),
    )


#: library name, source, C entry and its arguments, by (kind, form)
_LIBRARIES = {
    ("cuda", "ad"): ("cloudsc2_ad", "adjoint.cu", "cloudsc2_ad_launch", _ARGS + [_P]),
    ("host", "ad"): ("cloudsc2_ad_host", "adjoint_host.cpp", "cloudsc2_ad_host", _ARGS),
    ("cuda", "ad_fused"): ("cloudsc2_ad_fused", "ad_fused.cu", "cloudsc2_ad_fused_launch",
                           [_I] + _FUSED_ARGS + [_P]),
    ("host", "ad_fused"): ("cloudsc2_ad_fused_host", "ad_fused_host.cpp", "cloudsc2_ad_fused_host",
                           _FUSED_ARGS),
}


@functools.lru_cache(maxsize=None)
def _load(kind: str, form: str = "ad") -> ctypes.CDLL:
    name, source, entry, argtypes = _LIBRARIES[kind, form]
    lib = build.load(kind, name, [source])
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    if kind == "cuda" and form == "ad_fused":
        lib.cloudsc2_ad_fused_occupancy.argtypes = [_I] * 6 + [_P]
        lib.cloudsc2_ad_fused_occupancy.restype = ctypes.c_int
    sig = getattr(lib, f"cloudsc2_{form}_signature")
    sig.restype = ctypes.c_char_p
    got, want = sig().decode(), (signature() if form == "ad" else fused_signature())
    if got != want:
        raise RuntimeError(f"kernel argument lists differ from the wrapper's:\n{got}\n{want}")
    return lib


def load_cuda() -> ctypes.CDLL:
    """Build (first use) and load the CUDA library of the two-kernel AD's
    reverse kernel."""
    return _load("cuda")


def load_fused_cuda() -> ctypes.CDLL:
    """Build (first use) and load the CUDA library of the fused AD kernel."""
    return _load("cuda", "ad_fused")


def check_lphylin(c: Constants) -> None:
    """The kernels' forward sweep is the NL step, whose trajectory is the
    TL's forward only under linearized physics."""
    if not c.LPHYLIN:
        raise ValueError(
            "the AD kernels require LPHYLIN=True (their forward sweep is the NL "
            "step, whose trajectory is the TL forward only under linearized physics)"
        )


def _marshal(state: Dict[str, Tensor], c: Constants, device_type: str, inputs: Tuple[str, ...],
             outputs: Tuple[str, ...]) -> Tuple[list, list, torch.dtype]:
    """Check the state for a kernel, and return its ``inputs`` in order
    (``None`` for one it does not read) and fresh ``outputs``."""
    evap = bool(c.LEVAPLS2 or c.LDRAIN1D)
    names = [n for n in inputs if evap or n not in _EVAP_ONLY]
    ins, dtype = check_inputs(state, c, device_type, names, _IFACE)
    by_name = dict(zip(names, ins))
    nlev, ncols = state["ap"].shape
    outs = [
        torch.empty((nlev + 1, ncols) if n in _IFACE else (nlev, ncols), dtype=dtype,
                    device=state["ap"].device)
        for n in outputs
    ]
    return [by_name.get(n) for n in inputs], outs, dtype


def _reverse(state: Dict[str, Tensor], traj: Dict[str, Tensor], dt: float, c: Constants,
             device_type: str) -> Tuple[list, list, Tensor, Tuple[int, int, int]]:
    """Check the state, the seeds and the trajectory, and return the reverse
    kernel's inputs in order (``None`` for one it does not read), fresh
    outputs, the constant struct and the switches."""
    ins, outs, dtype = _marshal({**state, **traj}, c, device_type, AD_INPUTS, AD_OUTPUTS)
    consts = torch.from_numpy(tl_kernel_constants(c, dt, dtype))
    switches = (int(dtype == torch.float64), int(bool(c.LEVAPLS2 or c.LDRAIN1D)), int(bool(c.LREGCL)))
    return ins, outs, consts, switches


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
    the forward trajectory ``traj``.  Each launch adds one to
    ``cloudsc2_ad_cuda.launches``."""
    check_lphylin(c)
    ins, outs, consts, switches = _reverse(state, traj, dt, c, "cuda")
    lib = load_cuda()
    nlev, ncols = state["ap"].shape
    with torch.cuda.device(state["ap"].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cloudsc2_ad_launch(*switches, ptrs(ins), ptrs(outs), consts.data_ptr(), nlev, ncols, stream)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad kernel launch failed: cudaError_t {err}")
    cloudsc2_ad_cuda.launches += 1
    return dict(zip(AD_OUTPUTS, outs))


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
    ``ncols``.  Raises ``ValueError`` with ``LPHYLIN=False``, and raises on
    anything else the kernels do not take, on a failed build and on a
    refused launch; never falls back to the plain version.
    """
    check_lphylin(c)
    tends, diags, traj = cloudsc2_nl_cuda(state, dt, c, with_trajectory=True, traj_only=cotangent_only)
    return _assemble(tends, diags, cloudsc2_ad_reverse_cuda(state, traj, dt, c))


cloudsc2_ad_cuda.launches = 0  # type: ignore[attr-defined]


def cloudsc2_ad_host(
    state: Dict[str, Tensor], dt: float, c: Constants, cotangent_only: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """The kernels' bodies compiled for the host, on CPU tensors (tests
    only): the host NL body with its trajectory, then the reverse body."""
    check_lphylin(c)
    tends, diags, traj = cloudsc2_nl_host(state, dt, c, with_trajectory=True, traj_only=cotangent_only)
    ins, outs, consts, switches = _reverse(state, traj, dt, c, "cpu")
    lib = _load("host")
    nlev, ncols = state["ap"].shape
    err = lib.cloudsc2_ad_host(*switches, ptrs(ins), ptrs(outs), consts.data_ptr(), nlev, ncols)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad host body failed: {err}")
    return _assemble(tends, diags, dict(zip(AD_OUTPUTS, outs)))


# ---- the fused kernel (cloudsc2_ad_pallas_fused)


def fused_stack_slots(evap: bool, resident: bool) -> int:
    """Values a thread pushes per level: the trajectory (c_rfl, c_sfl, and
    c_cov with evaporation), and with ``resident`` the folded level inputs
    (``ADFusedSlots`` in ``ad_fused.h``)."""
    return (3 if evap else 2) + (len(AD_FUSED_RESIDENT) if resident else 0)


def fused_plan(nlev: int, dtype: torch.dtype, evap: bool, resident: bool) -> Tuple[int, int]:
    """``(threads a block, shared bytes a block)`` for the fused kernel: the
    largest block of ``FUSED_BLOCKS`` whose stacks fit in
    ``MAX_SHARED_BYTES``.  At 137 levels that is 128 threads in f32 and 64
    in f64, resident 32 and 16.  Raises ``ValueError``, naming the bytes,
    where not even 16 threads fit."""
    item = torch.empty((), dtype=dtype).element_size()
    slots = fused_stack_slots(evap, resident)
    per_thread = slots * nlev * item
    for block in FUSED_BLOCKS:
        if block * per_thread <= MAX_SHARED_BYTES:
            return block, block * per_thread
    raise ValueError(
        f"the fused AD kernel's stack does not fit: {slots} values x {nlev} levels x {item} B = "
        f"{per_thread} B a thread, {FUSED_BLOCKS[-1] * per_thread} B for {FUSED_BLOCKS[-1]} threads, "
        f"above the {MAX_SHARED_BYTES} B of shared memory a block may hold"
    )


def _fused(state: Dict[str, Tensor], dt: float, c: Constants, resident: bool,
           device_type: str) -> Tuple[list, list, Tensor, Tensor, Tuple[int, int, int, int]]:
    """Check the options and the state, and return the fused kernel's inputs
    in order, fresh outputs, the NL and TL constant structs and the
    switches."""
    check_lphylin(c)
    ins, outs, dtype = _marshal(state, c, device_type, AD_FUSED_INPUTS, AD_FUSED_OUTPUTS)
    nl_consts = torch.from_numpy(kernel_constants(c, dt, dtype))
    tl_consts = torch.from_numpy(tl_kernel_constants(c, dt, dtype))
    switches = (int(dtype == torch.float64), int(bool(c.LEVAPLS2 or c.LDRAIN1D)), int(bool(c.LREGCL)),
                int(resident))
    return ins, outs, nl_consts, tl_consts, switches


def _assemble_fused(outs: list) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    named = dict(zip(AD_FUSED_OUTPUTS, outs))
    tends = {n: named["tnd_" + n] for n in AD_TENDENCIES}
    return _assemble(tends, {n: named[n] for n in AD_DIAGNOSTICS}, named)


def cloudsc2_ad_fused_cuda(
    state: Dict[str, Tensor], dt: float, c: Constants, resident: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One AD step through the fused CUDA kernel, on PyTorch's current
    stream: both sweeps in one launch, with the block size of
    :func:`fused_plan`.  Each launch adds one to
    ``cloudsc2_ad_fused_cuda.launches``.

    Same contract and outputs as :func:`cloudsc2_ad_cuda`.  ``resident``
    keeps the folded level inputs on the kernel's stack too.  Raises
    ``ValueError`` with ``LPHYLIN=False`` and where the stack does not fit
    (before anything is launched), and raises on anything else the kernel
    does not take, on a failed build and on a refused launch; never falls
    back to the plain version or to the two-kernel AD.
    """
    ins, outs, nl_consts, tl_consts, switches = _fused(state, dt, c, resident, "cuda")
    nlev, ncols = state["ap"].shape
    block, _ = fused_plan(nlev, outs[0].dtype, bool(switches[1]), resident)
    lib = load_fused_cuda()
    with torch.cuda.device(state["ap"].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cloudsc2_ad_fused_launch(*switches, block, ptrs(ins), ptrs(outs), nl_consts.data_ptr(),
                                           tl_consts.data_ptr(), nlev, ncols, stream)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad_fused kernel launch failed: cudaError_t {err}")
    cloudsc2_ad_fused_cuda.launches += 1
    return _assemble_fused(outs)


cloudsc2_ad_fused_cuda.launches = 0  # type: ignore[attr-defined]


def fused_occupancy(dtype: torch.dtype, c: Constants, resident: bool, nlev: int) -> Dict[str, int]:
    """What the card makes of the fused kernel at :func:`fused_plan`'s block
    size: ``block``, ``blocks_per_sm``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), ``registers`` and
    ``local_bytes`` a thread, ``shared_bytes`` a block.  Needs the card."""
    evap = bool(c.LEVAPLS2 or c.LDRAIN1D)
    block, _ = fused_plan(nlev, dtype, evap, resident)
    out = (ctypes.c_int * 4)()
    err = load_fused_cuda().cloudsc2_ad_fused_occupancy(
        int(dtype == torch.float64), int(evap), int(bool(c.LREGCL)), int(resident), block, nlev, out)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad_fused occupancy query failed: cudaError_t {err}")
    return dict(zip(("block", "blocks_per_sm", "registers", "local_bytes", "shared_bytes"), (block, *out)))


def cloudsc2_ad_fused_host(
    state: Dict[str, Tensor], dt: float, c: Constants, resident: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """The fused kernel's bodies compiled for the host, on CPU tensors
    (tests only), one column's stack at a time."""
    ins, outs, nl_consts, tl_consts, switches = _fused(state, dt, c, resident, "cpu")
    nlev, ncols = state["ap"].shape
    err = _load("host", "ad_fused").cloudsc2_ad_fused_host(
        *switches, ptrs(ins), ptrs(outs), nl_consts.data_ptr(), tl_consts.data_ptr(), nlev, ncols)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad_fused host body failed: {err}")
    return _assemble_fused(outs)
