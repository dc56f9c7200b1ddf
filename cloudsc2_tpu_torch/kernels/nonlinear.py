# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The CLOUDSC2 nonlinear kernel for Hopper and its wrapper.

Replaces the Pallas kernel :func:`cloudsc2_tpu.pallas.nonlinear.
cloudsc2_nl_pallas` (``pallas/nonlinear.py:76``), its ``with_trajectory``
form (``:214-226``, the adjoint's forward sweep) and its ``traj_only`` form
(``:367-392,458``, the forward sweep of a gradient-only adjoint) included,
and, for it, the level-scan harness ``level_scan_pallas``
(``pallas/levelscan.py:402``).  The kernel is CUDA C++
(``csrc/nonlinear.cu`` over ``csrc/nl_level.h`` and ``csrc/levelscan.cuh``):
one thread per column, the carry in registers, the levels in a loop.  It is
bound by device-memory bytes; the note at the top of ``nonlinear.cu`` gives
the count and what the design does about it.

:func:`cloudsc2_nl_cuda` launches it on CUDA tensors and raises for
anything else; its plain version is
:func:`cloudsc2_tpu_torch.physics.nonlinear.cloudsc2_nl`.
:func:`cloudsc2_nl_host` runs the same body compiled for the CPU, for the
tests only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.kernels import build
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
#: (the step's outputs, then the trajectory of ``with_trajectory``)
STEP_OUTPUTS = (
    "tnd_t", "tnd_q", "tnd_ql", "tnd_qi", "clc", "covptot", "fplsl", "fplsn",
    "fhpsl", "fhpsn",
)
NL_OUTPUTS = STEP_OUTPUTS + TRAJ_OUTPUTS
_IFACE = ("aph", "fplsl", "fplsn", "fhpsl", "fhpsn")
_VERT = ("eta", "scalm")
_DTYPES = (torch.float32, torch.float64)

_P = ctypes.c_void_p
_ARGS = [ctypes.c_int] * 4 + [_P, _P, _P, ctypes.c_int, ctypes.c_int]


def signature() -> str:
    """The argument lists the Python side passes, in the form the kernel
    library reports them (``nl_signature`` in ``nl_level.h``)."""
    return "".join((
        "consts:", *(n + "," for n in NL_CONST_NAMES),
        ";inputs:", *(n + "," for n in NL_INPUTS),
        ";outputs:", *(n + "," for n in NL_OUTPUTS),
    ))


@functools.lru_cache(maxsize=None)
def _load(kind: str) -> ctypes.CDLL:
    if kind == "cuda":
        lib = build.load("cuda", "cloudsc2_nl", ["nonlinear.cu"])
        fn = lib.cloudsc2_nl_launch
        fn.argtypes = _ARGS + [_P]
    else:
        lib = build.load("host", "cloudsc2_nl_host", ["nonlinear_host.cpp"])
        fn = lib.cloudsc2_nl_host
        fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    lib.cloudsc2_nl_signature.restype = ctypes.c_char_p
    got = lib.cloudsc2_nl_signature().decode()
    if got != signature():
        raise RuntimeError(f"kernel argument lists differ from the wrapper's:\n{got}\n{signature()}")
    return lib


def load_cuda() -> ctypes.CDLL:
    """Build (first use) and load the CUDA library."""
    return _load("cuda")


def check_inputs(
    state: Dict[str, Tensor], c: Constants, device_type: str, inputs: Sequence[str],
    iface: Sequence[str],
) -> Tuple[List[Tensor], torch.dtype]:
    """Check the state for a kernel, and return its ``inputs`` in order:
    ``eta`` in the state's dtype and ``scalm`` computed from it, the other
    fields as they are.  Fields named in ``iface`` are ``(nlev + 1, ncols)``,
    ``eta``/``scalm`` ``(nlev,)``, the rest ``(nlev, ncols)``; all of one
    float dtype, contiguous, on one device of ``device_type``."""
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
    traj_only: bool,
) -> Tuple[List[Tensor], Dict[str, Tensor], Tensor, torch.dtype]:
    """Check the options and the state, and return the kernel's inputs in
    order, freshly allocated outputs (``None`` for one not written), the
    constant struct and the dtype."""
    if traj_only and not with_trajectory:
        raise ValueError("traj_only requires with_trajectory=True")
    ins, dtype = check_inputs(state, c, device_type, NL_INPUTS, _IFACE)
    nlev, ncols = state["ap"].shape
    written = trajectory_names(c) if with_trajectory else ()
    if not traj_only:
        written = STEP_OUTPUTS + written
    outs = {
        n: None if n not in written else torch.empty(
            (nlev + 1, ncols) if n in _IFACE else (nlev, ncols), dtype=dtype, device=state["ap"].device
        )
        for n in NL_OUTPUTS
    }
    consts = torch.from_numpy(kernel_constants(c, dt, dtype))
    return ins, outs, consts, dtype


def ptrs(tensors) -> ctypes.Array:
    """A C array of the tensors' data pointers (``None`` gives a null pointer)."""
    return (_P * len(tensors))(*(None if t is None else t.data_ptr() for t in tensors))


def _switches(
    c: Constants, dtype: torch.dtype, with_trajectory: bool, traj_only: bool
) -> Tuple[int, int, int, int]:
    return (
        int(dtype == torch.float64),
        int(bool(c.LPHYLIN or c.LDRAIN1D)),
        int(bool(c.LEVAPLS2 or c.LDRAIN1D)),
        2 if traj_only else int(with_trajectory),
    )


def _assemble(outs: Dict[str, Tensor], with_trajectory: bool, traj_only: bool):
    traj = {n: outs[n] for n in TRAJ_OUTPUTS if outs[n] is not None}
    if traj_only:
        return {}, {}, traj
    tends = {"t": outs["tnd_t"], "q": outs["tnd_q"], "ql": outs["tnd_ql"], "qi": outs["tnd_qi"]}
    diags = {n: outs[n] for n in ("clc", "covptot", "fplsl", "fplsn", "fhpsl", "fhpsn")}
    if not with_trajectory:
        return tends, diags
    return tends, diags, traj


def cloudsc2_nl_cuda(
    state: Dict[str, Tensor], dt: float, c: Constants, with_trajectory: bool = False,
    traj_only: bool = False,
):
    """One NL step through the CUDA kernel, on PyTorch's current stream.

    Same contract as :func:`cloudsc2_tpu_torch.physics.nonlinear.
    cloudsc2_nl`: contiguous CUDA tensors of one float dtype, any
    ``ncols``; ``(tendencies, diagnostics)``, and with ``with_trajectory``
    the trajectory dict as a third element.  ``traj_only`` (which requires
    ``with_trajectory``, ``ValueError`` otherwise) writes the trajectory
    alone and returns ``({}, {}, trajectory)``.  Raises on anything else, on
    a failed build and on a refused launch; never falls back to the plain
    version.  Each launch adds one to ``cloudsc2_nl_cuda.launches``.
    """
    ins, outs, consts, dtype = _marshal(state, dt, c, "cuda", with_trajectory, traj_only)
    lib = load_cuda()
    nlev, ncols = state["ap"].shape
    with torch.cuda.device(state["ap"].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cloudsc2_nl_launch(
            *_switches(c, dtype, with_trajectory, traj_only), ptrs(ins), ptrs(list(outs.values())),
            consts.data_ptr(), nlev, ncols, stream,
        )
    if err != 0:
        raise RuntimeError(f"cloudsc2_nl kernel launch failed: cudaError_t {err}")
    cloudsc2_nl_cuda.launches += 1
    return _assemble(outs, with_trajectory, traj_only)


cloudsc2_nl_cuda.launches = 0  # type: ignore[attr-defined]


def cloudsc2_nl_host(
    state: Dict[str, Tensor], dt: float, c: Constants, with_trajectory: bool = False,
    traj_only: bool = False,
):
    """The kernel's body compiled for the host, on CPU tensors (tests only)."""
    ins, outs, consts, dtype = _marshal(state, dt, c, "cpu", with_trajectory, traj_only)
    lib = _load("host")
    nlev, ncols = state["ap"].shape
    err = lib.cloudsc2_nl_host(
        *_switches(c, dtype, with_trajectory, traj_only), ptrs(ins), ptrs(list(outs.values())),
        consts.data_ptr(), nlev, ncols,
    )
    if err != 0:
        raise RuntimeError(f"cloudsc2_nl host body failed: {err}")
    return _assemble(outs, with_trajectory, traj_only)

