# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The CLOUDSC2 tangent-linear kernel for Hopper and its wrapper.

Replaces the Pallas kernel :func:`cloudsc2_tpu.pallas.tangent_linear.
cloudsc2_tl_pallas` (``pallas/tangent_linear.py:69``), on the level-scan
harness ``csrc/levelscan.cuh``.  The kernel is CUDA C++
(``csrc/tangent_linear.cu`` over ``csrc/tl_level.h``): one thread per
column, the carry and its perturbation in registers, the levels in a loop.
It is bound by device-memory bytes, with registers the risk; the note at
the top of ``tangent_linear.cu`` gives the count.  It takes the
``FAST_DIV`` divide modes (float32; float64 divides exactly) and both
``CUADJ_COMPACT`` forms of the saturation adjustment, as the Pallas kernel
does through its level body; each form is a library of its own
(:func:`cloudsc2_tpu_torch.kernels.build.form`).  Each block derives
``scalm`` from ``eta`` once, into shared memory (``levelscan.cuh`` "level
table"), so the wrapper does not compute it.

:func:`cloudsc2_tl_cuda` launches it on CUDA tensors and raises for
anything else; its plain version is
:func:`cloudsc2_tpu_torch.physics.tangent_linear.cloudsc2_tl`.
:func:`cloudsc2_tl_host` runs the same body compiled for the CPU, for the
tests only.  The wrapper works out each configuration's launch once, a
:class:`~cloudsc2_tpu_torch.kernels.nonlinear.LaunchPlan` cached by value
(:func:`_tl_plan`: the entry, dtype, shape, constants, ``dt`` by value and
type, ``tangent_only``), as the NL and AD wrappers do, and every call after
the lookup is one compiled call that checks the state, allocates the
outputs and launches.  While a profiler runs, each call records the root
span ``tl`` and its stages (:mod:`cloudsc2_tpu_torch.utils.timing`):
``plan``, then ``check``, ``alloc``, ``check`` and ``launch``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.kernels import build
from cloudsc2_tpu_torch.kernels.nonlinear import (
    NL_INPUTS,
    STEP_OUTPUTS,
    LaunchPlan,
    cached,
    check_layout,
    count_launch,
    div_switch,
    layout,
)
from cloudsc2_tpu_torch.physics.nonlinear import check_constants
from cloudsc2_tpu_torch.state import TL_CONST_NAMES, tl_kernel_constants
from cloudsc2_tpu_torch.utils.timing import PROFILER, close_span, open_span

Tensor = torch.Tensor

#: argument orders of ``CLOUDSC2_TL_INPUTS`` / ``_OUTPUTS`` in ``tl_level.h``:
#: the NL lists, then the perturbation of each field and output
TL_INPUTS = NL_INPUTS[:-1] + tuple(n + "_i" for n in NL_INPUTS[:-1]) + NL_INPUTS[-1:]
TL_OUTPUTS = STEP_OUTPUTS + tuple(n + "_i" for n in STEP_OUTPUTS)
_IFACE = ("aph", "aph_i") + tuple(
    n + s for n in ("fplsl", "fplsn", "fhpsl", "fhpsn") for s in ("", "_i")
)

_P = ctypes.c_void_p
_ARGS = [ctypes.c_int] * 6 + [_P, _P, _P, ctypes.c_int, ctypes.c_int]


def signature() -> str:
    """The argument lists the Python side passes, in the form the kernel
    library reports them (``tl_signature`` in ``tl_level.h``)."""
    return "".join((
        "consts:", *(n + "," for n in TL_CONST_NAMES),
        ";inputs:", *(n + "," for n in TL_INPUTS),
        ";outputs:", *(n + "," for n in TL_OUTPUTS),
    ))


@functools.lru_cache(maxsize=None)
def _load(kind: str, compact: bool = True, fast: bool = False) -> ctypes.CDLL:
    suffix, defines = build.form(compact, fast)
    if kind == "cuda":
        lib = build.load("cuda", "cloudsc2_tl" + suffix, ["tangent_linear.cu"], defines)
        fn = lib.cloudsc2_tl_launch
        fn.argtypes = _ARGS + [_P]
    else:
        lib = build.load("host", "cloudsc2_tl_host" + suffix, ["tangent_linear_host.cpp"], defines)
        fn = lib.cloudsc2_tl_host
        fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    lib.cloudsc2_tl_signature.restype = ctypes.c_char_p
    got = lib.cloudsc2_tl_signature().decode()
    if got != signature():
        raise RuntimeError(f"kernel argument lists differ from the wrapper's:\n{got}\n{signature()}")
    return lib


def load_cuda(compact: bool = True, fast: bool = False) -> ctypes.CDLL:
    """Build (first use) and load the CUDA library of one form
    (:func:`cloudsc2_tpu_torch.kernels.build.form`)."""
    return _load("cuda", compact, fast)


def tl_switches(c: Constants, dtype: torch.dtype, tangent_only: bool) -> Tuple[int, ...]:
    """The kernel's int switches for constants ``c``, a dtype and
    ``tangent_only``: ``is_double``, ``evap``, ``lregcl``,
    ``tangent_only``, ``div``, ``compact``."""
    return (int(dtype == torch.float64), int(bool(c.LEVAPLS2 or c.LDRAIN1D)), int(bool(c.LREGCL)),
            int(tangent_only), div_switch(c, dtype), int(bool(c.CUADJ_COMPACT)))


@functools.lru_cache(maxsize=64, typed=True)
def _tl_plan(entry: str, dtype: torch.dtype, shape: Tuple[int, ...], c: Constants, dt: float,
             tangent_only: bool) -> LaunchPlan:
    """The plan of one TL launch through ``entry`` (``"cuda"``, or the host
    build's ``"cloudsc2_tl_host"`` on the CPU) at ``shape``, ``(nlev,
    ncols)``: the C entry of the form's library, the switches, the constant
    struct and the outputs written (the ``*_i`` alone with
    ``tangent_only``)."""
    check_layout(dtype, shape)
    switches = tl_switches(c, dtype, tangent_only)
    on_card = entry == "cuda"
    lib = _load("cuda" if on_card else "host", bool(c.CUADJ_COMPACT), switches[4] != 0)
    if on_card:
        fn, failure = lib.cloudsc2_tl_launch, "cloudsc2_tl kernel launch failed: cudaError_t {}"
    else:
        fn, failure = getattr(lib, entry), "cloudsc2_tl host body failed: {}"
    written = tuple(n for n in TL_OUTPUTS if not tangent_only or n.endswith("_i"))
    return LaunchPlan.make(fn, on_card, failure, switches, torch.from_numpy(tl_kernel_constants(c, dt, dtype)),
                           TL_INPUTS, TL_OUTPUTS, written, _IFACE, dtype, *shape)


def _run_tl(entry: str, state: Dict[str, Tensor], dt: float, c: Constants,
            tangent_only: bool) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One TL call through ``entry`` (``"cuda"``: the kernel on PyTorch's
    current stream; ``"cloudsc2_tl_host"``: the host build): the constants
    checked, the plan looked up by the state's ``ap`` (the span ``plan``),
    then the launch by its plan (:meth:`~cloudsc2_tpu_torch.kernels.
    nonlinear.LaunchPlan.run`, which checks the state), the root span
    ``tl`` while a profiler runs."""
    k = open_span("tl") if PROFILER._is_profiler_enabled else None
    try:
        s = open_span("plan") if k else None
        check_constants(c)
        plan = cached(_tl_plan, dt)(entry, *layout(state, entry), c, dt, bool(tangent_only))
        if s:
            close_span(s)
        outs, _ = plan.run(state)
        if entry == "cuda":
            count_launch(cloudsc2_tl_cuda, plan.switches)
        return _assemble(outs)
    finally:
        if k:
            close_span(k)


def _assemble(outs: Dict[str, Optional[Tensor]]) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """``(tendencies, diagnostics)`` as :func:`cloudsc2_tpu_torch.physics.
    tangent_linear.cloudsc2_tl` returns them."""
    named = {n: v for n, v in outs.items() if v is not None}
    tends = {k[4:]: v for k, v in named.items() if k.startswith("tnd_")}
    diags = {k: v for k, v in named.items() if not k.startswith("tnd_")}
    return tends, diags


def cloudsc2_tl_cuda(
    state: Dict[str, Tensor], dt: float, c: Constants, tangent_only: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One TL step through the CUDA kernel, on PyTorch's current stream.

    Same contract as :func:`cloudsc2_tpu_torch.physics.tangent_linear.
    cloudsc2_tl`: contiguous CUDA tensors of one float dtype, any
    ``ncols``; with ``tangent_only`` only the ``*_i`` outputs are written
    and returned.  ``c.FAST_DIV`` and ``c.CUADJ_COMPACT`` pick the form.
    Raises on anything else, on a failed build and on a
    refused launch; never falls back to the plain version.  Each launch
    adds one to ``cloudsc2_tl_cuda.launches`` (and by its form, see
    :func:`cloudsc2_tpu_torch.kernels.nonlinear.count_launch`).
    """
    return _run_tl("cuda", state, dt, c, tangent_only)


cloudsc2_tl_cuda.launches = 0  # type: ignore[attr-defined]
cloudsc2_tl_cuda.fast_div_launches = 0  # type: ignore[attr-defined]
cloudsc2_tl_cuda.ref_launches = 0  # type: ignore[attr-defined]


def cloudsc2_tl_host(
    state: Dict[str, Tensor], dt: float, c: Constants, tangent_only: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """The kernel's body compiled for the host, on CPU tensors (tests only)."""
    return _run_tl("cloudsc2_tl_host", state, dt, c, tangent_only)
