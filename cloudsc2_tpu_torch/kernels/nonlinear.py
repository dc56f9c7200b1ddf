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
refuses outputs that overlap an input (:func:`check_disjoint`).  Each
block derives ``scalm`` from ``eta`` once, into shared memory before its
ring (``levelscan.cuh`` "level table", ``nl_level.h`` ``ScalmTable``), so
no wrapper computes it.  The wrapper works out the launch of each
configuration once, a :class:`LaunchPlan` cached by value
(:func:`_nl_plan`), and every call after the lookup is one compiled call
(``launcher/launcher.cpp``): the checks on the state, the outputs'
allocation, the overlap check and the C entry.  The TL kernel and both AD
forms launch the same way.  While a profiler runs, each
call records a root span and its stages
(:mod:`cloudsc2_tpu_torch.utils.timing`): ``plan``, then ``check``,
``alloc``, ``check`` and ``launch``, stamped inside the compiled call.
The note at the top of ``nonlinear.cu`` gives what bounds the kernel,
before and after, and why the ring needs no block synchronisation.

:func:`cloudsc2_nl_cuda` launches it on CUDA tensors and raises for
anything else; its plain version is
:func:`cloudsc2_tpu_torch.physics.nonlinear.cloudsc2_nl`.
:func:`occupancy` reports what the card makes of a form's kernel
(registers, blocks per SM, ring depth, shared bytes) at a column count,
and :func:`carveout_blocks` is the rule that sizes a float32 launch's
shared-memory carveout by its grid.
:func:`cloudsc2_nl_host` runs the same body and harness compiled for the
CPU, for the tests only, and :func:`cloudsc2_nl_direct_host` the body
through the direct scan, the harness's reference.  :func:`rcp_cuda` /
:func:`rcp_host` run the divide policies' reciprocal alone, and
:func:`scalm_cuda` / :func:`scalm_host` the kernels' derivation of
``scalm``, for the checks.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.kernels import build
from cloudsc2_tpu_torch.physics.fastmath import DIV_MODES
from cloudsc2_tpu_torch.physics.nonlinear import TRAJ_OUTPUTS, check_constants, trajectory_names
from cloudsc2_tpu_torch.state import NL_CONST_NAMES, kernel_constants
from cloudsc2_tpu_torch.utils.timing import PROFILER, close_span, open_span

Tensor = torch.Tensor

#: argument orders of ``CLOUDSC2_NL_INPUTS`` / ``_OUTPUTS`` in ``nl_level.h``
NL_INPUTS = (
    "ap", "aph", "lu", "lude", "mfd", "mfu", "q", "qi", "ql", "qsat", "supsat",
    "t", "tnd_cml_q", "tnd_cml_qi", "tnd_cml_ql", "tnd_cml_t", "eta",
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
_VERT = ("eta",)
#: the inputs of the fused form, which diagnoses ``qsat`` instead of reading it
_FUSED_INPUTS = tuple(None if n == "qsat" else n for n in NL_INPUTS)
_DTYPES = (torch.float32, torch.float64)
#: the types of ``dt`` whose launch plans are cached (by value and type)
_DT_TYPES = (float, int, np.float64, np.float32)

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
        fn, probe, scalm = lib.cloudsc2_nl_launch, lib.cloudsc2_rcp_probe, lib.cloudsc2_scalm_probe
        fn.argtypes = _ARGS + [_P]
        lib.cloudsc2_nl_occupancy.argtypes = [ctypes.c_int] * (len(NL_SWITCHES) + 2) + [_P]
        lib.cloudsc2_nl_occupancy.restype = ctypes.c_int
        probe.argtypes = [ctypes.c_int, _P, _P, ctypes.c_int, _P]
        scalm.argtypes = [ctypes.c_int, _P, _P, ctypes.c_int, _P, _P]
    else:
        lib = build.load(kind, "cloudsc2_nl_host" + suffix, ["nonlinear_host.cpp"], defines)
        fn, probe, scalm = lib.cloudsc2_nl_host, lib.cloudsc2_rcp_probe_host, lib.cloudsc2_scalm_probe_host
        fn.argtypes = lib.cloudsc2_nl_direct_host.argtypes = _ARGS
        lib.cloudsc2_nl_direct_host.restype = lib.cloudsc2_nl_ring_depth.restype = ctypes.c_int
        lib.cloudsc2_nl_ring_depth.argtypes = [ctypes.c_int]
        lib.cloudsc2_nl_carveout_blocks.argtypes = [ctypes.c_int] * 5
        lib.cloudsc2_nl_carveout_blocks.restype = ctypes.c_int
        probe.argtypes = [ctypes.c_int, _P, _P, ctypes.c_int]
        scalm.argtypes = [ctypes.c_int, _P, _P, ctypes.c_int, _P]
    fn.restype = probe.restype = scalm.restype = ctypes.c_int
    lib.cloudsc2_nl_signature.restype = ctypes.c_char_p
    got = lib.cloudsc2_nl_signature().decode()
    if got != signature():
        raise RuntimeError(f"kernel argument lists differ from the wrapper's:\n{got}\n{signature()}")
    return lib


def load_cuda(compact: bool = True) -> ctypes.CDLL:
    """Build (first use) and load the CUDA library of one saturation-
    adjustment form (``CUADJ_COMPACT``)."""
    return _load("cuda", compact)


def _shape(name: str, iface: Sequence[str], nlev: int, ncols: int) -> Tuple[int, ...]:
    """A field's shape, the one rule every launch's checks and allocations
    follow: ``(nlev + 1, ncols)`` for one named in ``iface``, ``(nlev,)``
    for ``eta``, else ``(nlev, ncols)``."""
    return (nlev,) if name in _VERT else ((nlev + 1, ncols) if name in iface else (nlev, ncols))


@dataclass(frozen=True, eq=False)
class LaunchPlan:
    """What a kernel wrapper works out once per launch configuration, the
    port's counterpart of ``jax.jit``'s cached dispatch
    (``cloudsc2_tpu/pallas/nonlinear.py:68-69``): the compiled launcher of
    the launch (``launcher/launcher.cpp``, built by
    :func:`cloudsc2_tpu_torch.kernels.build.launcher`), which holds the
    library's C entry, its int ``switches`` and the constant struct
    ``consts``, folded once, the kernel's inputs and outputs by name and
    their shapes (``shapes``: each output's, ``None`` where not written).
    Every NL, TL, AD reverse and fused AD launch runs through one: a plan
    lookup, then one compiled call (:meth:`run`).  ``wide``: an NL launch
    on the card whose shared-memory carveout is sized for more than four
    blocks an SM (:func:`occupancy`'s ``carveout_blocks``), counted in
    ``cloudsc2_nl_cuda.wide_launches``."""

    launcher: Any
    switches: Tuple[int, ...]
    consts: Tensor
    shapes: Tuple[Optional[Tuple[int, ...]], ...]
    wide: bool = False

    @classmethod
    def make(cls, fn: Callable[..., int], cuda: bool, failure: str, switches: Tuple[int, ...], consts: Tensor,
             inputs: Tuple[Optional[str], ...], outputs: Tuple[str, ...], written: Sequence[str],
             iface: Sequence[str], dtype: torch.dtype, nlev: int, ncols: int, scratch: int = 0) -> "LaunchPlan":
        """The plan of a launch through the C entry ``fn`` (``cuda``: a CUDA
        library's, which takes a stream; ``failure`` the error of a refused
        launch, ``{}`` its code) of a kernel that reads ``inputs`` (``None``
        for one it does not read) and writes the outputs named in
        ``written``, its shapes those of :func:`_shape`; with ``scratch``,
        the entry's last output is a scratch of ``(scratch, nlev, ncols)``
        values, ``"scratch"``, as fresh for each call as the outputs."""
        in_shapes = tuple(None if n is None else _shape(n, iface, nlev, ncols) for n in inputs)
        shapes = tuple(_shape(n, iface, nlev, ncols) if n in written else None for n in outputs)
        if scratch:
            outputs, shapes = (*outputs, "scratch"), (*shapes, (scratch, nlev, ncols))
        launcher = build.launcher().Launcher(
            ctypes.cast(fn, ctypes.c_void_p).value, cuda, list(switches), consts.numpy().tobytes(), tuple(inputs),
            in_shapes, tuple(outputs), shapes, dtype == torch.float64, "cuda" if cuda else "cpu", failure, nlev,
            ncols)
        return cls(launcher, switches, consts, shapes)

    def run(self, state: Dict[str, Tensor], extra: Optional[Dict[str, Tensor]] = None,
            eta: Optional[Tensor] = None) -> Tuple[Dict[str, Optional[Tensor]], Tensor]:
        """Launch on ``state`` (``extra``'s fields first, where given) in one
        compiled call: every field the kernel reads checked (present, of the
        plan's shape, dtype and device, contiguous) before any output
        exists; fresh outputs; refused where one overlaps an input
        (:func:`check_disjoint`'s rule); the C entry, on the card on
        PyTorch's current stream of the inputs' device.  Returns the
        outputs by name (``None``: not written) and the ``eta`` the kernel
        read (``eta``, else the state's in the launch's dtype); raises on a
        refused launch.  While a profiler runs, its stages are the spans
        ``check``, ``alloc``, ``check`` (the overlap) and ``launch``,
        stamped inside the call."""
        on = PROFILER._is_profiler_enabled
        outs, eta, stamps = self.launcher.run(state, extra, eta, on)
        if on:
            for name, start, end in zip(LAUNCH_STAGES, stamps, stamps[1:]):
                close_span(open_span(name, start), end)
        return outs, eta


#: the stages of :meth:`LaunchPlan.run`, between its five stamps
LAUNCH_STAGES = ("check", "alloc", "check", "launch")


def check_layout(dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    """The checks of a launch on ``ap``'s dtype and shape alone: every
    function that makes a plan runs them first, so a plan exists only for a
    layout a kernel takes, and the launcher holds every other field to
    ``ap``'s."""
    if len(shape) != 2:
        raise ValueError(f"ap must be (nlev, ncols), got shape {shape}")
    nlev, ncols = shape
    if nlev < 2 or ncols < 1:
        raise ValueError(f"need nlev >= 2 and ncols >= 1, got {(nlev, ncols)}")
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not supported (float32 | float64)")


def layout(state: Dict[str, Tensor], entry: str) -> Tuple[torch.dtype, Tuple[int, ...]]:
    """The state's ``ap``'s dtype and shape, a plan's key, for a launch
    through ``entry`` (``"cuda"``, or a host build's): on a device of the
    other type, the launcher's refusal, after the checks of the layout
    (:func:`check_layout`), before any library is built."""
    ap = state["ap"]
    if ap.is_cuda != (entry == "cuda"):
        check_layout(ap.dtype, tuple(ap.shape))
        raise ValueError(f"tensors must be on {'cuda' if entry == 'cuda' else 'cpu'}, got {ap.device}")
    return ap.dtype, tuple(ap.shape)


def cached(build: Callable[..., LaunchPlan], dt) -> Callable[..., LaunchPlan]:
    """``build``, a plan builder under ``functools.lru_cache``, for a
    ``dt`` that is a Python or numpy number (a key by value; the cache is
    ``typed``, since its type sets the arithmetic that folds the constant
    struct); for another ``dt`` (a tensor hashes by identity) the builder
    itself, whose plan is kept nowhere."""
    return build if type(dt) in _DT_TYPES else build.__wrapped__


@functools.lru_cache(maxsize=64, typed=True)
def _nl_plan(entry: str, dtype: torch.dtype, shape: Tuple[int, ...], c: Constants, dt: float,
             with_trajectory: bool, traj_only: bool, fuse_saturation: bool, kflag: int) -> LaunchPlan:
    """The plan of one NL launch through ``entry`` (``"cuda"``, or a host
    build's entry on the CPU) at ``shape``, ``(nlev, ncols)``: the C entry,
    the switches, the constant struct and the outputs written."""
    check_layout(dtype, shape)
    nlev, ncols = shape
    written = trajectory_names(c) if with_trajectory else ()
    if not traj_only:
        written = STEP_OUTPUTS + written + (("qsat_out",) if fuse_saturation else ())
    switches = launch_switches(c, dtype, with_trajectory, traj_only, fuse_saturation)
    if entry == "cuda":
        fn, failure = load_cuda(c.CUADJ_COMPACT).cloudsc2_nl_launch, "cloudsc2_nl kernel launch failed: cudaError_t {}"
    else:
        fn, failure = getattr(_load("host", c.CUADJ_COMPACT), entry), entry + " failed: {}"
    plan = LaunchPlan.make(
        fn, entry == "cuda", failure, switches, torch.from_numpy(kernel_constants(c, dt, dtype, kflag)),
        _FUSED_INPUTS if fuse_saturation else NL_INPUTS, NL_OUTPUTS, written, _IFACE, dtype, nlev, ncols)
    if entry != "cuda":
        return plan
    # wide: the launch's carveout sized for more than four blocks an SM (the query's carveout_blocks)
    return replace(plan, wide=_occupancy(switches, nlev, ncols)[5] > 4)


def _run_nl(entry: str, state: Dict[str, Tensor], dt: float, c: Constants, with_trajectory: bool,
            traj_only: bool, fuse_saturation: bool, kflag: int):
    """One NL launch through ``entry``: the options and the constants
    checked (:func:`check_constants`), the plan looked up by the state's
    ``ap`` (:func:`layout`; a new layout checked as its plan is made),
    then the launch by its plan, which checks the state (``qsat`` not read
    when fused).  Returns ``(outputs by name, eta)``, the ``eta`` in the
    state's dtype that the kernel read; a launch on the card counts in
    ``cloudsc2_nl_cuda.launches`` (and, by its plan, in
    ``.wide_launches``).  Its stages are the span ``plan`` and
    those of :meth:`LaunchPlan.run`."""
    if traj_only and not with_trajectory:
        raise ValueError("traj_only requires with_trajectory=True")
    k = open_span("plan") if PROFILER._is_profiler_enabled else None
    check_constants(c)
    plan = cached(_nl_plan, dt)(entry, *layout(state, entry), c, dt, bool(with_trajectory), bool(traj_only),
                                bool(fuse_saturation), kflag)
    if k:
        close_span(k)
    outs, eta = plan.run(state)
    if entry == "cuda":
        count_launch(cloudsc2_nl_cuda, plan.switches)
        cloudsc2_nl_cuda.wide_launches += plan.wide
    return outs, eta


def check_disjoint(ins: Sequence[Optional[Tensor]], outs: Dict[str, Optional[Tensor]],
                   names: Sequence[str] = NL_INPUTS) -> None:
    """Raise ``ValueError`` where an output's bytes overlap an input's (the
    inputs named by ``names``, in order): a pipelined kernel reads a level's
    inputs ahead of the stores of the levels before it, which is the same
    step only when no output is an input.  The launcher's own check
    (``launcher/launcher.cpp`` ``first_overlap``) on the tensors' addresses and
    byte counts (an absent tensor is a field the kernel does not take): one
    sweep over the spans sorted by address finds whether any output
    overlaps an input (a span that starts before the furthest end of the
    other kind so far); only then are the pairs searched, for the first
    output and its first input to name."""
    def spans(tensors):
        return [0 if t is None else t.data_ptr() for t in tensors], [0 if t is None else t.nbytes for t in tensors]

    build.launcher().check_spans(*spans(ins), list(names), *spans(list(outs.values())), list(outs))


@contextlib.contextmanager
def allocated_by(alloc: Callable[[Tuple[int, ...], torch.dtype, torch.device], Tensor]) -> Iterator[None]:
    """Inside the block, every launch plan allocates its outputs through
    ``alloc(shape, dtype, device)`` instead of fresh storage: the tests'
    seam for an output that overlaps an input."""
    lib = build.launcher()
    lib.set_alloc_seam(alloc)
    try:
        yield
    finally:
        lib.set_alloc_seam(None)


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
    launch under a non-exact divide also to ``.fast_div_launches``, one
    with ``CUADJ_COMPACT=False`` to ``.ref_launches``, and one whose
    shared-memory carveout is sized for more than four blocks an SM (a
    float32 grid of more than one wave of four, :func:`occupancy`) to
    ``.wide_launches``.  While a profiler runs, each call is a root span
    ``nl``.
    """
    return _entry("cuda", state, dt, c, with_trajectory, traj_only, fuse_saturation, kflag)


cloudsc2_nl_cuda.launches = 0  # type: ignore[attr-defined]
cloudsc2_nl_cuda.fast_div_launches = 0  # type: ignore[attr-defined]
cloudsc2_nl_cuda.ref_launches = 0  # type: ignore[attr-defined]
cloudsc2_nl_cuda.wide_launches = 0  # type: ignore[attr-defined]


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
def _occupancy(sw: Tuple[int, ...], nlev: int, ncols: int) -> Tuple[int, ...]:
    out = (ctypes.c_int * 6)()
    err = load_cuda(bool(sw[-1])).cloudsc2_nl_occupancy(*sw, nlev, ncols, out)
    if err != 0:
        raise RuntimeError(f"cloudsc2_nl occupancy query failed: cudaError_t {err}")
    return tuple(out)


def occupancy(dtype: torch.dtype, c: Constants, *, ncols: int, with_trajectory: bool = False,
              traj_only: bool = False, fuse_saturation: bool = False, nlev: int = 137) -> Dict[str, int]:
    """What the card makes of the kernel that :func:`cloudsc2_nl_cuda`
    launches for these options on ``ncols`` columns, at its 128 threads a
    block and ``nlev`` levels (the model's 137 unless told):
    ``blocks_per_sm`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    under the shared-memory carveout that launch asks for), ``registers``
    and ``local_bytes`` a thread (``cudaFuncGetAttributes``),
    ``shared_bytes`` a block (the level table's ``nlev`` values, then the
    ring), the ring ``depth``, and ``carveout_blocks``, the blocks an SM
    that carveout is sized for (:func:`carveout_blocks` at the card's
    registers and SMs, the ring's ``depth - 1`` slots in flight; 0 in
    float64, whose ring is in registers and which asks for none).  Needs
    the card; the answers are kept per instantiation, depth and column
    count."""
    sw = launch_switches(c, dtype, with_trajectory, traj_only, fuse_saturation)
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "shared_bytes", "depth", "carveout_blocks"),
                    _occupancy(sw, nlev, ncols)))


def carveout_blocks(register_blocks: int, shared_bytes: int, in_flight_bytes: int, grid_blocks: int,
                    sms: int) -> int:
    """The blocks an SM that a float32 launch of ``grid_blocks`` blocks on
    ``sms`` SMs sizes its shared-memory carveout for: the rule the card's
    launch runs (``nl_level.h`` ``nl_carveout_blocks``), from the host
    build.  The fewest of ``register_blocks`` (what the body's registers
    allow), the blocks an SM's memory holds, and the grid's blocks an SM,
    ``ceil(grid_blocks / sms)``, but never fewer than four.  A block holds
    ``shared_bytes`` and the 1 KB the card reserves of its 228 KB of shared
    memory, and ``in_flight_bytes`` of L1, the lines of the ring's copies
    in flight (the ring slots of the levels ahead), in the 256 KB an SM
    splits between the two.  Raises ``ValueError`` on an argument out of
    range."""
    args = (register_blocks, shared_bytes, in_flight_bytes, grid_blocks, sms)
    got = _load("host").cloudsc2_nl_carveout_blocks(*args)
    if got < 0:
        raise ValueError(f"carveout rule arguments out of range: {args}")
    return got


def _entry(entry: str, state, dt, c, with_trajectory, traj_only, fuse_saturation, kflag):
    """One call into an NL entry (``"cuda"`` or a host build's), the root
    span ``nl`` while a profiler runs."""
    k = open_span("nl") if PROFILER._is_profiler_enabled else None
    try:
        outs, _ = _run_nl(entry, state, dt, c, with_trajectory, traj_only, fuse_saturation, kflag)
        return _assemble(outs, with_trajectory, traj_only)
    finally:
        if k:
            close_span(k)


def cloudsc2_nl_host(
    state: Dict[str, Tensor], dt: float, c: Constants, with_trajectory: bool = False,
    traj_only: bool = False, fuse_saturation: bool = False, kflag: int = 1,
):
    """The kernel compiled for the host, on CPU tensors (tests only): its
    body through the pipelined scan the card runs, at the card's ring
    depth."""
    return _entry("cloudsc2_nl_host", state, dt, c, with_trajectory, traj_only, fuse_saturation, kflag)


def cloudsc2_nl_direct_host(
    state: Dict[str, Tensor], dt: float, c: Constants, with_trajectory: bool = False,
    traj_only: bool = False, fuse_saturation: bool = False, kflag: int = 1,
):
    """:func:`cloudsc2_nl_host` through the direct scan (each level's loads,
    arithmetic and stores in turn): the pipelined scan's reference in the
    tests."""
    return _entry("cloudsc2_nl_direct_host", state, dt, c, with_trajectory, traj_only, fuse_saturation, kflag)


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


def _scalm(eta: Tensor, c: Constants, device_type: str) -> Tensor:
    if eta.dtype not in _DTYPES or eta.device.type != device_type or not eta.is_contiguous() or eta.numel() < 1:
        raise ValueError(f"need a non-empty contiguous float32 or float64 tensor on {device_type}")
    out = torch.empty_like(eta)
    # zscal and zeps1 rounded to the dtype, as the constant structs fold them
    consts = torch.tensor([c.ZSCAL, c.ZEPS1], dtype=eta.dtype)
    is_double = int(eta.dtype == torch.float64)
    if device_type == "cuda":
        with torch.cuda.device(eta.device):
            err = _load("cuda").cloudsc2_scalm_probe(is_double, eta.data_ptr(), out.data_ptr(), eta.numel(),
                                                     consts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    else:
        err = _load("host").cloudsc2_scalm_probe_host(is_double, eta.data_ptr(), out.data_ptr(), eta.numel(),
                                                      consts.data_ptr())
    if err != 0:
        raise RuntimeError(f"cloudsc2_scalm_probe failed: {err}")
    return out


def scalm_cuda(eta: Tensor, c: Constants) -> Tensor:
    """``scalm`` of each value of ``eta`` (a float32 or float64 CUDA tensor)
    by the kernels' own derivation (``nl_level.h`` ``ScalmTable::derive``,
    which each block of every kernel runs in its prologue): for the checks
    against :func:`cloudsc2_tpu_torch.physics.nonlinear.scalm_profile`."""
    return _scalm(eta, c, "cuda")


def scalm_host(eta: Tensor, c: Constants) -> Tensor:
    """:func:`scalm_cuda` of the host build, on a CPU tensor."""
    return _scalm(eta, c, "cpu")
