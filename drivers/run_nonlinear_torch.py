# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLI driver: nonlinear CLOUDSC2 through the PyTorch port, with timing and
validation against the golden files.

The port's counterpart of ``drivers/run_nonlinear.py``: load the input
state (``data/input_synth.h5`` tiled to ``--num-cols``), diagnose eta,
run the scheme once to warm up and ``--num-runs`` timed times, print the
runtime statistics and validate against
``data/reference_synth_{double,single}.h5`` ("HOORAY").  On ``--device
cuda`` the scheme runs the hand-written CUDA kernel; on ``--device cpu``
its plain PyTorch version.  A CUDA device on a machine without one is an
error.

By default (``--fuse-saturation``) one NL step also diagnoses saturation,
in the kernel: the counterpart of the JAX driver's single-kernel path
(``cloudsc2_nl_pallas(..., fuse_saturation=True)``, ``run_nonlinear.py:196-209``).
``--no-fuse-saturation`` runs the ``Saturation`` component and then the NL
step, as two stages.  ``--fast-div`` picks the NL kernel's divide mode
(``Constants.FAST_DIV``: exact, faithful, approx); float64 always divides
exactly, as the JAX kernel does.  A ``Saturation`` component run apart
(``--no-fuse-saturation``) divides exactly: it is no kernel, and the JAX
package keeps the non-exact modes inside its kernels.

``--output-csv-file`` and ``--output-csv-file-stencils`` append the run's
performance row and its per-component timings (``--host-alias`` names the
host) as ``drivers/run_nonlinear.py`` does, the variant ``nl-torch:cuda``
or ``nl-torch:cpu``; ``--profile-dir`` writes a ``torch.profiler`` trace of
the timed runs (CPU activity, and CUDA activity on the card), with the
port's own spans of the same runs appended (the kernel wrappers' stages and
the ``timing`` blocks, :func:`cloudsc2_tpu_torch.utils.timing.append_spans`):
one timeline shows each stage above the kernels it launched.

``--stream-chunk N`` sweeps ``--num-cols`` columns through the device in
chunks of N (:func:`cloudsc2_tpu_torch.parallel.stream.stream_columns`:
the copies to the device overlapped with the NL kernel; ``--stream-ring``
distinct host chunks cycled; ``--stream-outputs`` returns every chunk's
outputs to host buffers) and validates chunk 0 against the goldens.  The
input is loaded at its own column count: the ring tiles it per chunk.

``--sharded`` runs the step column-sharded over a ``('node', 'device')``
mesh (:mod:`cloudsc2_tpu_torch.parallel.mesh`: every visible card on
``--device cuda``, one shard a process on ``--device cpu``), as
``drivers/run_nonlinear.py`` does: eta from the global column 0 first,
the columns padded to 128 times the mesh's shards by repeating column 0,
the state sharded once before the timed loop, then the sharded forward
step (:func:`~cloudsc2_tpu_torch.parallel.step.make_sharded_forward_step`).
``--distributed`` (which implies ``--sharded``) first joins a process group
over gloo (``--coordinator host:port --process-id i --num-processes n``,
or a ``torchrun`` launch); each process then holds its own column block
on its card, validates it against the same golden columns, and the lead
process writes the CSVs and prints every process's exit code.  Neither
composes with ``--stream-chunk``, as in the JAX driver.

Uses ``argparse``, and imports ``h5py`` only where a file is read.  Where
``h5py`` is not installed, the default input and goldens are built in
process instead (:func:`cloudsc2_tpu_torch.iox.synthetic_input`,
:func:`cloudsc2_tpu_torch.oracle.synthetic_golden`; equal to the files bit
for bit), so the driver also runs where neither ``click``
nor ``h5py`` is installed.

Usage:  python drivers/run_nonlinear_torch.py --device cuda --precision single --num-cols 65536
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from cloudsc2_tpu_torch.config import (  # noqa: E402
    DEFAULT_CONFIG,
    DEFAULT_IO_CONFIG,
    default_input_file,
    default_reference_file,
)
from cloudsc2_tpu_torch.iox import SYNTH_NCOLS, synthetic_input  # noqa: E402
from cloudsc2_tpu_torch.oracle import synthetic_golden  # noqa: E402

Fields = Dict[str, np.ndarray]


def _dtype(precision: str) -> Any:
    return np.float64 if precision == "double" else np.float32


def _have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def config_tolerances(precision: str, device_type: str, atol=None, rtol=None) -> Tuple[float, float]:
    """The rule of ``drivers/run_nonlinear.py:config_tolerances``: the
    double gate everywhere; in single, the goldens' f64 math against the
    run's own f32 rounding through 137 levels gets the accelerator gate on
    CUDA and the tight CPU gate on the CPU, whatever the divide mode.  A
    non-exact ``--fast-div`` on the CPU, where the plain version computes
    Pallas interpret mode's bfloat16 reciprocal, fails the tight gate
    (PERF.md, section 2); give ``--rtol`` / ``--atol`` to hold it to
    another."""
    if precision == "double":
        a, r = 1e-16, 1e-10
    else:
        a, r = (2e-4, 1e-2) if device_type == "cuda" else (1e-8, 2e-3)
    return (a if atol is None else atol), (r if rtol is None else rtol)


def core(
    config,
    torch_config,
    *,
    atol: Optional[float] = None,
    rtol: Optional[float] = None,
    inputs=None,
    reference: Optional[Tuple[Fields, Fields]] = None,
    fuse_saturation: bool = True,
    fast_div: str = "exact",
    io_config=DEFAULT_IO_CONFIG,
    profile_dir: Optional[str] = None,
    stream_chunk: Optional[int] = None,
    stream_ring: int = 4,
    stream_outputs: bool = False,
    dist_kwargs: Optional[Dict[str, Any]] = None,
) -> int:
    """Run the scheme and validate; returns the exit code (0 on success).

    ``config`` is a :class:`cloudsc2_tpu_torch.config.Config` (precision, columns,
    runs, checks, validation, files); ``torch_config`` a
    :class:`cloudsc2_tpu_torch.config.TorchConfig`; ``io_config`` a
    :class:`cloudsc2_tpu_torch.config.IOConfig` (the CSV outputs).
    ``inputs`` (``(grid, state, dt, constants)``) and ``reference``
    (``(tendencies, diagnostics)`` at ``config.num_cols``, at
    ``stream_chunk`` when streaming) replace the files when given.
    ``fuse_saturation``, ``fast_div``, ``profile_dir``, ``stream_chunk``,
    ``stream_ring`` and ``stream_outputs`` are the flags of the same names;
    ``config.sharded`` and ``config.distributed`` the flags ``--sharded``
    and ``--distributed``, which joins the process group of ``dist_kwargs``
    (:func:`cloudsc2_tpu_torch.parallel.mesh.initialize_distributed`).
    """
    import torch

    from cloudsc2_tpu_torch import iox
    from cloudsc2_tpu_torch.components import Cloudsc2NL, EtaLevels, Saturation
    from cloudsc2_tpu_torch.params import make_constants
    from cloudsc2_tpu_torch.state import state_from_numpy
    from cloudsc2_tpu_torch.utils.output import (
        print_performance,
        write_performance_to_csv,
        write_stencils_performance_to_csv,
    )
    from cloudsc2_tpu_torch.utils.timing import Timer, append_spans, clear, device_sync, timing

    if stream_chunk and config.sharded:
        raise ValueError("--stream-chunk is a single-device mode (the multi-device path keeps the columns "
                         "resident: --sharded / --distributed)")
    if config.distributed:
        from cloudsc2_tpu_torch.parallel.mesh import initialize_distributed

        initialize_distributed(**(dist_kwargs or {}))
    device = torch_config.apply()
    dtype = _dtype(config.precision)
    # streaming loads the input at its own column count: the ring tiles it
    # per chunk, and materialising --num-cols host columns up front is what
    # the mode exists to avoid
    load_cols = SYNTH_NCOLS if stream_chunk else config.num_cols
    ref_cols = stream_chunk or config.num_cols

    if inputs is None and not config.input_file and not _have_h5py():
        print("h5py is not installed: the default input and goldens are built in process "
              "(equal to data/input_synth.h5 and data/reference_synth_*.h5)")
        inputs = synthetic_input(load_cols, config.precision)
        if reference is None and config.enable_validation:
            reference = synthetic_golden(ref_cols, config.precision)

    # --- input state: the file tiled to --num-cols, else synthesis
    if inputs is not None:
        grid, state_np, dt, c = inputs
    else:
        input_file = config.input_file or default_input_file()
        if input_file:
            grid, state_np, dt, params = iox.load_input(
                input_file, ncols=None if stream_chunk else config.num_cols, dtype=dtype)
            c = make_constants(lphylin=True, ldrain1d=False, **params)
        else:
            grid, state_np, dt = iox.synthesize_input(ncols=load_cols, nlev=137, seed=0, dtype=dtype)
            c = make_constants(lphylin=True, ldrain1d=False)
    if fast_div != "exact" and config.precision == "double":
        print(f"--fast-div {fast_div} with --precision double: float64 divides exactly, so this run is exact")
    c_nl = c.replace(FAST_DIV=fast_div)

    def check(tends, diags, ncols, cols=None) -> int:
        return _validate(config, device, tends, diags, ncols, dtype, reference, atol, rtol, cols)

    if stream_chunk:
        # --- the column-chunked streaming sweep (the out-of-memory scaled run)
        from cloudsc2_tpu_torch.parallel.stream import stream_columns

        stats, (tends, diags) = stream_columns(
            state_np, dt, c_nl, total_cols=config.num_cols, chunk_cols=stream_chunk,
            ring_size=stream_ring, device=device, fuse_saturation=fuse_saturation,
            stream_outputs=stream_outputs, progress_every=16,
        )
        print(
            f"Streamed {stats['total_cols']} columns in {stats['nchunks']} "
            f"chunks of {stats['chunk_cols']}: {stats['wall_s']:.3f} s, "
            f"{stats['cols_per_sec'] / 1e6:.3f}M columns/s "
            f"(effective H2D {stats['effective_h2d_gbps']:.2f} GB/s at "
            f"{stats['h2d_bytes_per_col']} B/column)"
        )
        if stream_outputs:
            print(
                f"Full duplex: outputs streamed to host ring buffers "
                f"(effective D2H {stats['effective_d2h_gbps']:.2f} GB/s at "
                f"{stats['d2h_bytes_per_col']} B/column; "
                f"{stats['duplex_bytes_per_col']} B/column total link traffic)"
            )
        print(f"Device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
        return check(tends, diags, stream_chunk)

    ncols = grid.ncols
    # sharded, every process holds the whole state on the host and places
    # its own columns on its shards
    state = state_from_numpy(state_np, torch.device("cpu") if config.sharded else device, torch_config.dtype)

    # --- components; eta (global column 0, loop-invariant) before sharding
    eta_levels = EtaLevels(grid, c, enable_checks=config.enable_checks)
    state.update(eta_levels(state))
    mesh = None
    sync = device_sync
    if config.sharded:
        from cloudsc2_tpu_torch.parallel.mesh import column_mesh, pad_columns, shard_state
        from cloudsc2_tpu_torch.parallel.step import make_sharded_forward_step

        mesh = column_mesh(device=device.type)
        state, _ = pad_columns(state, 128 * mesh.size)
        padded = state["ap"].shape[1]
        state = shard_state(state, mesh)
        lo, hi = mesh.columns(padded, 0)[0], mesh.columns(padded, len(mesh.devices) - 1)[1]
        print(f"Sharded over the ('node', 'device') mesh {mesh.shape}: process {mesh.process_index} of "
              f"{mesh.process_count} holds columns [{lo}, {hi}) of {padded} ({ncols} real) in "
              f"{len(mesh.devices)} shard(s) on {[str(d) for d in mesh.devices]}")
        sharded_step = make_sharded_forward_step(mesh, dt=dt, c=c_nl, fuse_saturation=fuse_saturation)

        def run_once():
            return sharded_step(state)

        def sync(out):
            device_sync([v.shards for d in out for v in d.values()])
            return out
    elif fuse_saturation:
        cloudsc2_nl = Cloudsc2NL(grid, c_nl, fuse_saturation=True, kflag=1, enable_checks=config.enable_checks)

        def run_once():
            return cloudsc2_nl(dict(state), dt)
    else:
        saturation = Saturation(grid, c, kflag=1, lphylin=True, enable_checks=config.enable_checks)
        cloudsc2_nl = Cloudsc2NL(grid, c_nl, enable_checks=config.enable_checks)

        def run_once():
            s = dict(state)
            s.update(saturation(s))
            return cloudsc2_nl(s, dt)

    # warm-up (builds the kernel on first use), then the timed runs; an
    # optional profiler trace around them
    tends, diags = sync(run_once())
    Timer.reset()
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=activities)
        clear()
        prof.start()
    runtimes = []
    for _ in range(config.num_runs):
        with timing("run"):
            tends, diags = sync(run_once())
        runtimes.append(Timer.get_time("run", "ms") - sum(runtimes))
    if prof is not None:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"Profiler trace written to {profile_dir}, with {append_spans(trace)} spans of the port")
    stats = print_performance(ncols, runtimes, nlev=grid.nlev)
    print(f"Device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    if device.type == "cuda":
        from cloudsc2_tpu_torch.kernels.nonlinear import cloudsc2_nl_cuda

        print(f"Kernel launches in this process: cloudsc2_nl_cuda {cloudsc2_nl_cuda.launches}")
    # the CSVs from the lead process only (processes share the filesystem)
    is_lead = mesh is None or mesh.process_index == 0
    if is_lead and io_config.output_csv_file:
        write_performance_to_csv(
            io_config.output_csv_file, host_name=io_config.host_name, precision=config.precision,
            variant="nl-torch:" + device.type, num_cols=ncols, num_threads=config.num_threads,
            num_runs=config.num_runs, runtime_mean=stats[0], runtime_stddev=stats[1],
            mflops_mean=stats[2], mflops_stddev=stats[3],
        )
    if is_lead and io_config.output_csv_file_stencils:
        write_stencils_performance_to_csv(
            io_config.output_csv_file_stencils, host_name=io_config.host_name,
            precision=config.precision, backend="torch:" + device.type, num_cols=ncols,
            num_threads=config.num_threads, num_runs=config.num_runs,
            exec_info={k: Timer.get_time(k, "ms") for k in Timer.labels()},
            key_patterns=("cloudsc", "saturation", "increment", "perturbed", "eta"),
        )
    if mesh is None:
        return check(tends, diags, ncols)
    if mesh.process_count == 1:
        from cloudsc2_tpu_torch.parallel.mesh import gather_columns, unpad_columns

        return check(unpad_columns({k: gather_columns(v) for k, v in tends.items()}, ncols),
                     unpad_columns({k: gather_columns(v) for k, v in diags.items()}, ncols), ncols)
    return _check_process_block(mesh, tends, diags, ncols, check)


def _check_process_block(mesh, tends, diags, ncols, check) -> int:
    """A process of a group validates its own column block against the same
    golden columns (trailing pad columns carry no data); every process then
    gathers the exit codes of all, the lead prints them, and each returns
    the worst."""
    import torch.distributed as dist

    from cloudsc2_tpu_torch.parallel.mesh import process_local_block

    blocks = {k: process_local_block(v) for k, v in {**tends, **diags}.items()}
    c0, c1 = blocks["t"][1]
    c1 = min(c1, ncols)
    if c1 <= c0:
        print("Validation skipped: this process holds only pad columns.")
        rc = 0
    else:
        print(f"Validating this process's columns [{c0}, {c1})")
        rc = check({k: blocks[k][0][:, : c1 - c0] for k in tends},
                   {k: blocks[k][0][:, : c1 - c0] for k in diags}, ncols, (c0, c1))
    rcs = [None] * mesh.process_count
    dist.all_gather_object(rcs, rc)
    if mesh.process_index == 0:
        print(f"Exit codes of the {mesh.process_count} processes: {rcs}")
    dist.destroy_process_group()
    return max(rcs)


def _validate(config, device, tends, diags, ncols, dtype, reference, atol, rtol, cols=None) -> int:
    """Validate outputs at ``ncols`` columns, or at the golden columns
    ``cols = (start, stop)`` of them, against the goldens (``reference``,
    else ``config.reference_file``); the exit code."""
    from cloudsc2_tpu_torch import iox
    from cloudsc2_tpu_torch.utils.validation import validate

    if not config.enable_validation:
        return 0
    if reference is None:
        if not config.reference_file:
            return 0
        import h5py

        with h5py.File(config.reference_file, "r") as f:
            reference = iox.read_reference(f, ncols=ncols, dtype=dtype)
    tends_ref, diags_ref = reference
    if cols is not None:
        tends_ref = {k: v[:, cols[0]:cols[1]] for k, v in tends_ref.items()}
        diags_ref = {k: v[:, cols[0]:cols[1]] for k, v in diags_ref.items()}
    tends_np = {k: v.cpu().numpy() for k, v in tends.items()}
    # the fused step's qsat is no golden field (validate walks the union of keys)
    diags_np = {k: v.cpu().numpy() for k, v in diags.items() if k != "qsat"}
    atol, rtol = config_tolerances(config.precision, device.type, atol, rtol)
    failing = validate(tends_np, tends_ref, atol=atol, rtol=rtol)
    failing += validate(diags_np, diags_ref, atol=atol, rtol=rtol)
    if failing:
        print(f"Validation FAILED for fields: {failing}")
        return 1
    print("Validation completed successfully. HOORAY HOORAY!")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--num-cols", type=int, default=100)
    p.add_argument("--num-runs", type=int, default=1)
    p.add_argument("--precision", choices=("double", "single"), default="double")
    p.add_argument("--enable-checks", dest="enable_checks", action="store_true", default=False)
    p.add_argument("--enable-validation", dest="enable_validation", action="store_true", default=True)
    p.add_argument("--disable-validation", dest="enable_validation", action="store_false")
    p.add_argument("--input-file", default=None, help="input HDF5 (default: data/input_synth.h5)")
    p.add_argument("--reference-file", default=None, help="golden output HDF5")
    p.add_argument("--atol", type=float, default=None)
    p.add_argument("--rtol", type=float, default=None)
    p.add_argument("--fuse-saturation", action=argparse.BooleanOptionalAction, default=True,
                   help="diagnose saturation inside the NL step (default) or as its own component before it")
    p.add_argument("--fast-div", choices=("exact", "faithful", "approx"), default="exact",
                   help="the NL kernel's divide mode (Constants.FAST_DIV); float64 divides exactly")
    p.add_argument("--output-csv-file", default=None, help="append the performance row to this CSV")
    p.add_argument("--output-csv-file-stencils", default=None,
                   help="append the per-component timings to this CSV")
    p.add_argument("--host-alias", default="localhost", help="the host name written into the CSVs")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the timed runs (trace.json) into this directory")
    p.add_argument("--stream-chunk", type=int, default=None,
                   help="stream --num-cols columns through the device in chunks of this many columns "
                   "(copies overlapped with the kernel; the out-of-memory scaled run)")
    p.add_argument("--stream-ring", type=int, default=4,
                   help="distinct host-resident chunk buffers cycled by the stream")
    p.add_argument("--sharded", action="store_true", default=False,
                   help="column-shard the step over a ('node', 'device') mesh of every visible card "
                   "(--device cuda) or one CPU shard a process")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="join a process group over gloo first (one process a node); implies --sharded. "
                   "Give --coordinator, --process-id and --num-processes, or launch with torchrun")
    p.add_argument("--coordinator", default=None, help="the process group's address, host:port")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--stream-outputs", action=argparse.BooleanOptionalAction, default=False,
                   help="full duplex: every chunk's tendencies and diagnostics back into host ring "
                   "buffers, overlapped with compute; the validated sample then certifies that copy")
    a = p.parse_args(argv)

    from cloudsc2_tpu_torch.config import TorchConfig

    config = (
        DEFAULT_CONFIG.with_precision(a.precision)
        .with_checks(a.enable_checks)
        .with_validation(a.enable_validation)
        .with_num_cols(a.num_cols)
        .with_num_runs(a.num_runs)
        .with_input_file(a.input_file)
        .with_sharded(a.sharded)
        .with_distributed(a.distributed)
    )
    dist_kwargs = {k: v for k, v in (("coordinator_address", a.coordinator), ("process_id", a.process_id),
                                      ("num_processes", a.num_processes)) if v is not None}
    reference_file = a.reference_file
    if reference_file is None and a.input_file is None and a.enable_validation:
        ref = default_reference_file(a.precision)
        reference_file = ref if os.path.exists(ref) else None
    config = config.with_reference_file(reference_file)
    io_config = (
        DEFAULT_IO_CONFIG.with_output_csv_file(a.output_csv_file)
        .with_output_csv_file_stencils(a.output_csv_file_stencils)
        .with_host_name(a.host_alias)
    )
    return core(config, TorchConfig(device=a.device, precision=a.precision), atol=a.atol, rtol=a.rtol,
                fuse_saturation=a.fuse_saturation, fast_div=a.fast_div, io_config=io_config,
                profile_dir=a.profile_dir, stream_chunk=a.stream_chunk, stream_ring=a.stream_ring,
                stream_outputs=a.stream_outputs, dist_kwargs=dist_kwargs)


if __name__ == "__main__":
    sys.exit(main())
