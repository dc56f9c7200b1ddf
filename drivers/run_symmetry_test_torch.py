# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLI driver: symmetry test of the adjoint scheme through the PyTorch port.

The port's counterpart of ``drivers/run_symmetry_test.py``: assemble the
state (``data/input_synth.h5`` tiled to ``--num-cols``), diagnose eta, run
the symmetry protocol (``<Mx,Mx> == <x, M*(Mx)>`` per column), print the
verdict, ``--num-runs`` times for timing.  Exit code 0 iff the maximum
error is below 1e4 machine epsilons.  On ``--device cuda`` the TL and AD
run the hand-written CUDA kernels (the AD's forward sweep is the NL kernel
with its trajectory); on ``--device cpu`` their plain PyTorch versions.  A
CUDA device on a machine without one is an error.

``--output-csv-file`` and ``--output-csv-file-stencils`` append the
protocol's performance row and its per-stage timings (``--host-alias``
names the host) as the JAX driver does, the variant ``ad-torch:cuda`` or
``ad-torch:cpu``.

``--sharded`` runs the TL and AD column-sharded over a ``('node', 'device')``
mesh (every visible card on ``--device cuda``, one CPU shard on ``--device
cpu``), as the JAX driver does: the columns padded to 128 times the mesh's
shards by repeating column 0, so the pad columns enter the norms.

Uses ``argparse``, and imports ``h5py`` only where a file is read.  Where
``h5py`` is not installed, the default input is built in process instead
(:func:`drivers.run_nonlinear_torch.synthetic_input`, equal to the file bit
for bit).

Usage:  python drivers/run_symmetry_test_torch.py --device cpu --precision double
"""
from __future__ import annotations

import argparse
import sys
from typing import Tuple

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from cloudsc2_tpu_torch.config import DEFAULT_CONFIG, DEFAULT_IO_CONFIG, default_input_file  # noqa: E402
from drivers.run_nonlinear_torch import _dtype, _have_h5py, synthetic_input  # noqa: E402


def core(
    config, torch_config, *, factor: float = 0.01, inputs=None, io_config=DEFAULT_IO_CONFIG
) -> Tuple[int, float]:
    """Run the symmetry protocol ``config.num_runs`` times and print the
    verdict; returns ``(exit code, the maximum error of the last run in
    machine epsilons)``.

    ``config`` is a :class:`cloudsc2_tpu_torch.config.Config` (precision,
    columns, runs, input file); ``torch_config`` a
    :class:`cloudsc2_tpu_torch.config.TorchConfig`; ``io_config`` a
    :class:`cloudsc2_tpu_torch.config.IOConfig` (the CSV outputs).
    ``inputs`` (``(grid, state, dt, constants)``) replaces the file when
    given.
    """
    from cloudsc2_tpu_torch import iox
    from cloudsc2_tpu_torch.components import EtaLevels
    from cloudsc2_tpu_torch.params import make_constants
    from cloudsc2_tpu_torch.state import state_from_numpy
    from cloudsc2_tpu_torch.utils.output import (
        print_performance,
        write_performance_to_csv,
        write_stencils_performance_to_csv,
    )
    from cloudsc2_tpu_torch.utils.timing import Timer, timing
    from cloudsc2_tpu_torch.validation.symmetry import SymmetryTest

    device = torch_config.apply()
    dtype = _dtype(config.precision)

    if inputs is None and not config.input_file and not _have_h5py():
        print("h5py is not installed: the default input is built in process "
              "(equal to data/input_synth.h5)")
        inputs = synthetic_input(config.num_cols, config.precision)
    if inputs is not None:
        grid, state_np, dt, c = inputs
    else:
        input_file = config.input_file or default_input_file()
        if input_file:
            grid, state_np, dt, params = iox.load_input(input_file, ncols=config.num_cols, dtype=dtype)
            c = make_constants(lphylin=True, ldrain1d=False, **params)
        else:
            grid, state_np, dt = iox.synthesize_input(ncols=config.num_cols, nlev=137, seed=0, dtype=dtype)
            c = make_constants(lphylin=True, ldrain1d=False)

    state = state_from_numpy(state_np, device, torch_config.dtype)
    state.update(EtaLevels(grid, c)(state))

    mesh = None
    if config.sharded:
        # as run_nonlinear_torch.py --sharded: eta first (global column 0),
        # then the columns padded to 128 times the mesh's shards by
        # repeating column 0 (valid physics: the pad columns enter the
        # norms as the JAX driver's do); the protocol shards each scheme
        from cloudsc2_tpu_torch.parallel.mesh import column_mesh, pad_columns

        mesh = column_mesh(device=device.type)
        state, _ = pad_columns(state, 128 * mesh.size)
        print(f"Sharded over the ('node', 'device') mesh {mesh.shape}: {state['ap'].shape[1]} columns "
              f"({grid.ncols} real) on {[str(d) for d in mesh.devices]}")

    st = SymmetryTest(constants=c, factor=factor, mesh=mesh)
    Timer.reset()
    err = float("inf")
    runtimes = []
    for _ in range(config.num_runs):
        with timing("run"):
            err = st(state, dt, verbose=True)
        runtimes.append(Timer.get_time("run", "ms") - sum(runtimes))
    stats = print_performance(grid.ncols, runtimes, nlev=grid.nlev)
    if io_config.output_csv_file:
        write_performance_to_csv(
            io_config.output_csv_file, host_name=io_config.host_name, precision=config.precision,
            variant="ad-torch:" + device.type, num_cols=grid.ncols, num_threads=config.num_threads,
            num_runs=config.num_runs, runtime_mean=stats[0], runtime_stddev=stats[1],
            mflops_mean=stats[2], mflops_stddev=stats[3],
        )
    if io_config.output_csv_file_stencils:
        write_stencils_performance_to_csv(
            io_config.output_csv_file_stencils, host_name=io_config.host_name,
            precision=config.precision, backend="torch:" + device.type, num_cols=grid.ncols,
            num_threads=config.num_threads, num_runs=config.num_runs,
            exec_info={k: Timer.get_time(k, "ms") for k in Timer.labels()},
            key_patterns=("cloudsc", "saturation", "increment"),
        )
    return (0 if err < 1e4 else 1), err


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--num-cols", type=int, default=100)
    p.add_argument("--num-runs", type=int, default=1)
    p.add_argument("--precision", choices=("double", "single"), default="double")
    p.add_argument("--factor", type=float, default=0.01)
    p.add_argument("--sharded", action="store_true", default=False,
                   help="column-shard the schemes over a ('node', 'device') mesh of every visible card "
                   "(--device cuda) or one CPU shard")
    p.add_argument("--input-file", default=None, help="input HDF5 (default: data/input_synth.h5)")
    p.add_argument("--output-csv-file", default=None, help="append the performance row to this CSV")
    p.add_argument("--output-csv-file-stencils", default=None,
                   help="append the per-stage timings to this CSV")
    p.add_argument("--host-alias", default="localhost", help="the host name written into the CSVs")
    a = p.parse_args(argv)

    from cloudsc2_tpu_torch.config import TorchConfig

    config = (
        DEFAULT_CONFIG.with_precision(a.precision)
        .with_num_cols(a.num_cols)
        .with_num_runs(a.num_runs)
        .with_input_file(a.input_file)
        .with_sharded(a.sharded)
    )
    io_config = (
        DEFAULT_IO_CONFIG.with_output_csv_file(a.output_csv_file)
        .with_output_csv_file_stencils(a.output_csv_file_stencils)
        .with_host_name(a.host_alias)
    )
    rc, _ = core(config, TorchConfig(device=a.device, precision=a.precision), factor=a.factor,
                 io_config=io_config)
    return rc


if __name__ == "__main__":
    sys.exit(main())
