# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Generate the golden data of the synthetic workload through the PyTorch
port's numpy modules; the port's counterpart of
``drivers/generate_reference.py``.

Writes a deterministic synthetic input (``input_synth.h5``, the upstream
dwarf schema) and per-precision golden outputs
(``reference_synth_{double,single}.h5``, the reference output schema)
computed by the port's independent scalar oracle
(:func:`cloudsc2_tpu_torch.oracle.golden_outputs`).  At the defaults the
files are the committed ``data/`` files, dataset for dataset.

Uses ``argparse`` and needs ``h5py``.

Usage:  python drivers/generate_reference_torch.py [--ncols 100] [--nlev 137] [--seed 0] [--out-dir data]
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

DATA_DIR = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data"))


def generate(out_dir: str, ncols: int = 100, nlev: int = 137, seed: int = 0) -> List[str]:
    """Write the input and the two golden files into ``out_dir``; returns
    their paths."""
    from cloudsc2_tpu_torch import iox
    from cloudsc2_tpu_torch.oracle import golden_outputs
    from cloudsc2_tpu_torch.params import make_constants

    os.makedirs(out_dir, exist_ok=True)
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=seed)
    paths = [os.path.join(out_dir, "input_synth.h5")]
    iox.write_input_h5(paths[0], state, dt)
    print(f"wrote {paths[0]} ({ncols} cols x {nlev} levels, dt={dt})")

    c = make_constants(lphylin=True, ldrain1d=False)
    for precision, dtype in (("double", np.float64), ("single", np.float32)):
        tends, diags = golden_outputs(state, dt, c, dtype)
        paths.append(os.path.join(out_dir, f"reference_synth_{precision}.h5"))
        iox.write_reference_h5(paths[-1], tends, diags)
        print(f"wrote {paths[-1]}")
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ncols", type=int, default=100)
    p.add_argument("--nlev", type=int, default=137)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default=DATA_DIR, help="where the three files go (default: data/)")
    a = p.parse_args(argv)
    generate(a.out_dir, ncols=a.ncols, nlev=a.nlev, seed=a.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
