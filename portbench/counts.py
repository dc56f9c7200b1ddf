"""The work a step needs, from the benchmark's own field lists
(``portbench/counts/<launch>.json``) and the card's published peaks
(``portbench/peaks.json``).

A count file lists the fields a launch needs read and the fields the check
compares written, by shape: ``full`` ``(nlev, ncols)``, ``iface``
``(nlev + 1, ncols)``, ``vertical`` ``(nlev,)``.  Each is counted once,
whatever the kernel reads again or keeps internal, so the least time
measures the same work whatever implements it.  A field listed under
``evaporation_only`` is needed only with ``LEVAPLS2`` or ``LDRAIN1D``.
The operation counts are hand counts, labelled so in each file.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Sequence

ROOT = Path(__file__).resolve().parent

ITEM_BYTES = {"float32": 4, "float64": 8}


def load(name: str, root: Path = ROOT) -> Dict:
    """The count file ``counts/<name>.json``."""
    return json.loads((root / "counts" / f"{name}.json").read_text())


def peaks(root: Path = ROOT) -> Dict:
    """The card's published peaks (``peaks.json``)."""
    return json.loads((root / "peaks.json").read_text())


def evaporation(switches: Mapping[str, object]) -> bool:
    """Whether a configuration's switches run the evaporation branch."""
    return bool(switches.get("LEVAPLS2") or switches.get("LDRAIN1D"))


def _values(groups: Mapping[str, Sequence[str]], skip: Sequence[str], nlev: int, ncols: int) -> int:
    size = {"full": nlev * ncols, "iface": (nlev + 1) * ncols, "vertical": nlev}
    return sum(size[shape] for shape, names in groups.items() for n in names if n not in skip)


def launch_bytes(spec: Mapping, nlev: int, ncols: int, precision: str, evap: bool) -> int:
    """Bytes one launch must move: each needed input read once, each
    compared output written once."""
    skip = () if evap else tuple(spec["evaporation_only"])
    values = _values(spec["reads"], skip, nlev, ncols) + _values(spec["writes"], skip, nlev, ncols)
    return values * ITEM_BYTES[precision]


def launch_flops(spec: Mapping, nlev: int, ncols: int, evap: bool) -> int:
    """Operations of one launch by its hand count per column-level."""
    per = spec.get("flops_with_evaporation", spec["flops_per_column_level"]) if evap else spec["flops_per_column_level"]
    return per * nlev * ncols


def least_time_s(specs: Sequence[Mapping], nlev: int, ncols: int, precision: str, evap: bool,
                 peak: Mapping = None) -> float:
    """The step's least possible seconds on the card: the larger of its
    bytes over the HBM rate and its operations over the peak rate of its
    type, summed over the step's launches."""
    peak = peak or peaks()
    nbytes = sum(launch_bytes(s, nlev, ncols, precision, evap) for s in specs)
    flops = sum(launch_flops(s, nlev, ncols, evap) for s in specs)
    return max(nbytes / peak["hbm_bytes_per_s"], flops / peak["flops_per_s"][precision])
