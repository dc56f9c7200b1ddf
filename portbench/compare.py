"""The comparison that decides ``correct``.

Each number a cell compares covers a group of outputs (an entry's
``CHECKS``): for each output, the largest absolute difference between the
program's value and the reference's over the largest magnitude of the
reference's, and the number is the worst output's.  An output the
reference gives as all zeros counts 0 where the program's is all zeros
too and infinite otherwise; a non-finite value counts infinite.  A number
passes at or below its limit (the cell's ``limits``).

The control is the reference computed one precision below the
configuration's, in the program's place (:data:`LOWER`): float32 for
float64, bfloat16 for float32 (the scheme has no matrix product, so TF32
does not apply).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
#: the precision of the control, by the configuration's precision
LOWER = {"float64": "float32", "float32": "bfloat16"}


def output_stats(got: Optional[Tensor], want: Tensor) -> Tuple[float, float]:
    """One output's ``(largest absolute difference, largest magnitude of
    the reference)`` in float64; the difference is infinite where the
    output is missing, its shape is not the reference's or it holds a
    non-finite value."""
    scale = float(want.to(torch.float64).abs().max()) if want.numel() else 0.0
    if got is None or got.shape != want.shape:
        return math.inf, scale
    got, want = got.to(torch.float64), want.to(torch.float64)
    if not bool(torch.isfinite(got).all()):
        return math.inf, scale
    return (float((got - want).abs().max()) if want.numel() else 0.0), scale


def error(diff: float, scale: float) -> float:
    """A difference over the reference's scale: 0 where there is none,
    infinite where the reference is all zeros and the output is not."""
    if diff == 0.0:
        return 0.0
    return diff / scale if scale > 0.0 else math.inf


class Tally:
    """The numbers of one sample, compared block of columns by block: each
    output's largest difference and the reference's largest magnitude are
    kept over the blocks, so :meth:`numbers` reads what one block of all
    the columns would."""

    def __init__(self, checks: Mapping[str, Sequence[str]]):
        self.checks = checks
        self.stats = {n: (0.0, 0.0) for names in checks.values() for n in names}

    def add(self, got: Mapping[str, Tensor], want: Mapping[str, Tensor]) -> None:
        """One block: the sample's outputs and the reference's, both cut to
        the block's columns."""
        for n, (diff, scale) in self.stats.items():
            d, s = output_stats(got.get(n), want[n])
            self.stats[n] = (max(diff, d), max(scale, s))

    def numbers(self) -> Dict[str, float]:
        """Each compared number: the worst :func:`error` of its outputs."""
        return {name: max(error(*self.stats[n]) for n in names) for name, names in self.checks.items()}


def passes(found: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Whether every number is at or below its limit."""
    return all(found[k] <= limits[k] for k in limits)
