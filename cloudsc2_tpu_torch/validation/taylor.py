# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Taylor (V-shape) test: validates the tangent-linear against the nonlinear;
the port of :mod:`cloudsc2_tpu.validation.taylor` (``FLOORS:42``,
``FLOORS_PER_COLUMN:54``, ``TaylorTest:58``, ``run:127``, ``get_norm:176``,
``get_norm_columns:194``, ``validate:223``, ``_validate_per_column:277``,
``column_penalties:330``), with its column ``mesh``.

Perturb the state by ``factor1``, run the TL once, then for each
``factor2`` compare the nonlinear difference ``NL(x + λ δx) − NL(x)``
against ``λ · TL(δx)``.  The ratio must approach 1 as λ shrinks, descend,
then rise again (V-shape) as rounding dominates.  Regularization is off
(``LREGCL=False``).  The schemes run through
:mod:`cloudsc2_tpu_torch.dispatch` (the CUDA kernels for CUDA tensors);
each output dict is moved to the host once and the norms and verdicts are
the JAX module's numpy code, restated here word for word because that
module imports jax.  With a column ``mesh`` the NL and TL run column-sharded
(:func:`cloudsc2_tpu_torch.parallel.step.make_sharded_physics`), their
outputs gathered in column order, and the norms are taken as before.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np
import torch

from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch import dispatch
from cloudsc2_tpu_torch.physics.increment import perturbed_state, state_increment
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.utils.timing import device_sync, timing

Tensor = torch.Tensor

TEND_NAMES = ("t", "q", "ql", "qi")
DIAG_NAMES = ("clc", "fhpsl", "fhpsn", "fplsl", "fplsn", "covptot")

#: verdict floors on ``min |1 - norm|`` over the V-shape descent, by
#: precision regime ``(floor_plus7, floor_plus5)``: the reference's
#: constants are f64-calibrated; a single-precision descent bottoms out at
#: the f32 rounding of the nonlinear difference
FLOORS = {"f64": (1e-5, 1e-6), "f32": (1e-2, 1e-3)}

#: per-column verdict floors (the f32 ones calibrated on the per-column
#: distribution of V bottoms, see the JAX module)
FLOORS_PER_COLUMN = {"f64": (1e-5, 1e-6), "f32": (5e-2, 1e-3)}


def _host(tree: Dict[str, Tensor]) -> Dict[str, np.ndarray]:
    """One dict of outputs as numpy arrays on the host, dtypes kept."""
    return {k: v.cpu().numpy() for k, v in tree.items()}


@dataclass
class TaylorTest:
    """Reference Taylor-test orchestration."""

    constants: Constants
    factor1: float = 0.01
    factor2s: Sequence[float] = tuple(float(10.0 ** -(i + 1)) for i in range(10))
    kflag: int = 1
    lphylin: bool = True
    #: verdict floor calibration: "f64" (reference constants), "f32" (the
    #: measured single-precision V-floor), or "auto" (from the state dtype
    #: seen by :meth:`run`)
    floors: str = "f64"
    #: per-column mode (driver ``--per-column``): the V-shape state machine
    #: on every column's own norm sequence; pass iff at least
    #: :attr:`pass_fraction` of the columns pass individually
    per_column: bool = False
    pass_fraction: float = 0.98
    #: minimum fraction of columns that must pass the strict reference
    #: state machine in per-column mode; the achieved value is stored in
    #: :attr:`strict_fraction`
    min_strict_fraction: float = 0.5
    strict_fraction: float = field(default=None, repr=False)  # type: ignore[assignment]
    #: optional column mesh (:class:`cloudsc2_tpu_torch.parallel.mesh.ColumnMesh`,
    #: single-process): the NL and TL run column-sharded (driver ``--sharded``)
    mesh: object = None
    norms: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]
    _run_dtype: np.dtype = field(default=None, repr=False)  # type: ignore[assignment]
    _fns: tuple = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        # no regularization in the Taylor test
        self.constants = self.constants.replace(LREGCL=False)

    def _nl_tl(self):
        if self._fns is None:
            fns = (dispatch.cloudsc2_nl, dispatch.cloudsc2_tl)
            if self.mesh is not None:
                from cloudsc2_tpu_torch.parallel.step import make_sharded_physics

                fns = tuple(make_sharded_physics(f, self.mesh) for f in fns)
            self._fns = fns
        return self._fns

    def run(self, state: Dict[str, Tensor], dt: float) -> np.ndarray:
        """The norm sequence (``(n_factors,)``, or ``(n_factors, ncols)``
        per column) for ``state`` (the 16 fields and ``eta``)."""
        c = self.constants
        nl_fn, tl_fn = self._nl_tl()
        state = dict(state)
        self._run_dtype = np.dtype(np.float32 if state["t"].dtype == torch.float32 else np.float64)
        with timing("saturation"):
            state["qsat"] = device_sync(saturation(
                state["ap"], state["t"], kflag=self.kflag, lphylin=self.lphylin, c=c
            ))
        with timing("cloudsc2_nl"):
            tends_nl, diags_nl = device_sync(nl_fn(state, dt, c))

        with timing("state_increment"):
            state.update(device_sync(state_increment(state, self.factor1)))
        with timing("cloudsc2_tl"):
            tends_tl, diags_tl = device_sync(tl_fn(state, dt, c))

        # one transfer per dict; the norm loop reduces in numpy
        tends_nl, diags_nl = _host(tends_nl), _host(diags_nl)
        tends_tl, diags_tl = _host(tends_tl), _host(diags_tl)

        ncols = tends_nl["t"].shape[1]
        get = self.get_norm_columns if self.per_column else self.get_norm
        norms = np.zeros(
            (len(self.factor2s), ncols) if self.per_column else len(self.factor2s)
        )
        for i, f2 in enumerate(self.factor2s):
            with timing("perturbed_state"):
                state_p = device_sync(perturbed_state(state, f2))
            with timing("cloudsc2_nl"):
                tends_p, diags_p = device_sync(nl_fn(state_p, dt, c))
            norms[i] = get(
                f2, tends_nl, diags_nl, _host(tends_p), _host(diags_p), tends_tl, diags_tl
            )
        self.norms = norms
        return norms

    @staticmethod
    def get_norm(f2, tends_nl, diags_nl, tends_p, diags_p, tends_tl, diags_tl) -> float:
        """Averaged per-field ratio (reference ``validation.py:219-261``)."""
        total_count = 0
        total_norm = 0.0
        fields = [
            (tends_nl[n], tends_p[n], tends_tl[n + "_i"]) for n in TEND_NAMES
        ] + [(diags_nl[n], diags_p[n], diags_tl[n + "_i"]) for n in DIAG_NAMES]
        for f_nl, f_p, f_tl in fields:
            den = abs(f2 * float(np.sum(f_tl)))
            if den > sys.float_info.epsilon:
                norm = abs(float(np.sum(f_p - f_nl))) / den
            else:
                norm = 0.0
            total_count += norm > 0
            total_norm += norm
        return total_norm / total_count if total_count > 0 else 0.0

    @staticmethod
    def get_norm_columns(
        f2, tends_nl, diags_nl, tends_p, diags_p, tends_tl, diags_tl
    ) -> np.ndarray:
        """:meth:`get_norm` vectorized per column: the same averaged
        per-field ratio (reference ``validation.py:219-261``), with the
        field sums taken over levels only so every column gets its own
        norm sequence."""
        fields = [
            (tends_nl[n], tends_p[n], tends_tl[n + "_i"]) for n in TEND_NAMES
        ] + [(diags_nl[n], diags_p[n], diags_tl[n + "_i"]) for n in DIAG_NAMES]
        ncols = fields[0][0].shape[1]
        total_count = np.zeros(ncols)
        total_norm = np.zeros(ncols)
        for f_nl, f_p, f_tl in fields:
            # accumulate the level sums in f64 (documented deviation from
            # the scalar path's storage-dtype sums): the difference sum
            # cancels heavily, so f32 accumulation noise (~1e-7 of the
            # RUNNING sum per add) dominates the single-precision V bottom
            # for badly-conditioned columns; f64 accumulation leaves only
            # the irreducible f32 STORAGE rounding of the fields themselves
            den = np.abs(f2 * np.sum(f_tl.astype(np.float64), axis=0))
            num = np.abs(
                np.sum(f_p.astype(np.float64) - f_nl.astype(np.float64), axis=0)
            )
            norm = np.where(den > sys.float_info.epsilon, num / np.maximum(den, 1e-300), 0.0)
            total_count += norm > 0
            total_norm += norm
        return np.where(total_count > 0, total_norm / np.maximum(total_count, 1), 0.0)

    def validate(self, norms: np.ndarray | None = None, verbose: bool = True) -> int:
        """V-shape verdict (reference ``validation.py:183-217``).

        Returns the penalty/error code; the test passes iff it is <= 5.
        The min-norm floors are selected by ``self.floors`` (see
        :data:`FLOORS`); the reference's f64 constants are the default.
        """
        mode = self.floors
        if mode == "auto":
            mode = "f32" if self._run_dtype == np.dtype(np.float32) else "f64"
        floor7, floor5 = FLOORS[mode]
        norms = np.array(self.norms if norms is None else norms, dtype=np.float64)
        if norms.ndim == 2:
            floor7, floor5 = FLOORS_PER_COLUMN[mode]
            return self._validate_per_column(norms, floor7, floor5, verbose)
        if verbose:
            print(">>> Taylor test: Start")
        start = -1
        for i in range(norms.size):
            if verbose:
                print(
                    f"  factor1 = {self.factor1:.3e}, factor2 = {self.factor2s[i]:.3e}, "
                    f"norm = {norms[i]:.10f}"
                )
            norms[i] = np.abs(1.0 - norms[i])
            if start == -1 and norms[i] < 0.5:
                start = i

        if start == -1 or start > 3:
            test = 13
            log = "The test failed with error 13."
        else:
            test = -10
            negat = 1
            for i in range(start, norms.size - 1):
                tmp_negat = int(norms[i + 1] < norms[i])
                if negat > tmp_negat:
                    test += 10
                negat = tmp_negat
            if test == -10:
                test = 11
            if np.min(norms[start:]) > floor7:
                test += 7
            if np.min(norms[start:]) > floor5:
                test += 5
            if test > 5:
                log = f"The test failed with error {test}."
            else:
                log = f"The test passed with penalty {test}. HOORAY!"
        if verbose:
            print("<<< Taylor test: End")
            print(log)
        return test

    def _validate_per_column(self, norms, floor7, floor5, verbose) -> int:
        """Per-column V-shape verdict for heterogeneous batches.

        Runs the reference's exact state machine (``validation.py:183-217``)
        on every column's own norm sequence (vectorized), then requires
        ``pass_fraction`` of columns to pass individually.  Returns the
        penalty achieved by that fraction of columns (the
        ``pass_fraction``-quantile of per-column penalties), preserving the
        reference's "pass iff <= 5" contract.
        """
        pen = self.column_penalties(norms, floor7, floor5)
        strict = self.column_penalties(norms, floor7, floor5, strict=True)
        nc = pen.size
        frac = float(np.mean(pen <= 5))
        self.strict_fraction = float(np.mean(strict <= 5))
        # the penalty that pass_fraction of columns achieve (or better)
        k = min(int(np.ceil(self.pass_fraction * nc)), nc) - 1
        test = int(np.sort(pen)[max(k, 0)])
        if self.strict_fraction < self.min_strict_fraction and test <= 5:
            # the adapted verdict passed but the strict reference machine
            # collapsed — the relaxations are doing too much work; fail
            test = 13
            if verbose:
                print(
                    f"  STRICT-MACHINE GATE: only "
                    f"{100.0 * self.strict_fraction:.2f}% of columns pass the "
                    f"strict reference machine (required "
                    f"{100.0 * self.min_strict_fraction:.0f}%)"
                )
        if verbose:
            print(">>> Taylor test: Start (per-column)")
            med = np.median(norms, axis=1)
            for i in range(norms.shape[0]):
                print(
                    f"  factor1 = {self.factor1:.3e}, "
                    f"factor2 = {self.factor2s[i]:.3e}, "
                    f"median norm = {med[i]:.10f}"
                )
            print(
                f"  columns passing individually: {int(np.sum(pen <= 5))}/{nc}"
                f" ({100.0 * frac:.2f}%; required {100.0 * self.pass_fraction:.0f}%;"
                f" floors {floor7:g}/{floor5:g};"
                f" strict reference machine incl. post-bottom jitter:"
                f" {int(np.sum(strict <= 5))}/{nc})"
            )
            print("<<< Taylor test: End")
            if test <= 5:
                print(f"The test passed with penalty {test}. HOORAY!")
            else:
                print(f"The test failed with error {test}.")
        return test

    @staticmethod
    def column_penalties(
        norms: np.ndarray, floor7: float, floor5: float, strict: bool = False
    ) -> np.ndarray:
        """Vectorized V-shape verdict per column: ``norms`` is
        ``(n_factors, ncols)``; returns int penalties ``(ncols,)``.

        ``strict=True`` is exactly the reference scalar state machine
        (``tangent_linear/validation.py:183-217``): start = the FIRST factor
        with ``|1-norm| < 0.5`` (error 13 if none within the first 4), +10
        per break in the monotone descent anywhere in the remaining
        sequence (11 if the descent never turns), +7/+5 for min-norm floors.

        The default (``strict=False``) is the batched-protocol adaptation,
        differing in two documented, principled ways — the strict machine
        was tuned on one well-behaved column and is brittle on arbitrary
        atmospheric states:

        * **post-bottom jitter is not penalized**: descent breaks are
          counted only from the start down to the sequence minimum.  Past
          the V bottom the norm is rounding-dominated (the same rationale
          as the round-3 flat-tail scoring of underflowed f32 norms); a
          wiggle there carries no information about TL correctness.  An
          L-shape (minimum at the last factor, i.e. no observed turn) still
          scores 11 exactly as the reference does.
        * **the start may be ANY of the first four factors** (the best
          verdict over candidate starts with ``|1-norm| < 0.5``), not just
          the first such factor: the reference already accepts a V
          beginning anywhere within the first four; a column whose λ=1e-1
          norm is accidentally near 1 before a branch-crossing bump should
          be judged from the true descent start.
        * **breaks entirely below the +5 floor are ignored** (both values
          under ``floor5``): the floors themselves certify that region as
          converged — micro-jitter at 1e-7 around a 3e-8 bottom (f64) is
          rounding, not a TL defect.

        On a clean V / L / no-start sequence the two machines agree
        exactly (asserted by ``tests/test_tl.py``).
        """
        a = np.abs(1.0 - np.asarray(norms, np.float64))  # (nf, nc)
        nf, nc = a.shape
        desc = a[1:] < a[:-1]  # (nf-1, nc): step i descends
        rows = np.arange(nf - 1)[:, None]

        def machine(start, stop_at_min):
            """Reference state machine from ``start`` (per column), with
            breaks counted only before the argmin when ``stop_at_min``."""
            rmask = np.arange(nf)[:, None] >= start[None, :]
            sub = np.where(rmask, a, np.inf)
            vmin = sub.min(axis=0)
            active = rows >= start[None, :]
            if stop_at_min:
                m = sub.argmin(axis=0)
                active = active & (rows < m[None, :])
            # negat entering step i: True at i == start, else desc[i-1]
            prev = np.vstack([np.ones((1, nc), bool), desc[:-1]])
            prev = np.where(rows == start[None, :], True, prev)
            is_break = active & prev & ~desc
            if stop_at_min:
                # sub-floor5 breaks are rounding (third relaxation above)
                is_break = is_break & (np.maximum(a[:-1], a[1:]) >= floor5)
            breaks = np.sum(is_break, axis=0)
            if stop_at_min:
                # turn observed unless the minimum sits at the last factor
                pen = np.where(m == nf - 1, 11, 10 * breaks)
            else:
                pen = np.where(breaks == 0, 11, -10 + 10 * breaks)
            return pen + 7 * (vmin > floor7) + 5 * (vmin > floor5)

        lt = a < 0.5
        if strict:
            has = lt.any(axis=0)
            start = np.where(has, lt.argmax(axis=0), nf)  # nf == "never"
            ok = has & (start <= 3)
            return np.where(ok, machine(start, False), 13).astype(int)

        best = np.full(nc, np.inf)
        any_valid = np.zeros(nc, bool)
        for s in range(min(4, nf)):
            start = np.full(nc, s)
            pen = np.where(lt[s], machine(start, True), np.inf)
            best = np.minimum(best, pen)
            any_valid |= lt[s]
        return np.where(any_valid, best, 13).astype(int)

    def __call__(self, state: Dict[str, Tensor], dt: float, verbose: bool = True) -> int:
        return self.validate(self.run(state, dt), verbose=verbose)
