# Frozen copy of cloudsc2_tpu_torch/params.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Physical-parameter groups and the constant bundle of the port; the port's
own copy of :mod:`cloudsc2_tpu.params` (the port imports nothing of the JAX
package).

The reference framework reads six Fortran-namelist-style parameter groups from
HDF5 scalar datasets and bakes them into GT4Py kernels as compile-time
externals (reference: ``src/cloudsc2_gt4py/iox.py:25-209``,
``physics/nonlinear/microphysics.py:62-79``).

Here each group is a frozen ``dataclass`` of plain Python floats/bools/ints.
The plain versions read them as Python numbers; the kernels receive them
folded into their constant structs (:mod:`cloudsc2_tpu_torch.state`).

Defaults follow the published ECMWF IFS values so that the framework is
usable without the (upstream, unshipped) ``input.h5``; every value is
overridden by the HDF5 file when one is provided (see
:mod:`cloudsc2_tpu_torch.iox`).  :func:`constants_from_mapping` rebuilds a
:class:`Constants` from a plain mapping of its fields, such as
``dataclasses.asdict`` of the JAX package's bundle, so that both packages
can compute with the same numbers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping

__all__ = [
    "constants_from_mapping",
    "YoethfParams",
    "YomcstParams",
    "YrecldpParams",
    "YrephliParams",
    "YrnclParams",
    "YrphncParams",
    "Constants",
    "make_constants",
]

# -- Fundamental thermodynamic constants (IFS YOMCST conventions) ------------
_R = 8314.47  # universal gas constant J/(kmol K) (IFS value)
_MD = 28.9644  # molar mass dry air
_MV = 18.0153  # molar mass water vapour
_RD = 1000.0 * _R / _MD
_RV = 1000.0 * _R / _MV
_RCPD = 3.5 * _RD
_RTT = 273.16
_RLVTT = 2.5008e6
_RLSTT = 2.8345e6
_RLMLT = _RLSTT - _RLVTT
_RG = 9.80665


@dataclass(frozen=True)
class YomcstParams:
    """Fundamental constants (reference ``iox.py:48-57``)."""

    RCPD: float = _RCPD
    RD: float = _RD
    RETV: float = _RV / _RD - 1.0
    RG: float = _RG
    RLMLT: float = _RLMLT
    RLSTT: float = _RLSTT
    RLVTT: float = _RLVTT
    RTT: float = _RTT
    RV: float = _RV


@dataclass(frozen=True)
class YoethfParams:
    """Saturation-thermodynamics constants (reference ``iox.py:25-45``)."""

    R2ES: float = 611.21 * _MV / _MD
    R3IES: float = 22.587
    R3LES: float = 17.502
    R4IES: float = -0.7
    R4LES: float = 32.19
    R5ALSCP: float = 22.587 * (_RTT + 0.7) * _RLSTT / _RCPD
    R5ALVCP: float = 17.502 * (_RTT - 32.19) * _RLVTT / _RCPD
    R5IES: float = 22.587 * (_RTT + 0.7)
    R5LES: float = 17.502 * (_RTT - 32.19)
    RALFDCP: float = _RLMLT / _RCPD
    RALSDCP: float = _RLSTT / _RCPD
    RALVDCP: float = _RLVTT / _RCPD
    RKOOP1: float = 2.583
    RKOOP2: float = 0.48116e-2
    RTICE: float = _RTT - 23.0
    RTICECU: float = _RTT - 23.0
    RTWAT: float = _RTT
    RTWAT_RTICECU_R: float = 1.0 / 23.0
    RTWAT_RTICE_R: float = 1.0 / 23.0
    RVTMP2: float = 0.0


@dataclass(frozen=True)
class YrecldpParams:
    """Cloud-scheme namelist (reference ``iox.py:60-182``).

    Only ``RCLCRIT``, ``RKCONV``, ``RLMIN`` and ``RPECONS`` are consumed by the
    CLOUDSC2 kernels; the remaining fields are carried for schema parity with
    the reference HDF5 layout (keys prefixed ``YRECLDP_``) and default to
    published IFS values where known, else 0.
    """

    LAERICEAUTO: bool = False
    LAERICESED: bool = False
    LAERLIQAUTOCP: bool = False
    LAERLIQAUTOCPB: bool = False
    LAERLIQAUTOLSP: bool = False
    LAERLIQCOLL: bool = False
    LCLDBUDGET: bool = False
    LCLDEXTRA: bool = False
    NAECLBC: int = 0
    NAECLDU: int = 0
    NAECLOM: int = 0
    NAECLSS: int = 0
    NAECLSU: int = 0
    NAERCLD: int = 0
    NBETA: int = 0
    NCLDDIAG: int = 0
    NCLDTOP: int = 15
    NSHAPEP: int = 0
    NSHAPEQ: int = 0
    NSSOPT: int = 1
    RAMID: float = 0.8
    RAMIN: float = 1e-8
    RCCN: float = 125.0
    RCCNOM: float = 0.0
    RCCNSS: float = 0.0
    RCCNSU: float = 0.0
    RCLCRIT: float = 0.3e-3
    RCLCRIT_LAND: float = 5e-4
    RCLCRIT_SEA: float = 2.5e-4
    RCLDIFF: float = 1e-6
    RCLDIFF_CONVI: float = 1.0
    RCLDMAX: float = 5e-3
    RCLDTOPCF: float = 0.1
    RCLDTOPP: float = 100.0
    RCL_AI: float = 0.069
    RCL_APB1: float = 714.86
    RCL_APB2: float = 61.117
    RCL_APB3: float = 3.8646
    RCL_AR: float = 523.5988
    RCL_AS: float = 0.069
    RCL_BI: float = 2.0
    RCL_BR: float = 3.0
    RCL_BS: float = 2.0
    RCL_CDENOM1: float = 0.0
    RCL_CDENOM2: float = 0.0
    RCL_CDENOM3: float = 0.0
    RCL_CI: float = 16.8
    RCL_CONST1I: float = 0.0
    RCL_CONST1R: float = 0.0
    RCL_CONST1S: float = 0.0
    RCL_CONST2I: float = 0.0
    RCL_CONST2R: float = 0.0
    RCL_CONST2S: float = 0.0
    RCL_CONST3I: float = 0.0
    RCL_CONST3R: float = 0.0
    RCL_CONST3S: float = 0.0
    RCL_CONST4I: float = 0.0
    RCL_CONST4R: float = 0.0
    RCL_CONST4S: float = 0.0
    RCL_CONST5I: float = 0.0
    RCL_CONST5R: float = 0.0
    RCL_CONST5S: float = 0.0
    RCL_CONST6I: float = 0.0
    RCL_CONST6R: float = 0.0
    RCL_CONST6S: float = 0.0
    RCL_CONST7S: float = 0.0
    RCL_CONST8S: float = 0.0
    RCL_CR: float = 130.0
    RCL_CS: float = 4.84
    RCL_DI: float = 2.0
    RCL_DR: float = 0.5
    RCL_DS: float = 0.25
    RCL_DYNVISC: float = 1.717e-5
    RCL_FAC1: float = 0.0
    RCL_FAC2: float = 0.0
    RCL_FZRAB: float = -66.0
    RCL_FZRBB: float = 100.0
    RCL_KA273: float = 2.4e-2
    RCL_KKAac: float = 67.0
    RCL_KKAau: float = 1350.0
    RCL_KKBac: float = 1.15
    RCL_KKBaun: float = -1.79
    RCL_KKBauq: float = 2.47
    RCL_KK_cloud_num_land: float = 300e6
    RCL_KK_cloud_num_sea: float = 50e6
    RCL_SCHMIDT: float = 0.6
    RCL_X1I: float = 0.0
    RCL_X1R: float = 0.0
    RCL_X1S: float = 0.0
    RCL_X2I: float = 0.0
    RCL_X2R: float = 0.0
    RCL_X2S: float = 0.0
    RCL_X3I: float = 0.0
    RCL_X3S: float = 0.0
    RCL_X41: float = 0.0
    RCL_X4R: float = 0.0
    RCL_X4S: float = 0.0
    RCOVPMIN: float = 0.1
    RDENSREF: float = 1.0
    RDENSWAT: float = 1000.0
    RDEPLIQREFDEPTH: float = 500.0
    RDEPLIQREFRATE: float = 0.1
    RICEHI1: float = 0.0
    RICEHI2: float = 0.0
    RICEINIT: float = 1e-12
    RKCONV: float = 1.0 / 6000.0
    RKOOPTAU: float = 10800.0
    RLCRITSNOW: float = 4e-5
    RLMIN: float = 1e-8
    RNICE: float = 0.027
    RPECONS: float = 5.547e-5
    RPRC1: float = 100.0
    RPRC2: float = 0.5
    RPRECRHMAX: float = 0.7
    RSNOWLIN1: float = 1e-3
    RSNOWLIN2: float = 0.025
    RTAUMEL: float = 7200.0
    RTHOMO: float = 235.16
    RVICE: float = 0.13
    RVRAIN: float = 4.0
    RVRFACTOR: float = 0.05
    RVSNOW: float = 1.0


@dataclass(frozen=True)
class YrephliParams:
    """Linearized-physics namelist (reference ``iox.py:185-201``)."""

    LTLEVOL: bool = False
    LPHYLIN: bool = True
    LENOPERT: bool = True
    LEPPCFLS: bool = False
    LRAISANEN: bool = False
    RLPTRC: float = 266.425
    RLPAL1: float = 0.15
    RLPAL2: float = 20.0
    RLPBB: float = 5.0
    RLPCC: float = 5.0
    RLPDD: float = 5.0
    RLPMIXL: float = 4000.0
    RLPBETA: float = 0.2
    RLPDRAG: float = 0.0
    RLPEVAP: float = 0.0
    RLPP00: float = 30000.0


@dataclass(frozen=True)
class YrnclParams:
    """Regularization switch (reference ``iox.py:204-205``)."""

    LREGCL: bool = True


@dataclass(frozen=True)
class YrphncParams:
    """Physics switches (reference ``iox.py:208-209``)."""

    LEVAPLS2: bool = False


@dataclass(frozen=True)
class Constants:
    """Flattened constant bundle consumed by the CLOUDSC2 schemes: the
    merged GT4Py externals dict of ``physics/nonlinear/microphysics.py:62-78``
    (plus TL/AD variants), field for field as the JAX package's bundle.  All
    fields are plain Python scalars."""

    # YOMCST
    RCPD: float
    RD: float
    RETV: float
    RG: float
    RLMLT: float
    RLSTT: float
    RLVTT: float
    RTT: float
    # YOETHF
    R2ES: float
    R3IES: float
    R3LES: float
    R4IES: float
    R4LES: float
    R5ALSCP: float
    R5ALVCP: float
    R5IES: float
    R5LES: float
    RALSDCP: float
    RALVDCP: float
    RTICE: float
    RTICECU: float
    RTWAT: float
    RTWAT_RTICECU_R: float
    RTWAT_RTICE_R: float
    RVTMP2: float
    # YRECLDP (used subset)
    RCLCRIT: float
    RKCONV: float
    RLMIN: float
    RPECONS: float
    # YREPHLI
    RLPTRC: float
    # scheme switches / literals (reference microphysics.py:68-78)
    ICALL: int = 0
    LPHYLIN: bool = True
    LDRAIN1D: bool = False
    LEVAPLS2: bool = False
    LREGCL: bool = True
    ZEPS1: float = 1e-12
    ZEPS2: float = 1e-10
    ZQMAX: float = 0.5
    ZSCAL: float = 0.9
    #: divide strategy ("exact" | "faithful" | "approx"), in the plain
    #: versions and every kernel; float64 always divides exactly, and an
    #: unknown mode raises (``physics.nonlinear.check_constants``).
    FAST_DIV: str = "exact"
    #: predicate-select strategy of the JAX level bodies; the select and
    #: the mask form give bit-identical NL/TL outputs, and the port has
    #: only the select form, so it ignores this switch.
    MASK_SELECT: bool = False
    #: saturation-adjustment form.  ``True`` (default): the compact
    #: cor-free condensation quotient; ``False``: the reference-shaped
    #: ``cor``-based form (``physics/cuadjtqs.py``).
    CUADJ_COMPACT: bool = True

    def replace(self, **kw: Any) -> "Constants":
        return dataclasses.replace(self, **kw)


def make_constants(
    yoethf: YoethfParams | None = None,
    yomcst: YomcstParams | None = None,
    yrecldp: YrecldpParams | None = None,
    yrephli: YrephliParams | None = None,
    yrncl: YrnclParams | None = None,
    yrphnc: YrphncParams | None = None,
    *,
    lphylin: bool = True,
    ldrain1d: bool = False,
    lregcl: bool | None = None,
) -> Constants:
    """Build the kernel constant bundle from the six parameter groups."""
    yoethf = yoethf or YoethfParams()
    yomcst = yomcst or YomcstParams()
    yrecldp = yrecldp or YrecldpParams()
    yrephli = yrephli or YrephliParams()
    yrncl = yrncl or YrnclParams()
    yrphnc = yrphnc or YrphncParams()
    return Constants(
        RCPD=yomcst.RCPD,
        RD=yomcst.RD,
        RETV=yomcst.RETV,
        RG=yomcst.RG,
        RLMLT=yomcst.RLMLT,
        RLSTT=yomcst.RLSTT,
        RLVTT=yomcst.RLVTT,
        RTT=yomcst.RTT,
        R2ES=yoethf.R2ES,
        R3IES=yoethf.R3IES,
        R3LES=yoethf.R3LES,
        R4IES=yoethf.R4IES,
        R4LES=yoethf.R4LES,
        R5ALSCP=yoethf.R5ALSCP,
        R5ALVCP=yoethf.R5ALVCP,
        R5IES=yoethf.R5IES,
        R5LES=yoethf.R5LES,
        RALSDCP=yoethf.RALSDCP,
        RALVDCP=yoethf.RALVDCP,
        RTICE=yoethf.RTICE,
        RTICECU=yoethf.RTICECU,
        RTWAT=yoethf.RTWAT,
        RTWAT_RTICECU_R=yoethf.RTWAT_RTICECU_R,
        RTWAT_RTICE_R=yoethf.RTWAT_RTICE_R,
        RVTMP2=yoethf.RVTMP2,
        RCLCRIT=yrecldp.RCLCRIT,
        RKCONV=yrecldp.RKCONV,
        RLMIN=yrecldp.RLMIN,
        RPECONS=yrecldp.RPECONS,
        RLPTRC=yrephli.RLPTRC,
        LPHYLIN=lphylin,
        LDRAIN1D=ldrain1d,
        LEVAPLS2=yrphnc.LEVAPLS2,
        LREGCL=yrncl.LREGCL if lregcl is None else lregcl,
    )


def params_from_mapping(cls: type, mapping: Mapping[str, Any], prefix: str = "") -> Any:
    """Fill a parameter dataclass from a mapping (e.g. HDF5 scalars).

    Mirrors ``ifs_physics_common.iox.HDF5Operator.get_params``: missing keys
    fall back to the dataclass defaults.
    """
    kwargs = {}
    for field in dataclasses.fields(cls):
        key = prefix + field.name
        if key in mapping:
            raw = mapping[key]
            if field.type in ("bool", bool):
                kwargs[field.name] = bool(raw)
            elif field.type in ("int", int):
                kwargs[field.name] = int(raw)
            else:
                kwargs[field.name] = float(raw)
    return cls(**kwargs)


def constants_from_mapping(d: Mapping[str, Any]) -> Constants:
    """A :class:`Constants` from a plain mapping of all its fields, such as
    ``dataclasses.asdict`` of the JAX package's bundle.  Raises
    ``ValueError`` on a missing or an unknown key."""
    names = [f.name for f in dataclasses.fields(Constants)]
    missing = sorted(set(names) - set(d))
    unknown = sorted(set(d) - set(names))
    if missing or unknown:
        raise ValueError(f"constants mapping: missing keys {missing}, unknown keys {unknown}")
    return Constants(**{n: d[n] for n in names})
