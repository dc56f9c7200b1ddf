# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Two probes of the card for Hopper and their wrappers: a read-bandwidth
probe and a divide-chain probe.

:func:`reader_cuda` replaces the Pallas kernel ``make_reader``
(``benchmarks/microbench_hbm.py:45``, ``pallas_call`` at ``:81``): S float32
streams summed per column, ``out[c] = seq + sum_k sum_s in_s[k, c]``.  It is
bound by bytes, ``(S * nlev * ncols + ncols) * 4`` at the HBM rate.  Its
design is the access pattern of the physics kernels (one thread per column,
the levels in a loop, S loads a level; ``csrc/microbench.cu``), so its GB/s
at a kernel's stream count is the yardstick for that kernel's byte bound.
Two layouts: ``global``, each stream ``(nlev, ncols)`` with columns
contiguous (the port's layout, and the memory order of JAX's
``(NLEV, 8, w)``), and ``tile``, each stream ``(nj, nlev, TILE)`` with
column ``j * TILE + i`` (JAX's ``(nj, NLEV, 8, WB)``).  It sums the nlev
real levels: the JAX kernel's grid runs ``ceil(NLEV / KB)`` blocks of 16
levels and at 137 levels its last block lies 7 rows past the array.

:func:`chain_cuda` replaces ``make_chain`` (``benchmarks/microbench_div.py:56``,
``pallas_call`` at ``:65``): one of :data:`VARIANTS` of
``x -> 1.25 / (x + 1)`` applied ``n`` times to every element of a float32
tensor.  It is bound by operations once ``n`` is large
(:data:`CHAIN_OPS` a step; the reciprocals issue on the special-function
unit, so that bound is loose for them), and goes through ``scalar_math.h``'s
divide policies, so it prices the port's own divide code.  Its design is the
physics kernels' too: one thread per element, the chain in registers.

Each CUDA wrapper launches on CUDA tensors and raises for anything else,
and adds one to its ``launches`` where it launches.  :func:`reader` and
:func:`chain` dispatch by device: CUDA tensors to the kernel, CPU tensors to
the plain version (:func:`plain_reader`, :func:`plain_chain`); no fallback.
:func:`reader_host` / :func:`chain_host` run the same bodies compiled for
the CPU, for the tests only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from cloudsc2_tpu_torch.kernels import build
from cloudsc2_tpu_torch.physics import fastmath

Tensor = torch.Tensor

#: the chain's variants, in the order of ``ChainVariant`` in ``csrc/microbench.h``
VARIANTS = ("div", "rcp", "rcpx", "rcpx1", "rcpx2")
#: adds, multiplies, subtractions and divides or reciprocals of one chain step
CHAIN_OPS = {"div": 2, "rcp": 3, "rcpx": 3, "rcpx1": 6, "rcpx2": 9}
#: Newton steps after the approximate reciprocal, by variant
NEWTON_STEPS = {"rcpx": 0, "rcpx1": 1, "rcpx2": 2}
#: the reader's most streams (``kReaderMaxStreams``) and its tile width
MAX_STREAMS = 32
TILE = 4096
LAYOUTS = ("global", "tile")

_P = ctypes.c_void_p
_SIGNATURE = "variants:" + ",".join(VARIANTS) + f";max_streams:{MAX_STREAMS};tile:{TILE}"


@functools.lru_cache(maxsize=None)
def _load(kind: str) -> ctypes.CDLL:
    if kind == "cuda":
        lib = build.load(kind, "cloudsc2_microbench", ["microbench.cu"])
        reader, chain = lib.cloudsc2_reader_launch, lib.cloudsc2_chain_launch
        reader.argtypes = [ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P]
        chain.argtypes = [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P]
    else:
        lib = build.load(kind, "cloudsc2_microbench_host", ["microbench_host.cpp"])
        reader, chain = lib.cloudsc2_reader_host, lib.cloudsc2_chain_host
        reader.argtypes = [ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P]
        chain.argtypes = [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int]
    reader.restype = chain.restype = ctypes.c_int
    lib.cloudsc2_microbench_signature.restype = ctypes.c_char_p
    got = lib.cloudsc2_microbench_signature().decode()
    if got != _SIGNATURE:
        raise RuntimeError(f"probe library reports {got!r}, the wrapper expects {_SIGNATURE!r}")
    return lib


def load_cuda() -> ctypes.CDLL:
    """Build (first use) and load the probes' CUDA library."""
    return _load("cuda")


# ---------------------------------------------------------------- reader


def reader_shape(layout: str, nlev: int, ncols: int) -> Tuple[int, ...]:
    """The shape of one stream of ``ncols`` columns in ``layout``."""
    if layout == "global":
        return (nlev, ncols)
    if layout == "tile":
        return (-(-ncols // TILE), nlev, TILE)
    raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")


def reader_bytes(nstreams: int, nlev: int, ncols: int) -> int:
    """Bytes the reader must move: each value of the streams' ``nlev *
    ncols`` read once, ``ncols`` sums written (float32)."""
    return (nstreams * nlev * ncols + ncols) * 4


def _check_reader(
    streams: Sequence[Tensor], layout: str, ncols: Optional[int], device_type: Optional[str]
) -> Tuple[int, int]:
    """``(nlev, ncols)`` of valid reader arguments; raises otherwise."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"need 1 to {MAX_STREAMS} streams, got {len(streams)}")
    first = streams[0]
    if device_type is not None and first.device.type != device_type:
        raise ValueError(f"streams must be on {device_type}, got {first.device}")
    for i, s in enumerate(streams):
        if s.dtype != torch.float32:
            raise TypeError(f"stream {i} has dtype {s.dtype}, want torch.float32")
        if s.device != first.device or s.shape != first.shape:
            raise ValueError(f"stream {i} is {tuple(s.shape)} on {s.device}, want {tuple(first.shape)} "
                             f"on {first.device}")
        if not s.is_contiguous():
            raise ValueError(f"stream {i} is not contiguous")
    want_dim = 2 if layout == "global" else 3
    if first.dim() != want_dim or first.numel() == 0:
        raise ValueError(f"{layout} streams are {want_dim}-D and non-empty, got {tuple(first.shape)}")
    if layout == "global":
        nlev, width = first.shape
        ncols = width if ncols is None else ncols
        if ncols != width:
            raise ValueError(f"global streams hold {width} columns, not {ncols}")
    else:
        nj, nlev, width = first.shape
        if width != TILE:
            raise ValueError(f"tile streams are (nj, nlev, {TILE}), got {tuple(first.shape)}")
        ncols = nj * TILE if ncols is None else ncols
        if not (nj - 1) * TILE < ncols <= nj * TILE:
            raise ValueError(f"{nj} tiles hold {(nj - 1) * TILE + 1} to {nj * TILE} columns, not {ncols}")
    return nlev, ncols


def plain_reader(streams: Sequence[Tensor], seq: float, layout: str = "global",
                 ncols: Optional[int] = None) -> Tensor:
    """The reader's plain version, ``(ncols,)``: ``seq`` plus every level,
    then every stream, added in the kernel's order (bitwise the kernel)."""
    nlev, ncols = _check_reader(streams, layout, ncols, None)
    if layout == "tile":
        streams = [s.permute(1, 0, 2).reshape(nlev, -1)[:, :ncols] for s in streams]
    acc = torch.full((ncols,), seq, dtype=torch.float32, device=streams[0].device)
    for k in range(nlev):
        for s in streams:
            acc = acc + s[k]
    return acc


def _reader_run(streams, seq, layout, ncols, device_type):
    nlev, ncols = _check_reader(streams, layout, ncols, device_type)
    out = torch.empty(ncols, dtype=torch.float32, device=streams[0].device)
    ptrs = (_P * len(streams))(*(s.data_ptr() for s in streams))
    args = (int(layout == "tile"), ptrs, len(streams), nlev, ncols, float(seq), out.data_ptr())
    return out, args


def reader_cuda(streams: Sequence[Tensor], seq: float, layout: str = "global",
                ncols: Optional[int] = None) -> Tensor:
    """The reader kernel on PyTorch's current stream: contiguous float32
    CUDA streams of one shape (:func:`reader_shape`; ``ncols`` is needed
    only for a ragged tile layout), at most :data:`MAX_STREAMS`.  Raises on
    anything else, on a failed build and on a refused launch.  Each launch
    adds one to ``reader_cuda.launches``."""
    out, args = _reader_run(streams, seq, layout, ncols, "cuda")
    lib = load_cuda()
    with torch.cuda.device(out.device):
        err = lib.cloudsc2_reader_launch(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"reader kernel launch failed: cudaError_t {err}")
    reader_cuda.launches += 1
    return out


reader_cuda.launches = 0  # type: ignore[attr-defined]


def reader_host(streams: Sequence[Tensor], seq: float, layout: str = "global",
                ncols: Optional[int] = None) -> Tensor:
    """The reader's body compiled for the host, on CPU tensors (tests only)."""
    out, args = _reader_run(streams, seq, layout, ncols, "cpu")
    if _load("host").cloudsc2_reader_host(*args) != 0:
        raise RuntimeError("reader host body refused its arguments")
    return out


def reader(streams: Sequence[Tensor], seq: float, layout: str = "global",
           ncols: Optional[int] = None) -> Tensor:
    """The reader by device: CUDA tensors to the kernel, CPU tensors to the
    plain version; any other device raises."""
    kind = streams[0].device.type if streams else "cpu"
    if kind == "cuda":
        return reader_cuda(streams, seq, layout, ncols)
    if kind == "cpu":
        return plain_reader(streams, seq, layout, ncols)
    raise ValueError(f"no reader implementation for device {streams[0].device}")


# ---------------------------------------------------------------- chain


def _check_chain(x: Tensor, variant: str, n: int, device_type: Optional[str]) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if not isinstance(n, int) or n < 0:
        raise ValueError(f"need a step count n >= 0, got {n!r}")
    if x.dtype != torch.float32:
        raise TypeError(f"need float32, got {x.dtype}")
    if device_type is not None and x.device.type != device_type:
        raise ValueError(f"x must be on {device_type}, got {x.device}")
    if not x.is_contiguous() or x.numel() < 1:
        raise ValueError("x must be contiguous and non-empty")


def plain_chain(x: Tensor, variant: str, n: int,
                approx: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """The chain's plain version: the variant's step ``n`` times, each
    operation rounded apart as the kernel does.  ``approx`` is the
    approximate reciprocal; by default :func:`cloudsc2_tpu_torch.physics.fastmath.rcp`'s,
    Pallas interpret mode's ``1/bf16(x)`` (the host build's).  The card's
    is PTX ``rcp.approx.ftz.f32``: given that one
    (:func:`cloudsc2_tpu_torch.kernels.nonlinear.rcp_cuda` in ``approx``
    mode), the plain chain is bitwise the kernel in every variant."""
    _check_chain(x, variant, n, None)
    if approx is None:
        approx = functools.partial(fastmath.rcp, mode="approx")
    one, two, c = (fastmath.scalar(v, x) for v in (1.0, 2.0, 1.25))
    for _ in range(n):
        b = x + one
        if variant == "div":
            x = fastmath.div(c, b)
        elif variant == "rcp":
            x = c * torch.reciprocal(b)
        else:
            r = approx(b)
            for _ in range(NEWTON_STEPS[variant]):
                r = r * (two - b * r)
            x = c * r
    return x


def chain_cuda(x: Tensor, variant: str, n: int, block: int = 128, sm: Optional[Tensor] = None) -> Tensor:
    """The chain kernel on PyTorch's current stream, ``block`` threads a
    block (a multiple of 32 up to 128; 32 puts one warp in a block).  With
    ``sm``, an int32 CUDA tensor of one element per block, the kernel
    writes there the SM that ran each block.  Raises on anything but a
    contiguous float32 CUDA tensor, on a failed build and on a refused
    launch.  Each launch adds one to ``chain_cuda.launches``."""
    _check_chain(x, variant, n, "cuda")
    if block not in (32, 64, 96, 128):
        raise ValueError(f"block must be 32, 64, 96 or 128 threads, got {block}")
    blocks = -(-x.numel() // block)
    if sm is not None and (sm.dtype != torch.int32 or sm.device != x.device or not sm.is_contiguous()
                           or sm.numel() < blocks):
        raise ValueError(f"sm must be a contiguous int32 tensor of at least {blocks} elements on {x.device}")
    y = torch.empty_like(x)
    lib = load_cuda()
    with torch.cuda.device(x.device):
        err = lib.cloudsc2_chain_launch(VARIANTS.index(variant), x.data_ptr(), y.data_ptr(), x.numel(), n,
                                        block, None if sm is None else sm.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain kernel launch failed: cudaError_t {err}")
    chain_cuda.launches += 1
    return y


chain_cuda.launches = 0  # type: ignore[attr-defined]


def chain_host(x: Tensor, variant: str, n: int) -> Tensor:
    """The chain's body compiled for the host, on a CPU tensor (tests only)."""
    _check_chain(x, variant, n, "cpu")
    y = torch.empty_like(x)
    if _load("host").cloudsc2_chain_host(VARIANTS.index(variant), x.data_ptr(), y.data_ptr(), x.numel(), n) != 0:
        raise RuntimeError("chain host body refused its arguments")
    return y


def chain(x: Tensor, variant: str, n: int, block: int = 128) -> Tensor:
    """The chain by device: a CUDA tensor to the kernel (``block`` threads a
    block), a CPU tensor to the plain version (which has no blocks); any
    other device raises."""
    if x.device.type == "cuda":
        return chain_cuda(x, variant, n, block)
    if x.device.type == "cpu":
        return plain_chain(x, variant, n)
    raise ValueError(f"no chain implementation for device {x.device}")
