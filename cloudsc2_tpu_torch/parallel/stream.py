# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Column-chunked host-to-device streaming: the out-of-memory scaled run; the
port of :mod:`cloudsc2_tpu.parallel.stream`.

A column set larger than the device's memory (about 8.2 KB of inputs a
column in f32 at 137 levels) is swept through one device as a stream of
chunks: the copy of chunk *i+1* to the device runs while chunk *i*
computes, and the outputs stay on the device as one sum a chunk (half
duplex) or go back to a ring of host buffers (full duplex).  Its bound is
the larger, per chunk, of the copy time (:func:`h2d_bytes_per_column` a
column over the host link; in full duplex, with :func:`d2h_bytes_per_column`
the other way at the same time, which the link does not carry at twice its
one-way rate) and the NL kernel's time.

The host column set is a ring of ``ring_size`` distinct chunk-sized buffers
(:func:`build_ring`, bitwise the JAX package's) cycled over ``total_cols``:
host memory stays bounded while every chunk still pays its full copy (the
slots differ, so no layer can skip one).

On the card the design is CUDA's (:func:`sweep_ring`):

* the ring is pinned once, one flat buffer a slot with the fields as views
  into it (:func:`host_ring`), so a chunk's inputs are one asynchronous
  copy; a ring that is not pinned is refused, since a copy from pageable
  memory runs synchronously;
* two device input slots, allocated once: the copy of chunk *i+1* runs on a
  copy stream into the slot that chunk *i-1* read, after the event of that
  compute; the compute stream (PyTorch's current stream, where the NL
  wrapper launches) waits on the copy's event;
* in full duplex the outputs of chunk *i* go to a pinned host slot on a
  third stream, after the compute's event; the host reads chunk *i* only
  once chunk *i+1*'s copy and kernel are enqueued.  The outputs are fresh
  allocations of the compute stream, so each is marked as used by the copy
  stream (``record_stream``) before the allocator may hand its block on.

The sweep calls :func:`~cloudsc2_tpu_torch.parallel.step.forward_step`
directly: the component layer synchronises every call, which would stop
the copies from overlapping.  On the CPU the same function runs the plain
version, chunk after chunk.
"""
from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.parallel.step import forward_step
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.validation.symmetry import TEND_NAMES

Tensor = torch.Tensor

#: the diagnostics a chunk returns to the host in full duplex: the golden
#: ones (not ``qsat``), full levels then interfaces
OUT_DIAGS = ("clc", "covptot", "fhpsl", "fhpsn", "fplsl", "fplsn")
#: field offsets in a flat slot are multiples of this many elements
ALIGN = 64


def h2d_bytes_per_column(nlev: int, itemsize: int) -> int:
    """Host-to-device bytes a column a step: the 14 full-level input fields
    and the interface pressure (``qsat`` and ``eta`` are made on the device)."""
    return itemsize * (14 * nlev + (nlev + 1))


def d2h_bytes_per_column(nlev: int, itemsize: int) -> int:
    """Device-to-host bytes a column a step in full duplex: the 4 tendencies
    and clc / covptot on full levels, the 4 fluxes on interfaces."""
    return itemsize * (6 * nlev + 4 * (nlev + 1))


def build_ring(
    state_np: Dict[str, np.ndarray], chunk_cols: int, ring_size: int
) -> list:
    """Tile the base state to ``chunk_cols`` columns, ``ring_size`` distinct
    host-resident copies.

    Slot 0 is the exact tiling (so golden validation of chunk 0 works);
    later slots carry a per-slot temperature offset of a few mK so the
    buffers are genuinely distinct data.
    """
    base_cols = next(v.shape[1] for v in state_np.values() if np.ndim(v) == 2)
    reps = -(-chunk_cols // base_cols)

    def tile(v: np.ndarray) -> np.ndarray:
        if np.ndim(v) != 2:
            return np.ascontiguousarray(v)
        return np.ascontiguousarray(np.tile(v, (1, reps))[:, :chunk_cols])

    ring = []
    for i in range(ring_size):
        chunk = {k: tile(v) for k, v in state_np.items()}
        if i > 0:
            chunk["t"] = np.ascontiguousarray(chunk["t"] * (1.0 + 1e-6 * i))
        ring.append(chunk)
    return ring


@dataclass
class FlatSlot:
    """One flat buffer and its fields, contiguous views into it."""

    flat: Tensor
    fields: Dict[str, Tensor]


def flat_slot(
    shapes: Mapping[str, Tuple[int, ...]], dtype: torch.dtype, device: torch.device, pin: bool = False
) -> FlatSlot:
    """An uninitialised :class:`FlatSlot` of ``shapes``, each field at an
    offset of a multiple of :data:`ALIGN` elements; ``pin`` pins it (host)."""
    offsets, n = {}, 0
    for k, shape in shapes.items():
        offsets[k] = n
        n += -(-math.prod(shape) // ALIGN) * ALIGN
    flat = torch.empty(n, dtype=dtype, device=device, pin_memory=pin)
    return FlatSlot(flat, {k: flat[o:o + math.prod(shapes[k])].view(shapes[k]) for k, o in offsets.items()})


def host_ring(ring_np: List[Dict[str, np.ndarray]], pin: bool) -> List[FlatSlot]:
    """The numpy ring (:func:`build_ring`) as flat host slots in its dtype,
    pinned with ``pin`` (the card's asynchronous copies need it)."""
    ring = []
    for chunk in ring_np:
        dtype = torch.from_numpy(chunk["ap"]).dtype
        slot = flat_slot({k: v.shape for k, v in chunk.items()}, dtype, torch.device("cpu"), pin)
        for k, v in chunk.items():
            slot.fields[k].copy_(torch.from_numpy(v))
        ring.append(slot)
    return ring


class _CardInputs:
    """Two device slots, filled from the pinned ring on a copy stream; the
    compute stream waits on each copy, each copy on the compute that last
    read its slot."""

    def __init__(self, ring: List[FlatSlot], device: torch.device):
        self.ring = ring
        self.compute = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)
        shapes = {k: tuple(v.shape) for k, v in ring[0].fields.items()}
        self.slots = [flat_slot(shapes, ring[0].flat.dtype, device) for _ in range(2)]
        for slot in self.slots:
            slot.flat.record_stream(self.copy)
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.consumed = [torch.cuda.Event() for _ in range(2)]

    def put(self, i: int) -> None:
        j = i % 2
        self.copy.wait_event(self.consumed[j])  # no wait before the slot's first use
        with torch.cuda.stream(self.copy):
            self.slots[j].flat.copy_(self.ring[i % len(self.ring)].flat, non_blocking=True)
        self.copied[j].record(self.copy)

    def take(self, i: int) -> Dict[str, Tensor]:
        self.compute.wait_event(self.copied[i % 2])
        return self.slots[i % 2].fields

    def release(self, i: int) -> None:
        self.consumed[i % 2].record(self.compute)


class _HostInputs:
    """The ring's own slots, read in order (the CPU)."""

    def __init__(self, ring: List[FlatSlot]):
        self.ring = ring

    def put(self, i: int) -> None:
        pass

    def take(self, i: int) -> Dict[str, Tensor]:
        return self.ring[i % len(self.ring)].fields

    def release(self, i: int) -> None:
        pass


class _HostOutputs:
    """Full duplex: a ring of ``size`` host slots (pinned on the card) that
    each chunk's outputs are copied into, one chunk deep: chunk *i* is read
    (summed, and kept as the sample if it is chunk 0) after chunk *i+1*'s
    copy has been enqueued.  Chunk 0's slot is kept whole as the sample and
    a spare slot, allocated here, takes its place in the ring: no copy of
    the sample inside the timed sweep."""

    def __init__(self, size: int, like: Dict[str, Tensor], device: torch.device):
        card = device.type == "cuda"
        shapes = {k: tuple(v.shape) for k, v in like.items()}
        dtype = like["t"].dtype
        self.slots = [flat_slot(shapes, dtype, torch.device("cpu"), card) for _ in range(size)]
        self.spare = flat_slot(shapes, dtype, torch.device("cpu"), card)
        self.d2h = torch.cuda.Stream(device) if card else None
        self.done = [torch.cuda.Event() if card else None for _ in range(size)]
        self.pending: Optional[Tuple[int, int]] = None
        self.checksum = 0.0
        self.sample: Optional[Dict[str, Tensor]] = None

    def start(self, i: int, outs: Dict[str, Tensor], compute) -> None:
        k = i % len(self.slots)
        if self.pending is not None and self.pending[1] == k:
            self.finish()  # a ring of one slot: read it before it is overwritten
        dst = self.slots[k].fields
        if self.d2h is None:
            for n, v in outs.items():
                dst[n].copy_(v)
        else:
            self.d2h.wait_stream(compute)
            with torch.cuda.stream(self.d2h):
                for n, v in outs.items():
                    dst[n].copy_(v, non_blocking=True)
                    v.record_stream(self.d2h)
            self.done[k].record(self.d2h)
        previous, self.pending = self.pending, (i, k)
        if previous is not None:
            self._read(*previous)

    def finish(self) -> None:
        if self.pending is not None:
            self._read(*self.pending)
            self.pending = None

    def _read(self, i: int, k: int) -> None:
        if self.done[k] is not None:
            self.done[k].synchronize()
        fields = self.slots[k].fields
        # every chunk's host data is consumed (the half duplex's role of the
        # on-device sum of every chunk)
        self.checksum += float(fields["t"].numpy().sum())
        if i == 0:
            self.sample, self.slots[k] = fields, self.spare


def sweep_ring(
    ring: List[FlatSlot],
    dt: float,
    c: Constants,
    *,
    nchunks: int,
    device,
    fuse_saturation: bool = True,
    stream_outputs: bool = False,
    progress_every: int = 0,
) -> Tuple[dict, Tuple[Dict[str, Tensor], Dict[str, Tensor]]]:
    """Sweep ``nchunks`` chunks, chunk *i* from ring slot ``i % len(ring)``,
    through ``device``; :func:`stream_columns` once the ring is built.

    On a CUDA ``device`` every slot of ``ring`` must be pinned
    (``ValueError`` otherwise) and the compute runs on the device's current
    stream.  Returns ``(stats, (tends0, diags0))`` as
    :func:`stream_columns` does.
    """
    device = torch.device(device)
    if device.type == "cuda":
        pageable = [i for i, slot in enumerate(ring) if not slot.flat.is_pinned()]
        if pageable:
            raise ValueError(
                f"ring slots {pageable} are pageable: a copy from them would run synchronously; "
                "build the ring with host_ring(..., pin=True)"
            )
        inputs = _CardInputs(ring, device)
        compute = inputs.compute
    elif device.type == "cpu":
        inputs, compute = _HostInputs(ring), None
    else:
        raise ValueError(f"unsupported device {device} (cuda | cpu)")
    if nchunks < 1:
        raise ValueError(f"need nchunks >= 1, got {nchunks}")

    def step(i: int) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        s = dict(inputs.take(i), eta=eta)
        out = forward_step(s, dt, c, fuse_saturation)
        inputs.release(i)
        return out

    # eta is global and loop-invariant (reference EtaLevels runs before the
    # hot loop): derived once from slot 0.  A warm-up step (the kernel's
    # build, the first copy) runs outside the timed sweep (reference
    # warm-up call, run_nonlinear.py:109).
    inputs.put(0)
    first = inputs.take(0)
    eta = eta_levels(first["ap"], first["aph"])
    tends0, diags0 = step(0)
    float(tends0["t"][0].sum())

    outputs = None
    if stream_outputs:
        like = {**tends0, **{n: diags0[n] for n in OUT_DIAGS}}
        outputs = _HostOutputs(len(ring), like, device)
    sums = []
    t_start = time.perf_counter()
    inputs.put(0)
    for i in range(nchunks):
        if progress_every and i and i % progress_every == 0:
            # a marker on stderr only (no device sync): a long sweep that is
            # cut leaves a rate
            el = time.perf_counter() - t_start
            print(
                f"[stream {time.strftime('%H:%M:%S')}] chunk {i}/{nchunks}, "
                f"{el:.0f}s, ~{i * ring[0].fields['ap'].shape[1] / el:.0f} cols/s",
                file=sys.stderr, flush=True,
            )
        if i + 1 < nchunks:
            inputs.put(i + 1)
        tends, diags = step(i)
        if outputs is not None:
            outputs.start(i, {**tends, **{n: diags[n] for n in OUT_DIAGS}}, compute)
        else:
            sums.append(torch.sum(tends["t"]))
            if i == 0:
                tends0, diags0 = tends, diags
    if outputs is not None:
        outputs.finish()
        checksum = outputs.checksum  # every chunk's sum, as in half duplex
        sample = outputs.sample
        tends0 = {n: sample[n] for n in TEND_NAMES}
        diags0 = {n: sample[n] for n in OUT_DIAGS}
    else:
        checksum = float(torch.sum(torch.stack(sums)))  # the one end-of-sweep sync
    wall = time.perf_counter() - t_start

    nlev, chunk_cols = ring[0].fields["ap"].shape
    cols = nchunks * chunk_cols
    itemsize = ring[0].flat.element_size()
    bpc = h2d_bytes_per_column(nlev, itemsize)
    stats = {
        "total_cols": cols,
        "chunk_cols": chunk_cols,
        "nchunks": nchunks,
        "wall_s": wall,
        "cols_per_sec": cols / wall,
        "h2d_bytes_per_col": bpc,
        "effective_h2d_gbps": cols / wall * bpc / 1e9,
        "checksum": checksum,
    }
    if stream_outputs:
        d_bpc = d2h_bytes_per_column(nlev, itemsize)
        stats["d2h_bytes_per_col"] = d_bpc
        stats["effective_d2h_gbps"] = cols / wall * d_bpc / 1e9
        stats["duplex_bytes_per_col"] = bpc + d_bpc
    return stats, (tends0, diags0)


def stream_columns(
    state_np: Dict[str, np.ndarray],
    dt: float,
    c: Constants,
    *,
    total_cols: int,
    chunk_cols: int,
    ring_size: int = 4,
    device="cuda",
    fuse_saturation: bool = True,
    stream_outputs: bool = False,
    progress_every: int = 0,
) -> Tuple[dict, Tuple[Dict[str, Tensor], Dict[str, Tensor]]]:
    """Sweep ``total_cols`` columns through ``device`` in ``chunk_cols``
    chunks, the copies to the device overlapped with the compute.

    ``state_np`` is the base state in numpy (its dtype is the run's),
    tiled to the chunk into a ring of ``ring_size`` slots; the number of
    chunks is ``ceil(total_cols / chunk_cols)`` and ``stats["total_cols"]``
    is that times ``chunk_cols``.  Each chunk runs
    :func:`~cloudsc2_tpu_torch.parallel.step.forward_step`
    (``fuse_saturation``; ``c.FAST_DIV`` its divide mode).

    Returns ``(stats, (tends0, diags0))``: ``stats`` the timed sweep's
    throughput (the JAX package's keys), and chunk 0's outputs for golden
    validation.  ``stream_outputs=False`` (half duplex): each chunk's
    ``tends["t"]`` is summed on the device and the host synchronises once,
    at the end; chunk 0's outputs stay on the device.
    ``stream_outputs=True`` (full duplex, the reference's outputs-every-run
    contract): each chunk's 4 tendencies and 6 golden diagnostics go to a
    host ring of ``ring_size`` reused buffers, overlapped with the next
    chunk's copy and compute, and the checksum is the host's sum over every
    chunk; chunk 0's *host* copy is returned, so validating it certifies
    the return copy too.

    ``device`` is ``"cuda"`` unless the caller asks for the CPU, where the
    plain version runs; a CUDA device on a machine without one raises.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False")
    if total_cols < 1 or chunk_cols < 1 or ring_size < 1:
        raise ValueError(f"need positive sizes, got {(total_cols, chunk_cols, ring_size)}")
    ring = host_ring(build_ring(state_np, chunk_cols, ring_size), pin=device.type == "cuda")
    return sweep_ring(
        ring, dt, c, nchunks=math.ceil(total_cols / chunk_cols), device=device,
        fuse_saturation=fuse_saturation, stream_outputs=stream_outputs, progress_every=progress_every,
    )
