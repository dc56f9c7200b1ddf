# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The column mesh and state sharding for column-parallel CLOUDSC2; the port
of :mod:`cloudsc2_tpu.parallel.mesh` (``MESH_AXES:22``,
``initialize_distributed:26``, ``column_mesh:48``, ``state_shardings:81``,
``shard_state:88``, ``pad_columns:106``, ``unpad_columns:133``,
``process_local_block:138``).

Layout contract (:mod:`cloudsc2_tpu_torch.grid`): full-level fields are
``(nlev, ncols)``, interface fields ``(nlev + 1, ncols)``, eta ``(nlev,)``.
Columns are the only sharded axis; levels stay local because the scheme is
a strict top-down recurrence.

A :class:`ColumnMesh` is a ``('node', 'device')`` grid of column shards,
node-major: shard ``i = node * n_local + d`` holds the ``i``-th contiguous
block of the columns.  Where JAX holds a field over the mesh as one global
array, the port holds this process's shards of it, each on its shard's
``torch.device``, as a :class:`ShardedTensor`.

Processes: one a node, joined by ``torch.distributed`` over gloo
(:func:`initialize_distributed`).  Columns are independent, so no field
crosses processes: the group carries the rendezvous and the few control
messages (the gathered verdicts), as objects.
NCCL would refuse two ranks on one card, which is how a one-card machine
runs two processes.  On CUDA each process takes one card,
``cuda:{local_rank % device_count}``; a single process takes every
visible card, one shard each.  On the CPU, ``n_devices`` virtual shards
share the one CPU device: the counterpart of JAX's
``--xla_force_host_platform_device_count`` mesh, made only when a caller
asks for it.

``torch.distributed.device_mesh.DeviceMesh`` is not used: it maps one rank
to one device, and so cannot express one process that drives several
local shards, which the single-process ``--sharded`` path is.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

#: mesh axis names: ``node`` spans processes, ``device`` the shards of one
#: process.  Columns shard over both.
MESH_AXES = ("node", "device")

#: how long a process waits for the others to join its group
INIT_TIMEOUT = datetime.timedelta(seconds=180)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group (gloo) of a multi-process run; call once per
    process before building the mesh.

    With the three arguments the group forms over ``tcp://`` at
    ``coordinator_address`` (``host:port``, where process 0 listens).
    Without them it forms from ``env://`` when ``WORLD_SIZE`` is set (a
    ``torchrun`` launch); else the run is a single process and nothing
    happens.  A group that exists already is kept.  A group that fails to
    form raises.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    given = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in given):
        if any(v is None for v in given):
            raise ValueError("coordinator_address, num_processes and process_id go together")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=INIT_TIMEOUT)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo", init_method="env://", timeout=INIT_TIMEOUT)


def process_count_and_index() -> Tuple[int, int]:
    """``(processes, this process's index)`` of the group, ``(1, 0)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True)
class ColumnMesh:
    """A ``('node', 'device')`` grid of column shards and this process's
    part of it: ``devices[d]`` holds local shard ``d``, the global shard
    ``process_index * len(devices) + d``."""

    shape: Tuple[int, int]
    process_index: int
    process_count: int
    devices: Tuple[torch.device, ...]

    axis_names = MESH_AXES

    @property
    def size(self) -> int:
        """Shards in the whole mesh (JAX's ``mesh.devices.size``)."""
        return self.shape[0] * self.shape[1]

    @property
    def first_shard(self) -> int:
        """The global index of local shard 0."""
        return self.process_index * len(self.devices)

    def columns(self, ncols: int, d: int) -> Tuple[int, int]:
        """``(start, stop)`` of local shard ``d``'s columns out of ``ncols``."""
        if ncols % self.size:
            raise ValueError(f"{ncols} columns do not split over {self.size} shards (pad_columns first)")
        width = ncols // self.size
        start = (self.first_shard + d) * width
        return start, start + width


def column_mesh(
    n_devices: Optional[int] = None, *, n_nodes: Optional[int] = None, device: str = "cuda"
) -> ColumnMesh:
    """The ``('node', 'device')`` mesh of ``n_devices`` shards, factored
    ``(n_nodes, n_devices // n_nodes)``.

    ``n_nodes`` defaults to the number of processes (1 without a group), so
    that each process is one node; in one process ``n_nodes`` is only a
    factoring.  On ``"cuda"`` the shards are cards: a single process takes
    ``cuda:0`` .. ``cuda:{n_devices - 1}`` (default: every visible card),
    and each process of a group its one card.  More shards than cards
    raise; nothing falls back to the CPU.  On ``"cpu"`` the shards are
    ``n_devices`` virtual shards of the CPU (default: one a process).
    """
    count, index = process_count_and_index()
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh asked for, but torch.cuda.is_available() is False")
        cards = torch.cuda.device_count()
        if count > 1:
            local_rank = int(os.environ.get("LOCAL_RANK", index))
            local = [torch.device("cuda", local_rank % cards)]
        else:
            local = [torch.device("cuda", i) for i in range(cards)]
        available = count * len(local)
        if n_devices is None:
            n_devices = available
        if n_devices > available:
            raise ValueError(f"{n_devices} CUDA shards asked for, but {available} card(s) "
                             f"are visible to {count} process(es)")
    elif kind == "cpu":
        if n_devices is None:
            n_devices = count
    else:
        raise ValueError(f"unsupported mesh device {device!r} (cuda | cpu)")
    if n_devices < 1:
        raise ValueError(f"a mesh needs a shard at least, got {n_devices}")
    if n_nodes is None:
        n_nodes = count
        if n_devices % n_nodes != 0:
            n_nodes = 1
    if n_devices % n_nodes != 0:
        raise ValueError(f"{n_devices} devices not divisible by {n_nodes} nodes")
    if count > 1 and n_nodes != count:
        raise ValueError(f"a mesh over {count} processes has one node each, not {n_nodes}")
    n_local = n_devices // count
    local = local[:n_local] if kind == "cuda" else [torch.device("cpu")] * n_local
    return ColumnMesh((n_nodes, n_devices // n_nodes), index, count, tuple(local))


@dataclass(frozen=True)
class ShardedTensor:
    """This process's shards of one field over a :class:`ColumnMesh`:
    ``shards[d]`` on ``mesh.devices[d]``, its block of the last axis when
    ``column_sharded``, else the whole (replicated) field.  ``shape`` is
    the global shape."""

    mesh: ColumnMesh
    shape: Tuple[int, ...]
    shards: Tuple[Tensor, ...]
    column_sharded: bool

    @property
    def ndim(self) -> int:
        return len(self.shape)


def state_shardings(state: Dict[str, Any]) -> Dict[str, bool]:
    """Per field, whether it is column-sharded: 2-D fields are, 1-D fields
    (eta) are replicated."""
    return {k: v.ndim == 2 for k, v in state.items()}


def _as_tensor(v: Any) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v


def shard_state(state: Dict[str, Any], mesh: ColumnMesh) -> Dict[str, ShardedTensor]:
    """Place a state (numpy arrays or tensors) onto the mesh: each local
    shard's columns of every 2-D field on its device, contiguous, every
    1-D field whole on each.  Every process holds the same full state and
    keeps its own columns, as JAX's multi-host ``make_array_from_callback``
    does.  Fields sharded already pass through."""
    out = {}
    for k, v in state.items():
        if isinstance(v, ShardedTensor):
            out[k] = v
            continue
        t = _as_tensor(v)
        if t.ndim == 2:
            shards = []
            for d, dev in enumerate(mesh.devices):
                start, stop = mesh.columns(t.shape[1], d)
                shards.append(t[:, start:stop].to(dev).contiguous())
        else:
            shards = [t.to(dev) for dev in mesh.devices]
        out[k] = ShardedTensor(mesh, tuple(t.shape), tuple(shards), t.ndim == 2)
    return out


def pad_columns(state: Dict[str, Any], multiple: int) -> Tuple[Dict[str, Any], int]:
    """Pad the column axis of every 2-D field up to ``multiple``.

    Padding replicates column 0 (a valid physical column, so padded lanes
    never produce NaN/inf and never affect real columns: columns are
    independent).  Takes numpy arrays (bitwise the JAX function's) and
    tensors.  Returns ``(padded_state, original_ncols)``.
    """
    ncols = next(v.shape[1] for v in state.values() if v.ndim == 2)
    padded = (-(-ncols // multiple)) * multiple
    if padded == ncols:
        return dict(state), ncols
    pad = padded - ncols

    def _pad(v: Any) -> Any:
        if v.ndim != 2:
            return v
        if isinstance(v, np.ndarray):
            return np.concatenate([v, np.repeat(v[:, :1], pad, axis=1)], axis=1)
        return torch.cat([v, v[:, :1].expand(-1, pad)], dim=1)

    return {k: _pad(v) for k, v in state.items()}, ncols


def unpad_columns(fields: Dict[str, Any], ncols: int) -> Dict[str, Any]:
    """Strip column padding from output field dicts."""
    return {k: (v[..., :ncols] if v.ndim == 2 else v) for k, v in fields.items()}


def gather_columns(x: ShardedTensor, device: Optional[torch.device] = None) -> Tensor:
    """The whole field on one device (default: shard 0's), the shards
    concatenated in column order: the counterpart of ``jax.device_get`` on
    a global array.  Only a single-process mesh holds every shard; in a
    group, each process reads its own block (:func:`process_local_block`)."""
    if x.mesh.process_count > 1:
        raise ValueError("a multi-process field is not fully addressable: use process_local_block")
    device = x.shards[0].device if device is None else device
    if not x.column_sharded or len(x.shards) == 1:
        return x.shards[0].to(device)
    return torch.cat([s.to(device) for s in x.shards], dim=-1)


def process_local_block(x: ShardedTensor) -> Tuple[Tensor, Tuple[int, int]]:
    """This process's contiguous column block of a column-sharded field, on
    its first local device, as ``(block, (col_start, col_stop))``.

    The node-major factoring of :func:`column_mesh` gives each process one
    contiguous column range; this is asserted, not assumed.
    """
    ncols = x.shape[-1]
    ranges = [x.mesh.columns(ncols, d) for d in range(len(x.shards))]
    for (_, stop), (start, _) in zip(ranges, ranges[1:]):
        if start != stop:
            raise ValueError(f"non-contiguous local column shards at {start} != {stop}")
    device = x.shards[0].device
    block = x.shards[0] if len(x.shards) == 1 else torch.cat([s.to(device) for s in x.shards], dim=-1)
    return block, (ranges[0][0], ranges[-1][1])
