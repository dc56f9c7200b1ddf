# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Column parallelism: the port of :mod:`cloudsc2_tpu.parallel`.

Columns are physically independent, so the scheme parallelises over them
and over nothing else: a ``('node', 'device')`` mesh of column shards
(:mod:`~cloudsc2_tpu_torch.parallel.mesh`: one node a process, joined by
``torch.distributed`` over gloo; one card a shard, or virtual shards of
the CPU), the step functions and their sharded forms
(:mod:`~cloudsc2_tpu_torch.parallel.step`), and, on one device, a stream of
column chunks through it when they do not fit in its memory
(:mod:`~cloudsc2_tpu_torch.parallel.stream`).  The vertical recurrence
stays inside each shard's kernel; no field crosses a shard, and the
process group carries only the rendezvous and the verdicts.
"""
from cloudsc2_tpu_torch.parallel.mesh import (
    MESH_AXES,
    ColumnMesh,
    ShardedTensor,
    column_mesh,
    gather_columns,
    initialize_distributed,
    pad_columns,
    process_local_block,
    shard_state,
    state_shardings,
    unpad_columns,
)
from cloudsc2_tpu_torch.parallel.step import (
    forward_step,
    full_step,
    make_sharded_fn,
    make_sharded_forward_step,
    make_sharded_physics,
)
from cloudsc2_tpu_torch.parallel.stream import (
    build_ring,
    d2h_bytes_per_column,
    h2d_bytes_per_column,
    stream_columns,
)

__all__ = [
    "MESH_AXES",
    "ColumnMesh",
    "ShardedTensor",
    "build_ring",
    "column_mesh",
    "d2h_bytes_per_column",
    "forward_step",
    "full_step",
    "gather_columns",
    "h2d_bytes_per_column",
    "initialize_distributed",
    "make_sharded_fn",
    "make_sharded_forward_step",
    "make_sharded_physics",
    "pad_columns",
    "process_local_block",
    "shard_state",
    "state_shardings",
    "stream_columns",
    "unpad_columns",
]
