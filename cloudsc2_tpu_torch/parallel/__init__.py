# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Step functions and the column-chunked stream; the one-device part of
:mod:`cloudsc2_tpu.parallel`.

Columns are physically independent, so the scheme parallelises over them:
the JAX package shards them over a device mesh, and on one device streams
chunks of them through it when they do not fit in its memory
(:mod:`~cloudsc2_tpu_torch.parallel.stream`).  The port has the step
functions (:mod:`~cloudsc2_tpu_torch.parallel.step`) and the stream; the
column mesh is not ported yet.
"""
from cloudsc2_tpu_torch.parallel.step import forward_step, full_step
from cloudsc2_tpu_torch.parallel.stream import (
    build_ring,
    d2h_bytes_per_column,
    h2d_bytes_per_column,
    stream_columns,
)

__all__ = [
    "build_ring",
    "d2h_bytes_per_column",
    "forward_step",
    "full_step",
    "h2d_bytes_per_column",
    "stream_columns",
]
