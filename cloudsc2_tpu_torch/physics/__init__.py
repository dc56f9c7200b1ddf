# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Plain PyTorch physics: pointwise functions on tensors of any device.

Each function mirrors the function of the same name in
:mod:`cloudsc2_tpu.physics` expression by expression, so that the same
inputs give the same roundings (see :mod:`.fastmath` for the two places
where PyTorch's scalar arithmetic needs help to round as JAX does).
"""
