# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Hand-written kernels for NVIDIA Hopper, the port of
:mod:`cloudsc2_tpu.pallas`.  Sources in ``csrc/`` are CUDA C++ built by
:mod:`.build` at first use; each wrapper module keeps its kernel's plain
PyTorch version beside it (here or in :mod:`cloudsc2_tpu_torch.physics`)."""
