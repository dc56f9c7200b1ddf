# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""cloudsc2_tpu_torch — the CLOUDSC2 engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).

A port of :mod:`cloudsc2_tpu` (JAX on a TPU).  The JAX package stays the
reference: each module here mirrors the module of the same name there
(``physics/…`` for ``physics/…``, ``kernels/`` for ``pallas/``) and is
tested against it on the same inputs.  The numpy-only modules of the JAX
package (``grid``, ``params``, ``iox``, ``units``, ``oracle``, ``config``,
``utils.validation``, ``utils.output``, the ``Timer``) are imported, not
copied, so there is one source of constants and I/O.  This package never
imports ``jax``.

Layout is the reference's: full-level fields ``(nlev, ncols)``, interface
fields ``(nlev + 1, ncols)``, columns contiguous.
"""
