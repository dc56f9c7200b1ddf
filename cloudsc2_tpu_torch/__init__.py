# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""cloudsc2_tpu_torch — the CLOUDSC2 engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).

A port of :mod:`cloudsc2_tpu` (JAX on a TPU).  The JAX package stays the
reference: each module here mirrors the module of the same name there
(``physics/…`` for ``physics/…``, ``kernels/`` for ``pallas/``) and is
tested against it on the same inputs.  This package imports nothing of
the JAX package and never imports ``jax``: it keeps its own copies of the
numpy-only modules it needs (``grid``, ``params``, ``iox``, ``units``,
``oracle``, the driver ``Config``, ``utils.validation``, ``utils.output``,
the ``Timer``), and its tests hold each copy equal to its original.

Layout is the reference's: full-level fields ``(nlev, ncols)``, interface
fields ``(nlev + 1, ncols)``, columns contiguous.
"""
