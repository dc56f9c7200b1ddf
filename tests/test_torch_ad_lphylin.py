# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The AD with ``LPHYLIN=False``, on the CPU.

The TL, and so the AD, does not read ``LPHYLIN``
(``cloudsc2_tpu/physics/tangent_linear.py:26-27``): the JAX package's scan
AD gives the same numbers under either setting, and its ``Cloudsc2AD``
component computes that adjoint for ``LPHYLIN=False``
(``cloudsc2_tpu/components.py:410-423``).  The port's kernels run their
forward sweep under linearized physics (``kernels.adjoint.forward_constants``),
which is the TL's own forward.

* The kernels' host bodies (the two-kernel AD, its ``cotangent_only`` form,
  the fused AD rolled and resident) with ``LPHYLIN=False``: bitwise their
  ``LPHYLIN=True`` launch on the same state (whose qsat
  ``Saturation(lphylin=False)`` made), f64 and f32, in the three switch
  configurations.
* The plain AD with ``LPHYLIN=False`` against the JAX scan AD with it, f64:
  every field within 1e-10 of its largest magnitude (``ad_limit``), and
  bitwise the plain AD with ``LPHYLIN=True``.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.physics.adjoint import cloudsc2_ad
from tests.torch_helpers import CONFIGS, as_jax, assert_ad, flat, jax_constants, port_ad_state

torch.set_num_threads(1)

TYPES = {"f64": np.float64, "f32": np.float32}


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("tag", list(TYPES))
def test_host_ad_without_lphylin_is_the_lphylin_launch(tag, cfg):
    c = CONFIGS[cfg]()
    off = c.replace(LPHYLIN=False)
    _, state, dt = iox.synthesize_input(ncols=24, nlev=41, seed=4, dtype=TYPES[tag])
    s = port_ad_state(state, TYPES[tag], off, dt)
    runs = {
        "two-kernel": lambda cc: adk.cloudsc2_ad_host(s, dt, cc),
        "cotangent_only": lambda cc: adk.cloudsc2_ad_host(s, dt, cc, cotangent_only=True),
        "fused rolled": lambda cc: adk.cloudsc2_ad_fused_host(s, dt, cc),
        "fused resident": lambda cc: adk.cloudsc2_ad_fused_host(s, dt, cc, resident=True),
    }
    for form, run in runs.items():
        want, got = flat(run(c)), flat(run(off))
        assert got.keys() == want.keys() and len(want) == (16 if form == "cotangent_only" else 26)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{form} {k}")


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_ad_without_lphylin_matches_jax_scan_f64(cfg):
    from cloudsc2_tpu.physics.adjoint import cloudsc2_ad as jad

    c = CONFIGS[cfg]()
    off = c.replace(LPHYLIN=False)
    _, state, dt = iox.synthesize_input(ncols=16, nlev=137, seed=1)
    s = port_ad_state(state, np.float64, off, dt)
    got = flat(cloudsc2_ad(s, dt, off))
    assert_ad(got, flat(jad(as_jax(s), dt, jax_constants(off))), np.float64, cfg)
    want = flat(cloudsc2_ad(s, dt, c))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
