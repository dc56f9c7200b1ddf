# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Validation protocols; the port of :mod:`cloudsc2_tpu.validation`
(Taylor test so far).  The verdicts are numpy, on outputs moved to the host."""
