# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Framework utilities: timing and the device sync, golden validation,
performance output, and the field-by-field comparison of the kernels with
their plain versions."""
