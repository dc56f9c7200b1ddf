# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Framework utilities.  Validation and performance output are the JAX
package's numpy-only modules (:mod:`cloudsc2_tpu.utils.validation`,
:mod:`cloudsc2_tpu.utils.output`); only the device sync is torch's."""
