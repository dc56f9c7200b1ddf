"""The import guard: nothing under portbench/ imports JAX or the JAX
package, compared by whole top-level names; only the entries and the
tests import the port."""
import subprocess
import sys

import pytest

from portbench import guard


def test_benchmark_has_no_offence():
    assert guard.scan() == []


@pytest.mark.parametrize("where, source, refused", [
    ("reference/x.py", "import jax.numpy as jnp\n", True),
    ("reference/x.py", "from jaxlib import xla_client\n", True),
    ("harness2.py", "import cloudsc2_tpu.physics\n", True),
    ("entries/e.py", "from cloudsc2_tpu.pallas import adjoint\n", True),
    ("entries/e.py", "import flax\n", True),
    ("entries/e.py", "from cloudsc2_tpu_torch import dispatch\n", False),
    ("tests/test_x.py", "import cloudsc2_tpu_torch.kernels\n", False),
    ("reference/x.py", "from cloudsc2_tpu_torch.physics import nonlinear\n", True),
    ("generate2.py", "import cloudsc2_tpu_torch\n", True),
    ("reference/x.py", "from .nonlinear import cloudsc2_nl\nimport jaxtyping\n", False),
])
def test_scan_compares_whole_top_level_names(tmp_path, where, source, refused):
    path = tmp_path / where
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    assert bool(guard.offences(path, tmp_path)) == refused


def test_command_line():
    out = subprocess.run([sys.executable, guard.__file__], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout
