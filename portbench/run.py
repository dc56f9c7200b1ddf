#!/usr/bin/env python3
"""Run one cell of the port's benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on stdout (see
``portbench/README.md``); exits 2 without the CUDA devices the cell needs,
and 3 if JAX or the JAX package was loaded.
"""
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started, from ``/proc`` (0 where that
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0
    return age if 0.0 <= age < 60.0 else 0.0


START = time.perf_counter() - _process_age()
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run may fill stays at a fixed place in the checkout (the
# kernels themselves build into .kernels_build/ there)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CHECKOUT, ".portbench", "cache", sub)
sys.path.insert(0, CHECKOUT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START))
