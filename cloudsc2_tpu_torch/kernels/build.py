# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Build the hand-written kernels at first use and load them with ctypes.

CUDA sources are compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface; the same headers compiled by ``g++`` give a host
library for the CPU tests.  Libraries go to ``.kernels_build/`` at the root
of the checkout, named by a hash of the sources and the flags, so a change
to either rebuilds.  A failed build raises with the compiler's output.
Nothing is built when a module is imported.

A source builds into one library per form (:func:`form`): the form of the
saturation adjustment and the divide policies it holds, passed as ``-D``
flags (``csrc/scalar_math.h``, "library forms").  Each library holds fewer
bodies than all forms would, the libraries build in parallel, and the
default form's library compiles the same bodies whatever the others add.

:func:`launcher` builds the kernel wrappers' per-call launch path
(``launcher/launcher.cpp``) the same way, with ``g++`` against the installed
torch's headers and libraries, into a Python module that every launch plan
calls (``kernels/nonlinear.py`` ``LaunchPlan``).  A build holds a lock file
beside its library, so concurrent processes (test workers) compile each
library once.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
#: the launch path's source (``launcher.cpp``), apart from the kernels'
LAUNCHER_SRC = Path(__file__).resolve().parent / "launcher"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernels_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
#: one lock per library: two libraries build at once (one compiler process
#: each), one library builds once
_locks: Dict[Tuple[str, ...], threading.Lock] = {}
_loaded: Dict[Tuple[str, ...], ctypes.CDLL] = {}
#: compiler output of the builds made by this process, by library name
#: (ptxas reports registers, spills and shared memory per kernel there)
logs: Dict[str, str] = {}


class BuildError(RuntimeError):
    """A kernel library failed to compile."""


#: ``CLOUDSC2_DIVS`` masks: bit D holds ``fastmath.DIV_MODES[D]`` for float
#: (the exact bit also double, which divides exactly)
EXACT_DIVS, FAST_DIVS, ALL_DIVS = 1, 6, 7


def form(compact: bool, fast: bool, nl: bool = False) -> Tuple[str, Tuple[str, ...]]:
    """``(name suffix, -D flags)`` of the library form that holds a launch.
    ``compact`` is ``CUADJ_COMPACT``, ``fast`` a float32 launch under a
    non-exact divide.  The NL kernel's two libraries hold every divide
    policy, one saturation-adjustment form each.  The TL's and AD's hold
    the compact form with the exact divide (the default, suffix ``""``),
    with the faithful and approx divides (``"_fastdiv"``), and the
    reference-shaped form with every divide (``"_ref"``)."""
    if not compact:
        suffix, divs = "_ref", ALL_DIVS
    elif nl:
        suffix, divs = "", ALL_DIVS
    else:
        suffix, divs = ("_fastdiv", FAST_DIVS) if fast else ("", EXACT_DIVS)
    return suffix, (f"-DCLOUDSC2_COMPACT={int(compact)}", f"-DCLOUDSC2_DIVS={divs}")


#: ``(compact, fast)`` of each form of a TL or AD library, the default first
FORMS = ((True, False), (True, True), (False, False))
#: the same for the NL kernel's libraries
NL_FORMS = ((True, False), (False, False))


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest(sources: Sequence[str], flags: Sequence[str], src: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(src.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h", ".cpp"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(sources).encode())
    return h.hexdigest()[:16]


def _compile(compiler: str, sources: Sequence[str], flags: Sequence[str], name: str,
             libs: Sequence[str] = (), src: Path = CSRC) -> Path:
    """The library ``name`` built from ``sources`` in ``src`` with ``flags``
    (``libs`` after the sources), or the one a build of the same hash
    left."""
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / f"{name}-{_digest(sources, (*flags, *libs), src)}.so"
    if out.exists():
        return out
    # one process compiles, the others wait for its library
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        # compile to a private name and rename: no process loads a
        # half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *flags, "-I", str(src), "-o", tmp, *(str(src / s) for s in sources), *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise BuildError(
                f"{' '.join(cmd)}\nexit {proc.returncode}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    logs[name] = proc.stdout + proc.stderr
    return out


def load(kind: str, name: str, sources: Sequence[str], defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (once per process and per source hash) and load a library.
    ``kind`` is "cuda" (nvcc, sm_90a) or "host" (g++); ``defines`` are
    ``-D`` flags (a :func:`form`).  Calls for different libraries from
    different threads compile in parallel."""
    key = (kind, name, *sources, *defines)
    with _lock:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _loaded:
            if kind == "cuda":
                path = _compile(find_nvcc(), sources, (*NVCC_FLAGS, *defines), name)
            elif kind == "host":
                path = _compile(shutil.which("g++") or "g++", sources, (*HOST_FLAGS, *defines), name)
            else:
                raise ValueError(f"unknown build kind {kind!r}")
            _loaded[key] = ctypes.CDLL(str(path))
        return _loaded[key]


_launcher: Optional[ModuleType] = None
_launcher_lock = threading.Lock()


def launcher_flags(cuda: bool) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """``(flags, libraries)`` of the launcher's build against the installed
    torch: its headers, Python's, its C++ ABI and, with ``cuda``, the CUDA
    toolkit's headers and ``c10_cuda``.  The torch version is a define of
    its own, so another torch builds another library."""
    import torch
    from torch.utils import cpp_extension

    includes = [*cpp_extension.include_paths(), sysconfig.get_paths()["include"]]
    if cuda:
        includes.append(str(Path(find_nvcc()).parents[1] / "include"))
    flags = (*HOST_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             f"-DCLOUDSC2_LAUNCHER_CUDA={int(cuda)}", f'-DCLOUDSC2_TORCH_VERSION="{torch.__version__}"',
             *(f"-I{p}" for p in includes))
    lib_dirs = cpp_extension.library_paths()
    libs = (*(f"-L{p}" for p in lib_dirs), *(f"-Wl,-rpath,{p}" for p in lib_dirs),
            "-lc10", "-ltorch", "-ltorch_cpu", "-ltorch_python", *(("-lc10_cuda",) if cuda else ()))
    return flags, libs


def launcher() -> ModuleType:
    """Build (once per process and per source hash) and import the launch
    path (``launcher/launcher.cpp``): with CUDA where the installed torch is a
    CUDA build, so that it launches on the card and serves the host builds
    too, else for the host builds alone.  A failed build raises
    :class:`BuildError`; nothing falls back."""
    global _launcher
    with _launcher_lock:
        if _launcher is None:
            import torch

            flags, libs = launcher_flags(torch.version.cuda is not None)
            # the module's name carries its build's hash: Python keeps one
            # extension module per name, and two checkouts' launchers (an
            # A/B in one process) differ
            name = f"cloudsc2_launcher_{_digest(['launcher.cpp'], (*flags, *libs), LAUNCHER_SRC)}"
            path = _compile(shutil.which("g++") or "g++", ["launcher.cpp"],
                            (*flags, f"-DCLOUDSC2_LAUNCHER_MODULE={name}"), "cloudsc2_launcher", libs, LAUNCHER_SRC)
            spec = importlib.util.spec_from_file_location(name, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            _launcher = module
        return _launcher
