"""Builds the hand-written kernels of ``csrc/`` into shared libraries with a
plain C interface, at first use, and loads them with ctypes.

* :func:`cuda_library` compiles a library's ``.cu`` sources with ``nvcc``
  for sm_90a (Hopper): ``cellforce`` (the three single-phase pair kernels),
  ``nnforce`` (the three multiphase non-Newtonian kernels) or ``probes``
  (the two hardware probes of ``tools/probes.py``).
  :func:`build_cuda_libraries` builds them all at once, one nvcc process
  per library, started together.
* :func:`host_twin_library` compiles the matching ``*_host.cpp`` with
  ``g++``: the same per-thread bodies in a loop on the CPU, for tests.
* :func:`host_library` compiles other C++ sources with ``g++`` (the native
  .bi4 writer, ``native/``).

Each library lands in ``_build/`` inside the package, named by a hash of
its sources, every header of ``csrc/``, its compiler command and the
compiler's ``--version``, so an edited source or another compiler rebuilds
and an unchanged one loads at once.  The compiler's messages (with nvcc,
``-Xptxas -v``: registers, shared memory and spills per kernel) are kept
beside the library as ``<library>.log``.  A build writes to a temporary
name and then renames, so concurrent processes never load a half-written
file.  Any failure raises: there is no fallback.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

# library -> (CUDA sources, host-twin source, {C function: pointer
# arguments of the CUDA launcher}); each twin takes the same arguments but
# the stream
LIBRARIES = {
    "cellforce": (("cellforce.cu",), "cellforce_host.cpp",
                  {"dsph_cellforce": 15, "dsph_cellforce_cubic": 15,
                   "dsph_cellforce_lamsps": 15}),
    "nnforce": (("nnforce.cu",), "nnforce_host.cpp",
                {"dsph_nnforce_p1": 14, "dsph_nnforce_fda": 14,
                 "dsph_nnforce_p3": 11}),
    "probes": (("probe_fma.cu", "probe_gather.cu"), "probes_host.cpp",
               {"dsph_probe_fma": 4, "dsph_probe_gather": 5}),
}

_PTR = ctypes.c_void_p


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build_key(compiler: list, deps: list) -> str:
    """Hash of the compiler command (path included), the compiler's
    ``--version`` output and the contents of ``deps``."""
    res = subprocess.run([compiler[0], "--version"], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{compiler[0]} --version failed:\n"
                           f"{res.stdout}{res.stderr}")
    h = hashlib.sha256("\0".join(compiler).encode())
    h.update(res.stdout.encode())
    for path in deps:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(name: str, compiler: list, sources: list) -> str:
    """Compile ``sources`` (plus every header in csrc/) into
    ``_build/<name>-<key>.so`` unless it is there; returns the path."""
    deps = sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + list(sources)
    out = os.path.join(BUILD_DIR, f"{name}-{build_key(compiler, deps)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = compiler + ["-I", CSRC, "-o", tmp] + list(sources)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    with open(f"{out}.log", "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def _load(path: str, functions: dict, twin: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn_name, nptr in functions.items():
        fn = getattr(lib, fn_name + "_host" if twin else fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_PTR] * (nptr - 1 if twin else nptr)
    return lib


def library_path(name: str) -> str:
    """Where :func:`cuda_library` builds ``name`` (nvcc must be present)."""
    return _build(f"{name}_sm90a", [_find_nvcc()] + NVCC_FLAGS,
                  [os.path.join(CSRC, s) for s in LIBRARIES[name][0]])


@functools.cache
def cuda_library(name: str) -> ctypes.CDLL:
    """The nvcc-built kernels of ``LIBRARIES[name]``."""
    functions = LIBRARIES[name][2]
    return _load(library_path(name), functions, twin=False)


def build_cuda_libraries() -> dict:
    """Build and load every CUDA library, one nvcc process per library, all
    started together; returns {name: seconds until it was loaded}."""
    t0 = time.perf_counter()

    def one(name):
        cuda_library(name)
        return name, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as ex:
        return dict(ex.map(one, LIBRARIES))


def host_library(name: str, sources: list) -> str:
    """Compile the C++ ``sources`` with g++ into ``_build/<name>-<key>.so``
    unless it is there; returns the path."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {name} cannot be built")
    return _build(name, [gxx] + GXX_FLAGS, sources)


@functools.cache
def host_twin_library(name: str) -> ctypes.CDLL:
    """The g++-built CPU twin of ``LIBRARIES[name]``: each ``<fn>_host``
    takes the CUDA launcher's arguments without the stream."""
    _cuda, source, functions = LIBRARIES[name]
    path = host_library(f"{name}_host", [os.path.join(CSRC, source)])
    return _load(path, functions, twin=True)
