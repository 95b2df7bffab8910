"""Builds the hand-written kernels of ``csrc/`` into shared libraries with a
plain C interface, at first use, and loads them with ctypes.

* :func:`cuda_library` compiles ``cellforce.cu`` with ``nvcc`` for sm_90a
  (Hopper).
* :func:`host_twin_library` compiles ``cellforce_host.cpp`` with ``g++``:
  the same per-target body in a loop on the CPU, for tests.

Each library lands in ``_build/`` inside the package, named by a hash of
its sources, its compiler command and the compiler's ``--version``, so an
edited source or another compiler rebuilds and an unchanged one loads at
once.  A build writes to a temporary name and then
renames, so concurrent processes never load a half-written file.  Any
failure raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

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


def _build(name: str, compiler: list, source: str) -> str:
    """Compile ``source`` (plus every header in csrc/) into
    ``_build/<name>-<key>.so`` unless it is there; returns the path."""
    deps = sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [source]
    out = os.path.join(BUILD_DIR, f"{name}-{build_key(compiler, deps)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = compiler + ["-I", CSRC, "-o", tmp, source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _declare(fn, nptr: int):
    fn.restype = ctypes.c_int
    fn.argtypes = [_PTR] * nptr
    return fn


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """The nvcc-built cellforce kernel: ``dsph_cellforce(params, pospress,
    velrho, kind, cell, begin, ace, ar, viscdt, stream)``."""
    path = _build("cellforce_sm90a", [_find_nvcc()] + NVCC_FLAGS,
                  os.path.join(CSRC, "cellforce.cu"))
    lib = ctypes.CDLL(path)
    _declare(lib.dsph_cellforce, 10)
    return lib


@functools.cache
def host_twin_library() -> ctypes.CDLL:
    """The g++-built CPU twin: ``dsph_cellforce_host(params, pospress,
    velrho, kind, cell, begin, ace, ar, viscdt)``."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the CPU twin cannot be built")
    path = _build("cellforce_host", [gxx] + GXX_FLAGS,
                  os.path.join(CSRC, "cellforce_host.cpp"))
    lib = ctypes.CDLL(path)
    _declare(lib.dsph_cellforce_host, 9)
    return lib
