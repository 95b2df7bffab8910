"""The native .bi4 writer and its ctypes binding.

Counterpart of `dualsphysics_multilayer_tpu/native/__init__.py` (the
reference's JBinaryData serializer, which is C++): ``jbinary_native.cpp``
streams an ``io.jbinary.JItem`` tree to a file, each array's bytes going
from its numpy buffer to the file without a copy, and writes the bytes of
``io.jbinary``'s pure writer.  g++ builds it at first use into the
package's ``_build/`` (``ops/cuda/build.host_library``, named by a hash of
the source and the compiler, so an edit rebuilds).  A failed build, an
unwritable file or a failed write raises: unlike the JAX package's binding
there is no fallback to the pure writer, which ``write_file(...,
native=False)`` runs.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "jbinary_native.cpp")

_S, _I, _U = ctypes.c_char_p, ctypes.c_int, ctypes.c_uint
_ARGS = {
    "jbn_open": ([_S, _S], ctypes.c_void_p),
    "jbn_item": ([ctypes.c_void_p, _S, _S, _S, _U, _U], _I),
    "jbn_text": ([ctypes.c_void_p, _S, _S], _I),
    "jbn_num": ([ctypes.c_void_p, _S, _I] + [ctypes.c_double] * 3, _I),
    "jbn_int": ([ctypes.c_void_p, _S, _I] + [ctypes.c_longlong] * 3, _I),
    "jbn_array": ([ctypes.c_void_p, _S, _I, _U, ctypes.c_void_p,
                   ctypes.c_ulonglong], _I),
    "jbn_close": ([ctypes.c_void_p], _I),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The g++-built writer (built at the first call of a process)."""
    from ..ops.cuda import build
    lib = ctypes.CDLL(build.host_library("jbinary_native", [SOURCE]))
    for name, (args, res) in _ARGS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def write_item(path, root, filecode=None) -> None:
    """Write the ``io.jbinary.JItem`` tree ``root`` to ``path`` as a .bi4
    file of ``filecode`` (the root's name by default), bytes equal to
    ``io.jbinary``'s pure writer's.  Raises OSError if the file cannot be
    made or written, ValueError on a value or array type the format does
    not have."""
    from ..io import jbinary as jb
    lib = library()
    h = lib.jbn_open(os.fsencode(path), (filecode or root.name).encode())
    if not h:
        raise OSError(f"cannot create {path}")
    failed = False
    try:
        stack = [root]
        while stack:
            item = stack.pop()
            failed |= bool(lib.jbn_item(
                h, item.name.encode(), item.fmtfloat.encode(),
                item.fmtdouble.encode(), len(item.arrays), len(item.items)))
            for name, (t, v) in item.values.items():
                failed |= bool(_value(lib, h, name.encode(), t, v, jb))
            for ar in item.arrays:
                if ar.type not in jb._NP_DTYPE:
                    raise ValueError(f"bad array type {ar.type}")
                data = np.ascontiguousarray(
                    ar.data.astype(jb._NP_DTYPE[ar.type], copy=False))
                failed |= bool(lib.jbn_array(
                    h, ar.name.encode(), ar.type, ar.count,
                    data.ctypes.data_as(ctypes.c_void_p), data.nbytes))
            # depth first, children in their order
            stack.extend(reversed(item.items))
    finally:
        failed |= bool(lib.jbn_close(h))
    if failed:
        raise OSError(f"the native .bi4 writer failed on {path}")


def _value(lib, h, name, t, v, jb):
    if t == jb.TEXT:
        return lib.jbn_text(h, name, str(v).encode())
    if t in (jb.FLOAT, jb.DOUBLE):
        return lib.jbn_num(h, name, t, float(v), 0.0, 0.0)
    if t in (jb.FLOAT3, jb.DOUBLE3):
        return lib.jbn_num(h, name, t, *(float(x) for x in v))
    if t in (jb.INT3, jb.UINT3):
        return lib.jbn_int(h, name, t, *(int(x) for x in v))
    if t == jb.BOOL:
        return lib.jbn_int(h, name, t, 1 if v else 0, 0, 0)
    if t in jb._SCALAR_FMT:
        return lib.jbn_int(h, name, t, int(v), 0, 0)
    raise ValueError(f"bad value type {t}")
