"""VTK particle output (legacy binary .vtk polydata).

Counterpart of `dualsphysics_multilayer_tpu/io/vtkout.py`: a small
legacy-format writer produces ParaView-loadable particle files with the
standard field names (Idp/Vel/Rhop/Type/Mk) of PartVTK output (the
reference routes VTK through the closed-source libjvtklib, `JVtkLib.h`).
Equal arrays give files byte-equal to the JAX package's; the port's state
is in cell-sorted slot order, so its particle files list particles in that
order.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import typesdef as td
from .partdata import host


def _be(arr):
    return np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder(">"))


def write_vtk_particles(path, pos, fields=None, binary=True):
    """Write particle positions (+ named point-data fields) as VTK polydata.
    ``fields``: dict name -> (n,) or (n,3) array."""
    pos = np.asarray(pos, np.float32)
    n = len(pos)
    fields = fields or {}
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"dualsphysics_multilayer_tpu particles\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET POLYDATA\n")
        f.write(f"POINTS {n} float\n".encode())
        if binary:
            f.write(_be(pos.reshape(-1, 3)).tobytes())
        else:
            np.savetxt(f, pos, fmt="%g")
        f.write(f"\nVERTICES {n} {2 * n}\n".encode())
        verts = np.column_stack([np.ones(n, np.int32),
                                 np.arange(n, dtype=np.int32)])
        if binary:
            f.write(_be(verts).tobytes())
        else:
            np.savetxt(f, verts, fmt="%d")
        f.write(f"\nPOINT_DATA {n}\n".encode())
        for name, arr in fields.items():
            arr = np.asarray(arr)
            if arr.ndim == 2 and arr.shape[1] == 3:
                a = arr.astype(np.float32)
                f.write(f"VECTORS {name} float\n".encode())
                f.write(_be(a).tobytes() if binary else
                        ("\n".join(" ".join(map(str, r)) for r in a) + "\n").encode())
            else:
                if arr.dtype.kind in "ui":
                    a = arr.astype(np.int32)
                    tname = "int"
                else:
                    a = arr.astype(np.float32)
                    tname = "float"
                f.write(f"SCALARS {name} {tname} 1\nLOOKUP_TABLE default\n"
                        .encode())
                f.write(_be(a).tobytes() if binary else
                        ("\n".join(map(str, a)) + "\n").encode())
            f.write(b"\n")
    return path


def write_vtk_mesh(path, points, *, polys=None, lines=None, fields=None,
                   binary=True):
    """Write a VTK polydata mesh: triangles/polygons (`polys`, (m,k) int) or
    polylines (`lines`, list of index arrays) with optional point fields.
    Used by the IsoSurface/TracerParts/BoundaryVTK tool rebuilds (the closed
    libjvtklib surface writers, `JVtkLib.h`)."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    fields = fields or {}
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"dualsphysics_multilayer_tpu mesh\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET POLYDATA\n")
        f.write(f"POINTS {n} float\n".encode())
        f.write(_be(pts).tobytes() if binary else
                ("\n".join(" ".join(map(str, r)) for r in pts) + "\n").encode())
        if polys is not None and len(polys):
            polys = np.asarray(polys, np.int32)
            m, k = polys.shape
            cells = np.column_stack([np.full(m, k, np.int32), polys])
            f.write(f"\nPOLYGONS {m} {m * (k + 1)}\n".encode())
            f.write(_be(cells).tobytes() if binary else
                    ("\n".join(" ".join(map(str, r)) for r in cells)
                     + "\n").encode())
        if lines is not None and len(lines):
            tot = sum(len(l) + 1 for l in lines)
            f.write(f"\nLINES {len(lines)} {tot}\n".encode())
            for l in lines:
                cell = np.concatenate([[len(l)], l]).astype(np.int32)
                f.write(_be(cell).tobytes() if binary else
                        (" ".join(map(str, cell)) + "\n").encode())
        if fields:
            f.write(f"\nPOINT_DATA {n}\n".encode())
            for name, arr in fields.items():
                arr = np.asarray(arr)
                if arr.ndim == 2 and arr.shape[1] == 3:
                    f.write(f"VECTORS {name} float\n".encode())
                    f.write(_be(arr.astype(np.float32)).tobytes())
                else:
                    f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n"
                            .encode())
                    f.write(_be(arr.astype(np.float32)).tobytes())
                f.write(b"\n")
    return path


def write_state_vtk(path, state, live_only=True):
    """Dump a SimState as VTK (the `-sv:vtk` / DgSaveVtkParticles path,
    JSph.cpp:3127)."""
    pos = host(state.pos)
    code = host(state.code)
    live = ((code >> td.CODE_SPECIAL_SHIFT) & td.CODE_SPECIAL_MASK) \
        < td.SPECIAL_OUT_POS
    sel = np.where(live)[0] if live_only else np.arange(len(pos))
    fields = dict(
        Idp=host(state.idp)[sel],
        Vel=host(state.vel)[sel],
        Rhop=host(state.rho)[sel],
        Type=((code[sel] >> td.CODE_TYPE_SHIFT) & td.CODE_TYPE_MASK),
        Mk=(code[sel] & td.CODE_VALUE_MASK),
    )
    return write_vtk_particles(path, pos[sel], fields)
