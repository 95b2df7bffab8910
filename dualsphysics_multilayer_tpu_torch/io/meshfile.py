"""Triangle-mesh loaders for GenCase geometry import commands
(`<drawfilestl>`, `<drawfileply>`, `<drawfilevtk>` — CaseTemplate.xml; the
reference GenCase rasterizes imported surfaces onto the dp lattice the same
way, binary-only tool).  Returns (ntri, 3, 3) float64 triangle soups; the
Draw.tri_surface rasterizer turns them into boundary particles.

Counterpart of `dualsphysics_multilayer_tpu/io/meshfile.py`, copied: it is
numpy only, and the port keeps its own copy because importing the JAX
package's module loads JAX."""

from __future__ import annotations

import struct

import numpy as np


def load_stl(path):
    """Binary or ASCII STL -> (n,3,3) triangles."""
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    if head[:5].lower() == b"solid" and b"facet" in rest[:1000]:
        # ASCII
        tris, cur = [], []
        for line in (head + rest).decode("latin1").splitlines():
            p = line.split()
            if len(p) >= 4 and p[0] == "vertex":
                cur.append([float(p[1]), float(p[2]), float(p[3])])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
        return np.asarray(tris, np.float64).reshape(-1, 3, 3)
    (ntri,) = struct.unpack("<I", rest[:4])
    data = np.frombuffer(rest[4:4 + ntri * 50], dtype=np.uint8)
    data = data.reshape(ntri, 50)
    v = data[:, 12:48].copy().view("<f4").reshape(ntri, 3, 3)
    return v.astype(np.float64)


def load_ply(path):
    """ASCII PLY (vertex + face elements) -> (n,3,3) triangles; quads are
    split."""
    with open(path, "rb") as f:
        txt = f.read().decode("latin1")
    lines = txt.splitlines()
    nv = nf = 0
    i = 0
    props = 0
    in_vertex = False
    for i, ln in enumerate(lines):
        p = ln.split()
        if not p:
            continue
        if p[0] == "element" and p[1] == "vertex":
            nv = int(p[2])
            in_vertex = True
        elif p[0] == "element" and p[1] == "face":
            nf = int(p[2])
            in_vertex = False
        elif p[0] == "property" and in_vertex:
            props += 1
        elif p[0] == "format" and "ascii" not in ln:
            raise ValueError(f"{path}: only ascii PLY supported")
        elif p[0] == "end_header":
            break
    body = lines[i + 1:]
    verts = np.array([[float(x) for x in body[j].split()[:3]]
                      for j in range(nv)], np.float64)
    tris = []
    for j in range(nv, nv + nf):
        p = [int(x) for x in body[j].split()]
        cnt, idx = p[0], p[1:1 + p[0]]
        for k in range(1, cnt - 1):
            tris.append([verts[idx[0]], verts[idx[k]], verts[idx[k + 1]]])
    return np.asarray(tris, np.float64).reshape(-1, 3, 3)


def load_vtk(path):
    """Legacy ASCII VTK POLYDATA (POINTS + POLYGONS/TRIANGLE_STRIPS) ->
    (n,3,3) triangles."""
    with open(path, "rb") as f:
        txt = f.read().decode("latin1")
    toks = txt.split()
    tl = [t.lower() for t in toks]
    if "binary" in tl[:20]:
        raise ValueError(f"{path}: only ascii legacy VTK supported")

    def find(word):
        try:
            return tl.index(word)
        except ValueError:
            return -1

    ip = find("points")
    nv = int(toks[ip + 1])
    verts = np.array(toks[ip + 3:ip + 3 + nv * 3],
                     np.float64).reshape(nv, 3)
    tris = []
    ipo = find("polygons")
    if ipo >= 0:
        ncell = int(toks[ipo + 1])
        j = ipo + 3
        for _ in range(ncell):
            cnt = int(toks[j])
            idx = [int(x) for x in toks[j + 1:j + 1 + cnt]]
            j += cnt + 1
            for k in range(1, cnt - 1):
                tris.append([verts[idx[0]], verts[idx[k]], verts[idx[k + 1]]])
    ist = find("triangle_strips")
    if ist >= 0:
        ncell = int(toks[ist + 1])
        j = ist + 3
        for _ in range(ncell):
            cnt = int(toks[j])
            idx = [int(x) for x in toks[j + 1:j + 1 + cnt]]
            j += cnt + 1
            for k in range(cnt - 2):
                a, b, c = idx[k], idx[k + 1], idx[k + 2]
                tris.append([verts[a], verts[b], verts[c]] if k % 2 == 0
                            else [verts[b], verts[a], verts[c]])
    return np.asarray(tris, np.float64).reshape(-1, 3, 3)


def load_obj(path):
    """Wavefront OBJ (v + f, polygons fan-split) -> (n,3,3) triangles.
    The format Chrono collision bodies use (`modelfile="box.obj"`,
    `doc/xml_format/_FmtXML_Chrono.xml`)."""
    verts, tris = [], []
    with open(path, "rb") as f:
        for raw in f.read().decode("latin1").splitlines():
            p = raw.split()
            if not p:
                continue
            if p[0] == "v" and len(p) >= 4:
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif p[0] == "f" and len(p) >= 4:
                idx = []
                for tok in p[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, np.float64)
    return (v[np.asarray(tris, np.int64)] if tris
            else np.zeros((0, 3, 3), np.float64))


def load_mesh(path):
    low = path.lower()
    if low.endswith(".stl"):
        return load_stl(path)
    if low.endswith(".ply"):
        return load_ply(path)
    if low.endswith(".vtk"):
        return load_vtk(path)
    if low.endswith(".obj"):
        return load_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")
