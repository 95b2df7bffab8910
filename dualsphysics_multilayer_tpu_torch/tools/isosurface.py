"""IsoSurface: free-surface triangulation from SPH-interpolated fields.

Rebuild of the closed `IsoSurface` binary (CLI:
the reference's `doc/help/IsoSurface_Help.out`): interpolate mass (or any
`-isovar` variable) onto a regular node grid (spacing `-distnode[_dp]`),
then extract the iso-level surface.  The reference uses marching cubes; this
implementation uses **marching tetrahedra** (each cell split into 6 tets) —
a table-free equivalent producing a watertight triangulation of the same
level set — and marching squares for 2D cases (`-saveslice`).

Default iso level: 0.5 * fluid particle mass (the help's threshold).

The node values go through ``measuretool.interpolate``, on the card unless
``-cpu`` is given; the marching stays host numpy.

Counterpart of `dualsphysics_multilayer_tpu/tools/isosurface.py`.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io import vtkout
from . import common as C
from .measuretool import interpolate

# cube corner offsets (i,j,k) indexed 0..7
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
# 6-tetrahedra decomposition of the cube (corner indices)
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])


def _tet_triangles(p, v, level):
    """Marching-tetrahedra core: p (nt,4,3) corner positions, v (nt,4)
    values.  Returns (m,3,3) triangle vertices of the level set."""
    inside = v > level
    ncase = inside.sum(1)
    tris = []

    def interp(pa, va, pb, vb):
        t = (level - va) / (vb - va)
        return pa + t[:, None] * (pb - pa)

    # one corner inside (or outside): a single triangle
    for flip in (False, True):
        want = 1 if not flip else 3
        sel = np.where(ncase == want)[0]
        if len(sel) == 0:
            continue
        ins = inside[sel] if not flip else ~inside[sel]
        ci = np.argmax(ins, axis=1)
        others = np.array([[j for j in range(4) if j != i] for i in ci])
        pa = p[sel, ci]
        va = v[sel, ci]
        tri = np.stack([
            interp(pa, va, p[sel, others[:, k]], v[sel, others[:, k]])
            for k in range(3)], axis=1)
        tris.append(tri)
    # two corners inside: a quad (two triangles)
    sel = np.where(ncase == 2)[0]
    if len(sel):
        ins = inside[sel]
        # indices of the two inside and two outside corners
        idx = np.argsort(~ins, axis=1, kind="stable")
        a, b = idx[:, 0], idx[:, 1]
        c, dgt = idx[:, 2], idx[:, 3]
        r = np.arange(len(sel))
        pac = interp(p[sel, a], v[sel, a], p[sel, c], v[sel, c])
        pad = interp(p[sel, a], v[sel, a], p[sel, dgt], v[sel, dgt])
        pbc = interp(p[sel, b], v[sel, b], p[sel, c], v[sel, c])
        pbd = interp(p[sel, b], v[sel, b], p[sel, dgt], v[sel, dgt])
        tris.append(np.stack([pac, pad, pbd], axis=1))
        tris.append(np.stack([pac, pbd, pbc], axis=1))
    if not tris:
        return np.zeros((0, 3, 3))
    return np.concatenate(tris, 0)


def marching_tetrahedra(grid_vals, origin, spacing):
    """Extract the `level=0` surface from grid_vals (nx,ny,nz) already
    shifted by the iso level.  Returns (points (m,3), triangles (t,3))."""
    nx, ny, nz = grid_vals.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    # active cells: sign change among corners
    v = grid_vals
    pos = v > 0
    csum = np.zeros((nx - 1, ny - 1, nz - 1), np.int8)
    for dx, dy, dz in _CORNERS:
        csum += pos[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
    act = np.argwhere((csum > 0) & (csum < 8))
    if len(act) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    corner_idx = act[:, None, :] + _CORNERS[None, :, :]     # (na,8,3)
    vals = v[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    ppos = origin + corner_idx * spacing
    tri_all = []
    for tet in _TETS:
        tri_all.append(_tet_triangles(ppos[:, tet], vals[:, tet], 0.0))
    tri = np.concatenate(tri_all, 0)
    if len(tri) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    # weld duplicate vertices
    flat = tri.reshape(-1, 3)
    key = np.round(flat / (spacing * 1e-5)).astype(np.int64)
    _, uniq, inv = np.unique(key, axis=0, return_index=True,
                             return_inverse=True)
    return flat[uniq], inv.reshape(-1, 3).astype(np.int32)


def marching_squares(grid_vals, origin, spacing):
    """2D level-set polylines (for -saveslice / 2D cases): returns list of
    segments as (m,2,2) xy endpoints (level=0)."""
    nx, nz = grid_vals.shape
    segs = []
    v = grid_vals

    def ip(p1, v1, p2, v2):
        t = -v1 / (v2 - v1)
        return p1 + t * (p2 - p1)

    for i in range(nx - 1):
        for k in range(nz - 1):
            c = [v[i, k], v[i + 1, k], v[i + 1, k + 1], v[i, k + 1]]
            p = [np.array([i, k]), np.array([i + 1, k]),
                 np.array([i + 1, k + 1]), np.array([i, k + 1])]
            idxs = [n for n in range(4)
                    if (c[n] > 0) != (c[(n + 1) % 4] > 0)]
            if len(idxs) >= 2:
                pts = [ip(p[n], c[n], p[(n + 1) % 4], c[(n + 1) % 4])
                       for n in idxs[:2]]
                segs.append(np.stack(pts))
    if not segs:
        return np.zeros((0, 2, 2))
    return origin + np.stack(segs) * spacing


def parse_args(argv):
    cfg = dict(dirin=".", filexml=None, first=None, last=None, files=None,
               filters=C.Filters(onlytype={3}), out=C.OutCfg(),
               distnode_dp=None, distnode=None, iso_limits=None,
               saveiso=None, saveslice=None, isovars=[], slices=[],
               kclimit=0.05, kcdummy=0.0, kcusedummy=True, move=None,
               cpu=False)
    from .. import typesdef as td
    cfg["filters"].onlytype = {td.TYPE_FLUID}
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(__doc__)
            sys.exit(0)
        elif a == "-dirin":
            i += 1
            cfg["dirin"] = argv[i]
        elif a == "-casein":
            i += 1
        elif a == "-filexml":
            i += 1
            cfg["filexml"] = argv[i]
        elif a.startswith("-first:"):
            cfg["first"] = int(a.split(":")[1])
        elif a.startswith("-last:"):
            cfg["last"] = int(a.split(":")[1])
        elif a.startswith("-files:"):
            cfg["files"] = a.split(":", 1)[1]
        elif a.startswith("-move:"):
            cfg["move"] = tuple(float(x) for x in a.split(":")[1:4])
        elif a.startswith(("-threads", "-viscoart", "-viscolam", "-viscoauto",
                           "-gravity", "-vars", "-distinter")):
            pass
        elif a.startswith("-onlypos:"):
            cfg["filters"].onlypos = tuple(float(x) for x in a.split(":")[1:7])
        elif a.startswith("-onlymk:"):
            cfg["filters"].onlymk = C.parse_range_filter(a.split(":", 1)[1])
        elif a.startswith("-onlytype:"):
            cfg["filters"].onlytype = C.parse_typesel(a.split(":", 1)[1],
                                                      ("fluid",))
        elif a.startswith("-kclimit:"):
            cfg["kclimit"] = float(a.split(":")[1])
        elif a.startswith("-kcdummy:"):
            cfg["kcdummy"] = float(a.split(":")[1])
        elif a.startswith("-kcusedummy:"):
            cfg["kcusedummy"] = a.endswith("1")
        elif a.startswith("-iso_limits:"):
            cfg["iso_limits"] = tuple(float(x) for x in a.split(":")[1:7])
        elif a.startswith("-distnode_dp:"):
            cfg["distnode_dp"] = float(a.split(":")[1])
        elif a.startswith("-distnode:"):
            cfg["distnode"] = float(a.split(":")[1])
        elif a == "-saveiso":
            i += 1
            cfg["saveiso"] = argv[i]
        elif a.startswith("-isovar:"):
            f = a.split(":")
            cfg["isovars"].append((f[1], [float(x) for x in f[2:]]))
        elif a == "-saveslice":
            i += 1
            cfg["saveslice"] = argv[i]
        elif a.startswith("-slicevec:"):
            f = [float(x) for x in a.split(":")[1:7]]
            cfg["slices"].append(("vec", f[:3], f[3:]))
        elif a.startswith("-slice3pt:"):
            f = [float(x) for x in a.split(":")[1:10]]
            cfg["slices"].append(("3pt", f[:3], f[3:6], f[6:9]))
        elif a.startswith("-createdirs:"):
            cfg["out"].createdirs = a.endswith("1")
        elif a.startswith("-csvsep:"):
            cfg["out"].csvsep = int(a.split(":")[1])
        elif a == "-cpu":
            cfg["cpu"] = True
        elif a == "-opt":
            i += 1
            with open(argv[i]) as f:
                argv[i + 1:i + 1] = f.read().split()
        else:
            raise SystemExit(f"isosurface: unknown option '{a}'")
        i += 1
    return cfg


def _node_grid(d, cfg):
    dp = d["ctes"]["Dp"]
    spacing = (cfg["distnode"] if cfg["distnode"]
               else dp * (cfg["distnode_dp"] or 2.0))
    if cfg["iso_limits"]:
        lo = np.asarray(cfg["iso_limits"][:3])
        hi = np.asarray(cfg["iso_limits"][3:])
    else:
        lo = d["pos"].min(0) - 2 * d["ctes"]["H"]
        hi = d["pos"].max(0) + 2 * d["ctes"]["H"]
    n = np.maximum(np.ceil((hi - lo) / spacing).astype(int) + 1, 2)
    return lo, spacing, n


def run(cfg):
    parts = C.find_parts(cfg["dirin"], cfg["first"], cfg["last"],
                         cfg["files"])
    dev = C.tool_device(cfg["cpu"])
    blocks = None
    fx = C.resolve_filexml(cfg["filexml"], cfg["dirin"])
    if fx and os.path.exists(fx):
        blocks = C.load_mkblocks_xml(fx)
    written = []
    for cpart, path in parts:
        d = C.load_part(path)
        if cfg["move"] is not None:
            d["pos"] = d["pos"] + np.asarray(cfg["move"])
        sel_idx = np.where(cfg["filters"].apply(d, blocks))[0]
        sim2d = d.get("data2d", False) or \
            (len(d["pos"]) and np.ptp(d["pos"][:, 1]) < d["ctes"]["Dp"] * 0.5)
        lo, spacing, n = _node_grid(d, cfg)
        level = 0.5 * d["ctes"]["MassFluid"]
        if cfg["saveiso"]:
            if sim2d:
                # 2D case: level-set polylines in the xz plane
                xs = lo[0] + spacing * np.arange(n[0])
                zs = lo[2] + spacing * np.arange(n[2])
                y0 = float(d["pos"][:, 1].mean()) if len(d["pos"]) else 0.0
                pts = np.array([[x, y0, z] for x in xs for z in zs])
                res = interpolate(d, pts, ["mass"], kclimit=2.0,
                                  kcusedummy=False, sel=sel_idx, device=dev)
                grid = res["mass"].reshape(n[0], n[2]) - level
                segs = marching_squares(grid, lo[[0, 2]], spacing)
                pts3 = np.zeros((len(segs) * 2, 3), np.float32)
                pts3[:, 0] = segs[:, :, 0].reshape(-1)
                pts3[:, 1] = y0
                pts3[:, 2] = segs[:, :, 1].reshape(-1)
                lines = [np.array([2 * i, 2 * i + 1])
                         for i in range(len(segs))]
                p = C.prepare_path(C.numbered(cfg["saveiso"], cpart),
                                   cfg["out"])
                vtkout.write_vtk_mesh(p, pts3, lines=lines)
            else:
                xs = [lo[k] + spacing * np.arange(n[k]) for k in range(3)]
                pts = np.stack(np.meshgrid(*xs, indexing="ij"),
                               -1).reshape(-1, 3)
                res = interpolate(d, pts, ["mass"], kclimit=2.0,
                                  kcusedummy=False, sel=sel_idx, device=dev)
                grid = res["mass"].reshape(*n) - level
                verts, tris = marching_tetrahedra(grid, lo, spacing)
                p = C.prepare_path(C.numbered(cfg["saveiso"], cpart),
                                   cfg["out"])
                vtkout.write_vtk_mesh(p, verts, polys=tris)
            written.append(p)
        for kind, *geom in cfg["slices"]:
            if cfg["saveslice"] is None:
                break
            if kind == "vec":
                p0, nv = np.asarray(geom[0]), np.asarray(geom[1])
            else:
                p0 = np.asarray(geom[0])
                nv = np.cross(np.asarray(geom[1]) - p0,
                              np.asarray(geom[2]) - p0)
            nv = nv / max(np.linalg.norm(nv), 1e-30)
            # in-plane basis
            ref = np.array([1.0, 0, 0]) if abs(nv[0]) < 0.9 else \
                np.array([0, 1.0, 0])
            u = np.cross(nv, ref)
            u /= np.linalg.norm(u)
            w = np.cross(nv, u)
            ext = np.linalg.norm(d["pos"].max(0) - d["pos"].min(0)) \
                if len(d["pos"]) else 1.0
            m = max(int(ext / spacing) + 1, 2)
            uu = spacing * (np.arange(m) - m // 2)
            pts = p0 + uu[:, None, None] * u + uu[None, :, None] * w
            res = interpolate(d, pts.reshape(-1, 3), ["mass"], kclimit=2.0,
                              kcusedummy=False, sel=sel_idx, device=dev)
            grid = res["mass"].reshape(m, m) - level
            segs = marching_squares(grid, np.zeros(2), 1.0)
            pts3 = (p0 + (segs[:, :, 0].reshape(-1, 1) - m // 2)
                    * spacing * u
                    + (segs[:, :, 1].reshape(-1, 1) - m // 2) * spacing * w)
            lines = [np.array([2 * i, 2 * i + 1]) for i in range(len(segs))]
            p = C.prepare_path(C.numbered(cfg["saveslice"], cpart),
                               cfg["out"])
            vtkout.write_vtk_mesh(p, pts3.astype(np.float32), lines=lines)
            written.append(p)
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"IsoSurface: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
