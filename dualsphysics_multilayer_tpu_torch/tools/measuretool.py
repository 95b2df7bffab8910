"""MeasureTool: SPH interpolation of magnitudes at fixed points + wave
elevation from PART series.

Rebuild of the closed `MeasureTool` binary (CLI surface:
the reference's `doc/help/MeasureTool_Help.out`).  Interpolation follows the
solver's gauge formulation (`JDsGaugeItem.cpp` GaugeVel::CalculeCpu): for a
point p, var(p) = sum_j var_j (m_j/rho_j) W(p-x_j) with optional Shepard
kernel correction by kcorr = sum_j (m_j/rho_j) W — applied when
kcorr > kclimit (`-kclimit/-kcdummy/-kcusedummy`).

Elevation (`-elevation`, GaugeSwl analog): for each (x,y) column the fluid
surface is the highest z sample where the interpolated mass exceeds
masslimit*massfluid.

The sums run in float64 on the card unless ``-cpu`` is given
(``common.tool_device``): the pairs of ``common.device_pairs`` and
``index_add_``; the elevation's column scan runs vectorised on the same
device.  File reading, filtering and writing stay on the host.

Counterpart of `dualsphysics_multilayer_tpu/tools/measuretool.py`.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..io import vtkout
from . import common as C


def parse_points_def(txt):
    """-pointsdef grammar: pt=x:y:z,ptls[x=x0:dx:nx,...],ptels[x=x0:dx:xf...]"""
    pts = []
    for item in _split_top(txt):
        if item.startswith("pt="):
            pts.append([float(v) for v in item[3:].split(":")])
        elif item.startswith("ptls[") and item.endswith("]"):
            pts.extend(_grid_points(item[5:-1], endmode=False))
        elif item.startswith("ptels[") and item.endswith("]"):
            pts.extend(_grid_points(item[6:-1], endmode=True))
        else:
            raise SystemExit(f"measuretool: bad -pointsdef item '{item}'")
    return np.asarray(pts, np.float64)


def _split_top(txt):
    out, depth, cur = [], 0, ""
    for ch in txt:
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            depth += ch == "["
            depth -= ch == "]"
            cur += ch
    if cur:
        out.append(cur)
    return out


def _grid_points(body, endmode):
    axes = {"x": [0.0], "y": [0.0], "z": [0.0]}
    for part in body.split(","):
        k, v = part.split("=")
        f = [float(x) for x in v.split(":")]
        if endmode:
            v0, dv, vf = f
            n = max(int(np.floor((vf - v0) / dv + 1e-9)) + 1, 1) if dv else 1
            axes[k] = [v0 + dv * i for i in range(n)]
        else:
            v0, dv, n = f
            axes[k] = [v0 + dv * i for i in range(int(n))]
    return [[x, y, z] for x in axes["x"] for y in axes["y"]
            for z in axes["z"]]


def read_points_file(path):
    """POINTS / POINTSLIST / POINTSENDLIST file format
    (doc/help/FilePointsTemplate.txt)."""
    pts = []
    mode = "points"
    with open(path) as f:
        lines = [ln.split("#")[0].strip() for ln in f]
    i = 0
    while i < len(lines):
        ln = lines[i]
        if not ln:
            i += 1
            continue
        up = ln.upper()
        if up.startswith("POINTSENDLIST"):
            mode = "ptels"
        elif up.startswith("POINTSLIST"):
            mode = "ptls"
        elif up.startswith("POINTS"):
            mode = "points"
        elif mode == "points":
            vals = [float(x) for x in ln.replace(",", " ").split()]
            for k in range(0, len(vals), 3):
                pts.append(vals[k:k + 3])
        else:
            # three lines: x0:dx:nx(or xf) style per axis in free format
            vals = [float(x) for x in ln.replace(",", " ").split()]
            rows = [vals]
            for _ in range(2):
                i += 1
                rows.append([float(x)
                             for x in lines[i].replace(",", " ").split()])
            body = ",".join(f"{ax}={r[0]}:{r[1]}:{r[2]}"
                            for ax, r in zip("xyz", rows))
            pts.extend(_grid_points(body, endmode=(mode == "ptels")))
        i += 1
    return np.asarray(pts, np.float64)


def _source(dd, nm):
    """The per-particle values of variable ``nm`` (host numpy)."""
    if nm == "vel":
        return dd["vel"]
    if nm == "rhop":
        return dd["rhop"]
    if nm == "press":
        return C.press_of(dd)
    if nm == "mass":
        return C.mass_of(dd)
    if nm == "vol":
        return C.mass_of(dd) / dd["rhop"]
    if nm == "idp":
        return dd["idp"].astype(np.float64)
    raise SystemExit(f"measuretool: unsupported var '{nm}'")


def interpolate(d, points, varnames, *, kclimit=0.5, kcdummy=0.0,
                kcusedummy=True, sel=None, distinter=None, device=None):
    """SPH-interpolate the named variables at the points: the sums in
    float64 on ``device`` (default: the card, ``common.tool_device``),
    the Shepard correction on the host."""
    dev = device if device is not None else C.tool_device(False)
    pos = d["pos"] if sel is None else d["pos"][sel]
    h = d["ctes"]["H"]
    radius = distinter or 2.0 * h
    sim2d = d.get("data2d", False)
    dd = {k: (v[sel] if sel is not None and isinstance(v, np.ndarray)
              and v.ndim and len(v) == len(d["pos"]) else v)
          for k, v in d.items()}
    names = [nm for nm in varnames if nm != "kcorr"]
    cols = [np.asarray(_source(dd, nm), np.float64).reshape(len(pos), -1)
            for nm in names]
    widths = [c.shape[1] for c in cols]

    def t64(a):
        return torch.as_tensor(np.array(a, np.float64), device=dev)

    src, tgt = t64(pos), t64(points)
    # m/rho per particle in float32, as the host sums form it
    vol = t64(C.mass_of(dd) / dd["rhop"])
    vals = t64(np.concatenate(cols, axis=1) if cols
               else np.zeros((len(pos), 0)))
    npts = len(points)
    kc = torch.zeros(npts, dtype=torch.float64, device=dev)
    raw = torch.zeros((npts, vals.shape[1]), dtype=torch.float64, device=dev)
    for ti, sj in C.device_pairs(src, tgt, radius):
        dr = tgt[ti] - src[sj]
        rr2 = dr[:, 0] * dr[:, 0] + dr[:, 1] * dr[:, 1] + dr[:, 2] * dr[:, 2]
        vw = vol[sj] * C.wendland_wab_t(sim2d, h, rr2)
        kc.index_add_(0, ti, vw)
        raw.index_add_(0, ti, vw[:, None] * vals[sj])
    kcorr = kc.cpu().numpy()
    raw = raw.cpu().numpy()
    out = {"kcorr": kcorr.astype(np.float32)}
    ok = kcorr > kclimit
    denom = np.where(ok, kcorr, 1.0)

    def shepard(raw):
        v = raw / denom.reshape((-1,) + (1,) * (raw.ndim - 1))
        if kcusedummy:
            v = np.where(ok.reshape((-1,) + (1,) * (raw.ndim - 1)),
                         v, kcdummy)
        return v

    k0 = 0
    for nm, w in zip(names, widths):
        r = raw[:, k0:k0 + w]
        k0 += w
        # mass interpolation is kernel-corrected only when -kcmass:1
        out[nm] = shepard(r if w > 1 else r[:, 0]).astype(np.float32)
    return out


def elevation(d, xy_points, *, masslimit=None, masslimit_abs=None, sel=None,
              zrange=None, dz=None, device=None):
    """Free-surface elevation per (x,y) column: scan z, find the highest
    sample whose interpolated mass crosses the threshold (GaugeSwl logic,
    JDsGaugeItem.cpp:320-393), linearly interpolated to the crossing.  The
    JAX package scans the columns one by one on the host; here the same
    rule runs on every column at once on ``device``."""
    dev = device if device is not None else C.tool_device(False)
    h = d["ctes"]["H"]
    massf = d["ctes"]["MassFluid"]
    sim2d = d.get("data2d", False)
    limit = (masslimit_abs if masslimit_abs is not None
             else (masslimit if masslimit is not None
                   else (0.4 if sim2d else 0.5)) * massf)
    pos = d["pos"] if sel is None else d["pos"][sel]
    if zrange is None:
        zmin, zmax = (float(pos[:, 2].min()), float(pos[:, 2].max())) \
            if len(pos) else (0.0, 0.0)
    else:
        zmin, zmax = zrange
    dz = dz or h * 0.5
    nz = max(int(np.ceil((zmax - zmin) / dz)) + 1, 2)
    ncol = len(xy_points)
    zs = zmin + dz * np.arange(nz)
    pts = np.column_stack([np.repeat(xy_points[:, 0], nz),
                           np.repeat(xy_points[:, 1], nz),
                           np.tile(zs, ncol)])
    res = interpolate(d, pts, ["mass"], kclimit=2.0, kcusedummy=False,
                      device=dev)
    m = torch.as_tensor(res["mass"].reshape(ncol, nz), device=dev)
    above = m >= limit
    # the highest z where mass >= limit, linearly interpolated to the
    # crossing when the sample above differs
    k = (nz - 1) - torch.argmax(above.flip(1).to(torch.int8), dim=1)
    k1 = torch.clamp(k + 1, max=nz - 1)
    mk = m.gather(1, k[:, None])[:, 0]
    mk1 = m.gather(1, k1[:, None])[:, 0]
    zk = torch.as_tensor(zs, device=dev)[k]
    f = torch.clamp((limit - mk.double()) / (mk1 - mk).double(), 0.0, 1.0)
    eta = torch.where((k + 1 < nz) & (mk != mk1), zk + f * dz, zk)
    eta = torch.where(above.any(dim=1), eta, zmin)
    return eta.cpu().numpy()


def parse_args(argv):
    cfg = dict(dirin=".", filexml=None, first=None, last=None, files=None,
               points=None, vars=["vel", "rhop"], out=C.OutCfg(),
               filters=C.Filters(), kclimit=0.5, kcdummy=0.0, kcusedummy=True,
               distinter=None, elevation=None, elevationoutput="time",
               masslimit=None, masslimitvalue=None, tke=False,
               savevtk=None, savecsv=None, saveascii=None, csvpart=False,
               height_vars=["eta"], cpu=False)
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
        elif a.startswith("-threads") or a.startswith(("-viscoart",
                                                       "-viscolam",
                                                       "-viscoauto",
                                                       "-gravity")):
            pass
        elif a == "-points":
            i += 1
            cfg["points"] = read_points_file(argv[i])
        elif a.startswith("-pointsdef:"):
            cfg["points"] = parse_points_def(a.split(":", 1)[1])
        elif a == "-pointstemplate":
            print("POINTS\n0.5 0.0 0.25\nPOINTSLIST\n0.1:0.05:10\n0:0:1\n"
                  "0.2:0:1")
            sys.exit(0)
        elif a.startswith("-onlypos:"):
            cfg["filters"].onlypos = tuple(float(x) for x in a.split(":")[1:7])
        elif a.startswith("-onlymk:"):
            cfg["filters"].onlymk = C.parse_range_filter(a.split(":", 1)[1])
        elif a.startswith("-onlyid:"):
            cfg["filters"].onlyid = C.parse_range_filter(a.split(":", 1)[1])
        elif a.startswith("-onlytype:"):
            cfg["filters"].onlytype = C.parse_typesel(a.split(":", 1)[1])
        elif a.startswith("-kclimit:"):
            cfg["kclimit"] = float(a.split(":")[1])
        elif a.startswith("-kcdummy:"):
            cfg["kcdummy"] = float(a.split(":")[1])
        elif a.startswith("-kcusedummy:"):
            cfg["kcusedummy"] = a.endswith("1")
        elif a.startswith("-kcmass:"):
            pass
        elif a.startswith("-distinter_2h:"):
            cfg["distinter_2h"] = float(a.split(":")[1])
        elif a.startswith("-distinter:"):
            cfg["distinter"] = float(a.split(":")[1])
        elif a.startswith("-vars"):
            body = a.split(":", 1)[1] if ":" in a else ""
            cfg["vars"] = C.parse_vars(body, cfg["vars"]) if body else \
                cfg["vars"]
        elif a.startswith("-hvars"):
            body = a.split(":", 1)[1] if ":" in a else ""
            if body:
                cfg["height_vars"] = [v.lstrip("+-") for v in body.split(",")
                                      if not v.startswith("-")]
        elif a.startswith("-elevation:"):
            cfg["elevation"] = float(a.split(":")[1])
        elif a == "-elevation":
            cfg["elevation"] = True
        elif a.startswith("-elevationlimit:"):
            cfg["elevation"] = True
            cfg["masslimitvalue"] = float(a.split(":")[1])
        elif a.startswith("-elevationoutput:"):
            cfg["elevationoutput"] = a.split(":")[1]
        elif a.startswith("-masslimit:"):
            cfg["masslimit"] = float(a.split(":")[1])
        elif a.startswith("-masslimitvalue:"):
            cfg["masslimitvalue"] = float(a.split(":")[1])
        elif a.startswith("-hsort:"):
            pass
        elif a == "-tke":
            cfg["tke"] = True
        elif a == "-cpu":
            cfg["cpu"] = True
        elif a == "-savevtk":
            i += 1
            cfg["savevtk"] = argv[i]
        elif a == "-savecsv":
            i += 1
            cfg["savecsv"] = argv[i]
        elif a == "-saveascii":
            i += 1
            cfg["saveascii"] = argv[i]
        elif a.startswith("-savecsvpart:"):
            cfg["csvpart"] = a.endswith("1")
        elif a.startswith("-savecsvnopos:"):
            pass
        elif a.startswith("-createdirs:"):
            cfg["out"].createdirs = a.endswith("1")
        elif a.startswith("-csvsep:"):
            cfg["out"].csvsep = int(a.split(":")[1])
        elif a == "-opt":
            i += 1
            with open(argv[i]) as f:
                argv[i + 1:i + 1] = f.read().split()
        else:
            raise SystemExit(f"measuretool: unknown option '{a}'")
        i += 1
    if cfg["points"] is None:
        raise SystemExit("measuretool: no points given (-points/-pointsdef)")
    return cfg


def run(cfg):
    parts = C.find_parts(cfg["dirin"], cfg["first"], cfg["last"],
                         cfg["files"])
    blocks = None
    fx = C.resolve_filexml(cfg["filexml"], cfg["dirin"])
    if fx and os.path.exists(fx):
        blocks = C.load_mkblocks_xml(fx)
    points = cfg["points"]
    dev = C.tool_device(cfg["cpu"])
    rows = []
    eta_rows = []
    written = []
    for cpart, path in parts:
        d = C.load_part(path)
        sel = cfg["filters"].apply(d, blocks)
        sel_idx = np.where(sel)[0]
        if cfg["elevation"] is not None:
            xy = np.unique(points[:, :2], axis=0)
            eta = elevation(d, xy, masslimit=cfg["masslimit"],
                            masslimit_abs=cfg["masslimitvalue"], sel=sel_idx,
                            device=dev)
            eta_rows.append([cpart, d["timestep"]] + list(eta))
            continue
        res = interpolate(d, points, cfg["vars"], kclimit=cfg["kclimit"],
                          kcdummy=cfg["kcdummy"],
                          kcusedummy=cfg["kcusedummy"], sel=sel_idx,
                          distinter=cfg["distinter"], device=dev)
        if cfg["tke"]:
            # TKE = 0.5*mean((u - U)^2) per point over the PART series needs
            # the velocity history; record vel and post-process at the end
            pass
        row = [cpart, d["timestep"]]
        for nm in cfg["vars"]:
            v = res[nm]
            row.extend(v.reshape(-1).tolist())
        rows.append(row)
        if cfg["savevtk"]:
            fields = {nm: res[nm] for nm in cfg["vars"]}
            p = C.prepare_path(C.numbered(cfg["savevtk"], cpart), cfg["out"])
            vtkout.write_vtk_particles(p, points.astype(np.float32), fields)
            written.append(p)
    if cfg["elevation"] is not None and eta_rows:
        xy = np.unique(points[:, :2], axis=0)
        hdr = ["Part", "Time"] + [f"Eta_p{i}" for i in range(len(xy))]
        base = cfg["savecsv"] or "Elevation.csv"
        if not base.endswith(".csv"):
            base += "_Elevation.csv"
        written.append(C.write_csv(base, hdr, eta_rows, cfg["out"]))
        return written
    if rows:
        hdr = ["Part", "Time"]
        npts = len(points)
        for nm in cfg["vars"]:
            dimn = 3 if nm == "vel" else 1
            for p in range(npts):
                if dimn == 3:
                    hdr += [f"{nm}.x_p{p}", f"{nm}.y_p{p}", f"{nm}.z_p{p}"]
                else:
                    hdr.append(f"{nm}_p{p}")
        if cfg["savecsv"]:
            base = cfg["savecsv"]
            if not base.endswith(".csv"):
                base += ".csv"
            written.append(C.write_csv(base, hdr, rows, cfg["out"]))
        if cfg["saveascii"]:
            written.append(C.write_ascii(cfg["saveascii"], rows, cfg["out"]))
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"MeasureTool: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
