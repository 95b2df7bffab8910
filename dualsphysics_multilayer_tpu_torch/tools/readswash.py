"""ReadSwash: SWASH wave-model output -> solver velocity inputs.

Rebuild of the closed `ReadSwash` binary
(the reference's `doc/help/ReadSwash_Help.out`): converts SWASH table
output into the velocity CSV time series the multilayer-piston
(`features/mlpiston.py`), inlet grid-velocity (`features/inout.py`
``gridveldata``) and relaxation-zone features consume, applies the drift
correction, and exports check VTKs.

Flags (help dump grammar):
  -savecsv <file.sws> <out.csv>      SWASH table -> per-layer velocity CSVs
                                     (out_velx.csv / out_vely.csv / out_velz.csv)
  -correctcsv:tmax[:steps] <in.csv> <out.csv>
                                     drift-correct velocities so the net
                                     displacement over [0,tmax] is zero on
                                     each of ``steps`` segments (0 = copy)
  -tclip:min[:max]                   clip the exported time interval
  -setposx:<v> / -setposy:<v>        overwrite position columns
  -savevtkveldp:<dp> <out.vtk>       point-cloud VTK of the velocity field
    -file_velx/-file_vely/-file_velz <csv>   component series to combine
    -dt:<v> -tmin:<v> -tmax:<v>      sample times of the VTK series

The SWASH `.sws` reader accepts the whitespace table layout SWASH writes
for layered velocity output: comment/header lines, then blocks per output
time of ``x [y] vel_layer1..vel_layerN`` rows led by a ``time`` marker row
(no .sws sample ships with the reference, so the reader is intentionally
lenient: any line whose tokens all parse as floats is data; a line with
fewer numeric tokens starts a new time block).

CSV format written/read: the solver's time-series table — header
``time;v1;v2;...`` then one row per sample (see
`features/mlpiston.load_mlpiston_csv` and the gridveldata reader).

Counterpart of `dualsphysics_multilayer_tpu/tools/readswash.py`.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C


def _tokens(line):
    return [t for t in line.replace(";", " ").replace(",", " ").split() if t]


def _floats(toks):
    out = []
    for t in toks:
        try:
            out.append(float(t))
        except ValueError:
            return None
    return out


def read_sws(path):
    """Lenient SWASH table reader -> (times (nt,), data (nt, npt, ncomp))."""
    blocks = []
    cur = []
    times = []
    with open(path) as f:
        for line in f:
            vals = _floats(_tokens(line.split("#", 1)[0]))
            if not vals:
                continue
            if len(vals) == 1:           # a lone number = time marker row
                if cur:
                    blocks.append(cur)
                cur = []
                times.append(vals[0])
                continue
            cur.append(vals)
    if cur:
        blocks.append(cur)
    if not blocks:
        raise ValueError(f"{path}: no data rows found")
    if not times:
        times = list(range(len(blocks)))
    n = min(len(b) for b in blocks)
    w = min(len(r) for b in blocks for r in b)
    data = np.asarray([[r[:w] for r in b[:n]] for b in blocks], np.float64)
    return np.asarray(times[:len(blocks)], np.float64), data


def read_series_csv(path):
    """time;v... CSV -> (times (nt,), vals (nt, m), header list)."""
    times, rows, hdr = [], [], None
    with open(path) as f:
        for line in f:
            toks = _tokens(line.split("#", 1)[0])
            if not toks:
                continue
            vals = _floats(toks)
            if vals is None:
                if hdr is None:
                    hdr = toks
                continue
            times.append(vals[0])
            rows.append(vals[1:])
    m = min(len(r) for r in rows)
    return (np.asarray(times, np.float64),
            np.asarray([r[:m] for r in rows], np.float64), hdr)


def write_series_csv(path, times, vals, hdr=None, out="."):
    import os
    hdr = hdr or (["time"] + [f"v{i}" for i in range(vals.shape[1])])
    rows = [[t] + list(v) for t, v in zip(times, vals)]
    if not os.path.isabs(path):
        path = os.path.join(out, path)
    return C.write_csv(path, hdr, rows, C.OutCfg())


def correct_velocity(times, vals, tmax, steps=1):
    """Drift correction (`-correctcsv`): on each of ``steps`` segments of
    [0, tmax], subtract the constant velocity that zeroes the segment's net
    displacement (trapezoidal integral), so a piston driven by the series
    returns to its start — the reference's correction for SWASH series
    whose integrated drift walks the paddle away."""
    if steps <= 0:
        return vals
    vals = vals.copy()
    sel_all = times <= tmax + 1e-12
    edges = np.linspace(times[sel_all].min() if sel_all.any() else 0.0,
                        tmax, steps + 1)
    for s in range(steps):
        m = (times >= edges[s] - 1e-12) & (times <= edges[s + 1] + 1e-12)
        if m.sum() < 2:
            continue
        tseg = times[m]
        span = tseg[-1] - tseg[0]
        if span <= 0:
            continue
        for c in range(vals.shape[1]):
            disp = np.trapezoid(vals[m, c], tseg)
            vals[m, c] -= disp / span
    return vals


def parse_args(argv):
    cfg = dict(mode=None, args=[], tclip=None, setposx=None, setposy=None,
               dt=0.1, tmin=0.0, tmax=None, dp=0.0,
               velx=None, vely=None, velz=None, out=".", smooth=0)
    i = 0
    while i < len(argv):
        a = argv[i]
        base, _, val = a.partition(":")
        if base == "-savecsv":
            cfg["mode"] = "savecsv"
            cfg["args"] = argv[i + 1:i + 3]
            i += 2
        elif base == "-correctcsv":
            cfg["mode"] = "correctcsv"
            p = val.split(":") if val else ["1e30"]
            cfg["ctmax"] = float(p[0])
            cfg["csteps"] = int(p[1]) if len(p) > 1 else 1
            cfg["args"] = argv[i + 1:i + 3]
            i += 2
        elif base == "-savevtkveldp":
            cfg["mode"] = "savevtk"
            cfg["dp"] = float(val or 0.1)
            cfg["args"] = argv[i + 1:i + 2]
            i += 1
        elif base == "-tclip":
            p = val.split(":")
            cfg["tclip"] = (float(p[0]), float(p[1]) if len(p) > 1 else 1e30)
        elif base == "-setposx":
            cfg["setposx"] = float(val)
        elif base == "-setposy":
            cfg["setposy"] = float(val)
        elif base in ("-file_velx", "-file_vely", "-file_velz"):
            cfg[base[6:]] = argv[i + 1]
            i += 1
        elif base in ("-dt", "-tmin", "-tmax"):
            cfg[base[1:]] = float(val or argv[i + 1])
            if not val:
                i += 1
        elif base == "-smooth":
            cfg["smooth"] = int(val or 0)
        elif base == "-dirout":
            cfg["out"] = argv[i + 1]
            i += 1
        elif base in ("-h", "--help"):
            cfg["mode"] = "help"
        i += 1
    return cfg


def run(cfg):
    written = []
    if cfg["mode"] == "savecsv":
        src, dst = cfg["args"]
        times, data = read_sws(src)
        if cfg["tclip"]:
            m = (times >= cfg["tclip"][0]) & (times <= cfg["tclip"][1])
            times, data = times[m], data[m]
        # data: (nt, npt, w); col 0 = x [col 1 = y]; remaining = layers
        haspos = data.shape[2] > 1
        ncol = data.shape[2]
        stem = dst[:-4] if dst.endswith(".csv") else dst
        for name, c0 in (("velx", 1 if haspos else 0),):
            vals = data[:, :, c0:].reshape(len(times), -1)
            if cfg["setposx"] is not None and haspos:
                data[:, :, 0] = cfg["setposx"]
            written.append(write_series_csv(f"{stem}_{name}.csv", times,
                                            vals, out=cfg["out"]))
    elif cfg["mode"] == "correctcsv":
        src, dst = cfg["args"]
        times, vals, hdr = read_series_csv(src)
        vals = correct_velocity(times, vals, cfg["ctmax"], cfg["csteps"])
        if cfg["tclip"]:
            m = (times >= cfg["tclip"][0]) & (times <= cfg["tclip"][1])
            times, vals = times[m], vals[m]
        written.append(write_series_csv(dst, times, vals, hdr,
                                        out=cfg["out"]))
    elif cfg["mode"] == "savevtk":
        from ..io import vtkout
        (dst,) = cfg["args"]
        comps = []
        times = None
        for key in ("velx", "vely", "velz"):
            if cfg[key]:
                t, v, _ = read_series_csv(cfg[key])
                comps.append(v)
                times = t
            else:
                comps.append(None)
        if times is None:
            raise SystemExit("readswash: -savevtkveldp needs -file_vel*")
        npt = max(v.shape[1] for v in comps if v is not None)
        vel = np.zeros((len(times), npt, 3))
        for k, v in enumerate(comps):
            if v is not None:
                vel[:, :v.shape[1], k] = v
        tmax = cfg["tmax"] if cfg["tmax"] is not None else times[-1]
        tq = np.arange(cfg["tmin"], tmax + 1e-9, cfg["dt"])
        dp = cfg["dp"] or 0.1
        pos = np.zeros((npt, 3))
        pos[:, 2] = np.arange(npt) * dp
        if cfg["setposx"] is not None:
            pos[:, 0] = cfg["setposx"]
        base = dst[:-4] if dst.endswith(".vtk") else dst
        for n, t in enumerate(tq):
            it = int(np.clip(np.searchsorted(times, t) - 1, 0,
                             len(times) - 2))
            ft = (t - times[it]) / max(times[it + 1] - times[it], 1e-12)
            v = vel[it] * (1 - ft) + vel[it + 1] * np.clip(ft, 0, 1)
            import os
            p = f"{base}_{n:04d}.vtk"
            if not os.path.isabs(p):
                p = os.path.join(cfg["out"], p)
            C.prepare_path(p, C.OutCfg())
            vtkout.write_vtk_particles(p, pos, {"Vel": v})
            written.append(p)
    else:
        print(__doc__)
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"ReadSwash: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
