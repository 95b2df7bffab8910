"""PartVTK: convert PART .bi4 snapshots to VTK/CSV/ASCII with filters.

Rebuild of the reference's closed `bin/windows/PartVTK_win64.exe`
(CLI surface: the reference's `doc/help/PartVTK_Help.out`): each
`-savevtk/-savecsv/-saveascii/-savestatscsv/-saveenergy` opens an output
spec; the filter/var flags that follow configure that spec (matching the
reference semantics shown in the help's examples).

    python -m dualsphysics_multilayer_tpu_torch.tools.partvtk \
        -dirin out -savevtk fluid.vtk -onlytype:-all,+fluid -vars:+press

Counterpart of `dualsphysics_multilayer_tpu/tools/partvtk.py`.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io import vtkout
from . import common as C


class OutSpec:
    def __init__(self, kind, path, filters, varnames):
        self.kind = kind
        self.path = path
        self.filters = filters
        self.varnames = varnames
        self.rows = []    # for energy/stats accumulation over the series


def parse_args(argv):
    cfg = dict(dirin=".", filexml=None, first=None, last=None, files=None,
               move=None, out=C.OutCfg(), specs=[], enpotzero=(0., 0., 0.),
               gravity=(0.0, 0.0, -9.81))
    cur_filters = C.Filters()
    cur_vars = ["idp", "vel", "rhop", "type"]
    i = 0

    def spec(kind, path):
        s = OutSpec(kind, path, cur_filters.copy(), list(cur_vars))
        cfg["specs"].append(s)
        return s

    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(__doc__)
            sys.exit(0)
        elif a == "-dirin":
            i += 1
            cfg["dirin"] = argv[i]
        elif a == "-casein":
            i += 1  # accepted for compatibility; series name is implicit
        elif a == "-filexml":
            i += 1
            cfg["filexml"] = argv[i]
        elif a.startswith("-first:"):
            cfg["first"] = int(a.split(":", 1)[1])
        elif a.startswith("-last:"):
            cfg["last"] = int(a.split(":", 1)[1])
        elif a.startswith("-files:"):
            cfg["files"] = a.split(":", 1)[1]
        elif a.startswith("-move:"):
            cfg["move"] = tuple(float(x) for x in a.split(":")[1:4])
        elif a.startswith("-threads"):
            pass
        elif a.startswith(("-viscoart", "-viscolam", "-viscoauto",
                           "-distinter")):
            pass  # viscosity config only affects -vars:ace (handled there)
        elif a.startswith("-gravity:"):
            cfg["gravity"] = tuple(float(x) for x in a.split(":")[1:4])
        elif a.startswith("-enpotzero:"):
            cfg["enpotzero"] = tuple(float(x)
                                     for x in a.split(":", 1)[1].split(","))
        elif a == "-savevtk":
            i += 1
            spec("vtk", argv[i])
        elif a == "-savecsv":
            i += 1
            spec("csv", argv[i])
        elif a == "-saveascii":
            i += 1
            spec("ascii", argv[i])
        elif a == "-savestatscsv":
            i += 1
            spec("stats", argv[i])
        elif a == "-saveenergy":
            i += 1
            spec("energy", argv[i])
        elif a.startswith("-onlypos:"):
            box = tuple(float(x) for x in a.split(":")[1:7])
            (cfg["specs"][-1].filters if cfg["specs"] else cur_filters
             ).onlypos = box
        elif a.startswith("-onlyvel:"):
            vr = tuple(float(x) for x in a.split(":")[1:3])
            (cfg["specs"][-1].filters if cfg["specs"] else cur_filters
             ).onlyvel = vr
        elif a.startswith("-onlymk:"):
            v = C.parse_range_filter(a.split(":", 1)[1])
            (cfg["specs"][-1].filters if cfg["specs"] else cur_filters
             ).onlymk = v
        elif a.startswith("-onlyid:"):
            v = C.parse_range_filter(a.split(":", 1)[1])
            (cfg["specs"][-1].filters if cfg["specs"] else cur_filters
             ).onlyid = v
        elif a.startswith("-onlytype:"):
            t = C.parse_typesel(a.split(":", 1)[1])
            (cfg["specs"][-1].filters if cfg["specs"] else cur_filters
             ).onlytype = t
        elif a.startswith("-vars:"):
            v = C.parse_vars(a.split(":", 1)[1], cur_vars)
            if cfg["specs"]:
                cfg["specs"][-1].varnames = v
            else:
                cur_vars = v
        elif a.startswith("-createdirs:"):
            cfg["out"].createdirs = a.endswith("1")
        elif a.startswith("-csvsep:"):
            cfg["out"].csvsep = int(a.split(":")[1])
        elif a == "-opt":
            i += 1
            with open(argv[i]) as f:
                extra = f.read().split()
            argv = argv[:i + 1] + extra + argv[i + 1:]
        else:
            raise SystemExit(f"partvtk: unknown option '{a}'")
        i += 1
    if not cfg["specs"]:
        raise SystemExit("partvtk: no output file given (-savevtk/-savecsv)")
    return cfg


def run(cfg):
    parts = C.find_parts(cfg["dirin"], cfg["first"], cfg["last"], cfg["files"])
    blocks = None
    fx = C.resolve_filexml(cfg["filexml"], cfg["dirin"])
    if fx and os.path.exists(fx):
        blocks = C.load_mkblocks_xml(fx)
    written = []
    for cpart, path in parts:
        d = C.load_part(path)
        if cfg["move"] is not None:
            d["pos"] = d["pos"] + np.asarray(cfg["move"])
        for s in cfg["specs"]:
            sel = s.filters.apply(d, blocks)
            dd = {k: (v[sel] if isinstance(v, np.ndarray) else v)
                  for k, v in d.items()
                  if k in ("idp", "pos", "vel", "rhop", "code")}
            dd.update({k: d[k] for k in ("ctes", "counts")})
            fields = C.compute_vars(dd, s.varnames, blocks,
                                    cfg["enpotzero"], cfg["gravity"])
            if s.kind == "vtk":
                p = C.prepare_path(C.numbered(s.path, cpart), cfg["out"])
                vtkout.write_vtk_particles(p, dd["pos"], fields)
                written.append(p)
            elif s.kind in ("csv", "ascii"):
                hdr, cols = ["Pos.x", "Pos.y", "Pos.z"], [dd["pos"]]
                for nm, arr in fields.items():
                    if arr.ndim == 2:
                        hdr += [f"{nm}.x", f"{nm}.y", f"{nm}.z"]
                    else:
                        hdr.append(nm)
                    cols.append(arr.reshape(len(arr), -1))
                mat = np.column_stack(cols)
                p = C.numbered(s.path, cpart)
                if s.kind == "csv":
                    C.write_csv(p, hdr, mat, cfg["out"])
                else:
                    C.write_ascii(p, mat, cfg["out"])
                written.append(p)
            elif s.kind == "stats":
                row = [cpart, d["timestep"], int(sel.sum())]
                hdr = ["Part", "Time", "Np"]
                for nm, arr in fields.items():
                    a = np.linalg.norm(arr, axis=1) if arr.ndim == 2 else arr
                    if len(a) == 0:
                        row += [0, 0, 0]
                    else:
                        row += [a.min(), a.mean(), a.max()]
                    hdr += [f"{nm}.min", f"{nm}.mean", f"{nm}.max"]
                s.rows.append((hdr, row))
            elif s.kind == "energy":
                e = C.compute_vars(dd, ["energy"], blocks, cfg["enpotzero"],
                                   cfg["gravity"])
                s.rows.append((None, [cpart, d["timestep"],
                                      float(e["EnKin"].sum()),
                                      float(e["EnPot"].sum()),
                                      float(e["EnInt"].sum()),
                                      float(e["EnTot"].sum())]))
    for s in cfg["specs"]:
        if s.kind == "stats" and s.rows:
            p = C.write_csv(s.path, s.rows[0][0], [r for _, r in s.rows],
                            cfg["out"])
            written.append(p)
        elif s.kind == "energy" and s.rows:
            p = C.write_csv(s.path,
                            ["Part", "Time", "EnKin", "EnPot", "EnInt",
                             "EnTot"],
                            [r for _, r in s.rows], cfg["out"])
            written.append(p)
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"PartVTK: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
