"""PartVTKOut: excluded-particle stream (PartOut_xxx.obi4) to VTK/CSV.

Rebuild of the closed `PartVTKOut` binary
(the reference's `doc/help/PartVTKOut_Help.out`): dumps the particles the
solver excluded (out-of-domain / out-of-density), tagged by their exclusion
motive (1=pos, 2=rhop, 3=move).

Counterpart of `dualsphysics_multilayer_tpu/tools/partvtkout.py`.
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from ..io import vtkout
from ..io.floatdata import read_partout
from . import common as C


def parse_args(argv):
    cfg = dict(dirin=".", savevtk=None, savecsv=None, out=C.OutCfg(),
               first=None, last=None)
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
        elif a == "-filexml":
            i += 1
        elif a.startswith("-first:"):
            cfg["first"] = int(a.split(":")[1])
        elif a.startswith("-last:"):
            cfg["last"] = int(a.split(":")[1])
        elif a == "-savevtk":
            i += 1
            cfg["savevtk"] = argv[i]
        elif a == "-savecsv":
            i += 1
            cfg["savecsv"] = argv[i]
        elif a.startswith("-createdirs:"):
            cfg["out"].createdirs = a.endswith("1")
        elif a.startswith("-csvsep:"):
            cfg["out"].csvsep = int(a.split(":")[1])
        else:
            raise SystemExit(f"partvtkout: unknown option '{a}'")
        i += 1
    return cfg


def run(cfg):
    files = sorted(glob.glob(os.path.join(cfg["dirin"], "PartOut_*.obi4")))
    if not files:
        raise SystemExit(f"partvtkout: no PartOut_*.obi4 in '{cfg['dirin']}'")
    written = []
    rows = []
    for f in files:
        for p in read_partout(f):
            if cfg["first"] is not None and p["cpart"] < cfg["first"]:
                continue
            if cfg["last"] is not None and p["cpart"] > cfg["last"]:
                continue
            if cfg["savevtk"]:
                out = C.prepare_path(C.numbered(cfg["savevtk"], p["cpart"]),
                                     cfg["out"])
                vtkout.write_vtk_particles(
                    out, p["pos"],
                    dict(Idp=p["idp"], Vel=p["vel"], Rhop=p["rhop"],
                         Motive=p["motive"].astype(np.int32)))
                written.append(out)
            if cfg["savecsv"]:
                for k in range(len(p["idp"])):
                    rows.append([p["cpart"], f"{p['timestep']:.7e}",
                                 p["idp"][k], *C.fmt3(p["pos"][k]),
                                 *C.fmt3(p["vel"][k]),
                                 f"{p['rhop'][k]:.7e}", int(p["motive"][k])])
    if cfg["savecsv"]:
        base = cfg["savecsv"]
        if not base.endswith(".csv"):
            base += ".csv"
        hdr = ["Part", "Time", "Idp", "Pos.x", "Pos.y", "Pos.z",
               "Vel.x", "Vel.y", "Vel.z", "Rhop", "Motive"]
        written.append(C.write_csv(base, hdr, rows, cfg["out"]))
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"PartVTKOut: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
