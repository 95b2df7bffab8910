"""FlowTool: particle counts / volume / flow rate per user-defined box zone.

Rebuild of the closed `FlowTool` binary
(the reference's `doc/help/FlowTool_Help.out`): boxes come from a
`-fileboxes` file (8-corner prisms, `doc/help/FileBoxesTemplate.txt`
format; boxes sharing a name merge into one zone).  Per PART, counts the
fluid particles inside each zone, reports volume (count * massfluid/rhop0)
and the flow rate between consecutive PARTs.

Counterpart of `dualsphysics_multilayer_tpu/tools/flowtool.py`.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import typesdef as td
from ..io import vtkout
from . import common as C

BOXES_TEMPLATE = """Example_file_to_define_boxes...

BOX @ZoneA
0 0 0
1 0 0
1 1 0
0 1 0
0 0 1
1 0 1
1 1 1
0 1 1
"""


def read_boxes(path):
    """Parse the BOX prism file; returns {name: list of (8,3) corner sets}."""
    zones = {}
    with open(path) as f:
        lines = [ln.split("#")[0].strip() for ln in f]
    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.upper().startswith("BOX"):
            name = ln.split("@", 1)[1].strip() if "@" in ln else f"box{i}"
            pts = []
            i += 1
            while i < len(lines) and len(pts) < 8:
                if lines[i]:
                    pts.append([float(x)
                                for x in lines[i].replace(",", " ").split()])
                i += 1
            if len(pts) == 8:
                zones.setdefault(name, []).append(np.asarray(pts))
            continue
        i += 1
    return zones


def inside_prism(points, corners):
    """Point-in-convex-prism test via the 6 face planes of the 8-corner box
    (ordering per FileBoxesTemplate: bottom 0-3, top 4-7)."""
    faces = [(0, 1, 2), (4, 7, 6), (0, 4, 5), (1, 5, 6), (2, 6, 7),
             (3, 7, 4)]
    center = corners.mean(0)
    ok = np.ones(len(points), bool)
    for a, b, c in faces:
        n = np.cross(corners[b] - corners[a], corners[c] - corners[a])
        if (center - corners[a]) @ n < 0:
            n = -n
        ok &= ((points - corners[a]) @ n) >= 0.0
    return ok


def parse_args(argv):
    cfg = dict(dirin=".", filein=None, fileboxes=None, first=None, last=None,
               files=None, savecsv=None, savevtk=None, out=C.OutCfg())
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
        elif a == "-filein":
            i += 1
            cfg["filein"] = argv[i]
        elif a == "-fileboxes":
            i += 1
            cfg["fileboxes"] = argv[i]
        elif a == "-boxestemplate":
            print(BOXES_TEMPLATE)
            sys.exit(0)
        elif a.startswith("-first:"):
            cfg["first"] = int(a.split(":")[1])
        elif a.startswith("-last:"):
            cfg["last"] = int(a.split(":")[1])
        elif a.startswith("-files:"):
            cfg["files"] = a.split(":", 1)[1]
        elif a.startswith("-threads"):
            pass
        elif a == "-savecsv":
            i += 1
            cfg["savecsv"] = argv[i]
        elif a == "-savevtk":
            i += 1
            cfg["savevtk"] = argv[i]
        elif a.startswith("-createdirs:"):
            cfg["out"].createdirs = a.endswith("1")
        elif a.startswith("-csvsep:"):
            cfg["out"].csvsep = int(a.split(":")[1])
        elif a == "-opt":
            i += 1
            with open(argv[i]) as f:
                argv[i + 1:i + 1] = f.read().split()
        else:
            raise SystemExit(f"flowtool: unknown option '{a}'")
        i += 1
    if not cfg["fileboxes"]:
        raise SystemExit("flowtool: give -fileboxes <file>")
    return cfg


def run(cfg):
    zones = read_boxes(cfg["fileboxes"])
    if cfg["filein"]:
        parts = [(0, cfg["filein"])]
    else:
        parts = C.find_parts(cfg["dirin"], cfg["first"], cfg["last"],
                             cfg["files"])
    names = list(zones)
    rows = []
    prev = None
    written = []
    for cpart, path in parts:
        d = C.load_part(path)
        fluid = C.type_of(d) == td.TYPE_FLUID
        pos = d["pos"][fluid]
        vol_p = d["ctes"]["MassFluid"] / d["ctes"]["Rhop0"]
        counts = []
        zone_of = np.full(len(pos), -1, np.int32)
        for zi, nm in enumerate(names):
            ins = np.zeros(len(pos), bool)
            for box in zones[nm]:
                ins |= inside_prism(pos, box)
            counts.append(int(ins.sum()))
            zone_of[ins & (zone_of < 0)] = zi
        t = d["timestep"]
        row = [cpart, f"{t:.7e}"]
        for zi, nm in enumerate(names):
            vol = counts[zi] * vol_p
            if prev is None:
                rate = 0.0
            else:
                dtp = max(t - prev[0], 1e-12)
                rate = (vol - prev[1][zi]) / dtp
            row += [counts[zi], f"{vol:.7e}", f"{rate:.7e}"]
        rows.append(row)
        prev = (t, [c * vol_p for c in counts])
        if cfg["savevtk"]:
            p = C.prepare_path(C.numbered(cfg["savevtk"], cpart), cfg["out"])
            vtkout.write_vtk_particles(p, pos, {"Zone": zone_of})
            written.append(p)
    if cfg["savecsv"]:
        hdr = ["Part", "Time"]
        for nm in names:
            hdr += [f"Count_{nm}", f"Volume_{nm}", f"Flow_{nm}"]
        base = cfg["savecsv"]
        if not base.endswith(".csv"):
            base += ".csv"
        written.append(C.write_csv(base, hdr, rows, cfg["out"]))
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"FlowTool: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
