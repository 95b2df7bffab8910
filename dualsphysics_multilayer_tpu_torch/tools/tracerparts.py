"""TracerParts: particle trajectories over a PART series as VTK polylines.

Rebuild of the closed `TracerParts` binary
(the reference's `doc/help/TracerParts_Help.out`): follows selected particle
ids through Part_XXXX.bi4 files and writes one polyline per particle.

Counterpart of `dualsphysics_multilayer_tpu/tools/tracerparts.py`.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io import vtkout
from . import common as C


def parse_args(argv):
    cfg = dict(dirin=".", filexml=None, first=None, last=None, files=None,
               filters=C.Filters(), savevtk=None, out=C.OutCfg(),
               maxparts=1000)
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
            cfg["filexml"] = argv[i]
        elif a.startswith("-first:"):
            cfg["first"] = int(a.split(":")[1])
        elif a.startswith("-last:"):
            cfg["last"] = int(a.split(":")[1])
        elif a.startswith("-files:"):
            cfg["files"] = a.split(":", 1)[1]
        elif a.startswith("-onlymk:"):
            cfg["filters"].onlymk = C.parse_range_filter(a.split(":", 1)[1])
        elif a.startswith("-onlyid:"):
            cfg["filters"].onlyid = C.parse_range_filter(a.split(":", 1)[1])
        elif a.startswith("-onlypos:"):
            cfg["filters"].onlypos = tuple(float(x) for x in a.split(":")[1:7])
        elif a.startswith("-maxparts:"):
            cfg["maxparts"] = int(a.split(":")[1])
        elif a == "-savevtk":
            i += 1
            cfg["savevtk"] = argv[i]
        elif a.startswith("-createdirs:"):
            cfg["out"].createdirs = a.endswith("1")
        elif a.startswith("-csvsep:"):
            cfg["out"].csvsep = int(a.split(":")[1])
        else:
            raise SystemExit(f"tracerparts: unknown option '{a}'")
        i += 1
    if not cfg["savevtk"]:
        raise SystemExit("tracerparts: give -savevtk <file.vtk>")
    return cfg


def run(cfg):
    parts = C.find_parts(cfg["dirin"], cfg["first"], cfg["last"],
                         cfg["files"])
    blocks = None
    fx = C.resolve_filexml(cfg["filexml"], cfg["dirin"])
    if fx and os.path.exists(fx):
        blocks = C.load_mkblocks_xml(fx)
    track_ids = None
    traj = {}    # idp -> list of positions
    for cpart, path in parts:
        d = C.load_part(path)
        if track_ids is None:
            sel = cfg["filters"].apply(d, blocks)
            ids = d["idp"][sel]
            if len(ids) > cfg["maxparts"]:
                stride = int(np.ceil(len(ids) / cfg["maxparts"]))
                ids = ids[::stride]
            track_ids = set(ids.tolist())
            for i in ids:
                traj[int(i)] = []
        here = np.isin(d["idp"], list(track_ids))
        order = {int(i): k for k, i in enumerate(d["idp"][here])}
        pos = d["pos"][here]
        for i in traj:
            if i in order:
                traj[i].append(pos[order[i]])
    pts, lines, idf = [], [], []
    for i, ps in traj.items():
        if len(ps) < 2:
            continue
        start = len(pts)
        pts.extend(ps)
        idf.extend([i] * len(ps))
        lines.append(np.arange(start, start + len(ps)))
    if not pts:
        raise SystemExit("tracerparts: no trajectories found")
    p = C.prepare_path(cfg["savevtk"], cfg["out"])
    vtkout.write_vtk_mesh(p, np.asarray(pts, np.float32), lines=lines,
                          fields={"Idp": np.asarray(idf, np.float32)})
    return [p]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"TracerParts: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
