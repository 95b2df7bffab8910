"""BoundaryVTK: boundary geometry as VTK, optionally animated by the case
motion definition or by recorded particle data.

Rebuild of the closed `BoundaryVTK` binary
(the reference's `doc/help/BoundaryVTK_Help.out`), covering the shipped
workflows: boundary shapes from the initial particles (per-mk), moved either
by `-motiontime` (replay the XML <motion> script) or `-motiondata` (read
boundary positions from each PART).

Counterpart of `dualsphysics_multilayer_tpu/tools/boundaryvtk.py`.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import typesdef as td
from ..io import vtkout
from . import common as C


def parse_args(argv):
    cfg = dict(dirin=None, filexml=None, motiontime=None, motiondata=None,
               savevtkdata=None, onlymk=None, out=C.OutCfg())
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(__doc__)
            sys.exit(0)
        elif a == "-filexml":
            i += 1
            cfg["filexml"] = argv[i]
        elif a.startswith("-motiontime:"):
            f = a.split(":")[1:]
            cfg["motiontime"] = (float(f[0]), float(f[1]))
        elif a in ("-motiondata", "-motiondatatime"):
            i += 1
            cfg["motiondata"] = argv[i]
            cfg["dirin"] = cfg["dirin"] or argv[i]
        elif a == "-dirin":
            i += 1
            cfg["dirin"] = argv[i]
        elif a.startswith("-onlymk:"):
            cfg["onlymk"] = C.parse_range_filter(a.split(":", 1)[1])
        elif a in ("-savevtkdata", "-savevtk"):
            i += 1
            cfg["savevtkdata"] = argv[i]
        elif a.startswith("-createdirs:"):
            cfg["out"].createdirs = a.endswith("1")
        elif a.startswith("-csvsep:"):
            cfg["out"].csvsep = int(a.split(":")[1])
        elif a.startswith(("-loadvtk", "-loadply", "-loadstl", "-changemk",
                           "-onlyid", "-info", "-motionfile",
                           "-motiondata0")):
            # shape-file loading paths not supported: particle-based shapes
            # cover the shipped example workflows
            if a in ("-loadvtk",):
                i += 1
        else:
            raise SystemExit(f"boundaryvtk: unknown option '{a}'")
        i += 1
    if not cfg["savevtkdata"]:
        raise SystemExit("boundaryvtk: give -savevtkdata <file.vtk>")
    return cfg


def run(cfg):
    written = []
    if cfg["motiondata"]:
        parts = C.find_parts(cfg["motiondata"])
    elif cfg["dirin"]:
        parts = C.find_parts(cfg["dirin"])
    else:
        raise SystemExit("boundaryvtk: give -motiondata/-dirin")
    blocks = None
    fx = C.resolve_filexml(cfg["filexml"], cfg["dirin"] or ".")
    if fx and os.path.exists(fx):
        blocks = C.load_mkblocks_xml(fx)
    if cfg["motiontime"]:
        # replay the XML motion script over the initial boundary particles
        from ..io.xmlcase import load_case
        case, _, _ = load_case(fx, device="cpu")
        feats = case.meta.get("features")
        motions = feats.motions if feats is not None else ()
        d = C.load_part(parts[0][1])
        bsel = C.type_of(d) != td.TYPE_FLUID
        if cfg["onlymk"] is not None:
            bsel &= np.isin(C.mk_of(d, blocks), cfg["onlymk"])
        pos0 = d["pos"][bsel]
        tdur, tstep = cfg["motiontime"]
        nstep = int(np.floor(tdur / tstep)) + 1
        from ..features import motion as MOT
        code = d["code"][bsel] if d["code"] is not None else None
        for k in range(nstep):
            t = k * tstep
            pos = pos0
            if motions and code is not None:
                p0 = torch.as_tensor(pos0, dtype=torch.float32)
                p, _ = MOT.apply_motion(
                    motions, torch.tensor(t, dtype=torch.float32),
                    torch.tensor(tstep, dtype=torch.float32), p0,
                    torch.zeros(p0.shape, dtype=torch.float32),
                    torch.as_tensor(code.astype(np.int32)))
                pos = p.numpy()
            p = C.prepare_path(C.numbered(cfg["savevtkdata"], k), cfg["out"])
            vtkout.write_vtk_particles(p, pos, {})
            written.append(p)
        return written
    for cpart, path in parts:
        d = C.load_part(path)
        bsel = C.type_of(d) != td.TYPE_FLUID
        if cfg["onlymk"] is not None:
            bsel &= np.isin(C.mk_of(d, blocks), cfg["onlymk"])
        p = C.prepare_path(C.numbered(cfg["savevtkdata"], cpart), cfg["out"])
        vtkout.write_vtk_particles(
            p, d["pos"][bsel],
            {"Mk": C.mk_of(d, blocks)[bsel],
             "Type": C.type_of(d)[bsel]})
        written.append(p)
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"BoundaryVTK: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
