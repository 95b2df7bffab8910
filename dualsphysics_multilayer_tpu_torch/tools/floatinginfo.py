"""FloatingInfo: floating-body motion history (PartFloat.fbi4) to CSV.

Rebuild of the closed `FloatingInfo` binary
(the reference's `doc/help/FloatingInfo_Help.out`): per selected mkbound,
one CSV with center / linear+angular velocity / accelerations per PART.

    python -m dualsphysics_multilayer_tpu_torch.tools.floatinginfo \
        -dirin out -onlymk:51 -savemotion motion

Counterpart of `dualsphysics_multilayer_tpu/tools/floatinginfo.py`.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io.floatdata import read_floatbi4
from . import common as C


def parse_args(argv):
    cfg = dict(dirin=".", first=None, last=None, files=None, onlymk=None,
               savemotion=None, savedata=None, out=C.OutCfg())
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
        elif a.startswith("-files:"):
            cfg["files"] = a.split(":", 1)[1]
        elif a.startswith("-onlymk:"):
            cfg["onlymk"] = C.parse_range_filter(a.split(":", 1)[1])
        elif a in ("-savemotion", "-savedata", "-savecsv"):
            i += 1
            cfg["savemotion"] = argv[i]
        elif a.startswith("-createdirs:"):
            cfg["out"].createdirs = a.endswith("1")
        elif a.startswith("-csvsep:"):
            cfg["out"].csvsep = int(a.split(":")[1])
        elif a == "-opt":
            i += 1
            with open(argv[i]) as f:
                argv[i + 1:i + 1] = f.read().split()
        else:
            raise SystemExit(f"floatinginfo: unknown option '{a}'")
        i += 1
    return cfg


def run(cfg):
    path = os.path.join(cfg["dirin"], "PartFloat.fbi4")
    if not os.path.exists(path):
        raise SystemExit(f"floatinginfo: '{path}' not found")
    head, parts = read_floatbi4(path)
    if cfg["first"] is not None:
        parts = [p for p in parts if p["cpart"] >= cfg["first"]]
    if cfg["last"] is not None:
        parts = [p for p in parts if p["cpart"] <= cfg["last"]]
    mks = head["mkbound"]
    sel = range(len(mks)) if cfg["onlymk"] is None else \
        [i for i, mk in enumerate(mks) if mk in cfg["onlymk"]]
    base = cfg["savemotion"] or "FloatingMotion"
    if base.endswith(".csv"):
        base = base[:-4]
    written = []
    for bi in sel:
        rows = []
        for p in parts:
            rows.append([
                p["cpart"], f"{p['timestep']:.7e}",
                *C.fmt3(p["center"][bi]), *C.fmt3(p["fvel"][bi]),
                *C.fmt3(p["fomega"][bi]),
                *(C.fmt3(p["facelin"][bi]) if p["facelin"] is not None
                  else (0, 0, 0)),
                *(C.fmt3(p["faceang"][bi]) if p["faceang"] is not None
                  else (0, 0, 0))])
        hdr = (["Part", "Time"]
               + [f"Center.{c}" for c in "xyz"]
               + [f"Vel.{c}" for c in "xyz"]
               + [f"Omega.{c}" for c in "xyz"]
               + [f"AceLin.{c}" for c in "xyz"]
               + [f"AceAng.{c}" for c in "xyz"])
        p = C.write_csv(f"{base}_mkbound{int(mks[bi])}.csv", hdr, rows,
                        cfg["out"])
        written.append(p)
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"FloatingInfo: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
