"""BIFileInfo: dump the structure and content summary of any .bi4-family
file (the self-describing JBinaryData container).

Rebuild of the closed `BIFileInfo` binary
(the reference's `doc/help/BIFileInfo_Help.out`).

    python -m dualsphysics_multilayer_tpu_torch.tools.bifileinfo out/Part_0001.bi4

Counterpart of `dualsphysics_multilayer_tpu/tools/bifileinfo.py`.
"""

from __future__ import annotations

import sys

import numpy as np

from ..io import jbinary as jb

_TYPE_NAMES = {jb.TEXT: "text", jb.BOOL: "bool", jb.CHAR: "char",
               jb.UCHAR: "uchar", jb.SHORT: "short", jb.USHORT: "ushort",
               jb.INT: "int", jb.UINT: "uint", jb.LLONG: "llong",
               jb.ULLONG: "ullong", jb.FLOAT: "float", jb.DOUBLE: "double",
               jb.INT3: "int3", jb.UINT3: "uint3", jb.FLOAT3: "float3",
               jb.DOUBLE3: "double3"}


def dump_item(it, indent=0, out=print, arrays=True):
    pad = "  " * indent
    out(f"{pad}ITEM \"{it.name}\"  values:{len(it.values)} "
        f"arrays:{len(it.arrays)} items:{len(it.items)}")
    for nm, (t, v) in it.values.items():
        out(f"{pad}  {nm} <{_TYPE_NAMES.get(t, t)}> = {v}")
    if arrays:
        for a in it.arrays:
            d = np.asarray(a.data)
            stat = ""
            if d.size and d.dtype.kind in "fiu":
                stat = f"  min={d.min():.6g} max={d.max():.6g}"
            out(f"{pad}  ARRAY {a.name} <{_TYPE_NAMES.get(a.type, a.type)}> "
                f"n={a.count}{stat}")
    for ch in it.items:
        dump_item(ch, indent + 1, out, arrays)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    paths = [a for a in argv if not a.startswith("-")]
    if not paths or "-h" in argv or "--help" in argv:
        print(__doc__)
        return 0 if paths or "-h" in argv or "--help" in argv else 2
    for p in paths:
        print(f"=== {p} ===")
        dump_item(jb.read_file(p), arrays="-noarrays" not in argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
