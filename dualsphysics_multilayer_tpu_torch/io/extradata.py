"""Extra per-PART data files (mDBC boundary normals) — the JDsExtraData
channel.

Counterpart of `dualsphysics_multilayer_tpu/io/extradata.py` (reference
`JDsExtraData.h/cpp`): per PART a `PartExtra_%04u.bi4` file (root item
"JPartExtraBi4") holding the mDBC boundary normals as an idp-indexed float3
array of size CaseNbound (or CaseNbound-CaseNfloat when floating normals
are off), read back to restart mDBC runs (`JDsExtraDataLoad::LoadNormals`,
`JDsExtraData.cpp:207`).  Indexed by id, so the port's slot order does not
reach the file.
"""

from __future__ import annotations

import os

import numpy as np

from .. import typesdef as td
from . import jbinary as jb
from .partdata import APPNAME, host

FORMAT_VER = 230331          # JDsExtraData.h FormatVerDef


def extra_filename(cpart: int) -> str:
    return f"PartExtra_{cpart:04d}.bi4"


def save_extradata(dirout, cpart, timestep, state, *, casenbound,
                   casenfloat=0, usenormalsft=False, nstep=0,
                   appname=APPNAME):
    """Write one PartExtra file from a SimState with boundnormal
    (JDsExtraDataSave::InitPartData + AddNormals + SavePartData)."""
    if not casenfloat:
        usenormalsft = False
    nsize = casenbound if usenormalsft else casenbound - casenfloat
    root = jb.JItem(name="JPartExtraBi4")
    root.set_text("AppName", appname)
    root.set_uint("FormatVer", FORMAT_VER)
    root.set_uint("CaseNbound", casenbound)
    root.set_uint("CaseNfloat", casenfloat)
    root.set_int("Cpart", cpart)
    root.set_uint("Step", int(nstep))
    root.set_double("TimeStep", float(timestep))
    root.set_bool("UseNormalsFt", usenormalsft)

    idp = host(state.idp)
    code = host(state.code)
    nor = host(state.boundnormal).astype(np.float32)
    vnor = np.zeros((nsize, 3), np.float32)
    normal = ((code >> td.CODE_SPECIAL_SHIFT) & td.CODE_SPECIAL_MASK) == 0
    sel = (idp < nsize) & normal
    vnor[idp[sel]] = nor[sel]
    root.add_array("Normals", jb.FLOAT3, vnor)
    path = os.path.join(dirout, extra_filename(cpart))
    jb.write_file(path, root, filecode="JPartExtraBi4")
    return path


def load_extradata(dirout, cpart):
    """Read a PartExtra file; returns dict(normals (nsize,3), usenormalsft,
    casenbound, casenfloat) or None if absent
    (JDsExtraDataLoad::ExistsDataParts/LoadNormals)."""
    path = os.path.join(dirout, extra_filename(cpart))
    if not os.path.exists(path):
        return None
    root = jb.read_file(path)
    ar = root.array("Normals")
    if ar is None:
        raise ValueError(f"{path}: array 'Normals' is missing")
    return dict(normals=np.asarray(ar.data, np.float32),
                usenormalsft=bool(root.get("UseNormalsFt", False)),
                casenbound=int(root.get("CaseNbound", 0)),
                casenfloat=int(root.get("CaseNfloat", 0)))


def apply_normals(extra, idp, code, cap):
    """Scatter the idp-indexed normals table back onto particle slots
    (JDsExtraDataLoad::LoadNormals inverse mapping)."""
    out = np.zeros((cap, 3), np.float32)
    nsize = len(extra["normals"])
    idp = host(idp)
    sel = idp < nsize
    out[np.where(sel)[0]] = extra["normals"][idp[sel]]
    return out
