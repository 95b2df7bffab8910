"""PART snapshot files (.bi4) + run metadata, DualSPHysics-layout-compatible.

Counterpart of `dualsphysics_multilayer_tpu/io/partdata.py` (reference
`JPartDataBi4`): the root item "JPartDataBi4" carries the case config values
and one "PART_%04u" child item with the particle arrays Idp/Posd/Vel/Rhop
and the typecodes.  A file written here holds the same items and arrays as
the JAX package's for the same particles, apart from two text values:
``RunCode`` (the device the run used, "cuda" or "cpu", where the JAX writer
says "tpu") and ``AppName``.

The port keeps its state in cell-sorted slots that move at every rebuild;
the writer sorts live particles by id, so the slot order never reaches the
file.  Every PART file is a full checkpoint (``io.output.restart_state``).
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from . import jbinary as jb
from .. import typesdef as td

APPNAME = "dualsphysics_multilayer_tpu_torch"


def host(x):
    """A numpy array of ``x``: one copy to the host for a tensor."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


class HostCopy:
    """A state's arrays on the host for one save: each field is copied once,
    on first use, and ``nbytes`` counts the bytes copied from tensors.  The
    writers take it where they take a SimState."""

    def __init__(self, state):
        self.state = state
        self.runcode = state.pos.device.type if hasattr(state.pos, "cpu") \
            else "cpu"
        self.nbytes = 0

    def get(self, x):
        """``host(x)``, counted."""
        a = host(x)
        if hasattr(x, "cpu"):
            self.nbytes += a.nbytes
        return a

    def __getattr__(self, name):
        x = getattr(self.state, name)
        if not hasattr(x, "__array__"):
            return x
        a = self.get(x)
        setattr(self, name, a)
        return a


def live_mask(code):
    """Particles still in the run (not excluded, not spare slots)."""
    return td.code_special(code) < td.SPECIAL_OUT_POS


def part_filename(cpart, piece=0, npiece=1):
    """`JPartDataBi4::GetFileNamePart` naming ("Part_0001.bi4")."""
    return f"Part_{cpart:04d}.bi4"


class PartWriter:
    """Writes Part_XXXX.bi4 snapshots (the analog of JSph::SavePartData,
    JSph.cpp:2581)."""

    def __init__(self, dirout, csp, *, casename="case", appname=None,
                 np_total=0, nfixed=0, nmoving=0, nfloat=0, nfluid=0,
                 posmin=(0, 0, 0), posmax=(0, 0, 0), nortimes=False,
                 posdouble=True):
        self.posdouble = posdouble
        # nortimes: strip wall-clock values so outputs are byte-diffable
        # (the reference's -nortimes debug flag, JSphCfgRun.cpp:206)
        self.nortimes = nortimes
        self.dirout = dirout
        os.makedirs(dirout, exist_ok=True)
        self.csp = csp
        self.casename = casename
        self.appname = appname or APPNAME
        self.counts = (np_total, nfixed, nmoving, nfloat, nfluid)
        self.posmin, self.posmax = posmin, posmax

    def _config_root(self, root, runcode):
        csp = self.csp
        root.set_uint("Piece", 0)
        root.set_uint("Npiece", 1)
        root.set_text("RunCode", runcode)
        root.set_text("Date", "" if self.nortimes
                      else datetime.datetime.now().isoformat(" ")[:19])
        root.set_text("AppName", self.appname)
        root.set_text("CaseName", self.casename)
        root.set_bool("Data2d", csp.simulate2d)
        root.set_double("Data2dPosY", 0.0)
        root.set_double3("MapPosMin", self.posmin)
        root.set_double3("MapPosMax", self.posmax)
        root.set_int("PeriMode", 0)
        root.set_double3("PeriXinc", (0, 0, 0))
        root.set_double3("PeriYinc", (0, 0, 0))
        root.set_double3("PeriZinc", (0, 0, 0))
        root.set_int("AxisDiv", 0)
        npt, nfx, nmv, nft, nfl = self.counts
        root.set_ullong("CaseNp", npt)
        root.set_ullong("CaseNfixed", nfx)
        root.set_ullong("CaseNmoving", nmv)
        root.set_ullong("CaseNfloat", nft)
        root.set_ullong("CaseNfluid", nfl)
        root.set_double3("CasePosMin", self.posmin)
        root.set_double3("CasePosMax", self.posmax)
        root.set_bool("NpDynamic", False)
        root.set_bool("ReuseIds", False)
        root.set_double("Dp", csp.dp)
        root.set_double("H", csp.kernelh)
        root.set_double("B", csp.cteb)
        root.set_double("Rhop0", csp.rhopzero)
        root.set_double("Gamma", csp.gamma)
        root.set_double("MassBound", csp.massbound)
        root.set_double("MassFluid", csp.massfluid)

    def save(self, cpart, timestep, state, *, nstep=0, runtime=0.0,
             extra_arrays=None):
        """Write one PART from a SimState: live particles only, in id
        order, like the reference's NpbOk+Npf staging.  ``state`` may be a
        :class:`HostCopy` the caller's other channels share."""
        if not isinstance(state, HostCopy):
            state = HostCopy(state)
        pos, vel, rho = state.pos, state.vel, state.rho
        idp, code = state.idp, state.code
        live = live_mask(code)
        sel = np.where(live)[0]
        sel = sel[np.argsort(idp[sel])]
        npok = len(sel)

        root = jb.JItem(name="JPartDataBi4")
        self._config_root(root, state.runcode)
        part = root.child(f"PART_{cpart:04d}")
        part.set_uint("Cpart", cpart)
        part.set_double("TimeStep", float(timestep))
        part.set_uint("Npok", npok)
        part.set_uint("Nout", int((~live).sum()))
        part.set_uint("Step", int(nstep))
        part.set_double("RunTime", 0.0 if self.nortimes else float(runtime))
        part.set_double3("DomainMin", tuple(pos[sel].min(0)) if npok else (0,) * 3)
        part.set_double3("DomainMax", tuple(pos[sel].max(0)) if npok else (0,) * 3)
        part.add_array("Idp", jb.UINT, idp[sel].astype(np.uint32))
        # reference naming: "Pos" is float3, doubles go in "Posd"
        # (JPartDataBi4::AddPartData, JPartDataBi4.cpp:360-372); double by
        # default, -saveposdouble:0 the reference's float
        if self.posdouble:
            part.add_array("Posd", jb.DOUBLE3, pos[sel].astype(np.float64))
        else:
            part.add_array("Pos", jb.FLOAT3, pos[sel].astype(np.float32))
        part.add_array("Vel", jb.FLOAT3, vel[sel].astype(np.float32))
        part.add_array("Rhop", jb.FLOAT, rho[sel].astype(np.float32))
        # typecodes for an exact restart (the JAX package's extension)
        part.add_array("Code", jb.UINT, code[sel].astype(np.uint32))
        if extra_arrays:
            for name, (typ, arr) in extra_arrays.items():
                part.add_array(name, typ, state.get(arr)[sel])
        path = os.path.join(self.dirout, part_filename(cpart))
        jb.write_file(path, root, filecode="JPartDataBi4")
        return path


def read_part(path):
    """Load a PART/case .bi4 (the port's, the JAX package's or GenCase's).
    Returns a dict with config values and particle arrays (the
    JPartsLoad4::LoadParticles contract, JPartsLoad4.cpp:151)."""
    root = jb.read_file(path)
    if root.name != "JPartDataBi4":
        raise ValueError(f"{path}: unexpected root item {root.name}")
    part = None
    for it in root.items:
        if it.name.startswith("PART_") or it.name == "Case":
            part = it
            break
    if part is None and root.items:
        part = root.items[0]
    if part is None:
        raise ValueError(f"{path}: no PART item found")

    def arr(name, alt=None):
        a = part.array(name) or (part.array(alt) if alt else None)
        return None if a is None else a.data

    pos = arr("Pos", "Posd")
    if pos is None:
        # split double2+double encoding (GPU runs): Posxy + Posz
        pxy, pz = arr("Posxy"), arr("Posz")
        if pxy is not None:
            pos = np.column_stack([pxy[:, 0], pxy[:, 1], pz])
    return dict(
        casename=root.get("CaseName"),
        data2d=bool(root.get("Data2d", False)),
        counts={k: int(root.get(k, 0)) for k in
                ("CaseNp", "CaseNfixed", "CaseNmoving", "CaseNfloat",
                 "CaseNfluid")},
        ctes={k: root.get(k) for k in
              ("Dp", "H", "B", "Rhop0", "Gamma", "MassBound", "MassFluid")},
        mapposmin=root.get("MapPosMin"),
        mapposmax=root.get("MapPosMax"),
        cpart=int(part.get("Cpart", 0)),
        timestep=float(part.get("TimeStep", 0.0)),
        nstep=int(part.get("Step", 0)),
        npok=int(part.get("Npok", 0)),
        idp=arr("Idp", "Idpd"),
        pos=pos,
        vel=arr("Vel"),
        rhop=arr("Rhop"),
        code=arr("Code"),
    )
