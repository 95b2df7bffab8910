"""Run output manager + checkpoint/restart.

Counterpart of `dualsphysics_multilayer_tpu/io/output.py`: the per-PART
output channels the reference writes from `JSph::SaveData` (JSph.cpp:2717):
bi4 PART snapshots (full checkpoints), VTK and CSV particle dumps, gauges,
the SaveDt and floating-motion rings, the mooring lines, the run info,
extra data and the excluded-particle stream; and the `-partbegin` restart
contract (SURVEY §5.4): any PART file restores the particle state, time
and step counter.

Everything runs on the host at save time: each array the channels read is
copied from the device once per save (``partdata.HostCopy``, which counts
the bytes), never per step.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re

import numpy as np
import torch

from .. import typesdef as td
from . import extradata, floatdata, partdata, vtkout
from .partdata import HostCopy, host, live_mask


class OutputTime:
    """Variable PART-output schedule (the reference JDsOutputTime /
    `<special><timeout>` table, `_FmtXML_TimeOut.xml`): piecewise-constant
    intervals [(t_i, timeout_i)]; interval(t) is the timeout of the last
    entry with t_i <= t."""

    def __init__(self, entries):
        entries = sorted((float(t), float(dt)) for t, dt in entries)
        if not entries or entries[0][0] > 0.0:
            raise ValueError("timeout table must start at time=0")
        self.entries = entries

    def interval(self, t):
        out = self.entries[0][1]
        for ti, dt in self.entries:
            if ti <= t + 1e-12:
                out = dt
            else:
                break
        return out


def type_counts(code):
    """Live particles by type, as PartWriter's case counts."""
    ptype = td.code_type(code)
    live = live_mask(code)
    return dict(
        np_total=int(live.sum()),
        nfixed=int((live & (ptype == td.TYPE_FIXED)).sum()),
        nmoving=int((live & (ptype == td.TYPE_MOVING)).sum()),
        nfloat=int((live & (ptype == td.TYPE_FLOATING)).sum()),
        nfluid=int((live & (ptype == td.TYPE_FLUID)).sum()),
    )


class OutputManager:
    """Attachable on_save callback: writes Part_XXXX.bi4 and the channels
    the run asks for (the JAX ``OutputManager``'s)."""

    def __init__(self, dirout, case, *, save_vtk=False, gauges=None,
                 casename=None, save_info=False, feats=None,
                 nortimes=False, posdouble=True, extraparts="",
                 svnormals=False, save_csv=False, csvsep=";"):
        self.dirout = dirout
        self.save_csv = save_csv
        self.csvsep = csvsep
        os.makedirs(dirout, exist_ok=True)
        self.feats = feats
        # -svextraparts cadence (JDsExtraDataSave::Config/CheckSave,
        # JDsExtraData.cpp:68-84): "" = save whenever the run carries
        # normals, int N = PARTs divisible by N, range list = JRangeFilter
        self._extraparts_n = None
        self._extraparts_set = None
        if extraparts:
            if extraparts.isdigit():
                self._extraparts_n = int(extraparts)
            else:
                from ..tools.common import parse_range_filter
                self._extraparts_set = set(
                    int(v) for v in parse_range_filter(extraparts))
                self._extraparts_n = 1
        self.svnormals = svnormals
        counts = type_counts(host(case.state.code))
        casename = casename or case.meta.get("name", "case")
        self.writer = partdata.PartWriter(
            dirout, case.csp, casename=casename,
            posmin=case.dom.posmin, posmax=case.dom.posmax,
            nortimes=nortimes, posdouble=posdouble, **counts)
        self.save_vtk = save_vtk
        self.gauges = gauges
        self.save_info = save_info
        self.files = []
        self.last_save_bytes = 0
        # Part_Head.ibi4 run metadata (JPartDataHead, read back for restart
        # validation, JSph::RestartCheckData JSph.cpp:1993)
        floatdata.write_parthead(
            dirout, case.csp, casename=casename,
            mapposmin=case.dom.posmin, mapposmax=case.dom.posmax)
        # floating-body history channel (PartFloat.fbi4, JPartFloatBi4)
        self.floatw = None
        if feats is not None and feats.floating is not None:
            self.floatw = self._float_writer("PartFloat.fbi4")
        self.ftmotw = None
        # excluded-particle stream (PartOut .obi4, JPartOutBi4Save)
        self.outw = floatdata.PartOutWriter(dirout)
        self._out_seen = set()
        # extra-data channel (PartExtra .bi4 with the mDBC normals)
        self._nbound = counts["nfixed"] + counts["nmoving"] + counts["nfloat"]
        self._nfloat = counts["nfloat"]

    def _float_writer(self, filename):
        fc = self.feats.floating
        return floatdata.FloatBi4Writer(
            self.dirout, mkbound=np.arange(fc.count, dtype=np.uint16),
            begin=np.zeros(fc.count, np.uint32),
            count=np.zeros(fc.count, np.uint32),
            mass=np.asarray(fc.mass, np.float32),
            massp=np.asarray(fc.massp, np.float32), filename=filename)

    def __call__(self, sim):
        cpart = sim.part
        st = sim.state
        # every channel reads the host arrays of this one copy
        h = HostCopy(st)
        path = self.writer.save(cpart, sim.time, h, nstep=sim.carry.nstep,
                                runtime=getattr(sim, "walltime", 0.0))
        self.files.append(path)
        if self.save_vtk:
            vtkout.write_state_vtk(
                os.path.join(self.dirout, f"PartVtk_{cpart:04d}.vtk"), h)
        if self.save_csv:
            self.write_csv(h, cpart)
        if self.gauges is not None:
            self.gauges.run(sim.time, st)
            self.gauges.save_csv(self.dirout)
        if sim.carry.dthist is not None:
            self.drain_savedt(sim, h)
        if sim.carry.fthist is not None:
            self.drain_ftmotion(sim, h)
        if sim.carry.moor is not None:
            self.save_moorings(sim, h)
        if self.save_info:
            self.write_info(sim, h)
        save_extra = st.boundnormal is not None and self._nbound
        if save_extra and self._extraparts_n is not None:
            # explicit -svextraparts cadence (JDsExtraDataSave::CheckSave)
            save_extra = (cpart > 0 and cpart % self._extraparts_n == 0
                          and (self._extraparts_set is None
                               or cpart in self._extraparts_set))
        if save_extra:
            extradata.save_extradata(
                self.dirout, cpart, sim.time, h,
                casenbound=self._nbound, casenfloat=self._nfloat,
                usenormalsft=self._nfloat > 0, nstep=sim.carry.nstep)
        if self.svnormals and st.boundnormal is not None:
            # -svnormals: per-PART boundary-normal VTK
            # (SaveVtkNormals, JSphCpuSingle.cpp:1177)
            ndir = os.path.join(self.dirout, "normals")
            os.makedirs(ndir, exist_ok=True)
            bnd = live_mask(h.code) & (td.code_type(h.code) < td.TYPE_FLUID)
            vtkout.write_vtk_particles(
                os.path.join(ndir, f"Normals_{cpart:04d}.vtk"),
                h.pos[bnd], {"Idp": h.idp[bnd], "Normal": h.boundnormal[bnd]})
        if self.floatw is not None and st.ft is not None:
            ft = st.ft
            self.floatw.save_part(
                cpart, sim.time, step=sim.carry.nstep,
                center=h.get(ft.center), fvel=h.get(ft.fvel),
                fomega=h.get(ft.fomega))
        self.drain_partout(sim, h)
        # bytes this save copied from the device
        self.last_save_bytes = h.nbytes

    def write_csv(self, h, cpart):
        """Per-particle CSV dump (`-sv:csv`, reference JOutputCsv::SaveCsv):
        one PartCsv_XXXX.csv per PART, live particles in id order, with the
        basic-array columns of `JSph::AddBasicArrays` (JSph.cpp:2568)."""
        live = live_mask(h.code)
        pos, vel, rho, idp = h.pos[live], h.vel[live], h.rho[live], h.idp[live]
        ptype = td.code_type(h.code[live])
        s = self.csvsep
        path = os.path.join(self.dirout, f"PartCsv_{cpart:04d}.csv")
        with open(path, "w") as f:
            f.write(s.join(["Idp", "Pos.x [m]", "Pos.y [m]", "Pos.z [m]",
                            "Vel.x [m/s]", "Vel.y [m/s]", "Vel.z [m/s]",
                            "Rhop [kg/m^3]", "Type"]) + "\n")
            order = np.argsort(idp, kind="stable")
            cols = np.column_stack([
                idp[order].astype(np.int64), pos[order],
                vel[order], rho[order], ptype[order].astype(np.int64)])
            np.savetxt(f, cols, delimiter=s,
                       fmt=["%d"] + ["%.7g"] * 7 + ["%d"])

    def drain_partout(self, sim, h):
        """Stream newly excluded particles to PartOut .obi4 (the solver
        marks them SPECIAL_OUT_* in place; the reference compacts and
        streams them per divide)."""
        special = td.code_special(h.code)
        # OUT_IGNORE marks spare slots, not excluded particles
        out = (special >= td.SPECIAL_OUT_POS) & \
            (special < td.SPECIAL_OUT_IGNORE)
        if not out.any():
            return
        idp = h.idp
        new = [k for k in np.where(out)[0] if idp[k] not in self._out_seen]
        if not new:
            return
        # id order, so the stream does not depend on the slot order
        new = np.asarray(new)
        new = new[np.argsort(idp[new], kind="stable")]
        self._out_seen.update(idp[new].tolist())
        motive = np.where(
            special[new] == td.SPECIAL_OUT_RHOP, floatdata.MOTIVE_RHOP,
            np.where(special[new] == td.SPECIAL_OUT_MOVE,
                     floatdata.MOTIVE_MOVE,
                     floatdata.MOTIVE_POS)).astype(np.uint8)
        self.outw.save_part(
            sim.part, sim.time, idp=idp[new], pos=h.pos[new],
            vel=h.vel[new], rhop=h.rho[new], motive=motive)

    def write_info(self, sim, h):
        """Per-PART runtime info (the `-sv:info` channel, `StInfoPartPlus`
        `JSphCpuSingle.cpp:1151-1165`, as CSV): particle breakdown, step
        counters, dt diagnostics."""
        c = type_counts(h.code)
        path = os.path.join(self.dirout, "PartInfo.csv")
        newfile = not os.path.exists(path)
        with open(path, "a") as f:
            if newfile:
                f.write("Part;TimeStep;Nstep;Np;NpFixed;NpMoving;NpFloat;"
                        "NpFluid;NpOut;DtModif;Overflow\n")
            f.write(
                f"{sim.part};{sim.time:.6f};{sim.carry.nstep};"
                f"{c['np_total']};{c['nfixed']};{c['nmoving']};"
                f"{c['nfloat']};{c['nfluid']};{len(h.code) - c['np_total']};"
                f"{int(sim.carry.dtmodif)};{int(sim.carry.overflow)}\n")

    _savedt_last = 0
    _ftmot_last = 0
    _ftmot_tnext = 0.0
    # the record's own cadence (<parameter key="FtSaveMotion">, tout2 of
    # JFtMotionSave); 0 = every recorded step
    ftmotion_tout = 0.0

    def drain_ftmotion(self, sim, h):
        """Append the per-dt floating motion ring to PartFloatMotion.fbi4
        (JFtMotionSave's dt-level record, `JSphCpuSingle.cpp:1000-1003`):
        the rows recorded since the last save, one per ``ftmotion_tout``
        of simulated time when that is set."""
        if self.feats is None or self.feats.floating is None:
            return
        if self.ftmotw is None:
            self.ftmotw = self._float_writer("PartFloatMotion.fbi4")
        hist = h.get(sim.carry.fthist)
        cap, b = hist.shape[0], self.feats.floating.count
        cur = sim.carry.nstep
        for s in range(max(self._ftmot_last, cur - cap), cur):
            r = hist[s % cap]
            t = float(r[0])
            if self.ftmotion_tout:
                if t < self._ftmot_tnext:
                    continue
                while self._ftmot_tnext <= t:
                    self._ftmot_tnext += self.ftmotion_tout
            self.ftmotw.save_part(
                s, t, step=s,
                center=r[1:1 + 3 * b].reshape(b, 3),
                fvel=r[1 + 3 * b:1 + 6 * b].reshape(b, 3),
                fomega=r[1 + 6 * b:1 + 9 * b].reshape(b, 3), flush=False)
        self.ftmotw._flush()
        self._ftmot_last = cur

    def save_moorings(self, sim, h):
        """Per-PART mooring output (the reference's savevtk_lines and
        savecsv_points, `_FmtXML_MoorDyn.xml`; JAX ``save_moorings``): the
        line nodes as polylines in MooringsVtk/MooringsLines_XXXX.vtk and
        one MooringsPoints.csv row per line with its fairlead node's
        position, velocity and tension."""
        moor = sim.carry.moor
        cfg = self.feats.moorings if self.feats is not None else None
        if moor is None or cfg is None:
            return
        P = h.get(moor.pos)                    # (L, NM+1, 3)
        V = h.get(moor.vel)
        brk = h.get(moor.broken)
        tens = h.get(cfg.fairlead_tensions(moor))
        nseg = [ln.nseg for ln in cfg.lines]
        mdir = os.path.join(self.dirout, "MooringsVtk")
        os.makedirs(mdir, exist_ok=True)
        pts, lines = [], []
        off = 0
        for k, ns in enumerate(nseg):
            pts.append(P[k, :ns + 1])
            lines.append(np.arange(off, off + ns + 1))
            off += ns + 1
        vtkout.write_vtk_mesh(
            os.path.join(mdir, f"MooringsLines_{sim.part:04d}.vtk"),
            np.concatenate(pts, axis=0), lines=lines)
        path = os.path.join(self.dirout, "MooringsPoints.csv")
        newfile = not os.path.exists(path)
        with open(path, "a") as f:
            if newfile:
                f.write("time;line;broken;posx;posy;posz;velx;vely;velz;"
                        "tenx;teny;tenz;tension\n")
            for k, ns in enumerate(nseg):
                p, v, tv = P[k, ns], V[k, ns], tens[k]
                f.write(f"{sim.time:.6f};{k};{int(brk[k])};"
                        f"{p[0]:.6g};{p[1]:.6g};{p[2]:.6g};"
                        f"{v[0]:.6g};{v[1]:.6g};{v[2]:.6g};"
                        f"{tv[0]:.6g};{tv[1]:.6g};{tv[2]:.6g};"
                        f"{np.linalg.norm(tv):.6g}\n")

    def drain_savedt(self, sim, h):
        """Append the per-dt diagnostics recorded since the last save to
        SaveDt.csv (reference JDsSaveDt output, `_FmtXML_SaveDt.xml`)."""
        hist = h.get(sim.carry.dthist)
        cap = hist.shape[0]
        cur = sim.carry.nstep
        lo = max(self._savedt_last, cur - cap)
        path = os.path.join(self.dirout, "SaveDt.csv")
        newfile = not os.path.exists(path)
        with open(path, "a") as f:
            if newfile:
                f.write("Step;Time;Dt;Dt1;Dt2;AceMax;ViscDtMax\n")
            for s in range(lo, cur):
                r = hist[s % cap]
                f.write(f"{s};{r[0]:.7e};{r[1]:.7e};{r[2]:.7e};"
                        f"{r[3]:.7e};{r[4]:.7e};{r[5]:.7e}\n")
        self._savedt_last = cur


def _body_angles(a, b, planar):
    """Accumulated rotation angles (``FloatingState.angles``) of a body
    whose particle offsets from its centre went from ``a`` (t = 0) to
    ``b``: the least-squares rotation Q with b = Q a (Kabsch), as the
    angles whose ``floating._euler_rot`` (Rz Ry Rx) is Q.  A ``planar`` (2D)
    body turns about y alone, and its angle is exact modulo 2 pi; in 3D
    these are the Euler angles of the body's orientation."""
    u, _s, vt = np.linalg.svd(b.T @ a)
    d = np.sign(np.linalg.det(u @ vt)) or 1.0
    q = u @ np.diag([1.0, 1.0, d]) @ vt
    if planar:
        return np.array([0.0, math.atan2(q[0, 2], q[0, 0]), 0.0])
    return np.array([math.atan2(q[2, 1], q[2, 2]),
                     math.atan2(-q[2, 0], math.hypot(q[0, 0], q[1, 0])),
                     math.atan2(q[1, 0], q[0, 0])])


def _restart_floating(path, cpart, template_state, pos, idp, code):
    """The floating bodies' state at PART ``cpart``: ``center``, ``fvel``
    and ``fomega`` from that row of the PartFloat.fbi4 beside the PART
    (the reference's `-partbegin` restores them from it, SURVEY §5.4), and
    ``angles``, which the file does not hold, from the bodies' particles
    (``_body_angles``).  A missing file or row is an error naming it."""
    fpath = os.path.join(os.path.dirname(path) or ".", "PartFloat.fbi4")
    if not os.path.exists(fpath):
        raise FileNotFoundError(
            f"restart of a case with floating bodies needs {fpath} (the "
            f"bodies' state at PART {cpart})")
    _head, rows = floatdata.read_floatbi4(fpath)
    row = next((r for r in rows if r["cpart"] == cpart), None)
    if row is None:
        raise ValueError(f"{fpath} holds no row for PART {cpart} (Cpart "
                         f"{[r['cpart'] for r in rows]})")
    ft0 = template_state.ft
    nb = ft0.center.shape[0]
    if len(row["center"]) != nb:
        raise ValueError(f"{fpath} holds {len(row['center'])} bodies, the "
                         f"case {nb}")
    # the template's positions by id: the bodies' t = 0 lattice
    tid = host(template_state.idp)
    tpos = host(template_state.pos).astype(np.float64)
    pos0 = np.zeros((int(tid.max()) + 1, 3))
    pos0[tid] = tpos
    planar = bool(np.ptp(tpos[:, 1]) == 0.0)
    center0 = host(ft0.center).astype(np.float64)
    center = np.asarray(row["center"], np.float64)
    isft = td.code_type(code) == td.TYPE_FLOATING
    angles = np.zeros((nb, 3))
    for b in range(nb):
        k = np.where(isft & (td.code_value(code) == b))[0]
        if len(k) >= 2:
            angles[b] = _body_angles(pos0[idp[k]] - center0[b],
                                     pos[k] - center[b], planar)
    dev = ft0.center.device

    def dev32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return dataclasses.replace(
        ft0, center=dev32(center), fvel=dev32(row["fvel"]),
        fomega=dev32(row["fomega"]), angles=dev32(angles))


def restart_state(path, template_state):
    """Rebuild a SimState from a PART file (the `-partbegin` contract,
    JPartsLoad4::LoadParticles + JSph::InitRun) on the template's device.
    The template provides the capacity and the optional fields; particles
    take slots in the file's id order and spare slots are OUT_IGNORE.
    Where the template carries them, the Verlet M1 state starts from the
    PART's velocity and density (InitRun copies Velrhop into VelrhopM1),
    and the floating bodies' state from ``_restart_floating`` (the JAX
    package keeps the template's M1 and body state, that is t = 0's).  The
    other optional fields stay as the template has them.  The PART holds
    no Kahan residual, so ``pose`` restarts at zero.  Returns (state,
    timestep, nstep)."""
    d = partdata.read_part(path)
    cap = template_state.n
    npok = len(d["idp"])
    if npok > cap:
        raise ValueError(f"restart needs {npok} slots, capacity is {cap}")
    dev = template_state.pos.device
    pos = np.full((cap, 3), -1e6, np.float64)
    pos[:npok] = d["pos"]
    vel = np.zeros((cap, 3), np.float32)
    vel[:npok] = d["vel"]
    rho = np.full((cap,), 1000.0, np.float32)
    rho[:npok] = d["rhop"]
    idp = np.arange(cap, dtype=np.int64)
    idp[:npok] = d["idp"]
    code = np.full((cap,), td.code_make(td.TYPE_FLUID, 0,
                                        td.SPECIAL_OUT_IGNORE), np.int32)
    if d["code"] is not None:
        code[:npok] = d["code"]
    else:
        # reconstruct typecodes from the id layout (GenCase convention)
        c = d["counts"]
        ids = d["idp"]
        nfx, nmv, nft = c["CaseNfixed"], c["CaseNmoving"], c["CaseNfloat"]
        code[:npok] = np.select(
            [ids < nfx, ids < nfx + nmv, ids < nfx + nmv + nft],
            [td.code_make(td.TYPE_FIXED, 0), td.code_make(td.TYPE_MOVING, 0),
             td.code_make(td.TYPE_FLOATING, 0)],
            td.code_make(td.TYPE_FLUID, 0))

    def dev32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    st = dataclasses.replace(
        template_state, pos=dev32(pos), vel=dev32(vel), rho=dev32(rho),
        idp=torch.tensor(idp, device=dev),
        code=torch.tensor(code, device=dev),
        pose=torch.zeros((cap, 3), dtype=torch.float32, device=dev))
    if template_state.velm1 is not None:
        st = dataclasses.replace(st, velm1=dev32(vel), rhom1=dev32(rho))
    m = re.search(r"Part_?(\d+)\.bi4$", os.path.basename(path))
    cpart = int(m.group(1)) if m is not None else d["cpart"]
    if template_state.ft is not None:
        st = dataclasses.replace(st, ft=_restart_floating(
            path, cpart, template_state, pos, idp, code))
    # mDBC normals from the PartExtra channel (JDsExtraDataLoad::LoadNormals;
    # without it an mDBC restart would run with zero normals)
    if m is not None:
        extra = extradata.load_extradata(os.path.dirname(path) or ".",
                                         int(m.group(1)))
        if extra is not None:
            nor = extradata.apply_normals(extra, idp, code, cap)
            st = dataclasses.replace(st, boundnormal=dev32(nor))
    return st, d["timestep"], d["nstep"]
