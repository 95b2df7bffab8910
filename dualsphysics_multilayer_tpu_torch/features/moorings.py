"""Force points and mooring lines for floating bodies.

Counterpart of `dualsphysics_multilayer_tpu/features/moorings.py`, the
JAX package's replacement for the reference's closed-library couplings
(`JDsFtForcePoints`, JSphCpuSingle.cpp:903-913; `JDsMooredFloatings` with
MoorDyn+, SURVEY §2.12).  Each gives per-body (force, torque) sums, the
``ext_face``/``ext_fomegaace`` of ``features.floating.run_floating``:

* ``MooringCfg``: quasi-static taut lines, T = k (l - L0)/L0 + c dl/dt
  along the line while it is longer than L0;
* ``ForcePointsCfg``: forces from a time table at body-fixed points;
* ``MoorDynCfg``: the lumped-mass MoorDyn+ model (Hall & Goupee 2015):
  N segments and N+1 nodes per line, internal nodes with mass and added
  mass under segment tension, internal damping, net weight, Morison drag
  and a seabed spring, damper and friction; the anchor and the fairlead
  kinematic.  Semi-implicit Euler over ``nsub`` substeps per SPH step;
  ``MoorState`` holds the nodes, padded to the widest line, in the step's
  carry (``StepCarry.moor``).

Everything runs as torch ops on the bodies' device with no read to the
host.  The line tables are device tensors made once per configuration and
device (the JAX package builds them at each trace).  The substep loop of
the JAX package's ``lax.scan`` is a Python loop over the same operations.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .devconst import vec


@functools.lru_cache(maxsize=None)
def _index(values: tuple, device):
    """``values`` as an int64 tensor on ``device``, made once."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def _rot(fts):
    from .floating import _euler_rot
    return _euler_rot(fts.angles)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _body_sums(nbodies, bodies, f, arm, like):
    """(B,3) force and torque sums of the rows of ``f`` (k,3) acting at
    the arms ``arm`` (k,3) on the bodies ``bodies`` (a tuple of k ints), in
    row order."""
    face = torch.zeros((nbodies, 3), dtype=like.dtype, device=like.device)
    fom = torch.zeros_like(face)
    tq = _cross(arm, f)
    for k, b in enumerate(bodies):
        face[b] = face[b] + f[k]
        fom[b] = fom[b] + tq[k]
    return face, fom


@dataclass(frozen=True)
class MooringLine:
    """One line: world anchor -> body-fixed fairlead on body ``body``."""
    body: int
    anchor: tuple          # world coordinates
    fairlead: tuple        # body-frame offset from the body center (at t=0)
    length0: float         # unstretched length
    stiffness: float       # axial stiffness (N per unit strain)
    damping: float = 0.0   # axial damping (N s/m)


@dataclass(frozen=True)
class MooringCfg:
    lines: tuple           # (MooringLine, ...)
    nbodies: int

    def forces(self, fts):
        """Line tensions -> per-body (force, torque) sums; ``fts`` is the
        FloatingState."""
        like = fts.center
        R = _rot(fts)
        bodies = tuple(ln.body for ln in self.lines)
        idx = _index(bodies, like.device)
        fair = vec([x for ln in self.lines for x in ln.fairlead],
                   like).reshape(-1, 3)
        anchor = vec([x for ln in self.lines for x in ln.anchor],
                     like).reshape(-1, 3)
        l0 = vec([ln.length0 for ln in self.lines], like)
        k = vec([ln.stiffness for ln in self.lines], like)
        c = vec([ln.damping for ln in self.lines], like)
        r = (R[idx] @ fair[..., None])[..., 0]                 # rotated arms
        p = fts.center[idx] + r
        v = fts.fvel[idx] + _cross(fts.fomega[idx], r)
        d = anchor - p                          # fairlead -> anchor
        length = torch.sqrt((d * d).sum(dim=-1) + 1e-12)
        u = d / length[:, None]
        strain = (length - l0) / l0
        lrate = -(v * u).sum(dim=-1)
        tension = torch.clamp(k * strain + c * lrate, min=0.0)
        f = ((strain > 0.0).to(like.dtype) * tension)[:, None] * u
        return _body_sums(self.nbodies, bodies, f, r, like)


@dataclass(frozen=True)
class ForcePoint:
    """Time-varying point force on a body (`JDsFtForcePoints`): the force
    interpolated linearly in a table, applied at a body-fixed point."""
    body: int
    point: tuple           # body-frame offset from the center
    times: tuple = (0.0,)
    forces: tuple = (0.0, 0.0, 0.0)   # (nt*3,) row-major

    def force_at(self, t, like):
        """The force (3,) at time ``t`` (a 0-d tensor on ``like``'s
        device)."""
        nt = len(self.times)
        vals = vec(self.forces, like).reshape(nt, 3)
        if nt == 1:
            return vals[0]
        times = vec(self.times, like)
        t = torch.clamp(torch.as_tensor(t, dtype=like.dtype,
                                        device=like.device).reshape(1),
                        times[0], times[-1])
        # a (1,) index: indexing with a 0-d tensor would read it to the host
        i = torch.clamp(torch.searchsorted(times, t, right=True) - 1, 0,
                        nt - 2)
        t0, t1 = times[i], times[i + 1]
        f = ((t - t0) / torch.clamp(t1 - t0, min=1e-12))[:, None]
        return (vals[i] * (1 - f) + vals[i + 1] * f)[0]


@dataclass(frozen=True)
class ForcePointsCfg:
    points: tuple
    nbodies: int

    def forces(self, fts, tabs):
        like = fts.center
        R = _rot(fts)
        bodies = tuple(fp.body for fp in self.points)
        idx = _index(bodies, like.device)
        pt = vec([x for fp in self.points for x in fp.point],
                 like).reshape(-1, 3)
        r = (R[idx] @ pt[..., None])[..., 0]
        f = torch.stack([fp.force_at(tabs, like) for fp in self.points])
        return _body_sums(self.nbodies, bodies, f, r, like)


# ---------------------------------------------------------------------------
# Dynamic lumped-mass mooring lines (MoorDyn+ model)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoorDynLine:
    """One dynamic line: anchor (world) -> fairlead (body-frame offset);
    the moordyn.xml line parameters (`_FmtXML_MoorDyn.xml`)."""
    body: int
    anchor: tuple
    fairlead: tuple        # body-frame offset from the body center (at t=0)
    length0: float         # unstretched length
    ea: float              # axial stiffness EA [N]
    nseg: int = 20         # <segments>
    diameter: float = 0.0  # volume-equivalent diameter [m]
    massden: float = 0.0   # mass per length in air [kg/m]
    ba: float = -0.8       # internal damping [N s]; negative = -zeta ratio
    can: float = 1.0       # transverse added-mass coefficient
    cat: float = 0.0       # tangential added-mass coefficient
    cdn: float = 1.6       # transverse drag coefficient
    cdt: float = 0.05      # tangential drag coefficient
    breaktension: float = 0.0   # max tension (0 = unused)
    zbot: float = 0.0      # seabed elevation (freesurface - waterDepth)


@dataclass
class MoorState:
    """Node kinematics of all lines, padded to the widest line."""
    pos: torch.Tensor      # (L, NMAX+1, 3) f32
    vel: torch.Tensor      # (L, NMAX+1, 3) f32
    broken: torch.Tensor   # (L,) bool: the line exceeded breaktension


@dataclass(frozen=True)
class _LineTables:
    l0seg: torch.Tensor    # (L,) each per line
    ea: torch.Tensor
    d: torch.Tensor
    w: torch.Tensor
    can: torch.Tensor
    cat: torch.Tensor
    cdn: torch.Tensor
    cdt: torch.Tensor
    zbot: torch.Tensor
    btens: torch.Tensor
    c: torch.Tensor
    nseg: torch.Tensor     # (L,) int64
    segmask: torch.Tensor  # (L, NM): segment j live iff j < nseg
    intmask: torch.Tensor  # (L, NM+1): node i internal iff 0 < i < nseg
    tailmask: torch.Tensor  # (L, NM+1, 1): node i >= nseg
    anchors: torch.Tensor  # (L, 3)
    fairlead: torch.Tensor  # (L, 3) body-frame offsets
    body: torch.Tensor     # (L,) int64


@dataclass(frozen=True)
class MoorDynCfg:
    """Dynamic mooring system (the MoorDyn+ coupling's replacement)."""
    lines: tuple           # (MoorDynLine, ...)
    nbodies: int
    rho_w: float = 1000.0  # water density
    g: float = 9.81
    kbot: float = 3.0e6    # bottom stiffness [Pa/m]
    cbot: float = 3.0e5    # bottom damping [Pa s/m]
    fric: float = 0.0      # bottom friction coefficient
    fricdamp: float = 200.0   # near-zero-speed friction damping
    nsub: int = 16         # line substeps per SPH step (static)
    start: float = 0.0     # <start value=...>
    ramptime: float = 0.0  # <start ramptime=...>
    cdscale_ic: float = 5.0   # drag scaling for the dynamic-relaxation IC
    t_ic: float = 1.0      # seconds of dynamic relaxation at init
    dtm: float = 1e-4      # substep of the IC relaxation

    dynamic = True         # the step keeps a MoorState in its carry

    def tables(self, device) -> _LineTables:
        return _line_tables(self, torch.device(device))

    def _fairlead_kin(self, fts):
        """World fairlead positions and velocities (L,3) from the bodies."""
        tb = self.tables(fts.center.device)
        R = _rot(fts)
        r = (R[tb.body] @ tb.fairlead[..., None])[..., 0]
        return (fts.center[tb.body] + r,
                fts.fvel[tb.body] + _cross(fts.fomega[tb.body], r))

    def _accel(self, tb: _LineTables, P, V, cdscale=1.0):
        """(A, tlast, tmax): node accelerations (zero on the kinematic end
        nodes), the tension vector (L,3) of the fairlead's segment on the
        fairlead, and each line's largest segment tension (L,)."""
        e = P[:, 1:, :] - P[:, :-1, :]                         # (L,NM,3)
        length = torch.sqrt((e * e).sum(dim=-1) + 1e-12)
        q = e / length[..., None]
        l0 = tb.l0seg[:, None]
        eps = (length - l0) / l0
        de = V[:, 1:, :] - V[:, :-1, :]
        epsdot = (de * q).sum(dim=-1) / l0
        tmag = (torch.clamp(tb.ea[:, None] * eps, min=0.0)
                + tb.c[:, None] * epsdot) * tb.segmask
        Tv = tmag[..., None] * q
        F = torch.zeros_like(P)
        F[:, 1:-1, :] = Tv[:, 1:, :] - Tv[:, :-1, :]
        th = torch.zeros_like(P)
        th[:, :-1, :] += q
        th[:, 1:, :] += q
        th = th / torch.sqrt((th * th).sum(dim=-1, keepdim=True) + 1e-12)
        area = math.pi / 4.0 * tb.d * tb.d                     # (L,)
        wnet = (tb.w - self.rho_w * area)[:, None] * self.g * l0
        F[:, :, 2] += -wnet * tb.intmask
        vt = (V * th).sum(dim=-1, keepdim=True) * th
        vn = V - vt
        vnm = torch.sqrt((vn * vn).sum(dim=-1, keepdim=True) + 1e-12)
        vtm = torch.sqrt((vt * vt).sum(dim=-1, keepdim=True) + 1e-12)
        dfac = 0.5 * self.rho_w * cdscale
        Fd = (-dfac * (tb.cdn * tb.d * tb.l0seg)[:, None, None] * vnm * vn
              - dfac * (tb.cdt * math.pi * tb.d * tb.l0seg)[:, None, None]
              * vtm * vt)
        F = F + Fd * tb.intmask[..., None]
        # seabed: a vertical spring-damper and friction per contact area
        pen = tb.zbot[:, None] - P[:, :, 2]
        below = (pen > 0.0).to(P.dtype) * tb.intmask
        ac = (tb.d * tb.l0seg)[:, None]
        fnorm = torch.clamp(self.kbot * ac * pen - self.cbot * ac * V[:, :, 2],
                            min=0.0) * below
        F[:, :, 2] += fnorm
        if self.fric > 0.0:
            vxy = V[:, :, :2]
            vxym = torch.sqrt((vxy * vxy).sum(dim=-1, keepdim=True) + 1e-12)
            fmag = torch.minimum(self.fric * fnorm[..., None],
                                 self.fricdamp * ac[..., None] * vxym)
            F[:, :, :2] += -fmag * vxy / vxym
        # the mass matrix's inverse: m I + an (I - tt) + at tt
        mn = (tb.w * tb.l0seg)[:, None]
        an = (self.rho_w * tb.can * area * tb.l0seg)[:, None]
        at = (self.rho_w * tb.cat * area * tb.l0seg)[:, None]
        Ft = (F * th).sum(dim=-1, keepdim=True) * th
        Fn = F - Ft
        acc = (Fn / torch.clamp(mn + an, min=1e-12)[..., None]
               + Ft / torch.clamp(mn + at, min=1e-12)[..., None])
        acc = acc * tb.intmask[..., None]
        li = torch.arange(len(self.lines), device=P.device)
        tlast = -Tv[li, tb.nseg - 1, :]
        return acc, tlast, tmag.amax(dim=1)

    def stable_dtm(self):
        """The substep bound of the JAX ``stable_dtm``: 0.25 l0seg
        sqrt(w/EA), half the lumped chain's optical-mode and internal-
        damping limits under semi-implicit Euler."""
        return max(min(0.25 * (ln.length0 / ln.nseg)
                       * math.sqrt(max(ln.massden, 1e-4)
                                   / max(ln.ea, 1e-12))
                       for ln in self.lines), 1e-7)

    def init_state(self, fts) -> MoorState:
        """Straight lines from anchor to fairlead, then the dynamic
        relaxation of the JAX ``init_state`` (solverOptions dtIC/cdScaleIC/
        tmaxIC): ``t_ic`` seconds at the stable substep (at most 200,000)
        with scaled drag and the fairleads held, velocities zeroed after.
        The relaxation runs once, at set-up, on the host's CPU, and its
        nodes go to the bodies' device: its thousands of substeps of ~90
        small operations each are launch-bound on a card (2 ms a substep
        on an H100, a third of that on the CPU; ``PERF.md``)."""
        device = fts.center.device
        host = type(fts)(**{k: v.detach().cpu()
                            for k, v in vars(fts).items()})
        st = self._relaxed(host)
        return MoorState(pos=st.pos.to(device), vel=st.vel.to(device),
                         broken=st.broken.to(device))

    def _relaxed(self, fts) -> MoorState:
        tb = self.tables(fts.center.device)
        NM = tb.segmask.shape[1]
        pf, _ = self._fairlead_kin(fts)
        frac = torch.linspace(0.0, 1.0, NM + 1, device=pf.device)[None, :,
                                                                   None]
        P = tb.anchors[:, None, :] * (1 - frac) + pf[:, None, :] * frac
        st = MoorState(pos=P, vel=torch.zeros_like(P),
                       broken=torch.zeros(len(self.lines), dtype=torch.bool,
                                          device=P.device))
        dtm = min(self.dtm, self.stable_dtm())
        nic = int(max(1, min(self.t_ic / dtm, 200000)))
        st = self._advance_raw(st, pf, torch.zeros_like(pf),
                               np.float32(dtm * nic), nic,
                               cdscale=self.cdscale_ic)
        return MoorState(pos=st.pos, vel=torch.zeros_like(st.vel),
                         broken=st.broken)

    def _advance_raw(self, mstate, pf_end, vf, dt, nsub, cdscale=1.0):
        """Semi-implicit Euler over ``nsub`` substeps with the fairlead
        gliding at ``vf`` to ``pf_end`` (MoorDyn's constant-velocity
        coupling); the substep is clamped to :meth:`stable_dtm`, so an
        oversized dt integrates a shorter, stable window."""
        tb = self.tables(pf_end.device)
        f32 = pf_end.dtype
        h = torch.clamp(torch.as_tensor(dt, dtype=f32, device=pf_end.device)
                        / nsub, max=np.float32(self.stable_dtm()))
        T = h * nsub

        def set_bc(P, V, k):
            # the anchor at node 0; the fairlead at node nseg and the
            # padded tail after it
            pfk = pf_end - vf * (T - k * h)
            P = P.clone()
            V = V.clone()
            P[:, 0, :] = tb.anchors
            V[:, 0, :] = 0.0
            P = torch.where(tb.tailmask, pfk[:, None, :], P)
            V = torch.where(tb.tailmask, vf[:, None, :], V)
            return P, V

        P, V, brk = mstate.pos, mstate.vel, mstate.broken
        for k in range(nsub):
            P, V = set_bc(P, V, float(k))
            acc, _, tmax = self._accel(tb, P, V, cdscale)
            V = V + h * acc
            P = P + h * V
            brk = brk | ((tb.btens > 0) & (tmax > tb.btens))
        P, V = set_bc(P, V, float(nsub))
        return MoorState(pos=P, vel=V, broken=brk)

    def advance(self, mstate, fts, dt, tabs=None) -> MoorState:
        """The lines over one SPH step to the bodies' state ``fts`` (the
        coupling instant of MoorDyn_FairleadsCalc)."""
        pf, vf = self._fairlead_kin(fts)
        return self._advance_raw(mstate, pf, vf, dt, self.nsub)

    def fairlead_tensions(self, mstate):
        """Per-line tension vector (L,3) on the fairlead, zero for a broken
        line (MoorDyn+'s savedata tension)."""
        tb = self.tables(mstate.pos.device)
        _, tlast, _ = self._accel(tb, mstate.pos, mstate.vel)
        return tlast * (~mstate.broken)[:, None].to(tlast.dtype)

    def forces(self, fts, mstate, tabs=None):
        """Fairlead tensions -> per-body (force, torque), with the
        ``<start>`` ramp (JDsMooredFloatings start/ramptime)."""
        tlast = self.fairlead_tensions(mstate)
        if tabs is not None and (self.start > 0 or self.ramptime > 0):
            tabs = torch.as_tensor(tabs, dtype=tlast.dtype,
                                   device=tlast.device)
            if self.ramptime > 0:
                ramp = torch.clamp((tabs - self.start)
                                   / max(self.ramptime, 1e-9), 0.0, 1.0)
            else:
                ramp = (tabs >= self.start).to(tlast.dtype)
            tlast = tlast * ramp
        tb = self.tables(tlast.device)
        R = _rot(fts)
        r = (R[tb.body] @ tb.fairlead[..., None])[..., 0]
        return _body_sums(self.nbodies, tuple(ln.body for ln in self.lines),
                          tlast, r, tlast)


@functools.lru_cache(maxsize=16)
def _line_tables(cfg: MoorDynCfg, device) -> _LineTables:
    """``cfg``'s padded line tables as device tensors, made once."""
    lines = cfg.lines
    NM = max(ln.nseg for ln in lines)

    def arr(fn, dtype=torch.float32):
        return torch.tensor(np.asarray([fn(ln) for ln in lines], np.float32)
                            if dtype == torch.float32 else
                            [fn(ln) for ln in lines], dtype=dtype,
                            device=device)

    def damping(ln):
        # MoorDyn's BA < 0: -zeta, c = zeta l0seg sqrt(EA w)
        if ln.ba >= 0:
            return ln.ba
        w = max(ln.massden, 1e-4)
        return -ln.ba * (ln.length0 / ln.nseg) * math.sqrt(ln.ea * w)

    j = np.arange(NM)
    i = np.arange(NM + 1)
    f32 = dict(dtype=torch.float32, device=device)
    return _LineTables(
        l0seg=arr(lambda ln: ln.length0 / ln.nseg), ea=arr(lambda ln: ln.ea),
        d=arr(lambda ln: ln.diameter),
        # a mass floor keeps an unset massDenInAir integrable
        w=arr(lambda ln: max(ln.massden, 1e-4)), can=arr(lambda ln: ln.can),
        cat=arr(lambda ln: ln.cat), cdn=arr(lambda ln: ln.cdn),
        cdt=arr(lambda ln: ln.cdt), zbot=arr(lambda ln: ln.zbot),
        btens=arr(lambda ln: ln.breaktension), c=arr(damping),
        nseg=arr(lambda ln: ln.nseg, torch.int64),
        segmask=torch.tensor(np.asarray([j < ln.nseg for ln in lines],
                                        np.float32), **f32),
        intmask=torch.tensor(np.asarray([(i > 0) & (i < ln.nseg)
                                         for ln in lines], np.float32), **f32),
        tailmask=torch.tensor(np.asarray([i >= ln.nseg for ln in lines]),
                              device=device)[..., None],
        anchors=torch.tensor(np.asarray([ln.anchor for ln in lines],
                                        np.float32), **f32),
        fairlead=torch.tensor(np.asarray([ln.fairlead for ln in lines],
                                         np.float32), **f32),
        body=arr(lambda ln: ln.body, torch.int64))
