"""Rigid-body constraints: the Project-Chrono coupling's replacement.

Counterpart of `dualsphysics_multilayer_tpu/features/chrono.py` (reference
`JChronoObjects` and the closed `libdsphchrono.so`,
`JSphCpuSingle.cpp:930-945`; XML `_FmtXML_Chrono.xml`): the constrained
Newton-Euler system of the floating bodies

    [ M  -J^T ] [qacc]   [ F        ]
    [ J    0  ] [lam ] = [ rhs_stab ]

with M = blockdiag(m_i I3, I_i(world)), J the links' Jacobians at
acceleration level and Baumgarte terms tied to dt, solved on the device
in each rigid update (``torch.linalg.solve_ex``: no read of the solver's
status to the host).  B bodies and m constraint rows give one dense
(6B+m)^2 system, written row by row into one tensor per call.

The links (JChLink::TpLink): spheric (ball joint), hinge (with torsional
stiffness and damping about its axis), pointline (sliding along an axis),
linearspring and coulombdamping (explicit forces, :func:`spring_forces`),
and pulley (r1 w1.a = r2 w2.a about the shared axis).  ``b2 = -1`` is the
ground.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .devconst import vec


@dataclass(frozen=True)
class ChLink:
    """One link (JChLink and its subclasses), its geometry in world
    coordinates of the initial configuration, as the XML gives it."""
    # hinge|spheric|pointline|spring|coulomb|pulley
    type: str
    b1: int
    b2: int = -1                   # -1 = ground
    rotpoint: tuple = (0.0, 0.0, 0.0)
    rotvector: tuple = (0.0, 0.0, 1.0)
    slidevector: tuple = (0.0, 0.0, 1.0)
    pt1: tuple = (0.0, 0.0, 0.0)   # spring end on body1 (world at t0)
    pt2: tuple = (0.0, 0.0, 0.0)   # spring end on body2 or the ground
    stiffness: float = 0.0
    damping: float = 0.0
    restlength: float = 0.0
    coulomb: float = 0.0
    radius: float = 0.0            # pulley radius on body1
    radius2: float = 0.0           # pulley radius on body2


@dataclass(frozen=True)
class ChronoCfg:
    """The links and their body-local anchors: ``local1[i]`` is link i's
    anchor less body b1's initial center, ``local2[i]`` the same for b2 or
    the world anchor of a ground link."""
    links: tuple
    local1: tuple = ()
    local2: tuple = ()

    @property
    def njoint_rows(self):
        return sum(_LINK_ROWS[ln.type] for ln in self.links)


_LINK_ROWS = {"spheric": 3, "hinge": 5, "pointline": 2,
              "spring": 0, "coulomb": 0, "pulley": 1}
_POINT_LINKS = ("spheric", "hinge", "pointline")


def make_chrono(links, centers0) -> ChronoCfg:
    """The body-local anchors of ``links`` from the bodies' initial
    centers ``centers0`` (B,3)."""
    centers0 = np.asarray(centers0, np.float64)
    loc1, loc2 = [], []
    for ln in links:
        a1 = np.asarray(ln.rotpoint if ln.type in _POINT_LINKS else ln.pt1,
                        np.float64)
        a2 = np.asarray(ln.rotpoint if ln.type in _POINT_LINKS else ln.pt2,
                        np.float64)
        loc1.append(tuple(a1 - centers0[ln.b1]))
        loc2.append(tuple(a2 - centers0[ln.b2]) if ln.b2 >= 0 else tuple(a2))
    return ChronoCfg(links=tuple(links), local1=tuple(loc1),
                     local2=tuple(loc2))


def _basis_perp(n):
    """Two unit vectors orthogonal to n (host, float64)."""
    n = np.asarray(n, np.float64)
    n = n / max(np.linalg.norm(n), 1e-30)
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else \
        np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= max(np.linalg.norm(u), 1e-30)
    return u, np.cross(n, u)


def _unit(v):
    a = np.asarray(v, np.float64)
    return a / max(np.linalg.norm(a), 1e-30)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _skew(v):
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def spring_forces(cfg: ChronoCfg, R, center, fvel, fomega):
    """(face, torque), (B,3) each: the explicit links, linearspring and
    coulombdamping (JChLinkLinearSpring: F = -k(|d| - L0) d^ - c (vrel.d^)
    d^; coulombdamping a constant force against the relative motion)."""
    face = torch.zeros_like(center)
    tq = torch.zeros_like(center)
    for i, ln in enumerate(cfg.links):
        if ln.type not in ("spring", "coulomb"):
            continue
        r1 = R[ln.b1] @ vec(cfg.local1[i], center)
        p1 = center[ln.b1] + r1
        v1 = fvel[ln.b1] + _cross(fomega[ln.b1], r1)
        if ln.b2 >= 0:
            r2 = R[ln.b2] @ vec(cfg.local2[i], center)
            p2 = center[ln.b2] + r2
            v2 = fvel[ln.b2] + _cross(fomega[ln.b2], r2)
        else:
            p2 = vec(cfg.local2[i], center)
            v2 = torch.zeros(3, dtype=center.dtype, device=center.device)
        d = p1 - p2
        dist = torch.sqrt((d * d).sum() + 1e-30)
        dhat = d / dist
        vrel = ((v1 - v2) * dhat).sum()
        fmag = -ln.stiffness * (dist - ln.restlength) - ln.damping * vrel
        if ln.type == "coulomb" and ln.coulomb:
            fmag = fmag - ln.coulomb * torch.sign(vrel)
        f = fmag * dhat
        face[ln.b1] = face[ln.b1] + f
        tq[ln.b1] = tq[ln.b1] + _cross(r1, f)
        if ln.b2 >= 0:
            face[ln.b2] = face[ln.b2] - f
            tq[ln.b2] = tq[ln.b2] + _cross(r2, -f)
    return face, tq


def solve_constrained(cfg: ChronoCfg, mass, inert, R, center, fvel, fomega,
                      face_sum, tq_sum, dt):
    """Per-body (linear acceleration, angular acceleration), (B,3) each,
    from the KKT system.  ``face_sum``/``tq_sum``: each body's world force
    and torque (SPH, gravity, springs, external); the Baumgarte gains
    follow dt: Cdd = -2/(5 dt) Cd - 1/(5 dt)^2 C."""
    B = mass.shape[0]
    f32, dev = face_sum.dtype, face_sum.device
    m = cfg.njoint_rows
    nv = 6 * B
    K = torch.zeros((nv + m, nv + m), dtype=f32, device=dev)
    b = torch.zeros(nv + m, dtype=f32, device=dev)
    eye = torch.eye(3, dtype=f32, device=dev)
    for k in range(B):
        K[6 * k:6 * k + 3, 6 * k:6 * k + 3] = eye * mass[k]
        K[6 * k + 3:6 * k + 6, 6 * k + 3:6 * k + 6] = inert[k]
        b[6 * k:6 * k + 3] = face_sum[k]
        b[6 * k + 3:6 * k + 6] = tq_sum[k]
    if m == 0:
        acc = torch.linalg.solve_ex(K, b)[0].reshape(B, 6)
        return acc[:, :3], acc[:, 3:]
    J = K[nv:, :nv]          # the constraint rows, written in place
    rhs = b[nv:]
    gdt = 5.0 * dt
    kd = 2.0 / gdt
    kp = 1.0 / (gdt * gdt)
    row = 0

    def point_rows(b1, b2, loc1, loc2):
        """(J (3,nv), rhs (3,)): the world acceleration of the anchor on
        b1 equals that of the anchor on b2 (or the ground)."""
        r1 = R[b1] @ vec(loc1, center)
        Jp = torch.zeros((3, nv), dtype=f32, device=dev)
        Jp[:, 6 * b1:6 * b1 + 3] = eye
        Jp[:, 6 * b1 + 3:6 * b1 + 6] = -_skew(r1)
        p1 = center[b1] + r1
        v1 = fvel[b1] + _cross(fomega[b1], r1)
        cent = _cross(fomega[b1], _cross(fomega[b1], r1))
        if b2 >= 0:
            r2 = R[b2] @ vec(loc2, center)
            Jp[:, 6 * b2:6 * b2 + 3] += -eye
            Jp[:, 6 * b2 + 3:6 * b2 + 6] += _skew(r2)
            p2 = center[b2] + r2
            v2 = fvel[b2] + _cross(fomega[b2], r2)
            cent = cent - _cross(fomega[b2], _cross(fomega[b2], r2))
        else:
            p2 = vec(loc2, center)
            v2 = torch.zeros(3, dtype=f32, device=dev)
        return Jp, -cent - kd * (v1 - v2) - kp * (p1 - p2)

    for i, ln in enumerate(cfg.links):
        if ln.type in ("spring", "coulomb"):
            continue
        if ln.type in ("spheric", "hinge"):
            J[row:row + 3], rhs[row:row + 3] = point_rows(
                ln.b1, ln.b2, cfg.local1[i], cfg.local2[i])
            row += 3
        if ln.type == "hinge":
            # the axis of b1 stays aligned with b2's (or the world's): w.n1
            # = 0 for w = u, v spanning the plane normal to the axis
            n1 = R[ln.b1] @ vec(_unit(ln.rotvector), center)
            om1 = fomega[ln.b1]
            for w0 in _basis_perp(ln.rotvector):
                w = (R[ln.b2] @ vec(w0, center) if ln.b2 >= 0
                     else vec(w0, center))
                J[row, 6 * ln.b1 + 3:6 * ln.b1 + 6] = _cross(n1, w)
                Cd = (w * _cross(om1, n1)).sum()
                cent = (w * _cross(om1, _cross(om1, n1))).sum()
                if ln.b2 >= 0:
                    om2 = fomega[ln.b2]
                    J[row, 6 * ln.b2 + 3:6 * ln.b2 + 6] = _cross(w, n1)
                    Cd = Cd + (n1 * _cross(om2, w)).sum()
                    cent = (cent + (n1 * _cross(om2, _cross(om2, w))).sum()
                            + 2.0 * (_cross(om2, w) * _cross(om1, n1)).sum())
                rhs[row] = -cent - kd * Cd - kp * (w * n1).sum()
                row += 1
        elif ln.type == "pulley":
            # the belt: r1 (w1.a) - r2 (w2.a) constant, stabilised in
            # velocity only (a belt has no preferred phase)
            av = vec(_unit(ln.rotvector), center)
            J[row, 6 * ln.b1 + 3:6 * ln.b1 + 6] = ln.radius * av
            Cd = ln.radius * (fomega[ln.b1] * av).sum()
            if ln.b2 >= 0:
                J[row, 6 * ln.b2 + 3:6 * ln.b2 + 6] = -ln.radius2 * av
                Cd = Cd - ln.radius2 * (fomega[ln.b2] * av).sum()
            rhs[row] = -kd * Cd
            row += 1
        elif ln.type == "pointline":
            # b1's anchor stays on the line through rotpoint along
            # slidevector: the two rows across the axis
            J3, rhs3 = point_rows(ln.b1, ln.b2, cfg.local1[i], cfg.local2[i])
            for w0 in _basis_perp(ln.slidevector):
                w = vec(w0, center)
                J[row] = w @ J3
                rhs[row] = (w * rhs3).sum()
                row += 1
    K[:nv, nv:] = -J.T
    sol = torch.linalg.solve_ex(K, b)[0]
    acc = sol[:nv].reshape(B, 6)
    return acc[:, :3], acc[:, 3:]


def hinge_torsion(cfg: ChronoCfg, R, fomega, angles):
    """(B,3) torques of the hinges' torsional stiffness and damping
    (JChLinkHinge stiffness [Nm/rad], damping [Nms/rad]): -k theta - c
    thetad about the axis, theta the accumulated relative rotation."""
    tq = torch.zeros_like(fomega)
    for ln in cfg.links:
        if ln.type != "hinge" or (not ln.stiffness and not ln.damping):
            continue
        av = vec(_unit(ln.rotvector), fomega)
        th = (angles[ln.b1] * av).sum()
        w = (fomega[ln.b1] * av).sum()
        if ln.b2 >= 0:
            th = th - (angles[ln.b2] * av).sum()
            w = w - (fomega[ln.b2] * av).sum()
        t = (-ln.stiffness * th - ln.damping * w) * av
        tq[ln.b1] = tq[ln.b1] + t
        if ln.b2 >= 0:
            tq[ln.b2] = tq[ln.b2] - t
    return tq
