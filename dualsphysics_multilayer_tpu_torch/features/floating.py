"""Floating rigid bodies: the 6-DOF solve from the SPH particle forces.

Counterpart of `dualsphysics_multilayer_tpu/features/floating.py`
(reference `JSphCpuSingle::RunFloating`, JSphCpuSingle.cpp:897-1016), in
the same order of operations:

* per-body force and torque: the sums of the particle forces
  ace*massp and of their moments about the body's center
  (`FtCalcForcesSum`); the typecode's value is the body index;
* angular acceleration I^-1 * torque with the initial inertia tensor
  rotated to the current orientation, I = R I0 R^T (`FtCalcForces`);
* semi-implicit update: center += fvel*dt with the old fvel, then fvel +=
  face*dt, fomega += omegaace*dt (`FtCalcForcesRes`), with the 2D
  component zeroing, the DOF constraints (`FtApplyConstraints`) and the
  FtPause freeze;
* particle update: the ballistic position pos += dt*vel, then the rigid
  velocity vel = fvel + fomega x (pos - center);
* the body state commits on the corrector only (``predictor=False``).

The moorings, force points and the Chrono couplings attach here as in
JAX: external forces join the sums, mesh contact joins them too, and
Chrono's links replace the per-body solve with the constrained one
(``features/chrono.py``).

The sums are masked reductions over a (bodies, particles) membership, not
``index_add_``: a CUDA scatter-add is atomic and its order changes from run
to run, and two runs from one state must give the same bodies bit for bit.
They hold B x n x 3 floats, small for the few bodies a case has.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph


@dataclass(frozen=True)
class FloatingCfg:
    """Static per-body constants (reference StFloatingData, DualSphDef.h:
    227-243), tuples of length B; the JAX ``FloatingCfg``'s fields."""
    count: int
    mass: tuple           # (B,) total mass
    massp: tuple          # (B,) mass of one of its particles
    inertia0: tuple       # (B*9,) initial inertia tensors, row-major
    ftpause: float = 0.0
    translation_dof: tuple = ()   # (B*3,) 1/0; empty = all free
    rotation_dof: tuple = ()
    mkbound: tuple = ()           # (B,) source mkbound per body
    # (B*3,) scaling of the SPH force on each body; empty = 1
    scaleforce: tuple = ()


@dataclass
class FloatingState:
    """Dynamic body state (reference StFloatingData dynamics)."""
    center: torch.Tensor     # (B,3)
    fvel: torch.Tensor       # (B,3)
    fomega: torch.Tensor     # (B,3)
    angles: torch.Tensor     # (B,3) accumulated rotation (rad)


@dataclass(frozen=True)
class _Tables:
    massp: torch.Tensor      # (B,)
    mass: torch.Tensor       # (B,)
    inertia0: torch.Tensor   # (B,3,3)
    gravity: torch.Tensor    # (3,)
    scaleforce: torch.Tensor | None     # (B,3)
    translation_dof: torch.Tensor | None
    rotation_dof: torch.Tensor | None


@functools.lru_cache(maxsize=16)
def body_tables(cfg: FloatingCfg, gravity: tuple, device) -> _Tables:
    """``cfg``'s constants as f32 tensors on ``device``, made once (a copy
    to the card waits for the stream)."""
    B = cfg.count

    def t(v, shape):
        return (torch.tensor(v, dtype=torch.float32, device=device)
                .reshape(shape) if v else None)

    return _Tables(massp=t(cfg.massp, (B,)), mass=t(cfg.mass, (B,)),
                   inertia0=t(cfg.inertia0, (B, 3, 3)),
                   gravity=t(gravity, (3,)),
                   scaleforce=t(cfg.scaleforce, (B, 3)),
                   translation_dof=t(cfg.translation_dof, (B, 3)),
                   rotation_dof=t(cfg.rotation_dof, (B, 3)))


def _euler_rot(ang):
    """Rotation matrix from accumulated XYZ rotation angles, Rz Ry Rx."""
    cx, sx = torch.cos(ang[..., 0]), torch.sin(ang[..., 0])
    cy, sy = torch.cos(ang[..., 1]), torch.sin(ang[..., 1])
    cz, sz = torch.cos(ang[..., 2]), torch.sin(ang[..., 2])
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat([(one, zero, zero), (zero, cx, -sx), (zero, sx, cx)])
    ry = mat([(cy, zero, sy), (zero, one, zero), (-sy, zero, cy)])
    rz = mat([(cz, -sz, zero), (sz, cz, zero), (zero, zero, one)])
    return rz @ ry @ rx


def _body_sum(member, x):
    """(B, k) sums of the rows of x (n, k) over each body's members."""
    return torch.where(member[..., None], x[None], 0.0).sum(dim=1)


def run_floating(cfg: FloatingCfg, csp: CteSph, fts: FloatingState, t, dt,
                 predictor: bool, pos, vel, code, ace, ext_face=None,
                 ext_fomegaace=None, chrono=None, chcontact=None,
                 reduce_sum=None):
    """One floating update at time ``t`` over ``dt``.  Returns (pos, vel,
    new_state).  ``ext_face``/``ext_fomegaace`` (B,3): external forces and
    torques (moorings, force points) added to the sums.  ``chcontact``: a
    ``features.chcollision.ChContactCfg``, whose mesh-contact forces join
    the sums (its dt term is dropped, as in JAX).  ``chrono``: a
    ``features.chrono.ChronoCfg``, whose springs and hinge torsion join the
    sums and whose constrained solve replaces the per-body one (the
    attachment point of libdsphchrono, JSphCpuSingle.cpp:930-945).
    ``reduce_sum``: under a domain decomposition, the sum over the ranks of
    a tensor (JAX's ``psum_axis``): the particle sums of each rank's owned
    rows are added over the ranks in one collective, after which the body
    solve and its couplings run replicated on every rank; None on one
    device."""
    B = cfg.count
    tb = body_tables(cfg, tuple(csp.gravity), vel.device)
    floating = td.is_floating(code) & td.is_active(code)
    bidx = torch.where(floating, td.code_value(code), B).long()
    body = torch.clamp(bidx, max=B - 1)

    # ---- force and torque sums (FtCalcForcesSum); periodic ghost copies
    # never contribute
    summing = floating & (td.code_special(code) != td.SPECIAL_PERIODIC)
    member = summing[None, :] & (
        bidx[None, :] == torch.arange(B, device=vel.device)[:, None])
    mp = torch.where(summing, tb.massp[body], 0.0)
    force = ace * mp[:, None]
    if tb.scaleforce is not None:
        force = force * tb.scaleforce[body]
    face_sum = _body_sum(member, force)
    dist = pos - fts.center[body]
    fomegaace_sum = _body_sum(member, torch.linalg.cross(dist, force, dim=-1))
    if reduce_sum is not None:
        face_sum, fomegaace_sum = reduce_sum(
            torch.stack([face_sum, fomegaace_sum])).unbind(0)
    if ext_face is not None:
        face_sum = face_sum + ext_face
    if ext_fomegaace is not None:
        fomegaace_sum = fomegaace_sum + ext_fomegaace

    # ---- body accelerations (FtCalcForces)
    R = _euler_rot(fts.angles)
    inert = R @ tb.inertia0 @ R.transpose(-1, -2)
    if chcontact is not None:
        from . import chcollision as CC
        cface, ctq, _ = CC.contact_forces(chcontact, B, R, fts.center,
                                          fts.fvel, fts.fomega, dt)
        face_sum = face_sum + cface
        fomegaace_sum = fomegaace_sum + ctq
    weight = tb.mass[:, None] * tb.gravity
    if chrono is not None:
        from . import chrono as CH
        sf, stq = CH.spring_forces(chrono, R, fts.center, fts.fvel,
                                   fts.fomega)
        tq_tor = CH.hinge_torsion(chrono, R, fts.fomega, fts.angles)
        face, omegaace = CH.solve_constrained(
            chrono, tb.mass, inert, R, fts.center, fts.fvel, fts.fomega,
            face_sum + sf + weight, fomegaace_sum + stq + tq_tor, dt)
    else:
        omegaace = torch.linalg.solve_ex(
            inert, fomegaace_sum[..., None])[0][..., 0]
        face = (face_sum + weight) / tb.mass[:, None]

    # ---- result integration (FtCalcForcesRes)
    fomega = fts.fomega + dt * omegaace
    fvel = fts.fvel
    if csp.simulate2d:
        face, fomega, fvel = face.clone(), fomega.clone(), fvel.clone()
        face[:, 1] = 0.0
        fomega[:, 0] = 0.0
        fomega[:, 2] = 0.0
        fvel[:, 1] = 0.0
    fcenter = fts.center + dt * fvel
    fvel = fvel + dt * face

    # ---- DOF constraints (FtApplyConstraints)
    if tb.translation_dof is not None:
        fvel = fvel * tb.translation_dof
        fcenter = fts.center + (fcenter - fts.center) * tb.translation_dof
    if tb.rotation_dof is not None:
        fomega = fomega * tb.rotation_dof

    # ---- FtPause freeze
    frozen = torch.as_tensor(t < cfg.ftpause, device=vel.device)
    fcenter = torch.where(frozen, fts.center, fcenter)
    fvel = torch.where(frozen, 0.0, fvel)
    fomega = torch.where(frozen, 0.0, fomega)

    # ---- particle update
    moves = (floating & ~frozen)[:, None]
    newpos = torch.where(moves, pos + dt * vel, pos)
    dist = newpos - fcenter[body]
    rigidvel = fvel[body] + torch.linalg.cross(fomega[body], dist, dim=-1)
    newvel = torch.where(moves, rigidvel, vel)

    # ---- body state commits on the corrector only
    if predictor:
        return newpos, newvel, fts
    return newpos, newvel, FloatingState(
        center=torch.where(frozen, fts.center, fcenter),
        fvel=torch.where(frozen, fts.fvel, fvel),
        fomega=torch.where(frozen, fts.fomega, fomega),
        angles=torch.where(frozen, fts.angles, fts.angles + fomega * dt))


def make_floating(body_particles, body_rho, csp: CteSph, *, ftpause=0.0,
                  translation_dof=None, rotation_dof=None, device="cuda"):
    """(FloatingCfg, FloatingState) from each body's particle positions, as
    GenCase computes them for ``<floatings>`` blocks: particle mass
    rhopbody*dp^dim, center the mean position, inertia about it.  The state
    goes to the card unless ``device`` says otherwise."""
    B = len(body_particles)
    masses, massps, inert, centers = [], [], [], []
    dim = 2 if csp.simulate2d else 3
    for pts, rhob in zip(body_particles, body_rho):
        pts = np.asarray(pts, np.float64)
        mp = rhob * csp.dp ** dim
        c = pts.mean(axis=0)
        r = pts - c
        ixx = (mp * (r[:, 1] ** 2 + r[:, 2] ** 2)).sum()
        iyy = (mp * (r[:, 0] ** 2 + r[:, 2] ** 2)).sum()
        izz = (mp * (r[:, 0] ** 2 + r[:, 1] ** 2)).sum()
        ixy = -(mp * r[:, 0] * r[:, 1]).sum()
        ixz = -(mp * r[:, 0] * r[:, 2]).sum()
        iyz = -(mp * r[:, 1] * r[:, 2]).sum()
        inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz],
                            [ixz, iyz, izz]])
        if csp.simulate2d:
            # keep the matrix invertible in 2D (only Iyy matters)
            inertia[0, 0] = max(inertia[0, 0], 1e-12)
            inertia[2, 2] = max(inertia[2, 2], 1e-12)
        masses.append(mp * len(pts))
        massps.append(mp)
        inert.append(inertia.reshape(-1))
        centers.append(c)
    cfg = FloatingCfg(
        count=B,
        mass=tuple(float(m) for m in masses),
        massp=tuple(float(m) for m in massps),
        inertia0=tuple(float(x) for i in inert for x in i),
        ftpause=ftpause,
        translation_dof=(tuple(float(x) for d in translation_dof for x in d)
                         if translation_dof else ()),
        rotation_dof=(tuple(float(x) for d in rotation_dof for x in d)
                      if rotation_dof else ()))
    zeros = torch.zeros((B, 3), dtype=torch.float32, device=device)
    state = FloatingState(
        center=torch.tensor(np.array(centers), dtype=torch.float32,
                            device=device),
        fvel=zeros, fomega=zeros.clone(), angles=zeros.clone())
    return cfg, state
