"""Particle initialize operations (`<special><initialize>`), applied once
to the loaded state before the run.

Counterpart of `dualsphysics_multilayer_tpu/features/initialize.py`
(reference `JDsInitialize`, JDsInitialize.h:68-73: IT_FluidVel,
IT_BoundNormalSet, Plane, Sphere, Cylinder, Parts; XML schema
`_FmtXML_Initialize.xml`): fluid velocity profiles (uniform, linear,
parabolic) and mDBC wall normals from analytic shapes or from the particle
distribution itself.  The CLI builds the plane and particle forms too
(``-initnorpla``, ``-initnorpart``, JSphCfgRun.cpp:162-168).

Every operation runs in numpy on the host at set-up, as the reference runs
them once in `JSphCpuSingle::ConfigDomain` (JSphCpuSingle.cpp:135-139);
:func:`apply_initialize` copies the state's arrays to the host, applies the
operations there and puts the velocity and the normals back on the state's
device.  Normals make a run an mDBC run: the callers (``io.xmlcase``,
``cli``) set ``tboundary=MDBC`` when the state comes back with them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import typesdef as td
from ..tools.common import pair_indices, parse_range_filter, wendland_wab


def _onlypos_mask(pos, onlypos):
    if onlypos is None:
        return np.ones(len(pos), bool)
    lo, hi = np.asarray(onlypos[0]), np.asarray(onlypos[1])
    return np.all((pos >= lo) & (pos <= hi), axis=1)


@dataclass(frozen=True)
class InitFluidVel:
    """IT_FluidVel: uniform/linear/parabolic velocity profile along a
    direction for the fluid of one mkfluid."""
    mkfluid: int
    direction: tuple = (1.0, 0.0, 0.0)
    profile: str = "uniform"            # uniform|linear|parabolic
    v: tuple = (1.0,)                   # 1, 2 or 3 speeds
    z: tuple = ()                       # matching z knots (linear/parabolic)
    onlypos: tuple | None = None

    def apply(self, csp, pos, vel, code):
        mkv = td.code_value(code)
        sel = (td.code_type(code) == td.TYPE_FLUID) & (mkv == self.mkfluid)
        sel &= _onlypos_mask(pos, self.onlypos)
        d = np.asarray(self.direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-30)
        zz = pos[:, 2]
        if self.profile == "uniform" or len(self.v) == 1:
            speed = np.full(len(pos), self.v[0])
        elif self.profile == "linear" or len(self.v) == 2:
            z1, z2 = self.z
            t = np.clip((zz - z1) / max(z2 - z1, 1e-30), 0.0, 1.0)
            speed = self.v[0] + (self.v[1] - self.v[0]) * t
        else:                            # parabolic through 3 (z, v) knots
            z1, z2, z3 = self.z
            v1, v2, v3 = self.v
            # Lagrange quadratic
            speed = (v1 * (zz - z2) * (zz - z3) / ((z1 - z2) * (z1 - z3))
                     + v2 * (zz - z1) * (zz - z3) / ((z2 - z1) * (z2 - z3))
                     + v3 * (zz - z1) * (zz - z2) / ((z3 - z1) * (z3 - z2)))
        vel = vel.copy()
        vel[sel] = speed[sel, None] * d
        return vel, None


@dataclass(frozen=True)
class InitBoundNormalSet:
    """IT_BoundNormalSet: constant normal for an mkbound."""
    mkbound: int
    normal: tuple = (1.0, 0.0, 0.0)
    onlypos: tuple | None = None

    def apply(self, csp, pos, vel, code):
        sel = _bound_sel(code, self.mkbound) & _onlypos_mask(pos,
                                                             self.onlypos)
        n = np.asarray(self.normal, np.float64)
        out = np.zeros((len(pos), 3))
        out[sel] = n
        return None, (sel, out)


def _bound_sel(code, mkbound):
    # mkbound blocks carry code value == mk (moving) or mk index (fixed);
    # match both fixed and moving particles of the block
    t = td.code_type(code)
    return ((t == td.TYPE_FIXED) | (t == td.TYPE_MOVING)) & \
        (td.code_value(code) == mkbound)


@dataclass(frozen=True)
class InitBoundNormalPlane:
    """IT_BoundNormalPlane: normals point from each particle towards the
    boundary-limit plane (point + normal); magnitude = distance to the
    plane (the mDBC ghost-node convention: |normal| = dist to wall
    surface)."""
    mkbound: int
    normal: tuple = (1.0, 0.0, 0.0)
    point: tuple | None = None          # None = auto from particles
    maxdisth: float = 2.0
    limitdist: float = 0.5
    onlypos: tuple | None = None

    def apply(self, csp, pos, vel, code):
        sel = _bound_sel(code, self.mkbound) & _onlypos_mask(pos,
                                                             self.onlypos)
        n = np.asarray(self.normal, np.float64)
        n = n / max(np.linalg.norm(n), 1e-30)
        if self.point is not None:
            p0 = np.asarray(self.point, np.float64)
        else:
            # auto: outermost particle along the normal + limitdist*dp
            if not sel.any():
                return None, (sel, np.zeros((len(pos), 3)))
            dmax = (pos[sel] @ n).max()
            p0 = dmax * n + self.limitdist * csp.dp * n
        # signed distance to the plane through p0 with normal n
        dist = (p0 - pos) @ n
        out = np.zeros((len(pos), 3))
        keep = sel & (np.abs(dist) <= self.maxdisth * csp.kernelh)
        out[keep] = dist[keep, None] * n
        return None, (keep, out)


@dataclass(frozen=True)
class InitBoundNormalSphere:
    """IT_BoundNormalSphere: radial normals towards the sphere surface."""
    mkbound: int
    center: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0
    inside: bool = True
    maxdisth: float = 2.0
    onlypos: tuple | None = None

    def apply(self, csp, pos, vel, code):
        sel = _bound_sel(code, self.mkbound) & _onlypos_mask(pos,
                                                             self.onlypos)
        c = np.asarray(self.center, np.float64)
        rel = pos - c
        r = np.linalg.norm(rel, axis=1)
        rdir = rel / np.maximum(r, 1e-30)[:, None]
        # particles inside the solid: normal points towards the surface
        dist = self.radius - r if self.inside else r - self.radius
        outdir = rdir if self.inside else -rdir
        out = np.zeros((len(pos), 3))
        keep = sel & (np.abs(dist) <= self.maxdisth * csp.kernelh)
        out[keep] = dist[keep, None] * outdir[keep]
        return None, (keep, out)


@dataclass(frozen=True)
class InitBoundNormalCylinder:
    """IT_BoundNormalCylinder: radial normals to the lateral surface (+ the
    cap planes when limit1/limit2)."""
    mkbound: int
    center1: tuple = (0.0, 0.0, 0.0)
    center2: tuple = (0.0, 0.0, 1.0)
    radius: float = 1.0
    inside: bool = True
    limit1: bool = True
    limit2: bool = True
    maxdisth: float = 2.0
    onlypos: tuple | None = None

    def apply(self, csp, pos, vel, code):
        sel = _bound_sel(code, self.mkbound) & _onlypos_mask(pos,
                                                             self.onlypos)
        c1 = np.asarray(self.center1, np.float64)
        c2 = np.asarray(self.center2, np.float64)
        ax = c2 - c1
        L = max(np.linalg.norm(ax), 1e-30)
        ax = ax / L
        rel = pos - c1
        t = rel @ ax
        radial = rel - t[:, None] * ax[None, :]
        r = np.linalg.norm(radial, axis=1)
        rdir = radial / np.maximum(r, 1e-30)[:, None]
        dist_side = self.radius - r if self.inside else r - self.radius
        dir_side = rdir if self.inside else -rdir
        # candidate: lateral surface
        dist = dist_side.copy()
        vec = dist_side[:, None] * dir_side
        if self.inside:
            # cap planes (choose nearest surface among side/caps)
            if self.limit1:
                d1 = t                      # distance to cap 1 (inwards +ax)
                closer = np.abs(d1) < np.abs(dist)
                vec[closer] = (-d1[closer, None]) * ax[None, :]
                dist[closer] = d1[closer]
            if self.limit2:
                d2 = L - t
                closer = np.abs(d2) < np.abs(dist)
                vec[closer] = d2[closer, None] * ax[None, :]
                dist[closer] = d2[closer]
        out = np.zeros((len(pos), 3))
        keep = sel & (np.abs(dist) <= self.maxdisth * csp.kernelh)
        out[keep] = vec[keep]
        return None, (keep, out)


@dataclass(frozen=True)
class InitBoundNormalParts:
    """IT_BoundNormalParts: normals from the particle distribution itself —
    for each bound particle, the SPH-weighted direction away from its bound
    neighbours towards the fluid side (the geometry-free fallback the
    reference computes via GenCase normal data; here a Marrone-style
    mass-centroid estimate, cf. src_mphase JNormalsMarrone.cpp)."""
    mkbound: int
    maxdisth: float = 2.0
    onlypos: tuple | None = None

    def apply(self, csp, pos, vel, code):
        sel = _bound_sel(code, self.mkbound) & _onlypos_mask(pos,
                                                             self.onlypos)
        t = td.code_type(code)
        bound = (t == td.TYPE_FIXED) | (t == td.TYPE_MOVING) | \
            (t == td.TYPE_FLOATING)
        bpos = pos[bound]
        idx = np.where(sel)[0]
        ti, sj = pair_indices(bpos, pos[idx], csp.kernelsize)
        dr = pos[idx][ti] - bpos[sj]
        rr2 = (dr ** 2).sum(1)
        w = wendland_wab(csp.simulate2d, csp.kernelh, rr2)
        acc = np.zeros((len(idx), 3))
        for k in range(3):
            np.add.at(acc[:, k], ti, w * dr[:, k])
        # direction away from the bound mass centroid = towards the fluid;
        # magnitude scaled to half the local spacing like GenCase normals
        norm = np.linalg.norm(acc, axis=1)
        ok = norm > 1e-12
        ndir = np.zeros_like(acc)
        ndir[ok] = acc[ok] / norm[ok, None]
        out = np.zeros((len(pos), 3))
        out[idx] = ndir * (0.5 * csp.dp)
        keep = np.zeros(len(pos), bool)
        keep[idx[ok]] = True
        return None, (keep, out)


def apply_initialize(ops, csp, state):
    """The state with every operation of ``ops`` applied in order: its
    velocity, and its wall normals when an operation sets normals (or the
    state had them), as float32 tensors on the state's device.  The
    operations see the state's slots as they are (any order, inactive
    slots included)."""
    pos = state.pos.cpu().numpy()
    vel = state.vel.cpu().numpy().copy()
    code = state.code.cpu().numpy()
    normals = (state.boundnormal.cpu().numpy().copy()
               if state.boundnormal is not None
               else np.zeros((len(pos), 3)))
    any_norm = state.boundnormal is not None
    for op in ops:
        v2, nupd = op.apply(csp, pos, vel, code)
        if v2 is not None:
            vel = v2
        if nupd is not None:
            selk, nvals = nupd
            normals[selk] = nvals[selk]
            any_norm = True
    dev = state.pos.device
    out = dataclasses.replace(state, vel=torch.tensor(
        vel, dtype=torch.float32, device=dev))
    if any_norm:
        out = dataclasses.replace(out, boundnormal=torch.tensor(
            normals, dtype=torch.float32, device=dev))
    return out


# The XML node and the command line

def _xyz(el, default=(0.0, 0.0, 0.0)):
    if el is None:
        return default
    return tuple(float(el.get(a, d)) for a, d in zip("xyz", default))


def _vget(el, name, default=None, attr="v"):
    n = el.find(name)
    if n is None:
        return default
    v = n.get(attr)
    return default if v is None else v


def _onlypos(el):
    op = el.find("onlypos")
    if op is None:
        return None
    return (_xyz(op.find("posmin"), (-1e30,) * 3),
            _xyz(op.find("posmax"), (1e30,) * 3))


def parse_initialize_xml(node):
    """<initialize> element -> list of ops (JDsInitialize::LoadXml)."""
    ops = []
    for el in node:
        if el.get("active", "true").lower() in ("false", "0"):
            continue
        tag = el.tag
        if tag == "fluidvelocity":
            mk = int(float(el.get("mkfluid", 0)))
            d = _xyz(el.find("direction"), (1.0, 0.0, 0.0))
            if el.find("velocity3") is not None:
                v3 = el.find("velocity3")
                ops.append(InitFluidVel(
                    mkfluid=mk, direction=d, profile="parabolic",
                    v=tuple(float(v3.get(k)) for k in ("v", "v2", "v3")),
                    z=tuple(float(v3.get(k)) for k in ("z", "z2", "z3")),
                    onlypos=_onlypos(el)))
            elif el.find("velocity2") is not None:
                v2 = el.find("velocity2")
                ops.append(InitFluidVel(
                    mkfluid=mk, direction=d, profile="linear",
                    v=(float(v2.get("v")), float(v2.get("v2"))),
                    z=(float(v2.get("z")), float(v2.get("z2"))),
                    onlypos=_onlypos(el)))
            else:
                ops.append(InitFluidVel(
                    mkfluid=mk, direction=d, profile="uniform",
                    v=(float(_vget(el, "velocity", 0.0)),),
                    onlypos=_onlypos(el)))
        elif tag == "boundnormal_set":
            ops.append(InitBoundNormalSet(
                mkbound=int(float(el.get("mkbound", 0))),
                normal=_xyz(el.find("normal"), (1.0, 0.0, 0.0)),
                onlypos=_onlypos(el)))
        elif tag == "boundnormal_plane":
            pt = el.find("point")
            auto = pt is None or pt.get("auto", "false").lower() in \
                ("true", "1")
            ops.append(InitBoundNormalPlane(
                mkbound=int(float(el.get("mkbound", 0))),
                normal=_xyz(el.find("normal"), (1.0, 0.0, 0.0)),
                point=None if auto else _xyz(pt),
                maxdisth=float(_vget(el, "maxdisth", 2.0)),
                limitdist=float(_vget(el, "limitdist", 0.5, attr="vdp")),
                onlypos=_onlypos(el)))
        elif tag == "boundnormal_sphere":
            ops.append(InitBoundNormalSphere(
                mkbound=int(float(el.get("mkbound", 0))),
                center=_xyz(el.find("center")),
                radius=float(_vget(el, "radius", 1.0)),
                inside=str(_vget(el, "inside", "true")).lower() in
                ("true", "1"),
                maxdisth=float(_vget(el, "maxdisth", 2.0)),
                onlypos=_onlypos(el)))
        elif tag == "boundnormal_cylinder":
            ops.append(InitBoundNormalCylinder(
                mkbound=int(float(el.get("mkbound", 0))),
                center1=_xyz(el.find("center1")),
                center2=_xyz(el.find("center2")),
                radius=float(_vget(el, "radius", 1.0)),
                inside=str(_vget(el, "inside", "true")).lower() in
                ("true", "1"),
                limit1=str(_vget(el, "limit1", "true")).lower() in
                ("true", "1"),
                limit2=str(_vget(el, "limit2", "true")).lower() in
                ("true", "1"),
                maxdisth=float(_vget(el, "maxdisth", 2.0)),
                onlypos=_onlypos(el)))
        elif tag == "boundnormal_parts":
            ops.append(InitBoundNormalParts(
                mkbound=int(float(el.get("mkbound", 0))),
                maxdisth=float(_vget(el, "maxdisth", 2.0)),
                onlypos=_onlypos(el)))
    return ops


def parse_initnor_cli(spec, kind="plane"):
    """CLI forms (JSphCfgRun.cpp:162-168):
    -initnorpla:mkbound=10:normal=1:0:0[:point=x:y:z|point=auto]
    -initnorpart:mkbound=5-7,10[:maxdisth=2]"""
    fields = {}
    toks = spec.split(":")
    i = 0
    while i < len(toks):
        t = toks[i]
        if "=" in t:
            k, v = t.split("=", 1)
            vals = [v]
            # collect numeric continuation tokens (normal=1:0:0)
            while i + 1 < len(toks) and "=" not in toks[i + 1]:
                vals.append(toks[i + 1])
                i += 1
            fields[k] = vals
        i += 1
    mks = fields.get("mkbound", ["0"])[0]
    mklist = parse_range_filter(mks)
    ops = []
    for mk in mklist:
        if kind == "parts":
            ops.append(InitBoundNormalParts(
                mkbound=int(mk),
                maxdisth=float(fields.get("maxdisth", ["2"])[0])))
        else:
            pt = fields.get("point")
            point = None if (pt is None or pt[0] == "auto") else \
                tuple(float(x) for x in pt[:3])
            ops.append(InitBoundNormalPlane(
                mkbound=int(mk),
                normal=tuple(float(x)
                             for x in fields.get("normal",
                                                 ["1", "0", "0"])[:3]),
                point=point,
                maxdisth=float(fields.get("maxdisth", ["2"])[0]),
                limitdist=float(fields.get("limitdist", ["0.5"])[0])))
    return ops
