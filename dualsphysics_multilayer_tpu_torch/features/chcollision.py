"""Rigid-body contact from collision meshes (Chrono's ``<collision>``).

Counterpart of `dualsphysics_multilayer_tpu/features/chcollision.py`: the
reference hands body-body contact to Project Chrono (`JChronoData.h:
218-265` ``UseCollision``/``ModelFile``; `_FmtXML_Chrono.xml`
``<collision activate>`` with ``distancedp``; the materials of
``<properties>``).  As in JAX, each body with a ``modelfile`` mesh gets a
contact-point cloud (its vertices and its faces resampled at about dp),
and every body's points meet every other body's triangles in one dense
point-triangle sweep per pair of bodies, with the DEM visco-elastic
Hertzian law (``features/dem.py``) at each point closer than
``distancedp * dp`` (Chrono's SMC method; NSC runs through the same
law).  The sweep is chunked over the points so that one chunk holds at
most ``max_pairs`` point-triangle lanes.

The forces and torques join the per-body sums ahead of the rigid solve
(``features/floating.run_floating``), where the reference injects
Chrono's.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class ChContactCfg:
    """Static contact tables of the ``modelfile`` bodies.  ``body_ft``
    maps each to its floating body (-1: a fixed collider).  Points and
    triangles are in the body's frame: relative to its initial center for a
    floating body, world coordinates for a fixed one."""
    body_ft: np.ndarray     # (NB,) int32
    center0: np.ndarray     # (NB,3) f32 initial centers (0 for fixed)
    pts: np.ndarray         # (NB,P,3) f32 contact points, padded
    ptmask: np.ndarray      # (NB,P) bool
    tris: np.ndarray        # (NB,Q,3,3) f32 triangles, padded
    trimask: np.ndarray     # (NB,Q) bool
    tau: np.ndarray         # (NB,) (1-nu^2)/E
    kfric: np.ndarray       # (NB,)
    restitu: np.ndarray     # (NB,)
    mass: np.ndarray        # (NB,) body mass (fixed bodies: 0)
    ddp: float              # contact distance (distancedp * dp)
    dp: float


def sample_tri_points(tris, spacing):
    """The contact points of a triangle soup (host): its vertices and a
    barycentric grid on each face at about ``spacing``, deduplicated on a
    grid of spacing/4 (shared edges)."""
    pts = [tris.reshape(-1, 3)]
    for (a, b, c) in tris:
        na = max(int(np.linalg.norm(b - a) / spacing), 1)
        nb = max(int(np.linalg.norm(c - a) / spacing), 1)
        n = max(na, nb)
        for i in range(n + 1):
            for j in range(n + 1 - i):
                if (i, j) in ((0, 0), (n, 0), (0, n)):
                    continue
                u, v = i / n, j / n
                pts.append((a + u * (b - a) + v * (c - a))[None])
    allp = np.concatenate(pts, axis=0)
    key = np.round(allp / (0.25 * spacing)).astype(np.int64)
    _, keep = np.unique(key, axis=0, return_index=True)
    return allp[np.sort(keep)]


def make_chcontact(bodies, *, dp, distancedp=0.5, default_props=None):
    """The static tables (host).  ``bodies``: dicts with ``ft`` (floating
    index or -1), ``tris`` ((q,3,3) world-frame mesh), ``center0`` (a
    floating body's initial center), ``mass`` and the materials
    ``young``/``poisson``/``kfric``/``restitu`` (defaults those of JAX's
    ``make_chcontact``).  None without bodies."""
    if not bodies:
        return None
    dflt = dict(young=1e6, poisson=0.3, kfric=0.45, restitu=0.5)
    dflt.update(default_props or {})
    NB = len(bodies)
    ptl, tril = [], []
    for bd in bodies:
        tris = np.asarray(bd["tris"], np.float64)
        c0 = np.asarray(bd.get("center0", (0.0, 0.0, 0.0)), np.float64)
        tris = tris - c0[None, None]
        ptl.append(sample_tri_points(tris, dp))
        tril.append(tris)
    P = max(max(len(p) for p in ptl), 1)
    Q = max(max(len(t) for t in tril), 1)
    pts = np.zeros((NB, P, 3), np.float32)
    ptmask = np.zeros((NB, P), bool)
    tris = np.zeros((NB, Q, 3, 3), np.float32)
    trimask = np.zeros((NB, Q), bool)
    for i, (p, t) in enumerate(zip(ptl, tril)):
        pts[i, :len(p)] = p
        ptmask[i, :len(p)] = True
        tris[i, :len(t)] = t
        trimask[i, :len(t)] = True

    def get(bd, k):
        v = bd.get(k)
        return dflt[k] if v is None else v

    return ChContactCfg(
        body_ft=np.asarray([bd["ft"] for bd in bodies], np.int32),
        center0=np.asarray([bd.get("center0", (0, 0, 0)) for bd in bodies],
                           np.float32),
        pts=pts, ptmask=ptmask, tris=tris, trimask=trimask,
        tau=np.asarray([(1.0 - get(bd, "poisson") ** 2) / get(bd, "young")
                        for bd in bodies], np.float32),
        kfric=np.asarray([get(bd, "kfric") for bd in bodies], np.float32),
        restitu=np.asarray([get(bd, "restitu") for bd in bodies], np.float32),
        mass=np.asarray([bd.get("mass", 0.0) for bd in bodies], np.float32),
        ddp=float(distancedp) * float(dp), dp=float(dp))


@dataclass(frozen=True)
class _Tables:
    pts: torch.Tensor
    ptmask: torch.Tensor
    tris: torch.Tensor
    trimask: torch.Tensor
    center0: torch.Tensor
    body_ft: torch.Tensor
    isfl: torch.Tensor


@functools.lru_cache(maxsize=16)
def _tables(cc: ChContactCfg, device) -> _Tables:
    """``cc``'s arrays on ``device``, made once."""
    def t(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return _Tables(pts=t(cc.pts), ptmask=t(cc.ptmask), tris=t(cc.tris),
                   trimask=t(cc.trimask), center0=t(cc.center0),
                   body_ft=t(np.maximum(cc.body_ft, 0), torch.int64),
                   isfl=t(cc.body_ft >= 0))


def closest_on_tri(p, a, b, c):
    """The closest point on triangle abc to p, branch-free (Ericson, RTCD
    5.1.5: the Voronoi-region walk as a chain of selects); broadcasts over
    leading dimensions."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(dim=-1)
    d2 = (ac * ap).sum(dim=-1)
    bp = p - b
    d3 = (ab * bp).sum(dim=-1)
    d4 = (ac * bp).sum(dim=-1)
    cp = p - c
    d5 = (ab * cp).sum(dim=-1)
    d6 = (ac * cp).sum(dim=-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    s = va + vb + vc
    denom = torch.where(s.abs() > 1e-30, s, 1.0)
    v = vb / denom
    w = vc / denom
    eps = 1e-12

    def safe(x):
        return torch.where(x.abs() > eps, x, 1.0)

    vab = torch.clamp(d1 / safe(d1 - d3), 0.0, 1.0)
    vac = torch.clamp(d2 / safe(d2 - d6), 0.0, 1.0)
    vbc = torch.clamp((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)
    q = a + v[..., None] * ab + w[..., None] * ac
    q = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                    a + vab[..., None] * ab, q)                  # edge AB
    q = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                    a + vac[..., None] * ac, q)                  # edge AC
    q = torch.where(((va <= 0) & ((d4 - d3) >= 0)
                     & ((d5 - d6) >= 0))[..., None],
                    b + vbc[..., None] * (c - b), q)             # edge BC
    q = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, q)
    q = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, q)
    q = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, q)
    return q


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def contact_forces(cc: ChContactCfg, B, R, center, fvel, fomega, dt,
                   max_pairs: int = 1 << 22):
    """Mesh-contact force and torque on every floating body.  Returns
    ``(face, ftorque, dtterm)``: the (B,3) world force and torque sums and
    the DEM dt term of the contacts (JAX's; its ``run_floating`` drops
    it, and so does the port's)."""
    f32, dev = center.dtype, center.device
    tb = _tables(cc, dev)
    NB = cc.body_ft.shape[0]
    isfl = tb.isfl
    eye = torch.eye(3, dtype=f32, device=dev)
    Rb = torch.where(isfl[:, None, None], R[tb.body_ft], eye[None])
    cb = torch.where(isfl[:, None], center[tb.body_ft], tb.center0)
    vb = torch.where(isfl[:, None], fvel[tb.body_ft], 0.0)
    ob = torch.where(isfl[:, None], fomega[tb.body_ft], 0.0)
    ptsW = torch.einsum("bij,bpj->bpi", Rb, tb.pts) + cb[:, None]
    trisW = torch.einsum("bij,bqvj->bqvi", Rb, tb.tris) + cb[:, None, None]
    ddp = float(np.float32(cc.ddp))
    kn_geo = np.sqrt(np.float32(0.25 * cc.dp))
    P = ptsW.shape[1]
    Q = trisW.shape[1]
    chunk = max(1, max_pairs // Q)

    def pair(i, j):
        """(force on i, torque on i, force on j, torque on j, dt term):
        body i's points against body j's triangles."""
        t = trisW[j]
        f = np.float32
        fl_i, fl_j = cc.body_ft[i] >= 0, cc.body_ft[j] >= 0
        mi = f(cc.mass[i]) if fl_i else f(0.0)
        mj = f(cc.mass[j]) if fl_j else f(0.0)
        nu_mass = (mi * mj / max(mi + mj, f(1e-30)) if fl_i and fl_j
                   else f(0.5) * max(mi, mj))
        kn = f(4.0) / (f(3.0) * (cc.tau[i] + cc.tau[j])) * kn_geo
        eij = np.clip(f(0.5) * (cc.restitu[i] + cc.restitu[j]), f(1e-4),
                      f(0.999999))
        ln_e = np.log(eij)
        gn = -(f(2.0) * ln_e * np.sqrt(nu_mass * kn)) / np.sqrt(
            f(math.pi) + ln_e * ln_e)
        demv = f(0.2 * 40.0 / 3.21) * np.power(
            max(nu_mass, f(1e-30)) / kn, f(-0.4))
        # the pair's f32 constants as exact Python floats
        kn, gn, demv = float(kn), float(gn), float(demv)
        kfric = float(f(0.5) * (cc.kfric[i] + cc.kfric[j]))
        f_i = torch.zeros(3, dtype=f32, device=dev)
        tq_i = torch.zeros(3, dtype=f32, device=dev)
        tq_j = torch.zeros(3, dtype=f32, device=dev)
        dtmax = torch.zeros((), dtype=f32, device=dev)
        for p0 in range(0, P, chunk):
            p = ptsW[i, p0:p0 + chunk]                        # (c,3)
            q = closest_on_tri(p[:, None, :], t[None, :, 0], t[None, :, 1],
                               t[None, :, 2])                 # (c,Q,3)
            d = p[:, None, :] - q
            dist = torch.sqrt(torch.clamp((d * d).sum(dim=-1), min=1e-18))
            ovl = ddp - dist
            ok = (tb.ptmask[i, p0:p0 + chunk, None] & tb.trimask[j][None, :]
                  & (ovl > 0) & (dist > 1e-9))
            nrm = d / dist[..., None]
            vi = vb[i] + _cross(ob[i][None], p - cb[i])
            vj = vb[j] + _cross(ob[j][None, None], q - cb[j])
            dv = vi[:, None, :] - vj
            vn = (dv * nrm).sum(dim=-1)
            o = torch.clamp(ovl, min=0.0)
            fn = kn * o ** 1.5 - gn * o ** 0.25 * vn
            w = ok.to(f32)
            fvec = (w * fn)[..., None] * nrm
            dvt = dv - vn[..., None] * nrm
            vt = torch.sqrt(torch.clamp((dvt * dvt).sum(dim=-1), min=1e-18))
            ft = torch.minimum(kfric * fn * torch.tanh(8.0 * vt),
                               2.0 * (kn * dt - gn) * vt / 7.0)
            fvec = fvec + (w * ft)[..., None] * (dvt / vt[..., None])
            dtmax = torch.maximum(dtmax, torch.where(
                ok, demv * torch.pow(vn.abs(), 0.2), 0.0).amax())
            f_i = f_i + fvec.sum(dim=(0, 1))
            tq_i = tq_i + _cross(p[:, None] - cb[i], fvec).sum(dim=(0, 1))
            tq_j = tq_j + _cross(q - cb[j], -fvec).sum(dim=(0, 1))
        return f_i, tq_i, -f_i, tq_j, dtmax

    face = torch.zeros((B, 3), dtype=f32, device=dev)
    ftq = torch.zeros((B, 3), dtype=f32, device=dev)
    dtterm = torch.zeros((), dtype=f32, device=dev)
    for i in range(NB):
        for j in range(NB):
            if i == j or (cc.body_ft[i] < 0 and cc.body_ft[j] < 0):
                continue    # a fixed-fixed pair moves nothing
            fi, ti, fj, tj, dm = pair(i, j)
            if cc.body_ft[i] >= 0:
                face[cc.body_ft[i]] = face[cc.body_ft[i]] + fi
                ftq[cc.body_ft[i]] = ftq[cc.body_ft[i]] + ti
            if cc.body_ft[j] >= 0:
                face[cc.body_ft[j]] = face[cc.body_ft[j]] + fj
                ftq[cc.body_ft[j]] = ftq[cc.body_ft[j]] + tj
            dtterm = torch.maximum(dtterm, dm)
    return face, ftq, dtterm
