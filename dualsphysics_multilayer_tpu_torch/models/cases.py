"""Built-in case construction for the port: the dp-lattice box drawing of
GenCase (3D, or 2D in the y = 0 plane) with the mDBC normals of its faces,
the 3D and 2D dam breaks (`examples/main/01_DamBreak/CaseDambreak_Def.xml`,
`CaseDambreakVal2D_Def.xml`), the 3D coastal run-up, the 2D floating
box and the 2D wave flume; the 2D wet dam break of the multiphase
non-Newtonian solver lives in ``models/nnewtonian.py``.

Counterpart of `dualsphysics_multilayer_tpu/models/cases.py` (``Draw``
with every GenCase command the XML loader ``io/xmlcase.py`` draws through,
``prism_pred``, ``Case``, ``_make_state``, ``_make_domain``,
``dambreak3d``, ``dambreak2d``, ``coastal_runup3d``, ``floatingbox2d``,
``channel2d``, ``waveflume2d``, and the periodic channel of its tests as
``periodic_channel2d``; the
bucket capacities of the JAX builders, ``lattice_cellcap`` among them,
belong to the TPU layouts and have no counterpart here).  Lattices, ids,
densities, normals and the domain come out equal to the JAX package's,
which the tests check array for array.  Cases are built on the card unless
the caller asks for another device.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph, make_ctesph
from ..features import floating as FT
from ..features import motion as MOT
from ..ops import celldiv as cd
from ..ops import eos
from .wcsph import SimState

# cell-size skin for the rebuild-when-needed divide: candidate volume grows
# ~(1+skin)^3 in exchange for divide-free steps while displacements stay
# under skin*kernelsize
DOMAIN_SKIN = 1.0 / 16.0

_EPS = 1e-6
# the six axis directions of GenCase's <dirfilter> (redrawnear)
_DIRVECS = {"right": (1, 0, 0), "left": (-1, 0, 0), "back": (0, 1, 0),
            "front": (0, -1, 0), "top": (0, 0, 1), "bottom": (0, 0, -1)}


def prism_pred(base, extrude):
    """Point-in-extruded-polygon predicate ((m,3) -> bool): the even-odd
    test in the base plane and the extrusion interval (``Draw.prism`` and
    GenCase ``<fillprism>``)."""
    base = np.asarray(base, np.float64)
    ev = np.asarray(extrude, np.float64)
    m = len(base)
    eL = np.linalg.norm(ev)
    ez = ev / max(eL, _EPS)
    u0 = base[1] - base[0]
    u0 = u0 - np.dot(u0, ez) * ez
    u0 = u0 / max(np.linalg.norm(u0), _EPS)
    v0 = np.cross(ez, u0)
    b2 = np.stack([(base - base[0]) @ u0, (base - base[0]) @ v0], axis=1)

    def pred(pts):
        rel = np.asarray(pts) - base[0][None, :]
        t = rel @ ez
        px = rel @ u0
        py = rel @ v0
        inside = np.zeros(len(rel), bool)
        jm = m - 1
        for i in range(m):
            xi, yi = b2[i]
            xj, yj = b2[jm]
            crossed = ((yi > py) != (yj > py)) & (
                px < (xj - xi) * (py - yi) / (yj - yi + 1e-300) + xi)
            inside ^= crossed
            jm = i
        return inside & (t >= -_EPS) & (t <= eL + _EPS)

    return pred


@dataclass
class Draw:
    """dp-lattice drawing canvas anchored at the origin, with
    last-draw-wins overwrite (GenCase ``setmkfluid``/``setmkbound`` +
    the draw, fill and redraw commands).  With ``simulate2d`` every point
    lies in the y = 0 plane and boxes have no front/back faces.  A point
    carries its mDBC normal (inward, length dp) where the command gives
    one, else zero."""
    dp: float
    simulate2d: bool = False
    points: dict = field(default_factory=dict)   # (i,j,k) -> (ptype, mk, normal)

    def _irange(self, lo, hi):
        i0 = int(math.ceil(lo / self.dp - _EPS))
        i1 = int(math.floor(hi / self.dp + _EPS))
        return list(range(i0, i1 + 1))

    def _ranges(self, lo, hi):
        """Lattice indices per axis over [lo, hi] (y = [0] in 2D)."""
        return (self._irange(lo[0], hi[0]),
                [0] if self.simulate2d else self._irange(lo[1], hi[1]),
                self._irange(lo[2], hi[2]))

    def _frange(self, lo, hi):
        """Indices of a fill region, half-open at its far limit: a lattice
        point exactly on ``hi`` lies outside (GenCase fill semantics)."""
        idx = self._irange(lo, hi)
        if idx and abs(idx[-1] * self.dp - hi) < _EPS:
            idx = idx[:-1]
        return idx

    def _steps(self):
        steps = [(1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1)]
        if not self.simulate2d:
            steps += [(0, 1, 0), (0, -1, 0)]
        return steps

    def _seed(self, seed):
        s0 = tuple(int(round(seed[a] / self.dp)) for a in range(3))
        return (s0[0], 0, s0[2]) if self.simulate2d else s0

    def _flood(self, s0, lo, hi, ptype, mk, ok=None):
        """Breadth-first fill of the empty sites connected to ``s0`` inside
        the index box [lo, hi] (and where ``ok``)."""
        seen = {s0}
        q = deque([s0])
        while q:
            node = q.popleft()
            self.points[node] = (ptype, mk, (0.0, 0.0, 0.0))
            for dx, dy, dz in self._steps():
                nb = (node[0] + dx, node[1] + dy, node[2] + dz)
                if nb in seen or nb in self.points:
                    continue
                if not all(lo[a] <= nb[a] <= hi[a] for a in range(3)):
                    continue
                if ok is not None and not ok(nb):
                    continue
                seen.add(nb)
                q.append(nb)

    def box(self, pmin, pmax, *, ptype, mk, faces="solid"):
        """Draw a box: ``faces`` is 'solid' or a '|'-joined subset of
        bottom, top, left, right, front, back (left/right = x faces,
        front/back = y faces, bottom/top = z faces).  A face point carries
        the mDBC normal: the sum of its faces' inward unit normals scaled
        to length dp (the ghost node lies one dp inside, JSphCpu.cpp:1036
        gpos = pos + boundnormal); a solid box's points carry none."""
        xs, ys, zs = (self._irange(pmin[a], pmax[a]) for a in range(3))
        if self.simulate2d:
            ys = [0]
        want = None if faces == "solid" else {f.strip() for f in faces.split("|")}
        depth = not self.simulate2d

        def inward(i, j, k):
            """Inward unit normals of the faces the point lies on."""
            return [n for on, n in (
                ("left" in want and i == xs[0], (1, 0, 0)),
                ("right" in want and i == xs[-1], (-1, 0, 0)),
                (depth and "front" in want and j == ys[0], (0, 1, 0)),
                (depth and "back" in want and j == ys[-1], (0, -1, 0)),
                ("bottom" in want and k == zs[0], (0, 0, 1)),
                ("top" in want and k == zs[-1], (0, 0, -1))) if on]

        for k in zs:
            for j in ys:
                for i in xs:
                    if want is None:
                        self.points[(i, j, k)] = (ptype, mk, (0.0, 0.0, 0.0))
                        continue
                    faces_on = inward(i, j, k)
                    if not faces_on:
                        continue
                    v = np.sum(faces_on, axis=0, dtype=np.float64)
                    nn = np.linalg.norm(v)
                    v = v / nn * self.dp if nn else np.zeros(3)
                    self.points[(i, j, k)] = (ptype, mk,
                                              tuple(float(x) for x in v))

    def sphere(self, center, radius, *, ptype, mk, solid=True):
        """GenCase ``<drawsphere>``: lattice points within ``radius`` of
        ``center`` (solid) or within a dp-thick shell (face mode), with
        inward radial normals."""
        c = np.asarray(center, np.float64)
        xs, ys, zs = self._ranges(c - radius - self.dp, c + radius + self.dp)
        for k in zs:
            for j in ys:
                for i in xs:
                    p = np.array([i * self.dp, j * self.dp, k * self.dp])
                    if self.simulate2d:
                        p[1] = c[1]
                    d = np.linalg.norm(p - c)
                    inside = d <= radius + _EPS if solid \
                        else (radius - self.dp - _EPS <= d <= radius + _EPS)
                    if not inside:
                        continue
                    nv = (c - p) / d * self.dp if d > _EPS else np.zeros(3)
                    self.points[(i, j, k)] = (
                        ptype, mk, (float(nv[0]), float(nv[1]), float(nv[2])))

    def cylinder(self, p1, p2, radius, *, ptype, mk, solid=True):
        """GenCase ``<drawcylinder>``: lattice points within ``radius`` of
        the p1->p2 axis between the end planes (solid) or on the dp-thick
        lateral shell (face mode), with inward radial normals."""
        a = np.asarray(p1, np.float64)
        b = np.asarray(p2, np.float64)
        ax = b - a
        L = np.linalg.norm(ax)
        if L < _EPS:
            return self.sphere(p1, radius, ptype=ptype, mk=mk, solid=solid)
        ax = ax / L
        xs, ys, zs = self._ranges(np.minimum(a, b) - radius - self.dp,
                                  np.maximum(a, b) + radius + self.dp)
        for k in zs:
            for j in ys:
                for i in xs:
                    p = np.array([i * self.dp, j * self.dp, k * self.dp])
                    if self.simulate2d:
                        p[1] = a[1]
                    t = np.dot(p - a, ax)
                    if t < -_EPS or t > L + _EPS:
                        continue
                    rad_v = (p - a) - t * ax
                    d = np.linalg.norm(rad_v)
                    inside = d <= radius + _EPS if solid \
                        else (radius - self.dp - _EPS <= d <= radius + _EPS)
                    if not inside:
                        continue
                    nv = -rad_v / d * self.dp if d > _EPS else np.zeros(3)
                    self.points[(i, j, k)] = (
                        ptype, mk, (float(nv[0]), float(nv[1]), float(nv[2])))

    def voidbox(self, pmin, pmax):
        """GenCase ``setmkvoid`` + drawbox: erase the points in the box."""
        xs, ys, zs = (set(r) for r in self._ranges(pmin, pmax))
        for key in [k for k in self.points
                    if k[0] in xs and k[1] in ys and k[2] in zs]:
            del self.points[key]

    def fillbox(self, seed, pmin, pmax, *, ptype, mk):
        """GenCase ``<fillbox>``: flood-fill the empty lattice region
        connected to ``seed``, bounded by the box (half-open at its far
        limit) and by the points already drawn."""
        xs = self._frange(pmin[0], pmax[0])
        ys = [0] if self.simulate2d else self._frange(pmin[1], pmax[1])
        zs = self._frange(pmin[2], pmax[2])
        if not xs or not ys or not zs:
            return
        lo = (xs[0], ys[0], zs[0])
        hi = (xs[-1], ys[-1], zs[-1])
        s0 = self._seed(seed)
        if not all(lo[a] <= s0[a] <= hi[a] for a in range(3)) \
                or s0 in self.points:
            return
        self._flood(s0, lo, hi, ptype, mk)

    def fill_domain(self, pmin, pmax, *, ptype, mk):
        """Paint every lattice site of [pmin, pmax), void included (the
        filterless GenCase ``<redraw/>``)."""
        xs = self._frange(pmin[0], pmax[0])
        ys = [0] if self.simulate2d else self._frange(pmin[1], pmax[1])
        zs = self._frange(pmin[2], pmax[2])
        for k in zs:
            for j in ys:
                for i in xs:
                    self.points[(i, j, k)] = (ptype, mk, (0.0, 0.0, 0.0))

    def _snap(self, p):
        return (int(round(p[0] / self.dp)),
                0 if self.simulate2d else int(round(p[1] / self.dp)),
                int(round(p[2] / self.dp)))

    def pointmark(self, p, *, ptype, mk, normal=(0.0, 0.0, 0.0)):
        """GenCase ``<drawpoint(s)>``: the lattice point nearest ``p``."""
        self.points[self._snap(p)] = (ptype, mk, tuple(normal))

    def segment(self, p1, p2, *, ptype, mk):
        """GenCase ``<drawline(s)/lineto>``: samples every dp/4 along the
        segment, each snapped to its nearest lattice point."""
        a = np.asarray(p1, np.float64)
        b = np.asarray(p2, np.float64)
        L = np.linalg.norm(b - a)
        step = self.dp * 0.25
        ts = [min(k * step / L, 1.0)
              for k in range(int(math.floor(L / step)) + 1)] if L else [0.0]
        if ts[-1] < 1.0:
            ts.append(1.0)
        for t in ts:
            self.pointmark(a + t * (b - a), ptype=ptype, mk=mk)

    def tri_surface(self, tris, *, ptype, mk, normals=True):
        """Rasterize a triangle soup (GenCase ``<drawtriangle(s)/quadri/
        figure>`` and the mesh imports): each triangle sampled on a
        barycentric grid at dp/2, the nearest lattice points marked, with
        the inward (minus the face) normal scaled to dp."""
        tris = np.asarray(tris, np.float64).reshape(-1, 3, 3)
        for a, b, c in tris:
            e1, e2 = b - a, c - a
            nrm = np.cross(e1, e2)
            nl = np.linalg.norm(nrm)
            nv = (-nrm / nl * self.dp) if (normals and nl > _EPS) \
                else np.zeros(3)
            n1 = max(1, int(math.ceil(np.linalg.norm(e1) / (self.dp * 0.5))))
            n2 = max(1, int(math.ceil(np.linalg.norm(e2) / (self.dp * 0.5))))
            for iu in range(n1 + 1):
                u = iu / n1
                for iv in range(n2 + 1):
                    v = iv / n2
                    if u + v > 1.0 + 1e-9:
                        continue
                    self.points[self._snap(a + u * e1 + v * e2)] = (
                        ptype, mk, (float(nv[0]), float(nv[1]), float(nv[2])))

    def solid_pred(self, pred, bbox, *, ptype, mk):
        """Fill every lattice point of ``bbox`` where ``pred((m,3) points)``
        holds (rotated boxes, prisms, ellipsoids, the solitary wave)."""
        xs, ys, zs = self._ranges(np.asarray(bbox[0]), np.asarray(bbox[1]))
        if not xs or not ys or not zs:
            return
        gi, gj, gk = np.meshgrid(xs, ys, zs, indexing="ij")
        keys = np.stack([gi.ravel(), gj.ravel(), gk.ravel()], axis=1)
        sel = np.asarray(pred(keys * self.dp), bool)
        for (i, j, k) in keys[sel]:
            self.points[(int(i), int(j), int(k))] = (ptype, mk,
                                                     (0.0, 0.0, 0.0))

    def prism(self, base, extrude, *, ptype, mk, solid=True):
        """GenCase ``<drawprism>``/``<drawpolygon>``: the planar loop
        ``base`` extruded along ``extrude``, solid or its walls and caps."""
        base = np.asarray(base, np.float64)
        ev = np.asarray(extrude, np.float64)
        m = len(base)
        if not solid:
            for i in range(m):
                a, b = base[i], base[(i + 1) % m]
                self.tri_surface([[a, b, b + ev], [a, b + ev, a + ev]],
                                 ptype=ptype, mk=mk)
            for loop in (base, base + ev):
                ctr = loop.mean(axis=0)
                self.tri_surface(
                    [[ctr, loop[i], loop[(i + 1) % m]] for i in range(m)],
                    ptype=ptype, mk=mk)
            return
        lo = np.minimum(base.min(0), (base + ev).min(0)) - self.dp
        hi = np.maximum(base.max(0), (base + ev).max(0)) + self.dp
        self.solid_pred(prism_pred(base, ev), (lo, hi), ptype=ptype, mk=mk)

    def ellipsoid(self, p1, p2, radius=1.0, *, ptype, mk, solid=True):
        """GenCase ``<drawellipsoid>``: centred between the two points,
        semi-axes half the per-axis extents times ``radius`` (``radius``
        itself on a degenerate axis); solid or a dp-thick shell."""
        a = np.asarray(p1, np.float64)
        b = np.asarray(p2, np.float64)
        c = 0.5 * (a + b)
        semi = np.abs(b - a) * 0.5 * radius
        semi = np.where(semi < _EPS, radius, semi)
        if self.simulate2d:
            semi[1] = 1.0

        def pred(pts):
            u = (pts - c[None, :]) / semi[None, :]
            r2 = np.sum(u * u, axis=1)
            if solid:
                return r2 <= 1.0 + _EPS
            inner = (np.abs(pts - c[None, :]) / np.maximum(
                semi[None, :] - self.dp, _EPS))
            return (r2 <= 1.0 + _EPS) & (np.sum(inner * inner, axis=1)
                                         >= 1.0 - _EPS)

        self.solid_pred(pred, (c - semi - self.dp, c + semi + self.dp),
                        ptype=ptype, mk=mk)

    def fillpoint(self, seed, bounds, *, ptype, mk):
        """GenCase ``<fillpoint>``: ``fillbox`` over the definition box."""
        self.fillbox(seed, bounds[0], bounds[1], ptype=ptype, mk=mk)

    def fillpred(self, seed, bounds, pred, *, ptype, mk):
        """``fillbox`` also bounded by a region predicate (GenCase
        ``<fillprism>``/``<fillfigure>``)."""
        xs, ys, zs = self._ranges(np.asarray(bounds[0]),
                                  np.asarray(bounds[1]))
        if not xs or not ys or not zs:
            return
        lo = (xs[0], ys[0], zs[0])
        hi = (xs[-1], ys[-1], zs[-1])

        def ok(n):
            w = np.array([n[a] * self.dp for a in range(3)])
            return bool(np.asarray(pred(w[None, :])).ravel()[0])

        s0 = self._seed(seed)
        if not all(lo[a] <= s0[a] <= hi[a] for a in range(3)) \
                or s0 in self.points or not ok(s0):
            return
        self._flood(s0, lo, hi, ptype, mk, ok)

    def _inbox(self, ijk, box):
        return box is None or all(
            box[0][a] - _EPS <= ijk[a] * self.dp <= box[1][a] + _EPS
            for a in range(3))

    def redraw(self, *, ptype, mk, filter_type=None, filter_mk=None,
               box=None):
        """GenCase ``<redraw>``/``<redrawbox>``: give the current type/mk
        to the points matching the (type, mk) filter and the box;
        ``ptype=None`` (setmkvoid) deletes them."""
        out = [ijk for ijk, (t, m, _n) in self.points.items()
               if (filter_type is None or t == filter_type)
               and (filter_mk is None or m == filter_mk)
               and self._inbox(ijk, box)]
        for ijk in out:
            if ptype is None:
                del self.points[ijk]
            else:
                self.points[ijk] = (ptype, mk, self.points[ijk][2])

    def redrawnear(self, *, ptype, mk, times=1, targettp="fluid",
                   targetmk=None, bordertp="bound", bordermk=None,
                   dirs=None, box=None):
        """GenCase ``<redrawnear>``/``<redrawnearbox>``: repaint target
        sites (``targettp='void'``: empty sites) lying in an allowed
        direction from a border site, one layer per pass for ``times``
        passes, painted sites joining the border.  ``dirs``: the
        <dirfilter> subset of top/bottom/left/right/front/back, else the
        full neighbourhood with diagonals."""
        if dirs:
            use = [_DIRVECS[d] for d in dirs
                   if not (self.simulate2d and d in ("front", "back"))]
        else:
            js = (0,) if self.simulate2d else (-1, 0, 1)
            use = [(di, dj, dk) for di in (-1, 0, 1) for dj in js
                   for dk in (-1, 0, 1) if (di, dj, dk) != (0, 0, 0)]

        def match(entry, tp, mkf):
            if tp == "void":
                return entry is None
            if entry is None:
                return False
            t, m, _n = entry
            if tp == "fluid" and t != td.TYPE_FLUID:
                return False
            if tp == "bound" and t == td.TYPE_FLUID:
                return False
            return mkf is None or m == mkf

        border = {ijk for ijk, e in self.points.items()
                  if match(e, bordertp, bordermk) and self._inbox(ijk, box)}
        if bordertp == "void":
            # empty sites next to an occupied one, inside the box
            border = set()
            for ijk in self.points:
                for d in use:
                    nb = (ijk[0] - d[0], ijk[1] - d[1], ijk[2] - d[2])
                    if nb not in self.points and self._inbox(nb, box):
                        border.add(nb)
        for _ in range(max(int(times), 1)):
            paint = set()
            for b in border:
                for d in use:
                    t = (b[0] + d[0], b[1] + d[1], b[2] + d[2])
                    if t in paint or not self._inbox(t, box):
                        continue
                    if match(self.points.get(t), targettp, targetmk):
                        paint.add(t)
            if not paint:
                break
            for t in paint:
                old = self.points.get(t)
                if ptype is None:
                    self.points.pop(t, None)
                else:
                    self.points[t] = (ptype, mk,
                                      old[2] if old else (0.0, 0.0, 0.0))
            border |= paint

    def cell_mks(self):
        """{(i,j,k): (ptype, mk)}: the lattice (GenCase ``<cellsout>``)."""
        return {ijk: (t, m) for ijk, (t, m, _n) in self.points.items()}

    def build(self):
        """Assign canonical ids (fixed < moving < floating < fluid; within a
        type, lattice order z, y, x) and return (pos f64 (np,3), code int32
        (np,)); the points' mDBC normals land in ``self.normals`` (np,3)."""
        order = {td.TYPE_FIXED: 0, td.TYPE_MOVING: 1,
                 td.TYPE_FLOATING: 2, td.TYPE_FLUID: 3}
        items = sorted(self.points.items(),
                       key=lambda kv: (order[kv[1][0]], kv[0][2], kv[0][1],
                                       kv[0][0]))
        ijk = np.array([key for key, _ in items], dtype=np.float64).reshape(-1, 3)
        pos = ijk * self.dp
        code = np.array([td.code_make(t, mk) for _, (t, mk, _n) in items],
                        dtype=np.int32)
        self.normals = np.array([n for _, (_t, _mk, n) in items],
                                dtype=np.float64).reshape(-1, 3)
        return pos, code


@dataclass
class Case:
    """A fully constructed runnable case (state on ``device``)."""
    csp: CteSph
    dom: cd.Domain
    state: SimState
    npb: int          # boundary particle count (fixed+moving)
    np_total: int
    meta: dict


def _make_state(csp: CteSph, pos, code, zsurf, *, device, need_verlet=False,
                need_sps=False, normals=None, capacity=None, vel=None):
    """Initial state: positions cast from f64 to f32, zero velocity unless
    ``vel`` (np,3) gives one (cast to f32), and
    hydrostatic density for fluid (GenCase ``rhopgradient=2``) evaluated in
    f32 as the JAX package does; boundaries and floating bodies start at
    rho0.  ``need_verlet`` adds the Verlet M1 state (the initial velocity
    and density); ``need_sps`` a zero SPS stress for laminar+SPS runs;
    ``normals`` (np,3) the mDBC normals, with a zero wall velocity.
    ``capacity`` (> np) adds spare slots after the drawn particles, the
    free pool of the inlet/outlet zones: FLUID | OUT_IGNORE at -1e6, rho0,
    ids np..capacity-1 (JAX `cases.py:604-640`)."""
    n = pos.shape[0]
    cap = capacity or n
    posf = np.full((cap, 3), -1e6, np.float64)
    posf[:n] = pos
    codef = np.full((cap,), td.code_make(td.TYPE_FLUID, 0,
                                         td.SPECIAL_OUT_IGNORE), np.int32)
    codef[:n] = code
    z = torch.tensor(pos[:, 2], dtype=torch.float32)
    rho_hyd = eos.hydrostatic_rho(csp, z, zsurf).numpy()
    rho = np.full((cap,), csp.rhopzero, np.float64)
    rho[:n] = np.where(td.code_type(code) == td.TYPE_FLUID, rho_hyd,
                       csp.rhopzero)
    f32 = dict(dtype=torch.float32, device=device)
    nrm = None
    if normals is not None:
        nrm = np.zeros((cap, 3), np.float64)
        nrm[:n] = normals
    vel0 = torch.zeros((cap, 3), **f32)
    if vel is not None:
        vel0[:n] = torch.from_numpy(np.asarray(vel, np.float32)).to(device)
    return SimState(
        pos=torch.tensor(posf, **f32),
        vel=vel0,
        rho=torch.tensor(rho, **f32),
        code=torch.tensor(codef, dtype=torch.int32, device=device),
        idp=torch.arange(cap, dtype=torch.int64, device=device),
        pose=torch.zeros((cap, 3), **f32),
        velm1=vel0.clone() if need_verlet else None,
        rhom1=torch.tensor(rho, **f32) if need_verlet else None,
        spstau=torch.zeros((cap, 6), **f32) if need_sps else None,
        boundnormal=None if nrm is None else torch.tensor(nrm, **f32),
        motionvel=None if nrm is None else torch.zeros((cap, 3), **f32),
    )


def _make_domain(csp: CteSph, pos, headroom=0.5):
    """Static cell grid from particle bounds + a 2*KernelSize halo + free-
    surface headroom as a fraction of the lattice height (the
    `<simulationdomain>` 'default + X%' idiom); in 2D one cell row spans
    y = pos[0,1] +- KernelSize/2."""
    ks = csp.kernelsize
    pmin = pos.min(axis=0) - 2 * ks
    pmax = pos.max(axis=0) + 2 * ks
    pmax[2] += headroom * (pos[:, 2].max() - pos[:, 2].min())
    if csp.simulate2d:
        pmin[1] = pos[0, 1] - ks / 2
        pmax[1] = pos[0, 1] + ks / 2
    return cd.make_domain(tuple(pmin), tuple(pmax), ks,
                          simulate2d=csp.simulate2d, skin=DOMAIN_SKIN)


def dambreak3d(dp=0.02, *, tank=(1.6, 0.67, 0.4), column=(0.4, 0.67, 0.3),
               obstacle=True, visco=0.1, need_verlet=False, need_sps=False,
               mdbc=False, device="cuda") -> Case:
    """3D dam break with optional building obstacle (CaseDambreak_Def.xml):
    coefsound 20, free-surface headroom 100% of the lattice height.
    ``visco`` is the viscosity constant (artificial alpha, or the kinematic
    viscosity under laminar+SPS); ``need_sps`` allocates the zero SPS stress
    that laminar+SPS reads; ``mdbc`` gives the walls their normals.  As in
    the JAX package, the constants are those of artificial viscosity
    (``spssmag = spsblin = 0``); a laminar+SPS run takes
    ``make_ctesph(..., tvisco=LAMINAR_SPS)`` constants, as an XML case's
    do.  ``need_verlet`` allocates the M1 state the Verlet step reads."""
    csp = make_ctesph(simulate2d=False, dp=dp, hswl=column[2], coefh=1.0,
                      visco=visco, coefsound=20.0)
    d = Draw(dp=dp)
    d.box((0, 0, 0), column, ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), tank, ptype=td.TYPE_FIXED, mk=0,
          faces="bottom|left|right|front|back")
    if obstacle:
        d.box((0.9, 0.24, 0.0), (1.02, 0.36, 0.45),
              ptype=td.TYPE_FIXED, mk=1, faces="top|left|right|front|back")
    pos, code = d.build()
    dom = _make_domain(csp, pos, headroom=1.0)
    st = _make_state(csp, pos, code, zsurf=column[2], device=device,
                     need_verlet=need_verlet, need_sps=need_sps,
                     normals=d.normals if mdbc else None)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="dambreak3d", dp=dp, zsurf=column[2]))


def coastal_runup3d(dp=0.02, *, length=8.0, width=2.0, depth=0.5,
                    slope_start=3.0, slope=0.1, wave_height=0.0,
                    need_sps=False, capacity=None, headroom=0.6,
                    device="cuda") -> Case:
    """3D coastal run-up (BASELINE.json config 5, the 10-50M-particle case;
    JAX `cases.py:830-930`): a flat offshore bed rising onto a plane beach,
    b(x) = max(0, (x - slope_start) * slope), fluid in b(x) <= z < depth +
    eta(x), three bed layers under it, and a back wall (x = 0) and two side
    walls three layers thick up to the water column's height, the fluid
    kept between them.  ``wave_height`` > 0 seeds a solitary hump eta(x)
    centred at 0.4 * slope_start with the velocity u = c * eta / (depth +
    eta) on its fluid (first-order Boussinesq, c = sqrt(g (depth +
    wave_height))), evaluated in float64 on the host as JAX does, so the
    case runs without a wavemaker.  Built with numpy over whole lattice
    planes, never a loop over particles; the JAX builder's ``cellcap``, a
    bucket capacity of the TPU layout, has no counterpart."""
    g = 9.81
    csp = make_ctesph(simulate2d=False, dp=dp, hswl=depth, coefh=1.0,
                      visco=0.05, coefsound=20.0)
    nx = int(round(length / dp)) + 1
    ny = int(round(width / dp)) + 1
    nz = int(round((depth + max(wave_height, 0.0) * 1.5) / dp)) + 4
    xs = np.arange(nx) * dp
    ys = np.arange(ny) * dp
    zs = np.arange(nz) * dp
    bed = np.maximum(0.0, (xs - slope_start) * slope)        # (nx,)
    X, Z = np.meshgrid(xs, zs, indexing="ij")                # (nx, nz)
    bedx = bed[:, None]
    eta = np.zeros_like(xs)
    x0 = slope_start * 0.4
    kk = np.sqrt(3.0 * wave_height / (4.0 * depth ** 3))
    if wave_height > 0:
        eta = wave_height / np.cosh(np.clip(kk * (xs - x0), -20, 20)) ** 2
    swl = depth + eta[:, None]
    fluid2d = (Z >= bedx - 1e-9) & (Z < swl - 1e-9)
    bound2d = (Z >= bedx - 3 * dp - 1e-9) & (Z < bedx - 1e-9)

    def expand(mask2d):
        """(nx, nz) mask -> (m*ny, 3) positions over every y."""
        ix, iz = np.nonzero(mask2d)
        out = np.empty((len(ix) * ny, 3))
        out[:, 0] = np.repeat(xs[ix], ny)
        out[:, 1] = np.tile(ys, len(ix))
        out[:, 2] = np.repeat(zs[iz], ny)
        return out

    pos_bed = expand(bound2d)
    pos_fl = expand(fluid2d)
    # the fluid between the walls: three lattice columns off each side wall
    # and off the back wall
    wallw = 3 * dp + 1e-9
    pos_fl = pos_fl[(pos_fl[:, 1] > wallw) & (pos_fl[:, 1] < width - wallw)
                    & (pos_fl[:, 0] > wallw)]
    zcol = depth + (wave_height * 1.5 if wave_height else 0.0) + 4 * dp
    zw = zs[zs < zcol]
    planes = [np.stack(np.meshgrid(xs[i:i + 1], ys, zw, indexing="ij"),
                       axis=-1).reshape(-1, 3) for i in range(3)]
    planes += [np.stack(np.meshgrid(xs, ys[j:j + 1], zw, indexing="ij"),
                        axis=-1).reshape(-1, 3)
               for j in list(range(3)) + list(range(ny - 3, ny))]
    side = np.concatenate(planes)
    # wall points below the bed's layers are dropped (the bed covers them)
    side = side[side[:, 2] >= np.maximum(
        0.0, (side[:, 0] - slope_start) * slope) - 3 * dp - 1e-9]
    bound = np.concatenate([pos_bed, side])
    # at 50M particles each (n, 3) float64 array is ~1.3 GB of host memory
    del pos_bed, side, planes
    bound = np.unique(np.round(bound / dp).astype(np.int64), axis=0) * dp
    pos = np.concatenate([bound, pos_fl])
    nbound = len(bound)
    del pos_fl, bound
    code = np.full(len(pos), td.code_make(td.TYPE_FLUID, 0), np.int32)
    code[:nbound] = td.code_make(td.TYPE_FIXED, 0)
    vel = None
    if wave_height > 0:
        c = np.sqrt(g * (depth + wave_height))
        etap = wave_height / np.cosh(np.clip(kk * (pos[:, 0] - x0),
                                             -20, 20)) ** 2
        vel = np.zeros((len(pos), 3), np.float32)
        vel[:, 0] = np.where(code == td.code_make(td.TYPE_FLUID, 0),
                             c * etap / (depth + etap), 0.0)
        del etap
    dom = _make_domain(csp, pos, headroom=headroom)
    st = _make_state(csp, pos, code, zsurf=depth, device=device,
                     need_sps=need_sps, capacity=capacity, vel=vel)
    return Case(csp=csp, dom=dom, state=st, npb=nbound, np_total=len(pos),
                meta=dict(name="coastal_runup3d", dp=dp, zsurf=depth))


def dambreak2d(dp=0.02, *, tank=(4.0, 3.0), column=(1.0, 2.0), visco=0.02,
               need_verlet=False, need_sps=False, mdbc=False,
               device="cuda") -> Case:
    """2D dam break (CaseDambreakVal2D_Def.xml geometry): a column of
    ``column`` (x, z) in a tank with bottom, left and right walls one
    particle thick; ``mdbc`` gives the walls their normals, ``need_verlet``
    the state its M1 arrays."""
    hswl = column[1]
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=hswl, coefh=1.0,
                      visco=visco, coefsound=20.0)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (column[0], 0, column[1]), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (tank[0], 0, tank[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|left|right")
    pos, code = d.build()
    dom = _make_domain(csp, pos)
    st = _make_state(csp, pos, code, zsurf=column[1], device=device,
                     need_verlet=need_verlet, need_sps=need_sps,
                     normals=d.normals if mdbc else None)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="dambreak2d", dp=dp, zsurf=column[1]))


def floatingbox2d(dp=0.02, *, tank=(2.0, 1.2), water=0.5,
                  box=(0.2, 0.2), box_pos=(0.9, 0.42), box_rho=500.0,
                  visco=0.05, ftpause=0.0, device="cuda") -> Case:
    """2D floating box in a water tank (the 'floating box in waves'
    family): a solid box of density ``box_rho`` drawn over the water, body
    0 of ``meta["ftcfg"]``, with its body state in ``state.ft``.  The walls
    carry no mDBC normals, as in the JAX package."""
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=water, coefh=1.0,
                      visco=visco, coefsound=20.0)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (tank[0], 0, water), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (tank[0], 0, tank[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|left|right")
    d.box((box_pos[0], 0, box_pos[1]),
          (box_pos[0] + box[0], 0, box_pos[1] + box[1]),
          ptype=td.TYPE_FLOATING, mk=0)
    pos, code = d.build()
    # the floating typecode's value is the body index
    isft = td.code_type(code) == td.TYPE_FLOATING
    ftcfg, ftstate = FT.make_floating([pos[isft]], [box_rho], csp,
                                      ftpause=ftpause, device=device)
    dom = _make_domain(csp, pos)
    st = _make_state(csp, pos, code, zsurf=water, device=device)
    st.ft = ftstate
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="floatingbox2d", dp=dp, zsurf=water,
                          ftcfg=ftcfg))


def channel2d(dp=0.02, *, length=0.6, height=0.2, vel=0.5, layers=3,
              t_horizon=2.0, device="cuda") -> Case:
    """2D open channel between an inlet at x = 0 and an outlet at x =
    ``length`` (the JAX package's ``channel2d``, the inlet/outlet family of
    the reference's examples/inletoutlet): zero gravity, a uniform inlet
    velocity, walls above and below that reach past both zones.  The fluid
    starts one dp inside each zone plane (the first member layer sits ON
    the plane).  The state's slots are the drawn particles,
    ``features.inout.slots_required`` over ``t_horizon`` and 256 more;
    ``meta["inout"]`` holds the zones, whose members ``init_inout``
    placed in the spare slots."""
    from ..features.inout import (InOutCfg, InOutZone, init_inout,
                                  slots_required)
    csp = make_ctesph(simulate2d=True, dp=dp, gravity=(0.0, 0.0, 0.0),
                      speedsound=20.0 * vel, visco=0.02)
    w = (layers + 2) * dp
    d = Draw(dp=dp, simulate2d=True)
    d.box((dp, 0, 0), (length - dp, 0, height), ptype=td.TYPE_FLUID, mk=0)
    d.box((-w, 0, -3 * dp), (length + w, 0, -dp), ptype=td.TYPE_FIXED, mk=0)
    d.box((-w, 0, height + dp), (length + w, 0, height + 3 * dp),
          ptype=td.TYPE_FIXED, mk=0)
    pos, code = d.build()
    inlet = InOutZone(p0=(0.0, 0.0, height / 2), direction=(1, 0, 0),
                      layers=layers, tangent1=(0, 0, 1), size1=height + dp,
                      vel_profile=(vel, 0.0, 0.0), rho_mode="constant")
    outlet = InOutZone(p0=(length, 0.0, height / 2), direction=(-1, 0, 0),
                       layers=layers, tangent1=(0, 0, 1), size1=height + dp,
                       vel_profile=(-vel, 0.0, 0.0), rho_mode="constant")
    iocfg = InOutCfg(zones=(inlet, outlet))
    cap = pos.shape[0] + slots_required(iocfg, csp, t_horizon) + 256
    dom = _make_domain(csp, pos)
    st = _make_state(csp, pos, code, zsurf=0.0, device=device, capacity=cap)
    st = init_inout(iocfg, csp, st)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="channel2d", dp=dp, inout=iocfg, vel=vel))


def periodic_channel2d(dp=0.04, *, length=0.8, depth=0.3, height=0.8,
                       ghost_cap=256, device="cuda") -> Case:
    """2D x-periodic channel: ``depth`` of water over a solid bed three
    particles thick, both ``length`` long, with no side walls (the JAX
    package's periodic geometry, `tests/test_periodic.py:19-34`; it has no
    builder).  ``meta["periodic"]`` holds the ``PeriodicCfg`` (period
    ``length``, ``ghost_cap`` ghosts a side); the state needs no ghost
    slots (``features/periodic.py``)."""
    from ..features.periodic import PeriodicCfg
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=depth, coefh=1.0,
                      visco=0.05, coefsound=20.0)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (length - dp, 0, depth), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, -3 * dp), (length - dp, 0, -dp), ptype=td.TYPE_FIXED, mk=0,
          faces="solid")
    pos, code = d.build()
    dom = _make_domain(csp, pos, headroom=height / depth)
    st = _make_state(csp, pos, code, zsurf=depth, device=device)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    pcfg = PeriodicCfg(axes=(True, False, False), lo=(0.0, 0.0, 0.0),
                       hi=(length, 0.0, 0.0), ghost_cap=ghost_cap)
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="periodic_channel2d", dp=dp, zsurf=depth,
                          periodic=pcfg))


def waveflume2d(dp=0.02, *, flume=(6.0, 1.0), water=0.4, piston_freq=0.8,
                piston_amp=0.1, visco=0.02, coefsound=20.0, need_verlet=False,
                mdbc=False, device="cuda") -> Case:
    """2D wave flume with a sinusoidal piston wavemaker (the JAX package's
    ``waveflume2d``): still water of depth ``water`` over a bottom, a right
    wall, and a piston (moving mk 10) at x < 0 as thick as the kernel's
    support, which ``meta["motion"]`` (``piston_sinusoidal``) drives.  The
    piston's stroke x = -amp ... amp reaches past the domain's halo of
    2*kernelsize behind it when amp exceeds it.  ``mdbc`` gives the bottom,
    the right wall and the piston's face toward the water their normals
    (the JAX builder has no such option); ``need_verlet`` the state its M1
    arrays."""
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=water, coefh=1.0,
                      visco=visco, coefsound=coefsound)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (flume[0], 0, water), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (flume[0], 0, flume[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|right")
    # the piston: a column of moving wall thick enough to cover the kernel's
    # support, so that fast strokes do not push fluid through it
    nlay = max(2, int(math.ceil(csp.kernelsize / dp)) + 1)
    d.box((-nlay * dp, 0, 0), (-dp, 0, flume[1]), ptype=td.TYPE_MOVING, mk=10)
    if mdbc:
        # the piston's face at x = -dp looks along +x, into the water
        for key, (ptype, mk, _n) in d.points.items():
            if ptype == td.TYPE_MOVING and key[0] == -1:
                d.points[key] = (ptype, mk, (dp, 0.0, 0.0))
    pos, code = d.build()
    dom = _make_domain(csp, pos)
    st = _make_state(csp, pos, code, zsurf=water, device=device,
                     need_verlet=need_verlet,
                     normals=d.normals if mdbc else None)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    motion = MOT.piston_sinusoidal(10, freq=piston_freq, amplitude=piston_amp)
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="waveflume2d", dp=dp, zsurf=water,
                          motion=motion))
