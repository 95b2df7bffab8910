"""Measurement gauges on the particle state, on torch tensors.

Counterpart of `dualsphysics_multilayer_tpu/features/gauges.py` (the
reference's `JDsGaugeSystem`, `JDsGaugeItem.h`, GPU kernels
`JDsGauge_ker.cu`):

* GaugeVel: the SPH-interpolated velocity at a point;
* GaugeSwl: the free-surface level along a segment (mass-sum threshold);
* GaugeMaxZ: the highest fluid particle near a vertical line;
* GaugeForce: the pressure force on the boundary particles of one mk.

The kernel sums at query points walk the neighbour rows of the points'
cells in a cell-sorted layout (``celldiv.point_ranges``).  A layout divided
when the particles stood elsewhere still holds every neighbour while the
skin contract holds: that is ``StepCarry.cells`` while
``StepCarry.rebuild`` is False, and :meth:`GaugeSystem.run` divides afresh
otherwise.  The readings go to the host: a gauge is a measurement,
recorded by the run loop at its own cadence (``Simulation.run``'s
sub-ticks).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import typesdef as td
from ..ops import celldiv as cd
from ..ops import eos
from ..ops import kernels as K


def _sph_sum(csp, dom, cells, state, points, with_vel=False,
             max_pairs: int = 1 << 18):
    """Kernel sums of the active fluid within ``kernelsize`` of each query
    point (m,3): ``masssum`` = sum m W, and with ``with_vel`` the Shepard
    sum of m W / rho and the velocity sum of m W / rho v."""
    m, f32 = points.shape[0], points.dtype
    pos = state.pos
    fluid = td.is_fluid(state.code) & td.is_active(state.code)
    out = dict(masssum=torch.zeros(m, dtype=f32, device=pos.device))
    if with_vel:
        out["shepard"] = torch.zeros(m, dtype=f32, device=pos.device)
        out["velsum"] = torch.zeros((m, 3), dtype=f32, device=pos.device)
    for t, j, valid in cd.range_chunks(*cd.point_ranges(dom, cells, points),
                                       max_pairs):
        dr = points[t, None, :] - pos[j]
        rr2 = (dr * dr).sum(dim=-1)
        pair = valid & fluid[j] & (rr2 <= csp.kernelsize2)
        wab = torch.where(pair, K.kernel_wab(
            csp, torch.where(pair, rr2, csp.kernelsize2)), 0.0)
        masswab = csp.massfluid * wab
        out["masssum"][t] = masswab.sum(dim=1)
        if with_vel:
            vol = masswab / state.rho[j]
            out["shepard"][t] = vol.sum(dim=1)
            out["velsum"][t] = (vol[..., None] * state.vel[j]).sum(dim=1)
    return out


def _points(pts, like):
    return torch.tensor(np.asarray(pts, np.float64), dtype=torch.float32,
                        device=like.device)


@dataclass(frozen=True)
class GaugeVel:
    """SPH velocity at a point (GAUGE_Vel, JDsGaugeItem.h:183)."""
    name: str
    point: tuple

    def compute(self, csp, dom, cells, state):
        s = _sph_sum(csp, dom, cells, state, _points([self.point], state.pos),
                     with_vel=True)
        shep = torch.clamp(s["shepard"], min=1e-6)
        return (s["velsum"] / shep[:, None])[0].cpu().numpy()


@dataclass(frozen=True)
class GaugeSwl:
    """Surface water level along a segment (GAUGE_Swl, JDsGaugeItem.h:249):
    sample points every ``pointdp``; the surface is the last point whose
    kernel mass sum reaches ``masslimit`` (0.5 rho0 when 0)."""
    name: str
    point0: tuple
    point2: tuple
    pointdp: float
    masslimit: float = 0.0

    def sample_points(self):
        """(the segment's sample points (k,3) f64, k)."""
        p0 = np.asarray(self.point0, np.float64)
        p2 = np.asarray(self.point2, np.float64)
        k = max(2, int(np.ceil(np.linalg.norm(p2 - p0) / self.pointdp)) + 1)
        return p0[None, :] + (p2 - p0)[None, :] * np.linspace(0, 1, k)[:, None], k

    def masses(self, csp, dom, cells, state):
        """The kernel mass sum at each sample point (host, f32)."""
        pts, _ = self.sample_points()
        return _sph_sum(csp, dom, cells, state,
                        _points(pts, state.pos))["masssum"].cpu().numpy()

    def compute(self, csp, dom, cells, state):
        p0 = np.asarray(self.point0, np.float64)
        p2 = np.asarray(self.point2, np.float64)
        _, k = self.sample_points()
        mass = self.masses(csp, dom, cells, state)
        # a submerged point sums to about rho0; the surface is where the sum
        # drops through half of that
        above = mass >= (self.masslimit or 0.5 * csp.rhopzero)
        if not above.any():
            return p0
        return p0 + (p2 - p0) * (np.where(above)[0].max() / (k - 1))


@dataclass(frozen=True)
class GaugeMaxZ:
    """Highest active fluid z within ``distlimit`` of a vertical line
    (GAUGE_MaxZ)."""
    name: str
    point0: tuple
    height: float
    distlimit: float

    def compute(self, csp, dom, cells, state):
        pos, code = state.pos, state.code
        p0 = self.point0
        d2 = (pos[:, 0] - p0[0]) ** 2 + (pos[:, 1] - p0[1]) ** 2
        sel = (td.is_fluid(code) & td.is_active(code)
               & (d2 <= self.distlimit ** 2) & (pos[:, 2] <= p0[2] + self.height))
        zmax = float(torch.where(sel, pos[:, 2], -torch.inf).max())
        return zmax if zmax > -np.inf else float(p0[2])


@dataclass(frozen=True)
class GaugeForce:
    """Pressure force on the boundary particles of one mk (GAUGE_Force,
    JDsGaugeItem.h:355): per boundary particle sum over fluid neighbours of
    -m_f (P1 + P2)/(rho1 rho2) gradW (`KerInteractionGaugeForce`,
    JDsGauge_ker.cu:311-368); F = massbound times their sum."""
    name: str
    mkbound: int

    def compute(self, csp, dom, cells, state, chunk=256):
        pos, code, rho = state.pos, state.code, state.rho
        act = td.is_active(code) & td.is_normal(code)
        bsel = act & td.is_bound(code) & (td.code_value(code) == self.mkbound)
        fsel = act & td.is_fluid(code)
        if not bool(bsel.any()) or not bool(fsel.any()):
            return np.zeros(3)
        press = eos.press_from_rho(csp, rho)
        bp, fp = pos[bsel], pos[fsel]
        brho, frho = rho[bsel], rho[fsel]
        bprs, fprs = press[bsel], press[fsel]
        force = torch.zeros(3, dtype=torch.float64, device=pos.device)
        # the boundary side in chunks keeps the (nb, nf) pair block small
        for i0 in range(0, bp.shape[0], chunk):
            b = slice(i0, i0 + chunk)
            dr = bp[b, None, :] - fp[None, :, :]
            rr2 = (dr * dr).sum(dim=-1)
            m = (rr2 <= csp.kernelsize2) & (rr2 >= 1e-18)
            fac = K.kernel_fac(csp, torch.where(m, rr2, csp.kernelsize2))
            prs = (bprs[b, None] + fprs[None, :]) / (brho[b, None] * frho[None, :])
            coef = torch.where(m, -prs * csp.massfluid * fac, 0.0)
            force += (coef[..., None] * dr).sum(dim=(0, 1)).double()
        return force.cpu().numpy() * csp.massbound

    def compute_from_forces(self, csp, state, ace):
        sel = (td.is_bound(state.code) & td.is_active(state.code)
               & (td.code_value(state.code) == self.mkbound))
        return ace[sel].sum(dim=0).cpu().numpy() * csp.massbound


class GaugeSystem:
    """Host-side gauge runner (`JGaugeSystem`).

    A gauge with a ``computedt`` ticks on its own grid start + k*computedt
    (``Simulation.run`` stops the steps at the next pending tick, see
    :meth:`next_time`); one without ticks at the save cadence, the
    reference's default computedt = TimeOut (`JDsGaugeItem.h:70-73`,
    `JDsGaugeSystem.cpp:447`)."""

    def __init__(self, csp, dom, gauges=(), windows=None, computedts=None):
        self.csp, self.dom = csp, dom
        self.gauges = list(gauges)
        self.history = {g.name: [] for g in gauges}
        # per-gauge <computetime start end> windows: {name: (start, end)}
        self.windows = dict(windows or {})
        # per-gauge <computedt> cadence: {name: dt}
        self.computedts = {k: v for k, v in (computedts or {}).items()
                           if v and v > 0}
        self._last = {}

    def _grid_start(self, name):
        w = self.windows.get(name)
        return w[0] if w is not None else 0.0

    def next_time(self, t):
        """The earliest pending computedt tick after t over all gauges (None
        when no gauge has a computedt, or all are past their windows)."""
        times = []
        for g in self.gauges:
            cdt = self.computedts.get(g.name)
            if not cdt:
                continue
            start = self._grid_start(g.name)
            k = max(0, int(np.floor((t - start) / cdt + 1e-9)) + 1)
            nx = start + k * cdt
            w = self.windows.get(g.name)
            if w is not None and nx > w[1] + 1e-12:
                continue
            times.append(nx)
        return min(times) if times else None

    def run(self, t, state, cells=None, at_save=True):
        """Compute the gauges due at time ``t`` on ``state``.  ``cells``: a
        layout of ``state`` that still holds every neighbour
        (``StepCarry.cells`` while ``StepCarry.rebuild`` is False); without
        one the state is divided afresh.  Returns {name: reading}."""
        out = {}
        for g in self.gauges:
            w = self.windows.get(g.name)
            if w is not None and not (w[0] <= t <= w[1]):
                continue
            cdt = self.computedts.get(g.name)
            if cdt:
                # due iff a grid tick start + k*cdt lies in (last, t]
                start = self._grid_start(g.name)
                tick = start + int(np.floor((t - start) / cdt + 1e-9)) * cdt
                last = self._last.get(g.name)
                if tick < start - 1e-12 or (last is not None
                                            and tick <= last + 1e-12):
                    continue
                self._last[g.name] = t
            elif not at_save:
                continue
            if cells is None:
                cells, code = cd.divide_cells(self.dom, state.pos, state.code)
                state = replace(state, code=code).permuted(cells.order)
            v = g.compute(self.csp, self.dom, cells, state)
            self.history[g.name].append((t, np.asarray(v)))
            out[g.name] = v
        return out

    def save_csv(self, dirout):
        os.makedirs(dirout, exist_ok=True)
        for name, rows in self.history.items():
            if not rows:
                continue
            with open(os.path.join(dirout, f"Gauge_{name}.csv"), "w") as f:
                f.write("time;values\n")
                for t, v in rows:
                    vv = np.atleast_1d(v).ravel()
                    f.write(f"{t};" + ";".join(f"{x:g}" for x in vv) + "\n")
