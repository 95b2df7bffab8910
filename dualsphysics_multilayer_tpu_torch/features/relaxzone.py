"""Relaxation zones on torch tensors: the fluid velocity inside a zone is
blended toward an analytic wave, a current or external data.

Counterpart of `dualsphysics_multilayer_tpu/features/relaxzone.py` (the
reference's `JRelaxZones`, GPU kernels `JRelaxZone_ker.cu`): inside a zone

    v <- f * v_target + (1 - f) * v_sph,

with the tanh bump weight over the normalised distance ``vdis`` in [-1, 1]
(`JRelaxZone_ker.cu:161-162`), 1 at the zone's centre and 0 at its edges,
times ``min(coefdt * dt, 1)``.  The four zones:

* ``RelaxZoneRegular``: 1st/2nd-order regular wave velocities with optional
  Stokes-drift compensation (`KerCalcVelocityX/Z`);
* ``RelaxZoneSpectrum``: an irregular JONSWAP / Pierson-Moskowitz component
  sum (`KerCalcVelxzSpectrum`), components from
  ``wavegen.spectrum_components``;
* ``RelaxZoneExternal``: velocities on a (t, x, z) grid (``GridVel``, the
  JAX package's ``inout.InOutGridVel`` sampler);
* ``RelaxZoneUniform``: a constant or time-tabled velocity in a box,
  axis-aligned or rotated.

Applied after the corrector (`JSphCpuSingle.cpp:715-718`).  Times are 0-d
device tensors; the zones' constants are made once per device.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from .. import typesdef as td
from ..typesdef import CteSph
from .devconst import vec as _vec


def _fweight(vdis, falpha=0.9, fbeta=1.0):
    """The tanh bump weight (JRelaxZone_ker.cu:161): 1 at vdis = 0, 0 at
    |vdis| = 1."""
    a, b = falpha, fbeta
    fsub = math.tanh((1 + a) * b) - math.tanh((1 - a) * b)
    fdiv = math.tanh(a * b) - math.tanh(-a * b) - fsub
    f = (torch.tanh((vdis + a) * b) - torch.tanh((vdis - a) * b) - fsub) / fdiv
    return torch.clamp(f, 0.0, 1.0)


def _window(tabs, start, duration):
    """Active-time gate: start <= t (<= start + duration when duration > 0)."""
    on = tabs >= start
    if duration > 0:
        on = on & (tabs <= start + duration)
    return on


def _interp(x, xp, fp):
    """Linear interpolation of the table (xp, fp) at the 0-d ``x``, held at
    the end values outside it (``jnp.interp``)."""
    k = xp.shape[0]
    if k == 1:
        return fp[0]
    xc = torch.clamp(x, xp[0], xp[-1])
    i = torch.clamp(torch.searchsorted(xp, xc.reshape(1), right=True)[0],
                    1, k - 1)
    dx = xp[i] - xp[i - 1]
    f = torch.where(dx == 0, fp[i],
                    fp[i - 1] + ((xc - xp[i - 1]) / dx) * (fp[i] - fp[i - 1]))
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], f))


def _gated_weight(zone, vdis, inside, tabs):
    f = torch.where(inside, _fweight(vdis, zone.falpha, zone.fbeta), 0.0)
    return torch.where(_window(tabs, zone.start, zone.duration), f, 0.0)


@dataclass(frozen=True)
class RelaxZoneUniform:
    """Blend toward a constant or time-tabled velocity inside a box
    (`KerSetFluidVelUniform`, JRelaxZone_ker.cu:58; XML `<rz_uniform>`)."""
    pmin: tuple
    pmax: tuple
    vel: tuple = (0.0, 0.0, 0.0)
    veltimes: tuple = ()       # velocitytimes table: times
    velvalues: tuple = ()      # velocitytimes table: speeds along direction
    direction: tuple = (1.0, 0.0, 0.0)
    axis: int = 0              # the blend coordinate axis
    falpha: float = 0.9
    fbeta: float = 1.0
    coefdt: float = 1000.0
    start: float = 0.0
    duration: float = 0.0
    # a rotated box: unit axes and their extents, pmin its origin corner
    axes: tuple = None
    sizes: tuple = None

    def target_and_weight(self, csp, pos, tabs):
        inside = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
        if self.axes is not None:
            org = _vec(self.pmin, pos)
            for ax in range(3):
                if csp.simulate2d and ax == 1:
                    continue
                d = (pos - org) @ _vec(self.axes[ax], pos)
                inside = inside & (d >= 0.0) & (d <= self.sizes[ax])
            half = max(0.5 * self.sizes[self.axis], 1e-12)
            cen = org + 0.5 * sum(self.sizes[i] * _vec(self.axes[i], pos)
                                  for i in range(3))
            dirn = _vec(self.direction, pos)
            dirn = dirn / torch.clamp(torch.linalg.norm(dirn), min=1e-12)
            vdis = ((pos - cen) @ dirn) / half
        else:
            for ax in range(3):
                if csp.simulate2d and ax == 1:
                    continue
                inside = inside & (pos[:, ax] >= self.pmin[ax]) \
                    & (pos[:, ax] <= self.pmax[ax])
            c = 0.5 * (self.pmin[self.axis] + self.pmax[self.axis])
            half = max(0.5 * (self.pmax[self.axis] - self.pmin[self.axis]),
                       1e-12)
            vdis = (pos[:, self.axis] - c) / half
        f = _gated_weight(self, vdis, inside, tabs)
        if self.veltimes:
            sp = _interp(tabs, _vec(self.veltimes, pos),
                         _vec(self.velvalues, pos))
            tgt = (sp * _vec(self.direction, pos)).expand_as(pos)
        else:
            tgt = _vec(self.vel, pos).expand_as(pos)
        return tgt, f


@dataclass(frozen=True)
class RelaxZoneRegular:
    """Blend toward a 1st/2nd-order regular wave (`KerSetFluidVel` +
    `KerCalcVelocityX/Z`, JRelaxZone_ker.cu:113-176; XML
    `<rzwaves_regular>`)."""
    center: tuple             # central point (x0, y0, z0)
    width: float              # zone width: center +- width/2
    height: float             # wave height H
    period: float             # wave period T
    depth: float              # water depth d
    swl: float = 0.0          # still-water level (absolute z)
    order2: bool = False      # 2nd-order Stokes term
    phase: float = 0.0
    ramp: float = 0.0         # periods of the initial ramp
    coefdir: tuple = (1.0, 0.0, 0.0)
    coefdt: float = 1000.0
    falpha: float = 0.9
    fbeta: float = 1.0
    driftcorrection: float = 0.0
    start: float = 0.0
    duration: float = 0.0
    g: float = 9.81

    def target_and_weight(self, csp, pos, tabs):
        from .wavegen import dispersion_k
        k = dispersion_k(self.period, self.depth, self.g)
        w = 2.0 * math.pi / self.period
        half = max(0.5 * self.width, 1e-12)
        px = pos[:, 0] - self.center[0]
        vdis = px / half
        tw = torch.clamp(tabs - self.start, min=0.0)
        framp = torch.clamp(tw / (self.ramp * self.period), 0.0, 1.0) \
            if self.ramp > 0 else 1.0
        z = pos[:, 2] - self.swl          # z = 0 at the SWL
        cta = w * tw + self.phase
        sinh_kd = math.sinh(k * self.depth)
        wpf = 0.5 * self.height * w
        coshz = torch.cosh(k * (self.depth + z))
        sinhz = torch.sinh(k * (self.depth + z))
        u = wpf * coshz * torch.cos(cta - k * px) / sinh_kd
        wv = -wpf * sinhz * torch.sin(cta - k * px) / sinh_kd
        if self.order2:
            L = 2.0 * math.pi / k
            ce = self.g * self.period / (2.0 * math.pi) \
                * math.tanh(k * self.depth)
            ct2 = 0.75 * (math.pi * self.height / L) ** 2 * ce
            s4 = sinh_kd ** 4
            u = u + ct2 * torch.cosh(2 * k * (self.depth + z)) \
                * torch.cos(2 * cta - 2 * k * px) / s4
            wv = wv - ct2 * torch.sinh(2 * k * (self.depth + z)) \
                * torch.sin(2 * cta - 2 * k * px) / s4
        if self.driftcorrection:
            ce = w / k
            ctd = self.driftcorrection * (0.5 * k * self.height) ** 2 \
                * ce / (2.0 * sinh_kd ** 2)
            u = u - ctd * torch.cosh(2.0 * k * (self.depth + z))
        u = u * framp
        wv = wv * framp
        # coefdir scales the horizontal orbital velocity; the vertical one
        # has no direction
        tgt = torch.stack([u * self.coefdir[0], u * self.coefdir[1], wv],
                          dim=-1)
        return tgt, _gated_weight(self, vdis, vdis.abs() <= 1.0, tabs)


@dataclass(frozen=True)
class RelaxZoneSpectrum:
    """Blend toward an irregular wave field (`KerSetFluidVelSpectrumSub` +
    `KerCalcVelxzSpectrum`, JRelaxZone_ker.cu:215-330; XML
    `<rzwaves_spectrum>`).  Build it with :func:`make_spectrum_zone`."""
    center: tuple
    width: float
    height: float             # significant wave height Hs
    period: float             # peak period Tp
    depth: float
    swl: float = 0.0
    spectrum: str = "jonswap"          # jonswap | pierson-moskowitz
    discretization: str = "stretched"  # regular|random|stretched|cosstretched
    peakcoef: float = 3.3
    waves: int = 50
    randomseed: int = 2
    serieini: float = 0.0
    ramptime: float = 0.0
    coefdir: tuple = (1.0, 0.0, 0.0)
    coefdt: float = 1000.0
    falpha: float = 0.9
    fbeta: float = 1.0
    driftcorrection: float = 0.0
    start: float = 0.0
    duration: float = 0.0
    g: float = 9.81
    # the component tables (make_spectrum_zone fills them)
    comp_k: tuple = ()
    comp_amp: tuple = ()
    comp_w: tuple = ()
    comp_phase: tuple = ()

    def target_and_weight(self, csp, pos, tabs):
        half = max(0.5 * self.width, 1e-12)
        px = pos[:, 0] - self.center[0]
        vdis = px / half
        tw = torch.clamp(tabs - self.start, min=0.0) + self.serieini
        framp = torch.clamp((tw - self.serieini) / self.ramptime, 0.0, 1.0) \
            if self.ramptime > 0 else 1.0
        z = pos[:, 2] - self.swl
        kl = _vec(self.comp_k, pos)                          # (C,)
        waf = _vec(self.comp_amp, pos) * _vec(self.comp_w, pos)
        wf = _vec(self.comp_w, pos)
        ph = _vec(self.comp_phase, pos)
        dz = self.depth + z[:, None]                         # (n, 1)
        sinh_kd = torch.sinh(kl * self.depth)                # (C,)
        wft = wf * tw - kl * px[:, None] - ph                # (n, C)
        u = (waf * torch.cosh(kl * dz) * torch.cos(wft) / sinh_kd).sum(dim=1)
        wv = -(waf * torch.sinh(kl * dz) * torch.sin(wft) / sinh_kd).sum(dim=1)
        if self.driftcorrection:
            amp = _vec(self.comp_amp, pos)
            ce = wf / torch.clamp(kl, min=1e-12)
            ctd = self.driftcorrection * (kl * amp) ** 2 * ce \
                / (2.0 * sinh_kd ** 2)
            u = u - (ctd * torch.cosh(2.0 * kl * dz)).sum(dim=1)
        u = u * framp
        wv = wv * framp
        tgt = torch.stack([u * self.coefdir[0], u * self.coefdir[1], wv],
                          dim=-1)
        return tgt, _gated_weight(self, vdis, vdis.abs() <= 1.0, tabs)


def make_spectrum_zone(**kw) -> RelaxZoneSpectrum:
    """A RelaxZoneSpectrum with its component tables discretised from the
    spectrum (wavegen.spectrum_components and the dispersion relation)."""
    from .wavegen import dispersion_k, spectrum_components
    zone = RelaxZoneSpectrum(**kw)
    spec = "jonswap" if zone.spectrum.lower().startswith("j") \
        else "pierson-moskowitz"
    fc, amps, phases = spectrum_components(
        spectrum=spec, discretization=zone.discretization,
        hs=zone.height, tp=zone.period, nwaves=zone.waves,
        peakcoef=zone.peakcoef, seed=zone.randomseed, g=zone.g)
    ks = [dispersion_k(1.0 / f, zone.depth, zone.g) for f in fc]
    ws = [2.0 * math.pi * f for f in fc]
    return dataclasses.replace(zone, comp_k=tuple(ks), comp_amp=tuple(amps),
                               comp_w=tuple(ws), comp_phase=tuple(phases))


@dataclass(frozen=True)
class GridVel:
    """Velocities on a time x (x, z) grid (the reference's
    `JSphInOutGridData`, the JAX package's ``inout.InOutGridVel``): tuples
    of ``velx`` (and ``velz``, or ()) row-major [t][z][x]."""
    times: tuple                # (T,) increasing
    nx: int
    nz: int
    dpx: float
    dpz: float
    posmin: tuple = (0.0, 0.0)  # grid origin (x0, z0)
    velx: tuple = ()
    velz: tuple = ()
    velcorr: float = 0.0        # subtracted from velx

    def at(self, pos, tabs):
        """Time-linear and (x, z)-bilinear sample at the positions, clamped
        to the grid (InterpolateVelCpu, JSphInOutGridData.cpp:349-420)."""
        T = len(self.times)
        times = _vec(self.times, pos)
        vx = _vec(self.velx, pos).reshape(T, self.nz, self.nx)
        it = torch.clamp(torch.searchsorted(times, tabs.reshape(1),
                                            right=True)[0] - 1, 0, T - 1)
        it2 = torch.clamp(it + 1, max=T - 1)
        dt_ = times[it2] - times[it]
        ft = torch.where(dt_ > 0, (tabs - times[it]) / torch.clamp(dt_, min=1e-30),
                         0.0)
        ft = torch.clamp(ft, 0.0, 1.0)
        px = (pos[:, 0] - self.posmin[0]) / self.dpx
        pz = (pos[:, 2] - self.posmin[1]) / self.dpz
        cx = torch.clamp(torch.floor(px).long(), 0, self.nx - 1)
        cz = torch.clamp(torch.floor(pz).long(), 0, self.nz - 1)
        cx2 = torch.clamp(cx + 1, max=self.nx - 1)
        cz2 = torch.clamp(cz + 1, max=self.nz - 1)
        fx = torch.clamp(px - cx, 0.0, 1.0)
        fz = torch.clamp(pz - cz, 0.0, 1.0)

        def sample(g):
            return ((1 - fz) * ((1 - fx) * g[cz, cx] + fx * g[cz, cx2])
                    + fz * ((1 - fx) * g[cz2, cx] + fx * g[cz2, cx2]))

        outx = sample((1.0 - ft) * vx[it] + ft * vx[it2]) - self.velcorr
        if self.velz:
            vz = _vec(self.velz, pos).reshape(T, self.nz, self.nx)
            outz = sample((1.0 - ft) * vz[it] + ft * vz[it2])
        else:
            outz = torch.zeros_like(outx)
        return outx, outz


def load_gridvel(path, posmin=(0.0, 0.0), velcorr=0.0) -> GridVel:
    """Read a gridveldata CSV (JSphInOutGridData::LoadDataCsv; the JAX
    package's ``inout.load_inout_gridvel``): header rows fmtversion /
    grid_dpx;grid_dpz;grid_nx;grid_nz;vars, then one row per time:
    t;velx[nx*nz]...(;velz[nx*nz]...)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                rows.append([p for p in line.replace(";", " ").replace(
                    ",", " ").split() if p])
    head = {k.lower(): i for i, k in enumerate(rows[0])}
    if "fmtversion" not in head:
        raise ValueError(f"{path}: fmtversion header missing")
    vals = rows[1]
    dpx = float(vals[head["grid_dpx"]])
    dpz = float(vals[head["grid_dpz"]])
    nx = int(float(vals[head["grid_nx"]]))
    nz = int(float(vals[head["grid_nz"]]))
    # vars may take the remaining columns ("velx velz" splits in two)
    varcols = rows[0][head["vars"]:]
    usevelz = any("velz" in " ".join(r[head["vars"]:]).lower()
                  for r in rows[:2]) or "velz" in " ".join(varcols).lower()
    npt = nx * nz
    times, vxs, vzs = [], [], []
    for r in rows[2:]:
        if len(r) < 1 + npt * (2 if usevelz else 1):
            continue
        times.append(float(r[0]))
        vxs.extend(float(x) for x in r[1:1 + npt])
        if usevelz:
            vzs.extend(float(x) for x in r[1 + npt:1 + 2 * npt])
    if not times:
        raise ValueError(f"{path}: no time rows parsed")
    return GridVel(times=tuple(times), nx=nx, nz=nz, dpx=dpx, dpz=dpz,
                   posmin=tuple(posmin), velx=tuple(vxs), velz=tuple(vzs),
                   velcorr=velcorr)


@dataclass(frozen=True)
class RelaxZoneExternal:
    """Blend toward external (SWASH) velocity data on a (t, x, z) grid
    (`KerSetFluidVelExternal`, JRelaxZone_ker.cu:374; XML
    `<rzwaves_external_1d>`)."""
    center: tuple
    width: float
    grid: GridVel
    depth: float = 0.0
    swl: float = 0.0
    usevelz: bool = False
    coefdir: tuple = (1.0, 0.0, 0.0)
    coefdt: float = 1000.0
    falpha: float = 0.9
    fbeta: float = 1.0
    driftcorrection: float = 0.0
    driftinitialramp: float = 0.0
    start: float = 0.0
    duration: float = 0.0

    def target_and_weight(self, csp, pos, tabs):
        half = max(0.5 * self.width, 1e-12)
        vdis = (pos[:, 0] - self.center[0]) / half
        vx, vz = self.grid.at(pos, tabs)
        if not self.usevelz:
            vz = torch.zeros_like(vx)
        tgt = torch.stack([vx * self.coefdir[0], vx * self.coefdir[1], vz],
                          dim=-1)
        return tgt, _gated_weight(self, vdis, vdis.abs() <= 1.0, tabs)


def apply_relaxzones(zones, csp: CteSph, tabs, pos, vel, code, dt=None):
    """Blend every zone into the velocity of the normal fluid particles
    (the post-corrector hook).  With ``dt`` the blend is a rate: the
    applied fraction is f * min(coefdt * dt, 1) (coefdt = 0: f)."""
    fluid = td.is_fluid(code) & td.is_normal(code)
    for zn in zones:
        tgt, f = zn.target_and_weight(csp, pos, tabs)
        if dt is not None and zn.coefdt:
            f = f * torch.clamp(zn.coefdt * dt, max=1.0)
        f = torch.where(fluid, f, 0.0)[:, None]
        vel = vel * (1.0 - f) + tgt * f
    return vel
