"""Multi-layer pistons on torch tensors: a moving boundary block whose
horizontal velocity varies with depth, from a (t, z) table.

Counterpart of `dualsphysics_multilayer_tpu/features/mlpiston.py` (the
reference's `JMLPistons`, XML `<mlayerpistons>`): each moving particle of
the block interpolates its layer velocity bilinearly in (t, z) and moves
with it.  `<piston1d>` drives the block with one table; `<piston2d>` holds
several columns at different y, and each particle interpolates linearly
between its two neighbouring columns.  ``smooth_table`` applies the
[1, 2, 1]/4 filter of ``smooth``/``smoothz``/``smoothy`` to a table when it
is loaded.  Times are 0-d device tensors; the tables are made once per
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import typesdef as td
from .devconst import vec as _vec


def _cell(grid, x, k):
    """(x clamped to the grid, index of its interval, fraction in it)."""
    x = torch.clamp(x, grid[0], grid[-1])
    i = torch.clamp(torch.searchsorted(grid, x.reshape(-1), right=True)
                    .reshape(x.shape) - 1, 0, k - 2)
    return i, (x - grid[i]) / torch.clamp(grid[i + 1] - grid[i], min=1e-12)


@dataclass(frozen=True)
class MLPiston1D:
    """Layered piston for one moving mk block."""
    mk: int
    times: tuple           # (nt,) sample times
    zlayers: tuple         # (nl,) layer centre elevations, ascending
    vels: tuple            # (nt*nl,) velocities, row-major (t, z)
    direction: tuple = (1.0, 0.0, 0.0)

    def velocity_at(self, t, z):
        """Bilinear (t, z) interpolation of the table: ``t`` 0-d, ``z``
        (n,)."""
        nt, nl = len(self.times), len(self.zlayers)
        v = _vec(self.vels, z).reshape(nt, nl)
        it, ft = _cell(_vec(self.times, z), t, nt)
        iz, fz = _cell(_vec(self.zlayers, z), z, nl)
        return ((1 - ft) * ((1 - fz) * v[it, iz] + fz * v[it, iz + 1])
                + ft * ((1 - fz) * v[it + 1, iz] + fz * v[it + 1, iz + 1]))


@dataclass(frozen=True)
class MLPiston2D:
    """Layered piston with velocity columns at several y positions
    (`<piston2d>`), interpolated linearly in y between neighbours."""
    mk: int
    cols: tuple            # MLPiston1D per <veldata>, ascending posy
    posy: tuple            # (ncol,) y of each column
    direction: tuple = (1.0, 0.0, 0.0)

    def velocity_at(self, t, y, z):
        if len(self.cols) == 1:
            return self.cols[0].velocity_at(t, z)
        vs = torch.stack([c.velocity_at(t, z) for c in self.cols])  # (ncol, n)
        i, f = _cell(_vec(self.posy, y), y, len(self.posy))
        lane = torch.arange(vs.shape[1], device=y.device)
        return (1 - f) * vs[i, lane] + f * vs[i + 1, lane]


def smooth_table(vals, passes, axis=-1):
    """[1, 2, 1]/4 smoothing along ``axis``, edges clamped, ``passes``
    times (the reference's smooth/smoothz/smoothy levels)."""
    v = np.asarray(vals, np.float64)
    if v.shape[axis] < 3:
        return v
    for _ in range(int(passes)):
        lo = np.take(v, [0], axis=axis)
        hi = np.take(v, [-1], axis=axis)
        vp = np.concatenate([lo, v, hi], axis=axis)
        n = v.shape[axis]
        v = (np.take(vp, range(0, n), axis=axis)
             + 2.0 * np.take(vp, range(1, n + 1), axis=axis)
             + np.take(vp, range(2, n + 2), axis=axis)) / 4.0
    return v


def load_mlpiston_csv(path, timedataini=0.0):
    """A layered-velocity CSV as (times (nt,), vels (nt, nl)): an optional
    header line, then rows ``time v_layer1 .. v_layerN`` ('#' comments;
    space, ';' or ',' separators).  ``timedataini`` shifts the series
    (`<timedataini>`)."""
    times, rows = [], []
    with open(path) as f:
        for line in f:
            toks = [t for t in line.split("#", 1)[0]
                    .replace(";", " ").replace(",", " ").split() if t]
            if not toks:
                continue
            try:
                vals = [float(t) for t in toks]
            except ValueError:
                continue        # the header
            times.append(vals[0])
            rows.append(vals[1:])
    if not rows:
        raise ValueError(f"mlpiston velocity file {path!r} has no data rows")
    nl = min(len(r) for r in rows)
    t = np.asarray(times, np.float64) + float(timedataini)
    order = np.argsort(t)
    return t[order], np.asarray([r[:nl] for r in rows], np.float64)[order]


def make_piston1d(mk, times, vels, zmin, zmax, *, incz=0.0, smooth=0,
                  direction=(1.0, 0.0, 0.0)) -> MLPiston1D:
    """An MLPiston1D whose layer centres split the piston's z extent
    [zmin, zmax] into equal bands, column 0 the bottom layer
    (`JMLPistons::PreparePiston`); ``incz`` offsets the bands."""
    vels = np.asarray(vels, np.float64)
    nl = vels.shape[1]
    if smooth:
        vels = smooth_table(vels, smooth, axis=1)
    if nl == 1:
        # one layer: two knots around its centre keep the table bilinear
        zc = 0.5 * (zmin + zmax) + incz
        zl = (zc - 1e-6, zc + 1e-6)
        vels = np.repeat(vels, 2, axis=1)
    else:
        band = (zmax - zmin) / nl
        zl = tuple(zmin + incz + band * (i + 0.5) for i in range(nl))
    return MLPiston1D(mk=mk, times=tuple(np.asarray(times, np.float64)),
                      zlayers=tuple(zl), vels=tuple(vels.reshape(-1)),
                      direction=tuple(direction))


def apply_mlpistons(pistons, tabs, dt, pos, vel, code):
    """Move each piston's particles with their layer velocity over dt
    (`JSphCpu::MovePiston1d/2d`).  Returns (pos, vel)."""
    if not pistons:
        return pos, vel
    moving = td.is_moving(code) & td.is_active(code)
    mkv = td.code_value(code)
    for p in pistons:
        sel = (moving & (mkv == p.mk))[:, None]
        if isinstance(p, MLPiston2D):
            vmag = p.velocity_at(tabs, pos[:, 1], pos[:, 2])
        else:
            vmag = p.velocity_at(tabs, pos[:, 2])
        pvel = vmag[:, None] * _vec(p.direction, pos)[None, :]
        pos = torch.where(sel, pos + pvel * dt, pos)
        vel = torch.where(sel, pvel, vel)
    return pos, vel
