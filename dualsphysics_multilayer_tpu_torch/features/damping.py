"""Velocity damping zones (numerical beaches) on torch tensors.

Counterpart of `dualsphysics_multilayer_tpu/features/damping.py` (the
reference's `JDsDamping`): inside a zone the fluid velocity is scaled by
``(1 - dt*redumax)^over`` per step, ``over`` ramping from 0 to 1 across the
zone, component-weighted by ``factorxyz``.  Zone shapes: a plane (with an
overlimit), a box and a cylinder.  Applied after the corrector
(`JSphCpuSingle.cpp:716-718`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import typesdef as td
from .devconst import vec as _vec


@dataclass(frozen=True)
class DampingPlane:
    """Damping between two parallel planes: full strength at the plane of
    ``limitpoint``, none at the plane of ``point`` (`JDsDamping_Plane`)."""
    point: tuple
    limitpoint: tuple
    overlimit: float = 0.0   # extra distance past the limit at full damping
    redumax: float = 10.0
    factorxyz: tuple = (1.0, 1.0, 1.0)

    def factor(self, pos):
        p0 = _vec(self.point, pos)
        nvec = _vec(self.limitpoint, pos) - p0
        dist = float(np.linalg.norm(np.asarray(self.limitpoint)
                                    - np.asarray(self.point)))
        nhat = nvec / max(dist, 1e-12)
        s = (pos - p0) @ nhat
        over = torch.clamp(s / dist, 0.0, 1.0)
        over = torch.where(s > dist + self.overlimit, 1.0, over)
        return torch.where(s > 0, over, 0.0)


@dataclass(frozen=True)
class DampingBox:
    """Damping ramping from an inner box to an outer box (`JDsDamping_Box`)."""
    boxmin1: tuple
    boxmax1: tuple      # inner box: no damping inside
    boxmin2: tuple
    boxmax2: tuple      # outer box: full damping outside
    redumax: float = 10.0
    factorxyz: tuple = (1.0, 1.0, 1.0)

    def factor(self, pos):
        bmin1, bmax1 = _vec(self.boxmin1, pos), _vec(self.boxmax1, pos)
        bmin2, bmax2 = _vec(self.boxmin2, pos), _vec(self.boxmax2, pos)
        # penetration past the inner box, normalised by the gap to the outer
        lo = torch.where(pos < bmin1,
                         (bmin1 - pos) / torch.clamp(bmin1 - bmin2, min=1e-12),
                         0.0)
        hi = torch.where(pos > bmax1,
                         (pos - bmax1) / torch.clamp(bmax2 - bmax1, min=1e-12),
                         0.0)
        over = torch.maximum(lo, hi).amax(dim=1)
        inside2 = ((pos >= bmin2) & (pos <= bmax2)).all(dim=1)
        return torch.where(inside2, torch.clamp(over, 0.0, 1.0), 1.0) \
            * (over > 0)


@dataclass(frozen=True)
class DampingCylinder:
    """Radial damping between two radii (`JDsDamping_Cylinder`)."""
    point1: tuple
    point2: tuple       # the cylinder's axis
    limitmin: float     # radius where damping starts
    limitmax: float     # radius of full damping
    redumax: float = 10.0
    factorxyz: tuple = (1.0, 1.0, 1.0)

    def factor(self, pos):
        p1 = np.asarray(self.point1, np.float64)
        ax = np.asarray(self.point2, np.float64) - p1
        ax = ax / max(np.linalg.norm(ax), 1e-12)
        axt = _vec(ax.tolist(), pos)
        rel = pos - _vec(p1.tolist(), pos)
        along = rel @ axt
        radial = rel - along[:, None] * axt
        r = torch.sqrt((radial * radial).sum(dim=1))
        over = (r - self.limitmin) / max(self.limitmax - self.limitmin, 1e-12)
        return torch.clamp(over, 0.0, 1.0)


def apply_damping(zones, dt, pos, vel, code):
    """vel *= 1 - factorxyz (1 - (1 - dt*redumax)^over) for the active
    fluid in each zone (`JDsDamping::ComputeDampingCpu`).  ``dt`` is a 0-d
    tensor."""
    if not zones:
        return vel
    fluid = td.is_fluid(code) & td.is_active(code)
    for z in zones:
        over = z.factor(pos)
        fdamp = torch.pow(torch.clamp(1.0 - dt * z.redumax, 0.0, 1.0), over)
        fxyz = _vec(z.factorxyz, pos)
        scale = 1.0 - fxyz[None, :] * (1.0 - fdamp[:, None])
        vel = torch.where((fluid & (over > 0))[:, None], vel * scale, vel)
    return vel
