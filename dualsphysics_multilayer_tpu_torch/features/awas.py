"""Active wave absorption (AWAS) for piston wavemakers, every step, on
torch tensors.

Counterpart of `dualsphysics_multilayer_tpu/features/awas.py` (the
reference's `JWaveAwasZsurf`, XML `<awas_zsurf>`): each step the free
surface just in front of the paddle is measured and compared with the
target wave; the velocity correction

    u_c = gain * sqrt(g / depth) * (eta_target(t) - eta_measured)

moves the paddle on top of its scripted motion, and the accumulated
correction displacement of each paddle rides in the step carry
(``StepCarry.awas``).  The elevation is the fluid mass in a band around
the gauge's x, over rho0 times the band's width: a masked sum with no
neighbour search, and no read back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import typesdef as td
from ..typesdef import CteSph
from .devconst import vec as _vec


@dataclass(frozen=True)
class AwasZsurf:
    """AWAS configuration for one piston paddle (moving mk ``mk``)."""
    mk: int
    height: float            # target wave height H
    period: float            # wave period T
    depth: float             # water depth at the paddle
    swl: float               # still-water level (z of the free surface)
    gauge_x: float           # gauge x position, in front of the paddle
    start: float = 0.0       # time to start correcting
    gain: float = 1.0
    phase: float = 0.0       # paddle phase (piston x ~ sin(wt + phase))
    direction: tuple = (1.0, 0.0, 0.0)
    band: float = 0.0        # gauge band half-width (0: 1.5 dp)
    z0: float = 0.0          # bed elevation below the gauge

    def eta_target(self, t):
        """1st-order target elevation at the paddle face,
        H/2 sin(wt + phase)."""
        w = 2.0 * math.pi / self.period
        return 0.5 * self.height * torch.sin(w * t + self.phase)


def measure_eta(cfg: AwasZsurf, csp: CteSph, pos, code):
    """Column-mass surface elevation at the gauge, above the SWL (0-d)."""
    dp = csp.dp
    band = cfg.band or 1.5 * dp
    fluid = td.is_fluid(code) & td.is_active(code)
    inband = fluid & ((pos[:, 0] - cfg.gauge_x).abs() <= band)
    if csp.simulate2d:
        colarea = 2.0 * band          # per unit y
        mass_per = dp ** 2            # volume per particle per unit y
    else:
        # a dp-wide y band through the gauge line
        inband = inband & ((pos[:, 1] - 0.0).abs() <= 0.5 * dp)
        colarea = 2.0 * band * dp
        mass_per = dp ** 3
    h_col = torch.where(inband, mass_per, 0.0).sum() / colarea
    return h_col - (cfg.swl - cfg.z0)


def apply_awas(cfgs, csp: CteSph, corr, tabs, dt, pos, vel, code, g=9.81):
    """One AWAS update of every paddle: ``corr`` (P,) holds the accumulated
    correction displacements.  Returns (pos, vel, corr)."""
    moving = td.is_moving(code) & td.is_active(code)
    mkv = td.code_value(code)
    new_corr = []
    for i, cfg in enumerate(cfgs):
        eta = measure_eta(cfg, csp, pos, code)
        uc = cfg.gain * math.sqrt(g / cfg.depth) * (cfg.eta_target(tabs) - eta)
        uc = torch.where(tabs >= cfg.start, uc, 0.0)
        d = _vec(cfg.direction, pos)
        sel = (moving & (mkv == cfg.mk))[:, None]
        pos = torch.where(sel, pos + (uc * dt) * d[None, :], pos)
        vel = torch.where(sel, vel + uc * d[None, :], vel)
        new_corr.append(corr[i] + uc * dt)
    return pos, vel, torch.stack(new_corr)
