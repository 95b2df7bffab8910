"""Equation of state (Tait / Monaghan 1994, `FunSphEos.h:38-64`) on torch
tensors: ``press = b*((rho/rho0)^gamma - 1)`` and its inverse."""

from __future__ import annotations

import torch

from ..typesdef import CteSph


def press_from_rho(csp: CteSph, rho):
    return csp.cteb * ((rho / csp.rhopzero) ** csp.gamma - 1.0)


def rho_from_press(csp: CteSph, press):
    return csp.rhopzero * (press / csp.cteb + 1.0) ** (1.0 / csp.gamma)


def hydrostatic_rho(csp: CteSph, z, z_surface):
    """Initial hydrostatic density below a free surface at ``z_surface``
    (GenCase ``rhopgradient=2``): p = rho0*g*(z_surf - z) through the inverse
    EOS."""
    g = abs(csp.gravity[2])
    press = csp.rhopzero * g * torch.clamp(z_surface - z, min=0.0)
    return rho_from_press(csp, press)
