"""SPH smoothing kernels on torch tensors (`FunSphKernel.h`): Wendland C2
and the cubic spline, counterparts of `dualsphysics_multilayer_tpu/ops/
kernels.py`.

``wab`` is W(r); ``fac`` is (1/r) dW/dr, so the kernel gradient is
``fac * dr``.  Safe at rr2 == 0 (callers mask dead pairs by ``ALMOSTZERO``).
"""

from __future__ import annotations

import torch

from ..typesdef import CteSph, TpKernel

_EPS = 1e-30  # guards 0/0 at rr2==0; such pairs are always masked by callers


def wendland_wab(csp: CteSph, rr2):
    qq = torch.sqrt(rr2) / csp.kernelh
    wqq1 = 1.0 - 0.5 * qq
    wqq2 = wqq1 * wqq1
    return csp.kwend.awen * (2.0 * qq + 1.0) * wqq2 * wqq2


def wendland_fac(csp: CteSph, rr2):
    rad = torch.sqrt(rr2)
    qq = rad / csp.kernelh
    wqq1 = 1.0 - 0.5 * qq
    return csp.kwend.bwen * qq * wqq1 * wqq1 * wqq1 / torch.clamp(rad, min=_EPS)


def cubic_wab(csp: CteSph, rr2):
    kc = csp.kcubic
    rad = torch.sqrt(rr2)
    qq = rad / csp.kernelh
    wqq1 = 2.0 - qq
    outer = kc.a24 * (wqq1 * wqq1 * wqq1)
    inner = kc.a2 * (1.0 + (0.75 * qq - 1.5) * (qq * qq))
    return torch.where(rad > csp.kernelh, outer, inner)


def cubic_fac(csp: CteSph, rr2):
    kc = csp.kcubic
    rad = torch.sqrt(rr2)
    qq = rad / csp.kernelh
    wqq1 = 2.0 - qq
    outer = kc.c2 * wqq1 * wqq1
    inner = kc.c1 * qq + kc.d1 * qq * qq
    return torch.where(rad > csp.kernelh, outer, inner) / torch.clamp(rad, min=_EPS)


def cubic_tensil(csp: CteSph, rr2, rhop1, press1, rhop2, press2):
    """Cubic-spline tensile correction (`FunSphKernel.h:138-150`), added to
    the pressure term (p1 + p2)/(rho1*rho2)."""
    fab = cubic_wab(csp, rr2) * csp.kcubic.od_wdeltap
    fab = fab * fab
    fab = fab * fab  # fab^4
    t1 = (press1 / (rhop1 * rhop1)) * torch.where(press1 > 0, 0.01, -0.2)
    t2 = (press2 / (rhop2 * rhop2)) * torch.where(press2 > 0, 0.01, -0.2)
    return fab * (t1 + t2)


def kernel_wab(csp: CteSph, rr2):
    if csp.tkernel == TpKernel.WENDLAND:
        return wendland_wab(csp, rr2)
    return cubic_wab(csp, rr2)


def kernel_fac(csp: CteSph, rr2):
    if csp.tkernel == TpKernel.WENDLAND:
        return wendland_fac(csp, rr2)
    return cubic_fac(csp, rr2)
