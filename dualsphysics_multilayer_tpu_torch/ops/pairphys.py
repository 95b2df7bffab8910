"""Per-pair WCSPH physics on torch tensors: the plain version of the pair
body that `csrc/pairbody.cuh` implements for the GPU.

Counterpart of `dualsphysics_multilayer_tpu/ops/pairphys.py` (reference
`JSphCpu.cpp:631-822`): momentum (pressure, plus the tensile correction of
the cubic spline), continuity, every density diffusion mode under DBC or
mDBC walls, artificial or laminar+SPS viscosity and the shifting
accumulators.  Callers lay pairs out
as they like, build broadcast per-pair inputs, call :func:`pair_terms` and
reduce over their candidate axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import typesdef as td
from ..typesdef import (CteSph, TpBoundary, TpDensity, TpKernel, TpShifting,
                        TpVisco)
from . import kernels as K


@dataclass
class PairInputs:
    """Broadcast per-pair fields.  Index 1 = target, 2 = candidate."""
    dr: torch.Tensor          # (...,3) r1 - r2
    rr2: torch.Tensor
    pair: torch.Tensor        # bool: the pair interacts at all
    dv: torch.Tensor          # (...,3) v1 - v2
    mass2: torch.Tensor
    rho1: torch.Tensor
    rho2: torch.Tensor
    press1: torch.Tensor
    press2: torch.Tensor
    bound_t: torch.Tensor     # bool: target is boundary (fixed/moving)
    bound_c: torch.Tensor     # bool: candidate is boundary
    ft_t: torch.Tensor        # bool: target is floating
    ft_c: torch.Tensor        # bool: candidate is floating
    fixed_c: torch.Tensor     # bool: candidate is fixed boundary
    tau_t: torch.Tensor | None = None   # (...,6) target SPS stress (laminar+SPS)
    tau_c: torch.Tensor | None = None   # (...,6) candidate SPS stress


@dataclass
class PairTerms:
    """Per-pair contributions; reduce over the candidate axis.
    ``delta_blocked`` and ``shift_blocked`` are per-pair markers to be
    any-reduced."""
    ace: torch.Tensor
    ar: torch.Tensor
    delta: torch.Tensor | None
    delta_blocked: torch.Tensor | None
    shift: torch.Tensor | None          # (...,4) with shifting
    shift_blocked: torch.Tensor | None
    gradvel: torch.Tensor | None        # (...,6) with laminar+SPS
    visc: torch.Tensor        # per-pair dot_rr2, -FLT_MAX outside pairs


FLT_MAX = 3.4e38


def pair_terms(csp: CteSph, opts, p: PairInputs) -> PairTerms:
    if opts.tvisco not in (TpVisco.ARTIFICIAL, TpVisco.LAMINAR_SPS):
        raise NotImplementedError(f"pair_terms: tvisco={opts.tvisco.name}")
    f32 = p.dr.dtype
    cbar = csp.cs0
    ddtkh = csp.ddtkh
    pw = p.pair.to(f32)
    rr2s = torch.where(p.pair, p.rr2, csp.kernelsize2)
    fac = K.kernel_fac(csp, rr2s)
    fr = fac[..., None] * p.dr

    dvfr = (p.dv * fr).sum(dim=-1)
    drfr = (p.dr * fr).sum(dim=-1)
    dot = (p.dr * p.dv).sum(dim=-1)
    dot_rr2 = dot / (rr2s + csp.eta2)

    bb = p.bound_t & p.bound_c
    w_comp = pw * (1.0 - bb.to(f32))          # bound-bound pairs never interact
    w_mom = pw * (1.0 - p.bound_t.to(f32))    # momentum: fluid-side targets only

    # momentum (JSphCpu.cpp:713-716)
    prs = (p.press1 + p.press2) / (p.rho1 * p.rho2)
    if csp.tkernel == TpKernel.CUBIC:
        prs = prs + K.cubic_tensil(csp, rr2s, p.rho1, p.press1, p.rho2, p.press2)
    ace = -(w_mom * prs * p.mass2)[..., None] * fr

    # continuity (JSphCpu.cpp:720)
    ar = w_comp * p.mass2 * dvfr * (p.rho1 / p.rho2)

    delta = delta_blocked = None
    if opts.tdensity != TpDensity.NONE:
        w_ddt = w_mom * (1.0 - p.ft_t.to(f32))
        blocked = p.pair & ~p.bound_t & ~p.ft_t
        if opts.tdensity == TpDensity.MOLTENI:
            # Molteni & Colagrossi 2009 (JSphCpu.cpp:724-731); under mDBC a
            # boundary candidate adds its term instead of blocking
            visc_densi = ddtkh * cbar * (p.rho1 / p.rho2 - 1.0) / (rr2s + csp.eta2)
            delta = w_ddt * visc_densi * drfr * p.mass2
            blockers = p.ft_c
            if opts.tboundary == TpBoundary.DBC:
                blockers = blockers | p.bound_c
            delta_blocked = blocked & blockers
        else:
            # Fourtakas et al. 2019 (JSphCpu.cpp:733-740), exact pow form;
            # FULL has no boundary block
            applies = (torch.ones_like(p.bound_c)
                       if opts.tdensity == TpDensity.FOURTAKAS else ~p.bound_c)
            rh = 1.0 + csp.ddtgz * p.dr[..., 2]
            drhop = csp.rhopzero * rh ** (1.0 / csp.gamma) - csp.rhopzero
            visc_densi = ddtkh * cbar * ((p.rho2 - p.rho1) - drhop) / (rr2s + csp.eta2)
            w2 = w_ddt * (applies & ~p.ft_c & ~p.bound_c).to(f32)
            delta = -w2 * visc_densi * drfr * p.mass2 / p.rho2
            delta_blocked = blocked & p.bound_c & applies

    # shifting accumulators (JSphCpu.cpp:743-750)
    shift = shift_blocked = None
    if opts.shiftmode != TpShifting.NONE:
        massrhop = w_mom * p.mass2 / p.rho2
        shift = torch.stack([massrhop * fr[..., 0], massrhop * fr[..., 1],
                             massrhop * fr[..., 2], -massrhop * drfr], dim=-1)
        if opts.shiftmode == TpShifting.NO_BOUND:
            shift_blocked = p.pair & ~p.bound_t & (p.bound_c | p.ft_c)
        elif opts.shiftmode == TpShifting.NO_FIXED:
            shift_blocked = p.pair & ~p.bound_t & p.fixed_c
        else:
            shift_blocked = torch.zeros_like(p.pair)

    # viscdt and viscosity (JSphCpu.cpp:757-791)
    visc = torch.where(w_comp > 0, dot_rr2, -FLT_MAX)
    visco_eff = torch.where(p.bound_c, csp.visco * csp.viscoboundfactor,
                            csp.visco)
    gradvel = None
    if opts.tvisco == TpVisco.ARTIFICIAL:
        amubar = csp.kernelh * dot_rr2
        robar = (p.rho1 + p.rho2) * 0.5
        pi_visc = torch.where((dot < 0) & (w_mom > 0),
                              (-visco_eff * cbar * amubar / robar) * p.mass2, 0.0)
        ace = ace - pi_visc[..., None] * fr
    else:
        # laminar operator (JSphCpu.cpp:765-775)
        robar2 = p.rho1 + p.rho2
        temp = 4.0 * visco_eff / ((rr2s + csp.eta2) * robar2)
        vtemp = w_mom * p.mass2 * temp * drfr
        ace = ace + vtemp[..., None] * p.dv
        # SPS stress divergence (JSphCpu.cpp:776-782): the candidate's
        # stress counts for fluid candidates only
        tau_sum = p.tau_t + torch.where((~p.bound_c & ~p.ft_c)[..., None],
                                        p.tau_c, 0.0)
        txx, txy, txz, tyy, tyz, tzz = tau_sum.unbind(dim=-1)
        m2w = w_mom * p.mass2
        ace = ace + torch.stack([
            m2w * (txx * fr[..., 0] + txy * fr[..., 1] + txz * fr[..., 2]),
            m2w * (txy * fr[..., 0] + tyy * fr[..., 1] + tyz * fr[..., 2]),
            m2w * (txz * fr[..., 0] + tyz * fr[..., 1] + tzz * fr[..., 2]),
        ], dim=-1)
        # velocity gradient (GetVelocityGradients_SPH_tsym), fluid targets
        volp2 = -(w_mom * (1.0 - p.ft_t.to(f32))) * p.mass2 / p.rho2
        dvx, dvy, dvz = (p.dv * volp2[..., None]).unbind(dim=-1)
        gradvel = torch.stack([
            dvx * fr[..., 0], dvx * fr[..., 1] + dvy * fr[..., 0],
            dvx * fr[..., 2] + dvz * fr[..., 0], dvy * fr[..., 1],
            dvy * fr[..., 2] + dvz * fr[..., 1], dvz * fr[..., 2],
        ], dim=-1)
    return PairTerms(ace=ace, ar=ar, delta=delta, delta_blocked=delta_blocked,
                     shift=shift, shift_blocked=shift_blocked, gradvel=gradvel,
                     visc=visc)


def particle_flags(csp: CteSph, code, ftomassp=None, with_floating=False):
    """Per-particle masks and mass from typecodes:
    (fluidside, floating, fixed, mass).  With ``with_floating`` and
    ``ftomassp`` (B,), the particle mass of each body, a floating particle
    weighs that of its body (the typecode's value, clipped to the table);
    otherwise it weighs ``massfluid``, as in the JAX bucket path."""
    ptype = td.code_type(code)
    fluidside = ptype >= td.TYPE_FLOATING
    floating = ptype == td.TYPE_FLOATING
    fixed = ptype == td.TYPE_FIXED
    mass = torch.where(fluidside, csp.massfluid, csp.massbound).to(torch.float32)
    if with_floating and ftomassp is not None:
        body = torch.clamp(td.code_value(code), max=ftomassp.shape[0] - 1)
        mass = torch.where(floating, ftomassp[body.long()], mass)
    return fluidside, floating, fixed, mass
