"""Multiphase non-Newtonian (HBP) force interaction on torch tensors.

Counterpart of `dualsphysics_multilayer_tpu/ops/forces_nn.py` (the mphase
fork's `JSphCpu_NN_SPH.cpp:663-695` pipeline) over the port's cell-sorted
layout:

1. **pass 1** (PressGrad): per-phase pressure force (plus the cubic
   spline's tensile correction), continuity with per-phase masses, density
   diffusion on same-phase pairs with the candidate's cs0, viscdt, for SPH
   Morris/ConsEq the 6-component velocity gradient with the no-slip wall
   trick (dv = 2*v1 against a boundary), and with a shifting mode the
   shifting sums under the heavy-phase gate;
2. **pass 2**, elementwise: strain rate -> HBP effective viscosity (active
   fluid only) -> tau = 2*eta*D for ConsEq;
3. **pass 3**: Morris (eta1 + eta2), ConsEq (tau1 + tau2) or per-phase
   artificial viscosity, added to pass 1's acceleration.

With ``velgrad=FDA`` and Morris or ConsEq, pass 1 also evaluates the
per-pair FDA strain -> eta -> viscous force and no pass 3 runs; the
per-target eta max is the ``visco_eta`` that feeds dt3.

Under mDBC walls the passes differ from DBC in one rule, as the JAX bucket
path does: a wall neighbour does not block a target's Molteni diffusion
(JAX `forces_nn.py:276`).  The NN step runs no mDBC pre-pass (JAX
`models/nnewtonian.py`), so the walls keep their own velocity and density.

:func:`interaction_forces_nn` sends CUDA tensors to the hand-written kernels
(`ops/cuda/nnforce.py`: ``nnforce_p1``, ``nnforce_p3``, ``nnforce_fda``) and
CPU tensors to :func:`interaction_forces_nn_plain`, the plain torch version
of the same passes.  Both run pass 2 through :func:`pass2`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import typesdef as td
from ..typesdef import (CteSph, TpBoundary, TpDensity, TpKernel, TpShifting,
                        TpStep, TpVelGrad, TpVisco)
from . import eos
from . import kernels as K
from .celldiv import CellDiv, Domain
from .forces import (FLT_MAX, Forces, SolverOpts, candidate_chunks,
                     raise_unsupported)


@dataclass(frozen=True)
class Phase:
    """One fluid phase (reference StPhaseCte + StPhaseArray)."""
    mkfluid: int
    rho0: float
    csound: float
    gamma: float = 7.0
    visco: float = 0.001          # HBP consistency k (or Newtonian mu)
    tau_yield: float = 0.0
    tau_max: float = 0.0
    bi_multi: float = 0.0
    hbp_m: float = 0.0            # Papanastasiou exponential coefficient
    hbp_n: float = 1.0            # Herschel-Bulkley power index
    newtonian: bool = False


@dataclass(frozen=True)
class PhaseCfg:
    """Static phase table; index = fluid typecode value (mkfluid)."""
    phases: tuple                 # of Phase, indexed by mkfluid

    @property
    def count(self):
        return len(self.phases)

    def tables(self, csp: CteSph, device) -> dict:
        """Per-phase f32 tensors on ``device``: rho0, cs0, gamma, mass,
        cteb, visco, tau_yield, tau_max, bi_multi, hbp_m, hbp_n (cached, so
        a step copies nothing to the device)."""
        return _tables(self, csp.dp ** csp.dim, torch.device(device))

    def system_cs0(self):
        return max(p.csound for p in self.phases)


@functools.lru_cache(maxsize=16)
def _tables(phases: PhaseCfg, dpdim: float, device) -> dict:
    def f(k):
        return torch.tensor([float(getattr(p, k)) for p in phases.phases],
                            dtype=torch.float32, device=device)
    rho0, cs0, gamma = f("rho0"), f("csound"), f("gamma")
    return dict(
        rho0=rho0, cs0=cs0, gamma=gamma, mass=rho0 * dpdim,
        cteb=cs0 * cs0 * rho0 / gamma,
        visco=f("visco"), tau_yield=f("tau_yield"), tau_max=f("tau_max"),
        bi_multi=f("bi_multi"), hbp_m=f("hbp_m"), hbp_n=f("hbp_n"))


def press_nn(tb, phase_idx, rho):
    """Per-phase Tait EOS (the mphase ComputePress_NN)."""
    r0 = tb["rho0"][phase_idx]
    b = tb["cteb"][phase_idx]
    g = tb["gamma"][phase_idx]
    return b * ((rho / r0) ** g - 1.0)


def strain_rate(gradvel):
    """Deviatoric strain tensor D and its magnitude sqrt(-II1 + II2)
    (GetStrainRateTensor_tsym, JSphCpu_Tensors.cpp:185-208).  ``gradvel``
    (n,6) holds the symmetric accumulation, off-diagonals already summed
    (xy = du/dy + dv/dx)."""
    gxx, gxy, gxz, gyy, gyz, gzz = gradvel.unbind(dim=1)
    divv = (gxx + gyy + gzz) / 3.0
    dxx, dyy, dzz = gxx - divv, gyy - divv, gzz - divv
    dxy, dxz, dyz = 0.5 * gxy, 0.5 * gxz, 0.5 * gyz
    ii1 = dxx * dyy + dyy * dzz + dxx * dzz
    ii2 = dxy * dxy + dyz * dyz + dxz * dxz
    magn = torch.sqrt(torch.clamp(-ii1 + ii2, min=0.0))
    return torch.stack([dxx, dxy, dxz, dyy, dyz, dzz], dim=-1), magn


def eta_effective(tb, phase_idx, d_magn, ppx=None):
    """HBP effective viscosity (GetEta_Effective, JSphCpu_Tensors.cpp:
    116-136).  tau_yield, visco, m and n come from ``phase_idx``; the
    bi-viscosity constants tau_max and Bi_multi from ``ppx`` (the target's
    phase in the FDA per-pair call, JSphCpu_NN_FDA.cpp:291), which defaults
    to ``phase_idx``."""
    eps = td.ALMOSTZERO
    dm = torch.clamp(d_magn, min=eps)
    if ppx is None:
        ppx = phase_idx
    visco = tb["visco"][phase_idx]
    tauy = tb["tau_yield"][phase_idx]
    taumax = tb["tau_max"][ppx]
    bimult = tb["bi_multi"][ppx]
    m_nn = tb["hbp_m"][phase_idx]
    n_nn = tb["hbp_n"][phase_idx]

    has_taumax = taumax > 0
    miou_yield = torch.where(has_taumax, taumax / (2.0 * dm), tauy / (2.0 * dm))
    bi_region = has_taumax & (dm <= taumax / (2.0 * torch.clamp(
        bimult * visco, min=eps)))
    miou_yield = torch.where(bi_region, bimult * visco, miou_yield)
    miou_pap = miou_yield * (1.0 - torch.exp(-m_nn * dm))
    low_rate = (miou_pap > m_nn * tauy) | (d_magn <= eps)
    term1 = torch.where(has_taumax, miou_yield,
                        torch.where(low_rate, m_nn * tauy, miou_pap))
    miou_hb = visco * dm ** (n_nn - 1.0)
    term2 = torch.where(bi_region | low_rate, visco, miou_hb)
    return term1 + term2


def strain_magn_pair(dvw, dr, rr2):
    """Per-pair FDA strain rate (GetVelocityGradients_FDA +
    GetStrainRateTensor, JSphCpu_Tensors.cpp:80-112): gradient dv (outer)
    dr / rr2, deviatoric strain D = sym(grad) - (tr/3) I, and the
    full-matrix magnitude |II1 - II2| (the reference's quirk, unlike the
    SPH formulation's sqrt(-II1 + II2)).  Returns (magn, (sxx, sxy, sxz,
    syy, syz, szz))."""
    inv = 1.0 / rr2
    d11 = dvw[..., 0] * dr[..., 0] * inv
    d12 = dvw[..., 0] * dr[..., 1] * inv
    d13 = dvw[..., 0] * dr[..., 2] * inv
    d21 = dvw[..., 1] * dr[..., 0] * inv
    d22 = dvw[..., 1] * dr[..., 1] * inv
    d23 = dvw[..., 1] * dr[..., 2] * inv
    d31 = dvw[..., 2] * dr[..., 0] * inv
    d32 = dvw[..., 2] * dr[..., 1] * inv
    d33 = dvw[..., 2] * dr[..., 2] * inv
    divv = (d11 + d22 + d33) / 3.0
    sxx, syy, szz = d11 - divv, d22 - divv, d33 - divv
    sxy, sxz, syz = 0.5 * (d12 + d21), 0.5 * (d13 + d31), 0.5 * (d23 + d32)
    ii1 = sxx * syy + syy * szz + sxx * szz
    ii2 = sxy * sxy + syz * syz + sxz * sxz
    return torch.abs(ii1 - ii2), (sxx, sxy, sxz, syy, syz, szz)


def check_supported_nn(csp: CteSph, opts: SolverOpts, phases: PhaseCfg) -> None:
    """Raise NotImplementedError for any configuration outside the NN
    slices (symmetry, floating bodies, Verlet, the SaveDt and
    floating-motion rings and the DDT ramp among them; either kernel,
    every shifting mode, DBC or mDBC walls and a phase table of any count
    are in), ValueError for a table of no phase (JAX's ``make_nn_csp``
    fails on one).  The JAX NN step runs these options ignored (a symmetry
    case without the mirror, Verlet as symplectic, floating bodies as
    fluid-side particles that never move); the port refuses them instead
    (ROADMAP.md §3).  The neighbour-list mode passes: the NN step ignores
    it, as JAX's does."""
    raise_unsupported([
        (opts.tstep != TpStep.SYMPLECTIC, f"tstep={opts.tstep.name}"),
        (opts.symmetry, "symmetry=True on the NN step"),
        (opts.with_floating, "with_floating=True"),
        # the JAX NN step reads no DDT ramp and never writes the SaveDt or
        # floating-motion rings (its SaveDt.csv fills with zero rows)
        (opts.savedt, "savedt on the NN step"),
        (opts.ftmotion, "ftmotion on the NN step"),
        (opts.ddtramp is not None, "ddtramp on the NN step")])
    if phases.count < 1:
        raise ValueError("an NN phase table needs at least one phase")


def uses_fda(opts: SolverOpts) -> bool:
    """FDA with Morris or ConsEq fuses every pass into pass 1; FDA with
    artificial viscosity takes the SPH passes (it reads no gradient)."""
    return (opts.velgrad == TpVelGrad.FDA
            and opts.tvisco in (TpVisco.LAMINAR_SPS, TpVisco.CONST_EQ))


def uses_gradvel(opts: SolverOpts) -> bool:
    """Pass 1 accumulates the velocity gradient (SPH Morris or ConsEq)."""
    return not uses_fda(opts) and opts.tvisco != TpVisco.ARTIFICIAL


@dataclass
class NnChannels:
    """Per-particle inputs of the passes, in slot order."""
    phase: torch.Tensor       # (n,) int32 phase index, clipped to the table
    press: torch.Tensor       # (n,) f32 per-phase EOS (fluid), system EOS (bound)
    kind: torch.Tensor        # (n,) int32 particle type, -1 when inactive


def channels(csp: CteSph, phases: PhaseCfg, tb: dict, rho, code) -> NnChannels:
    """The per-particle prep of JAX ``interaction_forces_nn`` (and the
    TPU kernels' channels): the phase index from the typecode value (so
    boundaries carry phase 0), per-phase pressure for active fluid-side
    particles and the system EOS for the rest (ComputePress_NN,
    JSphCpu_Tensors.cpp:48-70)."""
    act = td.is_active(code)
    ptype = td.code_type(code)
    phase = torch.clamp(td.code_value(code), 0, phases.count - 1)
    press = torch.where((ptype >= td.TYPE_FLOATING) & act,
                        press_nn(tb, phase, rho), eos.press_from_rho(csp, rho))
    kind = torch.where(act, ptype, -1)
    return NnChannels(phase=phase.to(torch.int32), press=press,
                      kind=kind.to(torch.int32))


@dataclass
class Pass1:
    """Outputs of pass 1 (or of the fused FDA pass), in slot order."""
    ace: torch.Tensor         # (n,3)
    ar: torch.Tensor          # (n,)  diffusion folded in
    viscdt: torch.Tensor      # (n,)  max dot/(rr2+eta2) over the target's pairs
    gradvel: torch.Tensor     # (n,6) SPH Morris/ConsEq, else zeros
    etamax: torch.Tensor      # (n,)  FDA per-target eta max, else zeros
    shift: torch.Tensor | None = None     # (n,4) shifting sums, with a mode
    shiftblk: torch.Tensor | None = None  # (n,) bool, set under NO_BOUND


@dataclass
class NnResult:
    """One NN interaction: the JAX contract's (Forces, visco_eta, tau) and
    pass 1's velocity gradient."""
    forces: Forces
    visco_eta: torch.Tensor   # (n,)
    tau: torch.Tensor         # (n,6)
    gradvel: torch.Tensor     # (n,6)


def pass2(opts: SolverOpts, tb: dict, ch: NnChannels, code, p1: Pass1):
    """Elementwise pass 2, plain torch on either device: (visco_eta, tau).
    SPH Morris/ConsEq: eta_effective of the strain rate for active fluid, 0
    elsewhere, and tau = 2*eta*D for ConsEq; FDA: the per-target eta max of
    pass 1; artificial: zeros."""
    n = code.shape[0]
    zeros6 = torch.zeros((n, 6), dtype=torch.float32, device=code.device)
    if uses_fda(opts):
        return p1.etamax, zeros6
    if opts.tvisco == TpVisco.ARTIFICIAL:
        return torch.zeros_like(p1.ar), zeros6
    D, dmagn = strain_rate(p1.gradvel)
    visco_eta = torch.where(td.is_fluid(code) & td.is_active(code),
                            eta_effective(tb, ch.phase, dmagn), 0.0)
    if opts.tvisco == TpVisco.CONST_EQ:
        return visco_eta, 2.0 * visco_eta[:, None] * D
    return visco_eta, zeros6


def run_passes(csp: CteSph, opts: SolverOpts, phases: PhaseCfg, dom: Domain,
               cells: CellDiv, pos, vel, rho, code, pass1, pass3) -> NnResult:
    """Pass 1 -> pass 2 -> pass 3 with the given pass implementations:
    ``pass1(csp, opts, phases, dom, cells, pos, vel, rho, ch) -> Pass1`` and
    ``pass3(csp, opts, phases, dom, cells, pos, vel, rho, ch, visco_eta,
    tau, ace)``, which adds the viscous forces into ``ace`` in place."""
    check_supported_nn(csp, opts, phases)
    tb = phases.tables(csp, pos.device)
    ch = channels(csp, phases, tb, rho, code)
    p1 = pass1(csp, opts, phases, dom, cells, pos, vel, rho, ch)
    visco_eta, tau = pass2(opts, tb, ch, code, p1)
    ace = p1.ace
    if not uses_fda(opts):
        pass3(csp, opts, phases, dom, cells, pos, vel, rho, ch, visco_eta, tau,
              ace)
    if csp.simulate2d:
        ace[:, 1] = 0.0
    fr = Forces(ace=ace, ar=p1.ar,
                viscdtmax=torch.clamp(p1.viscdt.amax(), min=0.0),
                viscetadtmax=visco_eta.amax(), shiftposfs=p1.shift,
                shift_blocked=p1.shiftblk)
    return NnResult(forces=fr, visco_eta=visco_eta, tau=tau,
                    gradvel=p1.gradvel)


def interaction_forces_nn(csp: CteSph, opts: SolverOpts, phases: PhaseCfg,
                          dom: Domain, cells: CellDiv, pos, vel, rho, code):
    """One NN interaction on state arrays in ``cells`` order: the CUDA
    kernels for CUDA tensors, the plain version for CPU tensors.  Returns
    (Forces, visco_eta (n,), tau (n,6)), as the JAX package does."""
    if pos.device.type == "cuda":
        from .cuda import nnforce as NF
        r = NF.interaction_forces_nn_cuda(csp, opts, phases, dom, cells, pos,
                                          vel, rho, code)
    elif pos.device.type == "cpu":
        r = interaction_forces_nn_plain(csp, opts, phases, dom, cells, pos,
                                        vel, rho, code)
    else:
        raise ValueError(f"interaction_forces_nn: no path for device {pos.device}")
    return r.forces, r.visco_eta, r.tau


# ---------------------------------------------------------------------------
# The plain version: the kernels' passes in torch, over candidate_chunks
# ---------------------------------------------------------------------------

@dataclass
class _Pairs:
    """Per-pair fields of one chunk of targets (b, R*L): index 1 = target,
    2 = candidate."""
    t: torch.Tensor
    j: torch.Tensor
    pair: torch.Tensor        # bool: the pair interacts
    w_mom: torch.Tensor       # f32: pair with a fluid-side target
    bound_t: torch.Tensor
    bound_c: torch.Tensor
    dr: torch.Tensor          # (...,3)
    rr2: torch.Tensor         # rr2 of pairs, kernelsize^2 elsewhere
    fr: torch.Tensor          # (...,3) kernel gradient
    drfr: torch.Tensor
    dv: torch.Tensor          # (...,3)
    dvw: torch.Tensor         # (...,3) dv, or 2*v1 against a boundary
    mass2: torch.Tensor
    rho1: torch.Tensor
    rho2: torch.Tensor
    ph1: torch.Tensor
    ph2: torch.Tensor


def _chunks(csp: CteSph, tb: dict, dom: Domain, cells: CellDiv, pos, vel, rho,
            ch: NnChannels, max_pairs: int):
    """Yield the :class:`_Pairs` of each chunk of targets."""
    live = (ch.kind >= 0) & (cells.cell < dom.ncells)
    fluidside = ch.kind >= td.TYPE_FLOATING
    phase = ch.phase.long()
    mass = torch.where(fluidside, tb["mass"][phase], csp.massbound)
    for t, j, valid in candidate_chunks(dom, cells, live, max_pairs):
        dr = pos[t, None, :] - pos[j]
        rr2 = (dr * dr).sum(dim=-1)
        bound_t = ~fluidside[t, None]
        bound_c = ~fluidside[j]
        pair = (valid & (j != t[:, None]) & live[j] & (rr2 >= td.ALMOSTZERO)
                & (rr2 <= csp.kernelsize2) & ~(bound_t & bound_c))
        rr2 = torch.where(pair, rr2, csp.kernelsize2)
        fr = K.kernel_fac(csp, rr2)[..., None] * dr
        dv = vel[t, None, :] - vel[j]
        yield _Pairs(
            t=t, j=j, pair=pair, w_mom=(pair & ~bound_t).to(torch.float32),
            bound_t=bound_t, bound_c=bound_c, dr=dr, rr2=rr2, fr=fr,
            drfr=(dr * fr).sum(dim=-1), dv=dv,
            dvw=torch.where(bound_c[..., None], 2.0 * vel[t, None, :], dv),
            mass2=mass[j], rho1=rho[t, None], rho2=rho[j],
            ph1=phase[t, None], ph2=phase[j])


def pass1_plain(csp: CteSph, opts: SolverOpts, phases: PhaseCfg,
                dom: Domain, cells: CellDiv, pos, vel, rho, ch: NnChannels,
                max_pairs: int = 1 << 20) -> Pass1:
    """Plain version of ``nnforce_p1`` (or, under :func:`uses_fda`,
    ``nnforce_fda``)."""
    tb = phases.tables(csp, pos.device)
    n = pos.shape[0]
    f32 = dict(dtype=torch.float32, device=pos.device)
    shifting = opts.shiftmode != TpShifting.NONE
    out = Pass1(ace=torch.zeros((n, 3), **f32), ar=torch.zeros(n, **f32),
                viscdt=torch.full((n,), -FLT_MAX, **f32),
                gradvel=torch.zeros((n, 6), **f32),
                etamax=torch.zeros(n, **f32),
                shift=torch.zeros((n, 4), **f32) if shifting else None,
                shiftblk=torch.zeros(n, dtype=torch.bool, device=pos.device)
                if shifting else None)
    fda, grad = uses_fda(opts), uses_gradvel(opts)
    eta2 = csp.eta2
    for p in _chunks(csp, tb, dom, cells, pos, vel, rho, ch, max_pairs):
        t = p.t
        pw = p.pair.to(torch.float32)
        press1, press2 = ch.press[t, None], ch.press[p.j]
        prs = (press1 + press2) / (p.rho1 * p.rho2)
        if csp.tkernel == TpKernel.CUBIC:
            prs = prs + K.cubic_tensil(csp, p.rr2, p.rho1, press1, p.rho2, press2)
        ace = -((p.w_mom * prs * p.mass2)[..., None] * p.fr).sum(dim=1)
        dvfr = (p.dv * p.fr).sum(dim=-1)
        dot = (p.dr * p.dv).sum(dim=-1)
        ar = (pw * p.mass2 * dvfr * (p.rho1 / p.rho2)).sum(dim=1)
        out.viscdt[t] = torch.where(p.pair, dot / (p.rr2 + eta2), -FLT_MAX).amax(dim=1)

        if opts.tdensity != TpDensity.NONE:
            same = (p.ph1 == p.ph2) & ~p.bound_c
            cbar = tb["cs0"][p.ph2]
            if opts.tdensity == TpDensity.MOLTENI:
                vd = csp.ddtkh * cbar * (p.rho1 / p.rho2 - 1.0) / (p.rr2 + eta2)
                delta = (p.w_mom * torch.where(same, vd * p.drfr * p.mass2, 0.0)).sum(dim=1)
                # a wall neighbour blocks the term under DBC walls only (JAX
                # forces_nn.py:276); boundary candidates add no term
                blocked = ((p.pair & ~p.bound_t & p.bound_c).any(dim=1)
                           & (opts.tboundary == TpBoundary.DBC))
            else:
                rh = 1.0 + csp.ddtgz * p.dr[..., 2]
                drhop = csp.rhopzero * rh ** (1.0 / csp.gamma) - csp.rhopzero
                vd = csp.ddtkh * cbar * ((p.rho2 - p.rho1) - drhop) / (p.rr2 + eta2)
                delta = -(p.w_mom * torch.where(
                    same, vd * p.drfr * p.mass2 / p.rho2, 0.0)).sum(dim=1)
                blocked = ((p.pair & ~p.bound_t & p.bound_c).any(dim=1)
                           & (opts.tdensity == TpDensity.FOURTAKAS))
            ar = ar + torch.where(blocked, 0.0, delta)

        if shifting:
            # the mphase fork's heavy-phase gate: a pair with a lighter
            # candidate of another fluid phase adds nothing
            heavy = ((tb["mass"][p.ph1] > tb["mass"][p.ph2])
                     & (p.ph1 != p.ph2) & ~p.bound_c)
            massrhop = torch.where(heavy, 0.0, p.w_mom * p.mass2 / p.rho2)
            out.shift[t] = torch.cat([
                (massrhop[..., None] * p.fr).sum(dim=1),
                -(massrhop * p.drfr).sum(dim=1, keepdim=True)], dim=1)
            if opts.shiftmode == TpShifting.NO_BOUND:
                out.shiftblk[t] = (p.pair & ~p.bound_t & p.bound_c).any(dim=1)

        if grad:
            g = p.dvw * (-p.w_mom * p.mass2 / p.rho2)[..., None]
            gx, gy, gz = g.unbind(dim=-1)
            frx, fry, frz = p.fr.unbind(dim=-1)
            out.gradvel[t] = torch.stack([
                gx * frx, gx * fry + gy * frx, gx * frz + gz * frx,
                gy * fry, gy * frz + gz * fry, gz * frz], dim=-1).sum(dim=1)
        elif fda:
            magn, S = strain_magn_pair(p.dvw, p.dr, p.rr2)
            eta = eta_effective(tb, torch.where(p.bound_c, p.ph1, p.ph2), magn,
                                ppx=p.ph1)
            out.etamax[t] = torch.where(p.pair & ~p.bound_t, eta, 0.0).amax(dim=1)
            if opts.tvisco == TpVisco.LAMINAR_SPS:
                temp = 2.0 * eta / ((p.rr2 + eta2) * p.rho2)
                vtemp = p.w_mom * p.mass2 * temp * p.drfr
                ace = ace + (vtemp[..., None] * p.dvw).sum(dim=1)
            else:
                ace = ace + _stress_divergence(
                    p.w_mom * p.mass2 / p.rho2 * (2.0 * eta), S, p.fr)
        out.ace[t] = ace
        out.ar[t] = ar
    return out


def _stress_divergence(m2r, ts, fr):
    """sum over candidates of m2r * (tau . fr), tau as its 6 symmetric
    components (xx, xy, xz, yy, yz, zz)."""
    txx, txy, txz, tyy, tyz, tzz = ts
    frx, fry, frz = fr.unbind(dim=-1)
    return torch.stack([
        (m2r * (txx * frx + txy * fry + txz * frz)).sum(dim=1),
        (m2r * (txy * frx + tyy * fry + tyz * frz)).sum(dim=1),
        (m2r * (txz * frx + tyz * fry + tzz * frz)).sum(dim=1)], dim=-1)


def pass3_plain(csp: CteSph, opts: SolverOpts, phases: PhaseCfg,
                dom: Domain, cells: CellDiv, pos, vel, rho, ch: NnChannels,
                visco_eta, tau, ace, max_pairs: int = 1 << 20) -> None:
    """Plain version of ``nnforce_p3``: adds the viscous forces into ``ace``."""
    tb = phases.tables(csp, pos.device)
    eta2 = csp.eta2
    for p in _chunks(csp, tb, dom, cells, pos, vel, rho, ch, max_pairs):
        t = p.t
        if opts.tvisco == TpVisco.LAMINAR_SPS:
            eta1 = visco_eta[t, None]
            eta_c = torch.where(p.bound_c, eta1, visco_eta[p.j])
            temp = (eta1 + eta_c) / ((p.rr2 + eta2) * p.rho2)
            vtemp = p.w_mom * p.mass2 * temp * p.drfr
            add = (vtemp[..., None] * p.dvw).sum(dim=1)
        elif opts.tvisco == TpVisco.CONST_EQ:
            tau1 = tau[t, None, :]
            ts = tau1 + torch.where(p.bound_c[..., None], tau1, tau[p.j])
            add = _stress_divergence(p.w_mom * p.mass2 / p.rho2, ts.unbind(dim=-1),
                                     p.fr)
        else:
            # per-phase artificial viscosity (visco_NN = PhaseCte[pp2].visco)
            dot = (p.dr * p.dv).sum(dim=-1)
            amubar = csp.kernelh * (dot / (p.rr2 + eta2))
            robar = (p.rho1 + p.rho2) * 0.5
            pi = torch.where(
                (dot < 0) & (p.w_mom > 0),
                (-tb["visco"][p.ph2] * tb["cs0"][p.ph2] * amubar / robar) * p.mass2,
                0.0)
            add = -(pi[..., None] * p.fr).sum(dim=1)
        ace[t] += add


def interaction_forces_nn_plain(csp: CteSph, opts: SolverOpts,
                                phases: PhaseCfg, dom: Domain, cells: CellDiv,
                                pos, vel, rho, code) -> NnResult:
    """Plain torch version of the three NN kernels, on either device."""
    return run_passes(csp, opts, phases, dom, cells, pos, vel, rho, code,
                      pass1_plain, pass3_plain)
