"""WCSPH force interaction over the cell-sorted layout, the SPS stress
and the shifting displacement.

Counterpart of `dualsphysics_multilayer_tpu/ops/forces.py`.
:func:`interaction_forces` sends CUDA tensors to the hand-written kernels
(`ops/cuda/cellforce.py`) and CPU tensors to :func:`interaction_forces_plain`,
the plain torch version of the same function: it walks the same 9 (3 in 2D)
contiguous neighbour ranges per target as the kernel, gathers them padded to
the longest range, and evaluates :func:`pairphys.pair_terms`.

Acceleration excludes gravity (added by the integrator), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import typesdef as td
from ..typesdef import (CteSph, TpBoundary, TpDensity, TpShifting,
                        TpSlipMode, TpStep, TpVelGrad, TpVisco)
from . import eos
from . import pairphys as PP
from .celldiv import CellDiv, Domain, range_chunks, row_ranges
from .pairphys import FLT_MAX


@dataclass(frozen=True)
class SolverOpts:
    """Solver configuration; the JAX package's ``SolverOpts`` fields that
    the port's slices read.  Values no slice covers raise
    ``NotImplementedError`` in :func:`check_supported` (single phase) or
    ``forces_nn.check_supported_nn`` (multiphase non-Newtonian)."""
    tstep: TpStep = TpStep.SYMPLECTIC
    tvisco: TpVisco = TpVisco.ARTIFICIAL
    tdensity: TpDensity = TpDensity.FOURTAKAS
    tboundary: TpBoundary = TpBoundary.DBC
    # mDBC wall velocity (ops/mdbc.py); read only under tboundary=MDBC
    slipmode: TpSlipMode = TpSlipMode.NO_SLIP
    shiftmode: TpShifting = TpShifting.NONE
    with_floating: bool = False
    # mDBC kernel-completeness gate: a wall particle is corrected only where
    # its ghost node's Shepard sum reaches it (0 = always)
    mdbc_threshold: float = 0.0
    use_nbrlist: bool = False
    symmetry: bool = False
    # NN velocity-gradient formulation: SPH = accumulated per-particle
    # gradients (3 passes), FDA = per-pair finite differences (1 pass)
    velgrad: TpVelGrad = TpVelGrad.SPH
    # NN dt relaxation lamda in dt3 = h^2/(ViscEtaDtMax*lamda)
    relaxationdt: float = 0.2
    # Verlet: an Euler re-anchoring step every verlet_steps steps
    verlet_steps: int = 40


@dataclass
class Forces:
    """Force accumulators of one interaction, in the state's slot order."""
    ace: torch.Tensor          # (n,3) acceleration without gravity
    ar: torch.Tensor           # (n,)  drho/dt, density diffusion folded in
    viscdtmax: torch.Tensor    # ()    max dot(dv,dr)/(rr2+eta2) over pairs, >= 0
    shiftposfs: torch.Tensor | None = None     # (n,4) shifting sums
    shift_blocked: torch.Tensor | None = None  # (n,) bool
    spsgradvel: torch.Tensor | None = None     # (n,6) laminar+SPS only
    # () max effective viscosity for the NN dt3 control; None on the
    # single-phase path
    viscetadtmax: torch.Tensor | None = None


def check_supported_step(csp: CteSph, opts: SolverOpts) -> None:
    """Raise NotImplementedError for any setting outside every slice's step:
    what the single-phase and the NN interactions both require."""
    unsupported = [
        (opts.use_nbrlist, "use_nbrlist=True"),
        (opts.symmetry, "symmetry=True"),
    ]
    raise_unsupported(unsupported)


def raise_unsupported(unsupported) -> None:
    """Raise NotImplementedError naming the first ``(bad, name)`` pair that
    is bad."""
    for bad, name in unsupported:
        if bad:
            raise NotImplementedError(f"the torch port does not cover {name} yet")


def check_supported(csp: CteSph, opts: SolverOpts) -> None:
    """Raise NotImplementedError for any configuration outside the
    single-phase interaction: Wendland or cubic, artificial or laminar+SPS
    viscosity, every density diffusion and shifting mode, DBC or mDBC
    walls, with or without floating bodies."""
    check_supported_step(csp, opts)
    raise_unsupported([(opts.tvisco not in (TpVisco.ARTIFICIAL,
                                            TpVisco.LAMINAR_SPS),
                        f"tvisco={opts.tvisco.name}")])


def check_spstau(opts: SolverOpts, spstau) -> None:
    """Laminar+SPS reads the state's SPS stress: raise ValueError unless
    it is given (the case built with ``need_sps=True``)."""
    if opts.tvisco == TpVisco.LAMINAR_SPS and spstau is None:
        raise ValueError("laminar+SPS viscosity needs the SPS stress "
                         "SimState.spstau (n,6): build the case with "
                         "need_sps=True")


def interaction_forces(csp: CteSph, opts: SolverOpts, dom: Domain,
                       cells: CellDiv, pos, vel, rho, code,
                       spstau=None, ftomassp=None) -> Forces:
    """One interaction on state arrays in ``cells`` order: the CUDA kernels
    for CUDA tensors, the plain version for CPU tensors.  ``spstau`` (n,6)
    is read by laminar+SPS viscosity only; ``ftomassp`` (B,), the particle
    mass of each floating body, under ``opts.with_floating`` only."""
    if pos.device.type == "cuda":
        from .cuda import cellforce as CF
        return CF.interaction_forces_cuda(csp, opts, dom, cells, pos, vel,
                                          rho, code, spstau, ftomassp)
    if pos.device.type != "cpu":
        raise ValueError(f"interaction_forces: no path for device {pos.device}")
    return interaction_forces_plain(csp, opts, dom, cells, pos, vel, rho, code,
                                    spstau, ftomassp)


def neighbour_ranges(dom: Domain, cells: CellDiv, live):
    """(start, length) of each target's (dy, dz) neighbour ranges, (n, R)
    each with R = 9 (3 in 2D), from the cell of the target's slot."""
    ncx, ncy = dom.nc[0], dom.nc[1]
    cell = cells.cell.long()
    return row_ranges(dom, cells, cell % ncx, (cell // ncx) % ncy,
                      cell // (ncx * ncy), live)


def candidate_chunks(dom: Domain, cells: CellDiv, live, max_pairs: int):
    """:func:`range_chunks` over every target's neighbour ranges."""
    return range_chunks(*neighbour_ranges(dom, cells, live), max_pairs)


def interaction_forces_plain(csp: CteSph, opts: SolverOpts, dom: Domain,
                             cells: CellDiv, pos, vel, rho, code, spstau=None,
                             ftomassp=None, max_pairs: int = 1 << 21) -> Forces:
    """Plain torch version of the cellforce kernels, over
    :func:`candidate_chunks`."""
    check_supported(csp, opts)
    check_spstau(opts, spstau)
    n = pos.shape[0]
    f32 = pos.dtype
    dev = pos.device
    press = eos.press_from_rho(csp, rho)
    act = td.is_active(code)
    fluidside, floating, fixed, mass = PP.particle_flags(
        csp, code, ftomassp, opts.with_floating)
    live = act & (cells.cell < dom.ncells)
    use_sps = opts.tvisco == TpVisco.LAMINAR_SPS
    use_shift = opts.shiftmode != TpShifting.NONE
    tau = torch.where(fluidside[:, None], spstau, 0.0) if use_sps else None

    ace = torch.zeros((n, 3), dtype=f32, device=dev)
    ar = torch.zeros(n, dtype=f32, device=dev)
    visc = torch.full((n,), -FLT_MAX, dtype=f32, device=dev)
    shift = torch.zeros((n, 4), dtype=f32, device=dev) if use_shift else None
    shift_blocked = torch.zeros(n, dtype=torch.bool, device=dev) \
        if use_shift else None
    gradvel = torch.zeros((n, 6), dtype=f32, device=dev) if use_sps else None
    for t, j, valid in candidate_chunks(dom, cells, live, max_pairs):
        dr = pos[t, None, :] - pos[j]
        rr2 = (dr * dr).sum(dim=-1)
        pair = (valid & (j != t[:, None]) & act[j]
                & (rr2 >= td.ALMOSTZERO) & (rr2 < csp.kernelsize2))
        p = PP.PairInputs(
            dr=dr, rr2=rr2, pair=pair, dv=vel[t, None, :] - vel[j],
            mass2=mass[j], rho1=rho[t, None], rho2=rho[j],
            press1=press[t, None], press2=press[j],
            bound_t=~fluidside[t, None], bound_c=~fluidside[j],
            ft_t=floating[t, None], ft_c=floating[j], fixed_c=fixed[j],
            tau_t=tau[t, None, :] if use_sps else None,
            tau_c=tau[j] if use_sps else None)
        terms = PP.pair_terms(csp, opts, p)
        ace[t] = terms.ace.sum(dim=1)
        art = terms.ar.sum(dim=1)
        ft_live = floating[t] & live[t]
        if opts.tdensity != TpDensity.NONE:
            blocked = terms.delta_blocked.any(dim=1) | ft_live
            art = art + torch.where(blocked, 0.0, terms.delta.sum(dim=1))
        ar[t] = art
        visc[t] = terms.visc.amax(dim=1)
        if use_shift:
            shift[t] = terms.shift.sum(dim=1)
            shift_blocked[t] = terms.shift_blocked.any(dim=1) | ft_live
        if use_sps:
            gradvel[t] = terms.gradvel.sum(dim=1)
    if csp.simulate2d:
        ace[:, 1] = 0.0
    viscdtmax = torch.clamp(visc.amax(), min=0.0)
    return Forces(ace=ace, ar=ar, viscdtmax=viscdtmax, shiftposfs=shift,
                  shift_blocked=shift_blocked, spsgradvel=gradvel)


def compute_sps_tau(csp: CteSph, rho, gradvel):
    """SPS sub-particle stress from the accumulated velocity gradient
    (Smagorinsky + Blin; reference `JSphCpu::ComputeSpsTau`)."""
    gxx, gxy, gxz, gyy, gyz, gzz = gradvel.unbind(dim=1)
    pow1 = gxx * gxx + gyy * gyy + gzz * gzz
    prr = pow1 + pow1 + gxy * gxy + gxz * gxz + gyz * gyz
    visc_sps = csp.spssmag * torch.sqrt(prr)
    div_u = gxx + gyy + gzz
    sps_k = (2.0 / 3.0) * visc_sps * div_u
    sps_blin = csp.spsblin * prr
    sumsps = -(sps_k + sps_blin)
    two = visc_sps + visc_sps
    one_rho = 1.0 / rho
    return torch.stack([
        one_rho * (two * gxx + sumsps),
        one_rho * (visc_sps * gxy),
        one_rho * (visc_sps * gxz),
        one_rho * (two * gyy + sumsps),
        one_rho * (visc_sps * gyz),
        one_rho * (two * gzz + sumsps),
    ], dim=-1)


def apply_shifting(csp: CteSph, opts: SolverOpts, dt, vel, code, shiftposfs,
                   shift_blocked):
    """The shifting displacement (n,3) from the accumulators (reference
    `JSphShifting::RunCpu`): dt*shiftcoef*h*|v| times the concentration
    gradient, each component clipped to 0.1*dp, for normal fluid particles
    that no blocking neighbour touches."""
    vmag = torch.sqrt((vel * vel).sum(dim=-1))
    umagn = dt * csp.shiftcoef * csp.kernelh * vmag
    if csp.shifttfs:
        coeftfs = (2.0 if csp.simulate2d else 3.0) - csp.shifttfs
        conc = shiftposfs[:, 3]
        umagn = torch.where(conc < csp.shifttfs, 0.0,
                            umagn * (conc - csp.shifttfs) / coeftfs)
    maxdist = csp.dp * 0.1
    disp = torch.clamp(shiftposfs[:, :3] * umagn[:, None], -maxdist, maxdist)
    ok = td.is_fluid(code) & td.is_normal(code) & ~shift_blocked
    return torch.where(ok[:, None], disp, 0.0)
