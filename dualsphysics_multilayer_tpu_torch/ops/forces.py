"""WCSPH force interaction over the cell-sorted layout, the SPS stress
and the shifting displacement.

Counterpart of `dualsphysics_multilayer_tpu/ops/forces.py`.
:func:`interaction_forces` sends CUDA tensors to the hand-written kernels
(`ops/cuda/cellforce.py`) and CPU tensors to :func:`interaction_forces_plain`,
the plain torch version of the same function: it walks the same 9 (3 in 2D)
contiguous neighbour ranges per target as the kernel, gathers them padded to
the longest range, and evaluates :func:`pairphys.pair_terms`; under
``opts.symmetry`` it evaluates the same candidates' images in the plane
y = 0 too, for the targets within the kernel size of it: an image is its
candidate with dr_y and dv_y replaced, so it keeps the candidate's mass
(a floating body's particle mass) and its SPS stress, unreflected, as the
JAX bucket path's pair inputs do.

Acceleration excludes gravity (added by the integrator), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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
    # the neighbour-list mode (ops/nbrlist.py): the single-phase step
    # divides on the list's grid (cells of kernelsize + nbr_skin*dp) and
    # counts each rebuild's neighbours beyond nbr_m (0 = nbrlist.auto_m);
    # the NN step ignores it, as the JAX package's does
    use_nbrlist: bool = False
    nbr_m: int = 0
    nbr_skin: float = 0.5
    # the lateral symmetry plane y = 0 (<parameter key="Symmetry">): targets
    # within kernelsize of it also meet each candidate's mirror image (3D
    # only; the case loaders also refuse laminar+SPS viscosity and floating
    # bodies with it, JSph.cpp:1174-1179, which the library runs as the JAX
    # bucket path does)
    symmetry: bool = False
    # NN velocity-gradient formulation: SPH = accumulated per-particle
    # gradients (3 passes), FDA = per-pair finite differences (1 pass)
    velgrad: TpVelGrad = TpVelGrad.SPH
    # NN dt relaxation lamda in dt3 = h^2/(ViscEtaDtMax*lamda)
    relaxationdt: float = 0.2
    # Verlet: an Euler re-anchoring step every verlet_steps steps
    verlet_steps: int = 40
    # per-dt diagnostics ring capacity (the JDsSaveDt channel; 0 = off):
    # StepCarry.dthist, drained to SaveDt.csv at each save, so it must
    # cover the steps between two saves
    savedt: int = 0
    # per-dt floating-motion ring capacity (JFtMotionSave,
    # PartFloatMotion.fbi4; 0 = off): StepCarry.fthist, same contract
    ftmotion: int = 0
    # initial DDT ramp (tramp, tmaxvalue, maxvalue): while t < tramp the DDT
    # constant is maxvalue (t <= tmaxvalue), then blends linearly down to
    # csp.ddtvalue at t = tramp (CLI -ddtramp, RunInitialDDTRamp
    # JSphCpuSingle.cpp:650-663); a launch parameter of each step
    ddtramp: tuple | None = None


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
    # () int32 periodic edge particles beyond the ghost cap at this
    # interaction (features/periodic.py); None without periodic boundaries
    overflow: torch.Tensor | None = None
    # () int32 floating rows with a neighbour row beyond DEM's static row
    # cap (features/dem.py); None without DEM
    dem_overflow: torch.Tensor | None = None


def gathered(fr: Forces, index) -> Forces:
    """``fr`` with its per-particle arrays taken at ``index``: the Forces
    of rows in cell order brought back to the state's slot order."""
    return replace(fr, **{k: getattr(fr, k)[index] for k in (
        "ace", "ar", "shiftposfs", "shift_blocked", "spsgradvel")
        if getattr(fr, k) is not None})


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
    walls, with or without floating bodies, and the symmetry plane in 3D
    with any of these (the JAX bucket path's mirror pass; the case loaders
    refuse laminar+SPS and floating bodies with it as ValueError, the
    reference's rule, JSph.cpp:1174-1179)."""
    raise_unsupported([
        (opts.tvisco not in (TpVisco.ARTIFICIAL, TpVisco.LAMINAR_SPS),
         f"tvisco={opts.tvisco.name}"),
        (opts.symmetry and csp.simulate2d, "symmetry=True in 2D")])


def check_spstau(opts: SolverOpts, spstau) -> None:
    """Laminar+SPS reads the state's SPS stress: raise ValueError unless
    it is given (the case built with ``need_sps=True``)."""
    if opts.tvisco == TpVisco.LAMINAR_SPS and spstau is None:
        raise ValueError("laminar+SPS viscosity needs the SPS stress "
                         "SimState.spstau (n,6): build the case with "
                         "need_sps=True")


def interaction_forces(csp: CteSph, opts: SolverOpts, dom: Domain,
                       cells: CellDiv, pos, vel, rho, code,
                       spstau=None, ftomassp=None, ddtkh=None,
                       visco=None) -> Forces:
    """One interaction on state arrays in ``cells`` order: the CUDA kernels
    for CUDA tensors, the plain version for CPU tensors.  ``spstau`` (n,6)
    is read by laminar+SPS viscosity only; ``ftomassp`` (B,), the particle
    mass of each floating body, under ``opts.with_floating`` only.
    ``ddtkh`` and ``visco``, host floats, replace ``csp.ddtkh`` and
    ``csp.visco`` for this interaction (the DDT ramp and the viscosity
    table, JAX `ops/forces.py:106-118`); the wall viscosity is then
    ``visco * viscoboundfactor`` in float32."""
    if pos.device.type == "cuda":
        from .cuda import cellforce as CF
        return CF.interaction_forces_cuda(csp, opts, dom, cells, pos, vel,
                                          rho, code, spstau, ftomassp,
                                          ddtkh=ddtkh, visco=visco)
    if pos.device.type != "cpu":
        raise ValueError(f"interaction_forces: no path for device {pos.device}")
    return interaction_forces_plain(csp, opts, dom, cells, pos, vel, rho, code,
                                    spstau, ftomassp, ddtkh=ddtkh, visco=visco)


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
                             ftomassp=None, max_pairs: int = 1 << 21,
                             ddtkh=None, visco=None) -> Forces:
    """Plain torch version of the cellforce kernels, over
    :func:`candidate_chunks`; ``ddtkh`` and ``visco`` as in
    :func:`interaction_forces`.  Under ``opts.symmetry`` each chunk's
    candidates are taken a second time as their images in the plane y = 0
    (the JAX bucket path's mirror pass, `ops/forces.py:204-219`): for
    targets with y <= kernelsize, dr_y = y_t + y_j and dv_y = vy_t + vy_j,
    the target's own image included, folded into the same sums."""
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
        terms = [PP.pair_terms(csp, opts, p, ddtkh=ddtkh, visco=visco)]
        if opts.symmetry:
            terms.append(PP.pair_terms(csp, opts, _mirrored(csp, p, pos, vel,
                                                            t, j, valid & act[j]),
                                       ddtkh=ddtkh, visco=visco))
        ace[t] = sum(x.ace.sum(dim=1) for x in terms)
        art = sum(x.ar.sum(dim=1) for x in terms)
        ft_live = floating[t] & live[t]
        if opts.tdensity != TpDensity.NONE:
            blocked = ft_live
            for x in terms:
                blocked = blocked | x.delta_blocked.any(dim=1)
            art = art + torch.where(blocked, 0.0,
                                    sum(x.delta.sum(dim=1) for x in terms))
        ar[t] = art
        visc[t] = torch.stack([x.visc.amax(dim=1) for x in terms]).amax(dim=0)
        if use_shift:
            shift[t] = sum(x.shift.sum(dim=1) for x in terms)
            blocked = ft_live
            for x in terms:
                blocked = blocked | x.shift_blocked.any(dim=1)
            shift_blocked[t] = blocked
        if use_sps:
            gradvel[t] = sum(x.gradvel.sum(dim=1) for x in terms)
    if csp.simulate2d:
        ace[:, 1] = 0.0
    viscdtmax = torch.clamp(visc.amax(), min=0.0)
    return Forces(ace=ace, ar=ar, viscdtmax=viscdtmax, shiftposfs=shift,
                  shift_blocked=shift_blocked, spsgradvel=gradvel)


def _mirrored(csp: CteSph, p: PP.PairInputs, pos, vel, t, j, live_pair):
    """The pair inputs of ``p`` with each candidate replaced by its image
    in the plane y = 0, for targets with y <= kernelsize: no ``j != t``
    exclusion (a target meets its own image), the kernels' support test
    on the image's distance."""
    dr = p.dr.clone()
    dr[..., 1] = pos[t, None, 1] + pos[j, 1]
    dv = p.dv.clone()
    dv[..., 1] = vel[t, None, 1] + vel[j, 1]
    rr2 = (dr * dr).sum(dim=-1)
    near = pos[t, 1] <= csp.kernelsize
    pair = (live_pair & near[:, None] & (rr2 >= td.ALMOSTZERO)
            & (rr2 < csp.kernelsize2))
    return replace(p, dr=dr, rr2=rr2, pair=pair, dv=dv)


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
