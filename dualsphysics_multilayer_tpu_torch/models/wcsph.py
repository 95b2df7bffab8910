"""WCSPH solver on torch: state, the symplectic and Verlet steps and the
host-side run loop.

Counterpart of `dualsphysics_multilayer_tpu/models/wcsph.py`: ``SimState``,
``StepCarry``, ``make_carry``, the skin-contract rebuild (``_rowdiv_tick``),
``_interaction`` with the mDBC pre-pass and the external accelerations,
``make_symplectic_step`` and ``make_verlet_step`` with the feature hooks
(floating bodies, damping, relaxation zones, motion, multi-layer pistons,
AWAS), ``make_step``, ``make_advance`` and ``Simulation`` with its gauge
sub-ticks.  :func:`symplectic_step` takes the interaction as an argument,
so the multiphase non-Newtonian step (``models/nnewtonian.py``) shares it.

The state lives in cell-sorted order (``ops.celldiv.divide_cells``) and is
re-sorted only when the skin contract demands it: with cells of
``kernelsize + margin``, one divide finds every pair while
``2*max|pos - pos0| + 4*dt*vmax < 0.95*margin``.  The predictor and the
corrector share one layout; a Verlet step interacts once, at the step's
start.  Shifting, moving walls, AWAS and the multi-layer pistons need no
term of their own: they move particles after the step's interactions, and
the contract reads ``pos`` (walls included) before the next step's first
one.

Torch has no device-side loop, so the host drives the steps.  Each step
ends with ONE small device-to-host copy, ``[rebuild flag for the next step,
t]``: the flag decides whether the next step starts with a divide, and ``t``
is what :func:`make_advance` compares with its target.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph, TpBoundary, TpStep
from ..features import accinput as ACC
from ..features import awas as AWAS
from ..features import damping as DMP
from ..features import floating as FT
from ..features import mlpiston as MLP
from ..features import motion as MOT
from ..features import relaxzone as RZ
from ..features.featureset import Features
from ..ops import celldiv as cd
from ..ops import forces as F
from ..ops import integrators as I
from ..ops import mdbc as MD
from ..ops.forces import SolverOpts


@dataclass
class SimState:
    """Particle state (SoA).  Slots are permuted at every rebuild: ``idp``
    names the particle."""
    pos: torch.Tensor            # (n,3) f32
    vel: torch.Tensor            # (n,3) f32
    rho: torch.Tensor            # (n,)  f32
    code: torch.Tensor           # (n,)  int32 typecode
    idp: torch.Tensor            # (n,)  int64 particle id
    # compensated-position residual: pos + pose is the trajectory at
    # ~2x24-bit precision (integrators.comp_pos_update)
    pose: torch.Tensor           # (n,3) f32
    # SPS sub-particle stress (xx, xy, xz, yy, yz, zz), laminar+SPS only
    spstau: torch.Tensor | None = None   # (n,6) f32
    ft: FT.FloatingState | None = None   # floating body state, per body
    boundnormal: torch.Tensor | None = None   # (n,3) f32 mDBC normals
    motionvel: torch.Tensor | None = None     # (n,3) f32 mDBC wall velocity
    # Verlet M1 state: velocity and density of the step before
    velm1: torch.Tensor | None = None         # (n,3) f32
    rhom1: torch.Tensor | None = None         # (n,)  f32

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def permuted(self, order) -> "SimState":
        """The state with every per-particle field in slot order
        ``order``; the body state stays as it is."""
        return SimState(**{k: v if v is None or k == "ft" else v[order]
                           for k, v in vars(self).items()})


@dataclass
class StepCarry:
    """Per-step scalars (the reference's TimeStep/DtPre/Nstep plus
    diagnostics) and the current divide."""
    st: SimState
    t: torch.Tensor              # () f32 time since interval start (device)
    dt_pre: torch.Tensor         # () f32 SymplecticDtPre (device)
    dtmodif: torch.Tensor        # () int32 dt clamped-to-min counter (device)
    tabs: torch.Tensor           # () f32 absolute simulation time (device)
    cells: cd.CellDiv            # divide of the last rebuild
    pos0: torch.Tensor           # (n,3) positions at the last rebuild
    nstep: int = 0
    nrebuild: int = 0
    # the GPU layout has no per-cell capacity, so nothing is ever dropped
    # and overflow stays 0; the field keeps the JAX carry's diagnostic for
    # the benchmark, which fails a run on overflow
    overflow: int = 0
    t_host: float = 0.0          # host copy of t, read at the end of a step
    rebuild: bool = False        # the next step starts with a divide
    # Verlet steps since the last Euler re-anchoring step (VerletStep); it
    # depends on nstep alone, so it lives on the host
    verlet_count: int = 0
    # AWAS: the accumulated correction displacement of each paddle, (P,)
    awas: torch.Tensor | None = None


def _rebuild(dom: cd.Domain, carry: StepCarry) -> StepCarry:
    """Divide and permute the state into the fresh cell order (RunCellDivide
    + SortArray, JSphCpuSingle.cpp:450-467, run only when needed)."""
    st = carry.st
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    st = replace(st, code=code).permuted(cells.order)
    return replace(carry, st=st, cells=cells, pos0=st.pos,
                   nrebuild=carry.nrebuild + 1, rebuild=False)


def _rebuild_needed(csp: CteSph, margin: float, carry: StepCarry):
    """Skin contract (JAX ``_rowdiv_tick``): accumulated displacement since
    the last rebuild plus this step's worst-case motion must stay under the
    cell skin.  Returns a 0-d bool tensor on the device."""
    st = carry.st
    act = td.is_active(st.code)
    d2 = torch.where(act, ((st.pos - carry.pos0) ** 2).sum(dim=1), 0.0).amax()
    vmax = I.velocity_max(csp, st.vel, st.code)
    return (2.0 * torch.sqrt(d2) + 4.0 * carry.dt_pre * vmax) \
        >= np.float32(0.95 * margin)


def _sync_flags(csp: CteSph, margin: float, carry: StepCarry) -> StepCarry:
    """The step's one device-to-host copy: the next rebuild flag and t."""
    need = _rebuild_needed(csp, margin, carry)
    flag, t = torch.stack([need.to(carry.t.dtype), carry.t]).tolist()
    return replace(carry, rebuild=bool(flag), t_host=t)


def _margin(csp: CteSph, dom: cd.Domain) -> float:
    margin = dom.scell - csp.kernelsize
    if margin <= 0:
        raise ValueError("the domain needs a cell skin "
                         "(make_domain(..., skin=...) with skin > 0)")
    return margin


def make_carry(st: SimState, csp: CteSph, opts: SolverOpts,
               dom: cd.Domain, feats: Features | None = None) -> StepCarry:
    """Initial carry: the first divide (nrebuild = 1) and dt = DtIni, with
    a zero AWAS correction per paddle of ``feats``.  It serves the
    single-phase and the NN steps alike; each step checks its own
    interaction's settings.  The Verlet step reads the M1 state: ValueError
    unless the state has it (the case built with ``need_verlet=True``)."""
    F.check_supported_step(csp, opts)
    if opts.tstep == TpStep.VERLET and (st.velm1 is None or st.rhom1 is None):
        raise ValueError("the Verlet step needs the M1 state SimState.velm1 "
                         "and SimState.rhom1: build the case with "
                         "need_verlet=True")
    dev = st.pos.device
    carry = StepCarry(
        st=st,
        t=torch.zeros((), dtype=torch.float32, device=dev),
        dt_pre=torch.tensor(csp.dtini, dtype=torch.float32, device=dev),
        dtmodif=torch.zeros((), dtype=torch.int32, device=dev),
        tabs=torch.zeros((), dtype=torch.float32, device=dev),
        cells=None, pos0=None,
        awas=(torch.zeros(len(feats.awas), dtype=torch.float32, device=dev)
              if feats is not None and feats.awas else None))
    carry = _rebuild(dom, carry)
    return _sync_flags(csp, _margin(csp, dom), carry)


def _interaction(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 st: SimState, cells: cd.CellDiv, ftomassp=None):
    """The mDBC pre-pass and the forces of one interaction on the current
    layout (the body of `JSphCpuSingle::Interaction_Forces`).  Returns (the
    state with the pre-pass's boundary velocity and density, Forces).  The
    pre-pass runs under mDBC walls when the state carries normals (JAX
    `wcsph.py:443-449`); without normals an mDBC run is a DBC run with the
    mDBC diffusion rule, as in JAX."""
    if opts.tboundary == TpBoundary.MDBC and st.boundnormal is not None:
        vel, rho = MD.mdbc_correction(csp, opts, dom, cells, st.pos, st.vel,
                                      st.rho, st.code, st.boundnormal,
                                      st.motionvel)
        st = replace(st, vel=vel, rho=rho)
    return st, F.interaction_forces(csp, opts, dom, cells, st.pos, st.vel,
                                    st.rho, st.code, st.spstau, ftomassp)


def _single_phase(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                  feats: Features | None):
    """(interaction, rigid) of the single-phase steps: the interaction
    ``(st, cells, tabs) -> (st, Forces)`` with the floating bodies'
    particle mass and, after the forces, the external accelerations
    (`_post_forces`, JAX `wcsph.py:486-492`: they enter AceMax and the dt
    control); ``rigid(st, ace, t, dt, predictor) -> st``, the floating
    bodies' update, or None."""
    F.check_supported(csp, opts)
    floating = accinputs = None
    if feats is not None:
        feats.check_supported()
        floating, accinputs = feats.floating, feats.accinputs

    def interaction(st, cells, tabs):
        ftomassp = None
        if floating is not None:
            ftomassp = FT.body_tables(floating, tuple(csp.gravity),
                                      st.pos.device).massp
        st, fr = _interaction(csp, opts, dom, st, cells, ftomassp)
        if accinputs:
            fr = replace(fr, ace=ACC.apply_accinput(
                accinputs, csp, tabs, st.pos, st.vel, st.code, fr.ace))
        return st, fr

    rigid = None
    if floating is not None:
        def rigid(st, ace, t, dt, predictor):
            if st.ft is None:
                raise ValueError("floating bodies need the body state "
                                 "SimState.ft (features.floating."
                                 "make_floating)")
            pos, vel, ft = FT.run_floating(floating, csp, st.ft, t, dt,
                                           predictor, st.pos, st.vel,
                                           st.code, ace)
            return replace(st, pos=pos, vel=vel, ft=ft)

    return interaction, rigid


def _after_update(csp: CteSph, feats: Features | None, rigid,
                  write_motionvel: bool):
    """after(st, ace, tabs, dt, awas) -> (st, awas): the hooks that run
    after the step's update, in the JAX package's order (`wcsph.py:
    610-636`, `:728-750`): the floating bodies over dt, damping,
    relaxation zones, scripted motion, multi-layer pistons and AWAS.
    ``write_motionvel``: the motion writes the moving walls' velocity into
    ``motionvel`` for the mDBC pre-pass, as the JAX symplectic step does
    (`:621-623`); its Verlet step leaves ``motionvel`` as it is
    (`:735-738`).  None when there is nothing to run."""
    if feats is None or not (rigid or feats.damping or feats.relaxzones
                             or feats.motions or feats.mlpistons or feats.awas):
        return None

    def after(st, ace, tabs, dt, awas):
        if rigid is not None:
            st = rigid(st, ace, tabs, dt, False)
        if feats.damping:
            st = replace(st, vel=DMP.apply_damping(feats.damping, dt, st.pos,
                                                   st.vel, st.code))
        if feats.relaxzones:
            st = replace(st, vel=RZ.apply_relaxzones(
                feats.relaxzones, csp, tabs, st.pos, st.vel, st.code, dt=dt))
        if feats.motions:
            pos, vel = MOT.apply_motion(feats.motions, tabs, dt, st.pos,
                                        st.vel, st.code)
            st = replace(st, pos=pos, vel=vel)
            if write_motionvel and st.motionvel is not None:
                st = replace(st, motionvel=torch.where(
                    td.is_moving(st.code)[:, None], vel, 0.0))
        if feats.mlpistons:
            pos, vel = MLP.apply_mlpistons(feats.mlpistons, tabs, dt, st.pos,
                                           st.vel, st.code)
            st = replace(st, pos=pos, vel=vel)
        if feats.awas:
            pos, vel, awas = AWAS.apply_awas(feats.awas, csp, awas, tabs, dt,
                                             st.pos, st.vel, st.code)
            st = replace(st, pos=pos, vel=vel)
        return st, awas

    return after


def make_symplectic_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                         feats: Features | None = None):
    """Returns step(carry) -> carry implementing ComputeStep_Sym
    (JSphCpuSingle.cpp:695-722) over the single-phase interaction, with the
    floating bodies of ``feats`` moved after the predictor (dt/2) and the
    corrector (dt), JSphCpuSingle.cpp:707,715, and the other hooks of
    ``feats`` after the corrector."""
    interaction, rigid = _single_phase(csp, opts, dom, feats)
    return symplectic_step(csp, opts, dom, interaction, rigid,
                           _after_update(csp, feats, rigid, True))


def make_verlet_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                     feats: Features | None = None):
    """Returns step(carry) -> carry implementing ComputeStep_Ver
    (JSphCpuSingle.cpp:674-690): one interaction on the current layout, dt
    from it, the leapfrog against the M1 state with an Euler re-anchoring
    step every ``opts.verlet_steps`` steps (JAX `wcsph.py:662-773`), then
    the hooks of ``feats``.  The next step's skin-contract lookahead reads
    this step's dt."""
    interaction, rigid = _single_phase(csp, opts, dom, feats)
    after = _after_update(csp, feats, rigid, False)
    margin = _margin(csp, dom)

    def step(carry: StepCarry) -> StepCarry:
        if carry.rebuild:
            carry = _rebuild(dom, carry)
        st, fr = interaction(carry.st, carry.cells, carry.tabs)
        velmax = I.velocity_max(csp, st.vel, st.code)
        acemax = I.ace_max(fr.ace, st.code)
        dt, bad = I.dt_variable(csp, acemax, velmax, fr.viscdtmax)
        shiftdisp = None
        if fr.shiftposfs is not None:
            shiftdisp = F.apply_shifting(csp, opts, dt, st.vel, st.code,
                                         fr.shiftposfs, fr.shift_blocked)
        vcount = carry.verlet_count + 1
        use_m1 = vcount < opts.verlet_steps
        out = I.verlet(csp, st.pos, st.vel, st.rho, st.velm1, st.rhom1,
                       st.code, fr.ace, fr.ar, dt, use_m1, st.pose, shiftdisp)
        if fr.spsgradvel is not None:
            st = replace(st, spstau=_sps_tau(csp, st, fr))
        # the reference swaps Velrhop and VelrhopM1: the new M1 state is
        # the step's starting one
        st = replace(st, pos=out[0], vel=out[1], rho=out[2], code=out[3],
                     pose=out[4], velm1=st.vel, rhom1=st.rho)
        awas = carry.awas
        if after is not None:
            st, awas = after(st, fr.ace, carry.tabs, dt, awas)
        carry = replace(
            carry, st=st, t=carry.t + dt, dt_pre=dt, nstep=carry.nstep + 1,
            verlet_count=vcount if use_m1 else 0,
            dtmodif=carry.dtmodif + bad.to(torch.int32),
            tabs=carry.tabs + dt, awas=awas)
        return _sync_flags(csp, margin, carry)

    return step


def _sps_tau(csp: CteSph, st: SimState, fr: F.Forces):
    """The SPS stress of the forces' velocity gradient at the density the
    interaction read, zero for all but fluid particles."""
    tau = F.compute_sps_tau(csp, st.rho, fr.spsgradvel)
    return torch.where(td.is_fluid(st.code)[:, None], tau, 0.0)


def symplectic_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                    interaction, rigid=None, after=None):
    """step(carry) -> carry: the symplectic predictor and corrector over
    ``interaction(st, cells, tabs) -> (st, Forces)`` on one layout; the
    state it returns (the mDBC pre-pass's boundary values) goes on,
    as in JAX.  What the forces carry switches the rest: ``viscetadtmax``
    the NN dt3 control, ``spsgradvel`` the SPS stress after each
    interaction, ``shiftposfs`` the shifting displacement in the corrector.
    ``rigid(st, ace, t, dt, predictor) -> st`` moves the floating bodies
    after the predictor (dt/2); ``after(st, ace, tabs, dt, awas) -> (st,
    awas)`` runs the hooks after the corrector (:func:`_after_update`, the
    bodies over dt among them)."""
    margin = _margin(csp, dom)

    def step(carry: StepCarry) -> StepCarry:
        if carry.rebuild:
            carry = _rebuild(dom, carry)
        st = carry.st
        dt = carry.dt_pre

        # ---------------- predictor ----------------
        st, fr1 = interaction(st, carry.cells, carry.tabs)
        velmax1 = I.velocity_max(csp, st.vel, st.code)
        acemax1 = I.ace_max(fr1.ace, st.code)
        dt_p, bad_p = I.dt_variable(csp, acemax1, velmax1, fr1.viscdtmax,
                                    fr1.viscetadtmax, opts.relaxationdt)
        pos_pre, vel_pre, rho_pre = st.pos, st.vel, st.rho
        pos1, vel1, rho1, code1 = I.symplectic_pre(
            csp, st.pos, st.vel, st.rho, st.code, fr1.ace, fr1.ar, dt)
        if fr1.spsgradvel is not None:
            st = replace(st, spstau=_sps_tau(csp, st, fr1))
        st = replace(st, pos=pos1, vel=vel1, rho=rho1, code=code1)
        if rigid is not None:
            st = rigid(st, fr1.ace, carry.tabs, dt * 0.5, True)

        # ---------------- corrector (same layout) ----------------
        st, fr2 = interaction(st, carry.cells, carry.tabs)
        velmax2 = I.velocity_max(csp, st.vel, st.code)
        acemax2 = I.ace_max(fr2.ace, st.code)
        dt_c, bad_c = I.dt_variable(csp, acemax2, velmax2, fr2.viscdtmax,
                                    fr2.viscetadtmax, opts.relaxationdt)
        shiftdisp = None
        if fr2.shiftposfs is not None:
            # the predictor's velocity, the step's dt (JAX wcsph.py:580-586)
            shiftdisp = F.apply_shifting(csp, opts, dt, st.vel, st.code,
                                         fr2.shiftposfs, fr2.shift_blocked)
        out = I.symplectic_corr(csp, pos_pre, vel_pre, rho_pre, st.rho,
                                st.code, fr2.ace, fr2.ar, dt, pose=st.pose,
                                shiftdisp=shiftdisp)
        if fr2.spsgradvel is not None:
            st = replace(st, spstau=_sps_tau(csp, st, fr2))
        st = replace(st, pos=out[0], vel=out[1], rho=out[2], code=out[3],
                     pose=out[4])
        awas = carry.awas
        if after is not None:
            st, awas = after(st, fr2.ace, carry.tabs, dt, awas)

        carry = replace(
            carry, st=st, t=carry.t + dt, dt_pre=torch.minimum(dt_p, dt_c),
            nstep=carry.nstep + 1,
            dtmodif=carry.dtmodif + bad_p.to(torch.int32)
            + bad_c.to(torch.int32),
            tabs=carry.tabs + dt, awas=awas)
        return _sync_flags(csp, margin, carry)

    return step


def make_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
              feats: Features | None = None):
    if opts.tstep == TpStep.SYMPLECTIC:
        return make_symplectic_step(csp, opts, dom, feats)
    return make_verlet_step(csp, opts, dom, feats)


def make_advance(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 feats: Features | None = None, step=None):
    """advance(carry, t_target, nstep_max): run steps until interval time
    >= t_target or nstep reaches nstep_max (the reference's main loop
    between PART saves, JSphCpuSingle.cpp:1090-1120).  ``step`` replaces
    the single-phase step, e.g. with ``nnewtonian.make_nn_step``."""
    step = step or make_step(csp, opts, dom, feats)

    def advance(carry: StepCarry, t_target: float, nstep_max: int):
        while carry.t_host < t_target and carry.nstep < nstep_max:
            carry = step(carry)
        return carry

    return advance


class Simulation:
    """Host-side run loop (`JSphCpuSingle::Run`, JSphCpuSingle.cpp:
    1049-1202): owns the step, the save schedule and the diagnostics."""

    def __init__(self, csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 state: SimState, feats: Features | None = None, step=None):
        self.csp, self.opts, self.dom = csp, opts, dom
        self.carry = make_carry(state, csp, opts, dom, feats)
        self.advance = make_advance(csp, opts, dom, feats, step=step)
        self.part = 0
        self.time = 0.0        # global simulation time (host f64 accumulator)

    def check_diagnostics(self):
        if self.carry.overflow:
            raise RuntimeError(f"cell overflow: {self.carry.overflow} "
                               f"particle(s) dropped")
        code = self.carry.st.code.cpu().numpy()
        sp = td.code_special(code)
        # OUT_IGNORE marks never-active spare slots, not exclusions
        out = (sp >= td.SPECIAL_OUT_POS) & (sp != td.SPECIAL_OUT_IGNORE)
        bound_out = out & (td.code_type(code) < td.TYPE_FLUID)
        if bound_out.any():
            raise RuntimeError(
                f"{int(bound_out.sum())} boundary particle(s) excluded from "
                f"the domain (reference AbortBoundOut, JSph.cpp:2477)")

    def run(self, tmax: float, tout: float, on_save=None, next_subtick=None,
            on_subtick=None):
        """Run to ``tmax`` saving every ``tout`` seconds of simulation time.

        ``next_subtick(t_abs) -> t or None`` and ``on_subtick(sim, t_abs)``
        are the in-interval hooks of the gauges' own cadence (computedt,
        JDsGaugeSystem.cpp:447; ``features.gauges.GaugeSystem.next_time``):
        the steps stop at the first step end at or past the next pending
        tick inside the save interval, and ``on_subtick`` runs there."""
        t0 = time.time()
        if on_save:
            on_save(self)
        while self.time < tmax - 1e-5 * tout:
            target = min(tout, tmax - self.time)
            carry = self.carry
            while True:
                stgt = target
                if next_subtick is not None:
                    nt = next_subtick(self.time + carry.t_host)
                    if nt is not None and nt - self.time < target - 1e-9:
                        stgt = min(max(nt - self.time, carry.t_host), target)
                carry = self.advance(carry, stgt, float("inf"))
                if stgt >= target:
                    break
                self.carry = carry
                if on_subtick is not None:
                    on_subtick(self, self.time + carry.t_host)
            # keep the interval clock small so f32 time stays precise; the
            # sub-dt overshoot stays in t for the next interval
            t = carry.t - np.float32(target)
            self.carry = replace(carry, t=t, t_host=float(t))
            self.time += target
            self.part += 1
            self.check_diagnostics()
            if on_save:
                on_save(self)
        self.walltime = time.time() - t0
        return self
