"""WCSPH solver on torch: state, the symplectic step and the host-side run
loop.

Counterpart of the symplectic subset of
`dualsphysics_multilayer_tpu/models/wcsph.py`: ``SimState``, ``StepCarry``,
``make_carry``, the skin-contract rebuild (``_rowdiv_tick``),
``_interaction`` with the mDBC pre-pass, ``make_symplectic_step`` with the
floating-body hooks, ``make_step``, ``make_advance`` and ``Simulation``.
:func:`symplectic_step` takes the interaction as an argument, so the
multiphase non-Newtonian step (``models/nnewtonian.py``) shares it.

The state lives in cell-sorted order (``ops.celldiv.divide_cells``) and is
re-sorted only when the skin contract demands it: with cells of
``kernelsize + margin``, one divide finds every pair while
``2*max|pos - pos0| + 4*dt*vmax < 0.95*margin``.  The predictor and the
corrector share one layout.  Shifting needs no term of its own: a step's
shift enters ``pos`` after the step's two interactions, and the contract
reads ``pos`` before the next step's first one.

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
from ..typesdef import CteSph, TpBoundary
from ..features import floating as FT
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
               dom: cd.Domain) -> StepCarry:
    """Initial carry: the first divide (nrebuild = 1) and dt = DtIni.  It
    serves the single-phase and the NN steps alike; each step checks its
    own interaction's settings."""
    F.check_supported_step(csp, opts)
    dev = st.pos.device
    carry = StepCarry(
        st=st,
        t=torch.zeros((), dtype=torch.float32, device=dev),
        dt_pre=torch.tensor(csp.dtini, dtype=torch.float32, device=dev),
        dtmodif=torch.zeros((), dtype=torch.int32, device=dev),
        tabs=torch.zeros((), dtype=torch.float32, device=dev),
        cells=None, pos0=None)
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


def make_symplectic_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                         feats: Features | None = None):
    """Returns step(carry) -> carry implementing ComputeStep_Sym
    (JSphCpuSingle.cpp:695-722) over the single-phase interaction, with the
    floating bodies of ``feats`` moved after the predictor (dt/2) and the
    corrector (dt), JSphCpuSingle.cpp:707,715."""
    F.check_supported(csp, opts)
    floating = None
    if feats is not None:
        feats.check_supported()
        floating = feats.floating

    def interaction(st, cells):
        ftomassp = None
        if floating is not None:
            ftomassp = FT.body_tables(floating, tuple(csp.gravity),
                                      st.pos.device).massp
        return _interaction(csp, opts, dom, st, cells, ftomassp)

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

    return symplectic_step(csp, opts, dom, interaction, rigid)


def _sps_tau(csp: CteSph, st: SimState, fr: F.Forces):
    """The SPS stress of the forces' velocity gradient at the density the
    interaction read, zero for all but fluid particles."""
    tau = F.compute_sps_tau(csp, st.rho, fr.spsgradvel)
    return torch.where(td.is_fluid(st.code)[:, None], tau, 0.0)


def symplectic_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                    interaction, rigid=None):
    """step(carry) -> carry: the symplectic predictor and corrector over
    ``interaction(st, cells) -> (st, Forces)`` on one layout; the state it
    returns (the mDBC pre-pass's boundary values) is the one that goes on,
    as in JAX.  What the forces carry switches the rest: ``viscetadtmax``
    the NN dt3 control, ``spsgradvel`` the SPS stress after each
    interaction, ``shiftposfs`` the shifting displacement in the corrector.
    ``rigid(st, ace, t, dt, predictor) -> st`` moves the floating bodies
    after the predictor (dt/2) and after the corrector (dt)."""
    margin = _margin(csp, dom)

    def step(carry: StepCarry) -> StepCarry:
        if carry.rebuild:
            carry = _rebuild(dom, carry)
        st = carry.st
        dt = carry.dt_pre

        # ---------------- predictor ----------------
        st, fr1 = interaction(st, carry.cells)
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
        st, fr2 = interaction(st, carry.cells)
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
        if rigid is not None:
            st = rigid(st, fr2.ace, carry.tabs, dt, False)

        carry = replace(
            carry, st=st, t=carry.t + dt, dt_pre=torch.minimum(dt_p, dt_c),
            nstep=carry.nstep + 1,
            dtmodif=carry.dtmodif + bad_p.to(torch.int32)
            + bad_c.to(torch.int32),
            tabs=carry.tabs + dt)
        return _sync_flags(csp, margin, carry)

    return step


def make_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
              feats: Features | None = None):
    if opts.tstep != td.TpStep.SYMPLECTIC:
        raise NotImplementedError(f"the torch port does not cover "
                                  f"tstep={opts.tstep.name} yet")
    return make_symplectic_step(csp, opts, dom, feats)


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
        self.carry = make_carry(state, csp, opts, dom)
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

    def run(self, tmax: float, tout: float, on_save=None):
        """Run to ``tmax`` saving every ``tout`` seconds of simulation time."""
        t0 = time.time()
        if on_save:
            on_save(self)
        while self.time < tmax - 1e-5 * tout:
            target = min(tout, tmax - self.time)
            carry = self.advance(self.carry, target, float("inf"))
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
