"""Single-phase WCSPH solver on torch: state, the symplectic step and the
host-side run loop.

Counterpart of the main-path subset of
`dualsphysics_multilayer_tpu/models/wcsph.py`: ``SimState``, ``StepCarry``,
``make_carry``, the skin-contract rebuild (``_rowdiv_tick``), the DBC
``_interaction``, ``make_symplectic_step``, ``make_step``, ``make_advance``
and ``Simulation``.

The state lives in cell-sorted order (``ops.celldiv.divide_cells``) and is
re-sorted only when the skin contract demands it: with cells of
``kernelsize + margin``, one divide finds every pair while
``2*max|pos - pos0| + 4*dt*vmax < 0.95*margin``.  The predictor and the
corrector share one layout.

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
from ..typesdef import CteSph
from ..ops import celldiv as cd
from ..ops import forces as F
from ..ops import integrators as I
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

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def permuted(self, order) -> "SimState":
        return SimState(**{k: v[order] for k, v in vars(self).items()})


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
    """Initial carry: the first divide (nrebuild = 1) and dt = DtIni."""
    F.check_supported(csp, opts)
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
                 st: SimState, cells: cd.CellDiv) -> F.Forces:
    """Forces of one interaction on the current layout (DBC walls, no
    feature hooks: the body of `JSphCpuSingle::Interaction_Forces`)."""
    return F.interaction_forces(csp, opts, dom, cells, st.pos, st.vel,
                                st.rho, st.code)


def make_symplectic_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                         feats=None):
    """Returns step(carry) -> carry implementing ComputeStep_Sym
    (JSphCpuSingle.cpp:695-722)."""
    if feats is not None:
        raise NotImplementedError("the torch port does not cover Features "
                                  "hooks yet")
    F.check_supported(csp, opts)
    margin = _margin(csp, dom)

    def step(carry: StepCarry) -> StepCarry:
        if carry.rebuild:
            carry = _rebuild(dom, carry)
        st = carry.st
        dt = carry.dt_pre

        # ---------------- predictor ----------------
        fr1 = _interaction(csp, opts, dom, st, carry.cells)
        velmax1 = I.velocity_max(csp, st.vel, st.code)
        acemax1 = I.ace_max(fr1.ace, st.code)
        dt_p, bad_p = I.dt_variable(csp, acemax1, velmax1, fr1.viscdtmax)
        pos_pre, vel_pre, rho_pre = st.pos, st.vel, st.rho
        pos1, vel1, rho1, code1 = I.symplectic_pre(
            csp, st.pos, st.vel, st.rho, st.code, fr1.ace, fr1.ar, dt)
        st = replace(st, pos=pos1, vel=vel1, rho=rho1, code=code1)

        # ---------------- corrector (same layout) ----------------
        fr2 = _interaction(csp, opts, dom, st, carry.cells)
        velmax2 = I.velocity_max(csp, st.vel, st.code)
        acemax2 = I.ace_max(fr2.ace, st.code)
        dt_c, bad_c = I.dt_variable(csp, acemax2, velmax2, fr2.viscdtmax)
        out = I.symplectic_corr(csp, pos_pre, vel_pre, rho_pre, st.rho,
                                st.code, fr2.ace, fr2.ar, dt, pose=st.pose)
        st = replace(st, pos=out[0], vel=out[1], rho=out[2], code=out[3],
                     pose=out[4])

        carry = replace(
            carry, st=st, t=carry.t + dt, dt_pre=torch.minimum(dt_p, dt_c),
            nstep=carry.nstep + 1,
            dtmodif=carry.dtmodif + bad_p.to(torch.int32)
            + bad_c.to(torch.int32),
            tabs=carry.tabs + dt)
        return _sync_flags(csp, margin, carry)

    return step


def make_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain, feats=None):
    if opts.tstep != td.TpStep.SYMPLECTIC:
        raise NotImplementedError(f"the torch port does not cover "
                                  f"tstep={opts.tstep.name} yet")
    return make_symplectic_step(csp, opts, dom, feats)


def make_advance(csp: CteSph, opts: SolverOpts, dom: cd.Domain, feats=None):
    """advance(carry, t_target, nstep_max): run steps until interval time
    >= t_target or nstep reaches nstep_max (the reference's main loop
    between PART saves, JSphCpuSingle.cpp:1090-1120)."""
    step = make_step(csp, opts, dom, feats)

    def advance(carry: StepCarry, t_target: float, nstep_max: int):
        while carry.t_host < t_target and carry.nstep < nstep_max:
            carry = step(carry)
        return carry

    return advance


class Simulation:
    """Host-side run loop (`JSphCpuSingle::Run`, JSphCpuSingle.cpp:
    1049-1202): owns the step, the save schedule and the diagnostics."""

    def __init__(self, csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 state: SimState, feats=None):
        self.csp, self.opts, self.dom = csp, opts, dom
        self.carry = make_carry(state, csp, opts, dom)
        self.advance = make_advance(csp, opts, dom, feats)
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
