"""WCSPH solver on torch: state, the symplectic and Verlet steps and the
host-side run loop.

Counterpart of `dualsphysics_multilayer_tpu/models/wcsph.py`: ``SimState``,
``StepCarry``, ``make_carry``, the skin-contract rebuild (``_rowdiv_tick``),
``_interaction`` with the mDBC pre-pass and the external accelerations,
``make_symplectic_step`` and ``make_verlet_step`` with the feature hooks
(floating bodies, damping, relaxation zones, motion, multi-layer pistons,
AWAS, and the open boundaries: periodic ghosts and inlet/outlet zones),
``make_step``, ``make_advance`` and ``Simulation`` with its gauge
sub-ticks.  The floating bodies' couplings attach where JAX attaches them:
DEM contact after the forces of each interaction, the moorings' and force
points' forces and Chrono's links and mesh contact in each rigid update,
and the dynamic mooring lines (``StepCarry.moor``) advanced after the
corrector's.  :func:`symplectic_step` takes the interaction as an argument,
so the multiphase non-Newtonian step (``models/nnewtonian.py``) shares it.

The state lives in cell-sorted order (``ops.celldiv.divide_cells``) and is
re-sorted only when the skin contract demands it: with cells of
``kernelsize + margin``, one divide finds every pair while
``2*max|pos - pos0| + 4*dt*vmax < 0.95*margin``.  The predictor and the
corrector share one layout; a Verlet step interacts once, at the step's
start.  Shifting, moving walls, AWAS and the multi-layer pistons need no
term of their own: they move particles after the step's interactions, and
the contract reads ``pos`` (walls included) before the next step's first
one.  Open boundaries change the population: under periodic boundaries
each interaction divides the state's rows with their ghost rows afresh
(``features/periodic.py``), as JAX divides at both; inlet/outlet
conversions, captures and destructions change codes only, and a spawn
into a spare slot (the layout's dead tail) forces the next step's
rebuild.  Under ``SolverOpts.use_nbrlist`` the single-phase steps divide
on the neighbour list's grid (``ops/nbrlist.py``: cells of kernelsize +
nbr_skin*dp, so the margin is the list's skin) and count each rebuild's
neighbours beyond the list's capacity into the step's overflow; DEM then
reads the list's rows.  The carry records the domain of its layout
(``StepCarry.dom``): a step that walks another divides afresh, so the
NN step, which ignores the option as JAX's does, runs from a carry made
under it.  A domain without a cell skin (cells of the kernel size, JAX
``make_domain``'s default, which JAX's bucket path runs) keeps no layout
between interactions: each step starts with a rebuild and each
interaction divides its own positions afresh (:func:`fresh_interaction`),
as JAX divides at both; the inlet/outlet zones' extrapolation divides the
post-step positions too, and under a domain decomposition the rebuild
migrates and each interaction exchanges the ghost rows afresh.

Torch has no device-side loop, so the host drives the steps.  Each step
ends with ONE small device-to-host copy, ``[rebuild flag for the next step,
t, tabs]`` (with open boundaries, the step's overflow counts too): the
flag decides whether the next step starts with a divide,
``t`` is what :func:`make_advance` compares with its target, and ``tabs``
gives the next step its launch values on the host (:func:`step_values`:
the DDT ramp and the viscosity table), so they cost no read of their own.
With ``SolverOpts.savedt`` / ``ftmotion`` a step also writes one row of its
diagnostics rings on the device (``StepCarry.dthist`` / ``fthist``), which
``io.output.OutputManager`` drains at each save.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph, TpBoundary, TpStep
from ..features import accinput as ACC
from ..features import awas as AWAS
from ..features import damping as DMP
from ..features import dem as DEM
from ..features import floating as FT
from ..features import inout as IO
from ..features import mlpiston as MLP
from ..features import motion as MOT
from ..features import periodic as PER
from ..features import relaxzone as RZ
from ..features.featureset import Features
from ..ops import celldiv as cd
from ..ops import forces as F
from ..ops import integrators as I
from ..ops import mdbc as MD
from ..ops import nbrlist as NB
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
    # particles a step could not place, the largest count of any step so
    # far (JAX's carry diagnostic, which fails a run): periodic edge
    # particles beyond the ghost cap and inout spawn requests that found no
    # free slot (with members beyond the extrapolation's static sizes); the
    # GPU layout has no per-cell capacity, so a cell never drops one.  Read
    # in the step's one device-to-host copy; ``overflow_ghosts`` and
    # ``overflow_inout`` keep each kind's largest count
    overflow: int = 0
    overflow_ghosts: int = 0
    overflow_inout: int = 0
    # floating rows with a neighbour row longer than DEM's static row cap
    overflow_dem: int = 0
    # neighbour-list mode: neighbours beyond the list's capacity at the
    # last rebuild (``nbr_overflow``, 0-d on the device, read in each
    # step's one copy; None otherwise) and the largest read so far
    overflow_nbr: int = 0
    nbr_overflow: torch.Tensor | None = None
    # the domain ``cells`` divides: a step on another divides afresh
    dom: cd.Domain | None = None
    # domain decomposition (``parallel/sharding.py``): the halo rows'
    # slots of the last rebuild (``sharding.HaloState``), that rebuild's
    # migrants and ghosts beyond their capacities (0-d on the device, read
    # in each step's one copy) and the largest read so far
    halo: object = None
    shard_overflow: torch.Tensor | None = None
    overflow_shard: int = 0
    t_host: float = 0.0          # host copy of t, read at the end of a step
    rebuild: bool = False        # the next step starts with a divide
    # Verlet steps since the last Euler re-anchoring step (VerletStep); it
    # depends on nstep alone, so it lives on the host
    verlet_count: int = 0
    # AWAS: the accumulated correction displacement of each paddle, (P,)
    awas: torch.Tensor | None = None
    tabs_host: float = 0.0       # host copy of tabs, read at the end of a step
    # SaveDt ring (savedt, 6): [tabs, dt, dt1, dt2, acemax, viscdtmax] of
    # step k in row k % savedt (reference JDsSaveDt); written in place, so
    # carries copied with ``replace`` share it
    dthist: torch.Tensor | None = None
    # floating-motion ring (ftmotion, 1 + 9B): [t, center, fvel, fomega]
    # after step k in row k % ftmotion (JFtMotionSave); written in place
    fthist: torch.Tensor | None = None
    # the dynamic mooring lines' nodes (features.moorings.MoorState)
    moor: object = None
    moor_init_s: float = 0.0     # host seconds of the lines' relaxation


def _rebuild(dom: cd.Domain, carry: StepCarry,
             spec: NB.ListSpec | None = None) -> StepCarry:
    """Divide and permute the state into the fresh cell order (RunCellDivide
    + SortArray, JSphCpuSingle.cpp:450-467, run only when needed); under
    the neighbour-list mode (``spec``) count the list's overflow on the
    fresh layout."""
    st = carry.st
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    st = replace(st, code=code).permuted(cells.order)
    nbr_overflow = None
    if spec is not None:
        nbr_overflow = NB.overflow_count(dom, cells, st.pos, spec)
    return replace(carry, st=st, cells=cells, pos0=st.pos, dom=dom,
                   nbr_overflow=nbr_overflow,
                   nrebuild=carry.nrebuild + 1, rebuild=False)


def _rebuild_needed(csp: CteSph, margin: float, carry: StepCarry,
                    dd=None):
    """Skin contract (JAX ``_rowdiv_tick``): accumulated displacement since
    the last rebuild plus this step's worst-case motion must stay under the
    cell skin.  Returns a 0-d bool tensor on the device.  Under a domain
    decomposition (``dd``) the ghost rows are left out: they move with
    their owners, which count on their own rank."""
    st = carry.st
    act = td.is_active(st.code)
    if dd is not None:
        act = act & ~td.is_periodic(st.code)
    d2 = torch.where(act, ((st.pos - carry.pos0) ** 2).sum(dim=1), 0.0).amax()
    vmax = I.velocity_max(csp, st.vel, st.code)
    return (2.0 * torch.sqrt(d2) + 4.0 * carry.dt_pre * vmax) \
        >= np.float32(0.95 * margin)


def _sync_flags(csp: CteSph, margin: float, carry: StepCarry, filled=None,
                ghosts=None, inout=None, dem=None, nbr=None,
                dd=None) -> StepCarry:
    """The step's one device-to-host copy: the next rebuild flag, t and
    tabs, and with open boundaries, DEM or the neighbour list the step's
    overflow counts (0-d ``ghosts``, ``inout``, ``dem``, ``nbr``).
    ``filled`` (0-d bool), an inout slot filled in the layout's dead tail,
    forces the next rebuild: the skin contract cannot see a reused slot
    (its stale ``pos0`` may lie near the spawn point).  Under a domain
    decomposition (``dd``, a ``sharding.SlabRank``) the flag, the step's
    overflow counts and the last rebuild's are first reduced with MAX over
    the ranks (one collective), so every
    rank rebuilds at the same step and every rank reads the same
    overflow counts."""
    need = (_rebuild_needed(csp, margin, carry) if dd is None
            else _rebuild_needed(csp, margin, carry, dd))
    if filled is not None:
        need = need | filled
    kinds = [(k, v) for k, v in (
        ("ghosts", ghosts), ("inout", inout), ("dem", dem), ("nbr", nbr),
        ("shard", None if dd is None else dd.overflow(carry)))
        if v is not None]
    if dd is not None:
        need, maxima = dd.agree(need, [v for _, v in kinds])
        kinds = [(k, v) for (k, _), v in zip(kinds, maxima)]
    vals = [need.to(carry.t.dtype), carry.t, carry.tabs]
    vals += [v.to(carry.t.dtype) for _, v in kinds]
    out = torch.stack(vals).tolist()
    carry = replace(carry, rebuild=bool(out[0]), t_host=out[1],
                    tabs_host=out[2])
    if kinds:
        got = {f"overflow_{k}": int(x) for (k, _), x in zip(kinds, out[3:])}
        carry = replace(carry, overflow=max(carry.overflow, sum(got.values())),
                        **{k: max(getattr(carry, k), x) for k, x in got.items()})
    return carry


def step_values(csp: CteSph, opts: SolverOpts, feats: Features | None,
                tabs: float):
    """(ddtkh, visco) of a step that starts at absolute time ``tabs`` (a
    host float): the initial DDT ramp (RunInitialDDTRamp,
    JSphCpuSingle.cpp:650-663: maxvalue while t <= tmaxvalue, then linear
    down to ddtvalue at t = tramp) and the viscosity table (JDsViscoInput,
    JSphCpuSingle.cpp:1092), each None when the run has none.  Evaluated in
    float32 with the JAX package's arithmetic (`wcsph.py:328-344`, the
    blend's multiply-add fused as XLA fuses it)."""
    visco = None
    if feats is not None and feats.viscotime is not None:
        visco = float(feats.viscotime.visco_at(tabs))
    ddtkh = None
    if opts.ddtramp is not None:
        tramp, tmaxv, vmax = opts.ddtramp
        f32 = np.float32
        t = f32(tabs)
        trr = f32(max(tramp - tmaxv, 1e-30))
        q = np.float64((f32(tramp) - t) / trr)
        blend = f32(q * np.float64(f32(vmax - csp.ddtvalue))
                    + np.float64(f32(csp.ddtvalue)))
        val = f32(vmax) if t <= f32(tmaxv) else blend
        val = val if t < f32(tramp) else f32(csp.ddtvalue)
        ddtkh = float(f32(csp.kernelsize) * val)
    return ddtkh, visco


def skinless(csp: CteSph, dom: cd.Domain) -> bool:
    """Whether the cells leave no skin beyond the kernel size (JAX's rule
    for its bucket path, `wcsph.py:126`): no layout then holds the pairs
    of moved particles, so each interaction divides afresh."""
    return dom.scell <= csp.kernelsize * (1.0 + 1e-6)


def _margin(csp: CteSph, dom: cd.Domain) -> float:
    """The cells' skin beyond the kernel size, which the skin contract
    spends between rebuilds; without one (:func:`skinless`) every step
    rebuilds."""
    margin = dom.scell - csp.kernelsize
    if margin < 0:
        raise ValueError("cells narrower than the kernel size: the walks "
                         "of 3 cells per axis would miss pairs")
    return margin


def fresh_interaction(dom: cd.Domain, st, interact):
    """One interaction on a divide of its own positions, for a domain
    without a cell skin: runs ``interact(rows, cells) -> (rows, Forces)``
    on the state in cell order and returns the state with the
    interaction's vel, rho and code and the Forces' per-particle arrays
    in the state's own slot order, so the step's arrays (the predictor's,
    ``pose``) stay valid (the divide of ``periodic_interaction`` without
    its ghost rows)."""
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    back = cd.slots_of(cells)
    srt, fr = interact(replace(st, code=code).permuted(cells.order), cells)
    st = replace(st, vel=srt.vel[back], rho=srt.rho[back],
                 code=srt.code[back])
    return st, F.gathered(fr, back)


def check_ids(st: SimState, feats: Features | None) -> None:
    """Periodic and inout boundaries rank particles by id (slot order in
    the JAX package) and DEM keys its tables by id: ValueError unless the
    ids of ``st`` are a permutation of 0..n-1 (one read)."""
    if feats is not None and (feats.periodic is not None
                              or feats.inout is not None
                              or feats.dem is not None):
        if not torch.equal(torch.sort(st.idp).values,
                           torch.arange(st.n, device=st.idp.device)):
            raise ValueError("periodic and inout boundaries and DEM need "
                             "the ids to be a permutation of 0..n-1")


def make_carry(st: SimState, csp: CteSph, opts: SolverOpts,
               dom: cd.Domain, feats: Features | None = None,
               t0: float = 0.0, dd=None) -> StepCarry:
    """Initial carry: the first divide (nrebuild = 1) and dt = DtIni at
    tabs ``t0`` (a restart's PART time, so the DDT ramp, the viscosity
    table and the motions go on from there; 0 on a fresh run), with a
    zero AWAS correction per paddle of ``feats`` and the
    zeroed rings of ``opts.savedt`` / ``opts.ftmotion`` (the latter with
    floating bodies only) and, with dynamic mooring lines, their nodes
    relaxed at the state's bodies (``MoorDynCfg.init_state``, host seconds
    in ``StepCarry.moor_init_s``).  It serves the
    single-phase and the NN steps alike; each step checks its own
    interaction's settings.  The Verlet step reads the M1 state: ValueError
    unless the state has it (the case built with ``need_verlet=True``);
    :func:`check_ids` checks the ids of a state with periodic or inout
    boundaries or DEM.  Under ``opts.use_nbrlist`` the first divide is
    on the neighbour list's grid, with its overflow count (read by the
    first step's copy).  Under a domain decomposition (``dd``, a
    ``sharding.SlabRank``; ``st`` the rank's slots, ``dom`` its slab's
    grid) the first divide is the rank's rebuild: migration, halo rows
    and the divide of its slab; the ids are then the global state's
    (``sharding.ShardedSimulation`` checks them), not the rank's slots'."""
    if dd is None:
        check_ids(st, feats)
    if opts.tstep == TpStep.VERLET and (st.velm1 is None or st.rhom1 is None):
        raise ValueError("the Verlet step needs the M1 state SimState.velm1 "
                         "and SimState.rhom1: build the case with "
                         "need_verlet=True")
    dev = st.pos.device
    f32 = dict(dtype=torch.float32, device=dev)
    nbody = feats.floating.count \
        if feats is not None and feats.floating is not None else 0
    carry = StepCarry(
        st=st,
        t=torch.zeros((), **f32),
        dt_pre=torch.tensor(csp.dtini, **f32),
        dtmodif=torch.zeros((), dtype=torch.int32, device=dev),
        tabs=torch.tensor(t0, **f32),
        cells=None, pos0=None,
        awas=(torch.zeros(len(feats.awas), **f32)
              if feats is not None and feats.awas else None),
        dthist=torch.zeros((opts.savedt, 6), **f32) if opts.savedt else None,
        fthist=(torch.zeros((opts.ftmotion, 1 + 9 * nbody), **f32)
                if opts.ftmotion and nbody else None))
    moorings = feats.moorings if feats is not None else None
    if getattr(moorings, "dynamic", False) and st.ft is not None:
        t0_init = time.perf_counter()
        carry.moor = moorings.init_state(st.ft)
        carry.moor_init_s = time.perf_counter() - t0_init
    dom, spec = NB.layout(csp, opts, dom)
    carry = _rebuild(dom, carry, spec) if dd is None else dd.rebuild(carry)
    return _sync_flags(csp, _margin(csp, dom), carry, dd=dd)


def _interaction(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 st: SimState, cells: cd.CellDiv, ftomassp=None, ddtkh=None,
                 visco=None, refresh=None):
    """The mDBC pre-pass and the forces of one interaction on the current
    layout (the body of `JSphCpuSingle::Interaction_Forces`), with the
    step's launch values ``ddtkh`` and ``visco`` (:func:`step_values`).
    Returns (the state with the pre-pass's boundary velocity and density,
    Forces).  The pre-pass runs under mDBC walls when the state carries
    normals (JAX `wcsph.py:443-449`); without normals an mDBC run is a DBC
    run with the mDBC diffusion rule, as in JAX.  Under ``opts.symmetry``
    only the interaction meets the mirror images: the pre-pass has no
    symmetry term, as JAX's `ops/mdbc.py` has none.  ``refresh(st) ->
    st`` (a domain decomposition's; the caller refreshed the ghost rows
    before the pass) brings them up to date once more after the pre-pass,
    which corrects the owners' walls (JAX `sharding.py:553-569`)."""
    if opts.tboundary == TpBoundary.MDBC and st.boundnormal is not None:
        vel, rho = MD.mdbc_correction(csp, opts, dom, cells, st.pos, st.vel,
                                      st.rho, st.code, st.boundnormal,
                                      st.motionvel)
        st = replace(st, vel=vel, rho=rho)
        if refresh is not None:
            st = refresh(st)
    return st, F.interaction_forces(csp, opts, dom, cells, st.pos, st.vel,
                                    st.rho, st.code, st.spstau, ftomassp,
                                    ddtkh=ddtkh, visco=visco)


def _single_phase(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                  feats: Features | None, spec: NB.ListSpec | None = None,
                  dd=None):
    """(interaction, rigid) of the single-phase steps: the interaction
    ``(st, carry, dt) -> (st, Forces)`` on the carry's layout with the
    floating bodies' particle mass, the launch values of
    :func:`step_values` at the carry's ``tabs_host``, DEM contact after
    the forces (JAX `wcsph.py:454-463`, with the step's dt; under the
    neighbour list ``spec`` over the list's rows, JAX `:363`) and then
    the external accelerations
    (`_post_forces`, JAX `wcsph.py:486-492`: they enter AceMax and the dt
    control); ``rigid(st, ace, t, dt, predictor, moor) -> st``, the floating
    bodies' update with the moorings' and force points' forces (the lines'
    nodes ``moor``) and the Chrono couplings, or None.  Under a domain
    decomposition (``dd``) each interaction first refreshes the ghost rows
    (under periodic boundaries after the wrap and before the images, which
    then include the halo rows), DEM runs over owned and halo rows with
    only the owned ones as targets, its pass walking the rank's own
    floating rows alone, and the bodies' partial sums are added over the
    ranks.  On a slab without a cell skin the ghost rows are exchanged
    afresh before each interaction instead (``dd.exchange``, JAX
    ``_sharded_interaction``), before the wrap under periodic boundaries,
    and the mDBC pre-pass's second refresh writes the slots of that
    exchange, in the interaction's cell order."""
    F.check_supported(csp, opts)
    fresh = skinless(csp, dom)
    floating = accinputs = periodic = dem = None
    if feats is not None:
        feats.check_supported()
        floating, accinputs = feats.floating, feats.accinputs
        periodic, dem = feats.periodic, feats.dem
    dem_layout = DEM.DemLayout(local=dd is not None)

    def interaction(st, carry, dt):
        ftomassp = None
        if floating is not None:
            ftomassp = FT.body_tables(floating, tuple(csp.gravity),
                                      st.pos.device).massp
        ddtkh, visco = step_values(csp, opts, feats, carry.tabs_host)

        refresh = None
        if dd is not None:
            if fresh:
                # the stale ghost rows die and the rows within the halo of
                # each slab edge now come afresh
                st = dd.exchange(st)
            halo = dd.halo if fresh else carry.halo

            def refresh(s):
                return dd.refresh(s, halo)

        def interact(st, cells, refresh):
            st, fr = _interaction(csp, opts, dom, st, cells, ftomassp,
                                  ddtkh=ddtkh, visco=visco, refresh=refresh)
            if dem is not None:
                # after the forces, on the interaction's rows (under
                # periodic boundaries the ghost rows are candidates)
                ace, demdt, ovf = DEM.apply_dem(
                    dem, csp, dom, cells, st.pos, st.vel, st.code, st.idp,
                    dt, layout=dem_layout,
                    ref=None if spec is None else carry.pos0,
                    rcut2=None if spec is None else spec.rcut2)
                fr = replace(fr, ace=fr.ace + ace,
                             viscdtmax=torch.maximum(fr.viscdtmax, demdt),
                             dem_overflow=ovf)
            return st, fr

        if periodic is not None:
            # the wrap, the ghost rows and a divide of their own at every
            # interaction (JAX applies periodic at each one)
            st, fr = PER.periodic_interaction(periodic, csp, dom, st,
                                              interact, refresh)
        elif fresh:
            def interact_sorted(s, cells):
                again = None
                if dd is not None:
                    def again(x):
                        return dd.refresh(x, halo.moved(cd.slots_of(cells)))
                return interact(s, cells, again)

            st, fr = fresh_interaction(dom, st, interact_sorted)
        else:
            if refresh is not None:
                st = refresh(st)
            st, fr = interact(st, carry.cells, refresh)
        if accinputs:
            fr = replace(fr, ace=ACC.apply_accinput(
                accinputs, csp, carry.tabs, st.pos, st.vel, st.code, fr.ace))
        return st, fr

    rigid = None
    if floating is not None:
        def rigid(st, ace, t, dt, predictor, moor):
            if st.ft is None:
                raise ValueError("floating bodies need the body state "
                                 "SimState.ft (features.floating."
                                 "make_floating)")
            eface, efom = _ext_body_forces(feats, st.ft, t, moor)
            pos, vel, ft = FT.run_floating(
                floating, csp, st.ft, t, dt, predictor, st.pos, st.vel,
                st.code, ace, ext_face=eface, ext_fomegaace=efom,
                chrono=feats.chrono, chcontact=feats.chcontact,
                reduce_sum=None if dd is None else dd.reduce_sum)
            return replace(st, pos=pos, vel=vel, ft=ft)

    return interaction, rigid


def _ext_body_forces(feats: Features, fts, tabs, moor):
    """(face, fomegaace) of the moorings and force points, or Nones (JAX
    ``_ext_body_forces``, `wcsph.py:470-483`: the analog of folding
    JDsFtForcePoints into FtoForces, JSphCpuSingle.cpp:903-913)."""
    face = fom = None
    if feats.moorings is not None:
        if getattr(feats.moorings, "dynamic", False):
            face, fom = feats.moorings.forces(fts, moor, tabs=tabs)
        else:
            face, fom = feats.moorings.forces(fts)
    if feats.forcepoints is not None:
        f2, m2 = feats.forcepoints.forces(fts, tabs)
        face = f2 if face is None else face + f2
        fom = m2 if fom is None else fom + m2
    return face, fom


def _after_update(csp: CteSph, feats: Features | None, rigid,
                  write_motionvel: bool):
    """after(st, ace, tabs, dt, awas, moor) -> (st, awas, moor): the hooks
    that run after the step's update, in the JAX package's order
    (`wcsph.py:610-636`, `:728-750`): the floating bodies over dt and the
    dynamic mooring lines to their new state, damping, relaxation zones,
    scripted motion, multi-layer pistons and AWAS.  ``write_motionvel``:
    the motion writes the moving walls' velocity into ``motionvel`` for the
    mDBC pre-pass, as the JAX symplectic step does (`:621-623`); its Verlet
    step leaves ``motionvel`` as it is (`:735-738`).  None when there is
    nothing to run."""
    if feats is None or not (rigid or feats.damping or feats.relaxzones
                             or feats.motions or feats.mlpistons or feats.awas):
        return None

    def after(st, ace, tabs, dt, awas, moor):
        if rigid is not None:
            st = rigid(st, ace, tabs, dt, False, moor)
            if moor is not None:
                # the lines to the step's end state of the bodies (the
                # MoorDyn_FairleadsCalc coupling, JSphCpuSingle.cpp:1009)
                moor = feats.moorings.advance(moor, st.ft, dt, tabs=tabs)
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
        return st, awas, moor

    return after


def _inout_hook(csp: CteSph, dom: cd.Domain, feats: Features | None,
                dd=None):
    """inout(st, carry) -> (st, overflow, ghosts, filled): the inlet/outlet
    pass
    after the step's other hooks (JAX `wcsph.py:638-641`, `:752-755`) at
    the carry's ``tabs`` and ``nstep``, reading its layout for the
    extrapolated modes; None without zones.  On a domain without a cell
    skin no layout holds the post-step positions: the extrapolated modes
    read a divide of their own instead (JAX `features/inout.py:458`), the
    state left in its slot order, and on a slab the ghost rows are first
    exchanged afresh for them.  Conversions, captures and
    destructions change codes only, which kernel 1 reads at every launch;
    a filled slot forces the next rebuild (:func:`_sync_flags`).  Under a
    domain decomposition (``dd``) a spawn takes only the slots
    ``dd.spawn_slots`` leaves it, ``dd.spawned`` counts the spawns and
    the requests that found no slot, and the calculated zsurf and the AWAS
    column mass are reduced over the ranks (JAX's ``pmax`` and ``psum``,
    `features/inout.py:148-149`, `:382`).  Under periodic boundaries the
    pass reads the periodic images of the state's rows as sources, as
    JAX's zones read the ghosts its state holds (`features/inout.py:138`,
    `:374`, `:466`): ``ghosts`` counts the edge particles beyond the ghost
    cap, as an interaction's overflow does (None without periodic
    boundaries)."""
    if feats is None or feats.inout is None:
        return None
    flat = skinless(csp, dom)
    fresh = flat and IO.any_extrap(feats.inout)
    periodic = feats.periodic

    def inout(st, carry):
        if fresh and dd is not None:
            st = dd.exchange(st)
        layout = dict(dom=dom, cells=carry.cells)
        ghost_ovf = None
        if periodic is not None:
            layout["images"], ghost_ovf = PER.images(
                periodic, csp, st, halo=dd is not None)
        elif fresh:
            cells, _ = cd.divide_cells(dom, st.pos, st.code)
            layout.update(cells=cells, order=cells.order)
        if dd is None:
            out, ovf, filled = IO.inout_step(
                feats.inout, csp, st, carry.tabs, nstep=carry.nstep,
                **layout)
            return out, ovf, ghost_ovf, filled
        usable = dd.spawn_slots(st, dd.halo if flat else carry.halo)
        out, ovf, filled = IO.inout_step(
            feats.inout, csp, st, carry.tabs, nstep=carry.nstep,
            usable=usable, owns=dd.owns,
            reduce_max=lambda x: dd.reduce_max(x)[0],
            reduce_sum=dd.reduce_sum, **layout)
        dd.spawned((usable & ~td.is_active(st.code)
                    & td.is_active(out.code)).sum() + ovf)
        return out, ovf, ghost_ovf, filled

    return inout


def _largest(values):
    out = None
    for v in values:
        if v is not None:
            out = v if out is None else torch.maximum(out, v)
    return out


def _ghost_overflow(frs, images=None):
    """The step's periodic ghost overflow: the largest of its
    interactions' and of the inlet/outlet pass's periodic images'
    (``images``; None without periodic boundaries)."""
    return _largest([fr.overflow for fr in frs] + [images])


def _dem_overflow(frs):
    """The step's DEM row overflow: the largest of its interactions'
    (None without DEM)."""
    return _largest(fr.dem_overflow for fr in frs)


def make_symplectic_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                         feats: Features | None = None, dd=None):
    """Returns step(carry) -> carry implementing ComputeStep_Sym
    (JSphCpuSingle.cpp:695-722) over the single-phase interaction, with the
    floating bodies of ``feats`` moved after the predictor (dt/2) and the
    corrector (dt), JSphCpuSingle.cpp:707,715, and the other hooks of
    ``feats`` after the corrector; under ``opts.use_nbrlist`` on the
    neighbour list's layout; ``dd``: one rank of a domain decomposition
    (:func:`symplectic_step`)."""
    dom, spec = NB.layout(csp, opts, dom)
    interaction, rigid = _single_phase(csp, opts, dom, feats, spec, dd)
    return symplectic_step(csp, opts, dom, interaction, rigid,
                           _after_update(csp, feats, rigid, True),
                           _inout_hook(csp, dom, feats, dd), spec, dd)


def make_verlet_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                     feats: Features | None = None, dd=None):
    """Returns step(carry) -> carry implementing ComputeStep_Ver
    (JSphCpuSingle.cpp:674-690): one interaction on the current layout, dt
    from it, the leapfrog against the M1 state with an Euler re-anchoring
    step every ``opts.verlet_steps`` steps (JAX `wcsph.py:662-773`), then
    the hooks of ``feats``.  The next step's skin-contract lookahead reads
    this step's dt; under ``opts.use_nbrlist`` on the neighbour list's
    layout; ``dd``: one rank of a domain decomposition, as in
    :func:`symplectic_step`."""
    dom, spec = NB.layout(csp, opts, dom)
    interaction, rigid = _single_phase(csp, opts, dom, feats, spec, dd)
    after = _after_update(csp, feats, rigid, False)
    inout = _inout_hook(csp, dom, feats, dd)
    margin = _margin(csp, dom)

    def step(carry: StepCarry) -> StepCarry:
        carry = _start(dom, carry, spec, dd)
        st, fr = interaction(carry.st, carry, carry.dt_pre)
        velmax, acemax, viscdtmax, _ = _maxima(csp, st, fr, dd)
        dt, bad, dt1, dt2 = I.dt_variable_parts(csp, acemax, velmax,
                                                viscdtmax)
        _record_dt(carry, [carry.tabs, dt, dt1, dt2, acemax, viscdtmax])
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
        awas, moor = carry.awas, carry.moor
        if after is not None:
            st, awas, moor = after(st, fr.ace, carry.tabs, dt, awas, moor)
        ovf_io = ovf_img = filled = None
        if inout is not None:
            st, ovf_io, ovf_img, filled = inout(st, carry)
        _record_ftmotion(carry, st, carry.tabs + dt)
        carry = replace(
            carry, st=st, t=carry.t + dt, dt_pre=dt, nstep=carry.nstep + 1,
            verlet_count=vcount if use_m1 else 0,
            dtmodif=carry.dtmodif + bad.to(torch.int32),
            tabs=carry.tabs + dt, awas=awas, moor=moor)
        return _sync_flags(csp, margin, carry, filled,
                           _ghost_overflow((fr,), ovf_img), ovf_io,
                           _dem_overflow((fr,)), carry.nbr_overflow, dd)

    return step


def _start(dom: cd.Domain, carry: StepCarry, spec, dd) -> StepCarry:
    """The carry a step starts from: divided afresh when the last step's
    flag asks for it or the carry's layout is another domain's (a domain
    decomposition's rank rebuilds through ``dd``)."""
    if carry.rebuild or carry.dom != dom:
        return _rebuild(dom, carry, spec) if dd is None else dd.rebuild(carry)
    return carry


def _maxima(csp: CteSph, st: SimState, fr: F.Forces, dd):
    """(velmax, acemax, viscdtmax, viscetadtmax) of one interaction for the
    dt control, each reduced with MAX over the ranks of a domain
    decomposition in one collective (``viscetadtmax`` None on the
    single-phase path)."""
    vals = (I.velocity_max(csp, st.vel, st.code), I.ace_max(fr.ace, st.code),
            fr.viscdtmax, fr.viscetadtmax)
    return vals if dd is None else dd.reduce_max(*vals)


def _record_dt(carry: StepCarry, row) -> None:
    """Write the step's SaveDt row into ``carry.dthist`` (JAX `wcsph.py:
    575-578`, `:691-694`), one indexed copy on the device."""
    if carry.dthist is not None:
        carry.dthist[carry.nstep % carry.dthist.shape[0]] = torch.stack(row)


def _record_ftmotion(carry: StepCarry, st: SimState, t_next) -> None:
    """Write one [t, center, fvel, fomega] row into ``carry.fthist`` (the
    per-dt capture of JFtMotionSave::SaveFtData; JAX ``_record_ftmotion``,
    `wcsph.py:281-291`)."""
    if carry.fthist is None or st.ft is None:
        return
    ft = st.ft
    carry.fthist[carry.nstep % carry.fthist.shape[0]] = torch.cat([
        t_next.reshape(1), ft.center.reshape(-1).float(),
        ft.fvel.reshape(-1).float(), ft.fomega.reshape(-1).float()])


def _sps_tau(csp: CteSph, st: SimState, fr: F.Forces):
    """The SPS stress of the forces' velocity gradient at the density the
    interaction read, zero for all but fluid particles."""
    tau = F.compute_sps_tau(csp, st.rho, fr.spsgradvel)
    return torch.where(td.is_fluid(st.code)[:, None], tau, 0.0)


def symplectic_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                    interaction, rigid=None, after=None, inout=None,
                    spec: NB.ListSpec | None = None, dd=None):
    """step(carry) -> carry: the symplectic predictor and corrector over
    ``interaction(st, carry, dt) -> (st, Forces)`` on one layout of
    ``dom`` (the carry's ``cells``, ``pos0``, ``tabs`` and ``tabs_host``,
    the step's start time on the host; ``dt`` the step's, on the device),
    divided afresh when the carry's is another domain's; the
    state it returns (the mDBC pre-pass's boundary values) goes on,
    as in JAX.  What the forces carry switches the rest: ``viscetadtmax``
    the NN dt3 control, ``spsgradvel`` the SPS stress after each
    interaction, ``shiftposfs`` the shifting displacement in the corrector.
    ``rigid(st, ace, t, dt, predictor, moor) -> st`` moves the floating
    bodies after the predictor (dt/2); ``after(st, ace, tabs, dt, awas,
    moor) -> (st, awas, moor)`` runs the hooks after the corrector
    (:func:`_after_update`, the bodies over dt and the mooring lines among
    them); ``inout(st, carry) -> (st, overflow, ghosts, filled)`` the
    inlet/outlet pass last (:func:`_inout_hook`).
    ``spec``: the neighbour list's, whose overflow each rebuild counts.
    ``dd``: one rank of a domain decomposition (``parallel/sharding.py``
    ``SlabRank``): ``dom`` is its slab's grid, the rebuild migrates and
    picks the halo rows, the dt maxima and the rebuild flag are reduced
    with MAX over the ranks, and ``interaction`` refreshes the ghost
    rows."""
    margin = _margin(csp, dom)

    def step(carry: StepCarry) -> StepCarry:
        carry = _start(dom, carry, spec, dd)
        st = carry.st
        dt = carry.dt_pre

        # ---------------- predictor ----------------
        st, fr1 = interaction(st, carry, dt)
        velmax1, acemax1, viscdt1, eta1 = _maxima(csp, st, fr1, dd)
        dt_p, bad_p = I.dt_variable(csp, acemax1, velmax1, viscdt1, eta1,
                                    opts.relaxationdt)
        pos_pre, vel_pre, rho_pre = st.pos, st.vel, st.rho
        pos1, vel1, rho1, code1 = I.symplectic_pre(
            csp, st.pos, st.vel, st.rho, st.code, fr1.ace, fr1.ar, dt)
        if fr1.spsgradvel is not None:
            st = replace(st, spstau=_sps_tau(csp, st, fr1))
        st = replace(st, pos=pos1, vel=vel1, rho=rho1, code=code1)
        if rigid is not None:
            st = rigid(st, fr1.ace, carry.tabs, dt * 0.5, True, carry.moor)

        # ---------------- corrector (same layout) ----------------
        st, fr2 = interaction(st, carry, dt)
        velmax2, acemax2, viscdt2, eta2 = _maxima(csp, st, fr2, dd)
        dt_c, bad_c, dt1_c, dt2_c = I.dt_variable_parts(
            csp, acemax2, velmax2, viscdt2, eta2, opts.relaxationdt)
        _record_dt(carry, [carry.tabs, dt, dt1_c, dt2_c, acemax2, viscdt2])
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
        awas, moor = carry.awas, carry.moor
        if after is not None:
            st, awas, moor = after(st, fr2.ace, carry.tabs, dt, awas, moor)
        ovf_io = ovf_img = filled = None
        if inout is not None:
            st, ovf_io, ovf_img, filled = inout(st, carry)
        _record_ftmotion(carry, st, carry.tabs + dt)

        carry = replace(
            carry, st=st, t=carry.t + dt, dt_pre=torch.minimum(dt_p, dt_c),
            nstep=carry.nstep + 1,
            dtmodif=carry.dtmodif + bad_p.to(torch.int32)
            + bad_c.to(torch.int32),
            tabs=carry.tabs + dt, awas=awas, moor=moor)
        return _sync_flags(csp, margin, carry, filled,
                           _ghost_overflow((fr1, fr2), ovf_img), ovf_io,
                           _dem_overflow((fr1, fr2)), carry.nbr_overflow, dd)

    return step


def make_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
              feats: Features | None = None, dd=None):
    """The single-phase step of ``opts.tstep``; the neighbour-list mode
    refuses what changes the population mid-run, with JAX's words
    (`wcsph.py:778-784`).  ``dd``: one rank of a domain decomposition."""
    if opts.use_nbrlist and feats is not None and (
            feats.periodic is not None or feats.inout is not None):
        raise NotImplementedError("nbrlist mode does not support periodic "
                                  "ghosts or inlet/outlet zones")
    if opts.tstep == TpStep.SYMPLECTIC:
        return make_symplectic_step(csp, opts, dom, feats, dd)
    return make_verlet_step(csp, opts, dom, feats, dd)


def make_advance(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 feats: Features | None = None, step=None):
    """advance(carry, t_target, nstep_max): run steps until interval time
    >= t_target or nstep reaches nstep_max (the reference's main loop
    between PART saves, JSphCpuSingle.cpp:1090-1120).  ``step`` replaces
    the single-phase step, e.g. with ``nnewtonian.make_nn_step``."""
    step = step or make_step(csp, opts, dom, feats)

    def advance(carry: StepCarry, t_target: float, nstep_max: int):
        # the target in float32, as the JAX loop compares it with its f32 t
        t_target = float(np.float32(t_target))
        while carry.t_host < t_target and carry.nstep < nstep_max:
            carry = step(carry)
        return carry

    return advance


class Simulation:
    """Host-side run loop (`JSphCpuSingle::Run`, JSphCpuSingle.cpp:
    1049-1202): owns the step, the save schedule and the diagnostics.
    JAX's ``steps_per_call`` adaptation guards a TPU launch watchdog around
    its device loop; the steps here are launched one by one from the host,
    so it has no counterpart."""

    # excluded-fluid cap: fraction of the initial fluid allowed out before
    # the run aborts (XML <PartsOutMax>, reference NpfOutMax/NpMinimum check
    # JSphCpuSingle.cpp:1101-1106); None disables
    partsoutmax: float | None = None
    # directory for failure-evidence dumps (Error_BoundaryOut.vtk)
    errdir: str = "."

    def __init__(self, csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 state: SimState, feats: Features | None = None, step=None,
                 log=print, t0: float = 0.0):
        """``t0``: the start time, a restart's PART time (``io.output.
        restart_state``); the step's clock ``tabs`` starts there too."""
        self.csp, self.opts, self.dom = csp, opts, dom
        self.feats = feats
        self.carry = make_carry(state, csp, opts, dom, feats, t0=t0)
        self.advance = make_advance(csp, opts, dom, feats, step=step)
        self.part = 0
        self.time = t0         # global simulation time (host f64 accumulator)
        self.log = log
        self._nfluid0 = None

    @property
    def state(self) -> SimState:
        return self.carry.st

    def check_diagnostics(self):
        """Raise on boundary particles excluded from the domain, after
        dumping them to ``errdir``/Error_BoundaryOut.vtk in slot order
        (reference AbortBoundOut, JSph.cpp:2477), and on excluded fluid
        beyond ``partsoutmax`` of the initial fluid."""
        c = self.carry
        if c.overflow:
            kinds = []
            if c.overflow_ghosts:
                kinds.append(f"{c.overflow_ghosts} periodic edge "
                             f"particle(s) beyond the ghost cap (raise "
                             f"PeriodicCfg.ghost_cap)")
            if c.overflow_dem:
                kinds.append(f"{c.overflow_dem} DEM floating row(s) with a "
                             f"neighbour row beyond celldiv.row_cap "
                             f"(a state denser than 0.85 dp)")
            if c.overflow_shard:
                kinds.append(f"{c.overflow_shard} particle(s) beyond the "
                             f"domain decomposition's migration or halo "
                             f"capacity (raise make_shard_cfg's mig_cap or "
                             f"ghost_cap)")
            if c.overflow_nbr:
                kinds.append(f"{c.overflow_nbr} neighbour(s) beyond the "
                             f"neighbour list's capacity of "
                             f"{NB.capacity(self.csp, self.opts)} (raise "
                             f"SolverOpts.nbr_m)")
            if c.overflow_inout:
                kinds.append(f"{c.overflow_inout} inout spawn request(s) "
                             f"with no free slot or extrapolated member(s) "
                             f"beyond the pass's sizes (raise the state "
                             f"capacity; reference analog: "
                             f"ResizeParticlesSize)")
            raise RuntimeError(f"overflow: {c.overflow} in one step: "
                               + "; ".join(kinds))
        st = self.carry.st
        code = st.code.cpu().numpy()
        sp = td.code_special(code)
        # OUT_IGNORE marks never-active spare slots, not exclusions
        out = (sp >= td.SPECIAL_OUT_POS) & (sp != td.SPECIAL_OUT_IGNORE)
        bound_out = out & (td.code_type(code) < td.TYPE_FLUID)
        if bound_out.any():
            from ..io import vtkout
            p = os.path.join(self.errdir, "Error_BoundaryOut.vtk")
            try:
                os.makedirs(self.errdir, exist_ok=True)
                vtkout.write_vtk_particles(
                    p, st.pos.cpu().numpy()[bound_out],
                    {"Idp": st.idp.cpu().numpy()[bound_out]})
            except OSError:
                p = "(vtk dump failed)"
            raise RuntimeError(
                f"{int(bound_out.sum())} boundary particle(s) excluded from "
                f"the domain (evidence: {p}; reference AbortBoundOut, "
                f"JSph.cpp:2477)")
        if self.partsoutmax is not None:
            fluid_out = int((out & (td.code_type(code) == td.TYPE_FLUID)
                             & ~td.is_floating(code)).sum())
            if self._nfluid0 is None:
                act = td.is_active(code) | out
                self._nfluid0 = int(
                    (td.code_type(code) == td.TYPE_FLUID)[act].sum())
            nfluid0 = self._nfluid0
            if nfluid0 and fluid_out > self.partsoutmax * nfluid0:
                raise RuntimeError(
                    f"excluded fluid particles ({fluid_out}) exceed "
                    f"PartsOutMax={self.partsoutmax:g} of {nfluid0} "
                    f"(reference NpMinimum check, JSphCpuSingle.cpp:1101)")

    def run(self, tmax: float, tout, on_save=None, max_steps=None,
            terminate=None, next_subtick=None, on_subtick=None,
            every_step=False):
        """Run to ``tmax`` saving every ``tout`` seconds of simulation time.
        ``tout`` may be a float or an ``io.output.OutputTime`` schedule
        (JDsOutputTime).  ``terminate``: a ``utils.runinfo.TerminateCheck``
        polled between save intervals (JSph::CheckTermination).
        ``max_steps``: stop after the first save at or past that many steps
        (the CLI's ``-nsteps``).  ``every_step``: a save after every step,
        at the step's end time, ``tout`` then bounding nothing but the
        end test (the CLI's ``-svsteps``; the JAX CLI's tout of 1e-9
        saves once per 1e-9 s of simulated time instead, ``ROADMAP.md``
        §3).

        ``next_subtick(t_abs) -> t or None`` and ``on_subtick(sim, t_abs)``
        are the in-interval hooks of the gauges' own cadence (computedt,
        JDsGaugeSystem.cpp:447; ``features.gauges.GaugeSystem.next_time``):
        the steps stop at the first step end at or past the next pending
        tick inside the save interval, and ``on_subtick`` runs there."""
        interval = (tout.interval if hasattr(tout, "interval")
                    else (lambda t: tout))
        t0 = time.time()
        if on_save:
            on_save(self)
        while self.time < tmax - 1e-5 * interval(self.time):
            if terminate is not None:
                newmax = terminate.poll()
                if newmax is not None:
                    tmax = min(tmax, max(newmax, self.time))
                    self.log(f"TERMINATE file: tmax -> {tmax:g}")
                    if self.time >= tmax:
                        break
            target = min(interval(self.time), tmax - self.time)
            carry = self.carry
            if every_step:
                carry = self.advance(carry, float("inf"), carry.nstep + 1)
                target = carry.t_host
            while not every_step:
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
            self._eta_print(tmax, t0)
            self.walltime = time.time() - t0
            if on_save:
                on_save(self)
            if max_steps is not None and self.carry.nstep >= max_steps:
                break
        self.walltime = time.time() - t0
        return self

    # ETA print schedule in wall-clock seconds (JTimeControl: the reference
    # prints estimates at 30, 60, 300, 600, ... s, JSphCpuSingle.cpp:1083)
    _eta_schedule = (30.0, 60.0, 300.0)
    _eta_next_idx = 0
    _eta_next = 30.0

    def _eta_print(self, tmax, t0):
        elapsed = time.time() - t0
        if elapsed < self._eta_next or self.time <= 0:
            return
        frac = min(self.time / tmax, 1.0)
        eta = elapsed / frac * (1.0 - frac)
        self.log(f"Part_{self.part:04d}  t={self.time:.6f}  "
                 f"steps={self.carry.nstep}  "
                 f"{frac * 100:.1f}% done, estimated {eta:.0f}s left")
        if self._eta_next_idx + 1 < len(self._eta_schedule):
            self._eta_next_idx += 1
            self._eta_next = self._eta_schedule[self._eta_next_idx]
        else:
            self._eta_next = elapsed + self._eta_schedule[-1]
