"""Multiphase non-Newtonian solver (the mphase model family) on torch.

Counterpart of `dualsphysics_multilayer_tpu/models/nnewtonian.py`:
``make_nn_step``, ``make_nn_csp`` and the 2D wet dam break
``wet_dambreak_nn``; ``layered_dambreak_nn`` cuts its mud column into
strata of their own phases, a phase table of any count.  The step is the
single-phase symplectic step (``wcsph.symplectic_step``: one cell-sorted
layout for the predictor and the corrector, re-divided only when the skin
contract demands it) over the NN interaction of ``ops/forces_nn.py``,
whose ``viscetadtmax`` adds the viscous dt3 control.  The port's single layout plays the part of the JAX
package's ``nn_rowdiv_ok`` path.

Under mDBC walls (normals from ``<initialize>``, ``-initnorpla`` or
``Boundary=2``) the step stays JAX's: it runs no mDBC pre-pass (JAX
`models/nnewtonian.py:41-104`), so the walls keep their own velocity and
density, and the walls change one rule of the interaction, Molteni's
diffusion, which a wall neighbour no longer blocks.  The CLI prints
:data:`MDBC_NOTE` at the start of such a run.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph, make_ctesph
from ..features.featureset import Features
from ..ops import celldiv as cd
from ..ops import forces_nn as NN
from ..ops.forces import SolverOpts
from . import cases as C
from . import wcsph as W

MDBC_NOTE = ("NN step under mDBC walls: no mDBC pre-pass runs (as in the "
             "JAX package); the walls change only the Molteni diffusion "
             "rule")

def make_nn_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 phases: NN.PhaseCfg, feats: Features | None = None,
                 dd=None):
    """step(carry) -> carry: the symplectic step over the NN interaction
    (ComputeStep_Sym with the _NN_SPH or _NN_FDA interaction,
    JSphCpu_NN_SPH.cpp:663, JSphCpu_NN_FDA.cpp:129).  It takes no per-step
    launch values: the JAX NN step reads neither the DDT ramp nor the
    viscosity table, and writes no SaveDt row, so ``check_supported_nn``
    refuses ``savedt``, ``ftmotion`` and ``ddtramp`` rather than fill
    SaveDt.csv with zeros as JAX does.  It runs no feature hook either
    (JAX's NN step has none), so any set field of ``feats`` (motions,
    damping, the viscosity table, ...) raises NotImplementedError naming
    its XML node, where JAX would run the case with it ignored.  It
    ignores ``opts.use_nbrlist``, as JAX's does: it walks ``dom``, and a
    carry made on the neighbour list's grid is divided afresh on its first
    step.  On a domain without a cell skin each interaction divides
    afresh (``wcsph.fresh_interaction``).  ``dd``: one rank of a domain
    decomposition (``parallel/sharding.py``, a 2-cell halo): each
    interaction refreshes the ghost rows first (on a slab without a cell
    skin, exchanges them afresh), and ``wcsph.symplectic_step`` reduces
    the dt maxima, viscetadtmax among them, over the ranks."""
    if feats is not None:
        feats.check_none_set("the NN step")
    NN.check_supported_nn(csp, opts, phases)
    fresh = W.skinless(csp, dom)

    def forces(st: W.SimState, cells):
        fr, _eta, _tau = NN.interaction_forces_nn(
            csp, opts, phases, dom, cells, st.pos, st.vel, st.rho, st.code)
        return st, fr

    def interaction(st: W.SimState, carry: W.StepCarry, dt):
        if dd is not None:
            st = dd.exchange(st) if fresh else dd.refresh(st, carry.halo)
        if fresh:
            return W.fresh_interaction(dom, st, forces)
        return forces(st, carry.cells)

    return W.symplectic_step(csp, opts, dom, interaction, dd=dd)


def make_nn_csp(*, simulate2d, dp, phases: NN.PhaseCfg, gravity=(0, 0, -9.81),
                coefh=1.0, cflnumber=0.2, hswl=1.0, **kw) -> CteSph:
    """System constants for a multiphase run: cs0 = max phase cs0, rhop0 and
    masses of phase 0 as the bound reference (ConfigConstantsMP); the
    density-exclusion window spans every phase's rest density and the dt
    floor drops 1e-5x (CoefDtMin *= 1e-5), since the viscous dt3 control
    may drive dt far below the single-phase floor."""
    csp = make_ctesph(simulate2d=simulate2d, dp=dp, gravity=gravity,
                      coefh=coefh, cflnumber=cflnumber, hswl=hswl,
                      speedsound=phases.system_cs0(),
                      rhopzero=phases.phases[0].rho0, **kw)
    rmin = min(p.rho0 for p in phases.phases)
    rmax = max(p.rho0 for p in phases.phases)
    return csp.replace(rhopoutmin=0.6 * rmin, rhopoutmax=1.5 * rmax,
                       dtmin=csp.dtmin * 1e-5)


def wet_dambreak_nn(dp=0.02, *, tank=(2.0, 1.0), mud=(0.5, 0.3),
                    water_depth=0.15, mud_rho=1500.0, water_rho=1000.0,
                    mud_visco=0.1, hbp_m=10.0, hbp_n=1.0, tau_yield=0.001,
                    device="cuda"):
    """2D wet dam break: an HBP mud column (phase 1) collapsing into a
    water layer (phase 0) in a tank with bottom, left and right walls (the
    examples/mphase_nnewtonian/01_WetDambreak family; phase parameters
    mirror CaseWetDambreak2DNN_Def.xml's <nnphases> block).  Water starts
    hydrostatic, the mud column at its phase's rest density.  Returns
    (Case, PhaseCfg)."""
    g = 9.81
    cs_w = 20.0 * math.sqrt(g * max(mud[1], water_depth))
    phases = NN.PhaseCfg(phases=(
        NN.Phase(mkfluid=0, rho0=water_rho, csound=cs_w, visco=0.05,
                 tau_yield=0.0005, hbp_m=0.0, hbp_n=1.0),
        NN.Phase(mkfluid=1, rho0=mud_rho,
                 csound=cs_w * math.sqrt(mud_rho / water_rho), visco=mud_visco,
                 tau_yield=tau_yield, hbp_m=hbp_m, hbp_n=hbp_n),
    ))
    csp = make_nn_csp(simulate2d=True, dp=dp, phases=phases,
                      hswl=max(mud[1], water_depth))
    d = C.Draw(dp=dp, simulate2d=True)
    # water layer, then the mud column over it, then the tank's walls
    d.box((0, 0, 0), (tank[0], 0, water_depth), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (mud[0], 0, mud[1]), ptype=td.TYPE_FLUID, mk=1)
    d.box((0, 0, 0), (tank[0], 0, tank[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|left|right")
    pos, code = d.build()
    dom = C._make_domain(csp, pos)
    st = C._make_state(csp, pos, code, zsurf=water_depth, device=device)
    ismud = torch.tensor((td.code_type(code) == td.TYPE_FLUID)
                         & (td.code_value(code) == 1), device=device)
    st.rho = torch.where(ismud, float(mud_rho), st.rho)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    case = C.Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                  meta=dict(name="wet_dambreak_nn", dp=dp, phases=phases,
                            zsurf=water_depth))
    return case, phases


def layered_phases(water: NN.Phase, mud: NN.Phase, layers: int,
                   water_rho: float = 1000.0) -> NN.PhaseCfg:
    """``water`` as phase 0 and ``layers`` HBP muds as phases 1..layers,
    bottom to top, each with its own rest density (from 1.2 to 0.8 times
    ``mud``'s excess over water), consistency (2 to 0.5 times ``mud``'s),
    yield stress (2 to 0.5 times) and sound speed (``water``'s scaled by
    sqrt(rho0 / water_rho), as :func:`wet_dambreak_nn` does), with
    ``mud``'s power index; every third layer also takes the bi-viscosity
    constants (tau_max 10 times its yield stress, Bi_multi 20).  Under
    FDA, whose strain magnitude is the square of the rate
    (``forces_nn.strain_magn_pair``), a power index above 1 beside the
    no-slip walls blows up at dp 3.21 mm, in the JAX package as in the
    port (``ROADMAP.md`` §3)."""
    out = [water]
    for k in range(1, layers + 1):
        f = (k - 1) / max(layers - 1, 1)
        rho0 = water_rho + (mud.rho0 - water_rho) * (1.2 - 0.4 * f)
        tauy = mud.tau_yield * 2.0 ** (1.0 - 2.0 * f)
        bi = k % 3 == 0
        out.append(NN.Phase(
            mkfluid=k, rho0=rho0,
            csound=water.csound * math.sqrt(rho0 / water_rho),
            visco=mud.visco * 2.0 ** (1.0 - 2.0 * f), tau_yield=tauy,
            tau_max=10.0 * tauy if bi else 0.0, bi_multi=20.0 if bi else 0.0,
            hbp_m=mud.hbp_m, hbp_n=mud.hbp_n))
    return NN.PhaseCfg(phases=tuple(out))


def layered_dambreak_nn(dp=0.02, *, layers=11, tank=(2.0, 1.0),
                        mud=(0.5, 0.3), water_depth=0.15, device="cuda",
                        **kw):
    """:func:`wet_dambreak_nn` with its mud column cut into ``layers``
    horizontal strata of equal height (its rows' span plus dp, a row in
    the stratum of its middle), phase k =
    1..layers from the bottom (:func:`layered_phases`), each at its own
    rest density: a phase table of 1 + ``layers`` phases, the same
    particles.  ``kw`` goes to :func:`wet_dambreak_nn`.  Returns (Case,
    PhaseCfg)."""
    case, base = wet_dambreak_nn(dp, tank=tank, mud=mud,
                                 water_depth=water_depth, device=device, **kw)
    water_rho = base.phases[0].rho0
    phases = layered_phases(base.phases[0], base.phases[1], layers, water_rho)
    st = case.state
    ismud = td.is_fluid(st.code) & (td.code_value(st.code) == 1)
    csp = make_nn_csp(simulate2d=True, dp=dp, phases=phases,
                      hswl=max(mud[1], water_depth))
    z = st.pos[:, 2]
    z0, z1 = float(z[ismud].min()), float(z[ismud].max())
    k = ((z - z0 + 0.5 * dp) / ((z1 - z0 + dp) / layers)).floor()
    layer = torch.clamp(k.to(st.code.dtype), 0, layers - 1) + 1
    rho0 = phases.tables(csp, device)["rho0"][layer.long()]
    st = dataclasses.replace(
        st, code=torch.where(ismud, st.code - 1 + layer, st.code),
        rho=torch.where(ismud, rho0, st.rho))
    meta = dict(case.meta, name="layered_dambreak_nn", phases=phases)
    return dataclasses.replace(case, csp=csp, state=st, meta=meta), phases
