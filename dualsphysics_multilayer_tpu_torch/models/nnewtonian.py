"""Multiphase non-Newtonian solver (the mphase model family) on torch.

Counterpart of `dualsphysics_multilayer_tpu/models/nnewtonian.py`:
``make_nn_step``, ``make_nn_csp`` and the 2D wet dam break
``wet_dambreak_nn``.  The step is the single-phase symplectic step
(``wcsph.symplectic_step``: one cell-sorted layout for the predictor and
the corrector, re-divided only when the skin contract demands it) over the
NN interaction of ``ops/forces_nn.py``, whose ``viscetadtmax`` adds the
viscous dt3 control.  The port's single layout plays the part of the JAX
package's ``nn_rowdiv_ok`` path.

Under mDBC walls (normals from ``<initialize>``, ``-initnorpla`` or
``Boundary=2``) the step stays JAX's: it runs no mDBC pre-pass (JAX
`models/nnewtonian.py:41-104`), so the walls keep their own velocity and
density, and the walls change one rule of the interaction, Molteni's
diffusion, which a wall neighbour no longer blocks.  The CLI prints
:data:`MDBC_NOTE` at the start of such a run.
"""

from __future__ import annotations

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
                 phases: NN.PhaseCfg, feats: Features | None = None):
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
    step."""
    if feats is not None:
        feats.check_none_set("the NN step")
    NN.check_supported_nn(csp, opts, phases)

    def interaction(st: W.SimState, carry: W.StepCarry, dt):
        fr, _eta, _tau = NN.interaction_forces_nn(
            csp, opts, phases, dom, carry.cells, st.pos, st.vel, st.rho,
            st.code)
        return st, fr

    return W.symplectic_step(csp, opts, dom, interaction)


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
