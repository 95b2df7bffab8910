"""The slice end to end: symplectic steps of the small 3D dam break
(the geometry of __graft_entry__.py, 876 particles) through the port
against the JAX package's ``make_step(use_pallas=False)`` on the same
state, plus the run loop.

Contract (README, sharded-vs-single): positions agree within 1e-4*dp,
compared by particle id since the port re-sorts its slots; density within
rtol 1e-5; dt_pre within rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import forces as jF
from dualsphysics_multilayer_tpu import typesdef as jtd
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

torch.set_num_threads(2)

GEOM = dict(dp=0.04, tank=(0.8, 0.4, 0.3), column=(0.2, 0.4, 0.2),
            obstacle=False)
NSTEPS = 3


@pytest.fixture(scope="module")
def jax_ref():
    case = jcases.dambreak3d(**GEOM)
    opts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    return case, opts, jax.jit(jW.make_step(case.csp, opts, case.dom))


def initial_arrays(case, flow):
    st = case.state
    arrays = {k: np.asarray(getattr(st, k))
              for k in ("pos", "vel", "rho", "code", "idp")}
    if flow:
        # a seeded flow fast enough to trip the skin contract within the run
        rng = np.random.default_rng(7)
        fluid = jtd.code_type(arrays["code"]) == jtd.TYPE_FLUID
        vel = np.array([2.5, 0.0, 0.0]) + rng.normal(0.0, 0.3, arrays["pos"].shape)
        arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    return arrays


@pytest.mark.parametrize("flow", [False, True])
def test_symplectic_steps_match_jax(jax_ref, flow):
    case, jopts, jstep = jax_ref
    arrays = initial_arrays(case, flow)
    jcarry = jW.make_carry(dataclasses.replace(case.state,
                                               vel=jnp.asarray(arrays["vel"])),
                           case.csp, jopts, dom=case.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(case.csp))
    dom = convert.domain(dataclasses.asdict(case.dom))
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_step(csp, opts, dom)
    launches = dict(CF.launches)
    for _ in range(NSTEPS):
        carry = step(carry)
    assert CF.launches == launches      # CPU tensors never reach the kernel
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert carry.nrebuild >= (2 if flow else 1)
    assert carry.overflow == 0 == int(jcarry.overflow)

    st = carry.st
    idp = st.idp.numpy()
    assert sorted(idp.tolist()) == list(range(st.n))
    pos = np.empty((st.n, 3), np.float32)
    pos[idp] = st.pos.numpy()
    rho = np.empty(st.n, np.float32)
    rho[idp] = st.rho.numpy()
    code = np.empty(st.n, np.int32)
    code[idp] = st.code.numpy()
    np.testing.assert_allclose(pos, np.asarray(jcarry.st.pos), rtol=0,
                               atol=1e-4 * csp.dp)
    np.testing.assert_allclose(rho, np.asarray(jcarry.st.rho), rtol=1e-5)
    np.testing.assert_array_equal(code, np.asarray(jcarry.st.code).astype(np.int32))
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
    np.testing.assert_allclose(carry.t_host, float(jcarry.t), rtol=1e-4)
    assert int(carry.dtmodif) == int(jcarry.dtmodif)


def small_case():
    return cases.dambreak3d(**GEOM, device="cpu")


def test_simulation_run_and_advance():
    case = small_case()
    opts = P.SolverOpts()
    saves = []
    sim = P.Simulation(case.csp, opts, case.dom, case.state)
    # the first step runs at DtIni (h/cs0 ~ 2.5 ms here), later ones at ~0.5 ms
    sim.run(tmax=0.006, tout=0.003,
            on_save=lambda s: saves.append((s.part, s.carry.nstep)))
    assert [p for p, _ in saves] == [0, 1, 2]
    assert sim.time == pytest.approx(0.006)
    # the interval clock restarts at each save: only the overshoot is left
    assert 0.0 <= sim.carry.t_host < case.csp.dtini
    assert abs(float(sim.carry.tabs) - (sim.time + sim.carry.t_host)) < 1e-6
    nstep = sim.carry.nstep
    assert nstep == saves[-1][1] >= 4
    # advance honours nstep_max before t_target
    carry = sim.advance(sim.carry, 1.0, nstep + 2)
    assert carry.nstep == nstep + 2
    fluid = td.is_fluid(carry.st.code)
    rho = carry.st.rho[fluid]
    assert float(rho.min()) > 900 and float(rho.max()) < 1100


def test_diagnostics_abort_on_boundary_out(tmp_path):
    case = small_case()
    sim = P.Simulation(case.csp, P.SolverOpts(), case.dom, case.state)
    sim.errdir = str(tmp_path)
    sim.check_diagnostics()
    st = sim.carry.st
    k = int(torch.nonzero(td.is_bound(st.code))[0])
    code = st.code.clone()
    code[k] = td.code_set_special(int(code[k]), td.SPECIAL_OUT_POS)
    sim.carry = dataclasses.replace(sim.carry,
                                    st=dataclasses.replace(st, code=code))
    with pytest.raises(RuntimeError, match="boundary particle"):
        sim.check_diagnostics()
    assert (tmp_path / "Error_BoundaryOut.vtk").exists()


def test_unsupported_step_configs_raise():
    case = small_case()
    # a Verlet run reads the M1 state, which this case was built without
    with pytest.raises(ValueError, match="need_verlet"):
        P.make_carry(case.state, case.csp,
                     P.SolverOpts(tstep=td.TpStep.VERLET), case.dom)
    with pytest.raises(NotImplementedError, match="Features.periodic"):
        P.make_step(case.csp, P.SolverOpts(), case.dom,
                    feats=P.Features(motions=(object(),), periodic=object()))
    # mDBC walls run under the neighbour-list mode, as in JAX
    listed = P.SolverOpts(tboundary=td.TpBoundary.MDBC, use_nbrlist=True)
    carry = P.make_step(case.csp, listed, case.dom)(
        P.make_carry(case.state, case.csp, listed, case.dom))
    assert carry.nstep == 1 and carry.overflow == 0
    assert carry.dom.within == case.dom
    # a domain without a cell skin runs (test_torch_skinless.py); cells
    # narrower than the kernel size do not
    narrow = dataclasses.replace(case.dom, scell=0.9 * case.csp.kernelsize)
    with pytest.raises(ValueError, match="narrower than the kernel size"):
        P.make_step(case.csp, P.SolverOpts(), narrow)
