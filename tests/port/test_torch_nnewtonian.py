"""The multiphase non-Newtonian slice end to end: the wet dam-break case
builder and ``convert.phasecfg`` against the JAX package, and symplectic
steps of ``make_nn_step`` against the JAX package's
``make_nn_step(use_pallas=False)`` (its bucket path) from the same state.

Contract (README, sharded-vs-single): positions agree within 1e-4*dp,
compared by particle id since the port re-sorts its slots; density within
rtol 1e-5; dt_pre within rtol 1e-4.  The JAX bucket path re-divides at
every interaction while the port re-divides at rebuilds only, so the runs
stay inside the tank, where both find the same pairs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import nnewtonian as jNM
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops.forces import SolverOpts as JOpts
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF

torch.set_num_threads(2)

DP = 0.05
NSTEPS = 3


@pytest.fixture(scope="module")
def jcase():
    return jNM.wet_dambreak_nn(dp=DP)


def test_wet_dambreak_matches_jax(jcase):
    want, jph = jcase
    got, ph = NM.wet_dambreak_nn(dp=DP, device="cpu")
    assert got.np_total == want.np_total == 228 and got.npb == want.npb
    assert convert.ctesph(dataclasses.asdict(want.csp)) == got.csp
    assert convert.domain(dataclasses.asdict(want.dom)) == got.dom
    assert got.dom.nc[1] == 1
    st = want.state
    conv = convert.simstate({k: np.asarray(getattr(st, k))
                             for k in ("pos", "vel", "rho", "code", "idp")},
                            device="cpu")
    for k in ("pos", "vel", "rho", "code", "idp"):
        assert torch.equal(getattr(got.state, k), getattr(conv, k)), k
    assert not got.state.pos[:, 1].any()
    # water hydrostatic, mud at its rest density, walls at rho0
    mud = td.is_fluid(got.state.code) & (td.code_value(got.state.code) == 1)
    assert bool((got.state.rho[mud] == 1500.0).all()) and int(mud.sum()) > 0
    assert float(got.state.rho[~td.is_fluid(got.state.code)].min()) == 1000.0
    assert convert.phasecfg(jph) == ph


def test_phasecfg_round_trip(jcase):
    _, jph = jcase
    ph = convert.phasecfg(jph)
    assert ph.count == jph.count
    for p, jp in zip(ph.phases, jph.phases):
        for f in dataclasses.fields(jp):
            assert getattr(p, f.name) == getattr(jp, f.name), f.name
            assert type(getattr(p, f.name)) in (int, float, bool)
    assert ph.system_cs0() == jph.system_cs0()


def flowing_arrays(case):
    """The case's state with a seeded flow along x (2.5 m/s, jitter 0.3
    m/s, none along y), fast enough to trip the skin contract in the run."""
    st = case.state
    arrays = {k: np.asarray(getattr(st, k))
              for k in ("pos", "vel", "rho", "code", "idp")}
    rng = np.random.default_rng(7)
    fluid = jtd.code_type(arrays["code"]) == jtd.TYPE_FLUID
    vel = np.array([2.5, 0.0, 0.0]) + rng.normal(0.0, 0.3, arrays["pos"].shape)
    vel[:, 1] = 0.0
    arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    return arrays


@pytest.mark.parametrize("velgrad", ["SPH", "FDA"])
def test_nn_steps_match_jax(jcase, velgrad):
    case, jph = jcase
    jopts = JOpts(tvisco=jtd.TpVisco.LAMINAR_SPS,
                  tdensity=jtd.TpDensity.FOURTAKAS,
                  velgrad=jtd.TpVelGrad[velgrad], use_pallas=False)
    arrays = flowing_arrays(case)
    jstep = jax.jit(jNM.make_nn_step(case.csp, jopts, case.dom, jph))
    jcarry = jW.make_carry(dataclasses.replace(case.state,
                                               vel=jnp.asarray(arrays["vel"])),
                           case.csp, jopts)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(case.csp))
    dom = convert.domain(dataclasses.asdict(case.dom))
    opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS,
                        tdensity=td.TpDensity.FOURTAKAS,
                        velgrad=td.TpVelGrad[velgrad])
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_nn_step(csp, opts, dom, convert.phasecfg(jph))
    launches = dict(NF.launches)
    for _ in range(NSTEPS):
        carry = step(carry)
    assert NF.launches == launches      # CPU tensors never reach the kernels
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert carry.nrebuild >= 2
    assert int(jcarry.overflow) == 0

    st = carry.st
    idp = st.idp.numpy()
    pos = np.empty((st.n, 3), np.float32)
    pos[idp] = st.pos.numpy()
    rho = np.empty(st.n, np.float32)
    rho[idp] = st.rho.numpy()
    code = np.empty(st.n, np.int32)
    code[idp] = st.code.numpy()
    np.testing.assert_allclose(pos, np.asarray(jcarry.st.pos), rtol=0,
                               atol=1e-4 * DP)
    np.testing.assert_allclose(rho, np.asarray(jcarry.st.rho), rtol=1e-5)
    np.testing.assert_array_equal(code, np.asarray(jcarry.st.code).astype(np.int32))
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
    np.testing.assert_allclose(carry.t_host, float(jcarry.t), rtol=1e-4)
    assert int(carry.dtmodif) == int(jcarry.dtmodif)


def test_simulation_runs_the_nn_step():
    """``Simulation(step=make_nn_step(...))``: the run loop over the NN
    step; each phase stays near its own rest density."""
    case, ph = NM.wet_dambreak_nn(dp=DP, device="cpu")
    opts = P.SolverOpts(tvisco=td.TpVisco.CONST_EQ)
    # the single-phase step does not take the NN viscosity, the carry does
    with pytest.raises(NotImplementedError, match="CONST_EQ"):
        P.make_step(case.csp, opts, case.dom)
    sim = P.Simulation(case.csp, opts, case.dom, case.state,
                       step=P.make_nn_step(case.csp, opts, case.dom, ph))
    saves = []
    sim.run(tmax=0.004, tout=0.002, on_save=lambda s: saves.append(s.part))
    assert saves == [0, 1, 2] and sim.carry.nstep >= 4
    st = sim.carry.st
    fluid = td.is_fluid(st.code) & td.is_active(st.code)
    mk = td.code_value(st.code)
    for m, rho0 in ((0, 1000.0), (1, 1500.0)):
        rho = st.rho[fluid & (mk == m)]
        assert 0.9 * rho0 < float(rho.min()) and float(rho.max()) < 1.1 * rho0
    assert bool(torch.isfinite(st.pos).all())
