"""The run loop's step options and diagnostics against the JAX package.

* 5 symplectic and 5 Verlet steps of ``dambreak2d(dp=0.05)`` (a seeded
  flow) with the initial DDT ramp (its ``tmaxvalue`` and ``tramp`` inside
  the 5 steps, so both branches of the ramp run) and a 3-row viscosity
  table, against jitted JAX ``make_step(use_pallas=False)``: positions
  within 1e-4*dp by particle id, density rtol 1e-5 (the step tests'
  contract); the SaveDt rows against JAX's at rtol 2e-3, the force
  tolerance (dt, AceMax and ViscDtMax follow the forces).
* 30 Verlet steps from rest under a DDT of 0.3 swing the density out of
  +-10% in JAX and in the port alike (density rtol 1e-3, positions
  1e-4*dp by id), and stay within 1% without it.
* The g++ twin of kernels 1-3 against the plain version under the
  overridden ``ddtkh``/``visco``, rtol 2e-3 (the force rule), and both
  differ from the forces at the constants' values.
* The floating-motion ring's rows against the body state after each of 3
  floating-box steps (the bodies are held against JAX in
  test_torch_floating.py).
* Restart continuity as tests/test_io.py:76 (0.25*dp, by id); a flume
  restarted mid-stroke and mid-ramp goes on with the step values and the
  piston of its PART's time; a Verlet dam break restarted mid-flow takes
  its M1 state from the PART, and a falling, turning floating box its body
  state from PartFloat.fbi4 and its particles (each against a mutant that
  keeps the template's, as the JAX package does, and fails).
* ``partsoutmax`` and the boundary-out abort as tests/test_simulation.py:
  129-175, the Error_BoundaryOut.vtk dump compared with JAX's as a set of
  (idp, pos) rows (the port's slots are permuted).
* The NN step refuses ``savedt``, ``ftmotion`` and ``ddtramp``.
"""

import dataclasses
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.features.featureset import Features as jFeatures
from dualsphysics_multilayer_tpu.features.viscoinput import ViscoInput as jViscoInput
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import forces as jF
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.features import motion as MOT
from dualsphysics_multilayer_tpu_torch.features.viscoinput import ViscoInput
from dualsphysics_multilayer_tpu_torch.io.output import OutputManager, restart_state
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
from dualsphysics_multilayer_tpu_torch.models import wcsph as W
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

torch.set_num_threads(2)

DP = 0.05
FDP = 0.025   # the floating restart's
NSTEPS = 5
# (tramp, tmaxvalue, maxvalue) of the DDT ramp and the viscosity table's
# (times, values) per step kind.  The symplectic steps start at 0, 7.98e-4
# (the first runs at DtIni), 9.58e-4, 1.12e-3 and 1.28e-3 s; the Verlet
# steps (dt from their own interaction) at 0, 1.6e-4, 3.2e-4, 4.8e-4 and
# 6.4e-4 s: two steps at maxvalue, two on the blend, one past the ramp
RAMP = {"SYMPLECTIC": (1.2e-3, 9e-4, 0.4), "VERLET": (6e-4, 2e-4, 0.4)}
VISCO = {"SYMPLECTIC": ((0.0, 6e-4, 1.2e-3), (0.02, 0.12, 0.05)),
         "VERLET": ((0.0, 3e-4, 6e-4), (0.02, 0.12, 0.05))}


def flowing(case, seed=3):
    st = case.state
    arrays = {k: np.asarray(getattr(st, k))
              for k in ("pos", "vel", "rho", "code", "idp")}
    rng = np.random.default_rng(seed)
    fluid = jtd.code_type(arrays["code"]) == jtd.TYPE_FLUID
    vel = rng.normal(0.0, 0.4, arrays["pos"].shape)
    vel[:, 1] = 0.0
    arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    for k in ("velm1", "rhom1"):
        if getattr(st, k) is not None:
            arrays[k] = np.asarray(getattr(st, k))
    return arrays


def by_id(st, name):
    idp = st.idp.numpy()
    x = getattr(st, name).numpy()
    out = np.empty_like(x)
    out[idp] = x
    return out


@pytest.mark.parametrize("tstep", ["SYMPLECTIC", "VERLET"])
def test_steps_with_ramp_and_viscosity_table_match_jax(tstep):
    jcase = jcases.dambreak2d(dp=DP, need_verlet=True)
    arrays = flowing(jcase)
    jopts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False,
                          tstep=jtd.TpStep[tstep], savedt=8,
                          ddtramp=RAMP[tstep])
    jfeats = jFeatures(viscotime=jViscoInput(*VISCO[tstep]))
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jcase.dom, jfeats))
    jst = dataclasses.replace(jcase.state, vel=jnp.asarray(arrays["vel"]))
    jcarry = jW.make_carry(jst, jcase.csp, jopts, jfeats, dom=jcase.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS,
                        tstep=td.TpStep[tstep], savedt=8,
                        ddtramp=RAMP[tstep])
    feats = P.Features(viscotime=ViscoInput(*VISCO[tstep]))
    step = P.make_step(csp, opts, dom, feats)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts,
                         dom, feats)
    values = []
    for _ in range(NSTEPS):
        values.append(W.step_values(csp, opts, feats, carry.tabs_host))
        carry = step(carry)
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    # the ramp crossed both of its ends and the table moved
    ddtkh = [v[0] for v in values]
    ks = csp.kernelsize
    assert ddtkh[0] == ddtkh[1] == pytest.approx(ks * RAMP[tstep][2],
                                                    rel=1e-6)
    assert ks * csp.ddtvalue < ddtkh[2] < ddtkh[1]
    assert ddtkh[-1] == pytest.approx(ks * csp.ddtvalue, rel=1e-6)
    assert len({v[1] for v in values}) == NSTEPS
    np.testing.assert_allclose(by_id(carry.st, "pos"),
                               np.asarray(jcarry.st.pos), rtol=0,
                               atol=1e-4 * DP)
    np.testing.assert_allclose(by_id(carry.st, "rho"),
                               np.asarray(jcarry.st.rho), rtol=1e-5)
    np.testing.assert_allclose(carry.dthist.numpy()[:NSTEPS],
                               np.asarray(jcarry.dthist)[:NSTEPS], rtol=2e-3)
    assert not carry.dthist[NSTEPS:].any()


def test_verlet_under_a_strong_ddt_leaves_rest_as_jax_does():
    """30 Verlet steps of ``dambreak2d(dp=0.05)`` from rest (1,001
    particles, no Euler step) with the DDT held at the ramp's 0.3: the
    leapfrog carries the diffusion term from step n-1 to n+1 and the fluid
    density swings out of +-10% in both packages (882.8-1129.5 in JAX
    here), the port's by id within rtol 1e-3 of JAX's (0.58 apart at most
    here: the swing amplifies float32 rounding about 1.4x a step) and its
    positions within 1e-4*dp.  The same run without the ramp stays within
    1% of rest.  So the swing is the scheme's, not the port's."""
    jcase = jcases.dambreak2d(dp=DP, need_verlet=True)
    ramp = (1.0, 1.0, 0.3)
    jopts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False,
                          tstep=jtd.TpStep.VERLET, ddtramp=ramp)
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jcase.dom))
    jcarry = jW.make_carry(jcase.state, jcase.csp, jopts, dom=jcase.dom)
    arrays = {k: np.asarray(getattr(jcase.state, k)) for k in
              ("pos", "vel", "rho", "code", "idp", "velm1", "rhom1")}
    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    fluid = jtd.code_type(arrays["code"]) == jtd.TYPE_FLUID
    carries = {}
    for r in (ramp, None):
        opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS,
                            tstep=td.TpStep.VERLET, ddtramp=r)
        step = P.make_step(csp, opts, dom)
        carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp,
                             opts, dom)
        for _ in range(30):
            carry = step(carry)
        carries[r] = carry
    for _ in range(30):
        jcarry = jstep(jcarry)
    assert opts.verlet_steps > 30
    jrho = np.asarray(jcarry.st.rho)[fluid]
    rho = by_id(carries[ramp].st, "rho")[fluid]
    assert jrho.min() < 900 and jrho.max() > 1100, (jrho.min(), jrho.max())
    np.testing.assert_allclose(rho, jrho, rtol=1e-3)
    np.testing.assert_allclose(by_id(carries[ramp].st, "pos"),
                               np.asarray(jcarry.st.pos), rtol=0,
                               atol=1e-4 * DP)
    calm = by_id(carries[None].st, "rho")[fluid]
    assert np.abs(calm / 1000.0 - 1).max() < 0.01, (calm.min(), calm.max())


@pytest.fixture(scope="module")
def sorted_dambreak():
    case = cases.dambreak2d(dp=DP, device="cpu")
    arrays = flowing(jcases.dambreak2d(dp=DP))
    # a 1% density jitter, so the diffusion term is not the hydrostatic zero
    rng = np.random.default_rng(4)
    arrays["rho"] = (arrays["rho"] * (1 + rng.uniform(-0.01, 0.01, len(
        arrays["rho"])))).astype(np.float32)
    st = convert.simstate(arrays, device="cpu")
    cells, code = cd.divide_cells(case.dom, st.pos, st.code)
    o = cells.order
    return case, cells, (st.pos[o], st.vel[o], st.rho[o], code[o])


@pytest.mark.parametrize("variant", ["WENDLAND", "CUBIC", "LAMINAR_SPS"])
def test_twin_matches_plain_under_step_values(sorted_dambreak, variant):
    case, cells, args = sorted_dambreak
    csp, dom = case.csp, case.dom
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
    spstau = None
    if variant == "CUBIC":
        csp = csp.replace(tkernel=td.TpKernel.CUBIC)
    if variant == "LAMINAR_SPS":
        opts = dataclasses.replace(opts, tvisco=td.TpVisco.LAMINAR_SPS)
        csp = csp.replace(visco=1e-2)
        spstau = torch.zeros((args[0].shape[0], 6))
    ddtkh, visco = 0.35 * csp.kernelsize, 7.5 * csp.visco
    run = (csp, opts, dom, cells, *args, spstau, None)
    got = CF.interaction_forces_host_twin(*run, ddtkh=ddtkh, visco=visco)
    want = F.interaction_forces_plain(*run, ddtkh=ddtkh, visco=visco)
    base = F.interaction_forces_plain(*run)
    for k in ("ace", "ar"):
        g, w = getattr(got, k), getattr(want, k)
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 2e-3 * scale, k
        # the override moved the forces well past the comparison's rule
        assert float((w - getattr(base, k)).abs().max()) > 2e-2 * scale, k
    assert float(got.viscdtmax) == pytest.approx(float(want.viscdtmax),
                                                 rel=1e-3)


def test_ftmotion_rows_follow_the_bodies():
    case = cases.floatingbox2d(dp=0.05, tank=(1.0, 0.6), water=0.3,
                               box=(0.2, 0.2), box_pos=(0.4, 0.25),
                               device="cpu")
    feats = P.Features(floating=case.meta["ftcfg"])
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS, with_floating=True,
                        ftmotion=2, savedt=2)
    step = P.make_step(case.csp, opts, case.dom, feats)
    carry = P.make_carry(case.state, case.csp, opts, case.dom, feats)
    assert carry.fthist.shape == (2, 10)
    for k in range(3):
        carry = step(carry)
        ft = carry.st.ft
        row = carry.fthist[k % 2]
        assert float(row[0]) == float(carry.tabs)
        want = torch.cat([ft.center.reshape(-1), ft.fvel.reshape(-1),
                          ft.fomega.reshape(-1)]).float()
        assert torch.equal(row[1:], want)
    # a ring of 2 holds the last two steps; step 2 overwrote row 0
    assert float(carry.fthist[1, 0]) < float(carry.fthist[0, 0])
    assert float(carry.dthist[0, 0]) > float(carry.dthist[1, 0])


def test_restart_continuity(tmp_path):
    """Run A->B, checkpoint at A, restart from the PART, run to B again:
    the trajectories agree within 0.25*dp by id (the restart re-derives
    dt and starts the Kahan residual at zero)."""
    case = cases.dambreak2d(dp=DP, tank=(1.6, 1.0), column=(0.4, 0.6),
                            device="cpu")
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
    sim = P.Simulation(case.csp, opts, case.dom, case.state, log=lambda m: None)
    out = OutputManager(str(tmp_path), case)
    sim.run(tmax=0.02, tout=0.01, on_save=out)
    sim.run(tmax=0.03, tout=0.01)
    st2, tstep, nstep = restart_state(str(tmp_path / "Part_0002.bi4"),
                                      case.state)
    assert abs(tstep - 0.02) < 1e-9 and nstep > 0
    assert not st2.pose.any()
    sim2 = P.Simulation(case.csp, opts, case.dom, st2, t0=tstep)
    sim2.run(tmax=0.03, tout=0.01)
    ref, pos2 = by_id(sim.state, "pos"), by_id(sim2.state, "pos")
    live = by_id(sim.state, "code")
    live = td.is_active(torch.tensor(live)).numpy()
    err = np.abs(ref[live] - pos2[live]).max()
    assert err < 0.25 * DP, err


def test_restart_continues_the_ramp_and_the_piston(tmp_path):
    """A flume restarted mid-stroke and mid-ramp goes on with its clock:
    its first step's DDT coefficient and table viscosity are those the
    uninterrupted run reached at that PART, its piston moves on by
    A (sin(w tabs) - sin(w t0)) from the PART's position (1e-6 m), as the
    uninterrupted run's lies at A sin(w tabs), and the fluid ends within
    0.25*dp of the uninterrupted run's by id.  The PART's TimeStep is the
    save's nominal time, as in the JAX package, so the restart drops the
    sub-dt overshoot of the step the save came after."""
    amp, freq = 0.05, 6.0
    case = cases.waveflume2d(dp=DP, flume=(2.0, 0.7), water=0.4, device="cpu")
    feats = P.Features(motions=(MOT.piston_sinusoidal(10, freq=freq,
                                                      amplitude=amp),),
                       viscotime=ViscoInput((0.0, 0.02), (0.02, 0.12)))
    opts = P.SolverOpts(ddtramp=(0.025, 0.005, 0.4))
    quiet = dict(log=lambda m: None)
    sim = P.Simulation(case.csp, opts, case.dom, case.state, feats, **quiet)
    out = OutputManager(str(tmp_path), case)
    at_part = {}

    def on_save(s):
        out(s)
        at_part[s.part] = W.step_values(s.csp, opts, feats, s.carry.tabs_host)

    sim.run(tmax=0.02, tout=0.01, on_save=on_save)
    st2, tstep, _ = restart_state(str(tmp_path / "Part_0001.bi4"), case.state)
    sim2 = P.Simulation(case.csp, opts, case.dom, st2, feats, t0=tstep,
                        **quiet)
    assert sim2.carry.tabs_host == np.float32(tstep)
    start = W.step_values(case.csp, opts, feats, sim2.carry.tabs_host)
    fresh = W.step_values(case.csp, opts, feats, 0.0)
    for k in range(2):   # ddtkh, visco: as the run reached them, not anew
        assert abs(start[k] - at_part[1][k]) < 0.1 * abs(start[k] - fresh[k])
    sim2.run(tmax=0.02, tout=0.01)

    def stroke(t):
        return amp * np.sin(2.0 * np.pi * freq * np.float64(t))

    piston = td.is_moving(case.state.code).numpy()
    for s, x0, t0 in ((sim, case.state.pos.numpy(), 0.0),
                      (sim2, by_id(st2, "pos"), np.float32(tstep))):
        x = by_id(s.state, "pos")[piston, 0]
        want = stroke(s.carry.tabs_host) - stroke(t0)
        assert np.abs(x - x0[piston, 0] - want).max() < 1e-6
    live = td.is_active(torch.tensor(by_id(sim.state, "code"))).numpy()
    err = np.abs(by_id(sim.state, "pos") - by_id(sim2.state, "pos"))[live]
    assert err.max() < 0.25 * DP, err.max()


@pytest.fixture(scope="module")
def verlet_run(tmp_path_factory):
    """A 2D Verlet dam break (a 0.6 x 1 m column in a 2 x 1.5 m tank, 341
    particles) to 0.08 s with a PART every 0.02 s."""
    d = tmp_path_factory.mktemp("verlet")
    case = cases.dambreak2d(dp=DP, tank=(2.0, 1.5), column=(0.6, 1.0),
                            need_verlet=True, device="cpu")
    opts = P.SolverOpts(tstep=td.TpStep.VERLET)
    sim = P.Simulation(case.csp, opts, case.dom, case.state,
                       log=lambda m: None)
    sim.run(tmax=0.08, tout=0.02, on_save=OutputManager(str(d), case))
    return case, opts, d, sim.state


@pytest.mark.parametrize("m1", ["part", "template"])
def test_verlet_restart_takes_its_m1_state_from_the_part(verlet_run, m1):
    """Restarted from Part_0002 (t = 0.04 s, mid-flow), the Verlet run
    ends within 0.25*dp of the uninterrupted one by id (0.04 of the bound
    here); its M1 state is the PART's velocity and density.  The mutant
    keeps the template's (zero velocity: the first leapfrog step loses the
    flow) and ends more than 1.5x the bound away (2.1x here)."""
    case, opts, d, ref = verlet_run
    st2, tstep, _ = restart_state(str(d / "Part_0002.bi4"), case.state)
    assert torch.equal(st2.velm1, st2.vel) and torch.equal(st2.rhom1, st2.rho)
    if m1 == "template":
        st2 = dataclasses.replace(st2, velm1=case.state.velm1,
                                  rhom1=case.state.rhom1)
    sim2 = P.Simulation(case.csp, opts, case.dom, st2, t0=tstep,
                        log=lambda m: None)
    sim2.run(tmax=0.08, tout=0.02)
    live = td.is_active(torch.tensor(by_id(ref, "code"))).numpy()
    err = np.abs(by_id(ref, "pos") - by_id(sim2.state, "pos"))[live].max()
    if m1 == "part":
        assert err < 0.25 * DP, err
    else:
        assert err > 1.5 * 0.25 * DP, err


@pytest.fixture(scope="module")
def floating_run(tmp_path_factory):
    """A box falling into water and turning at 3 rad/s (dp 0.025, 464
    particles), to 0.04 s with a PART every 0.01 s; the body state of each
    PART in PartFloat.fbi4."""
    d = tmp_path_factory.mktemp("floating")
    case = cases.floatingbox2d(dp=FDP, tank=(0.8, 0.5), water=0.25,
                               box=(0.2, 0.2), box_pos=(0.3, 0.3),
                               device="cpu")
    st = case.state
    omega = torch.tensor([[0.0, 3.0, 0.0]])
    body = td.is_floating(st.code)
    vel = torch.where(body[:, None], torch.linalg.cross(
        omega.expand_as(st.pos), st.pos - st.ft.center, dim=-1), st.vel)
    case = dataclasses.replace(case, state=dataclasses.replace(
        st, vel=vel, ft=dataclasses.replace(st.ft, fomega=omega)))
    feats = P.Features(floating=case.meta["ftcfg"])
    opts = P.SolverOpts(with_floating=True)
    sim = P.Simulation(case.csp, opts, case.dom, case.state, feats,
                       log=lambda m: None)
    angles = {}

    def on_save(s):
        out(s)
        angles[s.part] = s.state.ft.angles.numpy().copy()

    out = OutputManager(str(d), case, feats=feats)
    sim.run(tmax=0.04, tout=0.01, on_save=on_save)
    return case, feats, opts, d, sim.state, angles


@pytest.mark.parametrize("ft", ["partfloat", "template"])
def test_floating_restart_takes_the_bodies_from_partfloat(floating_run, ft):
    """Restarted from Part_0002 (t = 0.02 s, the box falling and turned by
    ~0.06 rad), the body starts at PartFloat.fbi4's row of
    that PART with the angles of the uninterrupted run (recovered from its
    particles), and at 0.04 s its row of Part_0004 and its particles match
    the uninterrupted run's: centre within 1e-2*dp, velocity within
    1e-2 m/s and angular velocity within 0.05 rad/s (the restart re-derives
    dt and drops the sub-dt overshoot of its PART's time: 1.7e-3*dp,
    1.3e-4 m/s and 0.010 rad/s here), particles within 0.25*dp.  The
    mutant keeps the template's t = 0 body and is off by more than
    0.05 m/s and 0.2 rad/s (0.11 and 0.50 here)."""
    from dualsphysics_multilayer_tpu_torch.io import floatdata
    case, feats, opts, d, ref, angles = floating_run
    _, rows = floatdata.read_floatbi4(str(d / "PartFloat.fbi4"))
    row = {r["cpart"]: r for r in rows}
    st2, tstep, _ = restart_state(str(d / "Part_0002.bi4"), case.state)
    for k in ("center", "fvel", "fomega"):
        np.testing.assert_array_equal(getattr(st2.ft, k).numpy(),
                                      np.float32(row[2][k]))
    # the particles' orientation, which the accumulated sum of fomega*dt
    # follows within 9.2e-4 of the angle here
    np.testing.assert_allclose(st2.ft.angles.numpy(), angles[2], rtol=2e-3)
    assert abs(angles[2][0, 1]) > 0.03
    if ft == "template":
        st2 = dataclasses.replace(st2, ft=case.state.ft)
    sim2 = P.Simulation(case.csp, opts, case.dom, st2, feats, t0=tstep,
                        log=lambda m: None)
    sim2.run(tmax=0.04, tout=0.02)
    got = sim2.state.ft
    err = {"center": np.abs(got.center.numpy() - row[4]["center"]).max(),
           "fvel": np.abs(got.fvel.numpy() - row[4]["fvel"]).max(),
           "fomega": np.abs(got.fomega.numpy() - row[4]["fomega"]).max()}
    live = td.is_active(torch.tensor(by_id(ref, "code"))).numpy()
    perr = np.abs(by_id(ref, "pos") - by_id(sim2.state, "pos"))[live].max()
    if ft == "partfloat":
        assert err["center"] < 1e-2 * FDP and err["fvel"] < 1e-2 \
            and err["fomega"] < 0.05, err
        assert perr < 0.25 * FDP, perr
    else:
        assert err["fvel"] > 0.05 and err["fomega"] > 0.2, err


@pytest.mark.parametrize("planar", [True, False])
def test_body_angles_recover_a_rotation(planar):
    """``output._body_angles`` gives the angles whose rotation matrix
    (``floating._euler_rot``) turned the offsets: about y alone in 2D
    (beyond pi/2 too), any orientation in 3D."""
    from dualsphysics_multilayer_tpu_torch.features.floating import _euler_rot
    from dualsphysics_multilayer_tpu_torch.io.output import _body_angles
    rng = np.random.default_rng(5)
    a = rng.normal(size=(40, 3))
    ang = np.array([0.0, 2.5, 0.0]) if planar else np.array([0.3, -1.1, 2.0])
    if planar:
        a[:, 1] = 0.0
    q = _euler_rot(torch.tensor(ang)).numpy()
    got = _body_angles(a, a @ q.T, planar)
    np.testing.assert_allclose(_euler_rot(torch.tensor(got)).numpy(), q,
                               atol=1e-12)
    np.testing.assert_allclose(got, ang, atol=1e-12)


def read_vtk_points(path):
    """(idp, pos) rows of a binary legacy VTK particle file."""
    raw = open(path, "rb").read()
    i = raw.index(b"POINTS ")
    j = raw.index(b"\n", i)
    n = int(raw[i:j].split()[1])
    pos = np.frombuffer(raw[j + 1:j + 1 + 12 * n], ">f4").reshape(n, 3)
    k = raw.index(b"SCALARS Idp int 1\nLOOKUP_TABLE default\n")
    k += len(b"SCALARS Idp int 1\nLOOKUP_TABLE default\n")
    idp = np.frombuffer(raw[k:k + 4 * n], ">i4")
    return sorted(zip(idp.tolist(), map(tuple, pos.tolist())))


def mark(code, idx, special):
    code = code.copy()
    for i in idx:
        code[i] = jtd.code_make(int(jtd.code_type(code[i])),
                                int(jtd.code_value(code[i])), special)
    return code


def test_boundary_out_dump_matches_jax(tmp_path):
    jcase = jcases.dambreak2d(dp=0.06)
    code = np.asarray(jcase.state.code)
    bidx = np.flatnonzero(jtd.code_type(code) == jtd.TYPE_FIXED)[[0, 5, 9]]
    code = mark(code, bidx, jtd.SPECIAL_OUT_POS)
    jsim = jW.Simulation(jcase.csp, jF.SolverOpts(), jcase.dom,
                         dataclasses.replace(jcase.state,
                                             code=jnp.asarray(code)))
    jsim.errdir = str(tmp_path / "jax")
    with pytest.raises(RuntimeError, match="boundary particle"):
        jsim.check_diagnostics()

    case = cases.dambreak2d(dp=0.06, device="cpu")
    sim = P.Simulation(case.csp, P.SolverOpts(), case.dom, case.state)
    sim.errdir = str(tmp_path / "port")
    sim.check_diagnostics()          # clean state passes
    st = sim.carry.st                # cell-sorted slots
    out = torch.isin(st.idp, torch.tensor(bidx))
    st = dataclasses.replace(st, code=torch.where(
        out, td.code_set_special(st.code, td.SPECIAL_OUT_POS), st.code))
    sim.carry = dataclasses.replace(sim.carry, st=st)
    with pytest.raises(RuntimeError, match="3 boundary particle"):
        sim.check_diagnostics()
    rows = read_vtk_points(tmp_path / "port" / "Error_BoundaryOut.vtk")
    assert rows == read_vtk_points(tmp_path / "jax" / "Error_BoundaryOut.vtk")
    assert [r[0] for r in rows] == sorted(bidx.tolist())


def test_partsoutmax_aborts():
    case = cases.dambreak2d(dp=0.06, device="cpu")
    sim = P.Simulation(case.csp, P.SolverOpts(), case.dom, case.state)
    sim.partsoutmax = 0.01
    sim.check_diagnostics()
    st = sim.carry.st
    fidx = torch.nonzero(td.is_fluid(st.code)).flatten()
    k = max(int(0.02 * len(fidx)), 2)
    code = st.code.clone()
    code[fidx[:k]] = td.code_set_special(code[fidx[:k]], td.SPECIAL_OUT_RHOP)
    sim.carry = dataclasses.replace(sim.carry,
                                    st=dataclasses.replace(st, code=code))
    with pytest.raises(RuntimeError, match="PartsOutMax"):
        sim.check_diagnostics()
    # under the cap it passes
    sim.partsoutmax = 0.05
    sim.check_diagnostics()


@pytest.mark.parametrize("option", [dict(savedt=16), dict(ftmotion=16),
                                    dict(ddtramp=(0.1, 0.05, 0.3))])
def test_nn_step_refuses_run_loop_options(option):
    case, phases = NM.wet_dambreak_nn(dp=0.05, device="cpu")
    opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS, **option)
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        NM.make_nn_step(case.csp, opts, case.dom, phases)
