"""The wave-flume family against the JAX package: scripted motion, the
wave generators, damping, relaxation zones, multi-layer pistons, AWAS,
external accelerations, gauges, and steps of the 2D wave flume.

* ``motion_step`` of every segment kind (ramps, t_end, loops, circles,
  tables, spectra) on a time grid that crosses segment starts and ends, and
  ``apply_motion``: displacements within 2e-6 m plus rtol 1e-5, rotations
  and velocities within rtol 1e-5 with a floor of 1e-5 of the largest
  value plus 1e-7 (f32 sines of the same arguments, summed in another
  order);
* the accumulated piston displacement over a half stroke at bench.py's dp
  against the closed form A sin(w t) in float64: within 1e-3 dp; and that
  piston leaving the domain in its back stroke (a property of the JAX
  builder's geometry);
* each wave generator's ``MotionDef`` equal to the JAX package's (the
  same numpy code);
* damping, relaxation zones (all four), multi-layer pistons (1D and 2D),
  AWAS and external accelerations on one seeded cloud: velocities and
  accelerations rtol 1e-5 with a floor of 1e-5 of the largest value,
  positions within 1e-6 m plus rtol 1e-5; AWAS's velocities, elevation
  and correction rtol 1e-4 (a sum over the fluid in the gauge band, added
  in another order);
* the gauges on a still flume: velocity rtol 1e-4 with a floor of 1e-6
  m/s, the SWL level exact (its sample points' mass sums stay at least 3%
  of the limit away from it), MaxZ exact, the force rtol 1e-4;
* 3 symplectic steps of a small flume (dp 0.05, 1,185 particles) with a
  2nd-order piston, AWAS and a damping beach under mDBC walls with
  NO_SLIP, and 3 Verlet steps of it with a sinusoidal piston, a relaxation
  zone and an external acceleration: positions within 1e-4 dp by particle
  id, density rtol 1e-5, dt_pre rtol 1e-4, ``motionvel`` (written by the
  symplectic step, left alone by the Verlet step, as in JAX) within 1e-5
  m/s plus rtol 1e-5, the AWAS correction rtol 5e-3 (a difference of
  column heights, see the test);
* the layout kept between rebuilds holds every pair on a fast piston, the
  gauges' sub-ticks of ``Simulation.run``, and the refusals of the
  ``Features`` fields outside the port.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.features import accinput as jACC
from dualsphysics_multilayer_tpu.features import awas as jAWAS
from dualsphysics_multilayer_tpu.features import damping as jDMP
from dualsphysics_multilayer_tpu.features import gauges as jG
from dualsphysics_multilayer_tpu.features import inout as jIO
from dualsphysics_multilayer_tpu.features import mlpiston as jMLP
from dualsphysics_multilayer_tpu.features import motion as jMOT
from dualsphysics_multilayer_tpu.features import relaxzone as jRZ
from dualsphysics_multilayer_tpu.features import wavegen as jWG
from dualsphysics_multilayer_tpu.features.featureset import Features as jFeatures
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import forces as jF
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.features import accinput as ACC
from dualsphysics_multilayer_tpu_torch.features import awas as AWAS
from dualsphysics_multilayer_tpu_torch.features import damping as DMP
from dualsphysics_multilayer_tpu_torch.features import gauges as G
from dualsphysics_multilayer_tpu_torch.features import mlpiston as MLP
from dualsphysics_multilayer_tpu_torch.features import motion as MOT
from dualsphysics_multilayer_tpu_torch.features import relaxzone as RZ
from dualsphysics_multilayer_tpu_torch.features import wavegen as WG
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.models import wcsph as W
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd

from test_torch_variant_steps import by_id, pairs_per_target

torch.set_num_threads(2)

FLUME = dict(dp=0.05, flume=(2.0, 0.7), water=0.4)
NSTEPS = 3


def f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def close(got, want, rtol=1e-5, floor=1e-5, atol=0.0):
    """got (torch) against want (JAX or numpy): rtol with a floor of
    ``floor`` times the largest value, plus ``atol``."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * scale + atol)


# ---------------------------------------------------------------------------
# motion
# ---------------------------------------------------------------------------

def jax_motions():
    """A MotionDef of every segment kind, with ramps, an end time and a
    loop, in the JAX package's classes."""
    S, M = jMOT.Segment, jMOT.MotionDef
    axis = (0.1, 0.0, 0.2, 0.1, 1.0, 0.2)
    ref = (0.6, 0.1, 0.4)
    ts = (0.1, 0.3, 0.55, 0.9)
    return [
        M(mk=1, segments=(S(jMOT.WAIT, 0.0, 0.2),
                          S(jMOT.RECT, 0.2, 0.7, params=(0.3, 0.0, -0.1)))),
        M(mk=2, segments=(S(jMOT.RECT_ACE, 0.1, 0.8,
                            params=(0.1, 0.0, 0.2, 1.5, 0.0, -0.5)),),
          t_end=0.6),
        M(mk=3, segments=(S(jMOT.SIN_RECT, 0.0, 2.0,
                            params=(1.3, 0.4, 0.05, 0.0, 0.02, 0.5)),
                          S(jMOT.SIN_RECT, 0.0, 2.0,
                            params=(2.6, 0.8, 0.004, 0.0, 0.0)))),
        M(mk=4, segments=(S(jMOT.ROT, 0.05, 0.9, params=axis + (30.0,)),)),
        M(mk=5, segments=(S(jMOT.ROT_ACE, 0.0, 1.0, params=axis + (5.0, 40.0)),),
          loop_t=0.35, loop_start=0.1),
        M(mk=6, segments=(S(jMOT.SIN_ROT, 0.0, 1.5,
                            params=axis + (0.9, 0.3, 12.0, 0.4)),)),
        M(mk=7, segments=(S(jMOT.TABLE, ts[0], ts[-1], times=ts,
                            values=(0.0, 0.0, 0.0, 0.4, 0.0, 0.1,
                                    -0.2, 0.0, 0.3, 0.1, 0.0, 0.0)),)),
        M(mk=8, segments=(S(jMOT.SPECTRUM, 0.0, 3.0,
                            params=(1.0, 0.0, 0.0, 0.5),
                            times=(4.0, 6.5, 9.0),
                            values=(0.02, 0.1, 0.01, 1.2, 0.005, 2.0)),)),
        M(mk=9, segments=(S(jMOT.SPECTRUM_ROT, 0.0, 3.0,
                            params=axis + (0.3,), times=(5.0, 8.0),
                            values=(0.05, 0.3, 0.02, 1.0)),)),
        M(mk=10, segments=(S(jMOT.CIR, 0.1, 0.8, params=axis + (45.0, 0.0, 0.0)
                             + ref),)),
        M(mk=11, segments=(S(jMOT.CIR_ACE, 0.0, 0.8,
                             params=axis + (10.0, 60.0, 0.0) + ref),)),
        M(mk=12, segments=(S(jMOT.SIN_CIR, 0.0, 0.8,
                             params=axis + (1.1, 0.2, 20.0) + ref),)),
        M(mk=13, segments=(S(jMOT.ROT_FILE, ts[0], ts[-1], params=axis,
                             times=ts, values=(0.0, 0.2, 0.15, 0.5)),)),
        M(mk=14, segments=(S(jMOT.TABLE_POS, ts[0], ts[-1], times=ts,
                             values=(0.0, 0.0, 0.0, 0.02, 0.0, 0.01,
                                     0.05, 0.0, 0.0, 0.04, 0.0, -0.02)),),
          loop_t=0.5, loop_start=0.2),
    ]


TIMES = (0.0, 0.07, 0.12, 0.19, 0.28, 0.4, 0.5, 0.58, 0.66, 0.75, 0.87, 1.3)
DT = 0.031


def test_motion_step_matches_jax():
    for jm in jax_motions():
        m = convert.feature(jm)
        for t in TIMES:
            want = jMOT.motion_step(jm, jnp.float32(t), jnp.float32(DT))
            got = MOT.motion_step(m, f32(t), f32(DT))
            assert got[4] == want[4]                       # has_rot
            close(got[0], want[0], floor=0.0, atol=2e-6)   # disp
            for k in (1, 2, 3, 5, 6):     # vel, rot, center, axis, wvel
                close(got[k], want[k], atol=1e-7)


def motion_cloud(seed=0, n=120):
    """Moving particles of mks 1-14, fixed and fluid ones, seeded."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 0.3, (n, 3)).astype(np.float32)
    kinds = rng.integers(0, 16, n)
    code = np.array([jtd.code_make(jtd.TYPE_MOVING, int(k)) if k < 15
                     else jtd.code_make(jtd.TYPE_FLUID, 0) for k in kinds],
                    np.uint32)
    code[:4] = jtd.code_make(jtd.TYPE_FIXED, 3)
    code[4] = jtd.code_make(jtd.TYPE_MOVING, 3, jtd.SPECIAL_OUT_POS)
    return pos, vel, code


def test_apply_motion_matches_jax():
    pos, vel, code = motion_cloud()
    jms = jax_motions()
    ms = tuple(convert.feature(m) for m in jms)
    for t in (0.12, 0.58):
        want = jMOT.apply_motion(jms, jnp.float32(t), jnp.float32(DT),
                                 jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(code))
        got = MOT.apply_motion(ms, f32(t), f32(DT), f32(pos), f32(vel),
                               torch.tensor(code.astype(np.int32)))
        close(got[0], want[0], floor=0.0, atol=2e-6)
        close(got[1], want[1], atol=1e-7)
    unmoved = (jtd.code_type(code) != jtd.TYPE_MOVING) | (np.arange(len(code)) == 4)
    assert np.array_equal(got[0].numpy()[unmoved], pos[unmoved])


def test_piston_displacement_matches_closed_form():
    """bench.py's piston (0.8 Hz, 0.1 m) moved step by step over half a
    stroke at dt 1e-3 s in f32: its accumulated displacement stays within
    1e-3 dp (dp 6.325 mm, bench.py's flume) of A sin(w t) in float64."""
    dp = (6.0 * 0.4 / 60000) ** 0.5
    m = MOT.piston_sinusoidal(10, freq=0.8, amplitude=0.1)
    x0 = np.float32(-0.0253)
    pos = torch.tensor([[x0, 0.0, 0.1]], dtype=torch.float32)
    vel = torch.zeros_like(pos)
    code = torch.tensor([td.code_make(td.TYPE_MOVING, 10)], dtype=torch.int32)
    tabs = torch.zeros((), dtype=torch.float32)
    dt = torch.tensor(1e-3, dtype=torch.float32)
    worst = 0.0
    for _ in range(625):
        pos, vel = MOT.apply_motion((m,), tabs, dt, pos, vel, code)
        tabs = tabs + dt
        want = 0.1 * math.sin(2.0 * math.pi * 0.8 * float(tabs))
        worst = max(worst, abs(float(pos[0, 0]) - float(x0) - want))
    assert worst < 1e-3 * dp, worst
    assert abs(float(vel[0, 0]) - 0.1 * 2 * math.pi * 0.8
               * math.cos(2 * math.pi * 0.8 * float(tabs))) < 1e-5


def test_piston_leaves_the_domain_in_its_back_stroke(tmp_path):
    """bench.py's flume (the JAX builder's geometry, dp 6.325 mm): the
    piston's 0.1 m stroke exceeds the 2*kernelsize halo (35.8 mm) behind
    its back column, so in the back half-stroke (from T/2 = 0.625 s) that
    column leaves the map, near t = 0.698 s, and the run's diagnostics
    abort on boundary particles excluded.  The piston alone is moved, at
    dt 1e-3 s."""
    case = cases.waveflume2d(dp=(6.0 * 0.4 / 60000) ** 0.5, device="cpu")
    st, dom = case.state, case.dom
    piston = td.is_moving(st.code)
    pos, vel, code = st.pos[piston], st.vel[piston], st.code[piston]
    m = case.meta["motion"]
    tabs = torch.zeros((), dtype=torch.float32)
    dt = torch.tensor(1e-3, dtype=torch.float32)
    t_out = None
    while t_out is None and float(tabs) < 1.0:
        pos, vel = MOT.apply_motion((m,), tabs, dt, pos, vel, code)
        tabs = tabs + dt
        if float(pos[:, 0].min()) < dom.posmin[0]:
            t_out = float(tabs)
    assert t_out is not None and 0.69 < t_out < 0.71, t_out
    moved = st.pos.clone()
    moved[piston] = pos
    sim = P.Simulation(case.csp, P.SolverOpts(), dom, case.state)
    sim.errdir = str(tmp_path)
    sim.check_diagnostics()
    sim.carry = W._rebuild(dom, dataclasses.replace(
        sim.carry, st=dataclasses.replace(st, pos=moved)))
    with pytest.raises(RuntimeError, match="boundary particle"):
        sim.check_diagnostics()
    assert (tmp_path / "Error_BoundaryOut.vtk").exists()


# ---------------------------------------------------------------------------
# wave generators
# ---------------------------------------------------------------------------

def test_wavegen_builders_match_jax():
    axis = dict(axis_p0=(0.0, -1.0, -0.1), axis_p1=(0.0, 1.0, -0.1))
    builders = [
        ("piston_waves", dict(mk=10, height=0.08, period=1.2, depth=0.3,
                              order=1)),
        ("piston_waves", dict(mk=10, height=0.08, period=1.2, depth=0.3,
                              order=2, ramp=2.0, phase=0.3, gain=1.1)),
        ("flap_waves", dict(mk=11, height=0.06, period=1.5, depth=0.4,
                            draft=0.1, ramp=1.0, **axis)),
        ("flap_waves", dict(mk=11, height=0.06, period=1.5, depth=0.4,
                            order=1, **axis)),
        ("piston_spectrum", dict(mk=10, hs=0.05, tp=1.4, depth=0.4,
                                 nwaves=24, ramptime=2.0)),
        ("piston_spectrum", dict(mk=10, hs=0.05, tp=1.4, depth=0.4,
                                 spectrum="pierson-moskowitz",
                                 discretization="random", nwaves=16, seed=7)),
        ("piston_spectrum", dict(mk=10, hs=0.05, tp=1.4, depth=0.4,
                                 discretization="cosstretched", nwaves=16)),
        ("piston_spectrum", dict(mk=10, hs=0.05, tp=1.4, depth=0.4,
                                 discretization="regular", nwaves=16)),
        ("flap_spectrum", dict(mk=11, hs=0.05, tp=1.4, depth=0.4, draft=0.1,
                               nwaves=12, **axis)),
        ("piston_focused", dict(mk=10, hs=0.05, tp=1.4, depth=0.4, xf=3.0,
                                nwaves=32, fphase_deg=20.0)),
        ("piston_solitary", dict(mk=10, height=0.05, depth=0.3, nwaves=2,
                                 startcoefs=(0.8,), heights=(0.05, 0.04))),
        ("piston_solitary", dict(mk=10, height=0.05, depth=0.3, theory=1)),
        ("piston_solitary", dict(mk=10, height=0.05, depth=0.3, theory=3)),
    ]
    for name, kw in builders:
        want = getattr(jWG, name)(**kw)
        assert getattr(WG, name)(**kw) == convert.feature(want), (name, kw)
    assert WG.dispersion_k(1.3, 0.35) == jWG.dispersion_k(1.3, 0.35)
    for got, want in zip(WG.spectrum_components(hs=0.1, tp=2.0, seed=3),
                         jWG.spectrum_components(hs=0.1, tp=2.0, seed=3)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# damping, relaxation zones, multi-layer pistons, AWAS, external acceleration
# ---------------------------------------------------------------------------

def feature_cloud(seed=1, n=400):
    """A 2D-like cloud over x in [0, 2], z in [0, 0.6]: fluid of mks 0 and
    1, moving walls of mks 10 and 11, fixed walls, one excluded fluid
    particle."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0.0, 2.0, n), rng.uniform(-0.5, 0.5, n),
                    rng.uniform(0.0, 0.6, n)], axis=1).astype(np.float32)
    vel = rng.normal(0.0, 0.4, (n, 3)).astype(np.float32)
    kind = rng.integers(0, 5, n)
    table = [jtd.code_make(jtd.TYPE_FLUID, 0), jtd.code_make(jtd.TYPE_FLUID, 1),
             jtd.code_make(jtd.TYPE_MOVING, 10),
             jtd.code_make(jtd.TYPE_MOVING, 11), jtd.code_make(jtd.TYPE_FIXED, 0)]
    code = np.array([table[k] for k in kind], np.uint32)
    code[0] = jtd.code_make(jtd.TYPE_FLUID, 0, jtd.SPECIAL_OUT_RHOP)
    return pos, vel, code


def jax_csp(sim2d=False, dp=0.02):
    return jtd.make_ctesph(simulate2d=sim2d, dp=dp, hswl=0.4, coefh=1.0,
                           coefsound=20.0)


def both(pos, vel, code):
    return ((jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(code)),
            (f32(pos), f32(vel), torch.tensor(code.astype(np.int32))))


def test_damping_matches_jax():
    pos, vel, code = feature_cloud()
    (jp, jv, jc), (p, v, c) = both(pos, vel, code)
    zones = (jDMP.DampingPlane(point=(1.2, 0, 0), limitpoint=(1.8, 0, 0),
                               overlimit=0.05, redumax=12.0,
                               factorxyz=(1.0, 0.5, 1.0)),
             jDMP.DampingBox(boxmin1=(0.3, -0.2, 0.1), boxmax1=(0.8, 0.2, 0.4),
                             boxmin2=(0.1, -0.4, 0.0), boxmax2=(1.0, 0.4, 0.5)),
             jDMP.DampingCylinder(point1=(1.0, 0, 0), point2=(1.0, 0, 1.0),
                                  limitmin=0.4, limitmax=0.9, redumax=8.0))
    for dt in (2e-3, 0.02):
        want = jDMP.apply_damping(zones, jnp.float32(dt), jp, jv, jc)
        got = DMP.apply_damping(tuple(convert.feature(z) for z in zones),
                                f32(dt), p, v, c)
        close(got, want)
        assert not np.allclose(np.asarray(want), vel)


def relax_zones():
    grid = jIO.InOutGridVel(times=(0.0, 0.5, 1.0), nx=4, nz=3, dpx=0.4,
                            dpz=0.2, posmin=(0.4, 0.0),
                            velx=tuple(np.linspace(-0.3, 0.5, 36)),
                            velz=tuple(np.linspace(0.2, -0.1, 36)),
                            velcorr=0.02)
    return (
        jRZ.RelaxZoneRegular(center=(1.0, 0, 0), width=0.9, height=0.06,
                             period=1.1, depth=0.4, swl=0.4, order2=True,
                             phase=0.2, ramp=1.0, driftcorrection=0.5,
                             coefdt=30.0),
        jRZ.make_spectrum_zone(center=(0.6, 0, 0), width=1.0, height=0.05,
                               period=1.3, depth=0.4, swl=0.4, waves=12,
                               ramptime=0.5, driftcorrection=1.0,
                               coefdt=40.0),
        jRZ.RelaxZoneExternal(center=(1.2, 0, 0), width=1.0, grid=grid,
                              usevelz=True, coefdir=(0.9, 0.1, 0.0),
                              coefdt=50.0),
        jRZ.RelaxZoneUniform(pmin=(0.2, -0.5, 0.1), pmax=(0.9, 0.5, 0.5),
                             veltimes=(0.0, 0.4, 1.0), velvalues=(0.0, 0.3, 0.1),
                             direction=(0.8, 0.0, 0.6), coefdt=20.0,
                             start=0.1),
        jRZ.RelaxZoneUniform(pmin=(0.5, -0.5, 0.05), pmax=(0.0, 0.0, 0.0),
                             axes=((0.8, 0.0, 0.6), (0.0, 1.0, 0.0),
                                   (-0.6, 0.0, 0.8)),
                             sizes=(0.7, 1.0, 0.3), vel=(0.2, 0.0, -0.1),
                             axis=0, coefdt=0.0),
    )


def test_relaxzones_match_jax():
    pos, vel, code = feature_cloud()
    (jp, jv, jc), (p, v, c) = both(pos, vel, code)
    jzones = relax_zones()
    zones = tuple(convert.feature(z) for z in jzones)
    assert isinstance(zones[2].grid, RZ.GridVel)
    for sim2d in (True, False):
        jcsp = jax_csp(sim2d)
        csp = convert.ctesph(dataclasses.asdict(jcsp))
        for t, dt in ((0.3, 1e-3), (0.7, 0.05)):
            for jz, z in zip(jzones, zones):
                want = jRZ.apply_relaxzones((jz,), jcsp, jnp.float32(t), jp,
                                            jv, jc, dt=jnp.float32(dt))
                got = RZ.apply_relaxzones((z,), csp, f32(t), p, v, c,
                                          dt=f32(dt))
                close(got, want)
                moved = np.abs(np.asarray(want) - vel).max()
                assert moved > 1e-3, (type(jz).__name__, moved)


def test_mlpistons_match_jax(tmp_path):
    pos, vel, code = feature_cloud()
    (jp, jv, jc), (p, v, c) = both(pos, vel, code)
    rng = np.random.default_rng(2)
    csv = tmp_path / "piston.csv"
    times = np.linspace(0.0, 1.0, 6)
    table = rng.normal(0.0, 0.3, (6, 4))
    with open(csv, "w") as f:
        f.write("time;v1;v2;v3;v4\n")
        for t, row in zip(times, table):
            f.write(";".join(f"{x:.6f}" for x in (t, *row)) + "\n")
    jt, jvals = jMLP.load_mlpiston_csv(str(csv), timedataini=0.1)
    t_, vals = MLP.load_mlpiston_csv(str(csv), timedataini=0.1)
    np.testing.assert_array_equal(t_, jt)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(MLP.smooth_table(table, 2, axis=1),
                                  jMLP.smooth_table(table, 2, axis=1))
    one = jMLP.make_piston1d(10, jt, jvals, 0.05, 0.55, smooth=1, incz=0.01)
    single = jMLP.make_piston1d(11, jt, jvals[:, :1], 0.05, 0.55)
    cols = (jMLP.make_piston1d(11, jt, jvals, 0.0, 0.6),
            jMLP.make_piston1d(11, jt, jvals[:, ::-1], 0.0, 0.6),
            jMLP.make_piston1d(11, jt, 0.5 * jvals, 0.0, 0.6))
    two = jMLP.MLPiston2D(mk=11, cols=cols, posy=(-0.4, 0.1, 0.45),
                          direction=(0.9, 0.0, 0.1))
    assert convert.feature(one) == MLP.make_piston1d(
        10, t_, vals, 0.05, 0.55, smooth=1, incz=0.01)
    for pistons in ((one, two), (single,)):
        for t in (0.05, 0.42, 1.3):
            want = jMLP.apply_mlpistons(pistons, jnp.float32(t),
                                        jnp.float32(0.01), jp, jv, jc)
            got = MLP.apply_mlpistons(tuple(convert.feature(x) for x in pistons),
                                      f32(t), f32(0.01), p, v, c)
            close(got[0], want[0], floor=0.0, atol=1e-6)
            close(got[1], want[1])


def test_awas_matches_jax():
    """Two paddles, one still before its start time; the measured column
    in a 2D and a 3D cloud."""
    pos, vel, code = feature_cloud(n=600)
    (jp, jv, jc), (p, v, c) = both(pos, vel, code)
    cfgs = (jAWAS.AwasZsurf(mk=10, height=0.06, period=1.2, depth=0.4,
                            swl=0.35, gauge_x=0.3, gain=0.8, phase=0.3),
            jAWAS.AwasZsurf(mk=11, height=0.04, period=1.0, depth=0.4,
                            swl=0.3, gauge_x=1.1, band=0.08, start=0.5,
                            direction=(0.0, 0.0, 1.0), z0=0.02))
    for sim2d in (True, False):
        jcsp = jax_csp(sim2d, dp=0.05)
        csp = convert.ctesph(dataclasses.asdict(jcsp))
        corr0 = np.array([0.01, -0.02], np.float32)
        for t in (0.2, 0.9):
            want = jAWAS.apply_awas(cfgs, jcsp, jnp.asarray(corr0),
                                    jnp.float32(t), jnp.float32(1e-3), jp,
                                    jv, jc)
            got = AWAS.apply_awas(tuple(convert.feature(x) for x in cfgs), csp,
                                  torch.tensor(corr0), f32(t), f32(1e-3),
                                  p, v, c)
            close(got[0], want[0], floor=0.0, atol=1e-6)
            close(got[1], want[1], rtol=1e-4)
            np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                       rtol=1e-4)
            for cfg in cfgs:
                close(AWAS.measure_eta(convert.feature(cfg), csp, p, c),
                      jAWAS.measure_eta(cfg, jcsp, jp, jc), rtol=1e-4)


def test_accinput_matches_jax(tmp_path):
    pos, vel, code = feature_cloud()
    (jp, jv, jc), (p, v, c) = both(pos, vel, code)
    csv = tmp_path / "acc.csv"
    with open(csv, "w") as f:
        f.write("# time ax ay az wx wy wz\n")
        for k, t in enumerate(np.linspace(0.0, 1.0, 5)):
            f.write(f"{t} {0.3 * k} 0 {-0.1 * k}; {0.2 * k}, 0.5 {0.1}\n")
    times, lins, angs = jACC.load_accinput_csv(str(csv))
    assert ACC.load_accinput_csv(str(csv)) == (times, lins, angs)
    inputs = (jACC.AccInput(mkfluid=0, times=times, acclin=lins, accang=angs,
                            centre=(1.0, 0.0, 0.3), tstart=0.1, tend=0.9),
              jACC.AccInput(mkbound=(10, 11), times=times, acclin=lins,
                            gravity_enabled=False),
              jACC.AccInput(mkfluid=1, times=(0.0,), acclin=(0.5, 0.0, 0.2)))
    jcsp = jax_csp()
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    ace = np.random.default_rng(3).normal(0.0, 2.0, pos.shape).astype(np.float32)
    for t in (0.05, 0.37, 1.2):
        want = jACC.apply_accinput(inputs, jcsp, jnp.float32(t), jp, jv, jc,
                                   jnp.asarray(ace))
        got = ACC.apply_accinput(tuple(convert.feature(x) for x in inputs), csp,
                                 f32(t), p, v, c, f32(ace))
        close(got, want)


# ---------------------------------------------------------------------------
# gauges
# ---------------------------------------------------------------------------

def still_flume(seed=4):
    """The small flume's still water with a seeded jitter of 0.05 dp in
    the fluid positions and 0.05 m/s in its velocities."""
    jcase = jcases.waveflume2d(**FLUME)
    rng = np.random.default_rng(seed)
    st = jcase.state
    fluid = jtd.code_type(np.asarray(st.code)) == jtd.TYPE_FLUID
    jit = rng.normal(0.0, 0.05 * FLUME["dp"], st.pos.shape) * fluid[:, None]
    jit[:, 1] = 0.0
    dv = rng.normal(0.0, 0.05, st.pos.shape) * fluid[:, None]
    dv[:, 1] = 0.0
    st = dataclasses.replace(
        st, pos=jnp.asarray(np.asarray(st.pos) + jit, jnp.float32),
        vel=jnp.asarray(dv, jnp.float32))
    return jcase, st


def test_gauges_match_jax():
    jcase, jst = still_flume()
    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    st = convert.simstate({k: np.asarray(getattr(jst, k))
                           for k in ("pos", "vel", "rho", "code", "idp")},
                          device="cpu")
    jdiv, _ = jcd.divide(jcase.dom, jst.pos, jst.code)
    dp = FLUME["dp"]
    gauges = (jG.GaugeVel("vel", (0.52, 0.0, 0.21)),
              jG.GaugeVel("vel-dry", (0.5, 0.0, 0.65)),
              jG.GaugeSwl("swl", (0.77, 0.0, 0.1), (0.77, 0.0, 0.65), 0.3 * dp),
              jG.GaugeMaxZ("maxz", (1.0, 0.0, 0.0), 0.6, 2.0 * dp),
              jG.GaugeForce("force", 0))
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    sorted_st = dataclasses.replace(st, code=code).permuted(cells.order)
    for jg in gauges:
        g = convert.feature(jg)
        want = jg.compute(jcase.csp, jcase.dom, jdiv, jst)
        got = g.compute(csp, dom, cells, sorted_st)
        if isinstance(jg, jG.GaugeVel):
            close(got, want, rtol=1e-4, floor=0.0, atol=1e-6)
        elif isinstance(jg, jG.GaugeForce):
            assert np.abs(want).max() > 0
            close(got, want, rtol=1e-4, floor=1e-4)
        else:
            np.testing.assert_array_equal(got, want)
    # the SWL reading is a discrete choice: no sample point's mass sum lies
    # within 3% of the limit (3.8% at the closest on this state)
    swl = convert.feature(gauges[2])
    mass = swl.masses(csp, dom, cells, sorted_st)
    limit = 0.5 * csp.rhopzero
    assert np.abs(mass - limit).min() > 0.03 * limit
    # the gauge system divides afresh without a layout, and keeps its cadence
    gs = G.GaugeSystem(csp, dom, [convert.feature(g) for g in gauges[:3]],
                       computedts={"vel": 0.05})
    out = gs.run(0.0, st)
    assert set(out) == {"vel", "vel-dry", "swl"}
    close(out["vel"], gauges[0].compute(jcase.csp, jcase.dom, jdiv, jst),
          rtol=1e-4, floor=0.0, atol=1e-6)
    assert gs.next_time(0.0) == pytest.approx(0.05)
    assert set(gs.run(0.02, st, cells=cells, at_save=False)) == set()
    assert set(gs.run(0.05, sorted_st, cells=cells, at_save=False)) == {"vel"}


# ---------------------------------------------------------------------------
# steps of the flume
# ---------------------------------------------------------------------------

def flume_features(m, verlet):
    """The features of a flume run in module set ``m`` (JAX or the port):
    (motions, awas, damping, relaxzones, accinputs)."""
    MOTm, WGm, AWm, DMm, RZm, ACm = m
    if verlet:
        return dict(
            motions=(MOTm.piston_sinusoidal(10, freq=1.5, amplitude=0.05),),
            relaxzones=(RZm.RelaxZoneRegular(center=(1.3, 0, 0), width=0.5,
                                             height=0.04, period=1.0, depth=0.4,
                                             swl=0.4, coefdt=100.0),),
            accinputs=(ACm.AccInput(mkfluid=0, times=(0.0, 1.0),
                                    acclin=(0.5, 0.0, 0.0, 0.2, 0.0, 0.1)),))
    return dict(
        motions=(WGm.piston_waves(10, height=0.05, period=1.0, depth=0.4,
                                  order=2),),
        awas=(AWm.AwasZsurf(mk=10, height=0.05, period=1.0, depth=0.4,
                            swl=0.4, gauge_x=0.25),),
        damping=(DMm.DampingPlane(point=(1.4, 0, 0), limitpoint=(1.9, 0, 0)),))


JMODS = (jMOT, jWG, jAWAS, jDMP, jRZ, jACC)
MODS = (MOT, WG, AWAS, DMP, RZ, ACC)


@pytest.mark.parametrize("verlet", [False, True])
def test_flume_steps_match_jax(verlet):
    """3 steps of the small flume under mDBC walls (NO_SLIP, the piston's
    face with normals): the symplectic step writes the moving walls'
    velocity into motionvel, the Verlet step leaves it at zero."""
    jcase = jcases.waveflume2d(**FLUME)
    pcase = cases.waveflume2d(**FLUME, need_verlet=verlet, mdbc=True,
                              device="cpu")
    normals = pcase.state.boundnormal.numpy()
    assert (normals[:, 0] > 0).sum() > 0
    # the JAX builder has neither the mDBC normals nor the M1 state: the
    # port's go in, as the JAX _make_state would make them
    jst = dataclasses.replace(jcase.state, boundnormal=jnp.asarray(normals),
                              motionvel=jnp.zeros_like(jcase.state.pos))
    if verlet:
        jst = dataclasses.replace(jst, velm1=jnp.zeros_like(jst.vel),
                                  rhom1=jst.rho)
    tstep = "VERLET" if verlet else "SYMPLECTIC"
    jopts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False,
                          tboundary=jtd.TpBoundary.MDBC,
                          slipmode=jtd.TpSlipMode.NO_SLIP,
                          tstep=jtd.TpStep[tstep])
    jfeats = jFeatures(**flume_features(JMODS, verlet))
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jcase.dom, jfeats))
    jcarry = jW.make_carry(jst, jcase.csp, jopts, jfeats, dom=jcase.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    assert pcase.dom == dom
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS,
                        tboundary=td.TpBoundary.MDBC,
                        slipmode=td.TpSlipMode.NO_SLIP, tstep=td.TpStep[tstep])
    feats = convert.features(jfeats)
    assert feats == P.Features(**flume_features(MODS, verlet))
    carry = P.make_carry(pcase.state, csp, opts, dom, feats)
    step = P.make_step(csp, opts, dom, feats)
    for _ in range(NSTEPS):
        carry = step(carry)

    st, jst = carry.st, jcarry.st
    np.testing.assert_allclose(by_id(st, "pos"), np.asarray(jst.pos), rtol=0,
                               atol=1e-4 * csp.dp)
    np.testing.assert_allclose(by_id(st, "rho"), np.asarray(jst.rho), rtol=1e-5)
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
    np.testing.assert_allclose(carry.t_host, float(jcarry.t), rtol=1e-4)
    mv = by_id(st, "motionvel")
    np.testing.assert_allclose(mv, np.asarray(jst.motionvel), rtol=1e-5,
                               atol=1e-5)
    moving = td.is_moving(torch.tensor(by_id(st, "code")))
    if verlet:
        assert not mv.any()
    else:
        assert np.abs(mv[moving.numpy(), 0]).min() > 0
    if not verlet:
        # the correction is proportional to eta_target - eta, with eta the
        # ~0.4 m column less the depth: ~2e-4 m here, so the f32 rounding of
        # the column's sum (~1e-7 relative, added in another order) is up
        # to ~1e-3 of it
        np.testing.assert_allclose(carry.awas.numpy(), np.asarray(jcarry.awas),
                                   rtol=5e-3)
        assert float(carry.awas.abs().max()) > 0


def test_piston_layout_keeps_every_pair():
    """A piston at 1.9 m/s: between rebuilds the layout of the last divide
    still holds every pair a fresh divide finds (walls included), at the
    positions of the next predictor and one dt beyond; the wall's motion
    enters pos after the step's interactions, as shifting does."""
    case = cases.waveflume2d(**FLUME, device="cpu")
    feats = P.Features(motions=(MOT.piston_sinusoidal(10, freq=6.0,
                                                      amplitude=0.05),))
    opts = P.SolverOpts()
    carry = P.make_carry(case.state, case.csp, opts, case.dom, feats)
    step = P.make_step(case.csp, opts, case.dom, feats)
    checked = 0
    for _ in range(12):
        carry = step(carry)
        if carry.rebuild:
            continue
        st = carry.st
        for pos in (st.pos, st.pos + carry.dt_pre * st.vel):
            fresh, code = cd.divide_cells(case.dom, pos, st.code)
            o = fresh.order
            want = torch.empty_like(o)
            want[o] = pairs_per_target(case.csp, case.dom, fresh, pos[o],
                                       code[o])
            got = pairs_per_target(case.csp, case.dom, carry.cells, pos,
                                   st.code)
            assert torch.equal(got, want)
        checked += 1
    assert checked >= 2 and carry.nrebuild >= 2


def test_run_stops_at_gauge_subticks():
    """Simulation.run stops the steps at each gauge tick inside a save
    interval and reads the gauges there, on the carry's layout."""
    case = cases.waveflume2d(**FLUME, device="cpu")
    feats = P.Features(motions=(case.meta["motion"],))
    sim = P.Simulation(case.csp, P.SolverOpts(), case.dom, case.state, feats)
    gs = G.GaugeSystem(case.csp, case.dom,
                       [G.GaugeSwl("swl", (0.6, 0.0, 0.1), (0.6, 0.0, 0.65),
                                   0.5 * FLUME["dp"])],
                       computedts={"swl": 0.004})
    ticks = []

    def on_subtick(s, t):
        cells = None if s.carry.rebuild else s.carry.cells
        ticks.append((t, gs.run(t, s.carry.st, cells, at_save=False)))

    sim.run(tmax=0.01, tout=0.01, next_subtick=gs.next_time,
            on_subtick=on_subtick)
    assert [round(t, 3) for t, _ in ticks][:2] == [0.004, 0.008]
    assert all(t >= k * 0.004 - 1e-7 for k, (t, _) in enumerate(ticks, 1))
    assert all(abs(float(r["swl"][2]) - 0.4) < 2 * FLUME["dp"]
               for _, r in ticks)


def test_unported_features_raise():
    case = cases.waveflume2d(**FLUME, device="cpu")
    for name in ("periodic", "inout", "dem", "moorings", "forcepoints",
                 "chrono", "chcontact"):
        with pytest.raises(NotImplementedError, match=f"Features.{name}"):
            P.make_step(case.csp, P.SolverOpts(), case.dom,
                        P.Features(**{name: object()}))
