"""The Verlet step: 3 steps of the small 3D dam break (876 particles)
through the port against the JAX package's jitted
``make_step(tstep=VERLET, use_pallas=False)`` on the same state, with an
Euler re-anchoring step inside the run (``verlet_steps=2``: leapfrog,
Euler, leapfrog):

* Wendland, artificial viscosity, Fourtakas (bench.py's Verlet cell), from
  rest and flowing fast enough to re-divide inside the run;
* the cubic spline with laminar+SPS viscosity and NO_FIXED shifting
  (``-cubic -viscolamsps:1e-6 -shifting:2``), flowing, through the plain
  version of kernel 3's cubic instance: the cubic spline, the SPS stress
  and the shifting displacement in one configuration, one JAX compile
  (each costs about 10 CPU-s here, and each JAX step about 4).

Contract (README, sharded-vs-single): positions within 1e-4*dp by particle
id, density within rtol 1e-5, dt_pre within rtol 1e-4; the M1 density
within rtol 1e-5 too, the velocity and the M1 velocity within rtol 1e-4
with a floor of 1e-5 of the largest speed (or of 1 m/s); the SPS stress
within rtol 2e-3 with a floor of 2e-3 of the largest value.
Then the layout the port keeps between rebuilds holds every pair a fresh
divide finds under fast Verlet flow, and ``make_carry`` refuses a Verlet
run whose state has no M1 arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import forces as jF
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

from test_torch_variant_steps import (GEOM, LAMSPS_VISCO, by_id, lamsps_csp,
                                      pairs_per_target)

torch.set_num_threads(2)

NSTEPS = 3
VERLET_STEPS = 2


def path_opts(m, path):
    """SolverOpts fields of a Verlet path in module ``m`` (the JAX
    package's or the port's typesdef)."""
    kw = dict(tstep=m.TpStep.VERLET, verlet_steps=VERLET_STEPS,
              tdensity=m.TpDensity.FOURTAKAS)
    if path == "variant":
        kw.update(tvisco=m.TpVisco.LAMINAR_SPS, shiftmode=m.TpShifting.NO_FIXED)
    return kw


@pytest.fixture(scope="module")
def jax_paths():
    """path -> (case, csp, opts, jitted Verlet step) of the JAX package,
    each compiled once for the module."""
    built = {}

    def get(path):
        if path not in built:
            if path == "variant":
                case = jcases.dambreak3d(**GEOM, visco=LAMSPS_VISCO,
                                         need_sps=True, need_verlet=True)
                csp = lamsps_csp(jtd, GEOM["dp"]).replace(
                    tkernel=jtd.TpKernel.CUBIC)
            else:
                case = jcases.dambreak3d(**GEOM, need_verlet=True)
                csp = case.csp
            opts = jF.SolverOpts(use_pallas=False, **path_opts(jtd, path))
            built[path] = (case, csp, opts,
                           jax.jit(jW.make_step(csp, opts, case.dom)))
        return built[path]

    return get


def initial_arrays(case, flow, speed=2.5):
    """The case's state as numpy arrays; ``flow`` gives the fluid a seeded
    velocity along x, the M1 velocity too (a run already in motion)."""
    st = case.state
    arrays = {k: np.asarray(getattr(st, k))
              for k in ("pos", "vel", "rho", "code", "idp", "spstau",
                        "velm1", "rhom1")
              if getattr(st, k) is not None}
    if flow:
        rng = np.random.default_rng(5)
        fluid = jtd.code_type(arrays["code"]) == jtd.TYPE_FLUID
        vel = np.array([speed, 0.0, 0.0]) + rng.normal(0.0, 0.3,
                                                       arrays["pos"].shape)
        arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
        arrays["velm1"] = arrays["vel"].copy()
    return arrays


@pytest.mark.parametrize("path,flow", [("main", False), ("main", True),
                                       ("variant", True)])
def test_verlet_steps_match_jax(jax_paths, path, flow):
    case, jcsp, jopts, jstep = jax_paths(path)
    arrays = initial_arrays(case, flow)
    jcarry = jW.make_carry(dataclasses.replace(
        case.state, vel=jnp.asarray(arrays["vel"]),
        velm1=jnp.asarray(arrays["velm1"])), jcsp, jopts, dom=case.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(jcsp))
    dom = convert.domain(dataclasses.asdict(case.dom))
    opts = P.SolverOpts(**path_opts(td, path))
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_step(csp, opts, dom)
    launches = dict(CF.launches)
    counts = []
    for _ in range(NSTEPS):
        carry = step(carry)
        counts.append(carry.verlet_count)
    assert CF.launches == launches      # CPU tensors never reach the kernel
    # leapfrog, the Euler re-anchoring step, leapfrog
    assert counts == [1, 0, 1] and int(jcarry.verlet_count) == 1
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert carry.nrebuild >= (2 if flow else 1)

    st, jst = carry.st, jcarry.st
    np.testing.assert_allclose(by_id(st, "pos"), np.asarray(jst.pos), rtol=0,
                               atol=1e-4 * csp.dp)
    for k in ("rho", "rhom1"):
        np.testing.assert_allclose(by_id(st, k), np.asarray(getattr(jst, k)),
                                   rtol=1e-5)
    vscale = 1e-5 * max(float(np.abs(np.asarray(jst.vel)).max()), 1.0)
    for k in ("vel", "velm1"):
        np.testing.assert_allclose(by_id(st, k), np.asarray(getattr(jst, k)),
                                   rtol=1e-4, atol=vscale)
    code = np.asarray(jst.code).astype(np.int32)
    np.testing.assert_array_equal(by_id(st, "code"), code)
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
    np.testing.assert_allclose(carry.t_host, float(jcarry.t), rtol=1e-4)
    assert int(carry.dtmodif) == int(jcarry.dtmodif)
    if path == "variant":
        want = np.asarray(jst.spstau)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(by_id(st, "spstau"), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())


def test_verlet_layout_keeps_every_pair():
    """Between rebuilds, under fast Verlet flow, the layout of the last
    divide finds every pair a fresh divide finds, at the positions of the
    next interaction and one dt beyond.  The Verlet step fixes dt after its
    interaction, so the skin contract's lookahead reads the previous
    step's dt."""
    case = cases.dambreak3d(**GEOM, need_verlet=True, device="cpu")
    arrays = initial_arrays(case, True, speed=1.0)
    opts = P.SolverOpts(tstep=td.TpStep.VERLET, verlet_steps=3)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), case.csp,
                         opts, case.dom)
    step = P.make_step(case.csp, opts, case.dom)
    checked = 0
    for _ in range(8):
        carry = step(carry)
        if carry.rebuild:
            continue
        st = carry.st
        for pos in (st.pos, st.pos + carry.dt_pre * st.vel):
            fresh, code = cd.divide_cells(case.dom, pos, st.code)
            o = fresh.order
            want = torch.empty_like(o)
            want[o] = pairs_per_target(case.csp, case.dom, fresh, pos[o], code[o])
            got = pairs_per_target(case.csp, case.dom, carry.cells, pos, st.code)
            assert torch.equal(got, want)
        checked += 1
    assert checked >= 2 and carry.nrebuild >= 2


def test_verlet_needs_the_m1_state():
    case = cases.dambreak3d(**GEOM, device="cpu")
    opts = P.SolverOpts(tstep=td.TpStep.VERLET)
    with pytest.raises(ValueError, match="need_verlet"):
        P.make_carry(case.state, case.csp, opts, case.dom)
    # the NN step stays symplectic, as the JAX package's is
    phases = P.PhaseCfg(phases=(P.Phase(mkfluid=0, rho0=1000.0, csound=20.0),))
    with pytest.raises(NotImplementedError, match="tstep=VERLET"):
        P.make_nn_step(case.csp, opts, case.dom, phases)
