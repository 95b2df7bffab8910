"""Phase tables of more than 8 phases on the NN solver: TPU kernels 4-6
(``nnforce_p1``, ``nnforce_fda``, ``nnforce_p3``) read a table of up to 8
phases from their parameters and, in their wide instances, a table of any
count from a device array (csrc/nnbody.cuh ``phase_cte``, picked at launch
by ``NnParams.phtab``); the plain version indexes its tables by phase.

The case: ``layered_dambreak_nn``, the wet dam break in a small tank (141
particles at dp 0.05) with its mud column in 11 strata, 12 phases of
distinct rest density, consistency, yield stress, power index and (every
third stratum) bi-viscosity constants, with a flow drawn from a numpy
seed.  Held here:

- 3 steps of the port's ``make_nn_step`` (the plain version, CPU
  tensors) against the JAX package's ``make_nn_step(use_pallas=False)``
  (its bucket path, whose table has no count limit), SPH Morris and FDA
  Morris: positions within 1e-4*dp by particle id, density within rtol
  1e-5, dt within rtol 1e-4 (the contract of test_torch_nnewtonian.py);
- the kernels' g++ twins in their wide instances at 12 phases against the
  plain passes (the rule of test_torch_nngroup.py: rtol 2e-3, 4e-3 with
  the cubic spline, with a floor of rtol times the largest value; viscdt
  rtol 1e-3; flags exact);
- the wide instances bit-equal to the parameter-table ones at 2 phases;
- a power index above 1 under FDA at the chip's dp blowing up in two
  steps in the JAX package's step as in the port's, by id within 1e-4*dp;
- the refusals gone: ``check_supported_nn`` takes 12 phases (a table of
  none still raises, as JAX's ``make_nn_csp`` fails on one), while the
  parameters' own table and the launchers refuse more than 8 phases
  without the device table.
"""

import ctypes
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import nnewtonian as jNM
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import forces_nn as jNN
from dualsphysics_multilayer_tpu.ops.forces import SolverOpts as JOpts
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
from dualsphysics_multilayer_tpu_torch.ops.cuda import build
from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF

torch.set_num_threads(2)

DP = 0.05
NSTEPS = 3
GEOM = dict(tank=(1.0, 0.7), mud=(0.3, 0.55), water_depth=0.1)


def layered(dp, **geom):
    """``layered_dambreak_nn`` with the strata's power index from 0.8 to
    1.2, so that every field of the phase table varies (stable at dp 0.05
    over these steps)."""
    case, ph = NM.layered_dambreak_nn(dp, device="cpu", **geom)
    top = ph.count - 2
    return case, NN.PhaseCfg(phases=(ph.phases[0],) + tuple(
        dataclasses.replace(p, hbp_n=0.8 + 0.4 * k / top)
        for k, p in enumerate(ph.phases[1:])))


@pytest.fixture(scope="module")
def strata():
    """(port case, its 12 phases, the state's arrays with the seeded flow:
    2.5 m/s along x with a 0.3 m/s jitter, none along y, and a 0.5%
    density jitter of each phase's rest density, on the fluid)."""
    case, ph = layered(DP, **GEOM)
    st = case.state
    arrays = {k: getattr(st, k).numpy().copy()
              for k in ("pos", "vel", "rho", "code", "idp")}
    rng = np.random.default_rng(19)
    fluid = td.is_fluid(st.code).numpy()
    vel = np.array([2.5, 0.0, 0.0]) + rng.normal(0.0, 0.3, arrays["pos"].shape)
    vel[:, 1] = 0.0
    arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    arrays["rho"] = np.where(
        fluid, arrays["rho"] * rng.uniform(0.995, 1.005, st.n),
        arrays["rho"]).astype(np.float32)
    return case, ph, arrays


def test_layered_case_holds_twelve_distinct_phases(strata):
    case, ph, arrays = strata
    assert case.np_total == 141 and ph.count == 12 > NF.TABLE_PHASES
    fluid = td.is_fluid(case.state.code)
    counts = torch.bincount(td.code_value(case.state.code)[fluid])
    assert counts.tolist() == [26] + [6] * 11
    for f in ("rho0", "visco", "tau_yield", "hbp_n", "csound"):
        assert len({getattr(p, f) for p in ph.phases[1:]}) == 11, f
    assert {p.tau_max > 0 for p in ph.phases} == {True, False}
    # each stratum at its rest density, denser below
    rho0 = torch.tensor([p.rho0 for p in ph.phases])
    mud = fluid & (td.code_value(case.state.code) > 0)
    v = td.code_value(case.state.code)[mud].long()
    assert torch.equal(case.state.rho[mud], rho0[v].float())
    z = case.state.pos[mud, 2]
    assert bool((z[1:][v[1:] > v[:-1]] > z[:-1][v[1:] > v[:-1]]).all())


def jax_phases(ph):
    return jNN.PhaseCfg(phases=tuple(jNN.Phase(**dataclasses.asdict(p))
                                     for p in ph.phases))


@pytest.mark.parametrize("velgrad", ["SPH", "FDA"])
def test_twelve_phase_steps_match_jax(strata, velgrad):
    case, ph, arrays = strata
    jph = jax_phases(ph)
    assert convert.phasecfg(jph) == ph
    jcase, _ = jNM.wet_dambreak_nn(dp=DP, **GEOM)
    jcsp = jNM.make_nn_csp(simulate2d=True, dp=DP, phases=jph,
                           hswl=max(GEOM["mud"][1], GEOM["water_depth"]))
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    assert csp == case.csp and dom == case.dom
    assert np.array_equal(np.asarray(jcase.state.pos), arrays["pos"])

    jopts = JOpts(tvisco=jtd.TpVisco.LAMINAR_SPS,
                  tdensity=jtd.TpDensity.FOURTAKAS,
                  velgrad=jtd.TpVelGrad[velgrad], use_pallas=False)
    jst = dataclasses.replace(jcase.state, **{
        k: jnp.asarray(arrays[k]).astype(getattr(jcase.state, k).dtype)
        for k in ("vel", "rho", "code")})
    jstep = jax.jit(jNM.make_nn_step(jcsp, jopts, jcase.dom, jph))
    jcarry = jW.make_carry(jst, jcsp, jopts)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS,
                        tdensity=td.TpDensity.FOURTAKAS,
                        velgrad=td.TpVelGrad[velgrad])
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_nn_step(csp, opts, dom, ph)
    launches = dict(NF.launches)
    for _ in range(NSTEPS):
        carry = step(carry)
    assert NF.launches == launches      # CPU tensors never reach the kernels
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert int(jcarry.overflow) == 0

    st = carry.st
    idp = st.idp.numpy()
    out = {}
    for k in ("pos", "rho", "code"):
        a = getattr(st, k).numpy()
        out[k] = np.empty_like(a)
        out[k][idp] = a
    np.testing.assert_allclose(out["pos"], np.asarray(jcarry.st.pos), rtol=0,
                               atol=1e-4 * DP)
    np.testing.assert_allclose(out["rho"], np.asarray(jcarry.st.rho), rtol=1e-5)
    np.testing.assert_array_equal(out["code"],
                                  np.asarray(jcarry.st.code).astype(np.int32))
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
    assert int(carry.dtmodif) == int(jcarry.dtmodif)


def test_shear_thickening_fda_blows_up_as_jax_does():
    """Under FDA, whose strain magnitude is the square of the rate, the
    strata's power index above 1 beside the no-slip wall blows up at the
    chip's dp (3.21 mm; a narrow tank, 1,735 particles, fluid at 1 m/s):
    after each of two steps a particle moves at more than 10 m/s, and dt
    falls more than fivefold from the first step's, in the JAX package's
    step as in the port's, which agree by id within 1e-4*dp (why
    ``layered_dambreak_nn``'s strata keep the mud's power index, 1)."""
    dp = 0.00321
    geom = dict(tank=(0.1, 0.35), mud=(0.05, 0.3), water_depth=0.02)
    case, ph = layered(dp, **geom)
    assert case.np_total == 1735
    st = case.state
    arrays = {k: getattr(st, k).numpy().copy()
              for k in ("pos", "vel", "rho", "code", "idp")}
    fluid = td.is_fluid(st.code).numpy()
    vel = np.random.default_rng(0).normal(0.0, 0.05, arrays["pos"].shape)
    vel[:, 0] += 1.0
    vel[:, 1] = 0.0
    arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    jph = jax_phases(ph)
    jcase, _ = jNM.wet_dambreak_nn(dp=dp, **geom)
    jcsp = jNM.make_nn_csp(simulate2d=True, dp=dp, phases=jph, hswl=0.3)
    jopts = JOpts(tvisco=jtd.TpVisco.LAMINAR_SPS,
                  tdensity=jtd.TpDensity.FOURTAKAS,
                  velgrad=jtd.TpVelGrad.FDA, use_pallas=False)
    jst = dataclasses.replace(jcase.state, vel=jnp.asarray(arrays["vel"]),
                              code=jnp.asarray(arrays["code"]).astype(
                                  jcase.state.code.dtype),
                              rho=jnp.asarray(arrays["rho"]))
    jstep = jax.jit(jNM.make_nn_step(jcsp, jopts, jcase.dom, jph))
    jcarry = jW.make_carry(jst, jcsp, jopts)
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS,
                        tdensity=td.TpDensity.FOURTAKAS,
                        velgrad=td.TpVelGrad.FDA)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts,
                         case.dom)
    step = P.make_nn_step(csp, opts, case.dom, ph)
    dt0 = None
    for _ in range(2):
        jcarry, carry = jstep(jcarry), step(carry)
        dt0 = dt0 or float(carry.dt_pre)
        idp = carry.st.idp.numpy()
        pos = np.empty_like(carry.st.pos.numpy())
        pos[idp] = carry.st.pos.numpy()
        np.testing.assert_allclose(pos, np.asarray(jcarry.st.pos), rtol=0,
                                   atol=1e-4 * dp)
        np.testing.assert_allclose(float(carry.dt_pre),
                                   float(jcarry.dt_pre), rtol=1e-4)
        assert float(carry.st.vel.abs().max()) > 10.0
        assert float(np.abs(np.asarray(jcarry.st.vel)).max()) > 10.0
    assert float(carry.dt_pre) < 0.2 * dt0


def sorted_run(case, ph, arrays, tkernel, shiftmode, tvisco, velgrad,
               tdensity):
    """(pass 1's arguments on the sorted state, the sorted code)."""
    csp = case.csp.replace(tkernel=td.TpKernel[tkernel])
    opts = P.SolverOpts(tvisco=td.TpVisco[tvisco],
                        velgrad=td.TpVelGrad[velgrad],
                        tdensity=td.TpDensity[tdensity],
                        shiftmode=td.TpShifting[shiftmode])
    NN.check_supported_nn(csp, opts, ph)
    t = {k: torch.from_numpy(arrays[k]) for k in ("pos", "vel", "rho", "code")}
    cells, code = cd.divide_cells(case.dom, t["pos"], t["code"])
    o = cells.order
    pos, vel, rho, code = t["pos"][o], t["vel"][o], t["rho"][o], code[o]
    ch = NN.channels(csp, ph, ph.tables(csp, "cpu"), rho, code)
    return (csp, opts, ph, case.dom, cells, pos, vel, rho, ch), code


def assert_close(want, got, rtol, keys):
    for k in keys:
        w, g = want[k], got[k]
        assert (w is None) == (g is None), k
        if w is not None:
            scale = float(w.abs().max()) + 1e-6
            torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * scale,
                                       msg=k)


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")


# (pass, tkernel, shiftmode, tvisco, tdensity): every phase-table read of
# the three kernels (mass, cs0 in diffusion and artificial viscosity, the
# heavy-phase shifting gate, the HBP constants of FDA)
INSTANCES = [
    ("p1", "WENDLAND", "NONE", "LAMINAR_SPS", "FOURTAKAS"),
    ("p1", "WENDLAND", "NO_BOUND", "CONST_EQ", "MOLTENI"),
    ("fda", "WENDLAND", "NONE", "LAMINAR_SPS", "FOURTAKAS"),
    ("fda", "CUBIC", "FULL", "CONST_EQ", "FOURTAKAS"),
    ("p3", "WENDLAND", "NONE", "LAMINAR_SPS", "FOURTAKAS"),
    ("p3", "WENDLAND", "NONE", "CONST_EQ", "FOURTAKAS"),
    ("p3", "CUBIC", "NONE", "ARTIFICIAL", "FOURTAKAS"),
]
P1_KEYS = ("ace", "ar", "gradvel", "etamax", "shift")


@pytest.mark.parametrize("kernel,tkernel,shiftmode,tvisco,tdensity", INSTANCES)
def test_wide_twins_match_plain_at_twelve_phases(gxx, strata, kernel,
                                                 tkernel, shiftmode, tvisco,
                                                 tdensity):
    case, ph, arrays = strata
    velgrad = "FDA" if kernel == "fda" else "SPH"
    run, code = sorted_run(case, ph, arrays, tkernel, shiftmode, tvisco,
                           velgrad, tdensity)
    rtol = 4e-3 if tkernel == "CUBIC" else 2e-3
    launches = dict(NF.launches)
    if kernel == "p3":
        p1 = NN.pass1_plain(*run)
        eta, tau = NN.pass2(run[1], ph.tables(run[0], "cpu"), run[-1], code,
                            p1)
        got, want = torch.zeros_like(p1.ace), torch.zeros_like(p1.ace)
        NF.pass3(*run, eta, tau, got, twin=True)
        NN.pass3_plain(*run, eta, tau, want)
        assert_close(dict(ace=want), dict(ace=got), rtol, ("ace",))
        assert got.any()
    else:
        got, want = NF.pass1(*run, twin=True), NN.pass1_plain(*run)
        assert_close(vars(want), vars(got), rtol, P1_KEYS)
        torch.testing.assert_close(got.viscdt, want.viscdt, rtol=1e-3,
                                   atol=1e-5)
        if want.shiftblk is not None:
            assert torch.equal(got.shiftblk, want.shiftblk)
        if kernel == "fda":
            # the strata's own rheology reaches the eta max
            fl = td.is_fluid(code) & (got.etamax > 0)
            assert len(set(td.code_value(code)[fl].tolist())) == ph.count
    assert NF.launches == launches          # the twin is no kernel launch


def test_wide_twins_equal_table_twins_at_two_phases(gxx, monkeypatch):
    """At 2 phases the wide instances (the table in an array, picked here
    by a parameters' table of one phase) and the parameter-table ones run
    the same arithmetic on the same f32 values: bit-equal outputs."""
    case, ph = NM.wet_dambreak_nn(dp=DP, device="cpu")
    arrays = {k: getattr(case.state, k).numpy()
              for k in ("pos", "vel", "rho", "code")}
    rng = np.random.default_rng(3)
    arrays["vel"] = np.where(td.is_fluid(case.state.code).numpy()[:, None],
                             rng.normal(0.0, 0.5, arrays["pos"].shape),
                             0.0).astype(np.float32)
    arrays["vel"][:, 1] = 0.0
    for kernel, tvisco, velgrad in (("p1", "LAMINAR_SPS", "SPH"),
                                    ("fda", "CONST_EQ", "FDA"),
                                    ("p3", "ARTIFICIAL", "SPH")):
        run, code = sorted_run(case, ph, arrays, "WENDLAND", "NO_BOUND",
                               tvisco, velgrad, "FOURTAKAS")
        if kernel == "p3":
            eta, tau = torch.rand(code.shape[0]), torch.rand((code.shape[0], 6))
            out = [torch.zeros((code.shape[0], 3)) for _ in range(2)]
            for table, ace in zip((NF.TABLE_PHASES, 1), out):
                monkeypatch.setattr(NF, "TABLE_PHASES", table)
                NF.pass3(*run, eta, tau, ace, twin=True)
            assert out[0].any() and torch.equal(out[0], out[1])
            monkeypatch.undo()
            continue
        a = NF.pass1(*run, twin=True)
        monkeypatch.setattr(NF, "TABLE_PHASES", 1)
        assert NF.table_device(ph, "cpu") == "cpu"
        b = NF.pass1(*run, twin=True)
        monkeypatch.undo()
        for k in P1_KEYS + ("viscdt", "shiftblk"):
            assert torch.equal(getattr(a, k), getattr(b, k)), (kernel, k)


def test_phase_count_limits(gxx, strata):
    """``check_supported_nn`` takes 12 phases and refuses none; the
    parameters' own table refuses more than 8 without the device table,
    and so do the launchers (cudaErrorInvalidValue, 1), which take the
    device table."""
    case, ph, arrays = strata
    opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS)
    NN.check_supported_nn(case.csp, opts, ph)
    P.make_nn_step(case.csp, opts, case.dom, ph)
    with pytest.raises(ValueError, match="at least one phase"):
        NN.check_supported_nn(case.csp, opts, NN.PhaseCfg(phases=()))
    run, code = sorted_run(case, ph, arrays, "WENDLAND", "NONE",
                           "LAMINAR_SPS", "SPH", "FOURTAKAS")
    n = code.shape[0]
    with pytest.raises(ValueError, match="12 phases"):
        NF.make_params(case.csp, opts, ph, case.dom, n)
    params = NF.make_params(case.csp, opts, ph, case.dom, n, "cpu")
    assert params.nphases == 12 and params.phtab == params.table.data_ptr()
    ch = run[-1]
    pospress, velrho = NF._rows(*run[5:8], ch)
    ins = [pospress, velrho, ch.kind, ch.phase, run[4].cell, run[4].begin]
    outs = [torch.empty((n, 3)), torch.empty(n), torch.empty(n),
            torch.empty((n, 6)), None, None]
    p3outs = [torch.zeros(n), torch.zeros((n, 6)), torch.zeros((n, 3))]
    lib = build.host_twin_library("nnforce")

    def call(fn, p, tensors):
        return getattr(lib, fn)(ctypes.byref(p), *[
            None if t is None else t.data_ptr() for t in ins + tensors])

    def changed(**fields):
        other = NF.NnParams.from_buffer_copy(params)
        for k, v in fields.items():
            setattr(other, k, v)
        return other

    for fn, o in (("dsph_nnforce_p1_host", outs),
                  ("dsph_nnforce_fda_host", outs),
                  ("dsph_nnforce_p3_host", p3outs)):
        assert call(fn, params, o) == 0
        assert call(fn, changed(phtab=None), o) == 1
        assert call(fn, changed(nphases=0), o) == 1
        assert call(fn, changed(phtab=None, nphases=NF.TABLE_PHASES), o) == 0
