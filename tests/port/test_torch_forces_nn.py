"""The port's multiphase non-Newtonian interaction: the elementwise
functions and the plain torch version against the JAX package's
``forces_nn`` (bucket path), and the CPU twins of the three CUDA kernels'
bodies (g++) against the plain version.  The CUDA kernels themselves are
tested on the card by test_torch_cuda.py.

Tolerances: the elementwise functions within a few ulp (rtol 1e-6); the
interaction by the rule of tests/test_forces.py assert_close, rtol 2e-3
with an absolute floor of 2e-3 of the largest value; the twins at rtol
1e-4 with the same kind of floor.

Under mDBC walls the plain version and the twins meet the bucket path in
four configurations (Molteni and Fourtakas, SPH and FDA); only Molteni's
wall block tells the walls apart, which a mutant keeping it shows.

The JAX reference runs eagerly.  Under ``jax.jit`` XLA fuses the per-pair
FDA viscosity and rounds the ill-conditioned 1 - exp(-m*dm) of small
strain rates otherwise, which moves the FDA per-target eta max by up to
~1% between JAX's own jitted and eager results; eager JAX evaluates the
same f32 operations as the port.
"""

import dataclasses
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import nnewtonian as jNM
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import forces_nn as jNN
from dualsphysics_multilayer_tpu.ops.forces import SolverOpts as JOpts
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
from dualsphysics_multilayer_tpu_torch.ops.forces import SolverOpts

torch.set_num_threads(2)

# name: (tvisco, velgrad, tdensity)
CONFIGS = {
    "sph-morris": ("LAMINAR_SPS", "SPH", "FOURTAKAS"),
    "sph-conseq": ("CONST_EQ", "SPH", "FOURTAKAS"),
    "sph-artificial": ("ARTIFICIAL", "SPH", "FOURTAKAS"),
    "fda-morris": ("LAMINAR_SPS", "FDA", "FOURTAKAS"),
    "fda-conseq": ("CONST_EQ", "FDA", "FOURTAKAS"),
    "sph-morris-none": ("LAMINAR_SPS", "SPH", "NONE"),
    "sph-morris-molteni": ("LAMINAR_SPS", "SPH", "MOLTENI"),
    "sph-morris-full": ("LAMINAR_SPS", "SPH", "FOURTAKAS_FULL"),
}
ARRAYS = ("ace", "ar", "visco_eta", "tau")
SCALARS = ("viscdtmax", "viscetadtmax")


def opts_of(name):
    """(JAX SolverOpts, port SolverOpts) of a configuration."""
    tvisco, velgrad, tdensity = CONFIGS[name]
    return tuple(
        cls(tvisco=m.TpVisco[tvisco], velgrad=m.TpVelGrad[velgrad],
            tdensity=m.TpDensity[tdensity])
        for cls, m in ((JOpts, jtd), (SolverOpts, td)))


def perturbed(pos, code, rho0, seed, sim2d=True):
    """Seeded velocity jitter (0.5 m/s, none along y in 2D) on the fluid and
    a density jitter of 1% of each particle's phase rho0."""
    rng = np.random.default_rng(seed)
    n = len(pos)
    fluid = jtd.code_type(code) == jtd.TYPE_FLUID
    vel = np.where(fluid[:, None], rng.normal(0.0, 0.5, (n, 3)), 0.0)
    if sim2d:
        vel[:, 1] = 0.0
    rho = rho0 * (1.0 + np.where(fluid, rng.uniform(-0.01, 0.01, n), 0.0))
    return dict(pos=np.asarray(pos, np.float32), vel=vel.astype(np.float32),
                rho=rho.astype(np.float32), code=np.asarray(code, np.uint32))


@pytest.fixture(scope="module")
def wet():
    """wet_dambreak_nn(dp=0.05), 228 particles, in a perturbed state."""
    jcase, jph = jNM.wet_dambreak_nn(dp=0.05)
    st = jcase.state
    code = np.asarray(st.code)
    arrays = perturbed(st.pos, code, np.asarray(st.rho), seed=0)
    return dict(jcsp=jcase.csp, jdom=jcase.dom, jph=jph, arrays=arrays,
                csp=convert.ctesph(dataclasses.asdict(jcase.csp)),
                dom=convert.domain(dataclasses.asdict(jcase.dom)),
                ph=convert.phasecfg(jph))


def cloud3d(seed=3, n=240, dp=0.05):
    """3D jittered cloud over a boundary layer, fluid of phase 0 (x < 0.25)
    and phase 1 beside it, so same- and cross-phase pairs both occur."""
    rng = np.random.default_rng(seed)
    nb = n // 4
    pos = np.zeros((n, 3))
    pos[:, :2] = rng.uniform(0.0, 0.5, (n, 2))
    pos[:nb, 2] = rng.uniform(-dp, 0.0, nb)
    pos[nb:, 2] = rng.uniform(0.0, 0.25, n - nb)
    mk = (pos[:, 0] >= 0.25).astype(int)
    code = np.array([jtd.code_make(jtd.TYPE_FIXED, 0)] * nb
                    + [jtd.code_make(jtd.TYPE_FLUID, int(m)) for m in mk[nb:]],
                    np.uint32)
    rho0 = np.where(np.arange(n) < nb, 1000.0, np.where(mk == 1, 1500.0, 1000.0))
    return perturbed(pos, code, rho0, seed, sim2d=False)


@pytest.fixture(scope="module")
def cloud():
    _, jph = jNM.wet_dambreak_nn(dp=0.05)
    jcsp = jNM.make_nn_csp(simulate2d=False, dp=0.05, phases=jph, hswl=0.25)
    arrays = cloud3d()
    lo, hi = arrays["pos"].min(0) - 0.01, arrays["pos"].max(0) + 0.01
    jdom = jcd.make_domain(lo, hi, jcsp.kernelsize, cellcap=64)
    return dict(jcsp=jcsp, jdom=jdom, jph=jph, arrays=arrays,
                csp=convert.ctesph(dataclasses.asdict(jcsp)),
                dom=cd.make_domain(lo, hi, jcsp.kernelsize),
                ph=convert.phasecfg(jph))


def jax_forces(case, jopts):
    a = {k: jnp.asarray(v) for k, v in case["arrays"].items()}
    div, code = jcd.divide(case["jdom"], a["pos"], a["code"])
    assert int(div.overflow) == 0
    fr, eta, tau = jNN.interaction_forces_nn(
        case["jcsp"], jopts, case["jph"], case["jdom"], div, a["pos"],
        a["vel"], a["rho"], code)
    return dict(ace=np.asarray(fr.ace), ar=np.asarray(fr.ar),
                visco_eta=np.asarray(eta), tau=np.asarray(tau),
                viscdtmax=float(fr.viscdtmax),
                viscetadtmax=float(fr.viscetadtmax))


def sorted_inputs(case):
    """(cells, sorted state tensors, order) of a case's arrays, on the CPU."""
    a = case["arrays"]
    pos = torch.tensor(a["pos"])
    cells, code = cd.divide_cells(case["dom"], pos,
                                  torch.tensor(a["code"].astype(np.int32)))
    o = cells.order
    return cells, (pos[o], torch.tensor(a["vel"])[o], torch.tensor(a["rho"])[o],
                   code[o]), o.numpy()


def as_dict(r: NN.NnResult, order=None):
    out = dict(ace=r.forces.ace.numpy(), ar=r.forces.ar.numpy(),
               visco_eta=r.visco_eta.numpy(), tau=r.tau.numpy(),
               gradvel=r.gradvel.numpy(),
               viscdtmax=float(r.forces.viscdtmax),
               viscetadtmax=float(r.forces.viscetadtmax))
    if order is not None:
        for k in ARRAYS + ("gradvel",):
            canon = np.empty_like(out[k])
            canon[order] = out[k]
            out[k] = canon
    return out


def assert_close(want, got, rtol=2e-3, keys=ARRAYS):
    for k in keys:
        scale = np.abs(want[k]).max() + 1e-6
        np.testing.assert_allclose(got[k], want[k], atol=rtol * scale,
                                   rtol=rtol, err_msg=k)
    for k in SCALARS:
        assert np.isclose(got[k], want[k], rtol=rtol, atol=1e-6), \
            (k, got[k], want[k])


def test_elementwise_functions_match_jax():
    rng = np.random.default_rng(5)
    phases = (
        dict(mkfluid=0, rho0=1000.0, csound=30.0, visco=0.05, tau_yield=0.0005),
        dict(mkfluid=1, rho0=1500.0, csound=40.0, visco=0.1, tau_yield=0.02,
             hbp_m=10.0, hbp_n=0.7),
        dict(mkfluid=2, rho0=1200.0, csound=35.0, gamma=3.0, visco=0.3,
             tau_yield=0.05, tau_max=0.4, bi_multi=20.0, hbp_m=30.0,
             hbp_n=1.4))
    jph = jNN.PhaseCfg(phases=tuple(jNN.Phase(**p) for p in phases))
    ph = NN.PhaseCfg(phases=tuple(NN.Phase(**p) for p in phases))
    assert convert.phasecfg(jph) == ph
    jcsp = jNM.make_nn_csp(simulate2d=True, dp=0.02, phases=jph, hswl=0.3)
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    jtb, tb = jph.tables(jcsp), ph.tables(csp, "cpu")
    for k in jtb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jtb[k]), err_msg=k)

    n = 600
    idx = rng.integers(0, 3, n)
    ppx = rng.integers(0, 3, n)
    rho = (np.array([1000.0, 1500.0, 1200.0])[idx]
           * rng.uniform(0.97, 1.03, n)).astype(np.float32)
    # strain rates from rest through the bi-viscosity region to fast flow
    magn = np.concatenate([[0.0, 1e-20, 1e-18], 10.0 ** rng.uniform(-1.5, 2, n - 3)])
    magn = magn.astype(np.float32)
    gradvel = rng.normal(0.0, 3.0, (n, 6)).astype(np.float32)
    dvw = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    dr = rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    rr2 = (dr * dr).sum(1)
    j, t = (lambda x: jnp.asarray(x)), torch.tensor

    def same(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)

    same(NN.press_nn(tb, t(idx), t(rho)), jNN.press_nn(jtb, j(idx), j(rho)))
    D, m = NN.strain_rate(t(gradvel))
    jD, jm = jNN.strain_rate(j(gradvel))
    same(D, jD)
    same(m, jm)
    for p in (None, ppx):
        same(NN.eta_effective(tb, t(idx), t(magn), None if p is None else t(p)),
             jNN.eta_effective(jtb, j(idx), j(magn), None if p is None else j(p)))
    mp, S = NN.strain_magn_pair(t(dvw), t(dr), t(rr2))
    jmp, jS = jNN.strain_magn_pair(j(dvw), j(dr), j(rr2))
    same(mp, jmp)
    for a, b in zip(S, jS):
        same(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_matches_jax_wet_dambreak(wet, name):
    jopts, opts = opts_of(name)
    want = jax_forces(wet, jopts)
    cells, args, order = sorted_inputs(wet)
    fr, eta, tau = NN.interaction_forces_nn(wet["csp"], opts, wet["ph"],
                                            wet["dom"], cells, *args)
    got = as_dict(NN.NnResult(forces=fr, visco_eta=eta, tau=tau,
                              gradvel=torch.zeros_like(tau)), order)
    assert_close(want, got)
    assert got["viscdtmax"] > 0
    if name != "sph-artificial":
        assert got["viscetadtmax"] > 0
    assert not got["ace"][:, 1].any()                 # 2D


@pytest.mark.parametrize("name", ["sph-morris", "fda-conseq"])
def test_plain_matches_jax_3d_cloud(cloud, name):
    jopts, opts = opts_of(name)
    want = jax_forces(cloud, jopts)
    cells, args, order = sorted_inputs(cloud)
    got = as_dict(NN.interaction_forces_nn_plain(
        cloud["csp"], opts, cloud["ph"], cloud["dom"], cells, *args), order)
    assert_close(want, got)
    assert np.abs(got["ace"][:, 1]).max() > 0


@pytest.mark.parametrize("tkernel,shiftmode,name", [
    ("CUBIC", "NO_BOUND", "sph-morris"), ("WENDLAND", "NO_FIXED", "fda-conseq")])
def test_variant_matches_jax_3d_cloud(gxx, cloud, tkernel, shiftmode, name):
    """The cubic spline and shifting on the 3D cloud (the 2D cases are in
    test_torch_nn_variants.py; these run here, where the cloud's eager JAX
    operations are compiled already): plain and twin against the bucket
    path, rtol 4e-3 with the cubic spline, the shifting flags exact."""
    jopts, opts = opts_of(name)
    jopts = dataclasses.replace(jopts, shiftmode=jtd.TpShifting[shiftmode])
    opts = dataclasses.replace(opts, shiftmode=td.TpShifting[shiftmode])
    case = dict(cloud, jcsp=cloud["jcsp"].replace(tkernel=jtd.TpKernel[tkernel]),
                csp=cloud["csp"].replace(tkernel=td.TpKernel[tkernel]))
    a = {k: jnp.asarray(v) for k, v in case["arrays"].items()}
    div, code = jcd.divide(case["jdom"], a["pos"], a["code"])
    fr, eta, tau = jNN.interaction_forces_nn(
        case["jcsp"], jopts, case["jph"], case["jdom"], div, a["pos"],
        a["vel"], a["rho"], code)
    want = dict(ace=np.asarray(fr.ace), ar=np.asarray(fr.ar),
                visco_eta=np.asarray(eta), tau=np.asarray(tau),
                shift=np.asarray(fr.shiftposfs),
                blocked=np.asarray(fr.shift_blocked),
                viscdtmax=float(fr.viscdtmax),
                viscetadtmax=float(fr.viscetadtmax))
    assert want["blocked"].any() == (shiftmode == "NO_BOUND")
    cells, args, order = sorted_inputs(case)
    run = (case["csp"], opts, case["ph"], case["dom"], cells, *args)
    rtol = 4e-3 if tkernel == "CUBIC" else 2e-3
    for r in (NN.interaction_forces_nn_plain(*run),
              NF.interaction_forces_nn_host_twin(*run)):
        got = as_dict(r, order)
        for k, v in (("shift", r.forces.shiftposfs),
                     ("blocked", r.forces.shift_blocked)):
            got[k] = np.empty_like(v.numpy())
            got[k][order] = v.numpy()
        assert_close(want, got, rtol=rtol, keys=ARRAYS + ("shift",))
        np.testing.assert_array_equal(got["blocked"], want["blocked"])


def test_unsupported_configs_raise(wet):
    csp, ph = wet["csp"], wet["ph"]
    for kw, name in [
            (dict(with_floating=True), "with_floating"),
            (dict(symmetry=True), "symmetry=True on the NN step"),
            (dict(symmetry=True, tboundary=td.TpBoundary.MDBC), "symmetry"),
            (dict(tstep=td.TpStep.VERLET), "tstep=VERLET")]:
        with pytest.raises(NotImplementedError, match=name):
            NN.check_supported_nn(csp, SolverOpts(**kw), ph)
    # the cubic spline and shifting are in; what they come with may not be
    cubic = csp.replace(tkernel=td.TpKernel.CUBIC)
    with pytest.raises(NotImplementedError, match="with_floating"):
        NN.check_supported_nn(cubic, SolverOpts(
            shiftmode=td.TpShifting.NO_BOUND, with_floating=True), ph)
    for mode in td.TpShifting:
        NN.check_supported_nn(cubic, SolverOpts(shiftmode=mode), ph)
    # the neighbour-list mode passes: the NN step ignores it, as JAX's does
    NN.check_supported_nn(csp, SolverOpts(use_nbrlist=True), ph)
    # mDBC walls are in (test_mdbc_matches_jax_wet_dambreak)
    NN.check_supported_nn(csp, SolverOpts(tboundary=td.TpBoundary.MDBC), ph)
    # a phase table of any count is in (test_torch_nnphases_many.py); a
    # table of none is not, as JAX's make_nn_csp fails on one
    NN.check_supported_nn(csp, SolverOpts(), NN.PhaseCfg(phases=ph.phases * 5))
    with pytest.raises(ValueError, match="at least one phase"):
        NN.check_supported_nn(csp, SolverOpts(), NN.PhaseCfg(phases=()))


# name: (tvisco, velgrad, tdensity) under mDBC walls
MDBC_CONFIGS = {
    "sph-morris-molteni": ("LAMINAR_SPS", "SPH", "MOLTENI"),
    "sph-morris-fourtakas": ("LAMINAR_SPS", "SPH", "FOURTAKAS"),
    "fda-morris-molteni": ("LAMINAR_SPS", "FDA", "MOLTENI"),
    "fda-conseq-fourtakas": ("CONST_EQ", "FDA", "FOURTAKAS"),
}


@pytest.mark.parametrize("name", list(MDBC_CONFIGS))
def test_mdbc_matches_jax_wet_dambreak(gxx, wet, name):
    """NN under mDBC walls (no pre-pass on the NN step, as in JAX): the
    plain version and the g++ twins of kernels 4-6 against the bucket
    path, rtol 2e-3; under Molteni a mutant that keeps the DBC wall block
    (the same passes told DBC) fails that comparison."""
    tvisco, velgrad, tdensity = MDBC_CONFIGS[name]
    jopts, opts = (
        cls(tvisco=m.TpVisco[tvisco], velgrad=m.TpVelGrad[velgrad],
            tdensity=m.TpDensity[tdensity], tboundary=m.TpBoundary.MDBC)
        for cls, m in ((JOpts, jtd), (SolverOpts, td)))
    want = jax_forces(wet, jopts)
    cells, args, order = sorted_inputs(wet)
    run = (wet["csp"], opts, wet["ph"], wet["dom"], cells, *args)
    for impl in (NN.interaction_forces_nn_plain,
                 NF.interaction_forces_nn_host_twin):
        assert_close(want, as_dict(impl(*run), order))
    dbc = dataclasses.replace(opts, tboundary=td.TpBoundary.DBC)
    kept = as_dict(NN.interaction_forces_nn_plain(wet["csp"], dbc, *run[2:]),
                   order)
    if tdensity == "MOLTENI":
        with pytest.raises(AssertionError):
            assert_close(want, kept)
    else:
        assert_close(want, kept)        # Fourtakas knows no wall type


# ---------------------------------------------------------------------------
# CPU twins of the CUDA kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")


def with_rest_and_dead(case):
    """The case's sorted inputs with the fluid at x < 0.25 at rest (so the
    particles inside that region see strain rate 0) and one fluid slot
    turned inactive (OUT_RHOP) after the divide."""
    cells, (pos, vel, rho, code), order = sorted_inputs(case)
    vel = torch.where((pos[:, 0] < 0.25)[:, None], 0.0, vel)
    k = int(torch.nonzero(td.is_fluid(code) & (pos[:, 0] > 0.4))[0])
    code = code.clone()
    code[k] = td.code_set_special(int(code[k]), td.SPECIAL_OUT_RHOP)
    return cells, (pos, vel, rho, code), k


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("geom", ["wet", "cloud"])
def test_kernel_twins_match_plain(gxx, wet, cloud, name, geom):
    case = dict(wet=wet, cloud=cloud)[geom]
    _, opts = opts_of(name)
    cells, args, dead = with_rest_and_dead(case)
    run = dict(csp=case["csp"], opts=opts, phases=case["ph"], dom=case["dom"],
               cells=cells)
    launches = dict(NF.launches)
    got = as_dict(NF.interaction_forces_nn_host_twin(**run, pos=args[0],
                                                     vel=args[1], rho=args[2],
                                                     code=args[3]))
    assert NF.launches == launches          # the twins are no kernel launches
    want = as_dict(NN.interaction_forces_nn_plain(**run, pos=args[0],
                                                  vel=args[1], rho=args[2],
                                                  code=args[3]))
    assert_close(want, got, rtol=1e-4, keys=ARRAYS + ("gradvel",))
    for k in ARRAYS + ("gradvel",):
        assert np.isfinite(got[k]).all(), k
    # the inactive slot takes part in nothing
    assert not got["ace"][dead].any() and got["ar"][dead] == 0.0
    assert got["visco_eta"][dead] == 0.0
    if NN.uses_gradvel(opts) and geom == "wet":
        # at rest: strain rate 0 -> the low-rate branch, m*tau_y + visco
        pos = args[0].numpy()
        rest = (pos[:, 0] < 0.1) & td.is_fluid(args[3]).numpy()
        assert rest.any()
        assert not got["gradvel"][rest].any()
        ph = args[3][torch.from_numpy(rest)].numpy() & td.CODE_VALUE_MASK
        p = [case["ph"].phases[i] for i in ph]
        want_eta = np.array([np.float32(x.hbp_m) * np.float32(x.tau_yield)
                             + np.float32(x.visco) for x in p], np.float32)
        np.testing.assert_allclose(got["visco_eta"][rest], want_eta, rtol=1e-6)


def test_wrappers_reject_bad_inputs(wet):
    _, opts = opts_of("sph-morris")
    cells, (pos, vel, rho, code), _ = sorted_inputs(wet)
    run = (wet["csp"], opts, wet["ph"], wet["dom"], cells)
    with pytest.raises(ValueError, match="float32"):
        NF.interaction_forces_nn_host_twin(*run, pos.double(), vel, rho, code)
    with pytest.raises(ValueError, match="contiguous"):
        NF.interaction_forces_nn_host_twin(*run, pos, vel.t().contiguous().t(),
                                           rho, code)
    with pytest.raises(ValueError, match="cuda"):
        NF.interaction_forces_nn_cuda(*run, pos, vel, rho, code)
