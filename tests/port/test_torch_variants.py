"""The force-kernel variants: the cubic spline with its tensile correction,
laminar+SPS viscosity and the three shifting modes.

* Interaction: the plain torch version and the CPU twins of the CUDA
  kernels (g++) each against the naive O(N^2) oracle (tests/ref_naive.py)
  and the JAX bucket path, on 120-particle clouds (tests/test_forces.py
  make_cloud).  Tolerance: the rule of tests/test_forces.py assert_close,
  rtol 2e-3 with an absolute floor of 2e-3 of the largest value on ace, ar,
  the SPS velocity gradient and the shifting sums, rtol 1e-3 on viscdtmax;
  rtol 4e-3 wherever the cubic spline runs, the tolerance of JAX's own
  cubic test (tests/test_forces.py:90).  The shifting flags are exact.
* Elementwise: ``compute_sps_tau`` and ``apply_shifting`` against JAX on
  random f32 arrays (rtol 1e-6: the same f32 operations in the same order).

The steps of the variants: test_torch_variant_steps.py.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import eos as jeos
from dualsphysics_multilayer_tpu.ops import forces as jF
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

from ref_naive import naive_forces
from test_forces import make_cloud
from test_torch_forces import sorted_inputs

torch.set_num_threads(2)

FIELDS = ("ace", "ar", "gradvel", "shiftposfs")
SHIFTS = ["NO_BOUND", "NO_FIXED", "FULL"]


# ---------------------------------------------------------------------------
# interaction
# ---------------------------------------------------------------------------

def mixed_cloud(sim2d, seed):
    """make_cloud with every third boundary particle moving and every ninth
    fluid particle floating, so that the shifting modes block differently."""
    pos, vel, rho, code, nb = make_cloud(sim2d=sim2d, seed=seed)
    code = code.copy()
    code[:nb:3] = jtd.code_make(jtd.TYPE_MOVING, 1)
    code[nb::9] = jtd.code_make(jtd.TYPE_FLOATING, 2)
    return pos, vel, rho, code, nb


def variant(sim2d=False, tkernel="WENDLAND", tvisco="ARTIFICIAL",
            shiftmode="NONE", tdensity="FOURTAKAS", seed=3):
    """(port csp, JAX csp, port opts, JAX opts, cloud, spstau or None)."""
    ckw = dict(simulate2d=sim2d, dp=0.05, hswl=0.25,
               visco=1e-4 if tvisco == "LAMINAR_SPS" else 0.05,
               viscoboundfactor=0.5)
    csp = td.make_ctesph(tkernel=td.TpKernel[tkernel],
                         tvisco=td.TpVisco[tvisco], **ckw)
    jcsp = jtd.make_ctesph(tkernel=jtd.TpKernel[tkernel],
                           tvisco=jtd.TpVisco[tvisco], **ckw)
    okw = lambda m: dict(tvisco=m.TpVisco[tvisco], tdensity=m.TpDensity[tdensity],
                         shiftmode=m.TpShifting[shiftmode])
    opts, jopts = F.SolverOpts(**okw(td)), jF.SolverOpts(**okw(jtd))
    cloud = mixed_cloud(sim2d, seed)
    spstau = None
    if tvisco == "LAMINAR_SPS":
        pos, nb = cloud[0], cloud[4]
        rng = np.random.default_rng(seed + 100)
        spstau = rng.normal(0, 1e-3, (pos.shape[0], 6)).astype(np.float32)
        spstau[:nb] = 0.0
    return csp, jcsp, opts, jopts, cloud, spstau


def forces_dict(fr, order):
    """A port Forces as numpy in the cloud's own order."""
    out = dict(viscdtmax=float(fr.viscdtmax))
    for k, v in (("ace", fr.ace), ("ar", fr.ar), ("gradvel", fr.spsgradvel),
                 ("shiftposfs", fr.shiftposfs),
                 ("shift_blocked", fr.shift_blocked)):
        if v is not None:
            a = v.cpu().numpy()
            out[k] = np.empty_like(a)
            out[k][order] = a
    return out


def jax_dict(jfr):
    out = dict(ace=np.asarray(jfr.ace), ar=np.asarray(jfr.ar),
               viscdtmax=float(jfr.viscdtmax))
    for k, v in (("gradvel", jfr.spsgradvel), ("shiftposfs", jfr.shiftposfs),
                 ("shift_blocked", jfr.shift_blocked)):
        if v is not None:
            out[k] = np.asarray(v)
    return out


def references(jcsp, jopts, cloud, spstau):
    """(naive oracle, JAX bucket path) on the cloud."""
    pos, vel, rho, code, _ = cloud
    press = np.asarray(jeos.press_from_rho(jcsp, jnp.asarray(rho))).astype(np.float64)
    naive = naive_forces(jcsp, jopts, pos, vel, rho, press, code, spstau=spstau)
    # the oracle returns every accumulator; keep those of this configuration
    if spstau is None:
        del naive["gradvel"]
    if jopts.shiftmode == jtd.TpShifting.NONE:
        del naive["shiftposfs"], naive["shift_blocked"]
    jdom = jcd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01,
                           jcsp.kernelsize, simulate2d=jcsp.simulate2d,
                           cellcap=64)
    div, _ = jcd.divide(jdom, jnp.asarray(pos, jnp.float32), jnp.asarray(code))
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    jfr = jF.interaction_forces(
        jcsp, jopts, div, f32(pos), f32(vel), f32(rho), f32(press),
        jnp.asarray(code), spstau=None if spstau is None else f32(spstau))
    return naive, jax_dict(jfr)


def ports(csp, opts, cloud, spstau, twin):
    """(plain version, CPU twin or None) on the cloud."""
    pos, vel, rho, code, _ = cloud
    dom, cells, args, order = sorted_inputs(csp, pos, vel, rho, code)
    tau = None if spstau is None else torch.tensor(spstau)[cells.order]
    plain = forces_dict(F.interaction_forces(csp, opts, dom, cells, *args,
                                             spstau=tau), order)
    got_twin = None
    if twin:
        launches = dict(CF.launches)
        got_twin = forces_dict(CF.interaction_forces_host_twin(
            csp, opts, dom, cells, *args, spstau=tau), order)
        assert CF.launches == launches      # the twin is no kernel launch
    return plain, got_twin


def assert_close(want, got, rtol):
    for k in FIELDS:
        if k not in want:
            continue
        assert k in got, k
        scale = np.abs(want[k]).max() + 1e-9
        np.testing.assert_allclose(got[k], want[k], atol=rtol * scale,
                                   rtol=rtol, err_msg=k)
    assert np.isclose(got["viscdtmax"], want["viscdtmax"], rtol=1e-3, atol=1e-5)
    if "shift_blocked" in want:
        np.testing.assert_array_equal(got["shift_blocked"], want["shift_blocked"])


def check_variant(rtol=2e-3, **kw):
    csp, jcsp, opts, jopts, cloud, spstau = variant(**kw)
    naive, jax_out = references(jcsp, jopts, cloud, spstau)
    twin = shutil.which("g++") is not None
    plain, got_twin = ports(csp, opts, cloud, spstau, twin)
    for got in (plain, got_twin) if twin else (plain,):
        assert_close(naive, got, rtol)
        assert_close(jax_out, got, rtol)
    return plain, cloud


def test_cubic_matches():
    got, _ = check_variant(rtol=4e-3, tkernel="CUBIC", seed=2)
    assert "gradvel" not in got and "shiftposfs" not in got


@pytest.mark.parametrize("sim2d", [False, True])
def test_laminar_sps_matches(sim2d):
    got, _ = check_variant(sim2d=sim2d, tvisco="LAMINAR_SPS")
    assert np.abs(got["gradvel"]).max() > 0


@pytest.mark.parametrize("shiftmode", SHIFTS)
def test_shifting_matches(shiftmode):
    got, cloud = check_variant(shiftmode=shiftmode, seed=4)
    blocked = got["shift_blocked"]
    floating = jtd.code_type(cloud[3]) == jtd.TYPE_FLOATING
    # floating targets are always blocked; FULL blocks nothing else
    assert blocked[floating].all()
    assert (blocked.sum() == floating.sum()) == (shiftmode == "FULL")


def test_laminar_sps_cubic_shifting_matches():
    check_variant(rtol=4e-3, tkernel="CUBIC", tvisco="LAMINAR_SPS",
                  shiftmode="NO_FIXED", tdensity="MOLTENI", seed=6)


@pytest.mark.parametrize("kw,name", [
    (dict(tvisco="LAMINAR_SPS"), "tvisco=LAMINAR_SPS"),
    (dict(tkernel="CUBIC"), "CUBIC"),
] + [(dict(shiftmode=m), f"shiftmode={m}") for m in SHIFTS])
def test_variant_configs_supported(kw, name):
    """The settings this slice covers pass the single-phase check, and the
    multiphase non-Newtonian one (which takes the cubic spline and every
    shifting mode as well, and laminar viscosity as Morris's)."""
    csp, _, opts, _, _, _ = variant(**kw)
    F.check_supported(csp, opts)
    _, phases = NM.wet_dambreak_nn(dp=0.1, device="cpu")
    NN.check_supported_nn(csp, opts, phases)
    assert name.split("=")[-1] in (csp.tkernel.name, opts.tvisco.name,
                                   opts.shiftmode.name)


def test_laminar_sps_needs_spstau():
    csp, _, opts, _, cloud, _ = variant(tvisco="LAMINAR_SPS")
    pos, vel, rho, code, _ = cloud
    dom, cells, args, _ = sorted_inputs(csp, pos, vel, rho, code)
    with pytest.raises(ValueError, match="spstau"):
        F.interaction_forces(csp, opts, dom, cells, *args)
    with pytest.raises(ValueError, match="spstau"):
        CF.interaction_forces_host_twin(csp, opts, dom, cells, *args,
                                        spstau=torch.zeros(pos.shape[0], 5))


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

def random_fields(seed, n=300):
    rng = np.random.default_rng(seed)
    codes = [jtd.code_make(t, 0, s) for t in range(4) for s in (0, 0, 1)]
    return dict(
        gradvel=rng.normal(0, 5.0, (n, 6)).astype(np.float32),
        rho=rng.uniform(950, 1050, n).astype(np.float32),
        vel=rng.normal(0, 1.0, (n, 3)).astype(np.float32),
        shift=rng.normal(0, 50.0, (n, 4)).astype(np.float32),
        blocked=rng.random(n) < 0.2,
        code=rng.choice(np.array(codes, np.uint32), n))


def test_compute_sps_tau_matches():
    f = random_fields(0)
    kw = dict(simulate2d=False, dp=0.01, hswl=0.3, tvisco=td.TpVisco.LAMINAR_SPS)
    csp = td.make_ctesph(**kw)
    jcsp = jtd.make_ctesph(**dict(kw, tvisco=jtd.TpVisco.LAMINAR_SPS))
    want = np.asarray(jF.compute_sps_tau(jcsp, jnp.asarray(f["rho"]),
                                         jnp.asarray(f["gradvel"])))
    got = F.compute_sps_tau(csp, torch.tensor(f["rho"]),
                            torch.tensor(f["gradvel"])).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("sim2d,shifttfs", [(False, 0.0), (True, 1.5)])
def test_apply_shifting_matches(sim2d, shifttfs):
    f = random_fields(1)
    kw = dict(simulate2d=sim2d, dp=0.01, hswl=0.3, shifttfs=shifttfs)
    csp, jcsp = td.make_ctesph(**kw), jtd.make_ctesph(**kw)
    dt = np.float32(2e-4)
    want = np.asarray(jF.apply_shifting(
        jcsp, jF.SolverOpts(), jnp.float32(dt), jnp.asarray(f["vel"]),
        jnp.asarray(f["code"]), jnp.asarray(f["shift"]),
        jnp.asarray(f["blocked"])))
    got = F.apply_shifting(
        csp, F.SolverOpts(), torch.tensor(dt), torch.tensor(f["vel"]),
        torch.tensor(f["code"].astype(np.int32)), torch.tensor(f["shift"]),
        torch.tensor(f["blocked"])).numpy()
    # some displacements clip at 0.1*dp, some are blocked or not fluid
    assert (np.abs(want) == np.float32(0.1 * csp.dp)).any() and (want == 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
