"""The neighbour-list mode (``SolverOpts.use_nbrlist``) against the JAX
package's Verlet-list mode on the CPU.

* Steps of tests/test_nbrlist.py's 2D dam break (symplectic with
  Fourtakas DDT and flow; Verlet with the cubic spline; mDBC walls with
  their pre-pass), of a 3D laminar+SPS dam break at ~250 particles and of
  the floating box, each up to 10 steps against jitted JAX
  ``make_step(use_nbrlist=True, use_pallas=False)`` from the same state:
  positions by particle id within 1e-4*dp, density within rtol 1e-5, dt
  within rtol 1e-4, overflow 0, and the port on the list's grid.  One
  JAX compile per configuration.
* DEM's contact acceleration and dt term over the list's rows against
  JAX ``apply_dem_nbr`` on a list built before the particles moved.
* The overflow count against ``NB.build(...).overflow`` on
  test_list_complete_vs_bruteforce's random cloud (n = 250), with a
  capacity that overflows and at ``auto_m``.
* The refusal of periodic and inout boundaries in JAX's words, and the NN
  step ignoring the option.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.features import dem as jDEM
from dualsphysics_multilayer_tpu.features.featureset import Features as jFeatures
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import forces as jF
from dualsphysics_multilayer_tpu.ops import nbrlist as jNB
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.features import dem as DEM
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import nbrlist as NB

from test_torch_couplings import PROPS, WALL, by_order, close, dem_scene, t32

torch.set_num_threads(2)

DAM2D = dict(dp=0.05, tank=(1.6, 1.0), column=(0.4, 0.6))
DAM3D = dict(dp=0.05, tank=(0.5, 0.15, 0.3), column=(0.2, 0.15, 0.2),
             obstacle=False)
BOX = dict(dp=0.04, tank=(0.8, 0.6), water=0.3, box=(0.16, 0.16),
           box_pos=(0.32, 0.2))
NSTEPS = 10
LAMSPS_VISCO = 1e-6


def _config(name, m):
    """(case kwargs and builder, csp transform, opts kwargs, flow) of a
    configuration in module ``m`` (the JAX package's or the port's
    typesdef)."""
    fourtakas = dict(tdensity=m.TpDensity.FOURTAKAS)
    if name == "symplectic":
        return "dambreak2d", DAM2D, None, fourtakas, 2.5
    if name == "verlet-cubic":
        return ("dambreak2d", dict(DAM2D, need_verlet=True), "cubic",
                dict(fourtakas, tstep=m.TpStep.VERLET), 5.0)
    if name == "mdbc":
        return ("dambreak2d", dict(DAM2D, mdbc=True), None,
                dict(fourtakas, tboundary=m.TpBoundary.MDBC), 2.5)
    if name == "lamsps3d":
        return ("dambreak3d", dict(DAM3D, visco=LAMSPS_VISCO, need_sps=True),
                "lamsps", dict(fourtakas, tvisco=m.TpVisco.LAMINAR_SPS), 2.5)
    return "floatingbox2d", BOX, None, dict(fourtakas, with_floating=True), 2.5


def _csp(case_csp, how, m, dp):
    if how == "cubic":
        return case_csp.replace(tkernel=m.TpKernel.CUBIC)
    if how == "lamsps":
        return m.make_ctesph(simulate2d=False, dp=dp,
                             hswl=DAM3D["column"][2], coefh=1.0,
                             visco=LAMSPS_VISCO, coefsound=20.0,
                             tvisco=m.TpVisco.LAMINAR_SPS)
    return case_csp


def flowing(case, speed):
    st = case.state
    arrays = {k: np.asarray(getattr(st, k))
              for k in ("pos", "vel", "rho", "code", "idp", "spstau",
                        "boundnormal", "velm1", "rhom1")
              if getattr(st, k) is not None}
    rng = np.random.default_rng(5)
    fluid = jtd.code_type(arrays["code"]) == jtd.TYPE_FLUID
    vel = np.array([speed, 0.0, 0.0]) + rng.normal(0.0, 0.3, arrays["pos"].shape)
    if case.csp.simulate2d:
        vel[:, 1] = 0.0
    arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    return arrays


def by_id(st, name):
    v = getattr(st, name)
    out = torch.empty_like(v)
    out[st.idp] = v
    return out.numpy()


@pytest.mark.parametrize("name", ["symplectic", "verlet-cubic", "mdbc",
                                  "lamsps3d", "floatingbox"])
def test_list_steps_match_jax(name):
    builder, kw, how, okw, speed = _config(name, jtd)
    jcase = getattr(jcases, builder)(**kw)
    jcsp = _csp(jcase.csp, how, jtd, kw["dp"])
    jopts = jF.SolverOpts(use_nbrlist=True, use_pallas=False, **okw)
    arrays = flowing(jcase, speed)
    jst = dataclasses.replace(jcase.state, vel=jnp.asarray(arrays["vel"]))
    jfeats = feats = None
    if name == "floatingbox":
        jfeats = jFeatures(floating=jcase.meta["ftcfg"])
        feats = P.Features(floating=convert.floatingcfg(jcase.meta["ftcfg"]))
        arrays["ft"] = {k: np.asarray(getattr(jcase.state.ft, k))
                        for k in ("center", "fvel", "fomega", "angles")}
    jstep = jax.jit(jW.make_step(jcsp, jopts, jcase.dom, jfeats))
    jcarry = jW.make_carry(jst, jcsp, jopts, jfeats, dom=jcase.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(jcsp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    opts = P.SolverOpts(use_nbrlist=True, **_config(name, td)[3])
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts,
                         dom, feats)
    step = P.make_step(csp, opts, dom, feats)
    for _ in range(NSTEPS):
        carry = step(carry)
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert carry.overflow == 0 and int(jcarry.overflow) == 0
    rcut = csp.kernelsize + opts.nbr_skin * csp.dp
    assert carry.dom == NB.list_domain(dom, csp, opts)
    assert carry.dom.scell == pytest.approx(rcut) and carry.dom.within == dom
    assert carry.nrebuild >= 2          # the skin ran out inside the run

    st = carry.st
    np.testing.assert_allclose(by_id(st, "pos"), np.asarray(jcarry.st.pos),
                               rtol=0, atol=1e-4 * csp.dp)
    np.testing.assert_allclose(by_id(st, "rho"), np.asarray(jcarry.st.rho),
                               rtol=1e-5)
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
    if name == "floatingbox":
        np.testing.assert_allclose(st.ft.center.numpy(),
                                   np.asarray(jcarry.st.ft.center), rtol=0,
                                   atol=1e-4 * csp.dp)
    if name == "lamsps3d":
        want = np.asarray(jcarry.st.spstau)
        np.testing.assert_allclose(by_id(st, "spstau"), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())


def test_dem_over_the_list_matches_jax():
    """DEM with its candidates from a list built before the particles
    moved (0.1 dp jitter): the contact acceleration and the dt term, a
    maximum over every candidate pair, equal JAX's ``apply_dem_nbr``.  The
    floor beyond x = 0.5 moves fast: outside the list's radius of the
    boxes but inside the neighbour cells of its grid, where it would
    raise the dt term of the 27-cell candidates."""
    jcsp, a, jcfg, jdom = dem_scene(False, seed=1)
    vel = a["vel"].copy()
    far = (jtd.code_type(a["code"]) == jtd.TYPE_FIXED) & (a["pos"][:, 0] > 0.5)
    vel[far, 2] = -50.0
    a = dict(a, vel=vel)
    jdem = jDEM.make_dem(jcsp, a["code"], jcfg, float_props=PROPS,
                         bound_props=WALL)
    jopts = jF.SolverOpts(use_nbrlist=True)
    rng = np.random.default_rng(4)
    pos1 = (a["pos"] + rng.normal(0, 0.1 * jcsp.dp, a["pos"].shape)
            ).astype(np.float32)
    nbr, _ = jNB.build(jdom, jcsp, jopts, jnp.asarray(a["pos"]),
                       jnp.asarray(a["code"]))
    dt = np.float32(2e-4)
    jace, jdt = jDEM.apply_dem_nbr(jdem, jcsp, nbr, jnp.asarray(pos1),
                                   jnp.asarray(a["vel"]),
                                   jnp.asarray(a["code"]), jnp.asarray(dt))

    csp = convert.ctesph(dataclasses.asdict(jcsp))
    opts = P.SolverOpts(use_nbrlist=True)
    ldom, spec = NB.layout(csp, opts, convert.domain(dataclasses.asdict(jdom)))
    code = torch.tensor(a["code"].astype(np.int32))
    cells, code = cd.divide_cells(ldom, t32(a["pos"]), code)
    o = cells.order
    ref, pos, vel = t32(a["pos"])[o], t32(pos1)[o], t32(a["vel"])[o]
    dem = convert.demcfg(jdem)
    args = (dem, csp, ldom, cells, pos, vel, code[o], o.clone(),
            torch.tensor(dt))
    ace, demdt, ovf = DEM.apply_dem(*args, ref=ref, rcut2=spec.rcut2)
    isft = jtd.code_type(a["code"]) == jtd.TYPE_FLOATING
    assert np.abs(np.asarray(jace)[isft]).max() > 1.0
    close(by_order(ace, o.numpy()), jace, 2e-3, "ace")
    assert abs(float(demdt) - float(jdt)) <= 1e-3 * float(jdt)
    assert int(ovf) == 0
    _, cell_dt, _ = DEM.apply_dem(*args)
    assert abs(float(cell_dt) - float(jdt)) > 1e-3 * float(jdt)


@pytest.mark.parametrize("nbr_m", [64, 0])
def test_overflow_count_matches_jax_build(nbr_m):
    """test_list_complete_vs_bruteforce's cloud: JAX's list overflow with
    a capacity of 64 (every target has more neighbours) and none at
    ``auto_m``."""
    jcsp = jtd.make_ctesph(simulate2d=False, dp=0.05, hswl=0.25)
    jopts = jF.SolverOpts(use_nbrlist=True, nbr_m=nbr_m)
    rng = np.random.default_rng(0)
    n = 250
    pos = rng.uniform(0, 0.4, (n, 3))
    code = np.full(n, jtd.code_make(jtd.TYPE_FLUID, 0), np.uint32)
    jdom = jcd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01,
                           jcsp.kernelsize, simulate2d=False, dp=jcsp.dp)
    nbr, _ = jNB.build(jdom, jcsp, jopts, jnp.asarray(pos, jnp.float32),
                       jnp.asarray(code))
    want = int(nbr.overflow)

    csp = convert.ctesph(dataclasses.asdict(jcsp))
    opts = P.SolverOpts(use_nbrlist=True, nbr_m=nbr_m)
    ldom, spec = NB.layout(csp, opts, convert.domain(dataclasses.asdict(jdom)))
    assert spec.m == (nbr_m or jNB.auto_m(jcsp, opts.nbr_skin))
    cells, _ = cd.divide_cells(ldom, torch.tensor(pos, dtype=torch.float32),
                               torch.tensor(code.astype(np.int32)))
    p = torch.tensor(pos, dtype=torch.float32)[cells.order]
    got = NB.overflow_count(ldom, cells, p, spec, max_pairs=1 << 14)
    assert int(got) == want
    assert (want > 1000) if nbr_m else (want == 0)


def test_periodic_and_inout_refused_in_jax_words():
    case = cases.dambreak2d(**DAM2D, device="cpu")
    jcase = jcases.dambreak2d(**DAM2D)
    for kind in ("periodic", "inout"):
        with pytest.raises(NotImplementedError) as jerr:
            jW.make_step(jcase.csp, jF.SolverOpts(use_nbrlist=True),
                         jcase.dom, jFeatures(**{kind: object()}))
        with pytest.raises(NotImplementedError) as err:
            P.make_step(case.csp, P.SolverOpts(use_nbrlist=True), case.dom,
                        P.Features(**{kind: object()}))
        assert str(err.value) == str(jerr.value)
        assert "nbrlist mode does not support periodic" in str(err.value)


def test_nn_step_ignores_the_option():
    """The NN step from a carry made under the option: it divides afresh
    on its own domain and then steps as without the option, by id."""
    case, phases = NM.wet_dambreak_nn(dp=0.05, device="cpu")
    arrays = flowing(case, 2.5)
    runs = {}
    for listed in (False, True):
        opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS, use_nbrlist=listed)
        carry = P.make_carry(convert.simstate(arrays, device="cpu"), case.csp,
                             opts, case.dom)
        assert (carry.dom == case.dom) != listed
        step = P.make_nn_step(case.csp, opts, case.dom, phases)
        for _ in range(3):
            carry = step(carry)
        assert carry.dom == case.dom and carry.overflow == 0
        runs[listed] = carry
    for k in ("pos", "rho"):
        np.testing.assert_allclose(by_id(runs[True].st, k),
                                   by_id(runs[False].st, k), rtol=1e-6,
                                   atol=1e-6 * case.csp.dp)
    assert float(runs[True].dt_pre) == pytest.approx(float(runs[False].dt_pre),
                                                     rel=1e-6)
