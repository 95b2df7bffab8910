"""The lateral symmetry plane y = 0 (``SolverOpts.symmetry``, the
``Symmetry`` parameter) against the JAX package.

* The interaction on a seeded 3D cloud in y in [0, 3h], fluid over a wall
  layer: the port's plain version (its mirror pass) and the g++ twins of
  the SYM instances of kernels 1 and 2 against JAX's bucket
  ``interaction_forces(symmetry=True)``, Wendland and cubic, with and
  without shifting, Fourtakas diffusion, by the rule of
  tests/test_forces.py assert_close (rtol 2e-3, a floor of 2e-3 of the
  largest value); the shifting flags exact.  The interaction without the
  plane, and a mutant of the plain version without the target's own
  image, fail that comparison.
* An inline ``Symmetry=1`` case through both loaders (equal loads), then 3
  symplectic steps of it against jitted JAX ``make_step(use_pallas=
  False)``: positions within 1e-4*dp by id, density within rtol 1e-5.
* The loader's three ValueErrors (2D, floating bodies, laminar+SPS), with
  JAX's wording.
* The library runs the two combinations the loaders refuse, as the JAX
  bucket path does: the interaction with laminar+SPS viscosity (a seeded
  SPS stress), with floating bodies (a body straddling the plane, half the
  fluid's particle mass) and with both, Wendland and cubic, with and
  without shifting, plain and g++ twin (the SYM instances of kernel 3 and
  the FT x SYM ones of kernels 1-3) against JAX at rtol 2e-3, the SPS
  velocity gradient included; mutants of the mirror pass that reflect the
  image's stress or weigh a floating image as fluid fail that comparison;
  and 3 steps of the half case with each, loaded without ``Symmetry`` and
  given ``symmetry=True``, against jitted JAX ``make_step`` by id within
  1e-4*dp.

The CUDA instances are held against the plain version on the card
(chip_smoke.py phase 26).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.io import xmlcase as jX
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import eos as jeos
from dualsphysics_multilayer_tpu.ops import forces as jF
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.io import xmlcase as X
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

from test_torch_xmlcase import assert_loads_equal, xml

torch.set_num_threads(2)

DP = 0.05
# (tkernel, shiftmode) of the interaction cases, Fourtakas diffusion
VARIANTS = [("WENDLAND", "NONE"), ("CUBIC", "NONE"),
            ("WENDLAND", "NO_BOUND"), ("CUBIC", "FULL")]


def sym_cloud(csp, seed=7, n=150):
    """Fluid over a wall layer (z in [-dp, 0]), x in [0, 0.4], y in
    [0, 3h], seeded velocities (y included) and densities."""
    rng = np.random.default_rng(seed)
    nb = n // 4
    pos = np.zeros((n, 3))
    pos[:, 0] = rng.uniform(0.0, 0.4, n)
    pos[:, 1] = rng.uniform(0.0, 3 * csp.kernelh, n)
    pos[:nb, 2] = rng.uniform(-DP, 0.0, nb)
    pos[nb:, 2] = rng.uniform(0.0, 0.2, n - nb)
    vel = rng.normal(0.0, 0.5, (n, 3))
    vel[:nb] = 0.0
    rho = rng.uniform(980.0, 1050.0, n)
    code = np.array([td.code_make(td.TYPE_FIXED, 0)] * nb
                    + [td.code_make(td.TYPE_FLUID, 0)] * (n - nb), np.uint32)
    return pos, vel, rho, code


@pytest.fixture(scope="module")
def cloud():
    kw = dict(simulate2d=False, dp=DP, hswl=0.2, visco=0.05)
    csp, jcsp = td.make_ctesph(**kw), jtd.make_ctesph(**kw)
    pos, vel, rho, code = sym_cloud(csp)
    # the self image of the targets nearest the plane is in support
    assert (2 * pos[:, 1] < csp.kernelsize).sum() > 20
    lo, hi = pos.min(0) - 0.01, pos.max(0) + 0.01
    dom = cd.make_domain(lo, hi, csp.kernelsize)
    t = dict(dtype=torch.float32)
    cells, code_t = cd.divide_cells(dom, torch.tensor(pos, **t),
                                    torch.tensor(code.astype(np.int32)))
    o = cells.order
    args = (torch.tensor(pos, **t)[o], torch.tensor(vel, **t)[o],
            torch.tensor(rho, **t)[o], code_t[o])
    jdom = jcd.make_domain(lo, hi, jcsp.kernelsize, cellcap=32)
    jarr = [jnp.asarray(a, jnp.float32) for a in (pos, vel, rho)]
    div, _ = jcd.divide(jdom, jarr[0], jnp.asarray(code))
    assert int(div.overflow) == 0
    return dict(csp=csp, jcsp=jcsp, dom=dom, cells=cells, args=args,
                order=o.numpy(), jdiv=div, jarr=jarr, jcode=jnp.asarray(code))


def variant(cloud, tkernel, shiftmode):
    csp = cloud["csp"].replace(tkernel=td.TpKernel[tkernel])
    jcsp = cloud["jcsp"].replace(tkernel=jtd.TpKernel[tkernel])
    opts = F.SolverOpts(tdensity=td.TpDensity.FOURTAKAS, symmetry=True,
                        shiftmode=td.TpShifting[shiftmode])
    jopts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, symmetry=True,
                          shiftmode=jtd.TpShifting[shiftmode],
                          use_pallas=False)
    return csp, jcsp, opts, jopts


def jax_forces(cloud, jcsp, jopts, code=None, spstau=None, ftomassp=None):
    pos, vel, rho = cloud["jarr"]
    f32 = lambda x: None if x is None else jnp.asarray(x, jnp.float32)
    fr = jF.interaction_forces(
        jcsp, jopts, cloud["jdiv"], pos, vel, rho,
        jeos.press_from_rho(jcsp, rho),
        cloud["jcode"] if code is None else jnp.asarray(code),
        spstau=f32(spstau), ftomassp=f32(ftomassp))
    out = dict(ace=np.asarray(fr.ace), ar=np.asarray(fr.ar),
               viscdtmax=float(fr.viscdtmax))
    if fr.shiftposfs is not None:
        out.update(shift=np.asarray(fr.shiftposfs),
                   blocked=np.asarray(fr.shift_blocked))
    if fr.spsgradvel is not None:
        out["gradvel"] = np.asarray(fr.spsgradvel)
    return out


def as_dict(fr, order):
    out = dict(viscdtmax=float(fr.viscdtmax))
    for k, v in (("ace", fr.ace), ("ar", fr.ar), ("shift", fr.shiftposfs),
                 ("blocked", fr.shift_blocked), ("gradvel", fr.spsgradvel)):
        if v is not None:
            out[k] = np.empty_like(v.numpy())
            out[k][order] = v.numpy()
    return out


def assert_close(want, got, rtol=2e-3):
    for k in ("ace", "ar", "shift", "gradvel"):
        if k in want:
            scale = np.abs(want[k]).max() + 1e-6
            np.testing.assert_allclose(got[k], want[k], atol=rtol * scale,
                                       rtol=rtol, err_msg=k)
    if "blocked" in want:
        np.testing.assert_array_equal(got["blocked"], want["blocked"])
    assert np.isclose(got["viscdtmax"], want["viscdtmax"], rtol=1e-3,
                      atol=1e-5)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")


@pytest.mark.parametrize("tkernel,shiftmode", VARIANTS)
def test_interaction_matches_jax(gxx, cloud, tkernel, shiftmode):
    csp, jcsp, opts, jopts = variant(cloud, tkernel, shiftmode)
    want = jax_forces(cloud, jcsp, jopts)
    run = (csp, opts, cloud["dom"], cloud["cells"], *cloud["args"])
    launches = dict(CF.launches)
    for fr in (F.interaction_forces_plain(*run),
               CF.interaction_forces_host_twin(*run)):
        assert_close(want, as_dict(fr, cloud["order"]))
    assert CF.launches == launches          # the twins are no launches


def test_dropping_the_plane_or_the_self_image_fails(cloud, monkeypatch):
    """Without the plane the sums differ beyond the tolerance, and so do
    they with a mutant mirror pass that has the normal pass's j != t
    exclusion."""
    csp, jcsp, opts, jopts = variant(cloud, "WENDLAND", "NONE")
    want = jax_forces(cloud, jcsp, jopts)
    flat = as_dict(F.interaction_forces_plain(
        csp, dataclasses.replace(opts, symmetry=False), cloud["dom"],
        cloud["cells"], *cloud["args"]), cloud["order"])
    with pytest.raises(AssertionError):
        assert_close(want, flat)
    mirrored = F._mirrored

    def no_self(csp, p, pos, vel, t, j, live_pair):
        return mirrored(csp, p, pos, vel, t, j,
                        live_pair & (j != t[:, None]))

    monkeypatch.setattr(F, "_mirrored", no_self)
    got = as_dict(F.interaction_forces_plain(
        csp, opts, cloud["dom"], cloud["cells"], *cloud["args"]),
        cloud["order"])
    with pytest.raises(AssertionError):
        assert_close(want, got)


# half of a 3D dam break cut at its mid-plane, which lies at y = 0: no
# front wall there, the fluid column from the plane on
SYM_XML = dict(cmds="""
    <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right|back</boxfill>
     <point x="0" y="0" z="0"/><size x="0.32" y="0.16" z="0.2"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.04" y="0" z="0.04"/><size x="0.12" y="0.12" z="0.12"/></drawbox>
    """, dp=0.04, lo=(-0.1, 0, -0.1), hi=(0.4, 0.2, 0.3), hswl=0.12)
SYM_PARAMS = """
   <parameter key="Symmetry" value="1"/><parameter key="DensityDT" value="2"/>
   <parameter key="StepAlgorithm" value="2"/><parameter key="Visco" value="0.05"/>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>"""


def by_id(st, name):
    v = getattr(st, name)
    out = torch.empty_like(v)
    out[st.idp] = v
    return out.numpy()


def test_symmetry_case_loads_and_steps_as_jax(tmp_path):
    path = tmp_path / "Half_Def.xml"
    path.write_text(xml(**SYM_XML, params=SYM_PARAMS))
    jres, pres = jX.load_case(str(path)), X.load_case(str(path), device="cpu")
    assert_loads_equal(jres, pres)
    (jcase, jopts, _), (case, opts, _) = jres, pres
    assert opts.symmetry and jopts.symmetry
    # a flow towards the plane and along x
    st = case.state
    fluid = td.is_fluid(st.code)
    vel = torch.where(fluid[:, None], torch.tensor([1.0, -0.5, 0.0]), st.vel)
    jst = dataclasses.replace(jcase.state, vel=jnp.asarray(vel.numpy()))
    # JAX's bucket work is its active-cell rows times cellcap^2: rows for
    # 4x the cells the case occupies (the loader's rule without its floor
    # of 1024; an overflow would show)
    pos = jcase.state.pos
    cxyz = np.floor((np.asarray(pos) - np.asarray(jcase.dom.posmin))
                    / jcase.dom.scell).astype(np.int64)
    occupied = len(np.unique(cxyz, axis=0))
    jdom = dataclasses.replace(jcase.dom, maxcells=4 * occupied)
    jstep = jax.jit(jW.make_step(jcase.csp, dataclasses.replace(
        jopts, use_pallas=False), jdom))
    jcarry = jW.make_carry(jst, jcase.csp, jopts, dom=jdom)
    carry = P.make_carry(dataclasses.replace(st, vel=vel), case.csp, opts,
                         case.dom)
    step = P.make_step(case.csp, opts, case.dom)
    for _ in range(3):
        jcarry, carry = jstep(jcarry), step(carry)
    assert int(jcarry.overflow) == 0 and carry.nstep == 3
    np.testing.assert_allclose(by_id(carry.st, "pos"), np.asarray(jcarry.st.pos),
                               rtol=0, atol=1e-4 * case.csp.dp)
    np.testing.assert_allclose(by_id(carry.st, "rho"), np.asarray(jcarry.st.rho),
                               rtol=1e-5)


# what the reference refuses with symmetry: (xml() arguments, message)
RESTRICTIONS = {
    "2d": (dict(cmds="""<setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0" y="0" z="0"/><size x="0.2" y="0" z="0.2"/></drawbox>""",
                params=SYM_PARAMS), "not allowed with 2-D"),
    "floating": (dict(**SYM_XML, params=SYM_PARAMS,
                      casedef='<floatings><floating mkbound="0"/></floatings>'),
                 "not allowed with floating"),
    "lamsps": (dict(**SYM_XML, params=SYM_PARAMS.replace(
        '"Visco" value="0.05"/>',
        '"Visco" value="0.05"/><parameter key="ViscoTreatment" value="2"/>')),
        "only allowed with artificial"),
}


@pytest.mark.parametrize("what", list(RESTRICTIONS))
def test_symmetry_restrictions_raise_as_jax(tmp_path, what):
    kw, message = RESTRICTIONS[what]
    path = tmp_path / f"{what}_Def.xml"
    path.write_text(xml(**kw))
    for load in (jX.load_case, lambda p: X.load_case(p, device="cpu")):
        with pytest.raises(ValueError, match=message):
            load(str(path))


# ---------------------------------------------------------------------------
# the library's combinations: laminar+SPS and floating bodies with the plane
# ---------------------------------------------------------------------------

# (what, tkernel, shiftmode): "lamsps" laminar+SPS viscosity, "floating" a
# floating body with artificial viscosity, "both" the two together
DRESSED = [("lamsps", "WENDLAND", "NONE"), ("lamsps", "CUBIC", "NONE"),
           ("lamsps", "WENDLAND", "NO_FIXED"), ("lamsps", "CUBIC", "FULL"),
           ("floating", "WENDLAND", "NONE"), ("floating", "CUBIC", "NONE"),
           ("floating", "WENDLAND", "NO_BOUND"), ("floating", "CUBIC", "FULL"),
           ("both", "WENDLAND", "NO_FIXED"), ("both", "CUBIC", "NONE")]
LAMSPS_VISCO = 1e-3


def dressed(cloud, what, tkernel, shiftmode):
    """The cloud's configuration with laminar+SPS viscosity (a seeded SPS
    stress on the fluid, zero elsewhere, as the steps keep it) and/or a
    floating body: the fluid in x in (0.15, 0.25), z in (0.05, 0.15), which
    spans the cloud's y, so its particles' images are in support of the
    targets near the plane; the body's particle mass is half the fluid's.
    Returns (csp, jcsp, opts, jopts, kw): ``kw`` the arrays (``code``,
    ``spstau``, ``ftomassp``) in the cloud's input order."""
    lam, flt = what in ("lamsps", "both"), what in ("floating", "both")
    csp, jcsp, opts, jopts = variant(cloud, tkernel, shiftmode)
    pos = cloud["jarr"][0]
    code = np.asarray(cloud["jcode"]).copy()
    fluid = jtd.code_type(code) == jtd.TYPE_FLUID
    kw = dict(code=code, spstau=None, ftomassp=None)
    if flt:
        x, z = np.asarray(pos[:, 0]), np.asarray(pos[:, 2])
        body = fluid & (x > 0.15) & (x < 0.25) & (z > 0.05) & (z < 0.15)
        assert body.sum() >= 10
        code[body] = jtd.code_make(jtd.TYPE_FLOATING, 0)
        fluid = fluid & ~body
        kw["ftomassp"] = np.array([0.5 * csp.massfluid], np.float32)
    if lam:
        rng = np.random.default_rng(12)
        kw["spstau"] = np.where(fluid[:, None],
                                rng.normal(0.0, 0.02, (len(code), 6)),
                                0.0).astype(np.float32)
        sps = td.make_ctesph(simulate2d=False, dp=DP, hswl=0.2,
                             tvisco=td.TpVisco.LAMINAR_SPS)
        sub = dict(visco=LAMSPS_VISCO, spssmag=sps.spssmag,
                   spsblin=sps.spsblin)
        csp, jcsp = csp.replace(**sub), jcsp.replace(**sub)
    for m, o in ((td, opts), (jtd, jopts)):
        upd = dict(with_floating=flt)
        if lam:
            upd["tvisco"] = m.TpVisco.LAMINAR_SPS
        if m is td:
            opts = dataclasses.replace(o, **upd)
        else:
            jopts = dataclasses.replace(o, **upd)
    return csp, jcsp, opts, jopts, kw


def port_run(cloud, csp, opts, kw):
    """interaction_forces_plain's arguments on the cloud with ``kw``'s
    arrays, in the divide's order."""
    o = cloud["cells"].order
    code = torch.tensor(kw["code"].astype(np.int32))[o]
    extra = {}
    if kw["spstau"] is not None:
        extra["spstau"] = torch.tensor(kw["spstau"])[o].contiguous()
    if kw["ftomassp"] is not None:
        extra["ftomassp"] = torch.tensor(kw["ftomassp"])
    return (csp, opts, cloud["dom"], cloud["cells"], *cloud["args"][:3],
            code), extra


@pytest.mark.parametrize("what,tkernel,shiftmode", DRESSED)
def test_dressed_interaction_matches_jax(gxx, cloud, what, tkernel,
                                         shiftmode):
    csp, jcsp, opts, jopts, kw = dressed(cloud, what, tkernel, shiftmode)
    want = jax_forces(cloud, jcsp, jopts, **kw)
    run, extra = port_run(cloud, csp, opts, kw)
    launches = dict(CF.launches)
    assert CF.counter_name(csp, opts).endswith("_sym")
    for fr in (F.interaction_forces_plain(*run, **extra),
               CF.interaction_forces_host_twin(*run, **extra)):
        assert_close(want, as_dict(fr, cloud["order"]))
    assert CF.launches == launches          # the twins are no launches


@pytest.mark.parametrize("mutant", ["reflected_stress", "fluid_mass"])
def test_mirror_mutants_fail(cloud, monkeypatch, mutant):
    """A mirror pass that reflects the image's SPS stress in the plane
    (xy and yz change sign), or weighs a floating image with the fluid's
    mass, misses JAX's sums: the image keeps its candidate's stress and
    mass, as JAX's pair inputs do."""
    what = "lamsps" if mutant == "reflected_stress" else "floating"
    csp, jcsp, opts, jopts, kw = dressed(cloud, what, "WENDLAND", "NONE")
    want = jax_forces(cloud, jcsp, jopts, **kw)
    run, extra = port_run(cloud, csp, opts, kw)
    assert_close(want, as_dict(F.interaction_forces_plain(*run, **extra),
                               cloud["order"]))
    mirrored = F._mirrored

    def mutated(csp, p, pos, vel, t, j, live_pair):
        m = mirrored(csp, p, pos, vel, t, j, live_pair)
        if mutant == "reflected_stress":
            flip = torch.tensor([1.0, -1.0, 1.0, 1.0, -1.0, 1.0])
            return dataclasses.replace(m, tau_c=m.tau_c * flip)
        return dataclasses.replace(m, mass2=torch.where(
            m.ft_c, csp.massfluid, m.mass2))

    monkeypatch.setattr(F, "_mirrored", mutated)
    got = as_dict(F.interaction_forces_plain(*run, **extra), cloud["order"])
    with pytest.raises(AssertionError):
        assert_close(want, got)


# the half case with a floating box from the plane on (its other half is
# the image), inside the fluid column
SYM_FLOAT_XML = dict(SYM_XML, cmds=SYM_XML["cmds"] + """
    <setmkbound mk="1"/><drawbox><boxfill>solid</boxfill>
     <point x="0.08" y="0" z="0.08"/><size x="0.08" y="0.04" z="0.08"/></drawbox>
    """)
FLOAT_CASEDEF = ('<floatings><floating mkbound="1"><rhopbody value="800"/>'
                 '</floating></floatings>')
NO_SYM_PARAMS = SYM_PARAMS.replace(
    '<parameter key="Symmetry" value="1"/>',
    '<parameter key="RigidAlgorithm" value="1"/>')


def lamsps_constants(csp):
    """``csp`` with a laminar viscosity and the Smagorinsky and Blin
    constants of a laminar+SPS case (the loaders refuse the plane with
    it, so the case is loaded with artificial viscosity)."""
    sps = td.make_ctesph(simulate2d=False, dp=csp.dp, hswl=0.12,
                         tvisco=td.TpVisco.LAMINAR_SPS)
    return csp.replace(visco=LAMSPS_VISCO, spssmag=sps.spssmag,
                       spsblin=sps.spsblin)


@pytest.mark.parametrize("what", ["lamsps", "floating"])
def test_dressed_steps_match_jax(tmp_path, what):
    """3 symplectic steps of the half case with the plane and laminar+SPS
    viscosity (the SPS stress from rest, zero) or with a floating box on
    the plane, both loaded without ``Symmetry`` and run with
    ``symmetry=True``, against jitted JAX: positions by id within
    1e-4*dp, density within rtol 1e-5, and the body's centre within
    1e-4*dp."""
    flt = what == "floating"
    path = tmp_path / f"{what}_Def.xml"
    path.write_text(xml(**(SYM_FLOAT_XML if flt else SYM_XML),
                        params=NO_SYM_PARAMS if flt else SYM_PARAMS,
                        casedef=FLOAT_CASEDEF if flt else ""))
    jres, pres = jX.load_case(str(path)), X.load_case(str(path), device="cpu")
    assert_loads_equal(jres, pres)
    (jcase, jopts, _), (case, opts, _) = jres, pres
    jfeats, feats = jcase.meta["features"], case.meta["features"]
    jcsp, csp = jcase.csp, case.csp
    st = case.state
    fluid = td.is_fluid(st.code)
    vel = torch.where(fluid[:, None], torch.tensor([1.0, -0.5, 0.0]), st.vel)
    st = dataclasses.replace(st, vel=vel)
    jst = dataclasses.replace(jcase.state, vel=jnp.asarray(vel.numpy()))
    if flt:
        assert opts.with_floating and jopts.with_floating
        assert not opts.symmetry and feats.floating is not None
        body = st.pos[td.code_type(st.code) == td.TYPE_FLOATING]
        assert float(body[:, 1].min()) == 0.0
    else:
        jcsp, csp = lamsps_constants(jcsp), lamsps_constants(csp)
        st = dataclasses.replace(st, spstau=torch.zeros((st.n, 6)))
        jst = dataclasses.replace(jst, spstau=jnp.zeros((st.n, 6),
                                                        jnp.float32))
    sym = dict(symmetry=True)
    if not flt:
        opts = dataclasses.replace(opts, tvisco=td.TpVisco.LAMINAR_SPS, **sym)
        jopts = dataclasses.replace(jopts, tvisco=jtd.TpVisco.LAMINAR_SPS,
                                    **sym)
    else:
        opts = dataclasses.replace(opts, **sym)
        jopts = dataclasses.replace(jopts, **sym)
    pos = jcase.state.pos
    cxyz = np.floor((np.asarray(pos) - np.asarray(jcase.dom.posmin))
                    / jcase.dom.scell).astype(np.int64)
    jdom = dataclasses.replace(jcase.dom,
                               maxcells=4 * len(np.unique(cxyz, axis=0)))
    jopts = dataclasses.replace(jopts, use_pallas=False)
    jstep = jax.jit(jW.make_step(jcsp, jopts, jdom, jfeats))
    jcarry = jW.make_carry(jst, jcsp, jopts, jfeats, dom=jdom)
    carry = P.make_carry(st, csp, opts, case.dom, feats)
    step = P.make_step(csp, opts, case.dom, feats)
    for _ in range(3):
        jcarry, carry = jstep(jcarry), step(carry)
    assert int(jcarry.overflow) == 0 and carry.nstep == 3
    np.testing.assert_allclose(by_id(carry.st, "pos"),
                               np.asarray(jcarry.st.pos), rtol=0,
                               atol=1e-4 * csp.dp)
    np.testing.assert_allclose(by_id(carry.st, "rho"),
                               np.asarray(jcarry.st.rho), rtol=1e-5)
    if flt:
        np.testing.assert_allclose(carry.st.ft.center.numpy(),
                                   np.asarray(jcarry.st.ft.center), rtol=0,
                                   atol=1e-4 * csp.dp)
    else:
        tau = by_id(carry.st, "spstau")
        assert np.abs(tau).max() > 0
        want = np.asarray(jcarry.st.spstau)
        np.testing.assert_allclose(tau, want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())
