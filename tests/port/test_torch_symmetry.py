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


def jax_forces(cloud, jcsp, jopts):
    pos, vel, rho = cloud["jarr"]
    fr = jF.interaction_forces(jcsp, jopts, cloud["jdiv"], pos, vel, rho,
                               jeos.press_from_rho(jcsp, rho), cloud["jcode"])
    out = dict(ace=np.asarray(fr.ace), ar=np.asarray(fr.ar),
               viscdtmax=float(fr.viscdtmax))
    if fr.shiftposfs is not None:
        out.update(shift=np.asarray(fr.shiftposfs),
                   blocked=np.asarray(fr.shift_blocked))
    return out


def as_dict(fr, order):
    out = dict(viscdtmax=float(fr.viscdtmax))
    for k, v in (("ace", fr.ace), ("ar", fr.ar), ("shift", fr.shiftposfs),
                 ("blocked", fr.shift_blocked)):
        if v is not None:
            out[k] = np.empty_like(v.numpy())
            out[k][order] = v.numpy()
    return out


def assert_close(want, got, rtol=2e-3):
    for k in ("ace", "ar", "shift"):
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
