"""Floating bodies: the rigid-body update, the floating mass of the pair
interaction and 3 steps of the 2D floating box, each against the JAX
package on the same inputs.

* ``make_floating`` and ``run_floating`` on seeded random states (2D and
  3D, predictor and corrector, DOF constraints, FtPause before and after):
  particles within rtol 1e-5 (floor 1e-6 of the largest value), bodies
  within rtol 1e-4 with a floor of 1e-4 of the largest value (sums of
  hundreds of particle forces in another order).
* The interaction with ``ftomassp``: the plain version and the CPU twin of
  the CUDA kernels (g++) against the JAX bucket path on a perturbed
  floating box, by the rule of tests/test_forces.py (rtol 2e-3 with its
  floor, 4e-3 with the cubic spline, 1e-3 on viscdtmax).
* 3 steps of a small ``floatingbox2d`` with ``Features(floating=...)``
  under bench.py's floatingbox options against jitted JAX
  ``make_step(use_pallas=False)``: positions by particle id and the body
  center within 1e-4*dp, fvel and fomega within rtol 1e-3 with a floor of
  1e-3 of the largest value.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.features import floating as jFT
from dualsphysics_multilayer_tpu.features.featureset import Features as jFeatures
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import eos as jeos
from dualsphysics_multilayer_tpu.ops import forces as jF
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.features import floating as FT
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

from test_torch_variants import assert_close, forces_dict, jax_dict

torch.set_num_threads(2)

BODY = ("center", "fvel", "fomega", "angles")


# ---------------------------------------------------------------------------
# make_floating and run_floating
# ---------------------------------------------------------------------------

def random_bodies(sim2d, seed):
    """Two bodies of 20 and 15 particles among 10 fixed and 15 fluid ones,
    with seeded positions, velocities, accelerations and body motion."""
    rng = np.random.default_rng(seed)
    n = 60
    pos = rng.uniform(0.0, 1.0, (n, 3))
    if sim2d:
        pos[:, 1] = 0.0
    code = np.array([jtd.code_make(jtd.TYPE_FIXED, 0)] * 10
                    + [jtd.code_make(jtd.TYPE_FLOATING, 0)] * 20
                    + [jtd.code_make(jtd.TYPE_FLOATING, 1)] * 15
                    + [jtd.code_make(jtd.TYPE_FLUID, 0)] * 15, np.uint32)
    bodies = [pos[10:30], pos[30:45]]
    f32 = lambda a: a.astype(np.float32)
    return dict(pos=f32(pos), vel=f32(rng.normal(0, 0.5, (n, 3))),
                ace=f32(rng.normal(0, 5.0, (n, 3))), code=code,
                bodies=bodies,
                ft=dict(center=f32(np.array([b.mean(0) for b in bodies])
                                   + rng.normal(0, 0.01, (2, 3))),
                        fvel=f32(rng.normal(0, 0.2, (2, 3))),
                        fomega=f32(rng.normal(0, 1.0, (2, 3))),
                        angles=f32(rng.normal(0, 0.3, (2, 3)))))


def csps(sim2d):
    kw = dict(simulate2d=sim2d, dp=0.05, hswl=0.25)
    return td.make_ctesph(**kw), jtd.make_ctesph(**kw)


def assert_body_close(got, want, rtol):
    for k in BODY:
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("sim2d", [False, True])
def test_make_floating_matches_jax(sim2d):
    csp, jcsp = csps(sim2d)
    r = random_bodies(sim2d, 1)
    kw = dict(ftpause=0.1, translation_dof=[(1, 0, 1), (1, 1, 1)],
              rotation_dof=[(0, 1, 0), (1, 1, 1)])
    jcfg, jst = jFT.make_floating(r["bodies"], [500.0, 800.0], jcsp, **kw)
    cfg, st = FT.make_floating(r["bodies"], [500.0, 800.0], csp, device="cpu",
                               **kw)
    assert cfg == convert.floatingcfg(jcfg)
    for k in BODY:
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jst, k)))


RUNS = {   # name: (sim2d, predictor, dof, ftpause, t)
    "2d-predictor": (True, True, False, 0.0, 0.3),
    "2d-corrector": (True, False, False, 0.0, 0.3),
    "3d-predictor": (False, True, False, 0.0, 0.3),
    "3d-corrector": (False, False, False, 0.0, 0.3),
    "3d-dof": (False, False, True, 0.0, 0.3),
    "3d-ftpause-before": (False, False, False, 0.5, 0.3),
    "3d-ftpause-after": (False, False, False, 0.2, 0.3),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_run_floating_matches_jax(name):
    sim2d, predictor, dof, ftpause, t = RUNS[name]
    csp, jcsp = csps(sim2d)
    r = random_bodies(sim2d, 2)
    kw = dict(ftpause=ftpause)
    if dof:
        kw.update(translation_dof=[(1, 0, 1), (0, 0, 1)],
                  rotation_dof=[(0, 1, 0), (1, 0, 0)])
    jcfg, _ = jFT.make_floating(r["bodies"], [500.0, 800.0], jcsp, **kw)
    jfts = jFT.FloatingState(**{k: jnp.asarray(v) for k, v in r["ft"].items()})
    dt = np.float32(2e-3)
    jpos, jvel, jnew = jFT.run_floating(
        jcfg, jcsp, jfts, t, jnp.asarray(dt), predictor, jnp.asarray(r["pos"]),
        jnp.asarray(r["vel"]), jnp.asarray(r["code"]), jnp.asarray(r["ace"]))

    fts = FT.FloatingState(**{k: torch.tensor(v) for k, v in r["ft"].items()})
    pos, vel, new = FT.run_floating(
        convert.floatingcfg(jcfg), csp, fts, torch.tensor(t, dtype=torch.float32),
        torch.tensor(dt), predictor, torch.tensor(r["pos"]),
        torch.tensor(r["vel"]), torch.tensor(r["code"].astype(np.int32)),
        torch.tensor(r["ace"]))
    for got, want in ((pos, jpos), (vel, jvel)):
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
    assert_body_close(new, jnew, rtol=1e-4)
    if predictor:
        assert new is fts                     # bodies commit on the corrector
    frozen = t < ftpause
    moved = not np.allclose(pos.numpy(), r["pos"])
    assert moved != frozen


def test_run_floating_external_couplings_raise():
    """The sharded sums: ``reduce_sum`` (a domain decomposition's sum over
    its ranks, JAX's ``psum_axis``) takes the particle sums, so a sum that
    doubles them is the update of doubled accelerations; the Chrono
    couplings run (tests/port/test_torch_couplings.py), and a ``ChronoCfg``
    with no link reduces to the per-body solve."""
    from dualsphysics_multilayer_tpu_torch.features import chrono as CH
    csp, jcsp = csps(False)
    r = random_bodies(False, 3)
    cfg, fts = FT.make_floating(r["bodies"], [500.0, 800.0], csp, device="cpu")
    args = (torch.tensor(r["pos"]), torch.tensor(r["vel"]),
            torch.tensor(r["code"].astype(np.int32)), torch.tensor(r["ace"]))
    calls = []

    def doubled(x):
        calls.append(tuple(x.shape))
        return 2.0 * x

    summed = FT.run_floating(cfg, csp, fts, 0.0, 1e-3, False, *args,
                             reduce_sum=doubled)
    assert calls == [(2, cfg.count, 3)]       # one collective per update
    twice = FT.run_floating(cfg, csp, fts, 0.0, 1e-3, False, *args[:3],
                            2.0 * args[3])
    for a, b in zip(twice[2].__dict__.values(), summed[2].__dict__.values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(summed[1].numpy(), twice[1].numpy(),
                               rtol=1e-6, atol=1e-7)
    plain = FT.run_floating(cfg, csp, fts, 0.0, 1e-3, False, *args)
    linked = FT.run_floating(cfg, csp, fts, 0.0, 1e-3, False, *args,
                             chrono=CH.make_chrono([], fts.center.numpy()))
    for a, b in zip(plain[:2], linked[:2]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6 * a.abs().max().item())


# ---------------------------------------------------------------------------
# the interaction with the floating mass
# ---------------------------------------------------------------------------

BOX = dict(dp=0.05, tank=(1.0, 0.6), water=0.3, box=(0.2, 0.2),
           box_pos=(0.4, 0.2))


def perturbed_box(seed):
    """The JAX floating box (BOX) with a seeded 0.5 m/s velocity jitter on
    fluid and box and a 1% density jitter: (JAX case, arrays)."""
    jcase = jcases.floatingbox2d(**BOX)
    st = jcase.state
    rng = np.random.default_rng(seed)
    n = st.pos.shape[0]
    code = np.asarray(st.code)
    fluidside = jtd.code_type(code) >= jtd.TYPE_FLOATING
    vel = rng.normal(0, 0.5, (n, 3))
    vel[:, 1] = 0.0
    rho = np.asarray(st.rho) * (1 + rng.uniform(-0.01, 0.01, n))
    return jcase, dict(pos=np.asarray(st.pos),
                       vel=np.where(fluidside[:, None], vel, 0.0).astype(np.float32),
                       rho=np.where(fluidside, rho, np.asarray(st.rho)).astype(np.float32),
                       code=code)


def floating_forces(jcsp, jopts, opts, jdom, a, massp, spstau):
    """(JAX bucket path, port plain, port twin or None) on arrays ``a``."""
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    press = jeos.press_from_rho(jcsp, f32(a["rho"]))
    div, _ = jcd.divide(jdom, f32(a["pos"]), jnp.asarray(a["code"]))
    want = jax_dict(jF.interaction_forces(
        jcsp, jopts, div, f32(a["pos"]), f32(a["vel"]), f32(a["rho"]), press,
        jnp.asarray(a["code"]), spstau=None if spstau is None else f32(spstau),
        ftomassp=f32(massp)))

    csp = convert.ctesph(dataclasses.asdict(jcsp))
    dom = convert.domain(dataclasses.asdict(jdom))
    st = convert.simstate(dict(a, idp=np.arange(len(a["code"]))), device="cpu")
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    o = cells.order
    args = (st.pos[o], st.vel[o], st.rho[o], code[o])
    tau = None if spstau is None else torch.tensor(spstau)[o].contiguous()
    ftomassp = torch.tensor(massp, dtype=torch.float32)
    order = o.numpy()
    plain = forces_dict(F.interaction_forces(csp, opts, dom, cells, *args,
                                             spstau=tau, ftomassp=ftomassp), order)
    twin = None
    if shutil.which("g++") is not None:
        launches = dict(CF.launches)
        twin = forces_dict(CF.interaction_forces_host_twin(
            csp, opts, dom, cells, *args, spstau=tau, ftomassp=ftomassp), order)
        assert CF.launches == launches      # the twin is no kernel launch
    return want, plain, twin


# (tkernel, tvisco, shiftmode): each kernel with one shifting mode
FLOATING_VARIANTS = [("WENDLAND", "ARTIFICIAL", "NONE"),
                     ("WENDLAND", "ARTIFICIAL", "NO_BOUND"),
                     ("CUBIC", "ARTIFICIAL", "NO_FIXED"),
                     ("WENDLAND", "LAMINAR_SPS", "FULL")]


@pytest.mark.parametrize("tkernel,tvisco,shiftmode", FLOATING_VARIANTS)
def test_floating_mass_forces_match_jax(tkernel, tvisco, shiftmode):
    jcase, a = perturbed_box(5)
    # the box's constants (cases.floatingbox2d) with this kernel and viscosity
    jcsp = jtd.make_ctesph(simulate2d=True, dp=BOX["dp"], hswl=BOX["water"],
                           coefh=1.0, coefsound=20.0,
                           visco=1e-4 if tvisco == "LAMINAR_SPS" else 0.05,
                           tkernel=jtd.TpKernel[tkernel],
                           tvisco=jtd.TpVisco[tvisco])
    spstau = None
    if tvisco == "LAMINAR_SPS":
        rng = np.random.default_rng(6)
        fluid = jtd.code_type(a["code"]) == jtd.TYPE_FLUID
        spstau = np.where(fluid[:, None], rng.normal(0, 1e-3, (len(fluid), 6)),
                          0.0).astype(np.float32)
    massp = jcase.meta["ftcfg"].massp
    assert massp[0] == pytest.approx(0.5 * jcsp.massfluid)
    rtol = 4e-3 if tkernel == "CUBIC" else 2e-3
    outs = {}
    for with_floating in (True, False):
        okw = lambda m: dict(tvisco=m.TpVisco[tvisco],
                             tdensity=m.TpDensity.FOURTAKAS,
                             tboundary=m.TpBoundary.MDBC,
                             shiftmode=m.TpShifting[shiftmode],
                             with_floating=with_floating)
        want, plain, twin = floating_forces(
            jcsp, jF.SolverOpts(**okw(jtd)), F.SolverOpts(**okw(td)),
            jcase.dom, a, massp, spstau)
        for got in (plain, twin) if twin else (plain,):
            assert_close(want, got, rtol)
        outs[with_floating] = plain
    # the floating mass shows: half the fluid's, on every box-fluid pair
    scale = np.abs(outs[True]["ace"]).max()
    assert np.abs(outs[True]["ace"] - outs[False]["ace"]).max() > 10 * rtol * scale


# ---------------------------------------------------------------------------
# steps of the floating box
# ---------------------------------------------------------------------------

STEP_BOX = dict(dp=0.04, tank=(0.8, 0.6), water=0.3, box=(0.16, 0.16),
                box_pos=(0.32, 0.2))
NSTEPS = 3


def box_opts(m):
    """bench.py's floatingbox options (bench.py:70-80) in module ``m``."""
    return dict(tdensity=m.TpDensity.FOURTAKAS, with_floating=True,
                tboundary=m.TpBoundary.MDBC, slipmode=m.TpSlipMode.NO_SLIP)


def by_id(st, name):
    v = getattr(st, name)
    out = torch.empty_like(v)
    out[st.idp] = v
    return out.numpy()


def test_floatingbox_steps_match_jax():
    jcase = jcases.floatingbox2d(**STEP_BOX)
    jfeats = jFeatures(floating=jcase.meta["ftcfg"])
    jopts = jF.SolverOpts(use_pallas=False, **box_opts(jtd))
    st0 = jcase.state
    rng = np.random.default_rng(8)
    fluid = jtd.code_type(np.asarray(st0.code)) == jtd.TYPE_FLUID
    vel = np.array([2.5, 0.0, 0.0]) + rng.normal(0, 0.3, np.asarray(st0.pos).shape)
    vel[:, 1] = 0.0
    vel = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jcase.dom, jfeats))
    jcarry = jW.make_carry(dataclasses.replace(st0, vel=jnp.asarray(vel)),
                           jcase.csp, jopts, jfeats, dom=jcase.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    cfg = convert.floatingcfg(jcase.meta["ftcfg"])
    arrays = {k: np.asarray(getattr(st0, k))
              for k in ("pos", "rho", "code", "idp")}
    arrays.update(vel=vel, ft={k: np.asarray(getattr(st0.ft, k)) for k in BODY})
    opts = P.SolverOpts(**box_opts(td))
    feats = P.Features(floating=cfg)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_step(csp, opts, dom, feats)
    for _ in range(NSTEPS):
        carry = step(carry)
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert carry.nrebuild >= 2

    st = carry.st
    np.testing.assert_allclose(by_id(st, "pos"), np.asarray(jcarry.st.pos),
                               rtol=0, atol=1e-4 * csp.dp)
    np.testing.assert_allclose(by_id(st, "rho"), np.asarray(jcarry.st.rho),
                               rtol=1e-5)
    jft = jcarry.st.ft
    np.testing.assert_allclose(st.ft.center.numpy(), np.asarray(jft.center),
                               rtol=0, atol=1e-4 * csp.dp)
    for k in ("fvel", "fomega"):
        w = np.asarray(getattr(jft, k))
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(getattr(st.ft, k).numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)
    # the box moved as one rigid body: the distance between its first and
    # last particle is unchanged
    ftid = np.nonzero(jtd.code_type(arrays["code"]) == jtd.TYPE_FLOATING)[0]
    pos = by_id(st, "pos")
    d0 = np.linalg.norm(arrays["pos"][ftid[0]] - arrays["pos"][ftid[-1]])
    d1 = np.linalg.norm(pos[ftid[0]] - pos[ftid[-1]])
    assert abs(d1 - d0) < 1e-4 * csp.dp


@pytest.mark.parametrize("field", ["inout", "periodic", "chrono",
                                   "chcontact", "moorings", "forcepoints"])
def test_features_outside_the_port_raise(field):
    case = cases.floatingbox2d(**BOX, device="cpu")
    feats = P.Features(floating=case.meta["ftcfg"], **{field: object()})
    with pytest.raises(NotImplementedError, match=f"Features.{field}"):
        P.make_step(case.csp, P.SolverOpts(with_floating=True), case.dom, feats)


def test_floatingbox2d_matches_jax_builder():
    """The port's builder draws the JAX package's lattice, body and
    constants."""
    jcase = jcases.floatingbox2d(**BOX)
    case = cases.floatingbox2d(**BOX, device="cpu")
    st, jst = case.state, jcase.state
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))
    np.testing.assert_array_equal(st.rho.numpy(), np.asarray(jst.rho))
    np.testing.assert_array_equal(st.code.numpy(), np.asarray(jst.code).astype(np.int32))
    assert case.meta["ftcfg"] == convert.floatingcfg(jcase.meta["ftcfg"])
    for k in BODY:
        np.testing.assert_array_equal(getattr(st.ft, k).numpy(),
                                      np.asarray(getattr(jst.ft, k)))
    assert st.boundnormal is None and jst.boundnormal is None
    assert convert.domain(dataclasses.asdict(jcase.dom)) == case.dom
