"""mDBC walls: the ghost nodes' neighbour search, the mDBC correction, the
mDBC form of the density diffusion and 3 steps of the 2D dam break with
mDBC walls, each against the JAX package on the same inputs.

* ``celldiv.point_ranges`` holds every fluid particle within kernelsize of
  a point, on a fresh layout and on a stale one inside the skin contract.
* ``mdbc_correction`` against JAX ``mdbc_correction`` on the 2D dam break
  (VEL0, NO_SLIP and FREE_SLIP; threshold 0 and 0.5; Wendland and the
  cubic spline) and the 3D one:
  density within rtol 1e-5, velocity within rtol 2e-3 with a floor of 2e-3
  of the largest value; a particle whose density disagrees is reported with
  its branch (first order, Shepard, rho0) and determinant.
* Molteni and Fourtakas diffusion under mDBC walls: the plain version and
  the CPU twin (g++) against the JAX bucket path, by the rule of
  tests/test_forces.py (rtol 2e-3 with its floor, 1e-3 on viscdtmax).
* 3 steps of a small ``dambreak2d(mdbc=True)`` (VEL0, the CLI's ``-mdbc``,
  and NO_SLIP) against jitted JAX ``make_step(use_pallas=False)``:
  positions by particle id within 1e-4*dp and density within rtol 1e-5,
  walls included, velocity within 1e-4 m/s.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import eos as jeos
from dualsphysics_multilayer_tpu.ops import forces as jF
from dualsphysics_multilayer_tpu.ops import mdbc as jMD
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops import mdbc as MD
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

from test_torch_variants import assert_close, forces_dict, jax_dict

torch.set_num_threads(2)

DB2 = dict(dp=0.04)
DB3 = dict(dp=0.04, tank=(0.8, 0.4, 0.3), column=(0.2, 0.4, 0.2),
           obstacle=False)
FIELDS = ("pos", "vel", "rho", "code", "idp", "boundnormal", "motionvel")


def jax_case(sim2d):
    return (jcases.dambreak2d(**DB2, mdbc=True) if sim2d
            else jcases.dambreak3d(**DB3, mdbc=True))


def perturbed(jcase, seed, moving_walls=False):
    """The JAX case's arrays with a seeded 0.5 m/s fluid velocity jitter
    (none along y in 2D) and a 1% fluid density jitter; ``moving_walls``
    gives every other wall a seeded wall velocity."""
    st = jcase.state
    a = {k: np.asarray(getattr(st, k)) for k in FIELDS}
    rng = np.random.default_rng(seed)
    n = a["pos"].shape[0]
    fluid = jtd.code_type(a["code"]) == jtd.TYPE_FLUID
    vel = rng.normal(0, 0.5, (n, 3))
    if jcase.csp.simulate2d:
        vel[:, 1] = 0.0
    a["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    a["rho"] = np.where(fluid, a["rho"] * (1 + rng.uniform(-0.01, 0.01, n)),
                        a["rho"]).astype(np.float32)
    if moving_walls:
        mv = rng.normal(0, 0.3, (n, 3))
        mv[1::2] = 0.0
        if jcase.csp.simulate2d:
            mv[:, 1] = 0.0
        a["motionvel"] = np.where(fluid[:, None], 0.0, mv).astype(np.float32)
    return a


def sorted_state(jcase, a):
    """(csp, dom, cells, the port's state sorted into cells order, order)."""
    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    st = convert.simstate(a, device="cpu")
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    st = dataclasses.replace(st, code=code).permuted(cells.order)
    return csp, dom, cells, st, cells.order.numpy()


def unsort(x, order):
    out = np.empty_like(x)
    out[order] = x
    return out


# ---------------------------------------------------------------------------
# point_ranges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sim2d,stale", [(True, False), (True, True),
                                         (False, False), (False, True)])
def test_point_ranges_find_every_neighbour(sim2d, stale):
    case = (cases.dambreak2d(**DB2, mdbc=True, device="cpu") if sim2d
            else cases.dambreak3d(**DB3, mdbc=True, device="cpu"))
    csp, dom, st = case.csp, case.dom, case.state
    rng = np.random.default_rng(4)
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    pos0 = st.pos[cells.order]
    pos = pos0
    margin = dom.scell - csp.kernelsize
    if stale:
        # every particle moved by up to 0.99*margin since the divide
        step = torch.tensor(rng.normal(0, 1, pos.shape), dtype=torch.float32)
        if sim2d:
            step[:, 1] = 0.0
        step = step / step.norm(dim=1, keepdim=True).clamp(min=1e-12)
        step = step * torch.tensor(rng.uniform(0, 0.99 * margin, (pos.shape[0], 1)),
                                   dtype=torch.float32)
        pos = pos0 + step
    # the ghost nodes and random points over the domain
    bound = td.is_bound(st.code)
    lo = torch.tensor(dom.posmin)
    hi = torch.tensor(dom.posmax)
    rand = lo + (hi - lo) * torch.tensor(rng.uniform(0, 1, (300, 3)),
                                         dtype=torch.float32)
    if sim2d:
        rand[:, 1] = st.pos[0, 1]
    points = torch.cat([(st.pos + st.boundnormal)[bound], rand])
    fluid = td.is_fluid(code[cells.order])
    starts, lens = cd.point_ranges(dom, cells, points)
    found = torch.zeros((points.shape[0], pos.shape[0]), dtype=torch.bool)
    for t, j, valid in cd.range_chunks(starts, lens, 1 << 16):
        rows = t[:, None].expand_as(j)
        found[rows[valid], j[valid]] = True
    near = (((points[:, None, :] - pos[None]) ** 2).sum(-1)
            <= csp.kernelsize2) & fluid[None]
    assert int(near.sum()) > 100
    missed = near & ~found
    assert not bool(missed.any()), f"{int(missed.sum())} neighbours missed"


# ---------------------------------------------------------------------------
# mdbc_correction
# ---------------------------------------------------------------------------

CORRECTIONS = {   # name: (sim2d, slipmode, threshold, moving walls, kernel)
    "2d-vel0": (True, "VEL0", 0.0, False, "WENDLAND"),
    "2d-noslip": (True, "NO_SLIP", 0.0, False, "WENDLAND"),
    "2d-freeslip": (True, "FREE_SLIP", 0.0, True, "WENDLAND"),
    "2d-noslip-threshold": (True, "NO_SLIP", 0.5, True, "WENDLAND"),
    "2d-vel0-threshold": (True, "VEL0", 0.5, False, "WENDLAND"),
    "2d-noslip-cubic": (True, "NO_SLIP", 0.0, False, "CUBIC"),
    "3d-noslip": (False, "NO_SLIP", 0.0, True, "WENDLAND"),
    "3d-freeslip-threshold": (False, "FREE_SLIP", 0.5, False, "WENDLAND"),
}


@pytest.mark.parametrize("name", list(CORRECTIONS))
def test_mdbc_correction_matches_jax(name):
    sim2d, slip, threshold, moving, kernel = CORRECTIONS[name]
    jcase = jax_case(sim2d)
    # the ghost sums take W and its gradient from the case's kernel
    jcase = dataclasses.replace(jcase, csp=jcase.csp.replace(
        tkernel=jtd.TpKernel[kernel]))
    a = perturbed(jcase, 9, moving)
    okw = lambda m: dict(tboundary=m.TpBoundary.MDBC, slipmode=m.TpSlipMode[slip],
                         mdbc_threshold=threshold)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    div, jcode = jcd.divide(jcase.dom, f32(a["pos"]), jnp.asarray(a["code"]))
    jvel, jrho = jMD.mdbc_correction(
        jcase.csp, jF.SolverOpts(**okw(jtd)), jcase.dom, div, f32(a["pos"]),
        f32(a["vel"]), f32(a["rho"]), jcode, f32(a["boundnormal"]),
        f32(a["motionvel"]))
    jvel, jrho = np.asarray(jvel), np.asarray(jrho)

    csp, dom, cells, st, order = sorted_state(jcase, a)
    opts = F.SolverOpts(**okw(td))
    vel, rho = MD.mdbc_correction(csp, opts, dom, cells, st.pos, st.vel,
                                  st.rho, st.code, st.boundnormal, st.motionvel)
    vel, rho = unsort(vel.numpy(), order), unsort(rho.numpy(), order)
    g = MD.ghost_nodes(csp, dom, cells, st.pos, st.vel, st.rho, st.code,
                       st.boundnormal)
    branch = np.full(st.n, -1)
    determ = np.zeros(st.n, np.float32)
    branch[order[g.idx.numpy()]] = g.branch.numpy()
    determ[order[g.idx.numpy()]] = g.determ.numpy()
    # the case reaches every branch
    assert set(branch[branch >= 0]) == {MD.FIRST_ORDER, MD.SHEPARD, MD.RHO0}

    bad = ~np.isclose(rho, jrho, rtol=1e-5, atol=0)
    assert not bad.any(), "density differs from JAX at " + ", ".join(
        f"particle {k} (branch {branch[k]}, determinant {determ[k]:.6g}: "
        f"{rho[k]} vs {jrho[k]})" for k in np.nonzero(bad)[0][:10])
    corrected = rho != a["rho"]
    assert corrected.sum() > 0
    if threshold > 0:
        assert not corrected[branch == MD.RHO0].any()
    scale = np.abs(jvel).max() + 1e-6
    np.testing.assert_allclose(vel, jvel, rtol=2e-3, atol=2e-3 * scale)
    if slip == "VEL0":
        np.testing.assert_array_equal(vel, a["vel"])
    else:
        assert np.abs(vel[branch >= 0]).max() > 0


def test_case_normals_match_jax():
    """The port's builders draw the JAX package's mDBC normals."""
    for sim2d in (True, False):
        jst = jax_case(sim2d).state
        case = (cases.dambreak2d(**DB2, mdbc=True, device="cpu") if sim2d
                else cases.dambreak3d(**DB3, mdbc=True, device="cpu"))
        np.testing.assert_array_equal(case.state.pos.numpy(), np.asarray(jst.pos))
        np.testing.assert_array_equal(case.state.boundnormal.numpy(),
                                      np.asarray(jst.boundnormal))
        np.testing.assert_array_equal(case.state.motionvel.numpy(), 0.0)
    assert cases.dambreak2d(**DB2, device="cpu").state.boundnormal is None


# ---------------------------------------------------------------------------
# density diffusion under mDBC walls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tdensity", ["MOLTENI", "FOURTAKAS"])
def test_mdbc_diffusion_forces_match_jax(tdensity):
    jcase = jax_case(True)
    a = perturbed(jcase, 10)
    jcsp = jcase.csp
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    div, jcode = jcd.divide(jcase.dom, f32(a["pos"]), jnp.asarray(a["code"]))
    csp, dom, cells, st, order = sorted_state(jcase, a)
    outs = {}
    for boundary in ("MDBC", "DBC"):
        okw = lambda m: dict(tdensity=m.TpDensity[tdensity],
                             tboundary=m.TpBoundary[boundary])
        want = jax_dict(jF.interaction_forces(
            jcsp, jF.SolverOpts(**okw(jtd)), div, f32(a["pos"]), f32(a["vel"]),
            f32(a["rho"]), jeos.press_from_rho(jcsp, f32(a["rho"])), jcode))
        opts = F.SolverOpts(**okw(td))
        args = (csp, opts, dom, cells, st.pos, st.vel, st.rho, st.code)
        got = [forces_dict(F.interaction_forces_plain(*args), order)]
        if shutil.which("g++") is not None:
            got.append(forces_dict(CF.interaction_forces_host_twin(*args), order))
        for g in got:
            assert_close(want, g, 2e-3)
        outs[boundary] = got[0]["ar"]
    # Molteni: under mDBC a wall neighbour adds its term instead of blocking
    # the whole diffusion; Fourtakas: walls block under both
    scale = np.abs(outs["DBC"]).max()
    differs = np.abs(outs["MDBC"] - outs["DBC"]).max() > 1e-2 * scale
    assert differs == (tdensity == "MOLTENI")


# ---------------------------------------------------------------------------
# steps of the mDBC dam break
# ---------------------------------------------------------------------------

STEP_DB = dict(dp=0.02, tank=(0.8, 0.5), column=(0.2, 0.3))
NSTEPS = 3


@pytest.fixture(scope="module")
def jax_steps():
    built = {}

    def get(slip):
        if slip not in built:
            jcase = jcases.dambreak2d(**STEP_DB, mdbc=True)
            jopts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS,
                                  tboundary=jtd.TpBoundary.MDBC,
                                  slipmode=jtd.TpSlipMode[slip],
                                  use_pallas=False)
            built[slip] = (jcase, jopts,
                           jax.jit(jW.make_step(jcase.csp, jopts, jcase.dom)))
        return built[slip]

    return get


def by_id(st, name):
    v = getattr(st, name)
    out = torch.empty_like(v)
    out[st.idp] = v
    return out.numpy()


@pytest.mark.parametrize("slip", ["VEL0", "NO_SLIP"])
def test_mdbc_dambreak_steps_match_jax(jax_steps, slip):
    jcase, jopts, jstep = jax_steps(slip)
    a = {k: np.asarray(getattr(jcase.state, k)) for k in FIELDS}
    rng = np.random.default_rng(12)
    fluid = jtd.code_type(a["code"]) == jtd.TYPE_FLUID
    vel = np.array([2.5, 0.0, 0.0]) + rng.normal(0, 0.3, a["pos"].shape)
    vel[:, 1] = 0.0
    a["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    jcarry = jW.make_carry(dataclasses.replace(jcase.state,
                                               vel=jnp.asarray(a["vel"])),
                           jcase.csp, jopts, dom=jcase.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS,
                        tboundary=td.TpBoundary.MDBC,
                        slipmode=td.TpSlipMode[slip])
    carry = P.make_carry(convert.simstate(a, device="cpu"), csp, opts, dom)
    step = P.make_step(csp, opts, dom)
    for _ in range(NSTEPS):
        carry = step(carry)
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert carry.nrebuild >= 2

    st = carry.st
    np.testing.assert_allclose(by_id(st, "pos"), np.asarray(jcarry.st.pos),
                               rtol=0, atol=1e-4 * csp.dp)
    rho, jrho = by_id(st, "rho"), np.asarray(jcarry.st.rho)
    np.testing.assert_allclose(rho, jrho, rtol=1e-5)
    wall = ~fluid
    assert np.abs(rho[wall] - csp.rhopzero).max() > 1.0   # walls corrected
    vel, jvel = by_id(st, "vel"), np.asarray(jcarry.st.vel)
    np.testing.assert_allclose(vel, jvel, rtol=0, atol=1e-4)
    assert (np.abs(vel[wall]).max() > 0) == (slip == "NO_SLIP")
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
