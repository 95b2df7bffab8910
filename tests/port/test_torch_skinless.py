"""Domains without a cell skin: cells of exactly the kernel size, JAX
``celldiv.make_domain``'s default (``skin=0``), which the JAX package runs
on its bucket path by dividing at every interaction.  The port then
rebuilds at every step and divides each interaction's own positions
afresh (``wcsph.fresh_interaction``), so the corrector finds the pairs of
the predicted positions.

Held here against the JAX package's jitted ``make_step`` /
``make_nn_step`` (``use_pallas=False``) on the same skinless domain, from
a flow fast enough to move particles across the cell faces: the 2D dam
break (symplectic, Fourtakas) and the NN wet dam break (SPH Morris), 4 and
3 steps, positions by id within 1e-4*dp, density within rtol 1e-5, dt
within rtol 1e-4 (the contract of test_torch_wcsph.py); and one
interaction of a state moved after its divide against the naive O(N^2)
oracle, which the stale layout misses and ``fresh_interaction``
matches.  What a skinless
domain does not run yet raises before a step: inlet/outlet zones and a
domain decomposition; cells narrower than the kernel size raise too.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ref_naive import naive_forces

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import nnewtonian as jNM
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import eos as jeos
from dualsphysics_multilayer_tpu.features import inout as jIO
from dualsphysics_multilayer_tpu.features.featureset import Features as \
    jFeatures
from dualsphysics_multilayer_tpu.ops.forces import SolverOpts as JOpts
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.features import inout as IO
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.models import wcsph as W
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.parallel import sharding as S

from test_torch_openbc import arrays_of, extrap_scene, host_by_id
from test_torch_sharding import LIMIT, by_id, one_device

torch.set_num_threads(2)

DP = 0.05


def skinless(jcase):
    """The JAX case's grid with cells of the kernel size (skin 0), and its
    port conversion."""
    d = jcase.dom
    posmax = [p + n * d.scell for p, n in zip(d.posmin, d.nc)]
    jdom = jcd.make_domain(d.posmin, posmax, jcase.csp.kernelsize,
                           simulate2d=d.simulate2d, dp=jcase.csp.dp)
    dom = convert.domain(dataclasses.asdict(jdom))
    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    assert dom.scell == csp.kernelsize and W.skinless(csp, dom)
    return jdom, csp, dom


def flowing(st):
    arrays = {k: np.asarray(getattr(st, k))
              for k in ("pos", "vel", "rho", "code", "idp")}
    rng = np.random.default_rng(11)
    fluid = jtd.code_type(arrays["code"]) == jtd.TYPE_FLUID
    vel = np.array([2.5, 0.0, 0.0]) + rng.normal(0.0, 0.3, arrays["pos"].shape)
    vel[:, 1] = 0.0
    arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    return arrays


def assert_steps_match(carry, jcarry, dp):
    st = carry.st
    idp = st.idp.numpy()
    out = {}
    for k in ("pos", "rho"):
        a = getattr(st, k).numpy()
        out[k] = np.empty_like(a)
        out[k][idp] = a
    np.testing.assert_allclose(out["pos"], np.asarray(jcarry.st.pos), rtol=0,
                               atol=1e-4 * dp)
    np.testing.assert_allclose(out["rho"], np.asarray(jcarry.st.rho),
                               rtol=1e-5)
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
    assert carry.overflow == 0 == int(jcarry.overflow)


def test_skinless_symplectic_steps_match_jax():
    jcase = jcases.dambreak2d(dp=DP)
    jdom, csp, dom = skinless(jcase)
    arrays = flowing(jcase.state)
    jopts = JOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jdom))
    jcarry = jW.make_carry(dataclasses.replace(
        jcase.state, vel=jnp.asarray(arrays["vel"])), jcase.csp, jopts,
        dom=jdom)
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_step(csp, opts, dom)
    for _ in range(4):
        jcarry, carry = jstep(jcarry), step(carry)
        assert carry.rebuild            # every step starts with a divide
    assert carry.nrebuild == 1 + 4      # the carry's and each step's
    assert_steps_match(carry, jcarry, DP)


def test_skinless_nn_steps_match_jax():
    jcase, jph = jNM.wet_dambreak_nn(dp=DP)
    jdom, csp, dom = skinless(jcase)
    arrays = flowing(jcase.state)
    jopts = JOpts(tvisco=jtd.TpVisco.LAMINAR_SPS,
                  tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    jstep = jax.jit(jNM.make_nn_step(jcase.csp, jopts, jdom, jph))
    jcarry = jW.make_carry(dataclasses.replace(
        jcase.state, vel=jnp.asarray(arrays["vel"])), jcase.csp, jopts)
    opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS,
                        tdensity=td.TpDensity.FOURTAKAS)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_nn_step(csp, opts, dom, convert.phasecfg(jph))
    for _ in range(3):
        jcarry, carry = jstep(jcarry), step(carry)
    assert_steps_match(carry, jcarry, DP)


def test_fresh_interaction_finds_the_pairs_a_stale_layout_misses():
    """``fresh_interaction`` on a state moved after its divide (fluid
    particles up to 0.3 kernel sizes from their slots' cells) gives the
    naive O(N^2) oracle's forces (tests/ref_naive.py, the rule of
    test_torch_forces.py) in the state's own slot order, where the stale
    layout misses pairs."""
    jcase = jcases.dambreak2d(dp=DP)
    jdom, csp, dom = skinless(jcase)
    st = convert.simstate(flowing(jcase.state), device="cpu")
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    st = dataclasses.replace(st, code=code).permuted(cells.order)
    rng = np.random.default_rng(5)
    d = torch.tensor(rng.uniform(-0.3, 0.3, (st.n, 3)) * csp.kernelsize,
                     dtype=torch.float32)
    d[:, 1] = 0.0
    moved = dataclasses.replace(st, pos=torch.where(
        td.is_fluid(st.code)[:, None], st.pos + d, st.pos))
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)

    def interact(s, c):
        return s, F.interaction_forces(csp, opts, dom, c, s.pos, s.vel,
                                       s.rho, s.code)

    after, got = W.fresh_interaction(dom, moved, interact)
    assert torch.equal(after.pos, moved.pos)
    arr = {k: getattr(moved, k).numpy() for k in ("pos", "vel", "rho", "code")}
    jcsp = jcase.csp
    press = np.asarray(jeos.press_from_rho(jcsp, jnp.asarray(arr["rho"])))
    want = naive_forces(jcsp, JOpts(tdensity=jtd.TpDensity.FOURTAKAS),
                        arr["pos"], arr["vel"], arr["rho"],
                        press.astype(np.float64), arr["code"])
    for k in ("ace", "ar"):
        w = torch.tensor(want[k], dtype=torch.float32)
        scale = float(w.abs().max())
        torch.testing.assert_close(getattr(got, k), w, rtol=2e-3,
                                   atol=2e-3 * scale, msg=k)
    _, stale = interact(moved, cells)
    w = torch.tensor(want["ace"], dtype=torch.float32)
    assert float((stale.ace - w).abs().max()) > 0.1 * float(w.abs().max())


def test_skinless_refusals():
    """A skinless domain now takes inlet/outlet zones and a domain
    decomposition (both build); cells narrower than the kernel size still
    raise."""
    case = cases.channel2d(dp=0.05, device="cpu")
    d = case.dom
    flat = dataclasses.replace(d, scell=case.csp.kernelsize)
    assert W.skinless(case.csp, flat)
    step = P.make_step(case.csp, P.SolverOpts(), flat,
                       P.Features(inout=case.meta["inout"]))
    assert callable(step)
    sim = S.ShardedSimulation(case.csp, P.SolverOpts(), flat, case.state,
                              ndev=2, device="cpu")
    assert sim.cfg.ndev == 2
    narrow = dataclasses.replace(d, scell=0.9 * case.csp.kernelsize)
    with pytest.raises(ValueError, match="narrower than the kernel size"):
        P.make_carry(case.state, case.csp, P.SolverOpts(), narrow)


# ---------------------------------------------------------------------------
# inlet/outlet zones on a skinless domain
# ---------------------------------------------------------------------------

CHANNEL = dict(dp=0.02, length=0.5, height=0.16, vel=0.4)


def extrap_channel():
    """JAX's channel2d with its outlet's velocity and density extrapolated
    from the fluid (the mode that reads a layout after the corrector), on
    cells of the kernel size: (JAX case, JAX Features, csp, dom, the
    port's Features)."""
    jcase = jcases.channel2d(**CHANNEL)
    io = jcase.meta["inout"]
    zones = (io.zones[0], dataclasses.replace(io.zones[1], vel_extrap=True,
                                              rho_extrap=True))
    jfeats = jFeatures(inout=dataclasses.replace(io, zones=zones))
    jdom, csp, dom = skinless(jcase)
    return jcase, jdom, jfeats, csp, dom, convert.features(jfeats)


def channel_state(st, verlet):
    if verlet:
        return dataclasses.replace(st, velm1=st.vel.clone(),
                                   rhom1=st.rho.clone())
    return st


def test_skinless_inout_pass_divides_the_post_step_positions():
    """The inout pass of a skinless step (``wcsph._inout_hook``) on a
    state whose fluid moved up to 0.3 kernel sizes after the step's
    divide, test_torch_openbc.py's linear field by an extrapolated zone:
    JAX's ``inout_step`` (which divides afresh) by id within rtol 1e-4,
    the state left in its slot order; the pass on the stale layout
    misses pairs and fails that comparison."""
    jcsp, jcfg, jdom, jst, nfluid = extrap_scene(True, 1e-3)
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    dom = convert.domain(dataclasses.asdict(jdom))
    assert W.skinless(csp, dom)
    st = convert.simstate(arrays_of(jst), device="cpu")
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    st = dataclasses.replace(st, code=code).permuted(cells.order)
    rng = np.random.default_rng(3)
    d = torch.tensor(rng.uniform(-0.3, 0.3, (st.n, 3)) * csp.kernelsize,
                     dtype=torch.float32)
    d[:, 1] = 0.0
    plain = td.is_fluid(st.code) & ~td.is_inout(st.code)
    pos = torch.where(plain[:, None], st.pos + d, st.pos)
    # a field that a first-order fit over fewer neighbours does not keep
    x, z = pos[:, 0], pos[:, 2]
    vel = st.vel.clone()
    vel[:, 0] = torch.where(plain, torch.sin(3 * x) * torch.cos(2 * z),
                            vel[:, 0])
    rho = torch.where(plain, csp.rhopzero + 30 * torch.sin(4 * x + z),
                      st.rho)
    moved = dataclasses.replace(st, pos=pos, vel=vel, rho=rho)
    jmoved = dataclasses.replace(jst, **{k: jnp.asarray(host_by_id(moved, k))
                                         for k in ("pos", "vel", "rho")})
    jout, jov = jax.jit(functools.partial(jIO.inout_step, jcfg, jcsp,
                                          dom=jdom))(jmoved, 0.01,
                                                     jnp.float32(0.0))
    feats = P.Features(inout=convert.feature(jcfg))
    hook = W._inout_hook(csp, dom, feats)
    carry = types.SimpleNamespace(tabs=torch.zeros(()), nstep=0, cells=cells)
    out, ov, _, _ = hook(moved, carry)
    assert int(ov) == 0 == int(jov)
    assert torch.equal(out.idp, moved.idp) and torch.equal(out.pos,
                                                           moved.pos)

    def close(got):
        for name in ("vel", "rho"):
            want = np.asarray(getattr(jout, name))
            np.testing.assert_allclose(host_by_id(got, name), want,
                                       rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)

    close(out)
    stale, _, _ = IO.inout_step(feats.inout, csp, moved, carry.tabs,
                                nstep=0, dom=dom, cells=cells)
    with pytest.raises(AssertionError):
        close(stale)


@pytest.mark.parametrize("verlet", [False, True])
def test_skinless_channel_steps_match_jax(verlet, monkeypatch):
    """3 steps of the channel with an extrapolated outlet on a skinless
    domain against jitted JAX: codes by id equal, positions within
    1e-4*dp, density within rtol 1e-5, the spawns JAX's; the outlet's
    extrapolation reads a divide of the post-step positions, not the
    step's start layout."""
    jcase, jdom, jfeats, csp, dom, feats = extrap_channel()
    tstep = "VERLET" if verlet else "SYMPLECTIC"
    jst = jcase.state
    if verlet:
        jst = dataclasses.replace(jst, velm1=jst.vel, rhom1=jst.rho)
    jopts = JOpts(tdensity=jtd.TpDensity.MOLTENI, use_pallas=False,
                  tstep=jtd.TpStep[tstep])
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jdom, jfeats))
    jcarry = jW.make_carry(jst, jcase.csp, jopts, jfeats, dom=jdom)
    st = channel_state(cases.channel2d(**CHANNEL, device="cpu").state, verlet)
    opts = P.SolverOpts(tdensity=td.TpDensity.MOLTENI, tstep=td.TpStep[tstep])
    layouts = []
    extrapolate = IO.inout_extrapolate

    def seen(cfg, csp, dom, cells, st, **kw):
        layouts.append((cells, kw.get("order")))
        return extrapolate(cfg, csp, dom, cells, st, **kw)

    monkeypatch.setattr(IO, "inout_extrapolate", seen)
    carry = P.make_carry(st, csp, opts, dom, feats)
    step = P.make_step(csp, opts, dom, feats)
    for _ in range(3):
        jcarry, carry = jstep(jcarry), step(carry)
    assert len(layouts) == 3 and all(o is not None for _, o in layouts)
    assert all(c is not carry.cells for c, _ in layouts)
    out, jout = carry.st, jcarry.st
    jcode = np.asarray(jout.code).astype(np.int32)
    ids = out.idp.numpy()
    code = np.empty_like(jcode)
    code[ids] = out.code.numpy()
    np.testing.assert_array_equal(code, jcode)
    act = jtd.is_active(jcode)
    pos = np.empty_like(np.asarray(jout.pos))
    pos[ids] = out.pos.numpy()
    rho = np.empty_like(np.asarray(jout.rho))
    rho[ids] = out.rho.numpy()
    np.testing.assert_allclose(pos[act], np.asarray(jout.pos)[act], rtol=0,
                               atol=1e-4 * csp.dp)
    np.testing.assert_allclose(rho[act], np.asarray(jout.rho)[act],
                               rtol=1e-5)
    spawned = act & ~jtd.is_active(np.asarray(jcase.state.code))
    assert spawned.sum() > 0
    assert carry.overflow == 0 == int(jcarry.overflow)
    assert carry.nrebuild == 1 + 3


# ---------------------------------------------------------------------------
# a skinless domain over 2 ranks
# ---------------------------------------------------------------------------

# the 2D dam break whose fluid straddles the slab edge (test_torch_sharding)
SHARD_GEOM = dict(dp=0.025, tank=(0.6, 0.4), column=(0.5, 0.3))
SHARD_STEPS = 5


@pytest.fixture(scope="module")
def sharded():
    """Every skinless path over one start of two ranks, with its
    one-device run: the flowing dam break (symplectic and Verlet), the NN
    wet dam break and the channel with its extrapolated outlet; JAX's
    steps of the dam break."""
    jcase = jcases.dambreak2d(**SHARD_GEOM)
    jdom, csp, dom = skinless(jcase)
    arrays = flowing(jcase.state)
    st = convert.simstate(arrays, device="cpu")
    fd = dict(tdensity=td.TpDensity.FOURTAKAS)
    vst = dataclasses.replace(st, velm1=st.vel.clone(), rhom1=st.rho.clone())
    jnn, jph = jNM.wet_dambreak_nn(dp=DP)
    _, ncsp, ndom = skinless(jnn)
    nst = convert.simstate(flowing(jnn.state), device="cpu")
    _, _, _, ccsp, cdom, cfeats = extrap_channel()
    cst = cases.channel2d(**CHANNEL, device="cpu").state
    paths = {
        "symplectic": (csp, P.SolverOpts(**fd), dom, st, None, None),
        "verlet": (csp, P.SolverOpts(tstep=td.TpStep.VERLET, **fd), dom, vst,
                   None, None),
        "nn": (ncsp, P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS, **fd), ndom,
               nst, None, convert.phasecfg(jph)),
        "channel": (ccsp, P.SolverOpts(tdensity=td.TpDensity.MOLTENI), cdom,
                    cst, cfeats, None),
    }
    jopts = JOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jdom))
    jcarry = jW.make_carry(dataclasses.replace(
        jcase.state, vel=jnp.asarray(arrays["vel"])), jcase.csp, jopts,
        dom=jdom)
    for _ in range(SHARD_STEPS):
        jcarry = jstep(jcarry)
    sims, refs = {}, {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, (c, o, d, s, f, ph) in paths.items():
            assert W.skinless(c, d)
            sims[name] = S.ShardedSimulation(c, o, d, s, feats=f, ndev=2,
                                             phases=ph, device="cpu",
                                             limit=LIMIT, log=lambda *a: None)
            refs[name] = one_device(c, o, d, s, f, ph, SHARD_STEPS)
        out = S.steps_together(list(sims.values()), (SHARD_STEPS,))
    finally:
        torch.set_num_threads(threads)
    got = {name: carries[-1] for name, (carries, _) in zip(sims, out)}
    return dict(got=got, refs=refs, jax=jcarry,
                stats={k: s.stats for k, s in sims.items()})


@pytest.mark.parametrize("name", ["symplectic", "verlet", "nn", "channel"])
def test_skinless_sharded_matches_one_device(sharded, name):
    """2 ranks against the one-device skinless run: the same live ids,
    positions within 1e-4*dp, t within rtol 1e-5, no overflow."""
    got, ref = sharded["got"][name], sharded["refs"][name]
    assert got.nstep == SHARD_STEPS == ref.nstep
    assert got.overflow == 0 == ref.overflow
    gi, gp = by_id(got.st)
    ri, rp = by_id(ref.st)
    np.testing.assert_array_equal(gi, ri)
    dp = dict(nn=DP, channel=CHANNEL["dp"]).get(name, SHARD_GEOM["dp"])
    np.testing.assert_allclose(gp, rp, rtol=0, atol=1e-4 * dp)
    np.testing.assert_allclose(got.t_host, ref.t_host, rtol=1e-5)


def test_skinless_sharded_dambreak_matches_jax(sharded):
    got, jcarry = sharded["got"]["symplectic"], sharded["jax"]
    gi, gp = by_id(got.st)
    np.testing.assert_allclose(gp, np.asarray(jcarry.st.pos)[gi], rtol=0,
                               atol=1e-4 * SHARD_GEOM["dp"])
    np.testing.assert_allclose(got.t_host, float(jcarry.t), rtol=1e-5)


def test_skinless_sharded_rebuilds_and_exchanges(sharded):
    """Each step rebuilds (migration) and each interaction exchanges the
    ghost rows afresh, with no refresh in recorded slots; the channel's
    extrapolated outlet exchanges once more after the corrector; fluid
    ghost rows crossed the edge of every path."""
    per_step = dict(symplectic=2, verlet=1, nn=2, channel=3)
    for name, stats in sharded["stats"].items():
        for s in stats:
            assert s["nrebuild"] == 1 + SHARD_STEPS, name
            assert s["ghost_exchanges"] == per_step[name] * SHARD_STEPS, name
            assert s["refreshes"] == 0, name
            assert s["fluid_ghosts"] > 0, name
    assert sum(s["migrants"] for s in sharded["stats"]["symplectic"]) > 0
