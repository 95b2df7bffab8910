"""Domain decomposition (``parallel/sharding.py``) on the CPU: two ranks
over gloo, one process each, against the JAX package and against the
port's one-device runs.

* ``make_shard_cfg`` and ``shard_state`` against JAX's on its dry-run case
  (`sharding.py:1383`), exactly: host helpers, no JAX compile.
* The slice as a whole: 8 sharded symplectic steps of a 2D dam break
  with a rebuild at every step (cells of kernelsize * 1.0001), from a
  state whose fluid straddles the slab edge and flows across it, against
  the JAX package's single-device step (plain path) on the same state
  (in 2D: XLA's CPU threads spin through a 3D step), with
  ``tests/test_sharding.py``'s tolerances: positions by id within
  1e-4*dp, t within rtol 1e-5; particles migrated and fluid ghost rows
  were exchanged.
* Against the port's one-device step (held against JAX by the other
  files), 8 steps each (3 of the dry run), positions by id within 1e-4*dp and t within
  rtol 1e-5: Verlet, the dry run's scripted motion and damping zone
  (`sharding.py:1404-1431`), the 2D mDBC dam break (a 2-cell halo), the
  floating box (body centre within 1e-6 m and velocity within 1e-5 m/s,
  as `test_sharding.py:372-375`) and the NN wet dam break (kernels 4-6's
  plain passes, a 2-cell halo).  The mDBC and NN runs are also held
  against the JAX package's jitted single-device step (plain path) on the
  same state, with the same tolerances.
* The refusals; ``dsphtorch -cpu -shard:2`` against the unsharded CLI,
  its PARTs and, on a case XML with gauges that tick inside the save
  interval, its Gauge_*.csv; a rank that fails fails the run.

The ranks start once for all the step comparisons (``steps_together``),
each rank with one torch thread; each start carries a time limit.
"""

import dataclasses
import operator
import os
import types

import jax
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import nnewtonian as jNM
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import forces as jF
from dualsphysics_multilayer_tpu.parallel import sharding as jS
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import cli, convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.features import damping, motion
from dualsphysics_multilayer_tpu_torch.io import partdata as PD
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
from dualsphysics_multilayer_tpu_torch.parallel import group as G
from dualsphysics_multilayer_tpu_torch.parallel import sharding as S

# the fluid column straddles the 2-rank slab edge (x = 0.3094 m), its
# last column left of it 0.9 cm away: 297 particles
GEOM2 = dict(dp=0.025, tank=(0.6, 0.4), column=(0.5, 0.3))
# JAX's dry run (356 particles): its scripted wall and damping zone
DRYRUN = dict(dp=0.06, tank=(0.9, 0.3, 0.3), column=(0.3, 0.3, 0.2),
              obstacle=False)
NSTEPS = 8
# the dry run's 3D steps cost the plain path ten times a 2D step's; JAX's
# own dry run advances to 2e-4 s, about 2 steps
MOTION_STEPS = 3
LIMIT = 240.0        # seconds: each start of the ranks
FD = P.TpDensity.FOURTAKAS


def flowing(st, seed, speed=2.5, jitter=0.3, sim2d=False):
    """``st`` with its fluid flowing along x at ``speed`` plus a seeded
    jitter (m/s)."""
    rng = np.random.default_rng(seed)
    vel = torch.tensor(rng.normal(0.0, jitter, (st.n, 3)), dtype=torch.float32)
    vel[:, 0] += speed
    if sim2d:
        vel[:, 1] = 0.0
    return dataclasses.replace(st, vel=torch.where(
        td.is_fluid(st.code)[:, None], vel, st.vel))


def skinless(dom, csp):
    """``dom``'s extent in cells of kernelsize * 1.0001: the skin contract
    then breaks at every step, so every step rebuilds and migrates."""
    scell = csp.kernelsize * 1.0001
    hi = dom.posmax
    nc = tuple(max(1, int(np.ceil((hi[i] - dom.posmin[i]) / scell)))
               for i in range(3))
    return dataclasses.replace(dom, scell=scell,
                               nc=(nc[0], 1, nc[2]) if dom.simulate2d else nc)


def jax_arrays(case, seed):
    """The JAX case's state as numpy arrays, its fluid flowing."""
    st = case.state
    arrays = {k: np.asarray(getattr(st, k))
              for k in ("pos", "vel", "rho", "code", "idp")}
    flow = flowing(convert.simstate(arrays, device="cpu"), seed,
                   sim2d=True)
    arrays["vel"] = flow.vel.numpy()
    return arrays


def motion_case():
    """The dry run's featured path: the bound strip beyond x = 0.82 m a
    scripted wall moving at -0.05 m/s, a damping zone over 0.55-0.8 m."""
    case = cases.dambreak3d(**DRYRUN, device="cpu")
    st = case.state
    strip = td.is_bound(st.code) & (st.pos[:, 0] > 0.82)
    code = torch.where(strip, td.code_make(td.TYPE_MOVING, 9), st.code)
    feats = P.Features(
        motions=(motion.MotionDef(mk=9, segments=(motion.Segment(
            kind=motion.RECT, t0=0.0, t1=10.0, params=(-0.05, 0, 0)),)),),
        damping=(damping.DampingPlane(point=(0.55, 0.15, 0.15),
                                      limitpoint=(0.8, 0.15, 0.15)),))
    return case, dataclasses.replace(st, code=code), feats


MDBC2D = dict(dp=0.04, tank=(1.0, 0.6), column=(0.6, 0.4))
NN_DP = 0.05


def paths():
    """name: (csp, opts, dom, state, feats, phases) of each path held
    against the port's one-device step."""
    out = {}
    case = cases.dambreak2d(**GEOM2, need_verlet=True, device="cpu")
    out["verlet"] = (case.csp, P.SolverOpts(tstep=P.TpStep.VERLET,
                                            tdensity=FD),
                     case.dom, flowing(case.state, 1, sim2d=True), None,
                     None)
    case, st, feats = motion_case()
    out["motion"] = (case.csp, P.SolverOpts(tdensity=FD), case.dom, st,
                     feats, None)
    case = cases.dambreak2d(**MDBC2D, mdbc=True, device="cpu")
    out["mdbc2d"] = (case.csp, P.SolverOpts(
        tdensity=FD, tboundary=P.TpBoundary.MDBC,
        slipmode=P.TpSlipMode.VEL0), case.dom,
        flowing(case.state, 2, speed=1.0, jitter=0.05, sim2d=True),
        None, None)
    case = cases.floatingbox2d(dp=0.05, tank=(1.0, 0.6), water=0.3,
                               box=(0.2, 0.2), box_pos=(0.4, 0.2),
                               device="cpu")
    out["floating"] = (case.csp, P.SolverOpts(tdensity=FD,
                                              with_floating=True),
                       case.dom, flowing(case.state, 3, speed=1.0,
                                         jitter=0.05, sim2d=True),
                       P.Features(floating=case.meta["ftcfg"]), None)
    case, phases = NM.wet_dambreak_nn(dp=NN_DP, device="cpu")
    out["nn"] = (case.csp, P.SolverOpts(tvisco=P.TpVisco.LAMINAR_SPS,
                                        velgrad=P.TpVelGrad.SPH,
                                        tdensity=FD),
                 case.dom, flowing(case.state, 4, speed=0.5, jitter=0.05,
                                   sim2d=True), None, phases)
    return out


def jax_steps(name, st, nsteps):
    """The JAX package's jitted single-device steps of path ``name``
    ("mdbc2d" or "nn", the plain path) from the port's state ``st``,
    which holds the JAX case's particles in its order."""
    fd = jtd.TpDensity.FOURTAKAS
    if name == "mdbc2d":
        jcase = jcases.dambreak2d(**MDBC2D, mdbc=True)
        jopts = jF.SolverOpts(tdensity=fd, tboundary=jtd.TpBoundary.MDBC,
                              slipmode=jtd.TpSlipMode.VEL0, use_pallas=False)
        jstep = jW.make_step(jcase.csp, jopts, jcase.dom)
    else:
        jcase, jph = jNM.wet_dambreak_nn(dp=NN_DP)
        jopts = jF.SolverOpts(tvisco=jtd.TpVisco.LAMINAR_SPS,
                              velgrad=jtd.TpVelGrad.SPH, tdensity=fd,
                              use_pallas=False)
        jstep = jNM.make_nn_step(jcase.csp, jopts, jcase.dom, jph)
    for k in ("pos", "code", "idp"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jcase.state, k)))
    jstep = jax.jit(jstep)
    carry = jW.make_carry(dataclasses.replace(
        jcase.state, vel=jax.numpy.asarray(st.vel.numpy())), jcase.csp,
        jopts, dom=jcase.dom)
    for _ in range(nsteps):
        carry = jstep(carry)
    return carry


def jax_by_id(j):
    """(ids, pos) of a JAX carry's live particles, ordered by id."""
    live = np.asarray(jtd.is_active(j.st.code))
    jid = np.asarray(j.st.idp)[live]
    o = np.argsort(jid)
    return jid[o], np.asarray(j.st.pos)[live][o]


def nsteps_of(name):
    return MOTION_STEPS if name == "motion" else NSTEPS


def one_device(csp, opts, dom, st, feats, phases, nsteps):
    if phases is not None:
        step = NM.make_nn_step(csp, opts, dom, phases)
    else:
        step = P.make_step(csp, opts, dom, feats)
    carry = P.make_carry(st, csp, opts, dom, feats)
    for _ in range(nsteps):
        carry = step(carry)
    return carry


def by_id(st):
    """(ids, pos) of the live particles, ordered by id."""
    live = td.is_active(st.code) & ~td.is_periodic(st.code)
    idp, pos = st.idp[live], st.pos[live]
    o = torch.argsort(idp)
    return idp[o].numpy(), pos[o].numpy()


@pytest.fixture(scope="module")
def runs():
    """The sharded runs of every path, over one start of two ranks, and
    the references: JAX's steps for the main path, the port's one-device
    steps for the others."""
    jcase = jcases.dambreak2d(**GEOM2)
    arrays = jax_arrays(jcase, 0)
    jopts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jcase.dom))
    jcarry = jW.make_carry(dataclasses.replace(
        jcase.state, vel=jax.numpy.asarray(arrays["vel"])), jcase.csp, jopts,
        dom=jcase.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)
    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    dom = skinless(convert.domain(dataclasses.asdict(jcase.dom)), csp)
    st = convert.simstate(arrays, device="cpu")
    sims = {"main": S.ShardedSimulation(csp, P.SolverOpts(tdensity=FD), dom,
                                        st, ndev=2, device="cpu",
                                        limit=LIMIT, log=lambda *a: None)}
    refs, jrefs = {}, {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, (csp_, opts, dom_, st_, feats, phases) in paths().items():
            sims[name] = S.ShardedSimulation(
                csp_, opts, dom_, st_, feats=feats, ndev=2, phases=phases,
                device="cpu", limit=LIMIT, log=lambda *a: None)
            refs[name] = one_device(csp_, opts, dom_, st_, feats, phases,
                                    nsteps_of(name))
            if name in ("mdbc2d", "nn"):
                jrefs[name] = jax_steps(name, st_, nsteps_of(name))
        out = S.steps_together(list(sims.values()),
                               [[nsteps_of(k)] for k in sims])
    finally:
        torch.set_num_threads(threads)
    got = {name: carries[-1] for name, (carries, _) in zip(sims, out)}
    return dict(jax=jcarry, csp=csp, got=got, refs=refs, jrefs=jrefs,
                stats={k: s.stats for k, s in sims.items()},
                cfg={k: s.cfg for k, s in sims.items()})


@pytest.mark.parametrize("ndev", [2, 3])
def test_shard_cfg_and_state_match_jax(ndev):
    jcase = jcases.dambreak3d(**DRYRUN)
    jcfg = jS.make_shard_cfg(jcase.dom, ndev, jcase.state.n)
    jst = jS.shard_state(jcfg, jcase.state)
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    st = convert.simstate({k: np.asarray(getattr(jcase.state, k))
                           for k in ("pos", "vel", "rho", "code", "idp")},
                          device="cpu")
    cfg = S.make_shard_cfg(dom, ndev, st.n)
    for k in ("ndev", "n_local", "mig_cap", "ghost_cap", "halo",
              "ncx_loc", "n_ext"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    for d, jd in ((cfg.gdom, jcfg.gdom), (cfg.ldom, jcfg.ldom)):
        assert d.nc == tuple(jd.nc) and d.scell == jd.scell
        assert d.posmin == tuple(jd.posmin)
    sh = S.shard_state(cfg, st)
    for k in ("pos", "vel", "rho", "idp"):
        np.testing.assert_array_equal(getattr(sh, k).numpy(),
                                      np.asarray(getattr(jst, k)), k)
    np.testing.assert_array_equal(sh.code.numpy(),
                                  np.asarray(jst.code).astype(np.int32))
    # each shard's rows by id, and the owner of each by its x-cell
    live = td.is_active(sh.code).numpy()
    for r in range(ndev):
        rows = slice(r * cfg.n_local, (r + 1) * cfg.n_local)
        x = sh.pos.numpy()[rows][live[rows], 0]
        owner = np.floor((x - dom.posmin[0]) / dom.scell) // cfg.ncx_loc
        assert np.all(np.clip(owner, 0, ndev - 1) == r)
    assert live.sum() == st.n


def test_sharded_steps_match_jax(runs):
    """The slice as a whole: migration, halo rows and the MAX reductions
    under a rebuild at every step, against JAX's single-device step."""
    got, j, csp = runs["got"]["main"], runs["jax"], runs["csp"]
    assert got.nstep == NSTEPS == int(j.nstep)
    assert got.overflow == 0 == int(j.overflow)
    assert got.nrebuild == NSTEPS + 1        # the first divide and each step
    np.testing.assert_allclose(got.t_host, float(j.t), rtol=1e-5)
    idp, pos = by_id(got.st)
    jid, jpos = jax_by_id(j)
    np.testing.assert_array_equal(idp, jid)
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-4 * csp.dp)


def test_particles_migrate_and_fluid_ghosts_cross(runs):
    stats = runs["stats"]["main"]
    assert sum(s["migrants"] for s in stats) > 0
    assert all(s["fluid_ghosts"] > 0 for s in stats)
    # a refresh before each of a step's two interactions, on every rank
    assert all(s["refreshes"] == 2 * NSTEPS for s in stats)
    # CPU tensors never reach a kernel
    assert all(s[k] == 0 for s in stats for k in S._launches())


@pytest.mark.parametrize("name", ["verlet", "motion", "mdbc2d", "floating",
                                  "nn"])
def test_sharded_path_matches_one_device(runs, name):
    got, ref = runs["got"][name], runs["refs"][name]
    cfg = runs["cfg"][name]
    assert cfg.halo == (2 if name in ("mdbc2d", "nn") else 1)
    assert got.nstep == ref.nstep == nsteps_of(name)
    assert got.overflow == 0 == ref.overflow
    np.testing.assert_allclose(got.t_host, ref.t_host, rtol=1e-5)
    idp, pos = by_id(got.st)
    rid, rpos = by_id(ref.st)
    np.testing.assert_array_equal(idp, rid)
    dp = {"verlet": GEOM2["dp"], "motion": DRYRUN["dp"], "mdbc2d": 0.04,
          "floating": 0.05, "nn": 0.05}[name]
    np.testing.assert_allclose(pos, rpos, rtol=0, atol=1e-4 * dp)
    if name in runs["jrefs"]:
        # the sharded run against the JAX package's single-device step
        j = runs["jrefs"][name]
        assert int(j.nstep) == got.nstep and int(j.overflow) == 0
        np.testing.assert_allclose(got.t_host, float(j.t), rtol=1e-5)
        jid, jpos = jax_by_id(j)
        np.testing.assert_array_equal(idp, jid)
        np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-4 * dp)
    if name == "floating":
        for k, tol in (("center", 1e-6), ("fvel", 1e-5)):
            np.testing.assert_allclose(getattr(got.st.ft, k).numpy(),
                                       getattr(ref.st.ft, k).numpy(),
                                       rtol=0, atol=tol)
        assert float(ref.st.ft.fvel.abs().max()) > 1e-5
    if name == "motion":
        # the wall moved and the damping zone slowed the fluid in it
        moving = td.is_moving(got.st.code)
        assert torch.allclose(got.st.vel[moving][:, 0],
                              torch.tensor(-0.05))
    stats = runs["stats"][name]
    assert sum(s["ghost_rows"] for s in stats) > 0
    # the collectives of each rank's job: a refresh before each
    # interaction (two under mDBC), one MAX of the dt maxima per
    # interaction, one of [rebuild flag, overflow] per step and at the
    # start, one SUM of the bodies' sums per rigid update, the migration
    # and ghost exchanges of each rebuild, and the gather at the mark
    for s in stats:
        interactions = s["nstep"] * (1 if name == "verlet" else 2)
        assert s["refreshes"] == interactions * (2 if name == "mdbc2d"
                                                 else 1)
        assert s["collectives"] == (
            s["refreshes"] + interactions + s["nstep"] + 1
            + (interactions if name == "floating" else 0)
            + 2 * s["nrebuild"] + 1)


def test_refusals():
    case = cases.dambreak2d(dp=0.1, device="cpu")
    args = (case.csp, P.SolverOpts(), case.dom, case.state)
    from dualsphysics_multilayer_tpu_torch.features import periodic
    per = lambda axes: periodic.PeriodicCfg(axes=axes, lo=(0, 0, 0),
                                            hi=(1, 1, 1), ghost_cap=8)
    with pytest.raises(NotImplementedError, match="x-periodic conflicts"):
        S.ShardedSimulation(*args, P.Features(periodic=per((True, False,
                                                            False))),
                            ndev=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Features.awas"):
        S.ShardedSimulation(*args, P.Features(awas=(object(),)), ndev=2,
                            device="cpu")
    # z-periodic boundaries, inlet/outlet zones and DEM contact now start
    from dualsphysics_multilayer_tpu_torch.features import dem
    channel = cases.channel2d(dp=0.05, device="cpu")
    stub = types.SimpleNamespace(mass=(5.0,), massp=(0.5,))
    props = dict(young=1e6, poisson=0.3, kfric=0.45, restitu=0.2)
    for feats, st in (
            (P.Features(periodic=per((False, False, True))), case.state),
            (P.Features(dem=dem.make_dem(case.csp, case.state.code, stub,
                                         float_props=[props])), case.state)):
        sim = S.ShardedSimulation(case.csp, P.SolverOpts(), case.dom, st,
                                  feats, ndev=2, device="cpu")
        assert sim.cfg.halo == 1
    sim = S.ShardedSimulation(channel.csp, P.SolverOpts(), channel.dom,
                              channel.state,
                              P.Features(inout=channel.meta["inout"]),
                              ndev=2, device="cpu")
    # the halo reaches the zones' bands (3 layers of dp) in cells
    assert sim.cfg.halo == int(np.ceil(3 * 0.05 / channel.dom.scell))
    # no count on the CPU: one rank, as JAX's CPU backend has one device
    assert S.ShardedSimulation(*args, device="cpu").cfg.ndev == 1
    with pytest.raises(ValueError, match="halo=2"):
        S.make_sharded_step_nn(S.make_shard_cfg(case.dom, 2, 10), case.csp,
                               P.SolverOpts(), None, None)


def test_shared_card_needs_gloo(monkeypatch):
    """Two ranks on one card: NCCL cannot run them, so the plan raises
    unless the caller asks for gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        G.plan(2, "cuda")
    with pytest.raises(ValueError, match="NCCL cannot"):
        G.plan(2, "cuda", "nccl")
    devices, backend = G.plan(2, "cuda", "gloo")
    assert [str(d) for d in devices] == ["cuda:0", "cuda:0"]
    assert backend == "gloo"
    assert G.plan(1, "cuda")[1] == "nccl"
    assert G.plan(2, "cpu")[1] == "gloo"


class _FailsOnRank1(tuple):
    """Arguments that rank 0 takes as they are and that raise where a
    spawned rank loads them."""

    def __reduce__(self):
        return (operator.truediv, (1, 0))


def test_cli_shard_matches_unsharded(tmp_path):
    """``dsphtorch -cpu -shard:2`` writes the unsharded run's PARTs, equal
    by id within 1e-4*dp; a rank that fails fails the run."""
    dp = 0.1
    argv = ["-cpu", "-builtin", "dambreak2d", "-dp", str(dp), "-tmax:0.006",
            "-tout:0.003", "-sv:binx", "-nortimes"]
    one, two = tmp_path / "one", tmp_path / "two"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # the spawned rank takes this process's
    try:
        assert cli.main(argv + ["-dirout", str(one)]) == 0
        assert cli.main(argv + ["-shard:2", "-dirout", str(two)]) == 0
    finally:
        torch.set_num_threads(threads)
    names = sorted(f for f in os.listdir(one) if f.endswith(".bi4"))
    assert names == sorted(f for f in os.listdir(two)
                           if f.endswith(".bi4")) and len(names) == 3
    for f in names:
        a, b = PD.read_part(one / f), PD.read_part(two / f)
        np.testing.assert_array_equal(a["idp"], b["idp"])
        assert a["timestep"] == pytest.approx(b["timestep"], rel=1e-5)
        np.testing.assert_allclose(b["pos"], a["pos"], rtol=0,
                                   atol=1e-4 * dp)
    case = cases.dambreak2d(dp=0.1, device="cpu")
    sim = S.ShardedSimulation(case.csp, P.SolverOpts(), case.dom, case.state,
                              ndev=2, device="cpu")
    job = (_FailsOnRank1(sim._args()), dict(kind="steps", marks=(1,)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(RuntimeError,
                           match="(?s)a rank failed.*ZeroDivision"):
            G.launch(S._rank_jobs, 2, ([job],), device="cpu", limit=LIMIT,
                     timeout=30.0, log=lambda *a: None)
    finally:
        torch.set_num_threads(threads)


def test_cli_shard_gauges_on_subticks(tmp_path):
    """A case XML with gauges that tick inside the save interval
    (``<computedt>``): under ``-cpu -shard:2`` the ranks stop together at
    each tick (rank 0's next tick broadcast) and the gauges read the
    gathered state, writing the unsharded run's Gauge_*.csv."""
    from test_torch_xmlcase import write_case
    path = write_case(tmp_path, "gauges")
    argv = ["-cpu", "-case", str(path), "-tmax:0.06", "-tout:0.03",
            "-nortimes"]
    one, two = tmp_path / "one", tmp_path / "two"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(argv + ["-dirout", str(one)]) == 0
        assert cli.main(argv + ["-shard:2", "-dirout", str(two)]) == 0
    finally:
        torch.set_num_threads(threads)
    gauges = sorted(f for f in os.listdir(one) if f.startswith("Gauge_"))
    assert len(gauges) == 5
    for f in gauges:
        assert (one / f).read_text() == (two / f).read_text(), f
