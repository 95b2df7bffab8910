"""The open boundaries and DEM under domain decomposition
(``parallel/sharding.py``) on the CPU: two ranks over gloo, one process
each, against the port's one-device runs.

* One start of the ranks (``steps_together``) runs four jobs, each to the
  one-device run's step count at its time, with JAX's own sharded-vs-
  single tolerances (``tests/test_sharding.py``):
  - ``channel2d(dp=0.02, length=0.5, height=0.16, vel=0.4)`` to t = 5e-3
    (`:758-802`), symplectic and Verlet: the same steps and t, overflow
    0, the live fluid count within 2 and its centre of mass within
    2e-3*dp, every live id unique; the inlet's spawns land on rank 0 with
    ids of its share of the free pool, the ids the one-device run gives;
    once more with a free pool of 12 ids and the zone planes moved
    (:func:`recycle_job`), so that the inlet's second spawns need the ids
    of particles that left through the outlet on rank 1;
  - the DEM dry tank with one box dropped at -2 m/s across the slab edge
    (`tests/test_dem.py:96`, dp 0.025) to 5e-3 (`:720-755`): body centre
    within 1e-6 m, velocity within 1e-5 m/s, positions by id within
    1e-4*dp;
  - the y-periodic slab of `:513-575` at dp 0.05 to 2e-3 s, its fluid
    flowing along +y at 0.5 m/s with a seeded jitter and the periodic box
    shifted so that the last lattice row sits 0.3 mm below its edge (the
    predictor carries it across, so the corrector's interaction wraps it
    and images the halo rows): positions by id within 1e-4*dp of the
    port's one-device step and of the JAX package's jitted single-device
    periodic step (plain path) on the same state;
  - chip_smoke.py's y-periodic duct with an inlet (calculated zsurf,
    AWAS) and an extrapolated outlet at dp 0.02 to 2.5e-3 s (2 steps,
    the inlet's 16 spawns in the first): the inlet/outlet pass reads the
    periodic images of the rank's own and halo rows and reduces the zsurf
    and the AWAS column over the ranks; the same live ids and spawns,
    positions by id within 1e-4*dp and density rtol 1e-5 of the
    one-device run.
* Unit tests that start no rank: the periodic pass keeps and images a
  rank's halo rows; the id ranks ignore dead and duplicate ids; the
  calculated zsurf and the AWAS column mass of a state split in two,
  reduced through a callback, equal the whole state's; the free pool's
  ids go to the ranks without repeats, and a rank's dead slots carry its
  share; the pool's sharing at a rebuild brings the ids of particles
  that died on rank 1 to rank 0, which spawned; the advanced refilling on
  a rank fills only its own slab's holes.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.features import dem as DEM
from dualsphysics_multilayer_tpu_torch.features import floating as FT
from dualsphysics_multilayer_tpu_torch.features import inout as IO
from dualsphysics_multilayer_tpu_torch.features import periodic as PER
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.parallel import sharding as S

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
import chip_smoke  # noqa: E402

LIMIT = 240.0        # seconds: the start of the ranks
CHANNEL = dict(dp=0.02, length=0.5, height=0.16, vel=0.4)
RECYCLE_POOL = 12    # free ids: one inlet column of 9 and 3 more
PROPS = dict(young=1e6, poisson=0.3, kfric=0.45, restitu=0.2)   # test_dem.py
PER_DP = 0.05
# the periodic box of test_sharding.py:530 (period 0.4 m) moved down
# 0.0497 m: the lattice's last row (y = 0.35) sits 0.3 mm below its edge
PER_LO, PER_HI = -0.0497, 0.3503
DUCT_DP = 0.02


def channel_job(verlet=False, device="cpu"):
    """(csp, opts, dom, state, feats, tmax) of the channel."""
    case = cases.channel2d(**CHANNEL, device=device)
    st = case.state
    opts = P.SolverOpts(tdensity=P.TpDensity.MOLTENI)
    if verlet:
        st = dataclasses.replace(st, velm1=st.vel.clone(),
                                 rhom1=st.rho.clone())
        opts = dataclasses.replace(opts, tstep=P.TpStep.VERLET)
    return (case.csp, opts, case.dom, st,
            P.Features(inout=case.meta["inout"]), 5e-3)


def recycle_job(device="cpu"):
    """The channel with a free pool of ``RECYCLE_POOL`` ids and its zone
    planes moved: the inlet's first column (9 rows) sits 0.9 dp past its
    plane and crosses at the first step, its second 0.1 dp behind it and
    crosses at the fourth; the outlet's back column sits 0.001 dp inside
    its zone and leaves at the first step.  The second column's spawns so
    need 6 ids of the outlet's dead, which die on rank 1 and reach rank 0
    only through the pool's sharing at a rebuild between."""
    csp, opts, dom, st, feats, _ = channel_job(device=device)
    dp = CHANNEL["dp"]
    live = int(td.is_active(st.code).sum())
    # the free slots are the state's last, holding its highest ids
    st = st.permuted(torch.arange(live + RECYCLE_POOL, device=st.pos.device))
    inlet, outlet = feats.inout.zones
    zones = (dataclasses.replace(inlet, p0=(-0.9 * dp,) + inlet.p0[1:]),
             dataclasses.replace(outlet, p0=(outlet.p0[0] - 0.999 * dp,)
                                 + outlet.p0[1:]))
    return (csp, opts, dom, st, P.Features(inout=dataclasses.replace(
        feats.inout, zones=zones)), 7e-3)


def dem_job(device="cpu"):
    """``tests/test_dem.py:_dry_tank_with_boxes`` with one box, dropped at
    -2 m/s (``tests/test_sharding.py:720-755``), built by the port."""
    dp = 0.025
    csp = td.make_ctesph(simulate2d=True, dp=dp, speedsound=20.0, visco=0.05)
    d = cases.Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (1.0, 0, 1.0), ptype=td.TYPE_FIXED, mk=0,
          faces="bottom|left|right")
    d.box((0.4, 0, 0.15), (0.6, 0, 0.35), ptype=td.TYPE_FLOATING, mk=0)
    pos, code = d.build()
    isft = td.code_type(code) == td.TYPE_FLOATING
    ftcfg, ftst = FT.make_floating([pos[isft]], [800.0], csp, device=device)
    st = cases._make_state(csp, pos, code, zsurf=0.0, device=device)
    drop = torch.tensor([0.0, 0.0, -2.0], device=st.pos.device)
    st = dataclasses.replace(
        st, vel=torch.where(td.is_floating(st.code)[:, None], drop, st.vel),
        ft=dataclasses.replace(ftst, fvel=drop[None, :].clone()))
    feats = P.Features(floating=ftcfg, dem=DEM.make_dem(
        csp, st.code, ftcfg, float_props=[PROPS], idp=st.idp))
    return (csp, P.SolverOpts(tdensity=P.TpDensity.NONE, with_floating=True),
            cases._make_domain(csp, pos), st, feats, 5e-3)


def periodic_slab(draw_cls, types, dp=PER_DP):
    """The drawn (pos, code) of ``tests/test_sharding.py:513-575``'s slab:
    water over a floor, open in y, walls in x (either package's Draw)."""
    d = draw_cls(dp=dp, simulate2d=False)
    d.box((0, 0, 0), (0.9 - dp, 0.4 - dp, 0.2), ptype=types.TYPE_FLUID,
          mk=0)
    d.box((-3 * dp, 0, -3 * dp), (0.9 + 2 * dp, 0.4 - dp, -dp),
          ptype=types.TYPE_FIXED, mk=0, faces="solid")
    d.box((-3 * dp, 0, 0), (-dp, 0.4 - dp, 0.4),
          ptype=types.TYPE_FIXED, mk=0, faces="solid")
    d.box((0.9, 0, 0), (0.9 + 2 * dp, 0.4 - dp, 0.4),
          ptype=types.TYPE_FIXED, mk=0, faces="solid")
    return d.build()


def flowing_y(code, seed=7):
    """(n, 3) velocities: the fluid along +y at 0.5 m/s with a seeded
    jitter of 0.05 m/s, the rest at rest."""
    rng = np.random.default_rng(seed)
    vel = rng.normal(0.0, 0.05, (len(code), 3)).astype(np.float32)
    vel[:, 1] += 0.5
    fluid = np.asarray(td.code_type(code)) == td.TYPE_FLUID
    return np.where(fluid[:, None], vel, 0.0).astype(np.float32)


def periodic_job(device="cpu"):
    """The slab in the port, its periodic box at (PER_LO, PER_HI) with
    1024 ghosts a side (the JAX test's), the fluid flowing along +y; the
    port keeps its ghost rows out of the state, so it has no ghost tail."""
    pos, code = periodic_slab(cases.Draw, td)
    csp = td.make_ctesph(simulate2d=False, dp=PER_DP, hswl=0.2, coefh=1.0,
                         visco=0.05, coefsound=20.0)
    st = cases._make_state(csp, pos, code, zsurf=0.2, device=device)
    st = dataclasses.replace(st, vel=torch.tensor(
        flowing_y(code), device=st.pos.device))
    feats = P.Features(periodic=PER.PeriodicCfg(
        axes=(False, True, False), lo=(0, PER_LO, 0), hi=(0, PER_HI, 0),
        ghost_cap=1024))
    return (csp, P.SolverOpts(tdensity=P.TpDensity.FOURTAKAS),
            cases._make_domain(csp, pos, headroom=2.0), st, feats, 2e-3)


def jax_periodic_steps(st, nsteps):
    """The JAX package's jitted single-device periodic step (plain path)
    on its own slab, which must hold the port's state ``st`` (positions,
    codes and ids; its ghost tail beyond), from ``st``'s velocities."""
    import jax
    from dualsphysics_multilayer_tpu import typesdef as jtd
    from dualsphysics_multilayer_tpu.features import periodic as jPER
    from dualsphysics_multilayer_tpu.features.featureset import Features
    from dualsphysics_multilayer_tpu.models import cases as jcases
    from dualsphysics_multilayer_tpu.models import wcsph as jW
    from dualsphysics_multilayer_tpu.ops import forces as jF
    pos, code = periodic_slab(jcases.Draw, jtd)
    csp = jtd.make_ctesph(simulate2d=False, dp=PER_DP, hswl=0.2, coefh=1.0,
                          visco=0.05, coefsound=20.0)
    pcfg = jPER.PeriodicCfg(axes=(False, True, False), lo=(0, PER_LO, 0),
                            hi=(0, PER_HI, 0), ghost_cap=1024)
    cap = pos.shape[0] + jPER.ghost_slots_required(pcfg)
    dom = jcases._make_domain(csp, pos, headroom=2.0)
    jst = jcases._make_state(csp, pos, code, zsurf=0.2, capacity=cap)
    n = st.n
    for k in ("pos", "code", "idp"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jst, k))[:n])
    vel = np.zeros((cap, 3), np.float32)
    vel[:n] = st.vel.numpy()
    opts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    feats = Features(periodic=pcfg)
    step = jax.jit(jW.make_step(csp, opts, dom, feats))
    carry = jW.make_carry(dataclasses.replace(jst, vel=jax.numpy.asarray(vel)),
                          csp, opts, feats, dom=dom)
    for _ in range(nsteps):
        carry = step(carry)
    return carry


def duct_job(device="cpu"):
    """chip_smoke.py's y-periodic duct with its inlet and outlet zones."""
    csp, dom, st, feats, _ = chip_smoke.periodic_duct(DUCT_DP, device)
    return (csp, P.SolverOpts(tdensity=P.TpDensity.FOURTAKAS), dom, st,
            feats, 2.5e-3)


def one_device(csp, opts, dom, st, feats, tmax):
    step = P.make_step(csp, opts, dom, feats)
    carry = P.make_carry(st, csp, opts, dom, feats)
    while carry.t_host < np.float32(tmax):
        carry = step(carry)
    return carry


def owned(st):
    """Live rows that are not ghost rows."""
    return td.is_active(st.code) & ~td.is_periodic(st.code)


def by_id(st):
    m = owned(st)
    idp, pos = st.idp[m], st.pos[m]
    o = torch.argsort(idp)
    return idp[o].numpy(), pos[o].numpy()


@pytest.fixture(scope="module")
def runs():
    """Every job's sharded run over one start of two ranks, its
    one-device run, and JAX's periodic steps."""
    jobs = {"channel": channel_job(), "channel-verlet": channel_job(True),
            "channel-recycle": recycle_job(), "dem": dem_job(),
            "yperiodic": periodic_job(), "duct": duct_job()}
    refs, sims = {}, {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, (csp, opts, dom, st, feats, tmax) in jobs.items():
            refs[name] = one_device(csp, opts, dom, st, feats, tmax)
            sims[name] = S.ShardedSimulation(
                csp, opts, dom, st, feats=feats, ndev=2, device="cpu",
                limit=LIMIT, log=lambda *a: None)
        out = S.steps_together(list(sims.values()),
                               [[refs[k].nstep] for k in sims])
    finally:
        torch.set_num_threads(threads)
    jref = jax_periodic_steps(jobs["yperiodic"][3], refs["yperiodic"].nstep)
    return dict(jobs=jobs, refs=refs, jax=jref, sims=sims,
                got={k: carries[-1] for k, (carries, _) in zip(sims, out)})


def check_common(runs, name):
    got, ref = runs["got"][name], runs["refs"][name]
    assert got.nstep == ref.nstep > 0
    assert got.overflow == 0 == ref.overflow
    np.testing.assert_allclose(got.t_host, ref.t_host, rtol=1e-5)
    return got, ref


@pytest.mark.parametrize("name", ["channel", "channel-verlet",
                                  "channel-recycle"])
def test_sharded_channel_matches_one_device(runs, name):
    got, ref = check_common(runs, name)
    dp = CHANNEL["dp"]

    def fluid(st):
        m = owned(st) & td.is_fluid(st.code)
        return int(m.sum()), st.pos[m].double().mean(dim=0).numpy()

    n1, com1 = fluid(ref.st)
    n2, com2 = fluid(got.st)
    assert abs(n1 - n2) <= 2, (n1, n2)
    np.testing.assert_allclose(com2, com1, rtol=0, atol=2e-3 * dp)
    ids = got.st.idp[owned(got.st)]
    assert len(torch.unique(ids)) == len(ids)
    # the inlet's spawns: on rank 0, with ids of its share of the pool
    sim = runs["sims"][name]
    st0 = runs["jobs"][name][3]
    spawned = np.setdiff1d(ids.numpy(), st0.idp[owned(st0)].numpy())
    assert len(spawned) > 0
    pool = S.spare_ids(sim.cfg, st0, sim.feats)
    assert np.isin(spawned, pool[0]).all() and len(pool[1]) == 0
    m = np.isin(got.st.idp.numpy(), spawned)
    assert (S._owner(sim.cfg, got.st.pos[m, 0]) == 0).all()
    # rank 0 holds the whole pool in id order: the one-device run's ids
    np.testing.assert_array_equal(np.sort(ids.numpy()),
                                  np.sort(ref.st.idp[owned(ref.st)].numpy()))
    if name == "channel-recycle":
        # more spawns than the pool held at the start: ids of the outlet's
        # dead came back to rank 0 through the pool
        inlet = ((td.code_inout(got.st.code) == 1) & owned(got.st)).numpy()
        outlet0 = st0.idp[(td.code_inout(st0.code) == 2) & owned(st0)]
        back = np.isin(got.st.idp.numpy(), outlet0.numpy()) & inlet
        # two columns of 9 spawned, at least 6 of them with such ids
        assert len(spawned) + int(back.sum()) == 2 * 9
        assert int(back.sum()) >= 2 * 9 - RECYCLE_POOL
        assert (S._owner(sim.cfg, got.st.pos[back, 0]) == 0).all()


def test_sharded_dem_matches_one_device(runs):
    got, ref = check_common(runs, "dem")
    sim = runs["sims"]["dem"]
    st0 = runs["jobs"]["dem"][3]
    box = td.is_floating(st0.code)
    assert set(S._owner(sim.cfg, st0.pos[box, 0]).tolist()) == {0, 1}
    for k, tol in (("center", 1e-6), ("fvel", 1e-5)):
        np.testing.assert_allclose(getattr(got.st.ft, k).numpy(),
                                   getattr(ref.st.ft, k).numpy(),
                                   rtol=0, atol=tol)
    # the box fell on, and the contact then acted
    assert float(ref.st.ft.fvel[0, 2]) != -2.0
    # the fluid, the walls and the box row by row
    idp, pos = by_id(got.st)
    rid, rpos = by_id(ref.st)
    np.testing.assert_array_equal(idp, rid)
    np.testing.assert_allclose(pos, rpos, rtol=0, atol=1e-4 * 0.025)


def test_sharded_yperiodic_matches_one_device_and_jax(runs):
    got, ref = check_common(runs, "yperiodic")
    idp, pos = by_id(got.st)
    rid, rpos = by_id(ref.st)
    np.testing.assert_array_equal(idp, rid)
    np.testing.assert_allclose(pos, rpos, rtol=0, atol=1e-4 * PER_DP)
    # the predictor carried the last row across the periodic edge
    assert (rpos[:, 1] >= PER_HI).sum() > 0
    j = runs["jax"]
    assert int(j.nstep) == got.nstep and int(j.overflow) == 0
    code = np.asarray(j.st.code).astype(np.int64)
    sp = (code >> td.CODE_SPECIAL_SHIFT) & td.CODE_SPECIAL_MASK
    live = (sp < td.SPECIAL_OUT_POS) & (sp != td.SPECIAL_PERIODIC)
    jid = np.asarray(j.st.idp)[live]
    o = np.argsort(jid)
    np.testing.assert_array_equal(idp, jid[o])
    np.testing.assert_allclose(pos, np.asarray(j.st.pos)[live][o], rtol=0,
                               atol=1e-4 * PER_DP)
    np.testing.assert_allclose(got.t_host, float(j.t), rtol=1e-5)


def test_sharded_periodic_duct_with_zones_matches_one_device(runs):
    got, ref = check_common(runs, "duct")
    assert got.nstep == 2
    idp, pos = by_id(got.st)
    rid, rpos = by_id(ref.st)
    np.testing.assert_array_equal(idp, rid)
    np.testing.assert_allclose(pos, rpos, rtol=0, atol=1e-4 * DUCT_DP)

    def rho(st):
        m = owned(st)
        return st.rho[m][torch.argsort(st.idp[m])].numpy()

    np.testing.assert_allclose(rho(got.st), rho(ref.st), rtol=1e-5)
    st0 = runs["jobs"]["duct"][3]
    assert len(np.setdiff1d(rid, st0.idp[owned(st0)].numpy())) == 16
    # both ranks hold members of a zone: the inlet's on rank 0, the
    # outlet's on rank 1
    sim = runs["sims"]["duct"]
    for tag, rank in ((1, 0), (2, 1)):
        m = (td.code_inout(got.st.code) == tag) & owned(got.st)
        assert m.any() and (S._owner(sim.cfg, got.st.pos[m, 0])
                            == rank).all()


# ---------------------------------------------------------------------------
# units: no rank is started
# ---------------------------------------------------------------------------

def tiny_rank_state():
    """Twelve rows of a rank in 2D y-less x-z space, made 3D: owned fluid
    rows, two halo rows (periodic-coded, ids of another rank) and dead
    slots sharing id -1 or 0."""
    csp = td.make_ctesph(simulate2d=False, dp=0.05, hswl=0.2, coefh=1.0,
                         visco=0.05, coefsound=20.0)
    fluid = td.code_make(td.TYPE_FLUID, 0)
    halo = td.code_set_special(fluid, td.SPECIAL_PERIODIC)
    dead = td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE)
    y = [0.01, 0.02, 0.2, 0.39, 0.38, 0.03, 0.395, 0.2, -1e6, -1e6, -1e6,
         -1e6]
    code = [fluid] * 6 + [halo, halo] + [dead] * 4
    idp = [5, 1, 9, 3, 7, 2, 10, 11, 0, 0, -1, -1]
    pos = torch.tensor([[0.1 * i, yy, 0.1] for i, yy in enumerate(y)],
                       dtype=torch.float32)
    st = P.SimState(pos=pos, vel=torch.zeros_like(pos),
                    rho=torch.full((12,), 1000.0), code=torch.tensor(
                        code, dtype=torch.int32), idp=torch.tensor(idp),
                    pose=torch.zeros_like(pos))
    return csp, st


def test_ghost_rows_keep_and_image_halo_rows():
    csp, st = tiny_rank_state()
    cfg = PER.PeriodicCfg(axes=(False, True, False), lo=(0, 0.0, 0),
                          hi=(0, 0.4, 0), ghost_cap=8)
    n = st.n
    rows, ov, origin = PER._ghost_rows(cfg, csp, st, halo=True)
    assert int(ov) == 0
    code = rows["code"]
    # the halo rows stay live in place, and are imaged with the owned ones
    assert torch.equal(code[:n], st.code)
    ghost = torch.arange(code.shape[0]) >= n
    imaged = origin[ghost & td.is_active(code)]
    near = [i for i in range(8) if st.pos[i, 1] < csp.kernelsize
            or st.pos[i, 1] >= 0.4 - csp.kernelsize]
    assert sorted(imaged.tolist()) == near and 6 in near
    # each image sits one period from its origin, in id order per side
    live = ghost & td.is_active(code)
    dy = rows["pos"][live, 1] - st.pos[origin[live], 1]
    assert torch.allclose(dy.abs(), torch.tensor(0.4))
    up = origin[live][dy > 0]
    assert st.idp[up].tolist() == sorted(st.idp[up].tolist())
    # one-device: periodic-coded rows are stale ghosts and die
    rows1, _ = PER.ghost_rows(cfg, csp, st)
    assert not td.is_active(rows1["code"][6:8]).any()


def test_id_ranks_ignore_dead_and_duplicate_ids():
    idp = torch.tensor([5, 1, 9, 0, 0, 0, -1, 3, 0])
    mask = torch.tensor([True, True, True, False, True, False, False, True,
                         False])
    rank = PER._id_rank(mask, idp, 12)
    # among ids 5, 1, 9, 0, 3: 0 -> 0, 1 -> 1, 3 -> 2, 5 -> 3, 9 -> 4; the
    # unmasked rows sharing id 0 leave row 4's rank alone
    assert rank[mask].tolist() == [3, 1, 4, 0, 2]


def test_zsurf_and_awas_sums_of_a_split_state():
    """The calculated zsurf and the AWAS column mass of two halves of a
    state, reduced through callbacks (a MAX and a SUM of what each half
    hands them, as the ranks' collectives do), equal the whole state's;
    a halo row in one half counts nowhere."""
    case = cases.dambreak2d(dp=0.05, tank=(1.0, 0.6), column=(0.6, 0.4),
                            device="cpu")
    csp, st = case.csp, case.state
    # a surface that rises along x, so each half has its own highest row
    fluid = td.is_fluid(st.code)
    st = dataclasses.replace(st, pos=st.pos + torch.where(
        fluid[:, None], torch.tensor([0.0, 0.0, 0.2]) * st.pos[:, :1], 0.0))
    zone = IO.InOutZone(p0=(0.3, 0.0, 0.5), direction=(1, 0, 0), layers=3,
                        tangent1=(0, 0, 1), size1=4.0, zsurf_calc=True)
    aw = IO.InOutAwas(depth=1.5, zsurf_t=(0.0, 1.0), zsurf_v=(1.0, 1.0),
                      gauge_x=0.45, z0=0.0, band=0.1)
    tabs = torch.tensor(0.5)
    whole_z = IO._zsurf_at(zone, csp, tabs, st)
    whole_c = IO._awas_velcorr(aw, csp, st.pos, st.code, tabs)
    dead = td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE)
    # the halves meet inside the zone's band and the gauge's
    left = st.pos[:, 0] < 0.45
    halves = [dataclasses.replace(st, code=torch.where(m, st.code, dead))
              for m in (left, ~left)]
    # a copy of the left half's highest fluid row in the band as a halo
    # row of the right half
    i = int(torch.nonzero(left & td.is_fluid(st.code)
                          & (st.pos[:, 0] > 0.3))[-1])
    right = halves[1]
    halves[1] = dataclasses.replace(right, code=right.code.index_put(
        (torch.tensor([i]),), td.code_set_special(st.code[i:i + 1],
                                                  td.SPECIAL_PERIODIC)))
    seen = {"z": [], "m": []}

    def collect(key):
        return lambda x: seen[key].append(x) or x

    for h in halves:
        IO._zsurf_at(zone, csp, tabs, h, reduce_max=collect("z"))
        IO._awas_velcorr(aw, csp, h.pos, h.code, tabs,
                         reduce_sum=collect("m"))
    assert len(seen["z"]) == len(seen["m"]) == 2
    assert float(seen["z"][0]) != float(seen["z"][1])
    assert all(float(m) > 0 for m in seen["m"])
    for h in halves:
        z = IO._zsurf_at(zone, csp, tabs, h,
                         reduce_max=lambda x: torch.stack(seen["z"]).amax())
        c = IO._awas_velcorr(aw, csp, h.pos, h.code, tabs,
                             reduce_sum=lambda x: sum(seen["m"]))
        assert float(z) == float(whole_z)
        np.testing.assert_allclose(float(c), float(whole_c), rtol=1e-6)


def test_spare_ids_go_to_the_ranks_without_repeats():
    case = cases.channel2d(**CHANNEL, device="cpu")
    feats = P.Features(inout=case.meta["inout"])
    st = case.state
    for ndev in (2, 3):
        cfg = S.make_shard_cfg(case.dom, ndev, st.n)
        pool = S.spare_ids(cfg, st, feats)
        ids = np.concatenate(pool)
        free = ~td.is_active(st.code)
        np.testing.assert_array_equal(ids, np.sort(st.idp[free].numpy()))
        assert len(np.unique(ids)) == len(ids)
        # the inlet (rank 0) alone can spawn: its rank takes the pool
        assert len(pool[0]) == len(ids) > 0
        # without zones that spawn, the pool is split evenly
        even = S.spare_ids(cfg, st, None)
        sizes = [len(p) for p in even]
        assert max(sizes) - min(sizes) <= 1
        np.testing.assert_array_equal(np.concatenate(even), ids)
        # a rank's dead slots carry its share, the others id -1
        for r in range(ndev):
            rs = S._rank_state(cfg, S.shard_state(cfg, st), r, "cpu",
                               even[r])
            dead = rs.code == S._DEAD
            assert sorted(rs.idp[dead & (rs.idp >= 0)].tolist()) == \
                even[r].tolist()
            assert int((rs.idp[dead] == -1).sum()) == \
                int(dead.sum()) - len(even[r])


def test_advanced_refill_fills_only_the_owned_holes():
    """The advanced refilling on a rank (``owns``) fills only the holes of
    its own slab: a neighbour's rank fills the others, so no hole gets
    two spawns."""
    case = cases.channel2d(**CHANNEL, device="cpu")
    csp, st = case.csp, case.state
    zone = dataclasses.replace(case.meta["inout"].zones[0],
                               refill="advanced", refillrate=1)
    cfg = IO.InOutCfg(zones=(zone,))
    # empty the zone: every lattice point is a hole
    member = td.code_inout(st.code) == 1
    st = dataclasses.replace(st, code=torch.where(
        member, td.code_set_special(st.code, td.SPECIAL_OUT_MOVE), st.code))
    lattice = torch.tensor(IO.zone_points(zone, csp), dtype=torch.float32)
    split = float(lattice[:, 2].median())
    tabs = torch.tensor(0.0)
    runs = {}
    for name, owns in (("all", None), ("low", lambda p: p[:, 2] < split),
                       ("high", lambda p: p[:, 2] >= split)):
        out, ov, filled = IO.inout_step(cfg, csp, st, tabs, nstep=0,
                                        owns=owns)
        new = td.is_active(out.code) & ~td.is_active(st.code)
        assert int(ov) == 0 and bool(filled)
        runs[name] = out.pos[new]
    assert len(runs["all"]) == len(lattice)
    assert (runs["low"][:, 2] < split).all()
    assert (runs["high"][:, 2] >= split).all()
    assert len(runs["low"]) + len(runs["high"]) == len(lattice)


class TableGroup:
    """A stand-in for one rank's ``parallel.group.Group`` in
    ``sharding._rebalance_pool``: its one SUM returns ``total`` (every
    rank's table added), and keeps the rank's own table."""

    def __init__(self, rank, total=None):
        self.rank, self.world, self.device = rank, 2, torch.device("cpu")
        self.total, self.table = total, None

    def all_reduce(self, t, op="max"):
        assert op == "sum"
        self.table = t.clone()
        return t if self.total is None else self.total


def test_rebalance_brings_outlet_ids_to_the_spawning_rank():
    """The free pool's sharing at a rebuild: the ids of outlet members that
    died on rank 1 (no spawns there) and rank 1's share of the pool move
    to rank 0, which spawned; no id is held twice, rank 1 keeps none, and
    the slots the ids left are dead with id -1."""
    case = cases.channel2d(**CHANNEL, device="cpu")
    feats = P.Features(inout=case.meta["inout"])
    st = case.state
    cfg = S.make_shard_cfg(case.dom, 2, st.n)
    even = S.spare_ids(cfg, st, None)         # both ranks hold pool ids
    ranks = [S._rank_state(cfg, S.shard_state(cfg, st), r, "cpu", even[r])
             for r in range(2)]
    # rank 1's outlet members die through the zone's back
    r1 = ranks[1]
    dying = td.code_inout(r1.code) == 2
    assert int(dying.sum()) == 27
    ranks[1] = dataclasses.replace(r1, code=torch.where(
        dying, td.code_set_special(r1.code, td.SPECIAL_OUT_MOVE), r1.code))
    died = ranks[1].idp[dying]
    plan = S.PoolPlan(feats.inout, S._spawners(feats),
                      sum(len(p) for p in even))
    spawns = [torch.tensor(5), torch.tensor(0)]
    groups = [TableGroup(r) for r in range(2)]
    for r in range(2):
        S._rebalance_pool(ranks[r], groups[r], plan, spawns[r])
    total = groups[0].table + groups[1].table
    out = []
    for r in range(2):
        got, ov = S._rebalance_pool(ranks[r], TableGroup(r, total), plan,
                                    spawns[r])
        assert int(ov) == 0
        out.append(got)
    pooled = [o.idp[(o.idp >= 0) & ~td.is_active(o.code)] for o in out]
    want = torch.cat([torch.tensor(e) for e in even] + [died])
    assert sorted(pooled[0].tolist()) == sorted(want.tolist())
    assert len(pooled[1]) == 0
    assert not td.is_active(out[1].code[dying]).any()
    assert (out[1].code[dying] == S._DEAD).all()
    assert (out[1].idp[dying] == -1).all()
    # the live rows are untouched
    for r in range(2):
        live = td.is_active(ranks[r].code)
        assert torch.equal(out[r].idp[live], ranks[r].idp[live])
