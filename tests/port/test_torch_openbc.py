"""Open boundaries against the JAX package: periodic ghosts and the
inlet/outlet zones (``features/periodic.py``, ``features/inout.py``), their
steps, the ``<special><inout>`` loader and the CLI.

* ``_make_state(capacity=)`` and ``channel2d`` equal to the JAX builders
  array for array, and ``convert.simstate`` carrying the spare slots;
* the wrap and the ghost rows on seeded clouds with crossers and corner
  particles, 2D (x-periodic) and 3D (x and y): wrapped positions exact by
  id, each side's ghosts equal to JAX's as a set of (pos, vel, rho, code),
  the overflow at a small cap as JAX counts it; the port's state is
  permuted, so the choice must go by id;
* ``inout_step`` in every mode on a permuted state: codes, positions and
  spawned ids exact by id, imposed velocity and density rtol 1e-6 (floor
  1e-6 of the largest value), overflow equal;
* ``inout_extrapolate`` on the linear field of tests/test_inout.py and a
  3D twin, through the first-order, the Shepard and the keep-current
  branches: rtol 1e-4 with a floor of 1e-4 of the largest value (sums over
  the same pairs in another order; the MLS solve amplifies their rounding);
* 3 symplectic and 3 Verlet steps of the periodic channel (a column wraps)
  and of ``channel2d(dp=0.02, length=0.5, height=0.16, vel=0.4)`` (members
  convert and spawn at step 1) against jitted JAX steps: positions within
  1e-4 dp by id, density rtol 1e-5, codes exact;
* 3 symplectic steps of chip_smoke.py's y-periodic duct with an inlet
  (calculated zsurf, AWAS) and a full-width extrapolated outlet against
  JAX's state with its ghost tail, where the outlet's members by the
  periodic edges read periodic images: codes, live ids and spawns exact,
  positions within 1e-4 dp, velocity rtol 2e-3, density rtol 1e-5;
* the inlet/outlet pass counts the edge particles its periodic images
  leave out beyond the ghost cap;
* the layout kept after a spawn holds every pair a fresh divide finds;
* the loader against JAX's ``load_case`` on the inline XMLs of
  tests/test_inout.py and chip_smoke.py's duct at a coarse dp;
* the CLI running ``-builtin channel2d`` on the CPU and refusing its
  restart.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.features import inout as jIO
from dualsphysics_multilayer_tpu.features import periodic as jPER
from dualsphysics_multilayer_tpu.features.featureset import Features as jFeatures
from dualsphysics_multilayer_tpu.io import xmlcase as jX
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import forces as jF
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import cli, convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.features import inout as IO
from dualsphysics_multilayer_tpu_torch.features import periodic as PER
from dualsphysics_multilayer_tpu_torch.io import partdata as PD
from dualsphysics_multilayer_tpu_torch.io import xmlcase as X
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.models import wcsph as W
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd

from test_torch_variant_steps import by_id, pairs_per_target
from test_torch_xmlcase import assert_loads_equal

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

CHANNEL = dict(dp=0.02, length=0.5, height=0.16, vel=0.4)
NSTEPS = 3


def arrays_of(st):
    return {k: None if getattr(st, k) is None else np.asarray(getattr(st, k))
            for k in ("pos", "vel", "rho", "code", "idp", "velm1", "rhom1")}


def permuted(st, seed):
    """The state with its slots shuffled: choices must go by id."""
    order = torch.as_tensor(np.random.default_rng(seed).permutation(st.n))
    return st.permuted(order)


def host_by_id(st, name):
    v = getattr(st, name)
    out = torch.empty_like(v)
    out[st.idp] = v
    return out.numpy()


def test_make_state_capacity_and_channel2d_match_jax():
    """Spare slots as JAX fills them, carried by ``convert.simstate``, and
    channel2d's lattice, zones and initial members."""
    jcase = jcases.channel2d(**CHANNEL)
    case = cases.channel2d(**CHANNEL, device="cpu")
    jst, st = jcase.state, case.state
    for k in ("pos", "vel", "rho"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jst, k)), err_msg=k)
    np.testing.assert_array_equal(st.code.numpy(),
                                  np.asarray(jst.code).astype(np.int32))
    np.testing.assert_array_equal(st.idp.numpy(), np.asarray(jst.idp))
    assert st.n > case.np_total + 256
    assert convert.feature(jcase.meta["inout"]) == case.meta["inout"]
    assert convert.domain(dataclasses.asdict(jcase.dom)) == case.dom
    back = convert.simstate(arrays_of(jst), device="cpu")
    for k in ("pos", "vel", "rho", "code", "idp"):
        assert torch.equal(getattr(back, k), getattr(st, k)), k
    spare = ~td.is_active(st.code)
    assert int(spare.sum()) == st.n - case.np_total - int(
        td.is_inout(st.code).sum())
    # the 3D builder with spare slots and mDBC normals
    jc = jcases.dambreak3d(dp=0.05, capacity=None)
    pos = np.asarray(jc.state.pos, np.float64)[:40]
    code = np.asarray(jc.state.code)[:40]
    nrm = np.random.default_rng(0).normal(size=(40, 3))
    a = jcases._make_state(jc.csp, pos, code, zsurf=0.3, capacity=64,
                           need_verlet=True, need_sps=True, normals=nrm)
    csp = convert.ctesph(dataclasses.asdict(jc.csp))
    b = cases._make_state(csp, pos, code.astype(np.int32), zsurf=0.3,
                          device="cpu", capacity=64, need_verlet=True,
                          need_sps=True, normals=nrm)
    for k in ("pos", "vel", "rho", "velm1", "rhom1", "spstau", "motionvel"):
        np.testing.assert_array_equal(getattr(b, k).numpy(),
                                      np.asarray(getattr(a, k)), err_msg=k)
    np.testing.assert_allclose(b.boundnormal.numpy(), np.asarray(a.boundnormal),
                               atol=1e-6)
    np.testing.assert_array_equal(b.code.numpy(), np.asarray(a.code))


def periodic_cloud(sim2d, n, seed, ghost_cap):
    """A jittered cloud that straddles the periodic edges (crossers on both
    sides, corner particles in 3D), with JAX's ghost tail, as a JAX state
    and the config, plus the port's csp."""
    csp = jtd.make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.3, coefh=1.0)
    ks = csp.kernelsize
    rng = np.random.default_rng(seed)
    axes = (True, False, False) if sim2d else (True, True, False)
    lo, hi = (0.0, 0.0, 0.0), (0.6, 0.0 if sim2d else 0.5, 0.0)
    pos = np.zeros((n, 3))
    for ax in range(3):
        if axes[ax]:
            pos[:, ax] = rng.uniform(lo[ax] - 0.2 * ks, hi[ax] + 0.2 * ks, n)
    pos[:, 2] = rng.uniform(0.0, 0.3, n)
    code = np.full(n, jtd.code_make(jtd.TYPE_FLUID, 0), np.uint32)
    code[: n // 5] = jtd.code_make(jtd.TYPE_FIXED, 0)
    code[n // 5: n // 5 + 3] = jtd.code_make(jtd.TYPE_FLUID, 0,
                                             jtd.SPECIAL_OUT_POS)
    cfg = jPER.PeriodicCfg(axes=axes, lo=lo, hi=hi, ghost_cap=ghost_cap)
    cap = n + jPER.ghost_slots_required(cfg)
    full = lambda fill, shape: np.full((cap,) + shape, fill, np.float32)
    P_ = full(-1e6, (3,))
    P_[:n] = pos
    V = full(0.0, (3,))
    V[:n] = rng.normal(0, 0.5, (n, 3))
    R = full(1000.0, ())
    R[:n] = rng.uniform(990, 1010, n)
    C = np.full(cap, jtd.code_make(jtd.TYPE_FLUID, 0, jtd.SPECIAL_OUT_IGNORE),
                np.uint32)
    C[:n] = code
    arrays = dict(pos=P_, vel=V, rho=R, code=C, idp=np.arange(cap),
                  spstau=rng.normal(size=(cap, 6)).astype(np.float32))
    jst = jW.SimState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return csp, cfg, jst, arrays, n


def ghost_set(pos, vel, rho, code, spstau):
    rows = np.column_stack([pos, vel, rho, code.astype(np.float64), spstau])
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("sim2d,ghost_cap", [(True, 64), (False, 96),
                                             (True, 5), (False, 7)])
def test_ghost_rows_match_jax(sim2d, ghost_cap):
    jcsp, jcfg, jst, arrays, n = periodic_cloud(sim2d, 300, 1, ghost_cap)
    jout, jov = jPER.apply_periodic(jcfg, jcsp, jst)
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    cfg = convert.feature(jcfg)
    st = permuted(convert.simstate(arrays, device="cpu"), 2)
    pos = PER.wrap(cfg, st.pos, st.code)
    jpos = np.asarray(jout.pos)
    np.testing.assert_array_equal(host_by_id(dataclasses.replace(st, pos=pos),
                                             "pos")[:n], jpos[:n])
    rows, ov = PER.ghost_rows(cfg, csp, dataclasses.replace(st, pos=pos))
    assert int(ov) == int(jov)
    if ghost_cap < 10:
        assert int(ov) > 0
    G = cfg.ghost_cap
    jcode = np.asarray(jout.code).astype(np.int64)
    for seg in range(2 * cfg.naxes):
        js = slice(n + seg * G, n + (seg + 1) * G)
        ps = slice(st.n + seg * G, st.n + (seg + 1) * G)
        jsel = jtd.is_periodic(jcode[js])
        psel = td.is_periodic(rows["code"][ps]).numpy()
        assert jsel.sum() == psel.sum() > 0, seg
        want = ghost_set(jpos[js][jsel], np.asarray(jout.vel)[js][jsel],
                         np.asarray(jout.rho)[js][jsel], jcode[js][jsel],
                         np.asarray(jout.spstau)[js][jsel])
        got = ghost_set(*(rows[k][ps][psel].numpy() for k in
                          ("pos", "vel", "rho", "code", "spstau")))
        np.testing.assert_array_equal(got, want, err_msg=f"segment {seg}")


def io_scene(zone_kw, seed=0, verlet=False, shift=0.12, gravity=0.0):
    """An inlet at x = 0 and an outlet at x = 0.6 (2D, dp 0.1) around a
    fluid lattice, with spare slots, the zones' members placed by JAX's
    ``init_inout``, then every particle moved ``shift`` along x: members
    cross at the inlet, leave the outlet's back, fluid enters the outlet.
    ``zone_kw(name)`` gives each zone's extra settings."""
    csp = jtd.make_ctesph(simulate2d=True, dp=0.1, gravity=(0, 0, gravity),
                          speedsound=10.0)
    xs, zs = np.arange(0.1, 0.55, 0.1), np.arange(0.05, 0.5, 0.1)
    X_, Z_ = np.meshgrid(xs, zs, indexing="ij")
    fpos = np.stack([X_.ravel(), np.zeros(X_.size), Z_.ravel()], axis=1)
    zones = (jIO.InOutZone(**{**dict(
                 p0=(0, 0, 0.25), direction=(1, 0, 0), layers=3,
                 tangent1=(0, 0, 1), size1=0.5, vel_profile=(0.5, 0, 0),
                 capture_fluid=False), **zone_kw("inlet")}),
             jIO.InOutZone(**{**dict(
                 p0=(0.6, 0, 0.25), direction=(-1, 0, 0), layers=3,
                 tangent1=(0, 0, 1), size1=0.5, vel_profile=(-0.5, 0, 0)),
                 **zone_kw("outlet")}))
    cfg = jIO.InOutCfg(zones=zones)
    cap = len(fpos) + 80
    pos = np.full((cap, 3), -1e6, np.float32)
    pos[:len(fpos)] = fpos
    rng = np.random.default_rng(seed)
    vel = np.zeros((cap, 3), np.float32)
    vel[:len(fpos), 0] = 0.5 + rng.normal(0, 0.05, len(fpos))
    rho = np.full(cap, csp.rhopzero, np.float32)
    rho[:len(fpos)] += rng.normal(0, 2.0, len(fpos)).astype(np.float32)
    code = np.full(cap, jtd.code_make(jtd.TYPE_FLUID, 0,
                                      jtd.SPECIAL_OUT_IGNORE), np.uint32)
    code[:len(fpos)] = jtd.code_make(jtd.TYPE_FLUID, 0)
    extra = dict(velm1=jnp.asarray(vel), rhom1=jnp.asarray(rho)) \
        if verlet else {}
    jst = jW.SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                      rho=jnp.asarray(rho), code=jnp.asarray(code),
                      idp=jnp.arange(cap, dtype=jnp.uint32), **extra)
    return csp, cfg, jst


IO_MODES = {
    "conveyor": dict(),
    "simplezsurf": dict(zone=lambda z: dict(refill="simplezsurf",
                                            zsurf=0.28)),
    "advanced-tick": dict(zone=lambda z: dict(refill="advanced",
                                              refillrate=5), nstep=10,
                          kill=True),
    "advanced-off": dict(zone=lambda z: dict(refill="advanced",
                                             refillrate=5), nstep=7,
                         kill=True),
    "capture-off": dict(zone=lambda z: dict(capture_fluid=False)),
    "linear-times": dict(zone=lambda z: dict(
        vel_profile=(0.3, 0.8, 0.0) if z == "inlet" else (-0.3, -0.8, 0.0),
        vel_times=((0.0, 0.5), (1.0, 1.5))), tabs=0.4),
    "parabolic": dict(zone=lambda z: dict(
        vel_profile=(0.2, 1.0, -1.5) if z == "inlet" else (-0.2, 0.0, 0.0))),
    "hydrostatic": dict(zone=lambda z: dict(rho_mode="hydrostatic",
                                            zsurf=0.42), gravity=-9.81),
    "zsurf-timed": dict(zone=lambda z: dict(
        rho_mode="hydrostatic", refill="simplezsurf",
        zsurf_times=((0.0, 0.3), (1.0, 0.5))), gravity=-9.81, tabs=0.5),
    "zsurf-calc": dict(zone=lambda z: dict(
        rho_mode="hydrostatic", refill="simplezsurf", zsurf=0.2,
        zsurf_calc=True), gravity=-9.81),
    "awas": dict(zone=lambda z: dict(awas=jIO.InOutAwas(
        inletmode=z == "inlet", startawas=0.1, depth=0.5,
        zsurf_t=(0.0, 10.0), zsurf_v=(0.45, 0.5), gauge_x=0.3,
        z0=0.0)), tabs=0.3, gravity=-9.81),
    "gridvel": dict(zone=lambda z: dict(vel_grid=jIO.InOutGridVel(
        times=(0.0, 1.0), nx=2, nz=3, dpx=0.5, dpz=0.2,
        velx=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1),
        velz=(0.0,) * 6 + (0.05,) * 6)) if z == "inlet" else {},
        tabs=0.25),
    "verlet": dict(verlet=True),
}


@pytest.mark.parametrize("mode", list(IO_MODES))
def test_inout_step_matches_jax(mode):
    spec = IO_MODES[mode]
    jcsp, jcfg, jst = io_scene(spec.get("zone", lambda z: {}),
                               verlet=spec.get("verlet", False),
                               gravity=spec.get("gravity", 0.0))
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    cfg = convert.feature(jcfg)
    st0 = permuted(convert.simstate(arrays_of(jst), device="cpu"), 3)
    jst = jIO.init_inout(jcfg, jcsp, jst)
    st = IO.init_inout(cfg, csp, st0)
    for k in ("pos", "code"):
        np.testing.assert_array_equal(host_by_id(st, k),
                                      np.asarray(getattr(jst, k)).astype(
                                          host_by_id(st, k).dtype), err_msg=k)
    for k in ("vel", "rho"):
        np.testing.assert_allclose(host_by_id(st, k),
                                   np.asarray(getattr(jst, k)), rtol=1e-6,
                                   err_msg=k)
    if spec.get("kill"):
        # a depleted inlet: 4 of its members gone
        code = np.asarray(jst.code).astype(np.int64)
        members = np.flatnonzero(jtd.code_inout(code) == 1)[:4]
        code[members] = jtd.code_set_special(code[members],
                                             jtd.SPECIAL_OUT_MOVE)
        jst = dataclasses.replace(jst, code=jnp.asarray(code.astype(
            np.uint32)))
        pc = torch.tensor(code.astype(np.int32))
        st = dataclasses.replace(st, code=pc[st.idp])
    jst = dataclasses.replace(jst, pos=jst.pos + jnp.asarray([0.12, 0, 0]))
    st = dataclasses.replace(st, pos=st.pos + torch.tensor([0.12, 0, 0]))
    tabs = spec.get("tabs", 0.2)
    nstep = spec.get("nstep")
    jout, jov = jIO.inout_step(jcfg, jcsp, jst, 0.01, jnp.float32(tabs),
                               nstep=None if nstep is None
                               else jnp.asarray(nstep))
    out, ov, filled = IO.inout_step(cfg, csp, st,
                                    torch.tensor(tabs, dtype=torch.float32),
                                    nstep=nstep)
    assert int(ov) == int(jov)
    jcode = np.asarray(jout.code).astype(np.int64)
    code = host_by_id(out, "code").astype(np.int64)
    np.testing.assert_array_equal(code, jcode)
    np.testing.assert_array_equal(host_by_id(out, "pos"), np.asarray(jout.pos))
    spawned = td.is_active(torch.tensor(code)).numpy() & \
        ~jtd.is_active(np.asarray(jst.code).astype(np.int64))
    assert bool(filled) == bool(spawned.any())
    if mode in ("conveyor", "advanced-tick", "verlet"):
        assert spawned.sum() > 0
    if mode in ("conveyor", "advanced-off"):
        # the outlet destroyed its back layer and captured fluid
        assert (jtd.code_special(jcode) == jtd.SPECIAL_OUT_MOVE).sum() > 0
        assert (jtd.code_inout(jcode) == 2).sum() > 0
    for k in ("vel", "rho") + (("velm1", "rhom1") if spec.get("verlet")
                               else ()):
        want = np.asarray(getattr(jout, k))
        np.testing.assert_allclose(host_by_id(out, k), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)


def extrap_scene(sim2d, determlimit):
    """tests/test_inout.py's linear field (2D) or its 3D twin, with an
    extrapolated zone at the fluid's edge and a second one far from any
    fluid (its members keep their values)."""
    csp = jtd.make_ctesph(simulate2d=sim2d, dp=0.05 if sim2d else 0.1,
                          gravity=(0, 0, 0), speedsound=10.0)
    dp = csp.dp
    ax = np.arange(dp / 2, 1.0, dp)
    if sim2d:
        X_, Z_ = np.meshgrid(ax, ax, indexing="ij")
        fpos = np.stack([X_.ravel(), np.zeros(X_.size), Z_.ravel()], axis=1)
        kw = dict(tangent1=(0, 0, 1), size1=1.0)
    else:
        X_, Y_, Z_ = np.meshgrid(ax, ax, ax, indexing="ij")
        fpos = np.stack([X_.ravel(), Y_.ravel(), Z_.ravel()], axis=1)
        kw = dict(tangent1=(0, 1, 0), size1=1.0, tangent2=(0, 0, 1),
                  size2=1.0)
    y0 = 0.0 if sim2d else 0.5
    zone = jIO.InOutZone(p0=(0, y0, 0.5), direction=(1, 0, 0), layers=3,
                         vel_extrap=True, rho_extrap=True, **kw)
    far = jIO.InOutZone(p0=(-1.5, y0, 0.5), direction=(1, 0, 0), layers=1,
                        vel_extrap=True, rho_extrap=True, **kw)
    cfg = jIO.InOutCfg(zones=(zone, far), determlimit=determlimit)
    zpts = [jIO.zone_points(z, csp) for z in (zone, far)]
    n = len(fpos) + sum(len(z) for z in zpts)
    pos = np.concatenate([fpos] + zpts).astype(np.float32)
    vel = np.zeros((n, 3), np.float32)
    vel[:, 0] = 0.7
    rho = np.full(n, csp.rhopzero, np.float32)
    vel[:len(fpos), 0] = 0.3 + 0.2 * fpos[:, 0] - 0.1 * fpos[:, 2]
    if not sim2d:
        vel[:len(fpos), 1] = 0.05 * fpos[:, 1]
    rho[:len(fpos)] = csp.rhopzero + 40.0 * fpos[:, 0] + 25.0 * fpos[:, 2]
    code = np.full(n, jtd.code_make(jtd.TYPE_FLUID, 0), np.uint32)
    m0 = len(fpos)
    code[m0:m0 + len(zpts[0])] = jtd.code_set_inout(
        jtd.code_make(jtd.TYPE_FLUID, 0), 1)
    code[m0 + len(zpts[0]):] = jtd.code_set_inout(
        jtd.code_make(jtd.TYPE_FLUID, 0), 2)
    lo = (-2.0, 0.0 if sim2d else -0.5, -0.5)
    hi = (1.5, 0.0 if sim2d else 1.5, 1.5)
    dom = jcd.make_domain(lo, hi, csp.kernelsize, simulate2d=sim2d, dp=dp)
    jst = jW.SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                      rho=jnp.asarray(rho), code=jnp.asarray(code),
                      idp=jnp.arange(n, dtype=jnp.uint32))
    return csp, cfg, dom, jst, m0


@pytest.mark.parametrize("sim2d,determlimit", [(True, 1e-3), (True, 1e3),
                                               (False, 1e-3)])
def test_inout_extrapolate_matches_jax(sim2d, determlimit):
    jcsp, jcfg, jdom, jst, nfluid = extrap_scene(sim2d, determlimit)
    # jitted: eager, each of its operations compiles on its own (~11 s)
    jvel, jrho = (np.asarray(a) for a in jax.jit(
        jIO.inout_extrapolate, static_argnums=(0, 1, 2))(jcfg, jcsp, jdom,
                                                         jst))
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    dom = convert.domain(dataclasses.asdict(jdom))
    cfg = convert.feature(jcfg)
    st = convert.simstate(arrays_of(jst), device="cpu")
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    st = dataclasses.replace(st, code=code).permuted(cells.order)
    vel, rho, ov = IO.inout_extrapolate(cfg, csp, dom, cells, st)
    assert int(ov) == 0
    got = dataclasses.replace(st, vel=vel, rho=rho)
    for name, want in (("vel", jvel), ("rho", jrho)):
        np.testing.assert_allclose(host_by_id(got, name), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    far = jtd.code_inout(np.asarray(jst.code)) == 2
    np.testing.assert_array_equal(host_by_id(got, "vel")[far][:, 0],
                                  np.float32(0.7))
    inner = jtd.code_inout(np.asarray(jst.code)) == 1
    # the members by the fluid take its field, not the 0.7 they held
    assert (np.abs(host_by_id(got, "vel")[inner][:, 0] - 0.7)
            > 0.1).mean() > 0.8


def periodic_state(verlet):
    """The periodic channel at dp 0.04 streaming at 1 m/s, shifted so its
    last column sits 1e-4 m below the edge: it wraps inside 3 steps."""
    case = cases.periodic_channel2d(ghost_cap=64, device="cpu")
    st = case.state
    fl = td.is_fluid(st.code)
    pos = st.pos.clone()
    pos[fl, 0] += case.csp.dp - 1e-4
    vel = torch.where(fl[:, None], torch.tensor([1.0, 0.0, 0.0]), 0.0)
    st = dataclasses.replace(st, pos=pos, vel=vel,
                             velm1=vel if verlet else None,
                             rhom1=st.rho if verlet else None)
    return case, st


@pytest.mark.parametrize("verlet", [False, True])
def test_periodic_channel_steps_match_jax(verlet):
    """3 steps in which a column wraps, against JAX's state with its ghost
    tail (the port's has none)."""
    case, st = periodic_state(verlet)
    cfg = case.meta["periodic"]
    jcfg = jPER.PeriodicCfg(axes=cfg.axes, lo=cfg.lo, hi=cfg.hi,
                            ghost_cap=cfg.ghost_cap)
    n, G = st.n, jPER.ghost_slots_required(jcfg)
    tail = dict(pos=-1e6, vel=0.0, rho=1000.0)

    def pad(a, fill):
        a = a.numpy()
        return np.concatenate([a, np.full((G,) + a.shape[1:], fill,
                                          a.dtype)])

    jst = jW.SimState(
        **{k: jnp.asarray(pad(getattr(st, k), f)) for k, f in tail.items()},
        code=jnp.asarray(pad(st.code, jtd.code_make(
            jtd.TYPE_FLUID, 0, jtd.SPECIAL_OUT_IGNORE)).astype(np.uint32)),
        idp=jnp.arange(n + G, dtype=jnp.uint32),
        **({k: jnp.asarray(pad(getattr(st, k), f)) for k, f in
            (("velm1", 0.0), ("rhom1", 1000.0))} if verlet else {}))
    jcsp = jtd.make_ctesph(simulate2d=True, dp=0.04, hswl=0.3, coefh=1.0,
                           visco=0.05, coefsound=20.0)
    assert convert.ctesph(dataclasses.asdict(jcsp)) == case.csp
    tstep = "VERLET" if verlet else "SYMPLECTIC"
    jdom = jcases._make_domain(jcsp, _lattice(), headroom=0.8 / 0.3)
    assert convert.domain(dataclasses.asdict(jdom)) == case.dom
    jopts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False,
                          tstep=jtd.TpStep[tstep])
    jfeats = jFeatures(periodic=jcfg)
    jstep = jax.jit(jW.make_step(jcsp, jopts, jdom, jfeats))
    jcarry = jW.make_carry(jst, jcsp, jopts, jfeats, dom=jdom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS,
                        tstep=td.TpStep[tstep])
    feats = P.Features(periodic=cfg)
    carry = P.make_carry(st, case.csp, opts, case.dom, feats)
    step = P.make_step(case.csp, opts, case.dom, feats)
    for _ in range(NSTEPS):
        carry = step(carry)
    jout = jcarry.st
    jpos = np.asarray(jout.pos)[:n]
    np.testing.assert_array_equal(by_id(carry.st, "code"),
                                  np.asarray(jout.code)[:n].astype(np.int32))
    np.testing.assert_allclose(by_id(carry.st, "pos"), jpos, rtol=0,
                               atol=1e-4 * case.csp.dp)
    np.testing.assert_allclose(by_id(carry.st, "rho"),
                               np.asarray(jout.rho)[:n], rtol=1e-5)
    wrapped = (jpos[:, 0] < 0.02) & (st.pos[:, 0].numpy() > 0.7)
    assert wrapped.sum() >= 7
    assert carry.overflow == 0 == int(jcarry.overflow)


def jax_zone(zone):
    """The JAX package's zone with the port zone's fields."""
    kw = {f.name: getattr(zone, f.name) for f in dataclasses.fields(zone)}
    if zone.awas is not None:
        kw["awas"] = jIO.InOutAwas(**dataclasses.asdict(zone.awas))
    return jIO.InOutZone(**kw)


def test_periodic_duct_with_zones_matches_jax():
    """3 symplectic steps of chip_smoke.py's y-periodic duct at dp 0.02
    (990 drawn particles, 168 zone members, the flow jittered): an inlet
    with a calculated zsurf and AWAS, a full-width outlet whose velocity
    and density are extrapolated.  JAX keeps its ghosts in its state,
    where the outlet's mirror nodes near a periodic edge find fluid across
    it; the port hands its zones the periodic images of its rows.  Live
    ids, codes and spawns exact by id, positions within 1e-4 dp, velocity
    rtol 2e-3 (floor 2e-3 of the largest value) and density rtol 1e-5."""
    dp = 0.02
    csp, dom, st, feats, lattice = chip_smoke.periodic_duct(dp, "cpu")
    pcfg, icfg = feats.periodic, feats.inout
    n = st.n
    jcsp = jtd.make_ctesph(simulate2d=False, dp=dp,
                           hswl=chip_smoke.PDUCT["height"], visco=0.02)
    assert convert.ctesph(dataclasses.asdict(jcsp)) == csp
    jdom = jcases._make_domain(jcsp, lattice, headroom=0.5)
    assert convert.domain(dataclasses.asdict(jdom)) == dom
    jpcfg = jPER.PeriodicCfg(axes=pcfg.axes, lo=pcfg.lo, hi=pcfg.hi,
                             ghost_cap=pcfg.ghost_cap)
    jicfg = jIO.InOutCfg(zones=tuple(jax_zone(z) for z in icfg.zones),
                         n_usable=n)
    assert convert.feature(jicfg).zones == icfg.zones
    G = jPER.ghost_slots_required(jpcfg)

    def pad(a, fill):
        a = a.numpy()
        return np.concatenate([a, np.full((G,) + a.shape[1:], fill,
                                          a.dtype)])

    jst = jW.SimState(
        pos=jnp.asarray(pad(st.pos, -1e6)), vel=jnp.asarray(pad(st.vel, 0.0)),
        rho=jnp.asarray(pad(st.rho, 1000.0)),
        code=jnp.asarray(pad(st.code, jtd.code_make(
            jtd.TYPE_FLUID, 0, jtd.SPECIAL_OUT_IGNORE)).astype(np.uint32)),
        idp=jnp.arange(n + G, dtype=jnp.uint32))
    jopts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    jfeats = jFeatures(periodic=jpcfg, inout=jicfg)
    jstep = jax.jit(jW.make_step(jcsp, jopts, jdom, jfeats))
    jcarry = jW.make_carry(jst, jcsp, jopts, jfeats, dom=jdom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
    carry = P.make_carry(st, csp, opts, dom, feats)
    step = P.make_step(csp, opts, dom, feats)
    for _ in range(NSTEPS):
        carry = step(carry)
    out, jout = carry.st, jcarry.st
    jcode = np.asarray(jout.code)[:n].astype(np.int32)
    np.testing.assert_array_equal(by_id(out, "code"), jcode)
    act = jtd.is_active(jcode)
    spawned = act & ~jtd.is_active(st.code.numpy())
    assert spawned.sum() == 16
    np.testing.assert_allclose(by_id(out, "pos")[act],
                               np.asarray(jout.pos)[:n][act], rtol=0,
                               atol=1e-4 * dp)
    want = np.asarray(jout.vel)[:n][act]
    np.testing.assert_allclose(by_id(out, "vel")[act], want, rtol=2e-3,
                               atol=2e-3 * np.abs(want).max(), err_msg="vel")
    np.testing.assert_allclose(by_id(out, "rho")[act],
                               np.asarray(jout.rho)[:n][act], rtol=1e-5,
                               err_msg="rho")
    # the outlet's members by both periodic edges took JAX's values
    edge = (jtd.code_inout(jcode) == 2) & act & (
        np.minimum(np.asarray(jout.pos)[:n, 1] - pcfg.lo[1],
                   pcfg.hi[1] - np.asarray(jout.pos)[:n, 1]) < dp)
    assert edge.sum() >= 2 * 3 * 4
    assert carry.overflow == 0 == int(jcarry.overflow)


def test_inout_pass_counts_the_images_overflow():
    """The inlet/outlet pass under periodic boundaries returns the edge
    particles its images leave out beyond the ghost cap (the step adds
    them to its ghost overflow, as an interaction's), and none when they
    fit."""
    csp, dom, st, feats, _ = chip_smoke.periodic_duct(0.02, "cpu")
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
    pcfg = feats.periodic
    y, ks = st.pos[:, 1], csp.kernelsize
    live = td.is_active(st.code)
    near = [int((live & (y < pcfg.lo[1] + ks)).sum()),
            int((live & (y >= pcfg.hi[1] - ks)).sum())]
    for cap, want in ((pcfg.ghost_cap, 0), (4, sum(k - 4 for k in near))):
        fs = dataclasses.replace(feats, periodic=dataclasses.replace(
            pcfg, ghost_cap=cap))
        carry = P.make_carry(st, csp, opts, dom, fs)
        _, ovf, ghosts, _ = W._inout_hook(csp, dom, fs)(carry.st, carry)
        assert int(ovf) == 0 and int(ghosts) == want, (cap, want)
    assert min(near) > 4


def _lattice():
    """The drawn lattice of the periodic channel (f64, for JAX's domain)."""
    d = jcases.Draw(dp=0.04, simulate2d=True)
    d.box((0, 0, 0), (0.8 - 0.04, 0, 0.3), ptype=jtd.TYPE_FLUID, mk=0)
    d.box((0, 0, -3 * 0.04), (0.8 - 0.04, 0, -0.04), ptype=jtd.TYPE_FIXED,
          mk=0, faces="solid")
    return d.build()[0]


@pytest.mark.parametrize("verlet", [False, True])
def test_channel2d_steps_match_jax(verlet):
    """3 steps of channel2d: the inlet's first layer converts at step 1
    and the spawned members carry JAX's ids."""
    jcase = jcases.channel2d(**CHANNEL)
    jst = jcase.state
    if verlet:
        jst = dataclasses.replace(jst, velm1=jst.vel, rhom1=jst.rho)
    tstep = "VERLET" if verlet else "SYMPLECTIC"
    jopts = jF.SolverOpts(tdensity=jtd.TpDensity.MOLTENI, use_pallas=False,
                          tstep=jtd.TpStep[tstep])
    jfeats = jFeatures(inout=jcase.meta["inout"])
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jcase.dom, jfeats))
    jcarry = jW.make_carry(jst, jcase.csp, jopts, jfeats, dom=jcase.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)
    case = cases.channel2d(**CHANNEL, device="cpu")
    st = case.state
    if verlet:
        # the M1 state as the CLI adds it under -verlet
        st = dataclasses.replace(st, velm1=st.vel.clone(),
                                 rhom1=st.rho.clone())
    opts = P.SolverOpts(tdensity=td.TpDensity.MOLTENI,
                        tstep=td.TpStep[tstep])
    feats = convert.features(jfeats)
    carry = P.make_carry(st, case.csp, opts, case.dom, feats)
    step = P.make_step(case.csp, opts, case.dom, feats)
    for _ in range(NSTEPS):
        carry = step(carry)
    out, jout = carry.st, jcarry.st
    jcode = np.asarray(jout.code).astype(np.int32)
    np.testing.assert_array_equal(by_id(out, "code"), jcode)
    act = jtd.is_active(jcode)
    np.testing.assert_allclose(by_id(out, "pos")[act], np.asarray(jout.pos)[act],
                               rtol=0, atol=1e-4 * case.csp.dp)
    np.testing.assert_allclose(by_id(out, "rho")[act],
                               np.asarray(jout.rho)[act], rtol=1e-5)
    spawned = act & ~jtd.is_active(np.asarray(jcase.state.code))
    assert spawned.sum() == 9
    assert carry.overflow == 0 == int(jcarry.overflow)
    assert carry.nrebuild >= 2


def test_layout_after_a_spawn_keeps_every_pair():
    """Each step that fills a slot forces the next rebuild; between
    rebuilds the layout holds every pair (chip_smoke.layout_keeps_pairs)."""
    case = cases.channel2d(**CHANNEL, device="cpu")
    feats = P.Features(inout=case.meta["inout"])
    opts = P.SolverOpts(tdensity=td.TpDensity.MOLTENI)
    carry = P.make_carry(case.state, case.csp, opts, case.dom, feats)
    step = P.make_step(case.csp, opts, case.dom, feats)
    checked = 0
    for _ in range(30):
        live0 = int(td.is_active(carry.st.code).sum())
        nrebuild = carry.nrebuild
        carry = step(carry)
        if int(td.is_active(carry.st.code).sum()) > live0:
            assert carry.rebuild
        if carry.rebuild:
            continue
        assert carry.nrebuild in (nrebuild, nrebuild + 1)
        chip_smoke.layout_keeps_pairs(case.csp, case.dom, carry)
        checked += 1
    assert checked > 5
    cells = carry.cells
    pairs = pairs_per_target(case.csp, case.dom, cells, carry.st.pos,
                             carry.st.code)
    assert int(pairs.sum()) > 0


def test_a_spawn_forces_the_next_rebuild(monkeypatch):
    """With the skin contract silenced, a step leaves the rebuild flag
    exactly when it filled a slot, and the next step divides."""
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    case = cases.channel2d(**CHANNEL, device="cpu")
    feats = P.Features(inout=case.meta["inout"])
    opts = P.SolverOpts(tdensity=td.TpDensity.MOLTENI)
    carry = P.make_carry(case.state, case.csp, opts, case.dom, feats)
    step = P.make_step(case.csp, opts, case.dom, feats)
    monkeypatch.setattr(W, "_rebuild_needed",
                        lambda csp, margin, carry: torch.tensor(False))
    spawns = 0
    for _ in range(8):
        active = torch.zeros(carry.st.n, dtype=torch.bool)
        active[carry.st.idp] = td.is_active(carry.st.code)
        nrebuild, flag = carry.nrebuild, carry.rebuild
        carry = step(carry)
        assert carry.nrebuild == nrebuild + int(flag)
        now = torch.zeros_like(active)
        now[carry.st.idp] = td.is_active(carry.st.code)
        spawned = bool((now & ~active).any())
        spawns += spawned
        assert carry.rebuild == spawned
    assert spawns >= 1


IO_XML = {
    "box": """<zone3d><box>
      <point x="0" y="0.2" z="0.1"/><size x="0" y="0.4" z="0.2"/>
      <direction x="1" y="0" z="0"/>
     </box></zone3d>""",
    "circle": """<zone3d><circle>
      <point x="0.2" y="0.5" z="0.2"/><radius v="0.1"/>
      <direction x="1" y="0" z="0"/>
     </circle></zone3d>""",
    "circle-rotateaxis": """<zone3d><circle>
      <point x="0.2" y="0.5" z="0.2"/><radius v="0.1"/>
      <direction x="1" y="0" z="0"/>
      <rotateaxis angle="-90" anglesunits="degrees">
       <point1 x="0.2" y="0.5" z="0.2"/><point2 x="0.2" y="0.5" z="1.2"/>
      </rotateaxis>
     </circle></zone3d>""",
    "particles": """<zone3d><particles mkfluid="1" direction="right"/>
     </zone3d>""",
}


def io_case_xml(zonexml, extra="", velocity=None, dims="3d"):
    """tests/test_inout.py's ``_io_case_xml`` (3D) and its 2D tank."""
    y = 'y="1"' if dims == "3d" else 'y="0"'
    velocity = velocity or ('<imposevelocity mode="0"><velocity v="0.4"/>'
                            '</imposevelocity>')
    return f"""<?xml version="1.0"?>
<case>
 <casedef>
  <constantsdef>
   <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/><hswl value="0" auto="true"/>
   <gamma value="7"/><speedsystem value="0" auto="true"/><coefsound value="20"/>
   <speedsound value="0" auto="true"/><coefh value="1.0"/><cflnumber value="0.2"/>
  </constantsdef>
  <mkconfig boundcount="240" fluidcount="10"/>
  <geometry>
   <definition dp="0.05"><pointmin x="0" y="0" z="0"/><pointmax x="1" {y} z="1"/></definition>
   <commands><mainlist>
    <setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="0" y="0" z="0"/><size x="1" {y} z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.2" y="0" z="0.05"/><size x="0.8" {y} z="0.3"/></drawbox>
    {extra}
   </mainlist></commands>
  </geometry>
 </casedef>
 <execution>
  <special>
   <inout>
    <refillingrate value="7"/>
    <determlimit value="1e-3"/>
    <inoutzone>
     <layers value="3"/>
     {zonexml}
     {velocity}
    </inoutzone>
   </inout>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""


LINE = """<zone2d><line>
      <point x="0" z="0.1"/><point2 x="0" z="0.3"/>
      <direction x="1" z="0"/>{rot}
     </line></zone2d>"""
IO_CASES = {
    "box": (IO_XML["box"], "", None, "3d"),
    "circle": (IO_XML["circle"], "", None, "3d"),
    "circle-rotateaxis": (IO_XML["circle-rotateaxis"], "", None, "3d"),
    "particles": (IO_XML["particles"], """<setmkfluid mk="1"/><drawbox>
     <boxfill>solid</boxfill><point x="0.0" y="0.2" z="0.05"/>
     <size x="0.05" y="0.6" z="0.2"/></drawbox>""", None, "3d"),
    "line-rotate": (LINE.format(rot='<rotate angle="-30" '
                                'anglesunits="degrees"/>'),
                    "", None, "2d"),
    "line-profiles": (LINE.format(rot=""), "", """
     <imposevelocity mode="0"><velocity v="0.1"/>
      <velocity2 v="0.2" v2="0.6" z="0.1" z2="0.3"/></imposevelocity>
     <imposerhop mode="1"/><imposezsurf mode="1"><zsurftimes>
      <timevalue time="0" zsurf="0.3"/><timevalue time="1" zsurf="0.4"/>
     </zsurftimes></imposezsurf><refilling value="1"/>
     <inputtreatment value="1"/>""", "2d"),
    "line-extrap": (LINE.format(rot=""), "", """
     <imposevelocity mode="2"/><imposerhop mode="2"/>
     <imposezsurf mode="2" /><refilling value="2"/>""", "2d"),
    "awas": (LINE.format(rot=""), "", """
     <imposevelocity mode="1">
      <timevalue time="0" v="0.2"/><timevalue time="5" v="0.2"/>
      <awas><inletmode value="true"/><startawas value="0.5"/>
       <depth value="0.3"/><zsurffile file="zsurf.csv"/>
       <gaugex valuedp="5"/></awas>
     </imposevelocity>""", "2d"),
}


@pytest.mark.parametrize("name", list(IO_CASES) + ["duct"])
def test_inout_loader_matches_jax(name, tmp_path):
    if name == "duct":
        text = chip_smoke.duct_xml(0.04, 0.02)
    else:
        zone, extra, velocity, dims = IO_CASES[name]
        text = io_case_xml(zone, extra, velocity, dims)
    (tmp_path / "zsurf.csv").write_text("#t z\n0.0 0.30\n10.0 0.30\n")
    p = tmp_path / f"io_{name}_Def.xml"
    p.write_text(text)
    jres = jX.load_case(str(p))
    pres = X.load_case(str(p), device="cpu")
    assert_loads_equal(jres, pres)
    zones = pres[0].meta["features"].inout.zones
    assert len(zones) >= 1 and pres[0].state.n > pres[0].np_total


def test_cli_runs_channel2d_and_refuses_its_restart(tmp_path):
    """``-builtin channel2d`` runs its zones on the CPU (members spawn, the
    PARTs hold them) and a restart of it leaves with JAX's message."""
    out = tmp_path / "out"
    cli.main(["-cpu", "-builtin", "channel2d", "-dp", "0.02", "-tmax:0.006",
              "-tout:0.003", "-dirout", str(out)])
    p0 = PD.read_part(str(out / "Part_0000.bi4"))
    p2 = PD.read_part(str(out / "Part_0002.bi4"))
    assert len(p2["idp"]) > len(p0["idp"])
    with pytest.raises(SystemExit, match="Restart with inlet/outlet "
                                         "conditions is not allowed"):
        cli.main(["-cpu", "-builtin", "channel2d", "-partbegin:2", str(out),
                  "-dirout", str(tmp_path / "again")])
