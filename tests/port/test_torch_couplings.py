"""The floating bodies' couplings against the JAX package: function by
function (DEM contact, moorings and force points, the MoorDyn lines, the
Chrono links, mesh contact and the rigid update that takes them all), in
the steps, the case loader, the output and the command line.

* ``make_dem``: the port's id-keyed tables equal JAX's slot-keyed ones
  read through the ids, exactly, on a permuted state, and so does
  ``convert.demcfg``;
* ``apply_dem`` on a permuted, cell-sorted state against eager JAX on the
  canonical one (3D: two bodies 0.9 dp apart on a wall 0.9 dp below,
  seeded velocities; 2D DEM runs in the steps below): ace by id within rtol 2e-3 with a floor of 2e-3 of the largest
  value (tests/test_dem.py:56), ``demdtmax`` within 1e-3
  (tests/test_dem.py:68), the rows outside the bodies exactly zero, and a
  row beyond ``celldiv.row_cap`` counted;
* ``MooringCfg``/``ForcePointsCfg`` forces, ``MoorDynCfg.init_state`` (a
  short relaxation), ``advance``, ``fairlead_tensions`` and ``forces``
  with a ramp: rtol 1e-4 with a floor of 1e-4 of the largest value;
* ``solve_constrained`` for each of the six links (with a spring and a
  hinge's torsion in the sums), ``spring_forces`` and ``hinge_torsion``:
  rtol 1e-4 with a floor of 1e-4 of the largest value;
* ``closest_on_tri`` on seeded points in every Voronoi region (rtol 1e-5,
  floor 1e-6) and ``contact_forces`` of a box mesh sunk into a floor mesh,
  chunked over its points (rtol 1e-4, floor 1e-4 of the largest value);
* ``run_floating`` with ``ext_face``/``ext_fomegaace``, ``chcontact`` and
  ``chrono`` (hinge, spring): particles rtol 1e-5 (floor 1e-6), bodies
  rtol 1e-4 (floor 1e-4), the rule of test_torch_floating.py.

Then the couplings in the port's steps, its case loader, its output and
its command line:

* 3 symplectic steps of ``floatingbox2d(dp=0.05)`` with the box resting
  0.1 dp into the tank floor, DEM contact and a MoorDyn line, and the same
  with a Chrono hinge and spring in place of the line, against jitted JAX
  ``make_step(use_pallas=False)``: positions by id and the body centre
  within 1e-4 dp, the bodies' velocities within rtol 1e-4 (floor 1e-4 of
  the largest value), the line's nodes within 1e-4 dp;
* 15 steps of two boxes in a 2D tank, one moving and turning, in which
  the stale skin-contract layout's DEM candidate pairs differ from a
  fresh divide's: the dt sequence (SaveDt rows) within rtol 1e-5 and
  positions within 1e-4 dp of jitted JAX's;
* ``load_case`` against JAX's, array by array, on inline XMLs: DEM with
  ``<properties>`` (a property file and links); ``<moorings>`` with a
  MoorDyn file (a fixed and a connect end); ``<chrono>`` with links,
  ``<scaleforce>`` and ``.obj`` collision meshes (the fixtures of
  tests/test_dem.py, test_moorings.py and test_chrono.py);
* ``save_moorings``: the MooringsLines VTK bytes equal to JAX's and the
  MooringsPoints.csv rows within rtol 1e-4;
* the command line running the moored case and refusing the restart of
  the Chrono case without ``-restartchrono``.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.features import chcollision as jCC
from dualsphysics_multilayer_tpu.features import chrono as jCH
from dualsphysics_multilayer_tpu.features import dem as jDEM
from dualsphysics_multilayer_tpu.features import floating as jFT
from dualsphysics_multilayer_tpu.features import moorings as jMO
from dualsphysics_multilayer_tpu.features.featureset import Features as jFeatures
from dualsphysics_multilayer_tpu.io import output as jOUT
from dualsphysics_multilayer_tpu.io import xmlcase as jX
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import forces as jF
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import cli, convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.features import chcollision as CC
from dualsphysics_multilayer_tpu_torch.features import chrono as CH
from dualsphysics_multilayer_tpu_torch.features import dem as DEM
from dualsphysics_multilayer_tpu_torch.features import floating as FT
from dualsphysics_multilayer_tpu_torch.features import moorings as MO
from dualsphysics_multilayer_tpu_torch.io import output as OUT
from dualsphysics_multilayer_tpu_torch.io import partdata as PD
from dualsphysics_multilayer_tpu_torch.io import xmlcase as X
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd

from test_torch_floating import box_opts, by_id
from test_torch_xmlcase import assert_loads_equal

torch.set_num_threads(2)

BODY = ("center", "fvel", "fomega", "angles")
PROPS = [dict(young=1e6, poisson=0.3, kfric=0.45, restitu=0.2),
         dict(young=5e5, poisson=0.25, kfric=0.3, restitu=0.6)]
WALL = {0: dict(young=2e6, poisson=0.35, kfric=0.5, restitu=0.4)}


def close(got, want, rtol, err_msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * (np.abs(want).max() + 1e-30),
                               err_msg=err_msg)


def t32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


# ---------------------------------------------------------------------------
# DEM
# ---------------------------------------------------------------------------

def dem_scene(sim2d, seed=0):
    """Two floating boxes 0.9 dp apart, 0.9 dp above a wall (mk 0) and
    beside another (mk 1), fluid around them; seeded velocities.  Returns
    (JAX csp, arrays, FloatingCfg, JAX domain)."""
    dp = 0.05
    rng = np.random.default_rng(seed)
    ys = [0.0] if sim2d else list(np.arange(4) * dp)
    grid = lambda xs, zs: np.array([(x, y, z) for x in xs for y in ys
                                    for z in zs])
    floor = grid(np.arange(14) * dp, [0.0])
    side = grid([-0.9 * dp], np.arange(1, 6) * dp)
    box0 = grid(0.05 * dp + np.arange(4) * dp, 0.9 * dp + np.arange(4) * dp)
    box1 = grid(box0[:, 0].max() + 0.9 * dp + np.arange(3) * dp,
                0.9 * dp + np.arange(3) * dp)
    fluid = grid(0.4 + np.arange(5) * dp, dp + np.arange(3) * dp)
    pos = np.concatenate([floor, side, box0, box1, fluid]).astype(np.float32)
    pos += rng.normal(0, 0.02 * dp, pos.shape).astype(np.float32)
    if sim2d:
        pos[:, 1] = 0.0
    code = np.array([jtd.code_make(jtd.TYPE_FIXED, 0)] * len(floor)
                    + [jtd.code_make(jtd.TYPE_FIXED, 1)] * len(side)
                    + [jtd.code_make(jtd.TYPE_FLOATING, 0)] * len(box0)
                    + [jtd.code_make(jtd.TYPE_FLOATING, 1)] * len(box1)
                    + [jtd.code_make(jtd.TYPE_FLUID, 0)] * len(fluid),
                    np.uint32)
    vel = rng.normal(0, 0.4, pos.shape).astype(np.float32)
    vel[jtd.code_type(code) < jtd.TYPE_FLOATING] = 0.0
    if sim2d:
        vel[:, 1] = 0.0
    jcsp = jtd.make_ctesph(simulate2d=sim2d, dp=dp, hswl=0.3)
    isft = jtd.code_type(code) == jtd.TYPE_FLOATING
    val = jtd.code_value(code)
    jcfg, _ = jFT.make_floating([pos[isft & (val == b)] for b in (0, 1)],
                                [800.0, 600.0], jcsp)
    jdom = jcd.make_domain(pos.min(0) - 0.1, pos.max(0) + 0.1,
                           jcsp.kernelsize, simulate2d=sim2d, dp=dp,
                           skin=0.1, cellcap=64)
    return jcsp, dict(pos=pos, vel=vel, code=code), jcfg, jdom


def sorted_state(jcsp, jdom, a):
    """The arrays in the port's cell order with ids: (csp, dom, cells,
    pos, vel, code, idp, order)."""
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    dom = convert.domain(dataclasses.asdict(jdom))
    pos, vel = t32(a["pos"]), t32(a["vel"])
    code = torch.tensor(a["code"].astype(np.int32))
    cells, code = cd.divide_cells(dom, pos, code)
    o = cells.order
    return csp, dom, cells, pos[o], vel[o], code[o], o.clone(), o.numpy()


def by_order(x, order):
    a = x.numpy()
    out = np.empty_like(a)
    out[order] = a
    return out


def test_make_dem_tables_by_id():
    jcsp, a, jcfg, jdom = dem_scene(False)
    jdem = jDEM.make_dem(jcsp, a["code"], jcfg, float_props=PROPS,
                         bound_props=WALL)
    csp = convert.ctesph(dataclasses.asdict(jcsp))
    perm = np.random.default_rng(3).permutation(len(a["code"]))
    dem = DEM.make_dem(csp, a["code"][perm].astype(np.int32),
                       convert.floatingcfg(jcfg), float_props=PROPS,
                       bound_props=WALL, idp=perm)
    for k in ("c_tau", "c_kfric", "c_restitu", "c_mass", "c_massp",
              "c_group", "c_isbound"):
        np.testing.assert_array_equal(getattr(dem, k), getattr(jdem, k),
                                      err_msg=k)
    np.testing.assert_array_equal(np.sort(dem.ft_ids), jdem.ft_idx)
    conv = convert.demcfg(jdem, np.arange(len(perm)))
    np.testing.assert_array_equal(conv.ft_ids, jdem.ft_idx)
    # slots that hold other ids: the tables follow the ids
    moved = convert.demcfg(jdem, perm)
    np.testing.assert_array_equal(moved.c_tau[perm], jdem.c_tau)
    np.testing.assert_array_equal(moved.c_group[perm], jdem.c_group)


def test_apply_dem_matches_jax():
    sim2d = False
    jcsp, a, jcfg, jdom = dem_scene(sim2d, seed=1)
    jdem = jDEM.make_dem(jcsp, a["code"], jcfg, float_props=PROPS,
                         bound_props=WALL)
    dt = np.float32(2e-4)
    div, _ = jcd.divide(jdom, jnp.asarray(a["pos"]), jnp.asarray(a["code"]))
    jace, jdt = jDEM.apply_dem(jdem, jcsp, jdom, div, jnp.asarray(a["pos"]),
                               jnp.asarray(a["vel"]), jnp.asarray(a["code"]),
                               jnp.asarray(dt))
    jace = np.asarray(jace)
    csp, dom, cells, pos, vel, code, idp, order = sorted_state(jcsp, jdom, a)
    dem = convert.demcfg(jdem)
    # small chunks: the chunked sweep must give the one-block result
    ace, demdt, ovf = DEM.apply_dem(dem, csp, dom, cells, pos, vel, code,
                                    idp, torch.tensor(dt), max_pairs=4096)
    got = by_order(ace, order)
    isft = jtd.code_type(a["code"]) == jtd.TYPE_FLOATING
    assert np.abs(jace[isft]).max() > 1.0          # the boxes touch
    assert not got[~isft].any()
    close(got, jace, 2e-3, "ace")
    assert abs(float(demdt) - float(jdt)) <= 1e-3 * float(jdt)
    assert int(ovf) == 0


def test_apply_dem_counts_rows_beyond_the_cap():
    jcsp, a, jcfg, jdom = dem_scene(False, seed=2)
    jdem = jDEM.make_dem(jcsp, a["code"], jcfg, float_props=PROPS)
    csp, dom, cells, pos, vel, code, idp, _ = sorted_state(jcsp, jdom, a)
    # a lattice squeezed far below 0.85 dp around the first body
    csp = csp.replace(dp=csp.dp * 6)
    _, _, ovf = DEM.apply_dem(convert.demcfg(jdem), csp, dom, cells, pos,
                              vel, code, idp, 1e-4)
    assert int(ovf) > 0


# ---------------------------------------------------------------------------
# moorings, force points and MoorDyn lines
# ---------------------------------------------------------------------------

def bodies(seed, B=2, sim2d=False):
    rng = np.random.default_rng(seed)
    ft = dict(center=rng.uniform(0.2, 0.8, (B, 3)),
              fvel=rng.normal(0, 0.3, (B, 3)),
              fomega=rng.normal(0, 0.5, (B, 3)),
              angles=rng.normal(0, 0.2, (B, 3)))
    ft = {k: v.astype(np.float32) for k, v in ft.items()}
    return (jFT.FloatingState(**{k: jnp.asarray(v) for k, v in ft.items()}),
            FT.FloatingState(**{k: t32(v) for k, v in ft.items()}))


def test_mooring_and_force_point_forces_match_jax():
    jfts, fts = bodies(4)
    jcfg = jMO.MooringCfg(nbodies=2, lines=(
        jMO.MooringLine(0, (0.0, 0.0, 0.0), (0.1, 0.0, -0.05), 0.3, 500.0,
                        4.0),
        jMO.MooringLine(1, (1.0, 0.5, 0.0), (-0.05, 0.1, 0.0), 0.4, 800.0),
        jMO.MooringLine(0, (0.5, 1.0, 0.0), (0.0, 0.1, 0.0), 5.0, 700.0)))
    cfg = convert.feature(jcfg)
    for got, want in zip(cfg.forces(fts), jcfg.forces(jfts)):
        close(got, want, 1e-4)
    jfp = jMO.ForcePointsCfg(nbodies=2, points=(
        jMO.ForcePoint(0, (0.1, 0.0, 0.0), times=(0.0, 0.5, 1.0),
                       forces=(0, 0, 1, 2, 0, 3, -1, 1, 0)),
        jMO.ForcePoint(1, (0.0, 0.2, 0.1), forces=(0.5, 0.5, 0.0))))
    fp = convert.feature(jfp)
    for t in (0.2, 0.75, 3.0):
        for got, want in zip(fp.forces(fts, torch.tensor(t)),
                             jfp.forces(jfts, jnp.float32(t))):
            close(got, want, 1e-4)


def moordyn(mod, start=0.0, ramptime=0.0):
    line = dict(length0=0.45, ea=2.9e3, diameter=3.7e-3, massden=0.06)
    return mod.MoorDynCfg(nbodies=2, t_ic=0.02, nsub=8, start=start,
                          ramptime=ramptime, fric=0.2, lines=(
        mod.MoorDynLine(0, (0.0, 0.0, 0.0), (-0.1, 0.0, -0.05), nseg=6,
                        breaktension=40.0, **line),
        mod.MoorDynLine(1, (1.0, 0.4, 0.05), (0.1, 0.0, -0.05), nseg=4,
                        zbot=0.05, **line)))


def test_moordyn_lines_match_jax():
    jfts, fts = bodies(5)
    jcfg = moordyn(jMO, start=0.01, ramptime=0.02)
    cfg = convert.feature(jcfg)
    assert cfg == MO.MoorDynCfg(**{f.name: getattr(cfg, f.name) for f in
                                   dataclasses.fields(MO.MoorDynCfg)})
    jms = jcfg.init_state(jfts)
    ms = cfg.init_state(fts)
    close(ms.pos, jms.pos, 1e-4, "init pos")
    assert not ms.vel.any()
    # one step's advance of the lines to moved bodies, from the JAX nodes
    jfts2, fts2 = bodies(6)
    ms0 = convert.moorstate(jms, device="cpu")
    jadv = jcfg.advance(jms, jfts2, jnp.float32(3e-4))
    adv = cfg.advance(ms0, fts2, torch.tensor(3e-4))
    close(adv.pos, jadv.pos, 1e-4, "advance pos")
    close(adv.vel, jadv.vel, 1e-4, "advance vel")
    np.testing.assert_array_equal(adv.broken.numpy(), np.asarray(jadv.broken))
    close(cfg.fairlead_tensions(adv), jcfg.fairlead_tensions(jadv), 1e-4)
    for tabs in (0.0, 0.02, 1.0):
        for got, want in zip(cfg.forces(fts2, adv, tabs=torch.tensor(tabs)),
                             jcfg.forces(jfts2, jadv, tabs=jnp.float32(tabs))):
            close(got, want, 1e-4, f"forces at {tabs}")
    # the fairlead node sits on the body's fairlead point
    pf, _ = cfg._fairlead_kin(fts2)
    for k, ln in enumerate(cfg.lines):
        close(adv.pos[k, ln.nseg], pf[k], 1e-6)


# ---------------------------------------------------------------------------
# Chrono links
# ---------------------------------------------------------------------------

def link_set(mod, kind):
    """A two-body set with link ``kind`` and, in the sums, a spring and a
    torsional hinge."""
    links = {
        "hinge": [mod.ChLink("hinge", 0, -1, rotpoint=(0.4, 0.4, 0.3),
                             rotvector=(0.0, 1.0, 0.2), stiffness=3.0,
                             damping=0.5)],
        "spheric": [mod.ChLink("spheric", 0, 1, rotpoint=(0.5, 0.5, 0.5))],
        "pointline": [mod.ChLink("pointline", 1, -1, rotpoint=(0.6, 0.3, 0.4),
                                 slidevector=(0.2, 0.0, 1.0))],
        "spring": [mod.ChLink("spring", 0, 1, pt1=(0.3, 0.3, 0.3),
                              pt2=(0.7, 0.6, 0.5), stiffness=200.0,
                              damping=3.0, restlength=0.3)],
        "coulomb": [mod.ChLink("coulomb", 1, -1, pt1=(0.6, 0.6, 0.6),
                               pt2=(0.6, 0.6, 1.0), restlength=0.3,
                               coulomb=2.0)],
        "pulley": [mod.ChLink("pulley", 0, 1, rotvector=(0.0, 0.0, 1.0),
                              radius=0.1, radius2=0.2)],
    }[kind]
    links.append(mod.ChLink("hinge", 1, 0, rotpoint=(0.5, 0.4, 0.5),
                            rotvector=(1.0, 0.0, 0.0), stiffness=1.0,
                            damping=0.2))
    links.append(mod.ChLink("spring", 1, -1, pt1=(0.5, 0.5, 0.6),
                            pt2=(0.5, 0.5, 1.2), stiffness=50.0,
                            restlength=0.5))
    return links


@pytest.mark.parametrize("kind", ["hinge", "spheric", "pointline", "spring",
                                  "coulomb", "pulley"])
def test_solve_constrained_matches_jax(kind):
    jfts, fts = bodies(7)
    centers0 = np.array([[0.45, 0.4, 0.35], [0.55, 0.5, 0.5]])
    jcfg = jCH.make_chrono(link_set(jCH, kind), centers0)
    cfg = convert.feature(jcfg)
    assert cfg == CH.make_chrono(link_set(CH, kind), centers0)
    rng = np.random.default_rng(8)
    mass = np.array([3.0, 2.0], np.float32)
    I0 = np.stack([np.diag(rng.uniform(0.1, 0.3, 3)) for _ in range(2)])
    f, tq = (rng.normal(0, 10, (2, 3)).astype(np.float32) for _ in range(2))
    jR = jFT._euler_rot(jfts.angles)
    R = FT._euler_rot(fts.angles)
    close(R, jR, 1e-6)
    jin = jR @ jnp.asarray(I0, jnp.float32) @ jnp.swapaxes(jR, -1, -2)
    inert = R @ t32(I0) @ R.transpose(-1, -2)
    for got, want in zip(
            CH.spring_forces(cfg, R, fts.center, fts.fvel, fts.fomega),
            jCH.spring_forces(jcfg, jR, jfts.center, jfts.fvel,
                              jfts.fomega)):
        close(got, want, 1e-4, "springs")
    close(CH.hinge_torsion(cfg, R, fts.fomega, fts.angles),
          jCH.hinge_torsion(jcfg, jR, jfts.fomega, jfts.angles), 1e-4)
    dt = np.float32(1e-3)
    want = jCH.solve_constrained(jcfg, jnp.asarray(mass), jin, jR,
                                 jfts.center, jfts.fvel, jfts.fomega,
                                 jnp.asarray(f), jnp.asarray(tq),
                                 jnp.asarray(dt))
    got = CH.solve_constrained(cfg, t32(mass), inert, R, fts.center, fts.fvel,
                               fts.fomega, t32(f), t32(tq), torch.tensor(dt))
    for g, w, name in zip(got, want, ("linear", "angular")):
        close(g, w, 1e-4, name)


# ---------------------------------------------------------------------------
# mesh contact
# ---------------------------------------------------------------------------

def box_tris(lo, hi):
    """The 12 triangles of the box [lo, hi]."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    c = np.array([[lo[0] if i & 1 == 0 else hi[0],
                   lo[1] if i & 2 == 0 else hi[1],
                   lo[2] if i & 4 == 0 else hi[2]] for i in range(8)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    return np.array([[c[a], c[b], c[d]] for a, b, cc, d in quads]
                    + [[c[b], c[cc], c[d]] for a, b, cc, d in quads])


def test_closest_on_tri_matches_jax():
    rng = np.random.default_rng(9)
    tri = rng.uniform(-1, 1, (40, 3, 3)).astype(np.float32)
    p = rng.uniform(-2, 2, (40, 25, 3)).astype(np.float32)
    args = [p, tri[:, None, 0], tri[:, None, 1], tri[:, None, 2]]
    want = np.asarray(jCC.closest_on_tri(*(jnp.asarray(x) for x in args)))
    got = CC.closest_on_tri(*(t32(x) for x in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # every region reached: vertices, edges and faces
    assert len(np.unique(np.round(want, 4).reshape(-1, 3), axis=0)) > 500


def contact_bodies():
    box = box_tris((0.4, 0.4, 0.29), (0.6, 0.55, 0.45))
    floor = box_tris((0.0, 0.0, 0.0), (1.0, 1.0, 0.3))
    center0 = np.array([0.5, 0.475, 0.37])
    return [dict(ft=1, tris=box, center0=center0, mass=2.0, young=5e5,
                 restitu=0.3),
            dict(ft=-1, tris=floor, kfric=0.2)]


def test_contact_forces_match_jax():
    jfts, fts = bodies(10)
    jcc = jCC.make_chcontact(contact_bodies(), dp=0.05)
    cc = CC.make_chcontact(contact_bodies(), dp=0.05)
    conv = convert.chcontactcfg(jcc)
    for f in dataclasses.fields(CC.ChContactCfg):
        np.testing.assert_array_equal(getattr(cc, f.name),
                                      getattr(conv, f.name), err_msg=f.name)
    # the bodies near their initial pose, so the box's points reach the floor
    fts.center[1] = torch.tensor([0.5, 0.475, 0.368])
    fts.angles.mul_(0.05)
    jfts = jFT.FloatingState(**{k: jnp.asarray(getattr(fts, k).numpy())
                                for k in BODY})
    jR = jFT._euler_rot(jfts.angles)
    R = FT._euler_rot(fts.angles)
    dt = np.float32(2e-4)
    want = jCC.contact_forces(jcc, 2, jR, jfts.center, jfts.fvel,
                              jfts.fomega, jnp.asarray(dt))
    got = CC.contact_forces(cc, 2, R, fts.center, fts.fvel, fts.fomega,
                            torch.tensor(dt), max_pairs=300)
    assert np.abs(np.asarray(want[0][1])).max() > 0
    for g, w, name in zip(got, want, ("force", "torque", "dt term")):
        close(g, w, 1e-4, name)


# ---------------------------------------------------------------------------
# run_floating with every coupling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("predictor", [True, False])
def test_run_floating_with_couplings_matches_jax(predictor):
    from test_torch_floating import csps, random_bodies
    csp, jcsp = csps(False)
    r = random_bodies(False, 11)
    jcfg, _ = jFT.make_floating(r["bodies"], [500.0, 800.0], jcsp)
    jfts = jFT.FloatingState(**{k: jnp.asarray(v) for k, v in r["ft"].items()})
    fts = FT.FloatingState(**{k: torch.tensor(v) for k, v in r["ft"].items()})
    centers0 = np.asarray(r["ft"]["center"], np.float64)
    links = lambda m: [m.ChLink("hinge", 0, -1, rotpoint=tuple(centers0[0]
                                                                + 0.1),
                                rotvector=(0.0, 1.0, 0.0), stiffness=2.0),
                       m.ChLink("spring", 1, 0, pt1=tuple(centers0[1]),
                                pt2=tuple(centers0[0]), stiffness=30.0,
                                restlength=0.2)]
    jch = jCH.make_chrono(links(jCH), centers0)
    bd = contact_bodies()
    bd[0]["center0"] = centers0[1]
    bd[0]["tris"] = bd[0]["tris"] - np.array([0.5, 0.475, 0.37]) + centers0[1]
    jcc = jCC.make_chcontact(bd, dp=0.05)
    rng = np.random.default_rng(12)
    ext = rng.normal(0, 3, (2, 2, 3)).astype(np.float32)
    dt = np.float32(2e-3)
    jpos, jvel, jnew = jFT.run_floating(
        jcfg, jcsp, jfts, 0.3, jnp.asarray(dt), predictor,
        jnp.asarray(r["pos"]), jnp.asarray(r["vel"]), jnp.asarray(r["code"]),
        jnp.asarray(r["ace"]), ext_face=jnp.asarray(ext[0]),
        ext_fomegaace=jnp.asarray(ext[1]), chrono=jch, chcontact=jcc)
    pos, vel, new = FT.run_floating(
        convert.floatingcfg(jcfg), csp, fts, torch.tensor(0.3),
        torch.tensor(dt), predictor, torch.tensor(r["pos"]),
        torch.tensor(r["vel"]), torch.tensor(r["code"].astype(np.int32)),
        torch.tensor(r["ace"]), ext_face=t32(ext[0]),
        ext_fomegaace=t32(ext[1]), chrono=convert.feature(jch),
        chcontact=convert.chcontactcfg(jcc))
    for got, want in ((pos, jpos), (vel, jvel)):
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
    for k in BODY:
        close(getattr(new, k), getattr(jnew, k), 1e-4, k)
    # the couplings show: without them the bodies' velocities differ
    _, vel0, _ = FT.run_floating(
        convert.floatingcfg(jcfg), csp, fts, torch.tensor(0.3),
        torch.tensor(dt), predictor, torch.tensor(r["pos"]),
        torch.tensor(r["vel"]), torch.tensor(r["code"].astype(np.int32)),
        torch.tensor(r["ace"]))
    assert (vel0 - vel).abs().max() > 1e-3 * vel.abs().max()


STEP_PROPS = dict(young=1e6, poisson=0.3, kfric=0.45, restitu=0.2)
NSTEPS = 3


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def resting_box(dp=0.05):
    """JAX ``floatingbox2d`` with a dense box on the floor, sunk 0.1 dp into
    it, and the fluid moving at 0.3 m/s: (JAX case, JAX state)."""
    jcase = jcases.floatingbox2d(dp=dp, box_pos=(0.9, dp), box_rho=1500.0)
    st = jcase.state
    code = np.asarray(st.code)
    isft = jtd.code_type(code) == jtd.TYPE_FLOATING
    pos = np.array(st.pos)
    pos[isft, 2] -= 0.1 * dp
    vel = np.zeros_like(pos)
    vel[jtd.code_type(code) == jtd.TYPE_FLUID, 0] = 0.3
    jcfg, jft = jFT.make_floating([pos[isft]], [1500.0], jcase.csp)
    st = dataclasses.replace(st, pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                             ft=jft)
    return dataclasses.replace(jcase, meta=dict(jcase.meta, ftcfg=jcfg)), st


def couplings(jcase, st, kind):
    """JAX ``Features`` of the box with DEM and ``kind``: "moordyn" (one
    line to an anchor on the floor) or "hinge" (a hinge at the box's
    left foot and a spring to the ceiling)."""
    jcfg = jcase.meta["ftcfg"]
    dem = jDEM.make_dem(jcase.csp, np.asarray(st.code), jcfg,
                        float_props=[STEP_PROPS])
    c0 = np.asarray(st.ft.center, np.float64)[0]
    if kind == "moordyn":
        moor = jMO.MoorDynCfg(nbodies=1, t_ic=0.01, nsub=4, lines=(
            jMO.MoorDynLine(0, (c0[0] - 0.4, 0.0, 0.0), (-0.1, 0.0, 0.05),
                            length0=0.41, ea=2.9e3, nseg=5, diameter=3.7e-3,
                            massden=0.06),))
        return jFeatures(floating=jcfg, dem=dem, moorings=moor)
    foot = (c0[0] - 0.1, 0.0, c0[2] - 0.1)
    links = [jCH.ChLink("hinge", 0, -1, rotpoint=foot,
                        rotvector=(0.0, 1.0, 0.0)),
             jCH.ChLink("spring", 0, -1, pt1=(c0[0] + 0.1, 0.0, c0[2] + 0.1),
                        pt2=(c0[0] + 0.1, 0.0, 1.0), stiffness=400.0,
                        damping=5.0, restlength=0.3)]
    return jFeatures(floating=jcfg, dem=dem,
                     chrono=jCH.make_chrono(links, c0[None]))


@pytest.mark.parametrize("kind", ["moordyn", "hinge"])
def test_coupled_box_steps_match_jax(kind):
    jcase, st0 = resting_box()
    jfeats = couplings(jcase, st0, kind)
    jopts = jF.SolverOpts(use_pallas=False, **box_opts(jtd))
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jcase.dom, jfeats))
    jcarry = jW.make_carry(st0, jcase.csp, jopts, jfeats, dom=jcase.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    dom = convert.domain(dataclasses.asdict(jcase.dom))
    arrays = {k: np.asarray(getattr(st0, k))
              for k in ("pos", "vel", "rho", "code", "idp")}
    arrays["ft"] = {k: np.asarray(getattr(st0.ft, k)) for k in BODY}
    feats = convert.features(jfeats, idp=arrays["idp"])
    opts = P.SolverOpts(**box_opts(td))
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts,
                         dom, feats)
    step = P.make_step(csp, opts, dom, feats)
    for _ in range(NSTEPS):
        carry = step(carry)
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert carry.overflow == 0

    st, jst = carry.st, jcarry.st
    np.testing.assert_allclose(by_id(st, "pos"), np.asarray(jst.pos),
                               rtol=0, atol=1e-4 * csp.dp)
    np.testing.assert_allclose(by_id(st, "rho"), np.asarray(jst.rho),
                               rtol=1e-5)
    np.testing.assert_allclose(st.ft.center.numpy(), np.asarray(jst.ft.center),
                               rtol=0, atol=1e-4 * csp.dp)
    for k in ("fvel", "fomega"):
        w = np.asarray(getattr(jst.ft, k))
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(getattr(st.ft, k).numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    if kind == "moordyn":
        np.testing.assert_allclose(carry.moor.pos.numpy(),
                                   np.asarray(jcarry.moor.pos), rtol=0,
                                   atol=1e-4 * csp.dp)
    # DEM acted: the box's step differs from one without contact
    nodem = dataclasses.replace(feats, dem=None)
    c2 = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom,
                      nodem)
    c2 = P.make_step(csp, opts, dom, nodem)(c2)
    c1 = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom,
                      feats)
    c1 = step(c1)
    assert (c1.st.ft.fvel - c2.st.ft.fvel).abs().max() > 1e-6


def two_boxes(dp=0.05):
    """A 2D tank with two boxes of 16 particles on its floor, sunk 0.1 dp:
    body 0 at rest, body 1 left of it moving right at 1 m/s and turning at
    8 rad/s, its right column 1e-3 m short of a cell face.  (JAX csp, dom,
    state, Features with DEM)."""
    csp = jtd.make_ctesph(simulate2d=True, dp=dp, hswl=0.3, coefh=1.0,
                          visco=0.05, coefsound=20.0)
    d = jcases.Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (1.2, 0, 0.3), ptype=jtd.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (1.2, 0, 0.8), ptype=jtd.TYPE_FIXED, mk=0,
          faces="bottom|left|right")
    d.box((0.65, 0, 0.05), (0.8, 0, 0.2), ptype=jtd.TYPE_FLOATING, mk=0)
    d.box((0.25, 0, 0.05), (0.4, 0, 0.2), ptype=jtd.TYPE_FLOATING, mk=1)
    pos, code = d.build()
    dom = jcases._make_domain(csp, pos,
                              cellcap=jcases.lattice_cellcap(csp, 2.0))
    ft = jtd.code_type(code) == jtd.TYPE_FLOATING
    body = np.where(ft, code & 0xFFFF, -1)
    x1 = pos[body == 1, 0].max()
    face = dom.posmin[0] + np.ceil((x1 - dom.posmin[0]) / dom.scell) \
        * dom.scell
    pos[body == 1, 0] += face - 1e-3 - x1
    pos[ft, 2] -= 0.1 * dp
    jcfg, jft = jFT.make_floating([pos[body == 0], pos[body == 1]],
                                  [1500.0, 1500.0], csp)
    om = 8.0
    r = pos[body == 1] - np.asarray(jft.center)[1]
    vel = np.zeros_like(pos)
    vel[body == 1] = np.stack([1.0 + om * r[:, 2], 0 * r[:, 0],
                               -om * r[:, 0]], 1)
    jft = dataclasses.replace(
        jft, fvel=jnp.asarray([[0, 0, 0], [1.0, 0, 0]], jnp.float32),
        fomega=jnp.asarray([[0, 0, 0], [0, om, 0]], jnp.float32))
    st = dataclasses.replace(jcases._make_state(csp, pos, code, zsurf=0.3),
                             pos=jnp.asarray(pos, jnp.float32),
                             vel=jnp.asarray(vel, jnp.float32), ft=jft)
    dem = jDEM.make_dem(csp, np.asarray(st.code), jcfg,
                        float_props=[STEP_PROPS, STEP_PROPS])
    return csp, dom, st, jFeatures(floating=jcfg, dem=dem)


def stale_candidates(dom, carry):
    """Pairs of a floating target and another body's particle in the 3x3
    cells around it by the current positions but not by the layout's
    cells, or the other way round: DEM's candidates that JAX's fresh
    divide and the port's stale layout disagree on."""
    st = carry.st
    nx, ny, _ = dom.nc
    cur = cd.cell_coords(dom, st.pos)
    lay = carry.cells.cell.long()
    lx, lz = lay % nx, lay // (nx * ny)
    fl = td.is_floating(st.code)
    body = torch.where(fl, st.code & 0xFFFF, -1)
    t = torch.nonzero(fl).flatten()
    other = fl[None, :] & (body[None, :] != body[t, None])

    def near(x, z):
        return (((x[None, :] - cur[t, 0, None]).abs() <= 1)
                & ((z[None, :] - cur[t, 2, None]).abs() <= 1))

    return int((other & (near(cur[:, 0], cur[:, 2])
                         != near(lx, lz))).sum())


def test_dem_dt_over_a_stale_layout_matches_jax():
    """15 steps of two boxes in contact range: the port's DEM reads the
    cells of its last divide, JAX's divides at every step.  Between two
    rebuilds the moving box's particles change cells, so the candidate
    pairs of the dt term differ; the dt sequence (SaveDt rows) within rtol
    1e-5 and positions within 1e-4 dp by id, as JAX's."""
    nsteps = 15
    csp, dom, st0, jfeats = two_boxes()
    kw = dict(tdensity=jtd.TpDensity.FOURTAKAS, with_floating=True)
    jopts = jF.SolverOpts(use_pallas=False, savedt=nsteps, **kw)
    jstep = jax.jit(jW.make_step(csp, jopts, dom, jfeats))
    jcarry = jW.make_carry(st0, csp, jopts, jfeats, dom=dom)
    for _ in range(nsteps):
        jcarry = jstep(jcarry)
    pcsp = convert.ctesph(dataclasses.asdict(csp))
    pdom = convert.domain(dataclasses.asdict(dom))
    arrays = {k: np.asarray(getattr(st0, k))
              for k in ("pos", "vel", "rho", "code", "idp")}
    arrays["ft"] = {k: np.asarray(getattr(st0.ft, k)) for k in BODY}
    feats = convert.features(jfeats, idp=arrays["idp"])
    opts = P.SolverOpts(savedt=nsteps, tdensity=td.TpDensity.FOURTAKAS,
                        with_floating=True)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), pcsp, opts,
                         pdom, feats)
    step = P.make_step(pcsp, opts, pdom, feats)
    stale = 0
    for _ in range(nsteps):
        carry = step(carry)
        if not carry.rebuild:
            stale += stale_candidates(pdom, carry)
    assert stale > 0 and carry.nrebuild >= 2 and carry.overflow == 0
    jd, pd_ = np.asarray(jcarry.dthist), carry.dthist.numpy()
    # DEM's term sets the viscdt max of some steps: without it, lower
    nodem = dataclasses.replace(feats, dem=None)
    c2 = P.make_carry(convert.simstate(arrays, device="cpu"), pcsp, opts,
                      pdom, nodem)
    step2 = P.make_step(pcsp, opts, pdom, nodem)
    for _ in range(nsteps):
        c2 = step2(c2)
    assert (c2.dthist[:, 5].numpy() < 0.9 * pd_[:, 5]).sum() >= 3
    np.testing.assert_allclose(pd_[:, 1], jd[:, 1], rtol=1e-5)
    np.testing.assert_allclose(pd_[:, 5], jd[:, 5], rtol=1e-5)
    np.testing.assert_allclose(by_id(carry.st, "pos"),
                               np.asarray(jcarry.st.pos), rtol=0,
                               atol=1e-4 * csp.dp)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

_CASE = """<?xml version="1.0"?>
<case>
 <casedef>
  <constantsdef>
   <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/><hswl value="0" auto="true"/>
   <gamma value="7"/><speedsystem value="0" auto="true"/><coefsound value="20"/>
   <speedsound value="0" auto="true"/><coefh value="1.0"/><cflnumber value="0.2"/>
  </constantsdef>
  <mkconfig boundcount="240" fluidcount="10"/>
  <geometry>
   <definition dp="0.05"><pointmin x="{lo}" y="0" z="{lo}"/><pointmax x="2" y="0" z="1.5"/></definition>
   <commands><mainlist>
    {draw}
   </mainlist></commands>
  </geometry>
  <floatings>
   {floating}
  </floatings>
  {properties}
 </casedef>
 <execution>
  <special>{special}</special>
  <parameters>
   {params}
   <parameter key="TimeMax" value="{tmax}"/><parameter key="TimeOut" value="{tout}"/>
  </parameters>
 </execution>
</case>"""
_TANK = """<setmkbound mk="0"/><drawbox><boxfill>bottom|left|right</boxfill>
     <point x="0" y="0" z="0"/><size x="2" y="0" z="1.2"/></drawbox>
    <setmkbound mk="1"/><drawbox><boxfill>solid</boxfill>
     <point x="0.5" y="0" z="0.6"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0" y="0" z="0.05"/><size x="2" y="0" z="0.4"/></drawbox>"""
_MATS = """<?xml version="1.0"?>
<materials>
 <property name="steel">
  <Young_Modulus value="2.1e11"/><PoissonRatio value="0.3"/>
  <Restitution_Coefficient value="0.7"/><Kfric value="0.45"/>
 </property>
 <property name="pvc">
  <Young_Modulus value="3e9"/><PoissonRatio value="0.3"/>
  <Restitution_Coefficient value="0.6"/><Kfric value="0.45"/>
 </property>
</materials>"""
_MOORDYN = """<?xml version="1.0"?>
<moordyn>
 <solverOptions><waterDepth value="0.5"/><tmaxIC value="0.01"/></solverOptions>
 <bodies><body ref="45"/></bodies>
 <connects><connect conref="1" x="0.2" y="0.0" z="0.1" M="1" V="0.1"/></connects>
 <lines>
  <linedefault><ea value="2.9e3"/><ba value="-0.8"/>
   <diameter value="3.7e-3"/><massDenInAir value="0.06"/></linedefault>
  <line>
   <vesselconnection bodyref="45" x="0.25" y="0.0" z="0.45"/>
   <fixconnection x="-0.1" y="0.0" z="0.0"/>
   <length value="0.6"/><segments value="8"/>
   <ea value="3.1e3"/>
  </line>
  <line>
   <vesselconnection bodyref="45" x="0.35" y="0.0" z="0.45"/>
   <connect conref="1"/>
   <length value="0.3"/><segments value="5"/>
  </line>
 </lines>
</moordyn>"""


def _cube_obj(side, center):
    c = np.asarray(center, float)
    h = side / 2
    v = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                  for z in (-h, h)]) + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    return "\n".join(["v %g %g %g" % tuple(p) for p in v]
                     + ["f %d %d %d %d" % tuple(i + 1 for i in q)
                        for q in quads])


CASES = {
    "dem": dict(
        draw=_TANK,
        floating='<floating mkbound="1" rhopbody="500" property="pvc">'
                 '<translationDOF x="1" y="0" z="1"/>'
                 '<rotationDOF x="0" y="1" z="0"/>'
                 '<linearvelini x="0.5" y="0" z="0"/></floating>',
        properties='<properties><propertyfile file="mats.xml" '
                   'path="materials"/><links><link mkbound="0" '
                   'property="steel"/></links></properties>',
        params='<parameter key="RigidAlgorithm" value="2"/>'),
    "moorings": dict(
        lo=-0.5,
        draw="""<setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="-0.4" y="0" z="0"/><size x="1.2" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="-0.35" y="0" z="0.05"/><size x="1.0" y="0" z="0.3"/></drawbox>
    <setmkbound mk="45"/><drawbox><boxfill>solid</boxfill>
     <point x="0.25" y="0" z="0.4"/><size x="0.1" y="0" z="0.1"/></drawbox>""",
        floating='<floating mkbound="45"><massbody value="0.5"/></floating>',
        special='<moorings><start value="0.001" ramptime="0.002"/>'
                '<mooredfloatings><floating mkbound="45"/></mooredfloatings>'
                '<moordyn file="moordyn.xml"/></moorings>'),
    "chrono": dict(
        draw=_TANK,
        floating='<floating mkbound="1"><rhopbody value="500"/></floating>',
        properties='<properties><links><link mkbound="0" property="steel"/>'
                   '<link mkbound="1" property="steel"/></links>'
                   '<property name="steel"><Young_Modulus value="2e6"/>'
                   '<PoissonRatio value="0.3"/><Kfric value="0.4"/>'
                   '<Restitution_Coefficient value="0.6"/></property>'
                   '</properties>',
        special="""<chrono>
    <scaleforce><body mkbound="1" x="0.5" y="1" z="1"/></scaleforce>
    <collision activate="true"><distancedp value="0.5"/></collision>
    <bodyfixed id="ground" mkbound="0" modelfile="floor.obj"/>
    <bodyfloating id="box" mkbound="1" modelfile="box.obj"/>
    <link_hinge idbody1="box" idbody2="ground">
     <rotpoint x="0.6" y="0" z="0.7"/><rotvector x="0" y="1" z="0"/>
     <stiffness value="2"/><damping value="0.5"/></link_hinge>
    <link_linearspring idbody1="ground" idbody2="box">
     <point_fb1 x="0.6" y="0" z="1.2"/><point_fb2 x="0.6" y="0" z="0.7"/>
     <stiffness value="300"/><damping value="5"/><rest_length value="0.5"/>
    </link_linearspring>
    <link_pointline idbody1="box"><rotpoint x="0.6" y="0" z="0.7"/>
     <slidingvector x="1" y="0" z="0"/></link_pointline>
   </chrono>"""),
}


def write_case(directory, name, tmax=0.1, tout=0.05):
    os.makedirs(directory, exist_ok=True)
    kw = dict(lo=0, draw="", floating="", properties="", special="",
              params="", tmax=tmax, tout=tout)
    kw.update(CASES[name])
    with open(os.path.join(directory, "mats.xml"), "w") as f:
        f.write(_MATS)
    with open(os.path.join(directory, "moordyn.xml"), "w") as f:
        f.write(_MOORDYN)
    with open(os.path.join(directory, "box.obj"), "w") as f:
        f.write(_cube_obj(0.2, (0.6, 0.0, 0.7)))
    with open(os.path.join(directory, "floor.obj"), "w") as f:
        f.write("v -1 -1 0\nv 3 -1 0\nv 3 1 0\nv -1 1 0\nf 1 2 3 4\n")
    path = os.path.join(directory, f"{name}_Def.xml")
    with open(path, "w") as f:
        f.write(_CASE.format(**kw))
    return path


def _table_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", list(CASES))
def test_coupling_loads_match_jax(name, tmp_path):
    path = write_case(tmp_path, name)
    jres = jX.load_case(path)
    pres = X.load_case(path, device="cpu")
    jf, pf = jres[0].meta["features"], pres[0].meta["features"]
    # the id-keyed and the mesh tables compare array by array, the rest
    # through assert_loads_equal
    if name == "dem":
        assert pf.dem is not None
        want = convert.demcfg(jf.dem, np.asarray(jres[0].state.idp))
        for k, v in _table_fields(want).items():
            np.testing.assert_array_equal(getattr(pf.dem, k), v, err_msg=k)
    if name == "chrono":
        assert pf.chrono is not None and pf.chcontact is not None
        assert [ln.type for ln in pf.chrono.links] == ["hinge", "spring",
                                                       "pointline"]
        want = convert.chcontactcfg(jf.chcontact)
        for k, v in _table_fields(want).items():
            np.testing.assert_array_equal(getattr(pf.chcontact, k), v,
                                          err_msg=k)
        assert pf.floating.scaleforce == (0.5, 1.0, 1.0)
    if name == "moorings":
        assert len(pf.moorings.lines) == 2 and pf.moorings.nsub >= 1
    strip = dict(dem=None, chcontact=None)
    jres[0].meta["features"] = dataclasses.replace(jf, **strip)
    pres[0].meta["features"] = dataclasses.replace(pf, **strip)
    assert_loads_equal(jres, pres)


# ---------------------------------------------------------------------------
# output and the command line
# ---------------------------------------------------------------------------

def test_save_moorings_matches_jax(tmp_path):
    jcfg = moordyn(jMO)
    # seeded nodes around each line's chord, the first line broken
    rng = np.random.default_rng(13)
    ends = np.array([[[0.0, 0.0, 0.0], [0.4, 0.1, 0.3]],
                     [[1.0, 0.4, 0.05], [0.7, 0.2, 0.35]]])
    frac = np.linspace(0.0, 1.0, 7)[None, :, None]
    pos = ends[:, :1] * (1 - frac) + ends[:, 1:] * frac
    pos = pos + rng.normal(0, 0.01, pos.shape)
    jms = jMO.MoorState(pos=jnp.asarray(pos, jnp.float32),
                        vel=jnp.asarray(rng.normal(0, 0.1, pos.shape),
                                        jnp.float32),
                        broken=jnp.asarray([True, False]))
    ms = convert.moorstate(jms, device="cpu")
    outs = {}
    for label, cfg, moor, manager in (
            ("jax", jcfg, jms, jOUT.OutputManager),
            ("port", convert.feature(jcfg), ms, OUT.OutputManager)):
        d = tmp_path / label
        os.makedirs(d)
        sim = types.SimpleNamespace(carry=types.SimpleNamespace(moor=moor),
                                    part=3, time=0.125)
        m = types.SimpleNamespace(feats=types.SimpleNamespace(moorings=cfg),
                                  dirout=str(d))
        if label == "jax":
            manager.save_moorings(m, sim)
        else:
            manager.save_moorings(m, sim, PD.HostCopy(moor))
        outs[label] = d
    vtk = os.path.join("MooringsVtk", "MooringsLines_0003.vtk")
    assert (outs["port"] / vtk).read_bytes() == (outs["jax"] / vtk).read_bytes()
    rows = {k: (v / "MooringsPoints.csv").read_text().splitlines()
            for k, v in outs.items()}
    assert rows["port"][0] == rows["jax"][0] and len(rows["port"]) == 3
    got = np.array([r.split(";") for r in rows["port"][1:]], float)
    want = np.array([r.split(";") for r in rows["jax"][1:]], float)
    for col, name in enumerate(rows["jax"][0].split(";")):
        w = want[:, col]
        np.testing.assert_allclose(got[:, col], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_cli_runs_a_moored_case_and_gates_a_chrono_restart(tmp_path):
    path = write_case(tmp_path / "moor", "moorings", tmax=0.001, tout=0.0005)
    out = tmp_path / "out"
    assert cli.main(["-cpu", "-case", path, "-sv:binx", "-dirout",
                     str(out)]) == 0
    assert sorted(os.listdir(out / "MooringsVtk")) == [
        f"MooringsLines_{k:04d}.vtk" for k in range(3)]
    rows = (out / "MooringsPoints.csv").read_text().splitlines()
    assert len(rows) == 1 + 3 * 2
    # a restart of the Chrono case: refused without -restartchrono, as the
    # reference and JAX refuse it, and run with it
    path = write_case(tmp_path / "chrono", "chrono", tmax=0.0004,
                      tout=0.0002)
    first = tmp_path / "first"
    assert cli.main(["-cpu", "-case", path, "-sv:binx", "-dirout",
                     str(first)]) == 0
    again = ["-cpu", "-case", path, "-partbegin:1", str(first), "-dirout",
             str(tmp_path / "again")]
    with pytest.raises(SystemExit, match="-restartchrono"):
        cli.main(again)
    assert not (tmp_path / "again").exists()
    assert cli.main(again + ["-restartchrono"]) == 0
    assert (tmp_path / "again" / "Part_0002.bi4").exists()
