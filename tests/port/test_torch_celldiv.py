"""The GPU-layout divide (cell sort + begin index) and the dam-break case
construction against the JAX package."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops.forces import neighbour_ranges

torch.set_num_threads(2)


def cloud(n, seed, sim2d):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 0.5, (n, 3))
    if sim2d:
        pos[:, 1] = 0.0
    code = np.full(n, td.code_make(td.TYPE_FLUID, 0), np.int32)
    code[: n // 5] = td.code_make(td.TYPE_FIXED, 0)
    return pos, code


@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("skin", [0.0, 1.0 / 16.0])
def test_ranges_cover_exactly_the_pairs(sim2d, skin):
    """The 9 (3 in 2D) contiguous ranges of each target hold every particle
    within the kernel support, each once; outside the support they add only
    candidates of the 27 (9) surrounding cells."""
    ks = 0.11
    pos, code = cloud(300, 1, sim2d)
    dom = cd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01, ks,
                         simulate2d=sim2d, skin=skin)
    cells, code2 = cd.divide_cells(dom, torch.tensor(pos, dtype=torch.float32),
                                   torch.tensor(code))
    assert torch.equal(code2, torch.tensor(code))
    order = cells.order.numpy()
    spos = pos[order]
    assert np.all(np.diff(cells.cell.numpy()) >= 0)
    assert int(cells.begin[-1]) == len(pos)
    live = torch.ones(len(pos), dtype=torch.bool)
    starts, lens = neighbour_ranges(dom, cells, live)
    cxyz = np.floor((spos - np.asarray(dom.posmin)) / dom.scell).astype(int)
    for i in range(len(pos)):
        cand = np.concatenate([np.arange(s, s + n) for s, n in
                               zip(starts[i].tolist(), lens[i].tolist())])
        assert len(np.unique(cand)) == len(cand)
        d2 = ((spos - spos[i]) ** 2).sum(axis=1)
        within = set(np.nonzero(d2 < ks * ks)[0].tolist())
        assert within <= set(cand.tolist())
        near = np.abs(cxyz - cxyz[i]).max(axis=1) <= 1
        assert set(cand.tolist()) == set(np.nonzero(near)[0].tolist())


def test_divide_marks_out_pos_and_sorts_dead_last():
    pos, code = cloud(200, 2, False)
    code[5] = td.code_set_special(code[5], td.SPECIAL_OUT_RHOP)   # inactive
    dom = cd.make_domain((0.0, 0.0, 0.0), (0.4, 0.5, 0.5), 0.11)
    outside = pos[:, 0] >= dom.posmax[0]
    assert outside.sum() > 0
    cells, code2 = cd.divide_cells(dom, torch.tensor(pos, dtype=torch.float32),
                                   torch.tensor(code))
    # JAX divide marks the same particles
    _, jcode = jcd.divide(
        jcd.make_domain((0.0, 0.0, 0.0), (0.4, 0.5, 0.5), 0.11, cellcap=200),
        jnp.asarray(pos, jnp.float32), jnp.asarray(code.astype(np.uint32)))
    np.testing.assert_array_equal(code2.numpy(), np.asarray(jcode).astype(np.int32))
    sp = td.code_special(code2.numpy())
    np.testing.assert_array_equal(sp == td.SPECIAL_OUT_POS, outside & (np.arange(200) != 5))
    assert sp[5] == td.SPECIAL_OUT_RHOP
    nlive = int(cells.begin[-1])
    assert nlive == 200 - int((outside | (np.arange(200) == 5)).sum())
    dead = cells.order[nlive:].numpy()
    assert set(dead.tolist()) == set(np.nonzero(outside | (np.arange(200) == 5))[0].tolist())
    assert bool((cells.cell[nlive:] == dom.ncells).all())


@pytest.mark.parametrize("sim2d", [False, True])
def test_make_domain_matches(sim2d):
    lo, hi = (-0.1, 0.0, 0.05), (1.3, 0.7, 0.9)
    want = jcd.make_domain(lo, hi, 0.05, simulate2d=sim2d, skin=1 / 16)
    got = cd.make_domain(lo, hi, 0.05, simulate2d=sim2d, skin=1 / 16)
    assert convert.domain(dataclasses.asdict(want)) == got
    pos = np.random.default_rng(3).uniform(-0.2, 1.4, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        cd.cell_coords(got, torch.tensor(pos)).numpy(),
        np.asarray(jcd.cell_coords(want, jnp.asarray(pos))))


@pytest.mark.parametrize("obstacle", [False, True])
def test_dambreak3d_matches(obstacle):
    kw = dict(dp=0.04, tank=(0.8, 0.4, 0.3), column=(0.2, 0.4, 0.2))
    if obstacle:
        kw = dict(dp=0.05)
    want = jcases.dambreak3d(obstacle=obstacle, **kw)
    got = cases.dambreak3d(obstacle=obstacle, device="cpu", **kw)
    assert got.np_total == want.np_total and got.npb == want.npb
    assert convert.ctesph(dataclasses.asdict(want.csp)) == got.csp
    assert convert.domain(dataclasses.asdict(want.dom)) == got.dom
    st = want.state
    conv = convert.simstate(dict(pos=np.asarray(st.pos), vel=np.asarray(st.vel),
                                 rho=np.asarray(st.rho), code=np.asarray(st.code),
                                 idp=np.asarray(st.idp)), device="cpu")
    for k in ("pos", "vel", "rho", "code", "idp"):
        assert torch.equal(getattr(got.state, k), getattr(conv, k)), k
    # fluid is hydrostatic, walls at rho0
    fluid = td.is_fluid(got.state.code)
    assert float(got.state.rho[~fluid].min()) == got.csp.rhopzero
    assert float(got.state.rho[fluid].max()) > got.csp.rhopzero


def test_convert_rejects_unported_state():
    st = dict(pos=np.zeros((2, 3)), vel=np.zeros((2, 3)), rho=np.ones(2),
              code=np.zeros(2, np.uint32), idp=np.array([0, 0xFFFFFFFF], np.uint32))
    assert convert.simstate(st, device="cpu").idp.tolist() == [0, 0xFFFFFFFF]
    # the Verlet M1 state is ported: it passes through
    m1 = convert.simstate(dict(st, velm1=np.ones((2, 3)), rhom1=np.full(2, 2.0)),
                          device="cpu")
    assert m1.velm1.tolist() == [[1.0] * 3] * 2 and m1.rhom1.tolist() == [2.0] * 2
    with pytest.raises(ValueError):
        convert.simstate(dict(st, code=np.array([0, 1 << 27], np.uint32)),
                         device="cpu")
    assert jtd.CODE_INOUT_SHIFT + 5 == td.CODE_BITS


def test_convert_carries_spstau():
    """The laminar+SPS stress of a JAX state built with need_sps passes
    through; a state without one has none."""
    want = jcases.dambreak3d(dp=0.1, need_sps=True).state
    arrays = {k: np.asarray(getattr(want, k))
              for k in ("pos", "vel", "rho", "code", "idp")}
    tau = np.random.default_rng(0).normal(0, 1e-3, (want.n, 6))
    got = convert.simstate(dict(arrays, spstau=tau), device="cpu").spstau
    assert torch.equal(got, torch.tensor(tau, dtype=torch.float32))
    assert convert.simstate(dict(arrays, spstau=np.asarray(want.spstau)),
                            device="cpu").spstau.shape == (want.n, 6)
    assert convert.simstate(arrays, device="cpu").spstau is None
    port = cases.dambreak3d(dp=0.1, need_sps=True, device="cpu").state
    assert port.spstau.shape == (want.n, 6) and not bool(port.spstau.any())
    assert cases.dambreak3d(dp=0.1, device="cpu").state.spstau is None


def test_convert_pose_defaults_to_zero():
    """A JAX state without a position residual (``pose`` None) starts
    the port's at zero; a given residual passes through."""
    st = dict(pos=np.ones((3, 3)), vel=np.zeros((3, 3)), rho=np.ones(3),
              code=np.zeros(3, np.uint32), idp=np.arange(3, dtype=np.uint32))
    for pose in (None, "absent"):
        arrays = st if pose == "absent" else dict(st, pose=pose)
        got = convert.simstate(arrays, device="cpu").pose
        assert got.dtype == torch.float32 and got.shape == (3, 3)
        assert not bool(got.any())
    pose = np.full((3, 3), 1e-8)
    got = convert.simstate(dict(st, pose=pose), device="cpu").pose
    assert torch.equal(got, torch.tensor(pose, dtype=torch.float32))
