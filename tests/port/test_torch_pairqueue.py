"""The queue of in-support slots in the pair kernels' body (csrc/pairbody.cuh
``target_forces``): each target filters its candidates into a queue of at
most ``kQueue`` slots and drains the queue through the pair body, until its
walk ends.  The CPU twin (g++, cellforce_host.cpp) runs that very body, so
every instance of TPU kernels 1-3 (kernel x viscosity x shifting x floating
bodies, under DBC and mDBC walls) is held here against the plain torch
version on a cloud built to hold a target whose queue fills and drains more
than twice, one with exactly ``kQueue`` pairs, one with none, boundary
targets and dead slots; the cloud is checked for these first.  The kernel
itself is held against the twin on the same cloud on the card
(test_torch_cuda.py).

Tolerance: the rule of tests/test_forces.py assert_close (rtol 2e-3 with a
floor of 2e-3 of the largest value on ace, ar, the SPS velocity gradient
and the shifting sums; viscdtmax rtol 1e-3), rtol 4e-3 where the cubic
spline runs (tests/test_forces.py:90), the shifting flags exact: the twin
sums each target's pairs in walk order, the plain version in chunks.
Imports no JAX.
"""

import functools
import os
import re
import shutil

import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops.cuda import build
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

torch.set_num_threads(2)

with open(os.path.join(build.CSRC, "pairbody.cuh")) as _f:
    K_QUEUE = int(re.search(r"constexpr int kQueue = (\d+);", _f.read()).group(1))

SHIFTS = ("NO_BOUND", "NO_FIXED", "FULL")


@functools.cache
def queue_cloud(sim2d, seed=21):
    """The queue cloud's domain, layout, sorted (pos, vel, rho, code) on the
    CPU and kernel size: a dense fluid block (every ninth particle floating,
    two bodies) whose every particle lies within the kernel size of every
    other, over a wall (every third slot moving); a lone fluid target with
    exactly K_QUEUE fluid neighbours on a shell around it; a lone fluid
    particle; one slot of the block inactive before the divide (it sorts
    last) and one made inactive after it (a dead candidate in range)."""
    csp = td.make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25, visco=0.05)
    ks = csp.kernelsize
    rng = np.random.default_rng(seed)
    ny = 0.0 if sim2d else 1.0
    side = 0.55 * ks   # the block's diagonal stays inside the kernel size

    def box(n, lo, hi):
        p = rng.uniform(lo, hi, (n, 3))
        p[:, 1] *= ny
        return p

    wall = box(24, (0.0, 0.0, -0.05), (side, side, 0.0))
    block = box(2 * K_QUEUE + 8, (0.0, 0.0, 0.0), (side, side, side))
    # diagonally off the block, so that the walks cross rows in every
    # direction
    target = np.array([side + 1.5 * ks, (side + 1.5 * ks) * ny,
                       side + 1.5 * ks])
    k = np.arange(K_QUEUE) + 0.5
    if sim2d:
        a = 2 * np.pi * k / K_QUEUE
        shell = np.stack([np.cos(a), 0 * a, np.sin(a)], axis=1)
    else:   # a Fibonacci sphere
        z = 1 - 2 * k / K_QUEUE
        a = np.pi * (1 + 5 ** 0.5) * k
        r = np.sqrt(1 - z * z)
        shell = np.stack([r * np.cos(a), r * np.sin(a), z], axis=1)
    shell = target + 0.35 * ks * shell
    lone = np.array([target[0], target[1], target[2] - 1.5 * ks])
    pos = np.concatenate([wall, block, target[None], shell, lone[None]])
    n, nb, nf = pos.shape[0], wall.shape[0], block.shape[0]
    vel = rng.normal(0, 0.5, (n, 3))
    vel[:nb] = 0.0
    vel[:, 1] *= ny
    rho = rng.uniform(980, 1050, n)
    code = np.full(n, td.code_make(td.TYPE_FLUID, 0), np.int64)
    code[:nb] = td.code_make(td.TYPE_FIXED, 0)
    code[:nb:3] = td.code_make(td.TYPE_MOVING, 1)
    code[nb:nb + nf:9] = td.code_make(td.TYPE_FLOATING, 0)
    code[nb + 4:nb + nf:18] = td.code_make(td.TYPE_FLOATING, 1)
    code[nb + 1] = td.code_set_special(int(code[nb + 1]), td.SPECIAL_OUT_RHOP)
    f32 = dict(dtype=torch.float32)
    pos_t = torch.tensor(pos, **f32)
    dom = cd.make_domain((pos.min(0) - 0.01).tolist(),
                         (pos.max(0) + 0.01).tolist(), ks, simulate2d=sim2d)
    cells, code_t = cd.divide_cells(dom, pos_t,
                                    torch.tensor(code.astype(np.int32)))
    o = cells.order
    pos_t, code_t = pos_t[o], code_t[o].clone()
    stale = int((o == nb + 2).nonzero())
    code_t[stale] = td.code_set_special(int(code_t[stale]), td.SPECIAL_OUT_RHOP)
    return dom, cells, (pos_t, torch.tensor(vel, **f32)[o],
                        torch.tensor(rho, **f32)[o], code_t), ks


def queued(dom, cells, pos, code, ks):
    """In-support slots of every target as the body's filter counts them,
    through the same layout (chip_smoke.pair_walk's walk, with the filter's
    boundary-boundary rule)."""
    live = td.is_active(code) & (cells.cell < dom.ncells)
    bound = td.code_type(code) < td.TYPE_FLOATING
    count = torch.zeros(pos.shape[0], dtype=torch.int64)
    for t, j, valid in F.candidate_chunks(dom, cells, live, 1 << 20):
        rr2 = ((pos[t, None, :] - pos[j]) ** 2).sum(dim=-1)
        count[t] = (valid & (j != t[:, None]) & td.is_active(code)[j]
                    & ~(bound[t, None] & bound[j]) & (rr2 >= td.ALMOSTZERO)
                    & (rr2 < ks * ks)).sum(dim=1)
    return count


def instance(sim2d, tkernel, tvisco, shift, ft, tboundary):
    """(csp, opts, laminar+SPS?, ftomassp) of one kernel instance."""
    lam = tvisco == "LAMINAR_SPS"
    csp = td.make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25,
                         visco=1e-4 if lam else 0.05, viscoboundfactor=0.5,
                         tkernel=td.TpKernel[tkernel], tvisco=td.TpVisco[tvisco])
    opts = F.SolverOpts(
        tvisco=td.TpVisco[tvisco], shiftmode=td.TpShifting[shift],
        tdensity=td.TpDensity["FOURTAKAS" if tboundary == "DBC" else "MOLTENI"],
        tboundary=td.TpBoundary[tboundary], with_floating=ft)
    return csp, opts, lam, (torch.tensor([0.5, 0.3]) * csp.massfluid
                            if ft else None)


def sps_stress(code, seed=22):
    rng = np.random.default_rng(seed)
    tau = torch.tensor(rng.normal(0, 1e-3, (code.shape[0], 6)),
                       dtype=torch.float32)
    return torch.where(td.is_fluid(code)[:, None], tau, 0.0).contiguous()


def assert_close(want, got, rtol):
    for k in ("ace", "ar", "spsgradvel", "shiftposfs"):
        w, g = getattr(want, k), getattr(got, k)
        assert (w is None) == (g is None), k
        if w is not None:
            scale = float(w.abs().max()) + 1e-6
            torch.testing.assert_close(g.cpu(), w.cpu(), rtol=rtol,
                                       atol=rtol * scale, msg=k)
    torch.testing.assert_close(got.viscdtmax.cpu(), want.viscdtmax.cpu(),
                               rtol=1e-3, atol=1e-5)
    if want.shift_blocked is not None:
        assert torch.equal(got.shift_blocked.cpu(), want.shift_blocked.cpu())


# every instance of TPU kernels 1-3: (tkernel, tvisco, shift, ft); the
# shifting mode cycles through the three so that each runs
INSTANCES = [(ker, visc, SHIFTS[(2 * a + b + ft) % 3] if shift else "NONE",
              bool(ft))
             for a, ker in enumerate(("WENDLAND", "CUBIC"))
             for b, visc in enumerate(("ARTIFICIAL", "LAMINAR_SPS"))
             for shift in (0, 1) for ft in (0, 1)]


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")


@pytest.mark.parametrize("sim2d", [False, True])
def test_cloud_holds_every_queue_case(sim2d):
    dom, cells, (pos, vel, rho, code), ks = queue_cloud(sim2d)
    count = queued(dom, cells, pos, code, ks)
    fluid = td.is_fluid(code) & td.is_active(code)
    bound = td.is_bound(code)
    assert int(count[fluid].max()) > 2 * K_QUEUE        # fills more than twice
    assert int((count[fluid] == K_QUEUE).sum()) >= 1    # fills exactly once
    assert int((count[fluid] == 0).sum()) >= 1          # never queues
    assert int((count[bound] > 0).sum()) >= 10          # boundary targets
    # one dead slot sorts last, outside every cell; one is a dead candidate
    # in range of live targets, inside its cell's range
    dead = ~td.is_active(code)
    assert int((dead & (cells.cell == dom.ncells)).sum()) == 1
    stale = int((dead & (cells.cell < dom.ncells)).nonzero())
    near = ((pos - pos[stale]) ** 2).sum(dim=1) < ks * ks
    assert int((near & fluid).sum()) > K_QUEUE


@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("tboundary", ["DBC", "MDBC"])
@pytest.mark.parametrize("tkernel,tvisco,shift,ft", INSTANCES)
def test_twin_matches_plain_on_queue_cloud(gxx, sim2d, tkernel, tvisco, shift,
                                           ft, tboundary):
    dom, cells, (pos, vel, rho, code), _ = queue_cloud(sim2d)
    csp, opts, lam, ftomassp = instance(sim2d, tkernel, tvisco, shift, ft,
                                        tboundary)
    run = (csp, opts, dom, cells, pos, vel, rho, code,
           sps_stress(code) if lam else None, ftomassp)
    launches = dict(CF.launches)
    got = CF.interaction_forces_host_twin(*run)
    assert CF.launches == launches          # the twin is no kernel launch
    want = F.interaction_forces_plain(*run)
    assert_close(want, got, 4e-3 if tkernel == "CUBIC" else 2e-3)
    dead = ~td.is_active(code)
    assert not got.ace[dead].any() and not got.ar[dead].any()
