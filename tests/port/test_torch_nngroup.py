"""The lane groups of TPU kernels 4 and 6 (csrc/nnbody.cuh ``NnPass1Lane``):
``kGroup`` lanes share one target, filter its candidates in rounds of
``kRuns`` runs of ``kGroup`` slots that cross row ends, queue the
in-support slots in a ring of ``kGroupQueue`` and drain it through the
pair body, one slot per lane; the lanes' partial sums meet in a
butterfly.  The CPU twin (g++,
nnforce_host.cpp) runs that very body in the card's warps of groups, so
every instance of ``nnforce_p1`` and ``nnforce_fda`` (Wendland or cubic,
with or without the shifting sums, under the three shifting modes and the
four diffusion modes) is held here against the plain torch version,
``forces_nn.pass1_plain``, in 2D and 3D, on a cloud that is first checked
to hold: a target whose in-support count is several times the queue and
not a multiple of ``kGroup``; rows whose lengths are not multiples of
``kGroup``; a target with no candidate; boundary targets; two dead slots
(one sorted last, one stale in a cell range); two phases of different mass
with pairs that the heavy-phase shifting gate drops; fluid targets with a
boundary neighbour in range (NO_BOUND's flag) and without.  The kernels
themselves are held against the twin on the same cloud on the card
(test_torch_cuda.py).

Tolerance: the rule of tests/test_forces.py assert_close (rtol 2e-3 with a
floor of 2e-3 of the largest value on ace, ar, gradvel, etamax and the
shifting sums; the per-target viscdt rtol 1e-3), rtol 4e-3 where the cubic
spline runs (tests/test_forces.py:90), the shifting flags exact: the twin
sums each target's pairs in lane partials, the plain version in chunks.
Two twin runs on the same inputs are bit-equal.  Imports no JAX.
"""

import functools
import os
import re
import shutil

import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu_torch import SolverOpts
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
from dualsphysics_multilayer_tpu_torch.ops.cuda import build
from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF

torch.set_num_threads(2)

with open(os.path.join(build.CSRC, "nnbody.cuh")) as _f:
    _src = _f.read()
K_GROUP = int(re.search(r"constexpr int kGroup = (\d+);", _src).group(1))
K_RUNS = int(re.search(r"constexpr int kRuns = (\d+);", _src).group(1))
K_QUEUE = int(re.search(r"constexpr int kGroupQueue = (\d+);", _src).group(1))

# water and a heavier HBP mud whose power law runs (n != 1)
PHASES = NN.PhaseCfg(phases=(
    NN.Phase(mkfluid=0, rho0=1000.0, csound=20.0, visco=0.05,
             tau_yield=0.0005),
    NN.Phase(mkfluid=1, rho0=1500.0, csound=24.5, visco=0.1,
             tau_yield=0.001, hbp_m=10.0, hbp_n=0.8)))

# every instance of kernels 4 and 6: (pass, tkernel, shiftmode, tvisco,
# tdensity); each shifting mode, diffusion mode and viscous form runs
INSTANCES = [
    ("p1", "WENDLAND", "NONE", "LAMINAR_SPS", "FOURTAKAS"),
    ("p1", "WENDLAND", "NO_BOUND", "CONST_EQ", "MOLTENI"),
    ("p1", "CUBIC", "NONE", "ARTIFICIAL", "FOURTAKAS_FULL"),
    ("p1", "CUBIC", "FULL", "LAMINAR_SPS", "FOURTAKAS"),
    ("fda", "WENDLAND", "NONE", "LAMINAR_SPS", "FOURTAKAS"),
    ("fda", "WENDLAND", "NO_FIXED", "CONST_EQ", "NONE"),
    ("fda", "CUBIC", "NONE", "CONST_EQ", "MOLTENI"),
    ("fda", "CUBIC", "NO_BOUND", "LAMINAR_SPS", "FOURTAKAS"),
]


@functools.cache
def group_cloud(sim2d, seed=31):
    """(csp, domain, layout, sorted (pos, vel, rho, code) on the CPU): a
    dense two-phase block whose every particle lies within the kernel size
    of every other, over a wall, straddling the cell faces at half the
    kernel size so that its walks cross rows; a two-phase strip beside it
    under a sparse mist; a lone fluid particle three cells from the rest;
    one slot of
    the block inactive before the divide (it sorts last) and one made
    inactive after it (a dead candidate in range)."""
    csp = NM.make_nn_csp(simulate2d=sim2d, dp=0.05, phases=PHASES, hswl=0.25)
    ks = csp.kernelsize
    rng = np.random.default_rng(seed)
    ny = 0.0 if sim2d else 1.0
    side = 0.55 * ks   # the block's diagonal stays inside the kernel size

    def box(n, lo, hi):
        p = rng.uniform(lo, hi, (n, 3))
        p[:, 1] *= ny
        return p

    wall = box(80, (0.0, 0.0, -0.05), (side, side, 0.0))
    block = box(3 * K_QUEUE + 13, (0.0, 0.0, 0.0), (side, side, side))
    strip = box(45, (side + 0.2 * ks, 0.0, 0.0), (side + 2.4 * ks, side, side))
    mist = box(12, (side + 0.2 * ks, 0.0, 0.6 * ks),
               (side + 2.4 * ks, side, 2.5 * ks))
    lone = np.array([[side + 5.5 * ks, 0.5 * side * ny, side + 4.5 * ks]])
    pos = np.concatenate([wall, block, strip, mist, lone])
    n, nb = pos.shape[0], wall.shape[0]
    vel = rng.normal(0, 0.5, (n, 3))
    vel[:nb] = 0.0
    vel[:, 1] *= ny
    mk = rng.integers(0, 2, n)
    mk[:nb] = 0
    rho0 = np.where(mk == 1, 1500.0, 1000.0)
    rho = rho0 * rng.uniform(0.99, 1.01, n)
    code = np.array([td.code_make(td.TYPE_FLUID, int(m)) for m in mk], np.int64)
    code[:nb] = td.code_make(td.TYPE_FIXED, 0)
    code[nb + 1] = td.code_set_special(int(code[nb + 1]), td.SPECIAL_OUT_RHOP)
    f32 = dict(dtype=torch.float32)
    pos_t = torch.tensor(pos, **f32)
    dom = cd.make_domain([-0.5 * ks] * 3, (pos.max(0) + 0.01).tolist(), ks,
                         simulate2d=sim2d)
    cells, code_t = cd.divide_cells(dom, pos_t,
                                    torch.tensor(code.astype(np.int32)))
    o = cells.order
    pos_t, code_t = pos_t[o], code_t[o].clone()
    stale = int((o == nb + 2).nonzero())
    code_t[stale] = td.code_set_special(int(code_t[stale]), td.SPECIAL_OUT_RHOP)
    return csp, dom, cells, (pos_t, torch.tensor(vel, **f32)[o],
                             torch.tensor(rho, **f32)[o], code_t)


def walks(csp, dom, cells, pos, code):
    """{live target: (the slot counts of the rows it walks, the slots it
    walks, the filter's verdict on each)} in walk order, the filter being
    the group's: j != i, live, not boundary-boundary, ALMOSTZERO <= rr2 <=
    kernelsize^2."""
    ncx, ncy, ncz = dom.nc
    begin = cells.begin.numpy()
    p = pos.numpy()
    live = td.is_active(code).numpy()
    bound = (td.code_type(code) < td.TYPE_FLOATING).numpy()
    out = {}
    for i in np.nonzero(live & (cells.cell < dom.ncells).numpy())[0]:
        c = int(cells.cell[i])
        cx, cy, cz = c % ncx, (c // ncx) % ncy, c // (ncx * ncy)
        x0, x1 = max(cx - 1, 0), min(cx + 1, ncx - 1)
        rows = [(z * ncy + y) * ncx
                for z in range(max(cz - 1, 0), min(cz + 2, ncz))
                for y in range(max(cy - 1, 0), min(cy + 2, ncy))]
        j = np.concatenate([np.arange(begin[r + x0], begin[r + x1 + 1])
                            for r in rows])
        rr2 = ((p[i] - p[j]) ** 2).sum(axis=1)
        ok = ((j != i) & live[j] & ~(bound[i] & bound[j])
              & (rr2 >= td.ALMOSTZERO) & (rr2 <= csp.kernelsize2))
        out[int(i)] = ([int(begin[r + x1 + 1] - begin[r + x0]) for r in rows],
                       j, ok)
    return out


def forced_drains(walked, n):
    """Drains that a full queue forces, a group with no room for another
    round while another group of its warp is still short of a run, when
    the targets walk in warps of 32 // kGroup groups: the drain rule of
    nnforce.cu pass1_group, counted from the filter's verdicts."""
    forced = 0
    for w0 in range(0, n, 32 // K_GROUP):
        oks = [walked[i][2] if i in walked else np.zeros(0, bool)
               for i in range(w0, min(w0 + 32 // K_GROUP, n))]
        at, pending = [0] * len(oks), [0] * len(oks)
        more = [len(ok) > 0 for ok in oks]
        while any(more) or any(pending):
            for k, ok in enumerate(oks):
                for _ in range(K_RUNS):
                    if more[k]:
                        run = ok[at[k]:at[k] + K_GROUP]
                        pending[k] += int(run.sum())
                        at[k] += len(run)
                        more[k] = len(run) == K_GROUP
            ready = [q >= K_GROUP or not m for q, m in zip(pending, more)]
            crowded = [q > K_QUEUE - K_RUNS * K_GROUP for q in pending]
            if all(ready) or any(crowded):
                forced += not all(ready)
                for k, r in enumerate(ready):
                    while r:
                        pending[k] -= min(pending[k], K_GROUP)
                        r = pending[k] > K_QUEUE - K_RUNS * K_GROUP
    return forced


def run_instance(sim2d, kernel, tkernel, shiftmode, tvisco, tdensity):
    csp0, dom, cells, (pos, vel, rho, code) = group_cloud(sim2d)
    csp = csp0.replace(tkernel=td.TpKernel[tkernel])
    opts = SolverOpts(tvisco=td.TpVisco[tvisco],
                      velgrad=td.TpVelGrad["FDA" if kernel == "fda" else "SPH"],
                      tdensity=td.TpDensity[tdensity],
                      shiftmode=td.TpShifting[shiftmode])
    NN.check_supported_nn(csp, opts, PHASES)
    ch = NN.channels(csp, PHASES, PHASES.tables(csp, "cpu"), rho, code)
    run = (csp, opts, PHASES, dom, cells, pos, vel, rho, ch)
    assert NN.uses_fda(opts) == (kernel == "fda")
    return run


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")


@pytest.mark.parametrize("sim2d", [False, True])
def test_cloud_holds_every_group_case(sim2d):
    csp, dom, cells, (pos, vel, rho, code) = group_cloud(sim2d)
    walked = walks(csp, dom, cells, pos, code)
    bound = (td.code_type(code) < td.TYPE_FLOATING).numpy()
    phase = td.code_value(code).numpy()
    mass = PHASES.tables(csp, "cpu")["mass"].numpy()
    fluid = {i for i in walked if not bound[i]}
    pairs = {i: int(ok.sum()) for i, (_, _, ok) in walked.items()}
    # a target that fills the queue several times over, with a last partial
    # run of lanes
    assert any(pairs[i] > 3 * K_QUEUE and pairs[i] % K_GROUP for i in fluid)
    # walks whose runs cross a row end: a row longer than a run and one
    # shorter, neither a multiple of kGroup, each followed by another row
    # that holds slots
    crossed = [m for rows, _, _ in walked.values()
               for k, m in enumerate(rows[:-1])
               if m % K_GROUP and any(rows[k + 1:])]
    assert any(m > K_GROUP for m in crossed)
    assert any(m < K_GROUP for m in crossed)
    # a target whose rows hold nothing but itself
    assert sum(len(j) == 1 for _, j, _ in walked.values()) == 1
    assert sum(pairs[i] > 0 for i in walked if bound[i]) >= 10
    # warps where a group's full queue forces a drain
    assert forced_drains(walked, pos.shape[0]) >= 1
    # one dead slot sorts last, outside every cell; one is a dead candidate
    # in range of live targets, inside its cell's range
    dead = ~td.is_active(code)
    assert int((dead & (cells.cell == dom.ncells)).sum()) == 1
    stale = int((dead & (cells.cell < dom.ncells)).nonzero())
    near = ((pos - pos[stale]) ** 2).sum(dim=1) <= csp.kernelsize2
    assert sum(bool(near[i]) for i in fluid) > K_QUEUE
    # two phases of different mass, and pairs the heavy-phase gate drops;
    # fluid targets with a boundary neighbour in range and without
    assert {int(phase[i]) for i in fluid} == {0, 1}
    heavy, walls = 0, 0
    for i in fluid:
        _, j, ok = walked[i]
        pj = phase[j]
        heavy += bool((ok & ~bound[j] & (pj != phase[i])
                       & (mass[phase[i]] > mass[pj.clip(0, 1)])).any())
        walls += bool((ok & bound[j]).any())
    assert heavy >= 10
    assert walls >= 10 and sum(pairs[i] > 0 for i in fluid) - walls >= 10


def assert_close(want, got, rtol):
    for k in ("ace", "ar", "gradvel", "etamax", "shift"):
        w, g = getattr(want, k), getattr(got, k)
        assert (w is None) == (g is None), k
        if w is not None:
            scale = float(w.abs().max()) + 1e-6
            torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * scale,
                                       msg=k)
    torch.testing.assert_close(got.viscdt, want.viscdt, rtol=1e-3, atol=1e-5)
    if want.shiftblk is not None:
        assert torch.equal(got.shiftblk, want.shiftblk)


@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("kernel,tkernel,shiftmode,tvisco,tdensity", INSTANCES)
def test_twin_matches_plain_on_group_cloud(gxx, sim2d, kernel, tkernel,
                                           shiftmode, tvisco, tdensity):
    run = run_instance(sim2d, kernel, tkernel, shiftmode, tvisco, tdensity)
    launches = dict(NF.launches)
    got = NF.pass1(*run, twin=True)
    again = NF.pass1(*run, twin=True)
    assert NF.launches == launches          # the twin is no kernel launch
    want = NN.pass1_plain(*run)
    assert_close(want, got, 4e-3 if tkernel == "CUBIC" else 2e-3)
    for k in ("ace", "ar", "viscdt", "gradvel", "etamax", "shift", "shiftblk"):
        g = getattr(got, k)
        assert g is None or torch.equal(g, getattr(again, k)), k
    code = run[-1].kind
    dead = code < 0
    assert not got.ace[dead].any() and not got.ar[dead].any()
    if shiftmode == "NO_BOUND":
        assert got.shiftblk.any() and not got.shiftblk.all()
