"""The CUDA kernels on the card against their plain torch versions (and
kernels 1-3 against their g++ twins on the queue cloud of
test_torch_pairqueue.py, kernels 4 and 6 on the group cloud of
test_torch_nngroup.py), and steps on the card against the same steps on
the CPU (the floating box and the mDBC dam break among them).  Imports no
JAX, so it runs where only torch is installed:

    python -m pytest --noconftest tests/port/test_torch_cuda.py -m gpu

Without a CUDA device every test skips.  Tolerance: the rule of
tests/test_forces.py assert_close (rtol 2e-3, floor 2e-3 of the largest
value, on ace, ar, the SPS velocity gradient and the shifting sums;
viscdtmax and viscetadtmax rtol 1e-3), as in chip_smoke.py; rtol 4e-3 where
the cubic spline runs (tests/test_forces.py:90); the shifting flags exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
from dualsphysics_multilayer_tpu_torch.tools import probes as PR

DDT = ["NONE", "MOLTENI", "FOURTAKAS", "FOURTAKAS_FULL"]
GEOM = dict(dp=0.04, tank=(0.8, 0.4, 0.3), column=(0.2, 0.4, 0.2),
            obstacle=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    return torch.device("cuda")


def cloud(sim2d, seed, device, n=400, dp=0.05, mixed=False):
    """Jittered fluid over a boundary layer (tests/test_forces.py make_cloud
    at a larger n); ``mixed`` makes every third boundary particle moving and
    every ninth fluid particle floating."""
    rng = np.random.default_rng(seed)
    nb = n // 4
    pos = np.zeros((n, 3))
    pos[:, 0] = rng.uniform(0, 0.5, n)
    pos[:, 1] = 0.0 if sim2d else rng.uniform(0, 0.5, n)
    pos[:nb, 2] = rng.uniform(-dp, 0, nb)
    pos[nb:, 2] = rng.uniform(0, 0.25, n - nb)
    vel = rng.normal(0, 0.5, (n, 3))
    vel[:nb] = 0.0
    if sim2d:
        vel[:, 1] = 0.0
    rho = rng.uniform(980, 1050, n)
    code = np.array([td.code_make(td.TYPE_FIXED, 0)] * nb
                    + [td.code_make(td.TYPE_FLUID, 0)] * (n - nb), np.int32)
    if mixed:
        code[:nb:3] = td.code_make(td.TYPE_MOVING, 1)
        code[nb::9] = td.code_make(td.TYPE_FLOATING, 2)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(pos, **f32), torch.tensor(vel, **f32),
            torch.tensor(rho, **f32), torch.tensor(code, device=device))


def assert_close(want, got, rtol=2e-3):
    for k in ("ace", "ar", "spsgradvel", "shiftposfs"):
        w, g = getattr(want, k), getattr(got, k)
        assert (w is None) == (g is None), k
        if w is not None:
            scale = float(w.abs().max()) + 1e-6
            torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * scale)
    torch.testing.assert_close(got.viscdtmax, want.viscdtmax, rtol=1e-3,
                               atol=1e-5)
    if want.shift_blocked is not None:
        assert torch.equal(got.shift_blocked, want.shift_blocked)


def kernel_vs_plain(csp, opts, dom, pos, vel, rho, code, spstau=None):
    cells, code = cd.divide_cells(dom, pos, code)
    o = cells.order
    args = (pos[o], vel[o], rho[o], code[o])
    tau = None if spstau is None else spstau[o].contiguous()
    launches = dict(CF.launches)
    launches[CF.kernel_name(csp, opts)] += 1
    got = F.interaction_forces(csp, opts, dom, cells, *args, spstau=tau)
    torch.cuda.synchronize()
    assert CF.launches == launches
    rtol = 4e-3 if csp.tkernel == td.TpKernel.CUBIC else 2e-3
    assert_close(F.interaction_forces_plain(csp, opts, dom, cells, *args,
                                            spstau=tau), got, rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("tdensity", DDT)
def test_cuda_kernel_matches_plain(cuda, sim2d, tdensity):
    csp = td.make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25, visco=0.05,
                         viscoboundfactor=0.5)
    opts = F.SolverOpts(tdensity=td.TpDensity[tdensity])
    pos, vel, rho, code = cloud(sim2d, 12, cuda)
    dom = cd.make_domain(pos.min(0).values.tolist(), pos.max(0).values.tolist(),
                         csp.kernelsize, simulate2d=sim2d, borders=0.01)
    kernel_vs_plain(csp, opts, dom, pos, vel, rho, code)


# (tkernel, tvisco, shiftmode): every kernel instance of csrc/cellforce.cu
VARIANTS = [("CUBIC", "ARTIFICIAL", "NONE"), ("CUBIC", "ARTIFICIAL", "NO_FIXED"),
            ("WENDLAND", "ARTIFICIAL", "NO_BOUND"),
            ("WENDLAND", "ARTIFICIAL", "NO_FIXED"),
            ("WENDLAND", "ARTIFICIAL", "FULL"),
            ("WENDLAND", "LAMINAR_SPS", "NONE"), ("CUBIC", "LAMINAR_SPS", "NONE"),
            ("WENDLAND", "LAMINAR_SPS", "NO_FIXED"),
            ("CUBIC", "LAMINAR_SPS", "NO_BOUND")]


@pytest.mark.gpu
@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("tkernel,tvisco,shiftmode", VARIANTS)
def test_cuda_variant_kernels_match_plain(cuda, sim2d, tkernel, tvisco,
                                          shiftmode):
    csp = td.make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25,
                         visco=1e-4 if tvisco == "LAMINAR_SPS" else 0.05,
                         viscoboundfactor=0.5, tkernel=td.TpKernel[tkernel],
                         tvisco=td.TpVisco[tvisco])
    opts = F.SolverOpts(tvisco=td.TpVisco[tvisco],
                        shiftmode=td.TpShifting[shiftmode])
    pos, vel, rho, code = cloud(sim2d, 14, cuda, mixed=True)
    spstau = None
    if tvisco == "LAMINAR_SPS":
        rng = np.random.default_rng(15)
        spstau = torch.where(td.is_fluid(code)[:, None], torch.tensor(
            rng.normal(0, 1e-3, (pos.shape[0], 6)), dtype=torch.float32,
            device=cuda), 0.0)
    dom = cd.make_domain(pos.min(0).values.tolist(), pos.max(0).values.tolist(),
                         csp.kernelsize, simulate2d=sim2d, borders=0.01)
    kernel_vs_plain(csp, opts, dom, pos, vel, rho, code, spstau)


@pytest.mark.gpu
@pytest.mark.parametrize("tdensity", ["MOLTENI", "FOURTAKAS"])
@pytest.mark.parametrize("tkernel,tvisco", [("WENDLAND", "ARTIFICIAL"),
                                            ("CUBIC", "ARTIFICIAL"),
                                            ("WENDLAND", "LAMINAR_SPS")])
def test_cuda_floating_mdbc_kernels_match_plain(cuda, tkernel, tvisco, tdensity):
    """Kernels 1-3 with two floating bodies of their own particle mass and
    mDBC walls, against the plain version."""
    csp = td.make_ctesph(simulate2d=False, dp=0.05, hswl=0.25,
                         visco=1e-4 if tvisco == "LAMINAR_SPS" else 0.05,
                         viscoboundfactor=0.5, tkernel=td.TpKernel[tkernel],
                         tvisco=td.TpVisco[tvisco])
    opts = F.SolverOpts(tvisco=td.TpVisco[tvisco],
                        tdensity=td.TpDensity[tdensity],
                        tboundary=td.TpBoundary.MDBC, with_floating=True)
    pos, vel, rho, code = cloud(False, 16, cuda, mixed=True)
    floating = td.is_floating(code)
    body = torch.arange(code.shape[0], dtype=torch.int32, device=cuda) % 2
    code = torch.where(floating, td.code_make(td.TYPE_FLOATING, 0) + body,
                       code).to(torch.int32)
    ftomassp = torch.tensor([0.5, 0.3], device=cuda) * csp.massfluid
    spstau = None
    if tvisco == "LAMINAR_SPS":
        rng = np.random.default_rng(17)
        spstau = torch.where(td.is_fluid(code)[:, None], torch.tensor(
            rng.normal(0, 1e-3, (pos.shape[0], 6)), dtype=torch.float32,
            device=cuda), 0.0)
    dom = cd.make_domain(pos.min(0).values.tolist(), pos.max(0).values.tolist(),
                         csp.kernelsize, borders=0.01)
    cells, code = cd.divide_cells(dom, pos, code)
    o = cells.order
    args = (pos[o], vel[o], rho[o], code[o])
    tau = None if spstau is None else spstau[o].contiguous()
    launches = dict(CF.launches)
    launches[CF.kernel_name(csp, opts)] += 1
    got = F.interaction_forces(csp, opts, dom, cells, *args, spstau=tau,
                               ftomassp=ftomassp)
    torch.cuda.synchronize()
    assert CF.launches == launches
    rtol = 4e-3 if tkernel == "CUBIC" else 2e-3
    want = F.interaction_forces_plain(csp, opts, dom, cells, *args, spstau=tau,
                                      ftomassp=ftomassp)
    assert_close(want, got, rtol)
    # the body masses matter: without them the forces differ
    other = F.interaction_forces_plain(csp, opts, dom, cells, *args,
                                       spstau=tau)
    scale = float(want.ace.abs().max())
    assert float((other.ace - want.ace).abs().max()) > 10 * rtol * scale


@pytest.mark.gpu
def test_cuda_kernels_match_twin_on_queue_cloud(cuda):
    """Every instance of kernels 1-3 under DBC and mDBC walls, 3D and 2D, on
    the cloud of test_torch_pairqueue.py (targets whose queue of in-support
    slots fills more than twice, exactly once and never; boundary targets;
    dead slots), against the g++ twin of the same body."""
    import test_torch_pairqueue as PQ
    for sim2d in (False, True):
        dom, cells, args, _ = PQ.queue_cloud(sim2d)
        dcells = cd.CellDiv(*(x.to(cuda) for x in (cells.cell, cells.begin,
                                                   cells.order)))
        dargs = tuple(x.to(cuda) for x in args)
        for tboundary in ("DBC", "MDBC"):
            for tkernel, tvisco, shift, ft in PQ.INSTANCES:
                csp, opts, lam, ftomassp = PQ.instance(sim2d, tkernel, tvisco,
                                                       shift, ft, tboundary)
                tau = PQ.sps_stress(args[3]) if lam else None
                want = CF.interaction_forces_host_twin(
                    csp, opts, dom, cells, *args, tau, ftomassp)
                launches = dict(CF.launches)
                launches[CF.kernel_name(csp, opts)] += 1
                got = F.interaction_forces(
                    csp, opts, dom, dcells, *dargs,
                    spstau=None if tau is None else tau.to(cuda),
                    ftomassp=None if ftomassp is None else ftomassp.to(cuda))
                torch.cuda.synchronize()
                assert CF.launches == launches
                PQ.assert_close(want, got, 4e-3 if tkernel == "CUBIC" else 2e-3)


def small_floatingbox(dev):
    case = cases.floatingbox2d(dp=0.04, tank=(0.8, 0.6), water=0.3,
                               box=(0.16, 0.16), box_pos=(0.32, 0.2),
                               device=dev)
    fluid = td.is_fluid(case.state.code)
    vel = torch.where(fluid[:, None], torch.tensor([2.5, 0.0, 0.0], device=dev),
                      0.0)
    return case, dataclasses.replace(case.state, vel=vel)


FLOATINGBOX_OPTS = dict(tdensity=td.TpDensity.FOURTAKAS, with_floating=True,
                        tboundary=td.TpBoundary.MDBC,
                        slipmode=td.TpSlipMode.NO_SLIP)


@pytest.mark.gpu
def test_cuda_floatingbox_steps_match_cpu_steps(cuda):
    """Steps of the floating box on the card and on the CPU agree by
    particle id within 1e-4*dp, the body center within 1e-4*dp and its
    velocities within rtol 1e-3 (floor 1e-3 of the largest value); two runs
    on the card give the same bodies bit for bit."""
    opts = P.SolverOpts(**FLOATINGBOX_OPTS)
    out = {}
    for dev in ("cpu", cuda, cuda):
        case, st = small_floatingbox(dev)
        feats = P.Features(floating=case.meta["ftcfg"])
        carry = P.make_carry(st, case.csp, opts, case.dom)
        step = P.make_step(case.csp, opts, case.dom, feats)
        launches = CF.launches["cellforce"]
        for _ in range(4):
            carry = step(carry)
        if dev != "cpu":
            assert CF.launches["cellforce"] == launches + 8
        assert carry.nrebuild >= 2
        pos = torch.empty_like(carry.st.pos)
        pos[carry.st.idp] = carry.st.pos
        ft = {k: getattr(carry.st.ft, k).cpu()
              for k in ("center", "fvel", "fomega", "angles")}
        out.setdefault(str(dev), []).append((pos.cpu(), ft))
    (pos_c, ft_c), = out["cpu"]
    (pos_g, ft_g), (pos_g2, ft_g2) = out["cuda"]
    torch.testing.assert_close(pos_g, pos_c, rtol=0, atol=1e-4 * 0.04)
    torch.testing.assert_close(ft_g["center"], ft_c["center"], rtol=0,
                               atol=1e-4 * 0.04)
    for k in ("fvel", "fomega"):
        w = ft_c[k]
        torch.testing.assert_close(ft_g[k], w, rtol=1e-3,
                                   atol=1e-3 * float(w.abs().max()))
    assert torch.equal(pos_g, pos_g2)
    for k in ft_g:
        assert torch.equal(ft_g[k], ft_g2[k])


@pytest.mark.gpu
@pytest.mark.parametrize("slip", ["VEL0", "NO_SLIP"])
def test_cuda_mdbc_steps_match_cpu_steps(cuda, slip):
    """Steps of the 2D dam break with mDBC walls on the card and on the CPU
    agree by particle id: positions within 1e-4*dp, density within rtol
    1e-5 and velocity within 1e-4 m/s, walls included."""
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS,
                        tboundary=td.TpBoundary.MDBC,
                        slipmode=td.TpSlipMode[slip])
    dp = 0.02
    out = {}
    for dev in ("cpu", cuda):
        case = cases.dambreak2d(dp=dp, tank=(0.8, 0.5), column=(0.2, 0.3),
                                mdbc=True, device=dev)
        fluid = td.is_fluid(case.state.code)
        vel = torch.where(fluid[:, None],
                          torch.tensor([2.5, 0.0, 0.0], device=dev), 0.0)
        carry = P.make_carry(dataclasses.replace(case.state, vel=vel),
                             case.csp, opts, case.dom)
        step = P.make_step(case.csp, opts, case.dom)
        for _ in range(4):
            carry = step(carry)
        assert carry.nrebuild >= 2
        st = carry.st
        out[str(dev)] = {}
        for k in ("pos", "rho", "vel"):
            v = torch.empty_like(getattr(st, k))
            v[st.idp] = getattr(st, k)
            out[str(dev)][k] = v.cpu()
    got, want = out["cuda"], out["cpu"]
    torch.testing.assert_close(got["pos"], want["pos"], rtol=0, atol=1e-4 * dp)
    torch.testing.assert_close(got["rho"], want["rho"], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["vel"], want["vel"], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_dambreak(cuda):
    case = cases.dambreak3d(**GEOM, device=cuda)
    st = case.state
    rng = np.random.default_rng(3)
    dv = torch.tensor(rng.normal(0, 0.5, (st.n, 3)), dtype=torch.float32,
                      device=cuda)
    vel = torch.where(td.is_fluid(st.code)[:, None], dv, 0.0)
    kernel_vs_plain(case.csp, F.SolverOpts(), case.dom, st.pos, vel, st.rho,
                    st.code)


@pytest.mark.gpu
def test_cuda_steps_match_cpu_steps(cuda):
    """Steps on the card (kernel) and on the CPU (plain version) agree by
    particle id within 1e-4*dp, with a rebuild inside the run."""
    opts = P.SolverOpts()
    out = {}
    for dev in ("cpu", cuda):
        case = cases.dambreak3d(**GEOM, device=dev)
        fluid = td.is_fluid(case.state.code)
        vel = torch.where(fluid[:, None],
                          torch.tensor([2.5, 0.0, 0.0], device=dev), 0.0)
        st = P.SimState(pos=case.state.pos, vel=vel, rho=case.state.rho,
                        code=case.state.code, idp=case.state.idp,
                        pose=case.state.pose)
        carry = P.make_carry(st, case.csp, opts, case.dom)
        step = P.make_step(case.csp, opts, case.dom)
        launches = CF.launches["cellforce"]
        for _ in range(4):
            carry = step(carry)
        if dev != "cpu":
            assert CF.launches["cellforce"] == launches + 8
        assert carry.nrebuild >= 2
        pos = torch.empty_like(carry.st.pos)
        pos[carry.st.idp] = carry.st.pos
        out[str(dev)] = pos.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-4 * GEOM["dp"])


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["lamsps", "cubic"])
def test_cuda_path_steps_match_cpu_steps(cuda, path):
    """Steps of the laminar+SPS+shifting and the cubic paths on the card and
    on the CPU agree by particle id within 1e-4*dp (positions) and rtol
    2e-3 (SPS stress), with a rebuild inside the run."""
    if path == "lamsps":
        opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS,
                            shiftmode=td.TpShifting.NO_FIXED)
        csp = td.make_ctesph(simulate2d=False, dp=GEOM["dp"],
                             hswl=GEOM["column"][2], visco=1e-6,
                             tvisco=td.TpVisco.LAMINAR_SPS)
        name = "cellforce_lamsps"
    else:
        opts = P.SolverOpts()
        csp = None
        name = "cellforce_cubic"
    out = {}
    for dev in ("cpu", cuda):
        case = cases.dambreak3d(**GEOM, visco=1e-6 if csp else 0.1,
                                need_sps=path == "lamsps", device=dev)
        c = csp or case.csp.replace(tkernel=td.TpKernel.CUBIC)
        fluid = td.is_fluid(case.state.code)
        vel = torch.where(fluid[:, None],
                          torch.tensor([2.5, 0.0, 0.0], device=dev), 0.0)
        carry = P.make_carry(dataclasses.replace(case.state, vel=vel), c, opts,
                             case.dom)
        step = P.make_step(c, opts, case.dom)
        launches = CF.launches[name]
        for _ in range(4):
            carry = step(carry)
        if dev != "cpu":
            assert CF.launches[name] == launches + 8
        assert carry.nrebuild >= 2
        st = carry.st
        out[str(dev)] = {}
        for k in ("pos", "spstau"):
            if getattr(st, k) is not None:
                v = torch.empty_like(getattr(st, k))
                v[st.idp] = getattr(st, k)
                out[str(dev)][k] = v.cpu()
    torch.testing.assert_close(out["cuda"]["pos"], out["cpu"]["pos"], rtol=0,
                               atol=1e-4 * GEOM["dp"])
    if path == "lamsps":
        want = out["cpu"]["spstau"]
        torch.testing.assert_close(out["cuda"]["spstau"], want, rtol=2e-3,
                                   atol=2e-3 * float(want.abs().max()))


@pytest.mark.gpu
def test_cuda_wrapper_rejects_mixed_devices(cuda):
    case = cases.dambreak3d(**GEOM, device=cuda)
    st = case.state
    cells, code = cd.divide_cells(case.dom, st.pos, st.code)
    with pytest.raises(ValueError, match="rho"):
        CF.interaction_forces_cuda(case.csp, F.SolverOpts(), case.dom, cells,
                                   st.pos, st.vel, st.rho.cpu(), code)


# ---------------------------------------------------------------------------
# multiphase non-Newtonian kernels
# ---------------------------------------------------------------------------

NN_CONFIGS = [("LAMINAR_SPS", "SPH"), ("CONST_EQ", "SPH"), ("ARTIFICIAL", "SPH"),
              ("LAMINAR_SPS", "FDA"), ("CONST_EQ", "FDA")]


def nn_opts(tvisco, velgrad, tdensity="FOURTAKAS"):
    return P.SolverOpts(tvisco=td.TpVisco[tvisco], velgrad=td.TpVelGrad[velgrad],
                        tdensity=td.TpDensity[tdensity])


def nn_perturbed(case, phases, seed, device):
    """The case's state with a seeded 0.5 m/s velocity jitter on the fluid
    (none along y in 2D) and a 1% density jitter of each phase's rho0."""
    st = case.state
    rng = np.random.default_rng(seed)
    fluid = td.is_fluid(st.code)
    dv = torch.tensor(rng.normal(0, 0.5, (st.n, 3)), dtype=torch.float32,
                      device=device)
    if case.csp.simulate2d:
        dv[:, 1] = 0.0
    rho0 = phases.tables(case.csp, device)["rho0"][
        torch.clamp(td.code_value(st.code), 0, phases.count - 1).long()]
    drho = torch.tensor(rng.uniform(-0.01, 0.01, st.n), dtype=torch.float32,
                        device=device) * rho0
    return (st.pos, torch.where(fluid[:, None], dv, 0.0),
            st.rho + torch.where(fluid, drho, 0.0), st.code)


def nn_kernels_vs_plain(csp, opts, phases, dom, pos, vel, rho, code,
                        rtol=2e-3):
    cells, code = cd.divide_cells(dom, pos, code)
    o = cells.order
    run = (csp, opts, phases, dom, cells, pos[o], vel[o], rho[o], code[o])
    before = dict(NF.launches)
    fr, eta, tau = NN.interaction_forces_nn(*run)
    torch.cuda.synchronize()
    fda = NN.uses_fda(opts)
    assert NF.launches["nnforce_fda"] == before["nnforce_fda"] + fda
    assert NF.launches["nnforce_p1"] == before["nnforce_p1"] + (not fda)
    assert NF.launches["nnforce_p3"] == before["nnforce_p3"] + (not fda)
    got = NF.interaction_forces_nn_cuda(*run)
    want = NN.interaction_forces_nn_plain(*run)
    assert torch.equal(got.forces.ace, fr.ace)     # deterministic sums
    for k, g, w in (("ace", got.forces.ace, want.forces.ace),
                    ("ar", got.forces.ar, want.forces.ar),
                    ("visco_eta", got.visco_eta, want.visco_eta),
                    ("tau", got.tau, want.tau),
                    ("gradvel", got.gradvel, want.gradvel),
                    ("shiftposfs", got.forces.shiftposfs,
                     want.forces.shiftposfs)):
        if w is None:
            assert g is None, k
            continue
        scale = float(w.abs().max()) + 1e-6
        torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * scale, msg=k)
    for k in ("viscdtmax", "viscetadtmax"):
        torch.testing.assert_close(getattr(got.forces, k),
                                   getattr(want.forces, k), rtol=1e-3,
                                   atol=1e-5)
    if want.forces.shift_blocked is not None:
        assert torch.equal(got.forces.shift_blocked, want.forces.shift_blocked)


@pytest.mark.gpu
@pytest.mark.parametrize("tvisco,velgrad", NN_CONFIGS)
def test_cuda_nn_kernels_match_plain(cuda, tvisco, velgrad):
    case, phases = NM.wet_dambreak_nn(dp=0.02, device=cuda)
    nn_kernels_vs_plain(case.csp, nn_opts(tvisco, velgrad), phases, case.dom,
                        *nn_perturbed(case, phases, 4, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("tdensity", ["NONE", "MOLTENI", "FOURTAKAS_FULL"])
def test_cuda_nn_kernels_match_plain_ddt(cuda, tdensity):
    case, phases = NM.wet_dambreak_nn(dp=0.02, device=cuda)
    nn_kernels_vs_plain(case.csp, nn_opts("LAMINAR_SPS", "SPH", tdensity),
                        phases, case.dom, *nn_perturbed(case, phases, 5, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("tvisco,velgrad", [("LAMINAR_SPS", "SPH"),
                                            ("CONST_EQ", "FDA")])
def test_cuda_nn_kernels_match_plain_3d(cuda, tvisco, velgrad):
    """A 3D two-phase cloud, so that the 9-row walk runs."""
    _, phases = NM.wet_dambreak_nn(dp=0.05, device="cpu")
    csp = NM.make_nn_csp(simulate2d=False, dp=0.05, phases=phases, hswl=0.25)
    pos, vel, rho, code = cloud(False, 13, cuda)
    mud = td.is_fluid(code) & (pos[:, 0] >= 0.25)
    code = torch.where(mud, code | 1, code)
    rho = torch.where(mud, rho * 1.5, rho)
    dom = cd.make_domain(pos.min(0).values.tolist(), pos.max(0).values.tolist(),
                         csp.kernelsize, borders=0.01)
    nn_kernels_vs_plain(csp, nn_opts(tvisco, velgrad), phases, dom, pos, vel,
                        rho, code)


@pytest.mark.gpu
@pytest.mark.parametrize("velgrad", ["SPH", "FDA"])
def test_cuda_nn_steps_match_cpu_steps(cuda, velgrad):
    """NN steps on the card (kernels) and on the CPU (plain version) agree
    by particle id within 1e-4*dp, with a rebuild inside the run."""
    opts = nn_opts("LAMINAR_SPS", velgrad)
    dp = 0.02
    out = {}
    for dev in ("cpu", cuda):
        case, phases = NM.wet_dambreak_nn(dp=dp, device=dev)
        fluid = td.is_fluid(case.state.code)
        vel = torch.where(fluid[:, None],
                          torch.tensor([2.5, 0.0, 0.0], device=dev), 0.0)
        carry = P.make_carry(dataclasses.replace(case.state, vel=vel),
                             case.csp, opts, case.dom)
        step = P.make_nn_step(case.csp, opts, case.dom, phases)
        launches = dict(NF.launches)
        for _ in range(4):
            carry = step(carry)
        if dev != "cpu":
            kernels = ("nnforce_fda",) if velgrad == "FDA" else (
                "nnforce_p1", "nnforce_p3")
            for k in kernels:
                assert NF.launches[k] == launches[k] + 8
        assert carry.nrebuild >= 2
        pos = torch.empty_like(carry.st.pos)
        pos[carry.st.idp] = carry.st.pos
        out[str(dev)] = pos.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-4 * dp)


@pytest.mark.gpu
def test_cuda_nn_kernels_match_twin_on_group_cloud(cuda):
    """Every instance of nnforce_p1 and nnforce_fda, and nnforce_p3 in each
    viscous form, 3D and 2D, on the cloud of test_torch_nngroup.py (a
    target whose queue fills several times, walks that cross row ends
    mid-run, drains forced by a full queue, boundary targets, dead slots,
    two phases), against the g++ twin of the same lane groups; two launches
    on identical inputs are bit-equal."""
    import test_torch_nngroup as NG

    def dev(x):
        return x.to(cuda)

    for sim2d in (False, True):
        for inst in NG.INSTANCES:
            run = NG.run_instance(sim2d, *inst)
            csp, opts, phases, dom, cells, pos, vel, rho, ch = run
            drun = (csp, opts, phases, dom,
                    cd.CellDiv(*map(dev, (cells.cell, cells.begin,
                                          cells.order))),
                    dev(pos), dev(vel), dev(rho),
                    NN.NnChannels(*map(dev, (ch.phase, ch.press, ch.kind))))
            rtol = 4e-3 if inst[1] == "CUBIC" else 2e-3
            launches = dict(NF.launches)
            if inst[0] == "p3":
                run3, ace1 = NG.pass3_run(sim2d, run)
                want = torch.zeros_like(ace1)
                NF.pass3(*run3, want, twin=True)
                eta_tau = tuple(map(dev, run3[-2:]))
                got, again = (torch.zeros_like(dev(ace1)) for _ in range(2))
                NF.pass3(*drun, *eta_tau, got)
                NF.pass3(*drun, *eta_tau, again)
                torch.cuda.synchronize()
                launches["nnforce_p3"] += 2
                assert NF.launches == launches
                assert torch.equal(got, again)
                NG.assert_close_ace(want, got.cpu(), rtol)
                continue
            want = NF.pass1(*run, twin=True)
            kernel = "nnforce_fda" if NN.uses_fda(opts) else "nnforce_p1"
            launches[kernel] += 2
            got, again = NF.pass1(*drun), NF.pass1(*drun)
            torch.cuda.synchronize()
            assert NF.launches == launches
            fields = ("ace", "ar", "viscdt", "gradvel", "etamax", "shift",
                      "shiftblk")
            for k in fields:
                g = getattr(got, k)
                assert g is None or torch.equal(g, getattr(again, k)), k
            NG.assert_close(want, dataclasses.replace(got, **{
                k: None if getattr(got, k) is None else getattr(got, k).cpu()
                for k in fields}), rtol)


NN_VARIANTS = [("CUBIC", "NONE"), ("WENDLAND", "NO_BOUND"),
               ("WENDLAND", "NO_FIXED"), ("WENDLAND", "FULL"),
               ("CUBIC", "NO_BOUND")]


@pytest.mark.gpu
@pytest.mark.parametrize("tvisco,velgrad", [("LAMINAR_SPS", "SPH"),
                                            ("ARTIFICIAL", "SPH"),
                                            ("CONST_EQ", "FDA")])
@pytest.mark.parametrize("tkernel,shiftmode", NN_VARIANTS)
def test_cuda_nn_variant_kernels_match_plain(cuda, tkernel, shiftmode, tvisco,
                                             velgrad):
    """The cubic and shifting instances of nnforce_p1, nnforce_p3 and
    nnforce_fda (rtol 4e-3 with the cubic spline)."""
    case, phases = NM.wet_dambreak_nn(dp=0.02, device=cuda)
    opts = dataclasses.replace(nn_opts(tvisco, velgrad),
                               shiftmode=td.TpShifting[shiftmode])
    nn_kernels_vs_plain(case.csp.replace(tkernel=td.TpKernel[tkernel]), opts,
                        phases, case.dom, *nn_perturbed(case, phases, 6, cuda),
                        rtol=4e-3 if tkernel == "CUBIC" else 2e-3)


# ---------------------------------------------------------------------------
# hardware probes
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("op", PR.OPS)
def test_cuda_probe_fma_matches_plain(cuda, op):
    """rtol 1e-5 (1e-4 for the card's MUFU rsqrt and approximate
    reciprocal) after rep 2 x 64 steps."""
    x = PR.fma_input(PR.full_threads(cuda), cuda)
    before = PR.launches["probe_fma"]
    for chains in PR.CHAINS:
        got = PR.fma(x, op, chains, 2)
        want = PR.fma_plain(x, op, chains, 2)
        rtol = 1e-5 if op in ("fma", "mix") else 1e-4
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=rtol * float(want.abs().max()))
    assert PR.launches["probe_fma"] == before + len(PR.CHAINS)


@pytest.mark.gpu
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_probe_gather_matches_plain(cuda, aligned, staged):
    """At 16, 37 and 45 window loads (a pair of chunks, a count that ends
    the kernel's pipeline inside the first and inside the second chunk of
    a pair), and at the timed 512 bit for bit against the plain loop with
    the kernel's fused multiply-adds (NaN where it overflows)."""
    for niter in (16, 37, 45):
        buf, offs = PR.gather_inputs(niter, cuda)
        got = PR.gather(buf, offs, aligned, staged)
        want = PR.gather_plain(buf, offs, aligned)
        for g in range(PR.GROUPS):
            torch.testing.assert_close(got[g], want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))
    buf, offs = PR.gather_inputs(PR.NITER, cuda)
    got = PR.gather(buf, offs, aligned, staged)
    want = PR.gather_plain(buf, offs, aligned, fused=True)
    torch.testing.assert_close(got, want.expand_as(got), rtol=0, atol=0,
                               equal_nan=True)


def open_steps(case, feats, st, dev, nsteps=4):
    """(positions and codes by id, the carry) after ``nsteps`` steps of
    ``case`` with ``feats`` from ``st`` on ``dev``."""
    opts = P.SolverOpts(tdensity=td.TpDensity.MOLTENI)
    carry = P.make_carry(st, case.csp, opts, case.dom, feats)
    step = P.make_step(case.csp, opts, case.dom, feats)
    launches = CF.launches["cellforce"]
    for _ in range(nsteps):
        carry = step(carry)
    if st.pos.device.type == "cuda":
        assert CF.launches["cellforce"] == launches + 2 * nsteps
    pos = torch.empty_like(carry.st.pos)
    pos[carry.st.idp] = carry.st.pos
    code = torch.empty_like(carry.st.code)
    code[carry.st.idp] = carry.st.code
    return pos.cpu(), code.cpu(), carry


@pytest.mark.gpu
def test_cuda_channel2d_steps_match_cpu_steps(cuda):
    """Steps of channel2d on the card and on the CPU: the same codes
    (conversions, spawns) by id, positions within 1e-4*dp, overflow 0."""
    out = {}
    for dev in ("cpu", cuda):
        case = cases.channel2d(dp=0.02, length=0.5, height=0.16, vel=0.4,
                               device=dev)
        out[str(dev)] = open_steps(case, P.Features(inout=case.meta["inout"]),
                                   case.state, dev)
    (pc, cc, carry_c), (pg, cg, carry_g) = out["cpu"], out["cuda"]
    assert torch.equal(cg, cc)
    live = td.is_active(cc)
    torch.testing.assert_close(pg[live], pc[live], rtol=0, atol=1e-4 * 0.02)
    assert carry_g.overflow == 0 == carry_c.overflow


@pytest.mark.gpu
def test_cuda_periodic_steps_match_cpu_steps(cuda):
    """Steps of the x-periodic channel streaming at 1 m/s on the card and
    on the CPU: positions within 1e-4*dp by id (wrapped alike), overflow 0,
    and kernel 1 on a state with its ghost rows within the plain rule."""
    from dualsphysics_multilayer_tpu_torch.features import periodic as PER
    out = {}
    for dev in ("cpu", cuda):
        case = cases.periodic_channel2d(ghost_cap=64, device=dev)
        st = case.state
        fl = td.is_fluid(st.code)
        pos = st.pos.clone()
        pos[fl, 0] += 0.04 - 1e-4
        st = dataclasses.replace(st, pos=pos, vel=torch.where(
            fl[:, None], torch.tensor([1.0, 0.0, 0.0], device=dev), 0.0))
        out[str(dev)] = open_steps(
            case, P.Features(periodic=case.meta["periodic"]), st, dev)
    (pc, cc, carry_c), (pg, cg, carry_g) = out["cpu"], out["cuda"]
    assert torch.equal(cg, cc)
    torch.testing.assert_close(pg, pc, rtol=0, atol=1e-4 * 0.04)
    assert carry_g.overflow == 0 == carry_c.overflow
    rows, _ = PER.ghost_rows(case.meta["periodic"], case.csp, carry_g.st)
    cells, code = cd.divide_cells(case.dom, rows["pos"], rows["code"])
    o = cells.order
    args = (rows["pos"][o], rows["vel"][o], rows["rho"][o], code[o])
    opts = P.SolverOpts(tdensity=td.TpDensity.MOLTENI)
    got = CF.interaction_forces_cuda(case.csp, opts, case.dom, cells, *args)
    want = F.interaction_forces_plain(case.csp, opts, case.dom, cells, *args)
    for k in ("ace", "ar"):
        w = getattr(want, k)
        torch.testing.assert_close(getattr(got, k), w, rtol=2e-3,
                                   atol=2e-3 * float(w.abs().max()))


def coupled_box(dev, kind):
    """The small floating box resting 0.1 dp into the tank floor (dense
    box, fluid at 0.5 m/s) with DEM contact and ``kind``: "moordyn" (a
    lumped-mass line to the floor) or "chrono" (a hinge at its foot, a
    spring and a box mesh on a floor mesh).  Returns (case, state,
    Features)."""
    from dualsphysics_multilayer_tpu_torch.features import chcollision as CC
    from dualsphysics_multilayer_tpu_torch.features import chrono as CH
    from dualsphysics_multilayer_tpu_torch.features import dem as DEM
    from dualsphysics_multilayer_tpu_torch.features import floating as FT
    from dualsphysics_multilayer_tpu_torch.features import moorings as MO
    dp = 0.04
    case = cases.floatingbox2d(dp=dp, tank=(0.8, 0.6), water=0.3,
                               box=(0.16, 0.16), box_pos=(0.32, dp),
                               box_rho=1500.0, device=dev)
    st = case.state
    isft = td.is_floating(st.code)
    pos = st.pos.clone()
    pos[isft, 2] -= 0.1 * dp
    ftcfg, ft = FT.make_floating([pos[isft].cpu().numpy()], [1500.0],
                                 case.csp, device=dev)
    vel = torch.where(td.is_fluid(st.code)[:, None],
                      torch.tensor([0.5, 0.0, 0.0], device=dev), 0.0)
    st = dataclasses.replace(st, pos=pos, vel=vel, ft=ft)
    dem = DEM.make_dem(case.csp, st.code, ftcfg, idp=st.idp, float_props=[
        dict(young=1e6, poisson=0.3, kfric=0.45, restitu=0.2)])
    c0 = ft.center[0].cpu().numpy().astype(float)
    if kind == "moordyn":
        moor = MO.MoorDynCfg(nbodies=1, t_ic=0.01, nsub=4, lines=(
            MO.MoorDynLine(0, (c0[0] - 0.3, 0.0, 0.0), (-0.08, 0.0, 0.04),
                           length0=0.31, ea=2.9e3, nseg=5, diameter=3.7e-3,
                           massden=0.06),))
        return case, st, P.Features(floating=ftcfg, dem=dem, moorings=moor)
    links = [CH.ChLink("hinge", 0, -1, rotpoint=(c0[0] - 0.08, 0.0, c0[2] - 0.08),
                       rotvector=(0.0, 1.0, 0.0)),
             CH.ChLink("spring", 0, -1, pt1=(c0[0] + 0.08, 0.0, c0[2]),
                       pt2=(c0[0] + 0.08, 0.0, 0.6), stiffness=300.0,
                       restlength=0.3)]
    lo, hi = c0 - 0.08 - 0.1 * dp, c0 + 0.08
    box = np.array([[[lo[0], -0.1, lo[2]], [hi[0], -0.1, lo[2]],
                     [hi[0], 0.1, lo[2]]],
                    [[lo[0], -0.1, lo[2]], [hi[0], 0.1, lo[2]],
                     [lo[0], 0.1, lo[2]]]])
    floor = np.array([[[0.0, -1.0, 0.0], [0.8, -1.0, 0.0], [0.8, 1.0, 0.0]],
                      [[0.0, -1.0, 0.0], [0.8, 1.0, 0.0], [0.0, 1.0, 0.0]]])
    cc = CC.make_chcontact([dict(ft=0, tris=box, center0=c0,
                                 mass=ftcfg.mass[0]),
                            dict(ft=-1, tris=floor)], dp=dp)
    return case, st, P.Features(floating=ftcfg, dem=dem,
                                chrono=CH.make_chrono(links, c0[None]),
                                chcontact=cc)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["moordyn", "chrono"])
def test_cuda_coupled_box_steps_match_cpu_steps(cuda, kind):
    """4 steps of the box with DEM and a MoorDyn line, or with Chrono links
    and mesh contact, on the card and on the CPU: positions by id and the
    body centre within 1e-4*dp, its velocities within rtol 1e-3 (floor
    1e-3 of the largest value), the line's nodes within 1e-4*dp, overflow
    0; cellforce twice per step on the card."""
    opts = P.SolverOpts(**FLOATINGBOX_OPTS)
    out = {}
    for dev in ("cpu", cuda):
        case, st, feats = coupled_box(dev, kind)
        carry = P.make_carry(st, case.csp, opts, case.dom, feats)
        step = P.make_step(case.csp, opts, case.dom, feats)
        launches = CF.launches["cellforce"]
        for _ in range(4):
            carry = step(carry)
        if dev != "cpu":
            assert CF.launches["cellforce"] == launches + 8
        assert carry.overflow == 0
        pos = torch.empty_like(carry.st.pos)
        pos[carry.st.idp] = carry.st.pos
        out[str(dev)] = (pos.cpu(), {k: getattr(carry.st.ft, k).cpu() for k in
                                     ("center", "fvel", "fomega")},
                         None if carry.moor is None else carry.moor.pos.cpu())
    (pos_c, ft_c, moor_c), (pos_g, ft_g, moor_g) = out["cpu"], out["cuda"]
    torch.testing.assert_close(pos_g, pos_c, rtol=0, atol=1e-4 * 0.04)
    torch.testing.assert_close(ft_g["center"], ft_c["center"], rtol=0,
                               atol=1e-4 * 0.04)
    for k in ("fvel", "fomega"):
        w = ft_c[k]
        torch.testing.assert_close(ft_g[k], w, rtol=1e-3,
                                   atol=1e-3 * float(w.abs().max()))
    if moor_c is not None:
        torch.testing.assert_close(moor_g, moor_c, rtol=0, atol=1e-4 * 0.04)


@pytest.mark.gpu
def test_nbrlist_steps_on_the_card_match_the_cpu(cuda):
    """The 2D dam break under ``use_nbrlist`` on the card and on the CPU:
    5 flowing steps on the list's grid, positions by id within 1e-4*dp,
    cellforce twice per step, overflow 0."""
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS, use_nbrlist=True)
    out = {}
    for dev in ("cpu", cuda):
        case = cases.dambreak2d(dp=0.02, device=dev)
        st = case.state
        fluid = td.is_fluid(st.code)
        vel = torch.where(fluid[:, None],
                          torch.tensor([2.0, 0.0, 0.0], device=st.pos.device),
                          0.0)
        carry = P.make_carry(dataclasses.replace(st, vel=vel), case.csp,
                             opts, case.dom)
        step = P.make_step(case.csp, opts, case.dom)
        launches = CF.launches["cellforce"]
        for _ in range(5):
            carry = step(carry)
        if dev != "cpu":
            assert CF.launches["cellforce"] == launches + 10
        assert carry.overflow == 0 and carry.dom.within == case.dom
        pos = torch.empty_like(carry.st.pos)
        pos[carry.st.idp] = carry.st.pos
        out[str(dev)] = pos.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-4 * 0.02)


@pytest.mark.gpu
def test_tool_sums_on_the_card_match_the_cpu(cuda, tmp_path):
    """MeasureTool's interpolation and elevation and ComputeForces' fluid
    forces on a PART of the 3D dam break, on the card and with the CPU's
    torch: within rtol 1e-6."""
    from dualsphysics_multilayer_tpu_torch.io import partdata
    from dualsphysics_multilayer_tpu_torch.tools import common as TC
    from dualsphysics_multilayer_tpu_torch.tools import computeforces as TF
    from dualsphysics_multilayer_tpu_torch.tools import measuretool as TM
    case = cases.dambreak3d(dp=0.02, device="cpu")
    partdata.PartWriter(str(tmp_path), case.csp).save(0, 0.0, case.state)
    d = partdata.read_part(str(tmp_path / "Part_0000.bi4"))
    rng = np.random.default_rng(0)
    pts = rng.uniform(d["pos"].min(0), d["pos"].max(0), (2000, 3))
    sel = np.where(TC.type_of(d) != td.TYPE_FLUID)[0]
    res = {}
    for dev in (torch.device("cpu"), cuda):
        res[dev.type] = (
            TM.interpolate(d, pts, ["rhop", "vel", "press"], device=dev),
            TM.elevation(d, pts[:50, :2], device=dev),
            TF.fluid_forces(d, sel, visco=0.1, device=dev))
    (ic, ec, fc), (ig, eg, fg) = res["cpu"], res["cuda"]
    for k in ("kcorr", "rhop", "vel", "press"):
        np.testing.assert_allclose(ig[k], ic[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(eg, ec, rtol=1e-6, atol=1e-9)
    assert np.abs(fc).max() > 0
    np.testing.assert_allclose(fg, fc, rtol=1e-6,
                               atol=1e-9 * np.abs(fc).max())
