"""The CUDA kernel on the card against its plain torch version.  Imports no
JAX, so it runs where only torch is installed:

    python -m pytest --noconftest tests/port/test_torch_cuda.py -m gpu

Without a CUDA device every test skips.  Tolerance: the rule of
tests/test_forces.py assert_close (rtol 2e-3, floor 2e-3 of the largest
value; viscdtmax rtol 1e-3), as in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

DDT = ["NONE", "MOLTENI", "FOURTAKAS", "FOURTAKAS_FULL"]
GEOM = dict(dp=0.04, tank=(0.8, 0.4, 0.3), column=(0.2, 0.4, 0.2),
            obstacle=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    return torch.device("cuda")


def cloud(sim2d, seed, device, n=400, dp=0.05):
    """Jittered fluid over a boundary layer (tests/test_forces.py make_cloud
    at a larger n)."""
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
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(pos, **f32), torch.tensor(vel, **f32),
            torch.tensor(rho, **f32), torch.tensor(code, device=device))


def assert_close(want, got, rtol=2e-3):
    for k in ("ace", "ar"):
        w, g = getattr(want, k), getattr(got, k)
        scale = float(w.abs().max()) + 1e-6
        torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * scale)
    torch.testing.assert_close(got.viscdtmax, want.viscdtmax, rtol=1e-3,
                               atol=1e-5)


def kernel_vs_plain(csp, opts, dom, pos, vel, rho, code):
    cells, code = cd.divide_cells(dom, pos, code)
    o = cells.order
    args = (pos[o], vel[o], rho[o], code[o])
    launches = CF.launches
    got = F.interaction_forces(csp, opts, dom, cells, *args)
    torch.cuda.synchronize()
    assert CF.launches == launches + 1
    assert_close(F.interaction_forces_plain(csp, opts, dom, cells, *args), got)


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
        launches = CF.launches
        for _ in range(4):
            carry = step(carry)
        if dev != "cpu":
            assert CF.launches == launches + 8
        assert carry.nrebuild >= 2
        pos = torch.empty_like(carry.st.pos)
        pos[carry.st.idp] = carry.st.pos
        out[str(dev)] = pos.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-4 * GEOM["dp"])


@pytest.mark.gpu
def test_cuda_wrapper_rejects_mixed_devices(cuda):
    case = cases.dambreak3d(**GEOM, device=cuda)
    st = case.state
    cells, code = cd.divide_cells(case.dom, st.pos, st.code)
    with pytest.raises(ValueError, match="rho"):
        CF.interaction_forces_cuda(case.csp, F.SolverOpts(), case.dom, cells,
                                   st.pos, st.vel, st.rho.cpu(), code)
