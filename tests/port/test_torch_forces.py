"""The port's force interaction: the plain torch version against the naive
O(N^2) oracle and the JAX bucket path, and the CPU twin of the CUDA
kernel's body (g++) against the plain version.  The CUDA kernel itself is
tested on the card by test_torch_cuda.py.

Tolerance: the rule of tests/test_forces.py assert_close, rtol=2e-3 with an
absolute floor of 2e-3 of the largest value for ace and ar, and rtol=1e-3
for viscdtmax (f32 sums in another order than the f64 oracle).
"""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import eos as jeos
from dualsphysics_multilayer_tpu.ops import forces as jF
from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

from ref_naive import naive_forces
from test_forces import make_cloud

torch.set_num_threads(2)

DDT = ["NONE", "MOLTENI", "FOURTAKAS", "FOURTAKAS_FULL"]


def as_dict(fr, order=None):
    """Forces as numpy, back in the input (unsorted) order."""
    out = dict(ace=fr.ace.cpu().numpy(), ar=fr.ar.cpu().numpy(),
               viscdtmax=float(fr.viscdtmax))
    if order is not None:
        for k in ("ace", "ar"):
            canon = np.empty_like(out[k])
            canon[order] = out[k]
            out[k] = canon
    return out


def assert_close(want, got, rtol=2e-3):
    for k in ("ace", "ar"):
        scale = np.abs(want[k]).max() + 1e-6
        np.testing.assert_allclose(got[k], want[k], atol=rtol * scale,
                                   rtol=rtol, err_msg=k)
    assert np.isclose(got["viscdtmax"], want["viscdtmax"], rtol=1e-3, atol=1e-5)


def sorted_inputs(csp, pos, vel, rho, code, device="cpu"):
    """Divide a cloud and return (dom, cells, sorted state tensors, order)."""
    dom = cd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01, csp.kernelsize,
                         simulate2d=csp.simulate2d)
    t = dict(dtype=torch.float32, device=device)
    pos_t = torch.tensor(pos, **t)
    code_t = torch.tensor(np.asarray(code).astype(np.int32), device=device)
    cells, code_t = cd.divide_cells(dom, pos_t, code_t)
    o = cells.order
    return dom, cells, (pos_t[o], torch.tensor(vel, **t)[o],
                        torch.tensor(rho, **t)[o], code_t[o]), o.cpu().numpy()


def configs(sim2d, tdensity, seed=12, **kw):
    ckw = dict(simulate2d=sim2d, dp=0.05, hswl=0.25, visco=0.05, **kw)
    csp = td.make_ctesph(**ckw)
    jcsp = jtd.make_ctesph(**ckw)
    opts = F.SolverOpts(tdensity=td.TpDensity[tdensity])
    jopts = jF.SolverOpts(tdensity=jtd.TpDensity[tdensity])
    return csp, jcsp, opts, jopts, make_cloud(sim2d=sim2d, seed=seed)


@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("tdensity", DDT)
def test_plain_matches_oracle_and_jax(sim2d, tdensity):
    csp, jcsp, opts, jopts, (pos, vel, rho, code, nb) = configs(sim2d, tdensity)
    press = np.asarray(jeos.press_from_rho(jcsp, jnp.asarray(rho))).astype(np.float64)
    want = naive_forces(jcsp, jopts, pos, vel, rho, press, code)
    dom, cells, args, order = sorted_inputs(csp, pos, vel, rho, code)
    got = as_dict(F.interaction_forces(csp, opts, dom, cells, *args), order)
    assert_close(want, got)

    jdom = jcd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01,
                           jcsp.kernelsize, simulate2d=sim2d, cellcap=64)
    div, _ = jcd.divide(jdom, jnp.asarray(pos, jnp.float32), jnp.asarray(code))
    jfr = jF.interaction_forces(
        jcsp, jopts, div, jnp.asarray(pos, jnp.float32),
        jnp.asarray(vel, jnp.float32), jnp.asarray(rho, jnp.float32),
        jnp.asarray(press, jnp.float32), jnp.asarray(code))
    jax_out = dict(ace=np.asarray(jfr.ace), ar=np.asarray(jfr.ar),
                   viscdtmax=float(jfr.viscdtmax))
    assert_close(jax_out, got)


def test_plain_viscoboundfactor_and_chunking():
    csp, jcsp, opts, jopts, (pos, vel, rho, code, nb) = configs(
        False, "FOURTAKAS", seed=5, viscoboundfactor=0.3)
    press = np.asarray(jeos.press_from_rho(jcsp, jnp.asarray(rho))).astype(np.float64)
    want = naive_forces(jcsp, jopts, pos, vel, rho, press, code)
    dom, cells, args, order = sorted_inputs(csp, pos, vel, rho, code)
    whole = F.interaction_forces_plain(csp, opts, dom, cells, *args)
    assert_close(want, as_dict(whole, order))
    # small chunks of targets give the same sums
    chunked = F.interaction_forces_plain(csp, opts, dom, cells, *args,
                                         max_pairs=500)
    for k in ("ace", "ar"):
        torch.testing.assert_close(getattr(chunked, k), getattr(whole, k),
                                   rtol=1e-6, atol=1e-6)


def test_plain_skips_inactive_particles():
    """A particle excluded since the last divide (OUT_RHOP) stays in its
    cell range but takes no part in any pair."""
    csp, jcsp, opts, jopts, (pos, vel, rho, code, nb) = configs(False, "MOLTENI")
    dom, cells, (p, v, r, c), order = sorted_inputs(csp, pos, vel, rho, code)
    k = int(np.nonzero(order == nb + 3)[0][0])
    c_out = c.clone()
    c_out[k] = td.code_set_special(int(c[k]), td.SPECIAL_OUT_RHOP)
    got = F.interaction_forces(csp, opts, dom, cells, p, v, r, c_out)
    code_out = code.copy()
    code_out[nb + 3] = td.code_set_special(int(code[nb + 3]), td.SPECIAL_OUT_RHOP)
    press = np.asarray(jeos.press_from_rho(jcsp, jnp.asarray(rho))).astype(np.float64)
    want = naive_forces(jcsp, jopts, pos, vel, rho, press, code_out)
    assert_close(want, as_dict(got, order))
    assert float(got.ar[k]) == 0.0 and not got.ace[k].any()


@pytest.mark.parametrize("kw,name", [
    (dict(tvisco=td.TpVisco.CONST_EQ), "tvisco=CONST_EQ"),
    (dict(tboundary=td.TpBoundary.MDBC, symmetry=True, with_floating=True),
     "symmetry"),
    (dict(with_floating=True, tstep=td.TpStep.VERLET, symmetry=True),
     "symmetry"),
    (dict(symmetry=True, tvisco=td.TpVisco.LAMINAR_SPS), "symmetry"),
])
def test_unsupported_configs_raise(kw, name):
    """Settings outside the port raise, whatever the smoothing kernel and
    with floating bodies or mDBC walls on (the supported variants:
    test_torch_variants.py, test_torch_floating.py, test_torch_mdbc.py,
    test_torch_symmetry.py); the symmetry plane with floating bodies or
    laminar+SPS viscosity raises naming it."""
    for tkernel in (td.TpKernel.WENDLAND, td.TpKernel.CUBIC):
        csp = td.make_ctesph(simulate2d=False, dp=0.05, hswl=0.25,
                             tkernel=tkernel)
        with pytest.raises(NotImplementedError, match=name):
            F.check_supported(csp, F.SolverOpts(**kw))


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")


def twin_vs_plain(csp, opts, dom, cells, args):
    got = CF.interaction_forces_host_twin(csp, opts, dom, cells, *args)
    want = F.interaction_forces_plain(csp, opts, dom, cells, *args)
    assert_close(as_dict(want), as_dict(got), rtol=1e-4)
    return got


@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("tdensity", DDT)
def test_kernel_body_twin_matches_plain(gxx, sim2d, tdensity):
    csp, jcsp, opts, jopts, (pos, vel, rho, code, nb) = configs(sim2d, tdensity,
                                                                seed=21)
    dom, cells, args, order = sorted_inputs(csp, pos, vel, rho, code)
    launches = dict(CF.launches)
    twin_vs_plain(csp, opts, dom, cells, args)
    assert CF.launches == launches   # the twin is no kernel launch


def test_kernel_body_twin_dambreak(gxx):
    """The twin on the dam-break lattice (walls, obstacle-free) with a
    random velocity field, after a divide with the domain skin."""
    case = cases.dambreak3d(dp=0.04, tank=(0.8, 0.4, 0.3),
                            column=(0.2, 0.4, 0.2), obstacle=False,
                            device="cpu")
    st = case.state
    rng = np.random.default_rng(4)
    fluid = td.is_fluid(st.code)
    vel = torch.where(fluid[:, None],
                      torch.tensor(rng.normal(0, 0.3, (st.n, 3)), dtype=torch.float32),
                      0.0)
    cells, code = cd.divide_cells(case.dom, st.pos, st.code)
    o = cells.order
    opts = F.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
    fr = twin_vs_plain(case.csp, opts, case.dom, cells,
                       (st.pos[o], vel[o], st.rho[o], code[o]))
    assert float(fr.viscdtmax) > 0


def test_wrapper_rejects_bad_inputs():
    csp, jcsp, opts, jopts, (pos, vel, rho, code, nb) = configs(False, "NONE")
    dom, cells, (p, v, r, c), order = sorted_inputs(csp, pos, vel, rho, code)
    with pytest.raises(ValueError, match="float32"):
        CF.interaction_forces_host_twin(csp, opts, dom, cells, p.double(), v, r, c)
    with pytest.raises(ValueError, match="contiguous"):
        CF.interaction_forces_host_twin(csp, opts, dom, cells,
                                        p.t().contiguous().t(), v, r, c)
    with pytest.raises(ValueError, match="cuda"):
        CF.interaction_forces_cuda(csp, opts, dom, cells, p, v, r, c)
