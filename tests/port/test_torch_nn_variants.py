"""The multiphase non-Newtonian variants: the cubic spline with its tensile
correction and the three shifting modes under the mphase fork's
heavy-phase gate.

* Interaction: the plain torch version and the CPU twins of the CUDA
  kernels (g++) each against the JAX bucket path
  (``forces_nn.interaction_forces_nn``, eager, as test_torch_forces_nn.py
  runs it), on the small 2D wet dam break under the five NN viscosity
  configurations (the 3D two-phase cloud's cases are
  test_torch_forces_nn.py::test_variant_matches_jax_3d_cloud, where that
  cloud's JAX operations are compiled already).  Tolerance: rtol 2e-3 with
  an absolute floor of 2e-3 of the largest value on ace, ar, visco_eta,
  tau and the shifting sums, rtol 4e-3 wherever the cubic spline runs (the
  tolerance of JAX's own cubic test, tests/test_forces.py:90); viscdtmax
  and viscetadtmax at the same rtol; the shifting flags exact.  Each JAX
  result is computed once per module and shared by the plain and twin
  cases.
* Steps: 3 steps of ``-shifting:2`` SPH Morris and of ``-cubic`` FDA
  Morris against eager JAX ``make_nn_step(use_pallas=False)``, positions
  within 1e-4*dp by particle id (the contract of test_torch_nnewtonian.py).
* The skin contract under NN shifting: between rebuilds the layout of the
  last divide holds every pair a fresh divide finds.
"""

import ctypes
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import nnewtonian as jNM
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import forces_nn as jNN
from dualsphysics_multilayer_tpu.ops.forces import SolverOpts as JOpts
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
from dualsphysics_multilayer_tpu_torch.ops.cuda import build
from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF

from test_torch_forces_nn import SCALARS, sorted_inputs, wet  # noqa: F401
from test_torch_nnewtonian import flowing_arrays

torch.set_num_threads(2)

# name: (tkernel, shiftmode)
VARIANTS = {
    "cubic": ("CUBIC", "NONE"),
    "no-bound": ("WENDLAND", "NO_BOUND"),
    "no-fixed": ("WENDLAND", "NO_FIXED"),
    "full": ("WENDLAND", "FULL"),
    "cubic+no-bound": ("CUBIC", "NO_BOUND"),
}
# name: (tvisco, velgrad), all with Fourtakas diffusion
VISCOS = {
    "sph-morris": ("LAMINAR_SPS", "SPH"),
    "sph-conseq": ("CONST_EQ", "SPH"),
    "sph-artificial": ("ARTIFICIAL", "SPH"),
    "fda-morris": ("LAMINAR_SPS", "FDA"),
    "fda-conseq": ("CONST_EQ", "FDA"),
}
ARRAYS = ("ace", "ar", "visco_eta", "tau", "shiftposfs")
DP = 0.05


def configure(case, variant, visco):
    """(JAX csp, port csp, JAX opts, port opts) of a variant and a
    viscosity configuration on a case of test_torch_forces_nn.py."""
    tkernel, shiftmode = VARIANTS[variant]
    tvisco, velgrad = VISCOS[visco]

    def opts(cls, m):
        return cls(tvisco=m.TpVisco[tvisco], velgrad=m.TpVelGrad[velgrad],
                   tdensity=m.TpDensity.FOURTAKAS,
                   shiftmode=m.TpShifting[shiftmode])
    return (case["jcsp"].replace(tkernel=jtd.TpKernel[tkernel]),
            case["csp"].replace(tkernel=td.TpKernel[tkernel]),
            opts(JOpts, jtd), opts(P.SolverOpts, td))


def rtol_of(variant):
    return 4e-3 if VARIANTS[variant][0] == "CUBIC" else 2e-3


@pytest.fixture(scope="module")
def jax_result():
    """(case name, variant, viscosity) -> the JAX bucket path's result in
    canonical order, computed once for the module."""
    memo = {}

    def get(name, case, variant, visco):
        key = (name, variant, visco)
        if key not in memo:
            jcsp, _, jopts, _ = configure(case, variant, visco)
            a = {k: jnp.asarray(v) for k, v in case["arrays"].items()}
            div, code = jcd.divide(case["jdom"], a["pos"], a["code"])
            assert int(div.overflow) == 0
            fr, eta, tau = jNN.interaction_forces_nn(
                jcsp, jopts, case["jph"], case["jdom"], div, a["pos"],
                a["vel"], a["rho"], code)
            shift = fr.shiftposfs
            memo[key] = dict(
                ace=np.asarray(fr.ace), ar=np.asarray(fr.ar),
                visco_eta=np.asarray(eta), tau=np.asarray(tau),
                shiftposfs=None if shift is None else np.asarray(shift),
                shift_blocked=None if shift is None
                else np.asarray(fr.shift_blocked),
                viscdtmax=float(fr.viscdtmax),
                viscetadtmax=float(fr.viscetadtmax))
        return memo[key]

    return get


def port_dict(r: NN.NnResult, order):
    """An NnResult in canonical order, as numpy."""
    fr = r.forces
    out = dict(ace=fr.ace, ar=fr.ar, visco_eta=r.visco_eta, tau=r.tau,
               shiftposfs=fr.shiftposfs, shift_blocked=fr.shift_blocked)
    for k, v in out.items():
        if v is not None:
            canon = np.empty_like(v.numpy())
            canon[order] = v.numpy()
            out[k] = canon
    out.update(viscdtmax=float(fr.viscdtmax),
               viscetadtmax=float(fr.viscetadtmax))
    return out


def assert_matches(want, got, rtol):
    for k in ARRAYS:
        if want[k] is None:
            assert got[k] is None, k
            continue
        scale = np.abs(want[k]).max() + 1e-6
        np.testing.assert_allclose(got[k], want[k], atol=rtol * scale,
                                   rtol=rtol, err_msg=k)
    if want["shift_blocked"] is None:
        assert got["shift_blocked"] is None
    else:
        np.testing.assert_array_equal(got["shift_blocked"],
                                      want["shift_blocked"])
    for k in SCALARS:
        assert np.isclose(got[k], want[k], rtol=rtol, atol=1e-6), \
            (k, got[k], want[k])


def check_variant(case, name, variant, visco, jax_result):
    """The plain version and the g++ twin against the JAX bucket path."""
    want = jax_result(name, case, variant, visco)
    _, csp, _, opts = configure(case, variant, visco)
    cells, args, order = sorted_inputs(case)
    run = (csp, opts, case["ph"], case["dom"], cells, *args)
    plain = port_dict(NN.interaction_forces_nn_plain(*run), order)
    assert_matches(want, plain, rtol_of(variant))
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")
    launches = dict(NF.launches)
    twin = port_dict(NF.interaction_forces_nn_host_twin(*run), order)
    assert NF.launches == launches          # the twins are no kernel launches
    assert_matches(want, twin, rtol_of(variant))
    return want


def cross_phase_pairs(case):
    """In-support pairs of a target of the heavier fluid phase (mud) with a
    candidate of the lighter one (water): the pairs the heavy-phase gate
    drops from the shifting sums."""
    a = case["arrays"]
    fluid = jtd.code_type(a["code"]) == jtd.TYPE_FLUID
    mk = jtd.code_value(a["code"])
    d = a["pos"][:, None, :] - a["pos"][None, :, :]
    near = (d * d).sum(-1) <= case["csp"].kernelsize2
    return int(near[np.ix_(fluid & (mk == 1), fluid & (mk == 0))].sum())


@pytest.mark.parametrize("visco", list(VISCOS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax_wet_dambreak(wet, jax_result, variant, visco):
    want = check_variant(wet, "wet", variant, visco, jax_result)
    if VARIANTS[variant][1] != "NONE":
        assert np.abs(want["shiftposfs"]).max() > 0
        assert cross_phase_pairs(wet) > 0
        # the walls block some fluid under NO_BOUND; the NN path blocks
        # nothing under the other modes
        assert want["shift_blocked"].any() == (VARIANTS[variant][1] == "NO_BOUND")


def test_launchers_refuse_what_they_have_no_instance_for(wet):
    """A launcher refuses a shifting mode without its shift outputs, and a
    kernel it has no instance of, with the CUDA launchers' code
    cudaErrorInvalidValue (1); the twins share the launchers' choice."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")
    _, csp, _, opts = configure(wet, "cubic+no-bound", "sph-morris")
    cells, (pos, vel, rho, code), _ = sorted_inputs(wet)
    ph, n = wet["ph"], pos.shape[0]
    ch = NN.channels(csp, ph, ph.tables(csp, "cpu"), rho, code)
    pospress, velrho = NF._rows(pos, vel, rho, ch)
    outs = [torch.empty((n, 3)), torch.empty(n), torch.empty(n),
            torch.empty((n, 6)), torch.empty((n, 4)),
            torch.empty(n, dtype=torch.bool)]
    ins = [pospress, velrho, ch.kind, ch.phase, cells.cell, cells.begin]
    lib = build.host_twin_library("nnforce")
    params = NF.make_params(csp, opts, ph, wet["dom"], n)

    def call(fn, p, tensors):
        return getattr(lib, fn)(ctypes.byref(p), *[
            None if t is None else t.data_ptr() for t in ins + tensors])

    for fn in ("dsph_nnforce_p1_host", "dsph_nnforce_fda_host"):
        assert call(fn, params, outs) == 0
        assert call(fn, params, outs[:4] + [None, None]) == 1
        other = NF.NnParams.from_buffer_copy(params)
        other.tkernel = 3
        assert call(fn, other, outs) == 1
    other = NF.NnParams.from_buffer_copy(params)
    other.tkernel = 3
    eta_tau_ace = [torch.zeros(n), torch.zeros((n, 6)), torch.zeros((n, 3))]
    assert call("dsph_nnforce_p3_host", params, eta_tau_ace) == 0
    assert call("dsph_nnforce_p3_host", other, eta_tau_ace) == 1


def run_jax_steps(case, jph, jcsp, jopts, arrays, nsteps):
    """``nsteps`` eager JAX steps (the interaction cases' shapes, so they
    reuse their compiled operations)."""
    jstep = jNM.make_nn_step(jcsp, jopts, case.dom, jph)
    jcarry = jW.make_carry(dataclasses.replace(case.state,
                                               vel=jnp.asarray(arrays["vel"])),
                           jcsp, jopts)
    for _ in range(nsteps):
        jcarry = jstep(jcarry)
    return jcarry


def by_id(st, name):
    v = getattr(st, name)
    out = torch.empty_like(v)
    out[st.idp] = v
    return out.numpy()


# name: (tkernel, shiftmode, tvisco, velgrad)
PATHS = {
    "shifting:2 sph-morris": ("WENDLAND", "NO_FIXED", "LAMINAR_SPS", "SPH"),
    "cubic fda-morris": ("CUBIC", "NONE", "LAMINAR_SPS", "FDA"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_nn_variant_steps_match_jax(path):
    tkernel, shiftmode, tvisco, velgrad = PATHS[path]
    case, jph = jNM.wet_dambreak_nn(dp=DP)
    jcsp = case.csp.replace(tkernel=jtd.TpKernel[tkernel])

    def opts(cls, m, **kw):
        return cls(tvisco=m.TpVisco[tvisco], velgrad=m.TpVelGrad[velgrad],
                   tdensity=m.TpDensity.FOURTAKAS,
                   shiftmode=m.TpShifting[shiftmode], **kw)
    arrays = flowing_arrays(case)
    nsteps = 3
    jcarry = run_jax_steps(case, jph, jcsp, opts(JOpts, jtd, use_pallas=False),
                           arrays, nsteps)
    assert int(jcarry.overflow) == 0

    csp = convert.ctesph(dataclasses.asdict(jcsp))
    dom = convert.domain(dataclasses.asdict(case.dom))
    popts = opts(P.SolverOpts, td)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, popts,
                         dom)
    step = P.make_nn_step(csp, popts, dom, convert.phasecfg(jph))
    for _ in range(nsteps):
        carry = step(carry)
    assert carry.nstep == nsteps == int(jcarry.nstep)
    assert carry.nrebuild >= 2
    np.testing.assert_allclose(by_id(carry.st, "pos"), np.asarray(jcarry.st.pos),
                               rtol=0, atol=1e-4 * DP)
    np.testing.assert_allclose(by_id(carry.st, "rho"), np.asarray(jcarry.st.rho),
                               rtol=1e-5)
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)


def pairs_per_target(csp, dom, cells, pos, code):
    """In-support pairs of every target through the layout ``cells`` (slot
    order), as the NN bodies count them (rr2 <= kernelsize^2)."""
    live = td.is_active(code) & (cells.cell < dom.ncells)
    count = torch.zeros(pos.shape[0], dtype=torch.int64)
    for t, j, valid in F.candidate_chunks(dom, cells, live, 1 << 20):
        rr2 = ((pos[t, None, :] - pos[j]) ** 2).sum(dim=-1)
        count[t] = (valid & (j != t[:, None]) & live[j] & (rr2 >= td.ALMOSTZERO)
                    & (rr2 <= csp.kernelsize2)).sum(dim=1)
    return count


def test_nn_shifting_layout_keeps_every_pair():
    """Between rebuilds, the layout of the last divide finds every pair a
    fresh divide finds, at the positions of the next predictor and one dt
    beyond, while NN shifting moves the particles: the skin contract needs
    no shifting term (a shift is at most 0.1 dp a step, inside the skin's
    accounting of the largest displacement)."""
    case, ph = NM.wet_dambreak_nn(dp=DP, device="cpu")
    csp = case.csp
    opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS,
                        tdensity=td.TpDensity.FOURTAKAS,
                        shiftmode=td.TpShifting.NO_FIXED)
    fluid = td.is_fluid(case.state.code)
    vel = torch.where(fluid[:, None], torch.tensor([1.0, 0.0, 0.0]), 0.0)
    carry = P.make_carry(dataclasses.replace(case.state, vel=vel), csp, opts,
                         case.dom)
    step = P.make_nn_step(csp, opts, case.dom, ph)
    checked = 0
    for _ in range(10):
        carry = step(carry)
        if carry.rebuild:
            continue
        st = carry.st
        for pos in (st.pos, st.pos + carry.dt_pre * st.vel):
            fresh, code = cd.divide_cells(case.dom, pos, st.code)
            want = torch.empty_like(fresh.order)
            want[fresh.order] = pairs_per_target(csp, case.dom, fresh,
                                                 pos[fresh.order],
                                                 code[fresh.order])
            got = pairs_per_target(csp, case.dom, carry.cells, pos, st.code)
            assert torch.equal(got, want)
        checked += 1
    assert checked >= 2 and carry.nrebuild >= 2
