"""Steps of the force-kernel variants: 3 symplectic steps of the slice's
two configurations on the small 3D dam break (876 particles) against
jitted JAX ``make_step(use_pallas=False)``:

* laminar+SPS viscosity with NO_FIXED shifting (the reference's
  ``-viscolamsps:1e-6 -shifting:2``), from rest and flowing;
* the cubic spline with artificial viscosity (``-cubic``), flowing.

Contract (README, sharded-vs-single): positions within 1e-4*dp by
particle id, density within rtol 1e-5, dt_pre within rtol 1e-4; the SPS
stress within rtol 2e-3 with a floor of 2e-3 of the largest value.  The
flowing cases re-divide inside the run, the laminar+SPS one while
shifting.  The port keeps one layout between rebuilds, so a last test
checks after each step that it still holds every pair a fresh divide
finds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import forces as jF
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F

torch.set_num_threads(2)

GEOM = dict(dp=0.04, tank=(0.8, 0.4, 0.3), column=(0.2, 0.4, 0.2),
            obstacle=False)
NSTEPS = 3
LAMSPS_VISCO = 1e-6


def lamsps_csp(m, dp):
    """The constants of a laminar+SPS dam break, as an XML case builds them
    (``make_ctesph(tvisco=LAMINAR_SPS)``: Smagorinsky and Blin constants)."""
    return m.make_ctesph(simulate2d=False, dp=dp, hswl=GEOM["column"][2],
                         coefh=1.0, visco=LAMSPS_VISCO, coefsound=20.0,
                         tvisco=m.TpVisco.LAMINAR_SPS)


def path_opts(m, path):
    """SolverOpts of the slice's two paths in module ``m`` (the JAX
    package's or the port's typesdef)."""
    if path == "lamsps":
        return dict(tvisco=m.TpVisco.LAMINAR_SPS, tdensity=m.TpDensity.FOURTAKAS,
                    shiftmode=m.TpShifting.NO_FIXED)
    return dict(tdensity=m.TpDensity.FOURTAKAS)


@pytest.fixture(scope="module")
def jax_paths():
    """path -> (case, csp, opts, jitted step) of the JAX package, each
    compiled once for the module."""
    built = {}

    def get(path):
        if path not in built:
            if path == "lamsps":
                case = jcases.dambreak3d(**GEOM, visco=LAMSPS_VISCO,
                                         need_sps=True)
                csp = lamsps_csp(jtd, GEOM["dp"])
            else:
                case = jcases.dambreak3d(**GEOM)
                csp = case.csp.replace(tkernel=jtd.TpKernel.CUBIC)
            opts = jF.SolverOpts(use_pallas=False, **path_opts(jtd, path))
            built[path] = (case, csp, opts,
                           jax.jit(jW.make_step(csp, opts, case.dom)))
        return built[path]

    return get


def flowing_arrays(case, flow, speed=2.5):
    st = case.state
    arrays = {k: np.asarray(getattr(st, k))
              for k in ("pos", "vel", "rho", "code", "idp", "spstau")
              if getattr(st, k) is not None}
    if flow:
        # a seeded flow fast enough to trip the skin contract within the run
        rng = np.random.default_rng(11)
        fluid = jtd.code_type(arrays["code"]) == jtd.TYPE_FLUID
        vel = np.array([speed, 0.0, 0.0]) + rng.normal(0.0, 0.3, arrays["pos"].shape)
        arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    return arrays


def by_id(st, name):
    v = getattr(st, name)
    out = torch.empty_like(v)
    out[st.idp] = v
    return out.numpy()


@pytest.mark.parametrize("path,flow", [("lamsps", False), ("lamsps", True),
                                       ("cubic", True)])
def test_path_steps_match_jax(jax_paths, path, flow):
    case, jcsp, jopts, jstep = jax_paths(path)
    arrays = flowing_arrays(case, flow)
    jcarry = jW.make_carry(dataclasses.replace(case.state,
                                               vel=jnp.asarray(arrays["vel"])),
                           jcsp, jopts, dom=case.dom)
    for _ in range(NSTEPS):
        jcarry = jstep(jcarry)

    csp = convert.ctesph(dataclasses.asdict(jcsp))
    dom = convert.domain(dataclasses.asdict(case.dom))
    opts = P.SolverOpts(**path_opts(td, path))
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_step(csp, opts, dom)
    for _ in range(NSTEPS):
        carry = step(carry)
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert carry.nrebuild >= (2 if flow else 1)

    np.testing.assert_allclose(by_id(carry.st, "pos"), np.asarray(jcarry.st.pos),
                               rtol=0, atol=1e-4 * csp.dp)
    np.testing.assert_allclose(by_id(carry.st, "rho"), np.asarray(jcarry.st.rho),
                               rtol=1e-5)
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
    if path == "lamsps":
        want = np.asarray(jcarry.st.spstau)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(by_id(carry.st, "spstau"), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())
    else:
        assert carry.st.spstau is None


def pairs_per_target(csp, dom, cells, pos, code):
    """In-support pairs of every target through the layout ``cells``
    (slot order): the pairs the interaction sums."""
    live = td.is_active(code) & (cells.cell < dom.ncells)
    count = torch.zeros(pos.shape[0], dtype=torch.int64)
    for t, j, valid in F.candidate_chunks(dom, cells, live, 1 << 20):
        rr2 = ((pos[t, None, :] - pos[j]) ** 2).sum(dim=-1)
        count[t] = (valid & (j != t[:, None]) & live[j] & (rr2 >= td.ALMOSTZERO)
                    & (rr2 < csp.kernelsize2)).sum(dim=1)
    return count


def test_shifting_layout_keeps_every_pair():
    """Between rebuilds, the layout of the last divide finds every pair a
    fresh divide finds, at the positions of the next predictor and one dt
    beyond, while shifting moves the particles."""
    case = cases.dambreak3d(**GEOM, visco=LAMSPS_VISCO, need_sps=True,
                            device="cpu")
    csp = lamsps_csp(td, GEOM["dp"])
    opts = P.SolverOpts(**path_opts(td, "lamsps"))
    vel = torch.tensor(flowing_arrays(case, True, speed=1.0)["vel"])
    carry = P.make_carry(dataclasses.replace(case.state, vel=vel), csp, opts,
                         case.dom)
    step = P.make_step(csp, opts, case.dom)
    checked = 0
    for _ in range(8):
        carry = step(carry)
        if carry.rebuild:
            continue
        st = carry.st
        for pos in (st.pos, st.pos + carry.dt_pre * st.vel):
            fresh, code = cd.divide_cells(case.dom, pos, st.code)
            want = torch.empty_like(fresh.order)
            want[fresh.order] = pairs_per_target(csp, case.dom, fresh,
                                                 pos[fresh.order], code[fresh.order])
            got = pairs_per_target(csp, case.dom, carry.cells, pos, st.code)
            assert torch.equal(got, want)
        checked += 1
    assert checked >= 2 and carry.nrebuild >= 2
