"""Domains without a cell skin: cells of exactly the kernel size, JAX
``celldiv.make_domain``'s default (``skin=0``), which the JAX package runs
on its bucket path by dividing at every interaction.  The port then
rebuilds at every step and divides each interaction's own positions
afresh (``wcsph.fresh_interaction``), so the corrector finds the pairs of
the predicted positions.

Held here against the JAX package's jitted ``make_step`` /
``make_nn_step`` (``use_pallas=False``) on the same skinless domain, from
a flow fast enough to move particles across the cell faces: the 2D dam
break (symplectic, Fourtakas) and the NN wet dam break (SPH Morris), 4 and
3 steps, positions by id within 1e-4*dp, density within rtol 1e-5, dt
within rtol 1e-4 (the contract of test_torch_wcsph.py); and one
interaction of a state moved after its divide against the naive O(N^2)
oracle, which the stale layout misses and ``fresh_interaction``
matches.  What a skinless
domain does not run yet raises before a step: inlet/outlet zones and a
domain decomposition; cells narrower than the kernel size raise too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ref_naive import naive_forces

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import nnewtonian as jNM
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import celldiv as jcd
from dualsphysics_multilayer_tpu.ops import eos as jeos
from dualsphysics_multilayer_tpu.ops.forces import SolverOpts as JOpts
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.models import wcsph as W
from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.parallel import sharding as S

torch.set_num_threads(2)

DP = 0.05


def skinless(jcase):
    """The JAX case's grid with cells of the kernel size (skin 0), and its
    port conversion."""
    d = jcase.dom
    posmax = [p + n * d.scell for p, n in zip(d.posmin, d.nc)]
    jdom = jcd.make_domain(d.posmin, posmax, jcase.csp.kernelsize,
                           simulate2d=d.simulate2d, dp=jcase.csp.dp)
    dom = convert.domain(dataclasses.asdict(jdom))
    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    assert dom.scell == csp.kernelsize and W.skinless(csp, dom)
    return jdom, csp, dom


def flowing(st):
    arrays = {k: np.asarray(getattr(st, k))
              for k in ("pos", "vel", "rho", "code", "idp")}
    rng = np.random.default_rng(11)
    fluid = jtd.code_type(arrays["code"]) == jtd.TYPE_FLUID
    vel = np.array([2.5, 0.0, 0.0]) + rng.normal(0.0, 0.3, arrays["pos"].shape)
    vel[:, 1] = 0.0
    arrays["vel"] = np.where(fluid[:, None], vel, 0.0).astype(np.float32)
    return arrays


def assert_steps_match(carry, jcarry, dp):
    st = carry.st
    idp = st.idp.numpy()
    out = {}
    for k in ("pos", "rho"):
        a = getattr(st, k).numpy()
        out[k] = np.empty_like(a)
        out[k][idp] = a
    np.testing.assert_allclose(out["pos"], np.asarray(jcarry.st.pos), rtol=0,
                               atol=1e-4 * dp)
    np.testing.assert_allclose(out["rho"], np.asarray(jcarry.st.rho),
                               rtol=1e-5)
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)
    assert carry.overflow == 0 == int(jcarry.overflow)


def test_skinless_symplectic_steps_match_jax():
    jcase = jcases.dambreak2d(dp=DP)
    jdom, csp, dom = skinless(jcase)
    arrays = flowing(jcase.state)
    jopts = JOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    jstep = jax.jit(jW.make_step(jcase.csp, jopts, jdom))
    jcarry = jW.make_carry(dataclasses.replace(
        jcase.state, vel=jnp.asarray(arrays["vel"])), jcase.csp, jopts,
        dom=jdom)
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_step(csp, opts, dom)
    for _ in range(4):
        jcarry, carry = jstep(jcarry), step(carry)
        assert carry.rebuild            # every step starts with a divide
    assert carry.nrebuild == 1 + 4      # the carry's and each step's
    assert_steps_match(carry, jcarry, DP)


def test_skinless_nn_steps_match_jax():
    jcase, jph = jNM.wet_dambreak_nn(dp=DP)
    jdom, csp, dom = skinless(jcase)
    arrays = flowing(jcase.state)
    jopts = JOpts(tvisco=jtd.TpVisco.LAMINAR_SPS,
                  tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    jstep = jax.jit(jNM.make_nn_step(jcase.csp, jopts, jdom, jph))
    jcarry = jW.make_carry(dataclasses.replace(
        jcase.state, vel=jnp.asarray(arrays["vel"])), jcase.csp, jopts)
    opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS,
                        tdensity=td.TpDensity.FOURTAKAS)
    carry = P.make_carry(convert.simstate(arrays, device="cpu"), csp, opts, dom)
    step = P.make_nn_step(csp, opts, dom, convert.phasecfg(jph))
    for _ in range(3):
        jcarry, carry = jstep(jcarry), step(carry)
    assert_steps_match(carry, jcarry, DP)


def test_fresh_interaction_finds_the_pairs_a_stale_layout_misses():
    """``fresh_interaction`` on a state moved after its divide (fluid
    particles up to 0.3 kernel sizes from their slots' cells) gives the
    naive O(N^2) oracle's forces (tests/ref_naive.py, the rule of
    test_torch_forces.py) in the state's own slot order, where the stale
    layout misses pairs."""
    jcase = jcases.dambreak2d(dp=DP)
    jdom, csp, dom = skinless(jcase)
    st = convert.simstate(flowing(jcase.state), device="cpu")
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    st = dataclasses.replace(st, code=code).permuted(cells.order)
    rng = np.random.default_rng(5)
    d = torch.tensor(rng.uniform(-0.3, 0.3, (st.n, 3)) * csp.kernelsize,
                     dtype=torch.float32)
    d[:, 1] = 0.0
    moved = dataclasses.replace(st, pos=torch.where(
        td.is_fluid(st.code)[:, None], st.pos + d, st.pos))
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)

    def interact(s, c):
        return s, F.interaction_forces(csp, opts, dom, c, s.pos, s.vel,
                                       s.rho, s.code)

    after, got = W.fresh_interaction(dom, moved, interact)
    assert torch.equal(after.pos, moved.pos)
    arr = {k: getattr(moved, k).numpy() for k in ("pos", "vel", "rho", "code")}
    jcsp = jcase.csp
    press = np.asarray(jeos.press_from_rho(jcsp, jnp.asarray(arr["rho"])))
    want = naive_forces(jcsp, JOpts(tdensity=jtd.TpDensity.FOURTAKAS),
                        arr["pos"], arr["vel"], arr["rho"],
                        press.astype(np.float64), arr["code"])
    for k in ("ace", "ar"):
        w = torch.tensor(want[k], dtype=torch.float32)
        scale = float(w.abs().max())
        torch.testing.assert_close(getattr(got, k), w, rtol=2e-3,
                                   atol=2e-3 * scale, msg=k)
    _, stale = interact(moved, cells)
    w = torch.tensor(want["ace"], dtype=torch.float32)
    assert float((stale.ace - w).abs().max()) > 0.1 * float(w.abs().max())


def test_skinless_refusals():
    case = cases.channel2d(dp=0.05, device="cpu")
    d = case.dom
    flat = dataclasses.replace(d, scell=case.csp.kernelsize)
    with pytest.raises(NotImplementedError, match="inlet/outlet zones"):
        P.make_step(case.csp, P.SolverOpts(), flat,
                    P.Features(inout=case.meta["inout"]))
    with pytest.raises(NotImplementedError, match="domain decomposition"):
        S.ShardedSimulation(case.csp, P.SolverOpts(), flat, case.state,
                            ndev=2, device="cpu")
    narrow = dataclasses.replace(d, scell=0.9 * case.csp.kernelsize)
    with pytest.raises(ValueError, match="narrower than the kernel size"):
        P.make_carry(case.state, case.csp, P.SolverOpts(), narrow)
