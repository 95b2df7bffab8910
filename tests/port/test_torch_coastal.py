"""The 3D coastal run-up (BASELINE config 5) in the port against the JAX
package, and the small pieces that came with it.

* ``cases.coastal_runup3d`` against JAX's builder array by array (pos,
  code, idp, rho, vel; the domain, npb, np_total, meta) in three parameter
  sets: positions, codes and ids exact, density and velocity within rtol
  1e-6.  No JAX step runs there.
* 3 symplectic steps of ``tests/test_simulation.py:101``'s mini case (its
  solitary wave) against JAX's jitted ``make_step(use_pallas=False)`` on
  the same state, by id: positions within 1e-4*dp, rho rtol 1e-5, dt_pre
  rtol 1e-4 (the contract of ``test_torch_wcsph.py``), and no CPU tensor
  reaching the kernel.
* The JAX test's physics on the port alone: the crest moves shoreward by
  0.35-1.8 of c*t over 0.12 s, overflow 0, a finite state, |mean rho -
  1000| < 60.  Its ~150 steps run their interactions through kernel 1's
  body compiled by g++ (``interaction_forces_host_twin``, the code the card
  runs): the plain torch version takes ~2 s a step here.
* ``-cpu -builtin coastal_runup3d`` through the CLI, whose PARTs read back.
* ``utils.timers.profile_step``, ``utils.runinfo.MeanValue`` against
  JAX's, and ``parallel.sharding.dryrun`` over 2 ranks on the CPU.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.models import wcsph as jW
from dualsphysics_multilayer_tpu.ops import forces as jF
from dualsphysics_multilayer_tpu.utils import runinfo as jrun
import dualsphysics_multilayer_tpu_torch as P
from dualsphysics_multilayer_tpu_torch import cli, convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.io import partdata as PD
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.ops import forces as F
from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
from dualsphysics_multilayer_tpu_torch.parallel import sharding
from dualsphysics_multilayer_tpu_torch.utils import runinfo, timers

torch.set_num_threads(2)

# tests/test_simulation.py:101: 3,471 particles with the solitary wave
MINI = dict(dp=0.08, length=3.2, width=0.9, depth=0.3, slope_start=1.2,
            slope=0.15, wave_height=0.12)
NSTEPS = 3


@pytest.mark.parametrize("kw", [
    dict(dp=0.1),
    MINI,
    dict(MINI, need_sps=True, capacity=3471 + 64),
], ids=["default-geometry", "mini-wave", "mini-sps-capacity"])
def test_builder_matches_jax(kw):
    want = jcases.coastal_runup3d(**kw)
    got = cases.coastal_runup3d(**kw, device="cpu")
    assert (got.np_total, got.npb) == (want.np_total, want.npb)
    assert got.meta == want.meta
    assert got.dom.posmin == want.dom.posmin
    assert got.dom.scell == want.dom.scell
    assert got.dom.nc == want.dom.nc
    st, jst = got.state, want.state
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))
    np.testing.assert_array_equal(st.code.numpy(),
                                  np.asarray(jst.code).astype(np.int32))
    np.testing.assert_array_equal(st.idp.numpy(), np.asarray(jst.idp))
    np.testing.assert_allclose(st.rho.numpy(), np.asarray(jst.rho), rtol=1e-6)
    np.testing.assert_allclose(st.vel.numpy(), np.asarray(jst.vel), rtol=1e-6)
    assert (st.spstau is None) == (jst.spstau is None)
    if jst.spstau is not None:
        np.testing.assert_array_equal(st.spstau.numpy(),
                                      np.asarray(jst.spstau))
    if "wave_height" in kw:
        assert float(st.vel[:, 0].max()) > 0.1     # the hump's velocity


@pytest.fixture(scope="module")
def jax_mini():
    case = jcases.coastal_runup3d(**MINI)
    opts = jF.SolverOpts(tdensity=jtd.TpDensity.FOURTAKAS, use_pallas=False)
    step = jax.jit(jW.make_step(case.csp, opts, case.dom))
    carry = jW.make_carry(case.state, case.csp, opts, dom=case.dom)
    for _ in range(NSTEPS):
        carry = step(carry)
    return case, carry


def by_id(st, key):
    x = getattr(st, key)
    out = torch.empty_like(x)
    out[st.idp] = x
    return out.numpy()


def test_steps_match_jax(jax_mini):
    jcase, jcarry = jax_mini
    case = cases.coastal_runup3d(**MINI, device="cpu")
    csp = convert.ctesph(dataclasses.asdict(jcase.csp))
    assert csp == case.csp
    opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
    carry = P.make_carry(case.state, case.csp, opts, case.dom)
    step = P.make_step(case.csp, opts, case.dom)
    launches = dict(CF.launches)
    for _ in range(NSTEPS):
        carry = step(carry)
    assert CF.launches == launches      # CPU tensors never reach the kernel
    assert carry.nstep == NSTEPS == int(jcarry.nstep)
    assert carry.overflow == 0 == int(jcarry.overflow)
    jst = jcarry.st
    np.testing.assert_allclose(by_id(carry.st, "pos"), np.asarray(jst.pos),
                               rtol=0, atol=1e-4 * MINI["dp"])
    np.testing.assert_allclose(by_id(carry.st, "rho"), np.asarray(jst.rho),
                               rtol=1e-5)
    np.testing.assert_allclose(float(carry.dt_pre), float(jcarry.dt_pre),
                               rtol=1e-4)


def crest_x(st):
    live = td.is_fluid(st.code) & td.is_active(st.code)
    pf = st.pos[live]
    return float(pf[torch.argmax(pf[:, 2]), 0])


def test_solitary_wave_runs_shoreward(monkeypatch):
    """tests/test_simulation.py:97-126 on the port: the hump travels at
    about sqrt(g (d + H))."""
    monkeypatch.setattr(F, "interaction_forces",
                        CF.interaction_forces_host_twin)
    case = cases.coastal_runup3d(**MINI, device="cpu")
    sim = P.Simulation(case.csp, P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS),
                       case.dom, case.state)
    x0 = crest_x(sim.state)
    sim.run(tmax=0.12, tout=0.06)
    x1 = crest_x(sim.state)
    st = sim.state
    live = td.is_active(st.code) & td.is_fluid(st.code)
    assert sim.carry.overflow == 0
    assert bool(torch.isfinite(st.pos[live]).all())
    assert abs(float(st.rho[live].mean()) - 1000) < 60
    c = np.sqrt(9.81 * (MINI["depth"] + MINI["wave_height"]))
    assert 0.35 * c * 0.12 < (x1 - x0) < 1.8 * c * 0.12, (x0, x1)


def test_cli_runs_the_builtin(tmp_path):
    assert "coastal_runup3d" in cli.BUILTINS
    # the first step, at DtIni (3.9 ms), passes both PART times
    assert cli.main(["-cpu", "-builtin", "coastal_runup3d", "-dp", "0.1",
                     "-tmax:0.002", "-tout:0.001", "-nortimes",
                     "-dirout", str(tmp_path)]) == 0
    case = cases.coastal_runup3d(dp=0.1, device="cpu")
    rho0 = case.csp.rhopzero
    for k in range(3):
        part = PD.read_part(tmp_path / PD.part_filename(k))
        assert sorted(part["idp"].tolist()) == list(range(case.np_total))
        assert np.isfinite(part["pos"]).all()
        fluid = td.code_type(part["code"]) == td.TYPE_FLUID
        rho = part["rhop"][fluid]
        assert 0.9 * rho0 < rho.min() and rho.max() < 1.1 * rho0
        # still water: the builder's default wave height is 0
        if k == 0:
            np.testing.assert_array_equal(part["vel"], 0.0)


def test_profile_step_times_each_phase():
    # a short beach: 654 particles
    case = cases.coastal_runup3d(dp=0.1, length=1.2, width=0.8, depth=0.3,
                                 slope_start=0.5, slope=0.2, device="cpu")
    out = timers.profile_step(case.csp,
                              P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS),
                              case.dom, case.state, reps=1)
    assert sorted(out) == ["CF-Forces", "NL-Divide", "SU-FullStep"]
    assert all(v > 0 for v in out.values())


def test_mean_value_matches_jax():
    values = np.random.default_rng(5).normal(3.0, 2.0, 50)
    got, want = runinfo.MeanValue(), jrun.MeanValue()
    for v in values:
        got.add(v)
        want.add(v)
    assert (got.min, got.max, got.mean, got.values) == \
        (want.min, want.max, want.mean, want.values) == \
        (values.min(), values.max(), pytest.approx(values.mean()), 50)
    got.reset()
    assert (got.values, got.mean, got.min, got.max) == \
        (0, 0.0, float("inf"), float("-inf"))


def test_dryrun_steps_the_three_cases(capsys):
    sharding.dryrun(2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    lines = [x for x in lines if x.startswith("dryrun_multichip(2): ")]
    assert len(lines) == 3
    assert lines[0].startswith("dryrun_multichip(2): OK — nstep=1, ")
    assert "featured path OK — nstep=1 " in lines[1]
    assert "mDBC path OK — nstep=1 " in lines[2]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shape,field", [
    ((2 ** 32,), "count"),                 # 2^32 uint8 values
    ((2 ** 29 + 1, 3), "bytes"),           # 2^29+1 double3: 12 GiB + 24 B
], ids=["count", "bytes"])
def test_part_sizes_beyond_32_bits_raise(tmp_path, native, shape, field):
    """A .bi4 array's count and byte size are uint32 fields: a size that
    would wrap raises, naming the limit, before the file is made (a
    zero-stride array: no memory)."""
    from dualsphysics_multilayer_tpu_torch.io import jbinary as JB
    kind = JB.UCHAR if len(shape) == 1 else JB.DOUBLE3
    data = np.broadcast_to(np.zeros(1, JB._NP_DTYPE[kind]), shape)
    root = JB.JItem("Data", arrays=[JB.JArray("Big", kind, data)])
    path = tmp_path / "big.bi4"
    with pytest.raises(ValueError, match=f"Big: {field} .*at most 4294967295"):
        JB.write_file(path, root, native=native)
    assert not path.exists()
