"""The port's integrators against the JAX package's on random f32 states.
Both evaluate the same f32 operations in the same order, so results agree
to within 2 ulp (room for the two runtimes' sqrt and scalar handling)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.ops import integrators as jI
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.ops import integrators as I

torch.set_num_threads(2)

MAXULP = 2


def random_state(seed, n=257):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    codes = [jtd.code_make(t, 0, s) for t in range(4) for s in (0, 0, 0, 1, 2, 3)]
    code = rng.choice(np.array(codes, np.uint32), n)
    rho = rng.uniform(650, 1350, n).astype(np.float32)   # crosses the OUT_RHOP window
    return dict(pos=f(n, 3), vel=f(n, 3), rho=rho, code=code, ace=10 * f(n, 3),
                ar=100 * f(n), pose=1e-7 * f(n, 3),
                dt=np.float32(rng.uniform(1e-5, 1e-3)))


def to_jax(s):
    return {k: jnp.asarray(v) for k, v in s.items()}


def to_torch(s):
    return {k: torch.tensor(v.astype(np.int32) if k == "code" else v)
            for k, v in s.items()}


def assert_same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            np.testing.assert_array_equal(g, w.astype(np.int32))
        else:
            np.testing.assert_array_max_ulp(g, w, maxulp=MAXULP)


def csps():
    kw = dict(simulate2d=False, dp=0.02, hswl=0.3)
    return td.make_ctesph(**kw), jtd.make_ctesph(**kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_symplectic_pre_matches(seed):
    csp, jcsp = csps()
    s = random_state(seed)
    j, t = to_jax(s), to_torch(s)
    want = jI.symplectic_pre(jcsp, j["pos"], j["vel"], j["rho"], j["code"],
                             j["ace"], j["ar"], j["dt"])
    got = I.symplectic_pre(csp, t["pos"], t["vel"], t["rho"], t["code"],
                           t["ace"], t["ar"], t["dt"])
    assert_same(got, want)


@pytest.mark.parametrize("seed", [2, 3])
def test_symplectic_corr_matches(seed):
    csp, jcsp = csps()
    s = random_state(seed)
    s["rho_now"] = s["rho"] + np.float32(0.5)
    j, t = to_jax(s), to_torch(s)
    want = jI.symplectic_corr(jcsp, j["pos"], j["vel"], j["rho"], j["rho_now"],
                              j["code"], j["ace"], j["ar"], j["dt"],
                              pose=j["pose"])
    got = I.symplectic_corr(csp, t["pos"], t["vel"], t["rho"], t["rho_now"],
                            t["code"], t["ace"], t["ar"], t["dt"], t["pose"])
    assert len(got) == len(want) == 5
    assert_same(got, want)


def test_comp_pos_update_keeps_sub_ulp_displacements():
    """Displacements below half an ulp of the position still accumulate
    through the Kahan residual."""
    pos = torch.full((4, 3), 1.0)
    pose = torch.zeros(4, 3)
    fluid = torch.tensor([True, True, False, True])
    disp = torch.full((4, 3), 2e-8)           # ulp(1.0) / 2 is ~6e-8
    for _ in range(1000):
        pos, pose = I.comp_pos_update(pos, pose, disp, fluid)
    total = (pos.double() + pose.double()) - 1.0
    np.testing.assert_allclose(total[fluid].numpy(), 2e-5, rtol=1e-3)
    assert bool((total[~fluid] == 0).all())


@pytest.mark.parametrize("use_m1", [True, False])
def test_verlet_matches(use_m1):
    csp, jcsp = csps()
    s = random_state(4)
    s["velm1"] = s["vel"] * np.float32(0.9)
    s["rhom1"] = s["rho"] + np.float32(1.0)
    j, t = to_jax(s), to_torch(s)
    want = jI.verlet(jcsp, j["pos"], j["vel"], j["rho"], j["velm1"], j["rhom1"],
                     j["code"], j["ace"], j["ar"], j["dt"], jnp.asarray(use_m1),
                     pose=j["pose"])
    got = I.verlet(csp, t["pos"], t["vel"], t["rho"], t["velm1"], t["rhom1"],
                   t["code"], t["ace"], t["ar"], t["dt"], use_m1, pose=t["pose"])
    assert_same(got, want)


@pytest.mark.parametrize("acemax,velmax,viscdt", [
    (12.5, 1.3, 40.0), (0.0, 0.0, 0.0), (1e6, 50.0, 1e4), (3.0, 0.01, 0.0)])
def test_dt_variable_matches(acemax, velmax, viscdt):
    csp, jcsp = csps()
    a, v, vd = (np.float32(x) for x in (acemax, velmax, viscdt))
    want = jI.dt_variable_parts(jcsp, jnp.asarray(a), jnp.asarray(v),
                                jnp.asarray(vd))
    got = I.dt_variable_parts(csp, torch.tensor(a), torch.tensor(v),
                              torch.tensor(vd))
    for g, w in zip(got, want):
        if np.asarray(w).dtype == bool:
            assert bool(g) == bool(w)
        else:
            np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), maxulp=MAXULP)
    dt, bad = I.dt_variable(csp, torch.tensor(a), torch.tensor(v), torch.tensor(vd))
    assert float(dt) >= csp.dtmin and bool(bad) == bool(want[1])


def test_dt_variable_fixed_and_clamped():
    csp, jcsp = csps()
    fixed = csp.replace(dtfixed=2e-4)
    dt, bad = I.dt_variable(fixed, torch.tensor(1.0), torch.tensor(1.0),
                            torch.tensor(0.0))
    assert float(dt) == np.float32(2e-4) and not bool(bad)
    dt, bad = I.dt_variable(csp, torch.tensor(1e12), torch.tensor(1.0),
                            torch.tensor(0.0))
    assert float(dt) == np.float32(csp.dtmin) and bool(bad)


@pytest.mark.parametrize("dtall", [False, True])
def test_velocity_and_ace_max_match(dtall):
    csp, jcsp = csps()
    csp, jcsp = csp.replace(dtallparticles=dtall), jcsp.replace(dtallparticles=dtall)
    s = random_state(5)
    j, t = to_jax(s), to_torch(s)
    np.testing.assert_array_max_ulp(
        I.velocity_max(csp, t["vel"], t["code"]).numpy(),
        np.asarray(jI.velocity_max(jcsp, j["vel"], j["code"])), maxulp=MAXULP)
    np.testing.assert_array_max_ulp(
        I.ace_max(t["ace"], t["code"]).numpy(),
        np.asarray(jI.ace_max(j["ace"], j["code"])), maxulp=MAXULP)
