"""The JAX package's two multiphase non-Newtonian paths against each other
on the CPU: the Pallas kernels (`ops/pallas/nnforce.py`, in interpret
mode) and the bucket path (`ops/forces_nn.py`, the port's reference), on
one perturbed state of the 2D wet dam break at dp 0.05 m (228 particles;
0.5 m/s velocity jitter, 1% density jitter, seed 0), for the NN
configurations the port's slices cover: the default, the cubic spline,
the shifting modes, both together, SPH and FDA.

    python3 port_nnref_check.py

Prints one line per configuration: for ace, ar, the shifting sums and
visco_eta the largest difference over the largest value, the relative
difference of viscetadtmax, and how many shifting flags differ.  The
JAX package's own test (`tests/test_nnewtonian.py`) compares the two paths
only through positions after 10 steps from rest, in the default
configuration.  Each configuration takes 25-80 s (interpret mode).
"""

import dataclasses
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dualsphysics_multilayer_tpu import typesdef as td  # noqa: E402
from dualsphysics_multilayer_tpu.models import nnewtonian as NNM  # noqa: E402
from dualsphysics_multilayer_tpu.models.wcsph import make_carry  # noqa: E402
from dualsphysics_multilayer_tpu.ops import celldiv as cd  # noqa: E402
from dualsphysics_multilayer_tpu.ops import forces_nn as NN  # noqa: E402
from dualsphysics_multilayer_tpu.ops.forces import SolverOpts  # noqa: E402
from dualsphysics_multilayer_tpu.ops.pallas import nnforce as NF  # noqa: E402

CONFIGS = [  # (tvisco, velgrad, tkernel, shiftmode)
    ("LAMINAR_SPS", "SPH", "WENDLAND", "NONE"),
    ("LAMINAR_SPS", "FDA", "WENDLAND", "NONE"),
    ("LAMINAR_SPS", "SPH", "CUBIC", "NONE"),
    ("LAMINAR_SPS", "SPH", "WENDLAND", "NO_BOUND"),
    ("CONST_EQ", "SPH", "CUBIC", "NO_FIXED"),
    ("ARTIFICIAL", "SPH", "CUBIC", "FULL"),
    ("LAMINAR_SPS", "FDA", "CUBIC", "NO_BOUND"),
]


def perturbed(case):
    st = case.state
    rng = np.random.default_rng(0)
    n = st.n
    code = np.asarray(st.code)
    fluid = td.code_type(code) == td.TYPE_FLUID
    vel = np.where(fluid[:, None], rng.normal(0.0, 0.5, (n, 3)), 0.0)
    vel[:, 1] = 0.0
    rho = np.asarray(st.rho) * (1.0 + np.where(
        fluid, rng.uniform(-0.01, 0.01, n), 0.0))
    return dataclasses.replace(st, vel=jnp.asarray(vel, jnp.float32),
                               rho=jnp.asarray(rho, jnp.float32))


def compare(case, phases, st, tvisco, velgrad, tkernel, shiftmode):
    csp = case.csp.replace(tkernel=td.TpKernel[tkernel])
    opts = SolverOpts(tvisco=td.TpVisco[tvisco], velgrad=td.TpVelGrad[velgrad],
                      tdensity=td.TpDensity.FOURTAKAS, use_pallas=True,
                      shiftmode=td.TpShifting[shiftmode])
    # the Pallas path's row-padded layout, and the same state for both
    carry = make_carry(st, csp, opts, dom=case.dom, use_rowdiv=True)
    s2 = carry.st
    fp, etap, _ = NF.interaction_forces_nn_rows(
        csp, opts, phases, case.dom, carry.rdiv, s2.pos, s2.vel, s2.rho,
        s2.code, interpret=True)
    div, code = cd.divide(case.dom, s2.pos, s2.code)
    fb, etab, _ = NN.interaction_forces_nn(
        csp, dataclasses.replace(opts, use_pallas=False), phases, case.dom,
        div, s2.pos, s2.vel, s2.rho, code)
    act = np.asarray(td.is_active(s2.code))
    out = []
    for k, a, b in (("ace", fp.ace, fb.ace), ("ar", fp.ar, fb.ar),
                    ("shiftposfs", fp.shiftposfs, fb.shiftposfs),
                    ("visco_eta", etap, etab)):
        if b is None:
            continue
        a, b = np.asarray(a)[act], np.asarray(b)[act]
        out.append(f"{k} {np.abs(a - b).max() / (np.abs(b).max() + 1e-30):.2e}")
    ep, eb = float(fp.viscetadtmax), float(fb.viscetadtmax)
    out.append(f"viscetadtmax {abs(ep - eb) / (abs(eb) + 1e-30):.2e}")
    if fb.shift_blocked is not None:
        a = np.asarray(fp.shift_blocked)[act]
        b = np.asarray(fb.shift_blocked)[act]
        out.append(f"flags differing {int((a != b).sum())} of {int(b.sum())} set")
    return "; ".join(out)


def main():
    case, phases = NNM.wet_dambreak_nn(dp=0.05)
    st = perturbed(case)
    for cfg in CONFIGS:
        t0 = time.perf_counter()
        line = compare(case, phases, st, *cfg)
        print(" ".join(cfg) + f": {line} ({time.perf_counter() - t0:.1f} s)",
              flush=True)


if __name__ == "__main__":
    main()
