"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing the final result line:

1. device: the CUDA device, and ``nvidia-smi``'s name and power limit;
2. build: nvcc builds the hand-written kernels from ``csrc/``;
3. kernel vs plain: one interaction of the 3D dam break (obstacle on) at
   about 50k particles through the CUDA kernel and through its plain torch
   version on the card, compared by the rule of tests/test_forces.py
   (rtol 2e-3 on ace and ar, 1e-3 on viscdtmax), both timed with CUDA events
   (median of 7);
4. main path: the same case at bench.py's default size (BENCH_NP=300000,
   267,469 particles) through ``make_carry``/``make_step``, its fluid set
   moving at 1 m/s along x with a seeded 0.05 m/s jitter so that the skin
   contract re-divides the state within the run: 5 warm-up and 50 timed
   steps, which must launch the kernel exactly twice per step, rebuild at
   least once inside the steps, and keep the state finite and the fluid
   density within 10% of rho0; then the kernel against its plain version
   once more on the final main-path state.

The last two lines are a JSON record of the kernels and the result line
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

RTOL = 2e-3          # tests/test_forces.py assert_close, ace and ar
RTOL_VISC = 1e-3     # same rule, viscdtmax
SOURCE = "dualsphysics_multilayer_tpu_torch/csrc/cellforce.cu"
REPLACES = "dualsphysics_multilayer_tpu/ops/pallas/cellforce.py:1074"


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=7):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(csp, opts, dom, cells, args, reps):
    """Kernel vs plain version on the same inputs: errors and both times."""
    from dualsphysics_multilayer_tpu_torch.ops import forces as F
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    got = CF.interaction_forces_cuda(csp, opts, dom, cells, *args)
    want = F.interaction_forces_plain(csp, opts, dom, cells, *args)
    torch.cuda.synchronize()
    err = {}
    for k in ("ace", "ar"):
        g, w = getattr(got, k), getattr(want, k)
        check(bool(torch.isfinite(g).all()), f"kernel {k} is not finite")
        scale = float(w.abs().max()) + 1e-6
        bad = (g - w).abs() > RTOL * scale + RTOL * w.abs()
        check(not bool(bad.any()), f"kernel {k} disagrees with the plain "
              f"version at {int(bad.sum())} particles")
        err[k] = float((g - w).abs().max())
    gv, wv = float(got.viscdtmax), float(want.viscdtmax)
    check(abs(gv - wv) <= RTOL_VISC * abs(wv) + 1e-5,
          f"kernel viscdtmax {gv} != plain {wv}")
    err["viscdtmax"] = abs(gv - wv)
    ms = cuda_ms(lambda: CF.interaction_forces_cuda(csp, opts, dom, cells, *args),
                 reps)
    plain_ms = cuda_ms(lambda: F.interaction_forces_plain(csp, opts, dom, cells,
                                                          *args), reps)
    return err, ms, plain_ms


def perturbed_state(case, device, seed=0):
    """The case's initial state with a seeded random fluid velocity and a
    1% density jitter, so viscosity and diffusion terms are non-zero."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    st = case.state
    rng = np.random.default_rng(seed)
    fluid = td.is_fluid(st.code)
    dv = torch.tensor(rng.normal(0.0, 0.5, (st.n, 3)), dtype=torch.float32,
                      device=device)
    drho = torch.tensor(rng.uniform(-10.0, 10.0, st.n), dtype=torch.float32,
                        device=device)
    return (st.pos, torch.where(fluid[:, None], st.vel + dv, st.vel),
            st.rho + torch.where(fluid, drho, 0.0), st.code)


def flowing_state(case, device, seed=0):
    """The case's initial state with its fluid moving at 1 m/s along x
    plus a seeded 0.05 m/s jitter: fast enough for the skin contract to
    re-divide every few steps, gentle enough to keep the density near
    rho0."""
    from dataclasses import replace
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    st = case.state
    rng = np.random.default_rng(seed)
    vel = torch.tensor(rng.normal(0.0, 0.05, (st.n, 3)), dtype=torch.float32,
                       device=device)
    vel[:, 0] += 1.0
    return replace(st, vel=torch.where(td.is_fluid(st.code)[:, None], vel,
                                       st.vel))


def main():
    check(torch.cuda.is_available(), "no CUDA device: the port's smoke run "
          "needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import make_carry, make_step
    from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
    from dualsphysics_multilayer_tpu_torch.ops.cuda import build
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say("device", f"{kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.cuda_library()
    say("build", f"cellforce.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)

    # 3. kernel vs plain at ~50k particles
    case = cases.dambreak3d(dp=(0.11 / 5e4) ** (1 / 3), obstacle=True,
                            device=device)
    pos, vel, rho, code = perturbed_state(case, device)
    cells, code = cd.divide_cells(case.dom, pos, code)
    o = cells.order
    args = (pos[o], vel[o], rho[o], code[o])
    err, ms, plain_ms = compare(case.csp, opts, case.dom, cells, args, reps=7)
    say("kernel-vs-plain", f"{case.np_total} particles: max|d ace| "
        f"{err['ace']:.3e}, max|d ar| {err['ar']:.3e}, |d viscdtmax| "
        f"{err['viscdtmax']:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(median of 7, CUDA events; {smi})")

    # 4. main path at bench.py's default size
    case = cases.dambreak3d(dp=(0.11 / 300000) ** (1 / 3), obstacle=True,
                            device=device)
    n = case.np_total
    step = make_step(case.csp, opts, case.dom)
    carry = make_carry(flowing_state(case, device), case.csp, opts, case.dom)
    nrebuild0 = carry.nrebuild
    nwarm, nsteps = 5, 50
    CF.launches = 0
    times = []
    for k in range(nwarm + nsteps):
        t0 = time.perf_counter()
        carry = step(carry)
        torch.cuda.synchronize()
        if k >= nwarm:
            times.append(time.perf_counter() - t0)
    launches = CF.launches
    check(launches == 2 * (nwarm + nsteps),
          f"{launches} kernel launches in {nwarm + nsteps} steps, expected 2 per step")
    check(carry.nstep == nwarm + nsteps, f"nstep {carry.nstep}")
    check(carry.nrebuild > nrebuild0, f"no rebuild inside the steps "
          f"(nrebuild {carry.nrebuild})")
    check(carry.overflow == 0, f"overflow {carry.overflow}")
    st = carry.st
    for k in ("pos", "vel", "rho", "pose"):
        check(bool(torch.isfinite(getattr(st, k)).all()), f"state {k} not finite")
    check(bool(torch.isfinite(carry.dt_pre)) and float(carry.dt_pre) > 0,
          f"dt_pre {float(carry.dt_pre)}")
    fluid = td.is_fluid(st.code) & td.is_active(st.code)
    rmin, rmax = float(st.rho[fluid].min()), float(st.rho[fluid].max())
    check(0.9 * case.csp.rhopzero <= rmin and rmax <= 1.1 * case.csp.rhopzero,
          f"fluid density out of +-10% of rho0: [{rmin}, {rmax}]")
    p50 = statistics.median(times)
    say("main-path", f"{n} particles, {nsteps} steps after {nwarm} warm-up: "
        f"p50 step {p50 * 1e3:.3f} ms, {n / p50:.1f} particle-steps/s; "
        f"{launches} kernel launches, {carry.nrebuild - nrebuild0} rebuilds "
        f"inside the steps, overflow "
        f"{carry.overflow}, t {carry.t_host:.6f} s, fluid rho [{rmin:.2f}, "
        f"{rmax:.2f}] ({smi})")

    # kernel vs plain on the final main-path state
    err, ms, plain_ms = compare(case.csp, opts, case.dom, carry.cells,
                                (st.pos, st.vel, st.rho, st.code), reps=5)
    say("kernel-vs-plain", f"main-path state, {n} particles: max|d ace| "
        f"{err['ace']:.3e}, max|d ar| {err['ar']:.3e}; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (median of 5, CUDA events; {smi})")

    print(json.dumps({"kernels": [{
        "name": "cellforce", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": err["ace"],
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
