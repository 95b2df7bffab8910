"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing the final result line:

1. device: the CUDA device, and ``nvidia-smi``'s name and power limit;
2. build: nvcc builds the hand-written kernels from ``csrc/``, one process
   per library (``cellforce.cu``, ``nnforce.cu``, and the probes'
   ``probe_fma.cu`` with ``probe_gather.cu``), started together;
3. cellforce vs plain: one interaction of the 3D dam break (obstacle on)
   at about 50k particles through the CUDA kernel and through its plain
   torch version on the card, compared by the rule of tests/test_forces.py
   (rtol 2e-3 on ace and ar with a floor of 2e-3 of the largest value,
   1e-3 on viscdtmax), both timed with CUDA events (median of 7);
4. dam-break main path: the same case at bench.py's default size
   (BENCH_NP=300000, 267,469 particles) through ``make_carry``/
   ``make_step``, its fluid moving at 1 m/s along x with a seeded 0.05 m/s
   jitter so that the skin contract re-divides the state within the run:
   5 warm-up and 50 timed steps, which must launch cellforce exactly twice
   per step, rebuild at least once inside the steps, and keep the state
   finite and the fluid density within 10% of rho0; then the kernel
   against its plain version once more on the final state;
5. NN kernels vs plain: the 2D wet dam break (``wet_dambreak_nn``) at
   bench.py's nnmud size (BENCH_NP=60000: dp 3.21 mm, 37,143 particles) in
   a seeded perturbed state (0.5 m/s velocity jitter, 1% density jitter):
   nnforce_p1, nnforce_p3 and nnforce_fda each against its plain pass on
   the same inputs, timed with CUDA events (median of 7), two launches of
   each into separate zeroed buffers giving the same sha256 per output, the
   same for the three at a third of the dp (330,781 particles), then at
   37,143 particles the whole
   interaction for SPH Morris, SPH ConsEq, SPH artificial, FDA Morris and
   FDA ConsEq (all Fourtakas), by the same rule (rtol 2e-3 on ace, ar,
   visco_eta and pass 1's gradvel; 1e-3 on viscdtmax and viscetadtmax);
6. NN main path: the same case, SPH Morris with Fourtakas (bench.py's nnmud
   options), its fluid at 1 m/s along x (seeded jitter), through
   ``make_carry``/``make_nn_step``: 5 warm-up and 50 timed steps, which must
   launch nnforce_p1 and nnforce_p3 exactly twice per step each, rebuild at
   least once inside the steps, keep the state finite, each phase's fluid
   density within 10% of its rho0, and dt_pre > 0;
7. NN FDA path: the same with FDA Morris (the velocity gradient of the
   case's XML), 5 + 20 steps, nnforce_fda twice per step;
8. NN step breakdown: 10 more SPH Morris steps traced with
   ``torch.profiler`` (CUDA activity only): device busy time (the union of
   the traced device intervals) and idle share of the host-clock window,
   device operations per step, and the NN kernels' device time;
9. variant kernels vs plain: the 3D dam break of phase 3 (about 50k
   particles, seeded velocity, density and SPS stress) through the other
   instances of ``cellforce.cu`` against their plain versions, timed alike:
   cubic, cubic with shifting, Wendland with shifting (kernel 1's shifting
   instance), laminar+SPS with Wendland, with cubic, and with shifting
   (rtol 2e-3 on ace, ar, the SPS velocity gradient and the shifting sums,
   4e-3 with the cubic spline, the shifting flags exact);
10. laminar+SPS path: the dam break of phase 4 with the reference's
    ``-viscolamsps:1e-6 -shifting:2`` (laminar+SPS viscosity 1e-6 with the
    Smagorinsky/Blin constants, NO_FIXED shifting, Wendland, Fourtakas),
    flowing as in phase 4: 5 warm-up and 50 timed steps, which must launch
    cellforce_lamsps exactly twice per step and no other single-phase
    kernel, rebuild at least once inside the steps, keep the state and the
    SPS stress finite and the fluid density within 10% of rho0; then the
    layout of the last divide must hold every pair a fresh divide finds, at
    the positions of the next predictor and one dt beyond (the skin contract
    under shifting), and the kernel must match its plain version on the
    final state;
11. cubic path: the same with ``-cubic`` (the cubic spline with the tensile
    correction, artificial viscosity 0.1, Fourtakas, no shifting) and
    cellforce_cubic;
12. floating and mDBC instances vs plain: the 2D floating box
    (``floatingbox2d``) at bench.py's floatingbox size (BENCH_NP=60000: dp
    4.082 mm, 62,033 particles, 2,401 of them in the box) in a seeded
    perturbed state, through cellforce with the box's particle mass
    (Fourtakas, mDBC walls), cellforce with Molteni under mDBC walls, and
    cellforce_cubic and cellforce_lamsps with the box's mass, each against
    its plain version and timed alike, with its bound and its instance's
    ptxas registers (``cellforce_kernel<KER,VISC,SHIFT,FT>``, FT = 1 with
    floating bodies);
13. floating box path: the same case with bench.py's floatingbox options
    (Fourtakas, ``with_floating``, mDBC walls with NO_SLIP; the case has no
    normals, so no mDBC pre-pass, as in the JAX package), its fluid flowing
    as in phase 4: 5 warm-up and 50 timed steps, which must launch
    cellforce exactly twice per step, rebuild at least once inside the
    steps, keep the state and the body state finite, the fluid density
    within 10% of rho0 and the box rigid (the distance between its first
    and last particle within 0.2 dp of its start); then 10 steps from one
    saved carry, run twice, must give bit-equal states and bodies;
14. mDBC dam break path: ``dambreak2d(mdbc=True)`` at dp 5.774 mm (bench.py's
    2D size for BENCH_NP=60000: 61,589 particles, 1,731 walls with normals),
    Fourtakas, VEL0 (the CLI's ``-mdbc``), flowing as in phase 4: 5 + 50
    steps, which must launch cellforce and run the mDBC pre-pass exactly
    twice per step each, rebuild at least once, keep the state finite and
    the fluid and wall density within 10% of rho0; then the pre-pass alone,
    timed with CUDA events (torch ops: no TPU kernel to port);
15. NN variant instances vs plain: phase 5's case and state through every
    other instance of ``nnforce.cu`` (``nnforce_p1_kernel<KER,SHIFT>``,
    ``nnforce_fda_kernel<KER,SHIFT>``, ``nnforce_p3_kernel<KER,VISC>``;
    KER 1 cubic, 2 Wendland; SHIFT 1 with a shifting mode; VISC 0
    artificial, 1 Morris, 2 ConsEq): pass 1 and FDA (Morris) with the cubic
    spline, each shifting mode and the cubic spline with NO_BOUND, and pass
    3 in every kernel and viscous form, each against its plain pass and timed alike, with its bound and ptxas
    registers, two launches of each bit-equal as in phase 5; then the whole
    interaction for each of those five variants in phase 5's five
    configurations (rtol 2e-3, 4e-3 with the cubic spline, on ace, ar,
    visco_eta, tau, gradvel and the shifting sums; 1e-3 on viscdtmax and
    viscetadtmax; the shifting flags exact);
16. NN shifting path: phase 6 with ``-shifting:2`` (NO_FIXED): 5 + 50
    steps, nnforce_p1 and nnforce_p3 twice per step each, the checks of
    phase 6; then the layout of the last divide must hold every pair a
    fresh divide finds, and the kernels must match their plain versions on
    the final state;
17. NN cubic path: FDA Morris with ``-cubic -shifting:2``: 5 + 20 steps,
    nnforce_fda twice per step, the same checks;
18. probes: the two hardware probes of ``tools/probes.py`` (FMA issue,
    ``csrc/probe_fma.cu``; misaligned window loads, ``csrc/probe_gather.cu``)
    against their plain versions: the FMA probe at rep 2 (rtol 1e-5, 1e-4
    for rsqrt and the approximate reciprocal, the card's MUFU forms), the
    window-load probe in its four modes at 37 and 45 window loads (rtol
    1e-5) and, bit for bit, at the timed 512 loads x 64 windows against the
    plain loop with the kernel's fused multiply-adds (unfused, the
    recurrence's rounding differences grow to O(1) there); then their full tables on the card: each operation at 1, 2, 4 and 8
    chains (ms, steps per SM per clock at the SM's maximum clock, share of
    the SM's 128 f32 lanes) and the window loads aligned and not, from
    global and from shared memory (ns per window load), with the window
    loads' bound: device-memory bytes, the loads' bytes through the SMs'
    load paths (128 bytes per SM per clock at the maximum clock) and the
    f32 operations;
19. Verlet path: the dam break of phase 4 built with its M1 state
    (bench.py's ``BENCH_STEP=verlet``: Verlet steps, an Euler re-anchoring
    step every 40), flowing as in phase 4 with the M1 velocity the same: 5
    warm-up and 50 timed steps, which must launch cellforce exactly once
    per step and no other kernel, rebuild at least once, keep the state and
    the M1 state finite and the fluid density within 10% of rho0; then the
    layout check of phase 10, the kernel against its plain version on the
    final state, and 10 more steps traced as in phase 8;
20. wave-flume path: bench.py's ``waveflume`` (``waveflume2d`` at
    BENCH_NP=60000: dp 6.325 mm, 61,467 particles: 59,724 fluid, 1,743
    walls, 636 of them the piston; Fourtakas; the piston's sinusoid, 0.8 Hz
    and 0.1 m) from still water: 5 + 50 steps, cellforce exactly twice per
    step and no other kernel, at least one rebuild, the density within 10%;
    the piston's particles moved by A sin(w t) within 1e-3 dp in float64,
    all by the same amount within 1e-3 dp; the layout check, the kernel
    against its plain version with the moving walls in the state, and a
    traced breakdown;
21. full flume: the same flume with ``wavegen.piston_waves(order=2)`` (H
    0.1 m, T 1.25 s), AWAS and a damping beach over its last metre, its
    SWL, velocity and MaxZ gauges on their own sub-ticks (a fifth of the
    run) through ``Simulation.run``: 5 + about 50 steps, cellforce twice
    per step, every reading finite, the SWL within the depth plus or minus
    the stroke, the AWAS correction finite; then 5 + 20 steps with a
    multi-layer piston on mk 10, a regular-wave relaxation zone and an
    external acceleration of the fluid.

Each kernel is timed twice: alone (``ms``: CUDA events around 20
back-to-back launches of the C launcher on prepared inputs, per launch,
median of 5) and with its wrapper (channel packing, checks, allocation;
median of 7).  The last two lines are a JSON record of the kernels (with
each kernel's bound: the larger of the bytes it must move over 3.35 TB/s
and the f32 operations of this run's in-support pairs over 67 TFLOP/s,
the H100 SXM peaks; for the FMA probe its steps over the SM's 128 f32
lanes at the SM's maximum clock; for the window-load probe the largest of
its device-memory bytes, its loads' bytes through the SMs' load paths and
its operations; the NN kernels' rows list their other instances under
``instances``) and the result line
``{"ok": true, "device": {...}}``.  Every launch count comes from its
path's run, counted from 0 just before it (the probes' from their
tables); cellforce's row adds ``path_launches``, its launches on the dam
break (phase 4), the Verlet path, the wave flume and the full flume.
Imports no JAX.
"""

import ctypes
import dataclasses
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

RTOL = 2e-3          # tests/test_forces.py assert_close: ace, ar, eta, gradvel
RTOL_CUBIC = 4e-3    # tests/test_forces.py:90, the cubic spline's rule
RTOL_SCALAR = 1e-3   # same rule: viscdtmax, viscetadtmax
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12       # H100 SXM f32 outside the tensor cores, FLOP/s
NN_DP = max((2.0 * 0.45 * 0.35 / 60000) ** 0.5 * 1.4, 0.0025)   # bench.py nnmud
DP_50K = (0.11 / 5e4) ** (1 / 3)        # bench.py's dp for BENCH_NP=50000
DP_BENCH = (0.11 / 300000) ** (1 / 3)   # BENCH_NP=300000: 267,469 particles
DP_FLOAT = (2.0 * 0.5 / 60000) ** 0.5    # bench.py floatingbox: 62,033 particles
DP_2D = (2.0 / 60000) ** 0.5              # 2D dam break: 61,589 particles
DP_FLUME = (6.0 * 0.4 / 60000) ** 0.5     # bench.py waveflume: 61,467 particles
LAMSPS_VISCO = 1e-6   # water's kinematic viscosity, -viscolamsps:1e-6
PKG = "dualsphysics_multilayer_tpu_torch/csrc/"
TPU = "dualsphysics_multilayer_tpu/ops/pallas/"
KERNELS = {   # name: (source, TPU kernel it replaces)
    "cellforce": (PKG + "cellforce.cu", TPU + "cellforce.py:1074"),
    "nnforce_p1": (PKG + "nnforce.cu", TPU + "nnforce.py:76"),
    "nnforce_p3": (PKG + "nnforce.cu", TPU + "nnforce.py:478"),
    "nnforce_fda": (PKG + "nnforce.cu", TPU + "nnforce.py:247"),
    "cellforce_cubic": (PKG + "cellforce.cu", TPU + "cellforce.py:672"),
    "cellforce_lamsps": (PKG + "cellforce.cu", TPU + "cellforce.py:427"),
    "probe_fma": (PKG + "probe_fma.cu", "vputime.py:19"),
    "probe_gather": (PKG + "probe_gather.cu", "probe_unaligned.py:24"),
}
# f32 operations per in-support pair of a fluid-side target, each add,
# multiply, divide, max, sqrt, exp and pow counted once, from the bodies in
# csrc/ (pairbody.cuh, nnbody.cuh); the data-dependent branches (viscosity
# of approaching pairs, diffusion of same-phase pairs, the wall trick) are
# left out, so the count is a lower bound on the work.  The variants add
# to cellforce's 50: the tensile correction 15 (cubic), the laminar
# operator, SPS stress divergence and velocity gradient 62 (laminar+SPS;
# the candidate's stress, fluid candidates only, left out) and the
# shifting sums 9.
OPS_PER_PAIR = {"cellforce": 50, "nnforce_p1": 80, "nnforce_p3": 40,
                "nnforce_fda": 124, "cellforce_cubic": 65,
                "cellforce_lamsps": 112}
OPS_SHIFT = 9
OPS_TENSILE = 15
# the NN variants of phases 15-17: (label, tkernel, shiftmode)
NN_VARIANTS = (("cubic", "CUBIC", "NONE"), ("no-bound", "WENDLAND", "NO_BOUND"),
               ("no-fixed", "WENDLAND", "NO_FIXED"), ("full", "WENDLAND", "FULL"),
               ("cubic+no-bound", "CUBIC", "NO_BOUND"))
NN_CONFIGS = (("LAMINAR_SPS", "SPH"), ("CONST_EQ", "SPH"), ("ARTIFICIAL", "SPH"),
              ("LAMINAR_SPS", "FDA"), ("CONST_EQ", "FDA"))


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


def launch_ms(launch, count=20, reps=5):
    """Median milliseconds of one launch: CUDA events around ``count``
    back-to-back calls of ``launch`` (a C launcher returning its CUDA
    error code), median over ``reps`` runs."""
    check(launch() == 0, "kernel launch failed")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def close(name, got, want, rtol=RTOL):
    """Max abs error of ``got`` against ``want``; raises beyond rtol with a
    floor of rtol times the largest value."""
    check(bool(torch.isfinite(got).all()), f"{name} is not finite")
    scale = float(want.abs().max()) + 1e-6
    bad = (got - want).abs() > rtol * scale + rtol * want.abs()
    check(not bool(bad.any()), f"{name} disagrees with the plain version at "
          f"{int(bad.sum())} entries")
    return float((got - want).abs().max())


def close_scalar(name, got, want, rtol=RTOL_SCALAR):
    g, w = float(got), float(want)
    check(abs(g - w) <= rtol * abs(w) + 1e-5, f"{name} {g} != plain {w}")
    return abs(g - w)


def pair_walk(csp, dom, cells, pos, code, inclusive=False):
    """(candidates walked, in-support pairs) of every target through the
    layout ``cells``, in slot order: what the pair kernels walk and sum
    (``inclusive``: pairs at exactly the kernel size count, as in the NN
    bodies)."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.ops import forces as F
    live = td.is_active(code) & (cells.cell < dom.ncells)
    cand = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    pairs = torch.zeros_like(cand)
    for t, j, valid in F.candidate_chunks(dom, cells, live, 1 << 22):
        dr = pos[t, None, :] - pos[j]
        rr2 = (dr * dr).sum(dim=-1)
        inside = rr2 <= csp.kernelsize2 if inclusive else rr2 < csp.kernelsize2
        cand[t] = valid.sum(dim=1)
        pairs[t] = (valid & (j != t[:, None]) & live[j]
                    & (rr2 >= td.ALMOSTZERO) & inside).sum(dim=1)
    return cand, pairs


def layout_keeps_pairs(csp, dom, carry, inclusive=False):
    """Raise unless the carry's layout holds every pair a fresh divide
    finds, at the positions of the next predictor and one dt beyond;
    returns the number of pairs at the first (``inclusive`` as in
    :func:`pair_walk`)."""
    from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
    check(not carry.rebuild, "the run ended on a rebuild flag")
    st = carry.st
    total = None
    for pos in (st.pos, st.pos + carry.dt_pre * st.vel):
        fresh, code = cd.divide_cells(dom, pos, st.code)
        o = fresh.order
        want = torch.empty_like(o)
        want[o] = pair_walk(csp, dom, fresh, pos[o], code[o], inclusive)[1]
        got = pair_walk(csp, dom, carry.cells, pos, st.code, inclusive)[1]
        lost = int((got != want).sum())
        check(lost == 0, f"{lost} targets lost pairs between rebuilds")
        total = total if total is not None else int(got.sum())
    return total


def pair_counts(csp, dom, cells, pos, code, inclusive):
    """(candidates walked, in-support pairs with a fluid-side target) of
    one interaction on these inputs."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    cand, pairs = pair_walk(csp, dom, cells, pos, code, inclusive)
    fluidside = td.code_type(code) >= td.TYPE_FLOATING
    return int(cand.sum()), int(pairs[fluidside].sum())


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time for the bytes and operations."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def perturbed_state(case, device, rho0, seed=0, sim2d=False):
    """The case's initial state with a seeded random fluid velocity (0.5
    m/s; none along y in 2D) and a density jitter of 1% of ``rho0`` (a
    tensor per particle), so viscosity and diffusion terms are non-zero."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    st = case.state
    rng = np.random.default_rng(seed)
    fluid = td.is_fluid(st.code)
    dv = torch.tensor(rng.normal(0.0, 0.5, (st.n, 3)), dtype=torch.float32,
                      device=device)
    if sim2d:
        dv[:, 1] = 0.0
    drho = torch.tensor(rng.uniform(-0.01, 0.01, st.n), dtype=torch.float32,
                        device=device) * rho0
    return (st.pos, torch.where(fluid[:, None], st.vel + dv, st.vel),
            st.rho + torch.where(fluid, drho, 0.0), st.code)


def flowing_state(case, device, seed=0, jitter=0.05, sim2d=False):
    """The case's initial state with its fluid moving at 1 m/s along x
    plus a seeded jitter: fast enough for the skin contract to re-divide
    every few steps, gentle enough to keep the density near rho0."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    st = case.state
    rng = np.random.default_rng(seed)
    vel = torch.tensor(rng.normal(0.0, jitter, (st.n, 3)), dtype=torch.float32,
                       device=device)
    vel[:, 0] += 1.0
    if sim2d:
        vel[:, 1] = 0.0
    return dataclasses.replace(st, vel=torch.where(
        td.is_fluid(st.code)[:, None], vel, st.vel))


def sorted_args(dom, pos, vel, rho, code):
    from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
    cells, code = cd.divide_cells(dom, pos, code)
    o = cells.order
    return cells, (pos[o], vel[o], rho[o], code[o])


def _counters():
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
    from dualsphysics_multilayer_tpu_torch.tools import probes as PR
    return CF.launches, NF.launches, PR.launches


def reset_counts():
    for c in _counters():
        c.update(dict.fromkeys(c, 0))


def counts():
    return {k: v for c in _counters() for k, v in c.items()}


def run_steps(step, carry, nwarm, nsteps):
    """Run nwarm + nsteps steps; returns (carry, host seconds of the timed
    steps, the launch counts of the whole run)."""
    reset_counts()
    times = []
    for k in range(nwarm + nsteps):
        t0 = time.perf_counter()
        carry = step(carry)
        torch.cuda.synchronize()
        if k >= nwarm:
            times.append(time.perf_counter() - t0)
    return carry, times, counts()


def check_state(carry, nsteps, nrebuild0):
    """Raise unless the run made ``nsteps`` steps, re-divided after the
    ``nrebuild0``-th divide (None: no rebuild required) and kept its state
    finite."""
    check(carry.nstep == nsteps, f"nstep {carry.nstep}")
    check(nrebuild0 is None or carry.nrebuild > nrebuild0,
          f"no rebuild inside the steps (nrebuild {carry.nrebuild})")
    check(carry.overflow == 0, f"overflow {carry.overflow}")
    st = carry.st
    for k in ("pos", "vel", "rho", "pose"):
        check(bool(torch.isfinite(getattr(st, k)).all()), f"state {k} not finite")
    check(bool(torch.isfinite(carry.dt_pre)) and float(carry.dt_pre) > 0,
          f"dt_pre {float(carry.dt_pre)}")


def fluid_rho_range(st, select, rho0):
    """[min, max] of the active fluid density where ``select``; raises
    outside +-10% of rho0."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    fluid = td.is_fluid(st.code) & td.is_active(st.code) & select
    rmin, rmax = float(st.rho[fluid].min()), float(st.rho[fluid].max())
    check(0.9 * rho0 <= rmin and rmax <= 1.1 * rho0,
          f"fluid density out of +-10% of {rho0}: [{rmin}, {rmax}]")
    return rmin, rmax


def bare_launcher(library, function, params, tensors):
    """A call of the C launcher ``function`` of ``library`` on ``params``
    and ``tensors`` (held by the closure), on torch's current stream: the
    kernel without its wrapper."""
    from dualsphysics_multilayer_tpu_torch.ops.cuda import build
    fn = getattr(build.cuda_library(library), function)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    stream = torch.cuda.current_stream().cuda_stream
    return lambda held=tensors: fn(ctypes.byref(params), *ptrs, stream)


def nn_launch_ms(name, params, rows, outs, ins=()):
    """NN kernel ``name`` alone (:func:`launch_ms`) on ``rows`` and ``ins``
    (pass 3's eta and tau) into ``outs``, after two launches into zeroed
    copies of ``outs``, which must give the same sha256 per output
    (deterministic sums; pass 3 adds into its ace).  Returns (ms, a note for
    the log)."""
    args = rows + list(ins)
    hashes = []
    for _ in range(2):
        bufs = [None if o is None else torch.zeros_like(o) for o in outs]
        check(bare_launcher("nnforce", f"dsph_{name}", params,
                            args + bufs)() == 0, f"{name} launch failed")
        torch.cuda.synchronize()
        hashes.append([hashlib.sha256(o.cpu().numpy().tobytes()).digest()
                       for o in bufs if o is not None])
    check(hashes[0] == hashes[1],
          f"{name}: two launches on the same inputs differ")
    return launch_ms(bare_launcher("nnforce", f"dsph_{name}", params,
                                   args + outs)), "; two launches bit-equal"


def compare_cellforce(csp, opts, dom, cells, args, reps, spstau=None,
                      ftomassp=None):
    """The cellforce kernel of this configuration vs its plain version on
    the same inputs: errors and the times of the kernel alone, with its
    wrapper, and of the plain version."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.ops import forces as F
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    name = CF.kernel_name(csp, opts)
    rtol = RTOL_CUBIC if csp.tkernel == td.TpKernel.CUBIC else RTOL
    run = (csp, opts, dom, cells, *args, spstau, ftomassp)
    got = CF.interaction_forces_cuda(*run)
    want = F.interaction_forces_plain(*run)
    torch.cuda.synchronize()
    err = {k: close(f"{name} {k}", getattr(got, k), getattr(want, k), rtol)
           for k in ("ace", "ar", "spsgradvel", "shiftposfs")
           if getattr(want, k) is not None}
    err["viscdtmax"] = close_scalar(f"{name} viscdtmax", got.viscdtmax,
                                    want.viscdtmax)
    if want.shift_blocked is not None:
        check(torch.equal(got.shift_blocked, want.shift_blocked),
              f"{name} shift_blocked disagrees with the plain version")
    n = args[0].shape[0]
    pospress, velrho, kind = CF.channels(csp, *args)
    outs = [None if x is None else torch.empty_like(x) for x in (
        got.ace, got.ar, got.ar, got.spsgradvel, got.shiftposfs,
        got.shift_blocked)]
    ftmass = CF.floating_mass(csp, opts, args[3], ftomassp)
    ms = launch_ms(bare_launcher(
        "cellforce", f"dsph_{name}", CF.make_params(csp, opts, dom, n),
        [pospress, velrho, kind, cells.cell, cells.begin, spstau, ftmass]
        + outs))
    wrapped_ms = cuda_ms(lambda: CF.interaction_forces_cuda(*run), reps)
    plain_ms = cuda_ms(lambda: F.interaction_forces_plain(*run), reps)
    return err, ms, wrapped_ms, plain_ms


def cellforce_bytes(n, ncells, opts):
    """Bytes a cellforce kernel must move: pospress, velrho, kind, cell and
    begin in, ace, ar, viscdt out, plus the SPS stress in and the gradient
    out (laminar+SPS) and the shifting sums and flags out."""
    from dualsphysics_multilayer_tpu_torch import TpShifting, TpVisco
    per = 16 + 16 + 4 + 4 + 12 + 4 + 4
    if opts.tvisco == TpVisco.LAMINAR_SPS:
        per += 24 + 24
    if opts.shiftmode != TpShifting.NONE:
        per += 16 + 1
    return n * per + (ncells + 1) * 4


def ops_per_pair(name, opts):
    from dualsphysics_multilayer_tpu_torch import TpShifting
    return OPS_PER_PAIR[name] + (OPS_SHIFT if opts.shiftmode != TpShifting.NONE
                                 else 0)


def lamsps_csp(dp, visco=LAMSPS_VISCO):
    """The dam break's constants under laminar+SPS (make_ctesph with
    tvisco=LAMINAR_SPS: the Smagorinsky/Blin constants), as an XML case
    builds them."""
    from dualsphysics_multilayer_tpu_torch import TpVisco, make_ctesph
    return make_ctesph(simulate2d=False, dp=dp, hswl=0.3, coefh=1.0,
                       visco=visco, coefsound=20.0, tvisco=TpVisco.LAMINAR_SPS)


def variant_kernels_vs_plain(device, smi):
    """Phase 9: the other cellforce instances against their plain
    versions at about 50k particles."""
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpDensity,
                                                   TpKernel, TpShifting, TpVisco)
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    case = cases.dambreak3d(dp=DP_50K, obstacle=True, device=device)
    pos, vel, rho, code = perturbed_state(case, device, case.csp.rhopzero,
                                          seed=1)
    cells, args = sorted_args(case.dom, pos, vel, rho, code)
    rng = np.random.default_rng(2)
    tau = torch.where(td.is_fluid(args[3])[:, None], torch.tensor(
        rng.normal(0.0, 1e-3, (pos.shape[0], 6)), dtype=torch.float32,
        device=device), 0.0).contiguous()
    fourtakas, nofixed = TpDensity.FOURTAKAS, TpShifting.NO_FIXED
    cubic = case.csp.replace(tkernel=TpKernel.CUBIC)
    # a viscosity 100x water's, so the laminar term clears the comparison's
    # floor of 2e-3 of the largest acceleration
    lam = lamsps_csp(DP_50K, visco=1e-4)
    lamsps = dict(tvisco=TpVisco.LAMINAR_SPS, tdensity=fourtakas)
    for label, csp, opts in (
            ("cubic", cubic, SolverOpts(tdensity=fourtakas)),
            ("cubic+shift", cubic, SolverOpts(tdensity=fourtakas,
                                              shiftmode=nofixed)),
            ("wendland+shift", case.csp, SolverOpts(tdensity=fourtakas,
                                                    shiftmode=nofixed)),
            ("lamsps-wendland", lam, SolverOpts(**lamsps)),
            ("lamsps-cubic", lam.replace(tkernel=TpKernel.CUBIC),
             SolverOpts(**lamsps)),
            ("lamsps+shift", lam, SolverOpts(**lamsps, shiftmode=nofixed))):
        err, ms, wrapped_ms, plain_ms = compare_cellforce(
            csp, opts, case.dom, cells, args, reps=5,
            spstau=tau if opts.tvisco == TpVisco.LAMINAR_SPS else None)
        say("variant-vs-plain", f"{label}, {case.np_total} particles: max|d| "
            + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
            + f"; kernel alone {ms:.3f} ms, with its wrapper {wrapped_ms:.3f} "
            f"ms, plain {plain_ms:.3f} ms (CUDA events; {smi})")


def variant_path(label, csp, opts, case, device, smi):
    """Phases 10 and 11: 5 + 50 steps of the dam break from a flowing start
    through its kernel; then the layout and the kernel checks.  Returns the
    kernel's record."""
    from dualsphysics_multilayer_tpu_torch.models.wcsph import make_carry, make_step
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    name = CF.kernel_name(csp, opts)
    n, nwarm, nsteps = case.np_total, 5, 50
    step = make_step(csp, opts, case.dom)
    carry = make_carry(flowing_state(case, device), csp, opts, case.dom)
    nrebuild0 = carry.nrebuild
    carry, times, launched = run_steps(step, carry, nwarm, nsteps)
    single = {k: launched[k] for k in CF.launches}
    check(single == {**dict.fromkeys(CF.launches, 0),
                     name: 2 * (nwarm + nsteps)},
          f"{launched} kernel launches in {nwarm + nsteps} steps, expected "
          f"{name} 2 per step and no other single-phase kernel")
    check_state(carry, nwarm + nsteps, nrebuild0)
    st = carry.st
    if st.spstau is not None:
        check(bool(torch.isfinite(st.spstau).all()), "state spstau not finite")
    rmin, rmax = fluid_rho_range(st, True, csp.rhopzero)
    p50 = statistics.median(times)
    say(label, f"{n} particles, {nsteps} steps after {nwarm} warm-up: p50 step "
        f"{p50 * 1e3:.3f} ms, {n / p50:.1f} particle-steps/s; {launched[name]} "
        f"{name} launches, {carry.nrebuild - nrebuild0} rebuilds inside the "
        f"steps, t {carry.t_host:.6f} s, dt_pre {float(carry.dt_pre):.4g} s, "
        f"fluid rho [{rmin:.2f}, {rmax:.2f}]"
        + ("" if st.spstau is None else
           f", max|spstau| {float(st.spstau.abs().max()):.4g}") + f" ({smi})")
    # the next steps until the layout is current, so the check reads the
    # layout the next interaction would use
    extra = 0
    while carry.rebuild and extra < 5:
        carry, extra = step(carry), extra + 1
    npairs = layout_keeps_pairs(csp, case.dom, carry)
    say(label, f"after {extra} more steps: the layout of the last divide holds "
        f"all {npairs} pairs a fresh divide finds, at the next predictor's "
        f"positions and one dt beyond")
    st = carry.st
    err, ms, wrapped_ms, plain_ms = compare_cellforce(
        csp, opts, case.dom, carry.cells, (st.pos, st.vel, st.rho, st.code),
        reps=5, spstau=st.spstau)
    cand, pairs = pair_counts(csp, case.dom, carry.cells, st.pos, st.code,
                              inclusive=False)
    b = bound(cellforce_bytes(n, case.dom.ncells, opts),
              pairs * ops_per_pair(name, opts))
    say("kernel-vs-plain", f"{label} state, {n} particles, {name}: max|d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f"; kernel alone {ms:.3f} ms, with its wrapper {wrapped_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (CUDA events); {cand} candidates, {pairs} "
        f"in-support pairs with a fluid-side target; bound {b[0] * 1e3:.2f} us "
        f"by {b[1]} ({smi})")
    return name, dict(launches=launched[name], max_abs_err=err["ace"], ms=ms,
                      plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1])


def floating_kernels_vs_plain(device, registers, smi):
    """Phase 12: the cellforce instances with the floating box's particle
    mass and the mDBC diffusion rule against their plain versions at
    bench.py's floatingbox size."""
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpBoundary,
                                                   TpDensity, TpKernel,
                                                   TpVisco, make_ctesph)
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.features import floating as FT
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    case = cases.floatingbox2d(dp=DP_FLOAT, device=device)
    csp = case.csp
    pos, vel, rho, code = perturbed_state(case, device, csp.rhopzero, seed=3,
                                          sim2d=True)
    cells, args = sorted_args(case.dom, pos, vel, rho, code)
    ftomassp = FT.body_tables(case.meta["ftcfg"], tuple(csp.gravity),
                              device).massp
    rng = np.random.default_rng(4)
    tau = torch.where(td.is_fluid(args[3])[:, None], torch.tensor(
        rng.normal(0.0, 1e-3, (pos.shape[0], 6)), dtype=torch.float32,
        device=device), 0.0).contiguous()
    # laminar+SPS at 100x water's viscosity, as in phase 9
    lam = make_ctesph(simulate2d=True, dp=DP_FLOAT, hswl=0.5, coefh=1.0,
                      visco=1e-4, coefsound=20.0, tvisco=TpVisco.LAMINAR_SPS)
    walls = dict(tboundary=TpBoundary.MDBC, with_floating=True)
    fourtakas = TpDensity.FOURTAKAS
    nft = int(td.is_floating(code).sum())
    n = case.np_total
    cand, pairs = pair_counts(csp, case.dom, cells, args[0], args[3],
                              inclusive=False)
    for label, c, opts, instance in (
            ("floating", csp, SolverOpts(tdensity=fourtakas, **walls), "<2,1,0,1>"),
            ("floating+molteni-mdbc", csp,
             SolverOpts(tdensity=TpDensity.MOLTENI, **walls), "<2,1,0,1>"),
            ("floating-cubic", csp.replace(tkernel=TpKernel.CUBIC),
             SolverOpts(tdensity=fourtakas, **walls), "<1,1,0,1>"),
            ("floating-lamsps", lam,
             SolverOpts(tvisco=TpVisco.LAMINAR_SPS, tdensity=fourtakas,
                        **walls), "<2,2,0,1>")):
        err, ms, wrapped_ms, plain_ms = compare_cellforce(
            c, opts, case.dom, cells, args, reps=5,
            spstau=tau if opts.tvisco == TpVisco.LAMINAR_SPS else None,
            ftomassp=ftomassp)
        name = CF.kernel_name(c, opts)
        # the inputs of the plain instance plus the slots' masses
        b = bound(cellforce_bytes(n, case.dom.ncells, opts) + 4 * n,
                  pairs * ops_per_pair(name, opts))
        say("floating-vs-plain", f"{label}, {n} particles ({nft} floating, "
            f"particle mass {float(ftomassp[0]):.6g} kg): max|d| "
            + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
            + f"; kernel alone {ms:.3f} ms, with its wrapper {wrapped_ms:.3f} "
            f"ms, plain {plain_ms:.3f} ms (CUDA events); {cand} candidates, "
            f"{pairs} in-support pairs with a fluid-side target; bound "
            f"{b[0] * 1e3:.2f} us by {b[1]}; cellforce_kernel{instance}: "
            f"{registers.get('cellforce_kernel' + instance, '?')} ({smi})")


def floating_path(device, smi):
    """Phase 13: 5 + 50 steps of the floating box with bench.py's
    floatingbox options, then 10 steps from one saved carry, twice."""
    from dualsphysics_multilayer_tpu_torch import (Features, SolverOpts,
                                                   TpBoundary, TpDensity,
                                                   TpSlipMode)
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import make_carry, make_step
    case = cases.floatingbox2d(dp=DP_FLOAT, device=device)
    csp, dom, n = case.csp, case.dom, case.np_total
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True,
                      tboundary=TpBoundary.MDBC, slipmode=TpSlipMode.NO_SLIP)
    step = make_step(csp, opts, dom, Features(floating=case.meta["ftcfg"]))
    st0 = flowing_state(case, device, sim2d=True)
    box = torch.nonzero(td.is_floating(st0.code)).squeeze(1)
    ends = st0.idp[box[[0, -1]]]
    span0 = float((st0.pos[box[0]] - st0.pos[box[-1]]).norm())
    carry = make_carry(st0, csp, opts, dom)
    nrebuild0 = carry.nrebuild
    nwarm, nsteps = 5, 50
    carry, times, launched = run_steps(step, carry, nwarm, nsteps)
    check(launched == {**dict.fromkeys(launched, 0),
                       "cellforce": 2 * (nwarm + nsteps)},
          f"{launched} kernel launches in {nwarm + nsteps} steps, expected "
          f"cellforce 2 per step and no other kernel")
    check_state(carry, nwarm + nsteps, nrebuild0)
    st, ft = carry.st, carry.st.ft
    for k in ("center", "fvel", "fomega", "angles"):
        check(bool(torch.isfinite(getattr(ft, k)).all()), f"body {k} not finite")
    rmin, rmax = fluid_rho_range(st, True, csp.rhopzero)
    slot = torch.empty_like(st.idp)
    slot[st.idp] = torch.arange(st.n, device=device)
    a, b = st.pos[slot[ends]]
    span = float((a - b).norm())
    check(abs(span - span0) < 0.2 * csp.dp,
          f"the box deformed: span {span} m, at the start {span0} m")
    p50 = statistics.median(times)
    say("floating-path", f"{n} particles ({box.numel()} floating), {nsteps} "
        f"steps after {nwarm} warm-up: p50 step {p50 * 1e3:.3f} ms, "
        f"{n / p50:.1f} particle-steps/s; {launched['cellforce']} cellforce "
        f"launches, {carry.nrebuild - nrebuild0} rebuilds inside the steps, t "
        f"{carry.t_host:.6f} s, fluid rho [{rmin:.2f}, {rmax:.2f}]; body center "
        f"{ft.center[0].tolist()}, fvel {ft.fvel[0].tolist()}, fomega "
        f"{ft.fomega[0].tolist()}; box span {span:.6f} m (start {span0:.6f}) "
        f"({smi})")
    runs = []
    for _ in range(2):
        c = carry
        for _ in range(10):
            c = step(c)
        runs.append(c.st)
    fields = ("pos", "vel", "rho", "code", "idp", "pose")
    same = all(torch.equal(getattr(runs[0], k), getattr(runs[1], k))
               for k in fields) and all(
        torch.equal(getattr(runs[0].ft, k), getattr(runs[1].ft, k))
        for k in ("center", "fvel", "fomega", "angles"))
    check(same, "10 steps from one carry, run twice, differ")
    say("floating-path", "10 steps from one saved carry, run twice: states "
        "and bodies bit-equal")


def mdbc_path(device, smi):
    """Phase 14: 5 + 50 steps of the 2D dam break with mDBC walls (VEL0),
    the pre-pass counted; then the pre-pass alone."""
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpBoundary,
                                                   TpDensity, TpSlipMode)
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import make_carry, make_step
    from dualsphysics_multilayer_tpu_torch.ops import mdbc as MD
    case = cases.dambreak2d(dp=DP_2D, mdbc=True, device=device)
    csp, dom, n = case.csp, case.dom, case.np_total
    nwalls = int(((case.state.boundnormal ** 2).sum(dim=1) > 0).sum())
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, tboundary=TpBoundary.MDBC,
                      slipmode=TpSlipMode.VEL0)
    step = make_step(csp, opts, dom)
    carry = make_carry(flowing_state(case, device, sim2d=True), csp, opts, dom)
    nrebuild0 = carry.nrebuild
    prepasses = [0]
    correction = MD.mdbc_correction

    def counted(*args, **kw):
        prepasses[0] += 1
        return correction(*args, **kw)

    nwarm, nsteps = 5, 50
    MD.mdbc_correction = counted
    try:
        carry, times, launched = run_steps(step, carry, nwarm, nsteps)
    finally:
        MD.mdbc_correction = correction
    check(launched == {**dict.fromkeys(launched, 0),
                       "cellforce": 2 * (nwarm + nsteps)}
          and prepasses[0] == 2 * (nwarm + nsteps),
          f"{launched} kernel launches and {prepasses[0]} mDBC pre-passes in "
          f"{nwarm + nsteps} steps, expected 2 per step each")
    check_state(carry, nwarm + nsteps, nrebuild0)
    st = carry.st
    rmin, rmax = fluid_rho_range(st, True, csp.rhopzero)
    wall = td.is_bound(st.code)
    wmin, wmax = float(st.rho[wall].min()), float(st.rho[wall].max())
    check(0.9 * csp.rhopzero <= wmin and wmax <= 1.1 * csp.rhopzero,
          f"wall density out of +-10% of rho0: [{wmin}, {wmax}]")
    p50 = statistics.median(times)
    say("mdbc-path", f"{n} particles ({nwalls} walls with normals), {nsteps} "
        f"steps after {nwarm} warm-up: p50 step {p50 * 1e3:.3f} ms, "
        f"{n / p50:.1f} particle-steps/s; {launched['cellforce']} cellforce "
        f"launches, {prepasses[0]} mDBC pre-passes, "
        f"{carry.nrebuild - nrebuild0} rebuilds inside the steps, t "
        f"{carry.t_host:.6f} s, fluid rho [{rmin:.2f}, {rmax:.2f}], wall rho "
        f"[{wmin:.2f}, {wmax:.2f}] ({smi})")
    run = (csp, opts, dom, carry.cells, st.pos, st.vel, st.rho, st.code,
           st.boundnormal, st.motionvel)
    ms = cuda_ms(lambda: MD.mdbc_correction(*run))
    g = MD.ghost_nodes(csp, *run[2:9])
    branches = torch.bincount(g.branch, minlength=3).tolist()
    say("mdbc-prepass", f"alone {ms:.3f} ms per pre-pass (CUDA events, median "
        f"of 7; torch ops) on the final state: {g.idx.numel()} ghost nodes, "
        f"branches first order / Shepard / rho0 {branches} ({smi})")


def kernel_label(mangled):
    """A kernel's name in ptxas' log, with its template arguments and
    without the anonymous namespace's mangled prefix."""
    m = re.search(r"\d+([a-z0-9_]+_kernel)(I(?:L[a-z]\d+E)+E)?", mangled)
    if m is None:
        return mangled
    name = re.sub(r"^.*\d(?=[a-z][a-z0-9_]*_kernel$)", "", m.group(1))
    args = re.findall(r"L[a-z](\d+)E", m.group(2) or "")
    return name + (f"<{','.join(args)}>" if args else "")


def nn_opts(tvisco, velgrad, shiftmode="NONE"):
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpDensity,
                                                   TpShifting, TpVelGrad, TpVisco)
    return SolverOpts(tvisco=TpVisco[tvisco], velgrad=TpVelGrad[velgrad],
                      tdensity=TpDensity.FOURTAKAS,
                      shiftmode=TpShifting[shiftmode])


def nn_kernels_vs_plain(case, phases, device, smi, label="nn-kernel-vs-plain",
                        full=True):
    """Phase 5: each NN kernel against its plain pass on the same inputs,
    two launches of each bit-equal, then the whole interaction in five
    configurations (``full``).  Returns the kernels' records (without
    launches)."""
    from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
    from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
    csp, dom = case.csp, case.dom
    tb = phases.tables(csp, device)
    code0 = case.state.code
    rho0 = tb["rho0"][torch.clamp(code0 & 0xFFFF, 0, phases.count - 1).long()]
    pos, vel, rho, code = perturbed_state(case, device, rho0, sim2d=True)
    cells, args = sorted_args(dom, pos, vel, rho, code)
    spos, svel, srho, scode = args
    ch = NN.channels(csp, phases, tb, srho, scode)
    n = spos.shape[0]
    cand, pairs = pair_counts(csp, dom, cells, spos, scode, inclusive=True)
    say(label, f"{n} particles: {cand} candidates walked, {pairs} "
        f"in-support pairs with a fluid-side target per pass "
        f"({cand / n:.1f} and {pairs / n:.1f} per particle)")
    state_bytes = n * (16 + 16 + 4 + 4 + 4) + (dom.ncells + 1) * 4
    records = {}

    rows = [torch.cat([spos, ch.press[:, None]], dim=1).contiguous(),
            torch.cat([svel, srho[:, None]], dim=1).contiguous(), ch.kind,
            ch.phase, cells.cell, cells.begin]

    def record(name, opts, errs, kernel_fn, plain_fn, run, outs, out_bytes,
               ins=()):
        ms, same = nn_launch_ms(name, NF.make_params(csp, opts, phases, dom, n),
                                rows, outs, ins)
        wrapped_ms = cuda_ms(lambda: kernel_fn(*run))
        plain_ms = cuda_ms(lambda: plain_fn(*run))
        b = bound(state_bytes + n * out_bytes, pairs * OPS_PER_PAIR[name])
        records[name] = dict(max_abs_err=errs["ace"], ms=ms, plain_ms=plain_ms,
                             bound_ms=b[0], bound_by=b[1])
        say(label, f"{name}: max|d| " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
            + f"{same}; kernel alone {ms:.3f} ms, with its wrapper "
            f"{wrapped_ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events), bound "
            f"{b[0] * 1e3:.2f} us by {b[1]} ({smi})")

    def pass1(name, opts, outputs, out_bytes):
        run = (csp, opts, phases, dom, cells, spos, svel, srho, ch)
        got, want = NF.pass1(*run), NN.pass1_plain(*run)
        torch.cuda.synchronize()
        errs = {k: close(f"{name} {k}", getattr(got, k), getattr(want, k))
                for k in outputs}
        errs["viscdtmax"] = close_scalar(
            f"{name} viscdtmax", got.viscdt.amax(), want.viscdt.amax())
        # the four outputs, and no shifting sums or flags
        outs = [torch.empty_like(got.ace), torch.empty_like(got.ar),
                torch.empty_like(got.viscdt),
                torch.empty_like(getattr(got, outputs[-1])), None, None]
        record(name, opts, errs, NF.pass1, NN.pass1_plain, run, outs, out_bytes)

    morris = nn_opts("LAMINAR_SPS", "SPH")
    # nnforce_p1: outputs ace, ar, viscdt, gradvel (12 + 4 + 4 + 24 bytes)
    pass1("nnforce_p1", morris, ("ace", "ar", "gradvel"), 44)
    # nnforce_fda: outputs ace, ar, viscdt, etamax
    pass1("nnforce_fda", nn_opts("LAMINAR_SPS", "FDA"), ("ace", "ar", "etamax"),
          24)

    # nnforce_p3 (Morris) on pass 2 of the plain pass 1: reads eta, ace in
    # and out
    p1 = NN.pass1_plain(csp, morris, phases, dom, cells, spos, svel, srho, ch)
    eta, tau = NN.pass2(morris, tb, ch, scode, p1)
    run3 = (csp, morris, phases, dom, cells, spos, svel, srho, ch, eta, tau)
    got, want = torch.zeros_like(p1.ace), torch.zeros_like(p1.ace)
    NF.pass3(*run3, got)
    NN.pass3_plain(*run3, want)
    torch.cuda.synchronize()
    errs = dict(ace=close("nnforce_p3 ace", got, want))
    record("nnforce_p3", morris, errs, NF.pass3, NN.pass3_plain, run3 + (got,),
           [torch.zeros_like(got)], 4 + 12 + 12, ins=(eta, tau))
    if not full:
        return records

    # the whole interaction in the five configurations
    for tvisco, velgrad in (("LAMINAR_SPS", "SPH"), ("CONST_EQ", "SPH"),
                            ("ARTIFICIAL", "SPH"), ("LAMINAR_SPS", "FDA"),
                            ("CONST_EQ", "FDA")):
        opts = nn_opts(tvisco, velgrad)
        run = (csp, opts, phases, dom, cells, *args)
        got = NF.interaction_forces_nn_cuda(*run)
        want = NN.interaction_forces_nn_plain(*run)
        torch.cuda.synchronize()
        errs = {k: close(f"{velgrad}-{tvisco} {k}", g, w) for k, g, w in (
            ("ace", got.forces.ace, want.forces.ace),
            ("ar", got.forces.ar, want.forces.ar),
            ("visco_eta", got.visco_eta, want.visco_eta),
            ("tau", got.tau, want.tau),
            ("gradvel", got.gradvel, want.gradvel))}
        for k in ("viscdtmax", "viscetadtmax"):
            errs[k] = close_scalar(f"{velgrad}-{tvisco} {k}",
                                   getattr(got.forces, k), getattr(want.forces, k))
        ms = cuda_ms(lambda: NF.interaction_forces_nn_cuda(*run), reps=5)
        plain_ms = cuda_ms(lambda: NN.interaction_forces_nn_plain(*run), reps=5)
        say("nn-interaction-vs-plain", f"{velgrad}-{tvisco}: max|d| " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
            + f"; viscetadtmax {float(got.forces.viscetadtmax):.5g}; kernels "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms per interaction (median of "
            f"5, CUDA events; {smi})")
    return records


def nn_path(case, phases, opts, device, nwarm, nsteps, label, smi, csp=None):
    """Phases 6, 7, 16 and 17: ``nwarm + nsteps`` NN steps from a flowing
    start, under the case's constants or ``csp``; returns (the launch
    counts, the step, the final carry)."""
    from dualsphysics_multilayer_tpu_torch import make_carry, make_nn_step
    csp = csp or case.csp
    step = make_nn_step(csp, opts, case.dom, phases)
    st = flowing_state(case, device, sim2d=True)
    carry = make_carry(st, csp, opts, case.dom)
    nrebuild0 = carry.nrebuild
    carry, times, launched = run_steps(step, carry, nwarm, nsteps)
    check_state(carry, nwarm + nsteps, nrebuild0)
    code = carry.st.code
    ranges = [fluid_rho_range(carry.st, (code & 0xFFFF) == k, p.rho0)
              for k, p in enumerate(phases.phases)]
    n = case.np_total
    p50 = statistics.median(times)
    say(label, f"{n} particles, {nsteps} steps after {nwarm} warm-up: p50 step "
        f"{p50 * 1e3:.3f} ms, {n / p50:.1f} particle-steps/s; launches "
        f"{launched}, {carry.nrebuild - nrebuild0} rebuilds inside the steps, "
        f"t {carry.t_host:.6f} s, dt_pre {float(carry.dt_pre):.4g} s, fluid rho "
        + ", ".join(f"phase {k} [{a:.2f}, {b:.2f}]" for k, (a, b) in
                    enumerate(ranges)) + f" ({smi})")
    return launched, step, carry


def nn_instance(kernel, csp, opts):
    """The ptxas name of the instance of ``kernel`` that these constants and
    options launch."""
    from dualsphysics_multilayer_tpu_torch import TpShifting
    from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
    ker = csp.tkernel.value
    if kernel == "nnforce_p3":
        return f"nnforce_p3_kernel<{ker},{NF.VISC[opts.tvisco]}>"
    return f"{kernel}_kernel<{ker},{int(opts.shiftmode != TpShifting.NONE)}>"


def nn_result_errors(label, got, want, rtol):
    """Errors of a kernels' NN interaction against the plain one: arrays
    within ``rtol``, the scalars within RTOL_SCALAR, the flags exact."""
    errs = {k: close(f"{label} {k}", g, w, rtol) for k, g, w in (
        ("ace", got.forces.ace, want.forces.ace),
        ("ar", got.forces.ar, want.forces.ar),
        ("visco_eta", got.visco_eta, want.visco_eta),
        ("tau", got.tau, want.tau),
        ("gradvel", got.gradvel, want.gradvel),
        ("shiftposfs", got.forces.shiftposfs, want.forces.shiftposfs))
        if w is not None}
    for k in ("viscdtmax", "viscetadtmax"):
        errs[k] = close_scalar(f"{label} {k}", getattr(got.forces, k),
                               getattr(want.forces, k))
    if want.forces.shift_blocked is not None:
        check(torch.equal(got.forces.shift_blocked, want.forces.shift_blocked),
              f"{label} shift_blocked disagrees with the plain version")
    return errs


def nn_variant_kernels_vs_plain(case, phases, device, registers, smi):
    """Phase 15: every new instance of the NN kernels against its plain
    pass on phase 5's state, then the whole interaction of each variant in
    phase 5's five configurations.  Returns {instance: record} (without
    launches)."""
    from dualsphysics_multilayer_tpu_torch import TpKernel, TpShifting
    from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
    from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
    csp0, dom = case.csp, case.dom
    tb = phases.tables(csp0, device)
    code0 = case.state.code
    rho0 = tb["rho0"][torch.clamp(code0 & 0xFFFF, 0, phases.count - 1).long()]
    pos, vel, rho, code = perturbed_state(case, device, rho0, sim2d=True)
    cells, args = sorted_args(dom, pos, vel, rho, code)
    spos, svel, srho, scode = args
    ch = NN.channels(csp0, phases, tb, srho, scode)
    n = spos.shape[0]
    pairs = pair_counts(csp0, dom, cells, spos, scode, inclusive=True)[1]
    state_bytes = n * (16 + 16 + 4 + 4 + 4) + (dom.ncells + 1) * 4
    rows = [torch.cat([spos, ch.press[:, None]], dim=1).contiguous(),
            torch.cat([svel, srho[:, None]], dim=1).contiguous(), ch.kind,
            ch.phase, cells.cell, cells.begin]
    records = {}

    def record(name, csp, opts, label, errs, kernel_fn, plain_fn, run, outs,
               out_bytes, ins=()):
        instance = nn_instance(name, csp, opts)
        ms, same = nn_launch_ms(name, NF.make_params(csp, opts, phases, dom, n),
                                rows, outs, ins)
        wrapped_ms = cuda_ms(lambda: kernel_fn(*run), reps=5)
        plain_ms = cuda_ms(lambda: plain_fn(*run), reps=5)
        ops = OPS_PER_PAIR[name]
        if csp.tkernel == TpKernel.CUBIC and name != "nnforce_p3":
            ops += OPS_TENSILE
        shifting = opts.shiftmode != TpShifting.NONE
        if shifting:
            ops += OPS_SHIFT
            out_bytes += 16 + 1
        b = bound(state_bytes + n * out_bytes, pairs * ops)
        records.setdefault(instance, dict(
            kernel=name, variant=label, max_abs_err=errs["ace"], ms=ms,
            plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            registers=registers.get(instance, "?")))
        say("nn-variant-vs-plain", f"{label} {instance}: max|d| " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
            + f"{same}; kernel alone {ms:.3f} ms, with its wrapper "
            f"{wrapped_ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events), bound "
            f"{b[0] * 1e3:.2f} us by {b[1]}; "
            f"{registers.get(instance, '?')} ({smi})")

    for label, tkernel, shiftmode in NN_VARIANTS:
        csp = csp0.replace(tkernel=TpKernel[tkernel])
        rtol = RTOL_CUBIC if tkernel == "CUBIC" else RTOL
        for velgrad, name, last, out_bytes in (
                ("SPH", "nnforce_p1", "gradvel", 44),
                ("FDA", "nnforce_fda", "etamax", 24)):
            opts = nn_opts("LAMINAR_SPS", velgrad, shiftmode)
            run = (csp, opts, phases, dom, cells, spos, svel, srho, ch)
            got, want = NF.pass1(*run), NN.pass1_plain(*run)
            torch.cuda.synchronize()
            errs = {k: close(f"{label} {name} {k}", getattr(got, k),
                             getattr(want, k), rtol)
                    for k in ("ace", "ar", last, "shift")
                    if getattr(want, k) is not None}
            errs["viscdtmax"] = close_scalar(f"{label} {name} viscdtmax",
                                             got.viscdt.amax(), want.viscdt.amax())
            if want.shiftblk is not None:
                check(torch.equal(got.shiftblk, want.shiftblk),
                      f"{label} {name} shiftblk disagrees with the plain version")
            outs = [torch.empty_like(got.ace), torch.empty_like(got.ar),
                    torch.empty_like(got.viscdt),
                    torch.empty_like(getattr(got, last)),
                    None if got.shift is None else torch.empty_like(got.shift),
                    None if got.shiftblk is None
                    else torch.empty_like(got.shiftblk)]
            record(name, csp, opts, label, errs, NF.pass1, NN.pass1_plain, run,
                   outs, out_bytes)

    # every instance of pass 3 (no shifting sums): each kernel and viscous
    # form, on pass 2 of the plain pass 1 of its options
    for tkernel in ("WENDLAND", "CUBIC"):
        csp = csp0.replace(tkernel=TpKernel[tkernel])
        rtol = RTOL_CUBIC if tkernel == "CUBIC" else RTOL
        for tvisco in ("ARTIFICIAL", "LAMINAR_SPS", "CONST_EQ"):
            opts = nn_opts(tvisco, "SPH")
            label = f"{tkernel.lower()} {tvisco.lower()}"
            p1 = NN.pass1_plain(csp, opts, phases, dom, cells, spos, svel,
                                srho, ch)
            eta, tau = NN.pass2(opts, tb, ch, scode, p1)
            run3 = (csp, opts, phases, dom, cells, spos, svel, srho, ch, eta,
                    tau)
            got, want = torch.zeros_like(p1.ace), torch.zeros_like(p1.ace)
            NF.pass3(*run3, got)
            NN.pass3_plain(*run3, want)
            torch.cuda.synchronize()
            errs = dict(ace=close(f"{label} nnforce_p3 ace", got, want, rtol))
            # reads eta (Morris) or tau (ConsEq); ace in and out
            read = dict(ARTIFICIAL=0, LAMINAR_SPS=4, CONST_EQ=24)[tvisco]
            record("nnforce_p3", csp, opts, label, errs, NF.pass3,
                   NN.pass3_plain, run3 + (got,), [torch.zeros_like(got)],
                   read + 12 + 12, ins=(eta, tau))

    # the whole interaction of each variant in the five configurations
    for label, tkernel, shiftmode in NN_VARIANTS:
        csp = csp0.replace(tkernel=TpKernel[tkernel])
        rtol = RTOL_CUBIC if tkernel == "CUBIC" else RTOL
        worst = {}
        for tvisco, velgrad in NN_CONFIGS:
            run = (csp, nn_opts(tvisco, velgrad, shiftmode), phases, dom, cells,
                   *args)
            got = NF.interaction_forces_nn_cuda(*run)
            want = NN.interaction_forces_nn_plain(*run)
            torch.cuda.synchronize()
            for k, v in nn_result_errors(f"{label} {velgrad}-{tvisco}", got,
                                         want, rtol).items():
                worst[k] = max(worst.get(k, 0.0), v)
        say("nn-variant-interaction-vs-plain", f"{label}, all five "
            f"configurations: max|d| " + ", ".join(
                f"{k} {v:.3e}" for k, v in worst.items()) + f" ({smi})")
    return records


def nn_variant_path(case, phases, csp, opts, nwarm, nsteps, label, kernels,
                    device, smi):
    """Phases 16 and 17: the NN path of ``csp`` and ``opts``, whose
    ``kernels`` must launch twice per step each; then the layout and the
    kernels against plain on the final state.  Returns the launch counts."""
    from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
    from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
    launched, step, carry = nn_path(case, phases, opts, device, nwarm, nsteps,
                                    label, smi, csp=csp)
    for k in kernels:
        check(launched[k] == 2 * (nwarm + nsteps),
              f"{launched} in {nwarm + nsteps} steps, expected {k} 2 per step")
    others = {k: v for k, v in launched.items() if k not in kernels and v}
    check(not others, f"{others} launched besides {kernels}")
    extra = 0
    while carry.rebuild and extra < 5:
        carry, extra = step(carry), extra + 1
    npairs = layout_keeps_pairs(csp, case.dom, carry, inclusive=True)
    st = carry.st
    run = (csp, opts, phases, case.dom, carry.cells, st.pos, st.vel, st.rho,
           st.code)
    got = NF.interaction_forces_nn_cuda(*run)
    want = NN.interaction_forces_nn_plain(*run)
    torch.cuda.synchronize()
    errs = nn_result_errors(label, got, want,
                            RTOL_CUBIC if csp.tkernel.name == "CUBIC" else RTOL)
    say(label, f"after {extra} more steps: the layout of the last divide holds "
        f"all {npairs} pairs a fresh divide finds; the kernels against their "
        f"plain versions on the final state: max|d| " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()) + f" ({smi})")
    return launched


def probes_phase(device, smi):
    """Phase 18: both probes against their plain versions at a small size,
    then their full tables, the launches counted from 0.  Returns the
    probes' records."""
    from dualsphysics_multilayer_tpu_torch.tools import probes as PR
    n = PR.full_threads(device)
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    x = PR.fma_input(n, device)
    worst = {}
    for op in PR.OPS:
        rtol = 1e-5 if op in ("fma", "mix") else 1e-4
        for chains in PR.CHAINS:
            err = close(f"probe_fma {op} x{chains}", PR.fma(x, op, chains, 2),
                        PR.fma_plain(x, op, chains, 2), rtol)
            worst[op] = max(worst.get(op, 0.0), err)
    say("probes-vs-plain", f"probe_fma, {n} threads, rep 2 x {PR.STEPS} "
        f"steps, chains 1/2/4/8: max|d| " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()) + f" ({smi})")
    # counts that end the kernel's pipeline inside the first and inside the
    # second chunk of a pair, every group against the plain loop
    for niter in (37, 45):
        buf, offs = PR.gather_inputs(niter, device)
        gerr = {}
        for aligned in (True, False):
            want = PR.gather_plain(buf, offs, aligned).expand(
                PR.GROUPS, PR.ROWS, PR.LANES)
            for staged in (False, True):
                gerr[(aligned, staged)] = close(
                    f"probe_gather {niter} loads aligned={aligned} "
                    f"staged={staged}", PR.gather(buf, offs, aligned, staged),
                    want, 1e-5)
        say("probes-vs-plain", f"probe_gather, {niter} window loads, "
            f"{PR.GROUPS} groups: max|d| " + ", ".join(
                f"aligned={int(a)} staged={int(s)} {v:.3e}"
                for (a, s), v in gerr.items()) + f" ({smi})")
    # the timed size, NITER loads: there the recurrence amplifies one
    # rounding apart into an O(1) difference and overflows in some aligned
    # lanes, so the kernel is held bit for bit (NaN where the plain loop is
    # NaN) against the plain loop that rounds as its fused multiply-adds do
    buf, offs = PR.gather_inputs(PR.NITER, device)
    gerr, nans = {}, {}
    for aligned in (True, False):
        want = PR.gather_plain(buf, offs, aligned, fused=True).expand(
            PR.GROUPS, PR.ROWS, PR.LANES)
        for staged in (False, True):
            got = PR.gather(buf, offs, aligned, staged)
            nan = want.isnan()
            check(torch.equal(got.isnan(), nan)
                  and torch.equal(got[~nan], want[~nan]),
                  f"probe_gather {PR.NITER} loads aligned={aligned} "
                  f"staged={staged} differs from the fused plain loop")
            gerr[(aligned, staged)] = float((got - want)[~nan].abs().max())
            nans[(aligned, staged)] = int(nan.sum())
    say("probes-vs-plain", f"probe_gather, {PR.NITER} window loads, "
        f"{PR.GROUPS} groups, against the fused plain loop: bit-equal, max|d| "
        + ", ".join(f"aligned={int(a)} staged={int(s)} {v:.3e} "
                    f"({nans[(a, s)]} NaN)" for (a, s), v in gerr.items())
        + f" ({smi})")

    # the tables, the launches counted from 0
    reset_counts()
    fma_rows = PR.fma_table(device)
    gather_rows = PR.gather_table(device)
    launched = dict(PR.launches)
    for k, v in launched.items():
        check(v > 0, f"{k} was not launched by its table")
    clock = PR.sm_clock_hz()
    for r in fma_rows:
        say("probe-fma", f"op={r['op']} chains={r['chains']}: {r['ms']:.4f} ms, "
            f"{r['per_sm_clock']:.2f} steps/SM/clock at {clock / 1e6:.0f} MHz, "
            f"{r['share'] * 100:.2f}% of {PR.F32_LANES} lanes ({n} threads, "
            f"rep {PR.REP} x {PR.STEPS}; {smi})")
    for r in gather_rows:
        where = "shared" if r["staged"] else "global"
        if r["niter"] == 0:
            say("probe-gather", f"staging alone ({where}, {PR.GROUPS} groups): "
                f"{r['ms'] * 1e3:.2f} us ({smi})")
            continue
        say("probe-gather", f"aligned={int(r['aligned'])} {where}: "
            f"{r['ms'] * 1e3:.2f} us for {PR.GROUPS} x {r['niter']} window "
            f"loads, {r['ns_per_load']:.3f} ns per load, "
            f"{r['ns_per_block_load']:.1f} ns per load of one block ({smi})")

    # the records: fma at 8 chains, rep 256; unaligned global windows
    rep = 256
    got, want = PR.fma(x, "fma", 8, rep), PR.fma_plain(x, "fma", 8, rep)
    fma_err = close("probe_fma fma x8 rep 256", got, want, 1e-3)
    p = PR.FmaParams(op=0, chains=8, rep=rep, n=n)
    fma_rec = dict(
        launches=launched["probe_fma"], max_abs_err=fma_err,
        ms=launch_ms(bare_launcher("probes", "dsph_probe_fma", p,
                                   [x, torch.empty_like(x)])),
        plain_ms=cuda_ms(lambda: PR.fma_plain(x, "fma", 8, rep), reps=3),
        bound_ms=PR.fma_bound_ms(n, rep, nsm, clock), bound_by="operations")
    g = PR.GatherParams(niter=PR.NITER, aligned=0, staged=0, groups=PR.GROUPS)
    gb = PR.gather_bound(PR.NITER, PR.GROUPS, nsm, clock)
    say("probe-gather", f"bound of {PR.GROUPS} x {PR.NITER} window loads: "
        + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in PR.gather_bound_terms(
            PR.NITER, PR.GROUPS, nsm, clock).items())
        + f" ({PR.SM_LOAD_BYTES} bytes per SM per clock on the load path, "
        f"{nsm} SMs at {clock / 1e6:.0f} MHz; {smi})")
    gather_rec = dict(
        launches=launched["probe_gather"], max_abs_err=gerr[(False, False)],
        ms=launch_ms(bare_launcher(
            "probes", "dsph_probe_gather", g,
            [buf, offs, torch.empty((PR.GROUPS, PR.ROWS, PR.LANES),
                                    device=device)])),
        plain_ms=cuda_ms(lambda: PR.gather_plain(buf, offs, False), reps=3),
        bound_ms=gb[0], bound_by=gb[1])
    for name, r in (("probe_fma", fma_rec), ("probe_gather", gather_rec)):
        say("probe-record", f"{name}: {r['launches']} launches, kernel alone "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, max|d| "
            f"{r['max_abs_err']:.3e} ({smi})")
    return {"probe_fma": fma_rec, "probe_gather": gather_rec}


def trace_steps(step, carry, nsteps, kernels):
    """``nsteps`` steps under ``torch.profiler`` (CUDA activity only): per
    step, the host-clock window (``window_ms``), the device busy time
    (``busy_ms``, the union of the traced device intervals), the
    ``idle_share``, the device operations (``ops``) and the device time of
    the kernels whose names contain each of ``kernels`` (``kernel_ms``);
    None when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nsteps):
            carry = step(carry)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    ev = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if not ev:
        return None
    busy, cur_s, cur_e = 0.0, ev[0][0], ev[0][1]
    for s0, e0, _ in ev[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy = (busy + cur_e - cur_s) * 1e-3
    return dict(window_ms=window / nsteps, busy_ms=busy / nsteps,
                idle_share=1.0 - busy / window, ops=len(ev) / nsteps,
                kernel_ms={k: sum(e - s0 for s0, e, name in ev if k in name)
                           * 1e-3 / nsteps for k in kernels})


def traced_breakdown(step, carry, nsteps, kernels, smi):
    """Phase 8: :func:`trace_steps`, printed."""
    r = trace_steps(step, carry, nsteps, kernels)
    if r is None:
        say("nn-breakdown", f"not measured: the trace of {nsteps} steps holds "
            f"no device activity ({smi})")
        return
    per_kernel = r["kernel_ms"]
    say("nn-breakdown", f"{nsteps} traced steps: window {r['window_ms']:.3f} "
        f"ms per step, device busy {r['busy_ms']:.3f} ms per step, idle share "
        f"{r['idle_share']:.4f}, {r['ops']:.1f} device operations "
        f"per step; device ms per step " + ", ".join(
            f"{k} {v:.4f}" for k, v in per_kernel.items())
        + f", everything else {r['busy_ms'] - sum(per_kernel.values()):.4f} "
        f"({smi})")


def path_breakdown(label, step, carry, times, nsteps_traced, smi):
    """Phases 19 and 20: the p50 step of the timed steps and a traced
    breakdown of ``nsteps_traced`` more (:func:`trace_steps`)."""
    p50 = statistics.median(times)
    r = trace_steps(step, carry, nsteps_traced, ("cellforce",))
    if r is None:
        say(label, f"p50 step {p50 * 1e3:.3f} ms; device breakdown not "
            f"measured: the trace of {nsteps_traced} steps holds no device "
            f"activity ({smi})")
        return
    say(label, f"p50 step {p50 * 1e3:.3f} ms; {nsteps_traced} traced steps: "
        f"window {r['window_ms']:.3f} ms per step, device busy "
        f"{r['busy_ms']:.3f} ms per step, idle share {r['idle_share']:.4f}, "
        f"{r['ops']:.1f} device operations per step, cellforce "
        f"{r['kernel_ms']['cellforce']:.4f} ms per step ({smi})")


def single_phase_counts(launched, name, per_step, nsteps):
    """Raise unless ``name`` ran ``per_step`` times a step and no other
    kernel ran."""
    want = {**dict.fromkeys(launched, 0), name: per_step * nsteps}
    check(launched == want, f"{launched} kernel launches in {nsteps} steps, "
          f"expected {name} {per_step} per step and no other kernel")


def verlet_path(device, smi):
    """Phase 19: 5 + 50 Verlet steps of the dam break at 267,469 particles
    from a flowing start (its M1 velocity the same), an Euler re-anchoring
    step among them; then the layout and the kernel checks.  Returns the
    cellforce launches of the run."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity, TpStep
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import make_carry, make_step
    case = cases.dambreak3d(dp=DP_BENCH, obstacle=True, need_verlet=True,
                            device=device)
    csp, dom, n = case.csp, case.dom, case.np_total
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, tstep=TpStep.VERLET)
    st = flowing_state(case, device)
    st = dataclasses.replace(st, velm1=st.vel.clone())
    step = make_step(csp, opts, dom)
    carry = make_carry(st, csp, opts, dom)
    nrebuild0 = carry.nrebuild
    nwarm, nsteps = 5, 50
    check(nwarm + nsteps > opts.verlet_steps, "no Euler step inside the run")
    carry, times, launched = run_steps(step, carry, nwarm, nsteps)
    single_phase_counts(launched, "cellforce", 1, nwarm + nsteps)
    check_state(carry, nwarm + nsteps, nrebuild0)
    for k in ("velm1", "rhom1"):
        check(bool(torch.isfinite(getattr(carry.st, k)).all()),
              f"state {k} not finite")
    rmin, rmax = fluid_rho_range(carry.st, True, csp.rhopzero)
    p50 = statistics.median(times)
    say("verlet-path", f"{n} particles, {nsteps} Verlet steps after {nwarm} "
        f"warm-up (an Euler step every {opts.verlet_steps}; verlet_count "
        f"{carry.verlet_count} at the end): p50 step {p50 * 1e3:.3f} ms, "
        f"{n / p50:.1f} particle-steps/s; {launched['cellforce']} cellforce "
        f"launches, {carry.nrebuild - nrebuild0} rebuilds inside the steps, t "
        f"{carry.t_host:.6f} s, dt_pre {float(carry.dt_pre):.4g} s, fluid rho "
        f"[{rmin:.2f}, {rmax:.2f}] ({smi})")
    extra = 0
    while carry.rebuild and extra < 5:
        carry, extra = step(carry), extra + 1
    npairs = layout_keeps_pairs(csp, dom, carry)
    say("verlet-path", f"after {extra} more steps: the layout of the last "
        f"divide holds all {npairs} pairs a fresh divide finds, at the next "
        f"interaction's positions and one dt beyond")
    st = carry.st
    err, ms, wrapped_ms, plain_ms = compare_cellforce(
        csp, opts, dom, carry.cells, (st.pos, st.vel, st.rho, st.code), reps=5)
    say("kernel-vs-plain", f"verlet-path state, {n} particles: max|d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f"; kernel alone {ms:.3f} ms, with its wrapper {wrapped_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (CUDA events; {smi})")
    path_breakdown("verlet-breakdown", step, carry, times, 10, smi)
    return launched["cellforce"]


def piston_check(case, carry, label):
    """Raise unless every particle of the piston (mk 10) moved along x by
    the closed form A sin(w tabs) of ``case.meta["motion"]``, within 1e-3
    dp, as one body, in float64."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    seg = case.meta["motion"].segments[0]
    freq, amp = seg.params[0], seg.params[2]
    st = carry.st
    piston = td.is_moving(st.code) & (td.code_value(st.code) == 10)
    x0 = case.state.pos[:, 0].double()[st.idp[piston]]
    disp = st.pos[piston, 0].double() - x0
    tabs = float(carry.tabs)
    want = amp * np.sin(2.0 * np.pi * freq * tabs)
    dev = float((disp - want).abs().max())
    spread = float(disp.max() - disp.min())
    dp = case.csp.dp
    check(dev < 1e-3 * dp, f"piston displacement off the closed form by "
          f"{dev} m (1e-3 dp = {1e-3 * dp} m)")
    check(spread < 1e-3 * dp, f"piston particles spread by {spread} m")
    say(label, f"piston: {int(piston.sum())} particles moved {want:.6e} m at "
        f"t {tabs:.6f} s (A sin(wt) in float64), max deviation {dev:.3e} m, "
        f"spread {spread:.3e} m (1e-3 dp = {1e-3 * dp:.3e} m); wall speed "
        f"{float(st.vel[piston, 0].max()):.4f} m/s")


def waveflume_path(device, smi):
    """Phase 20: 5 + 50 symplectic steps of bench.py's wave flume (its
    piston's motion only, from still water); then the piston, the layout
    and the kernel with moving walls in the state.  Returns the cellforce
    launches of the run."""
    from dualsphysics_multilayer_tpu_torch import (Features, SolverOpts,
                                                   TpDensity)
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import make_carry, make_step
    case = cases.waveflume2d(dp=DP_FLUME, device=device)
    csp, dom, n = case.csp, case.dom, case.np_total
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    feats = Features(motions=(case.meta["motion"],))
    step = make_step(csp, opts, dom, feats)
    carry = make_carry(case.state, csp, opts, dom, feats)
    nrebuild0 = carry.nrebuild
    nwarm, nsteps = 5, 50
    carry, times, launched = run_steps(step, carry, nwarm, nsteps)
    single_phase_counts(launched, "cellforce", 2, nwarm + nsteps)
    check_state(carry, nwarm + nsteps, nrebuild0)
    rmin, rmax = fluid_rho_range(carry.st, True, csp.rhopzero)
    nmoving = int(td.is_moving(carry.st.code).sum())
    p50 = statistics.median(times)
    say("waveflume-path", f"{n} particles ({case.npb} walls, {nmoving} of them "
        f"the piston), {nsteps} steps after {nwarm} warm-up: p50 step "
        f"{p50 * 1e3:.3f} ms, {n / p50:.1f} particle-steps/s; "
        f"{launched['cellforce']} cellforce launches, "
        f"{carry.nrebuild - nrebuild0} rebuilds inside the steps, t "
        f"{carry.t_host:.6f} s, dt_pre {float(carry.dt_pre):.4g} s, fluid rho "
        f"[{rmin:.2f}, {rmax:.2f}] ({smi})")
    piston_check(case, carry, "waveflume-path")
    extra = 0
    while carry.rebuild and extra < 5:
        carry, extra = step(carry), extra + 1
    npairs = layout_keeps_pairs(csp, dom, carry)
    say("waveflume-path", f"after {extra} more steps: the layout of the last "
        f"divide holds all {npairs} pairs a fresh divide finds (moving walls "
        f"included), at the next predictor's positions and one dt beyond")
    st = carry.st
    moving = td.is_moving(st.code)
    check(float(st.vel[moving].abs().max()) > 0, "the piston is at rest")
    err, ms, wrapped_ms, plain_ms = compare_cellforce(
        csp, opts, dom, carry.cells, (st.pos, st.vel, st.rho, st.code), reps=5)
    say("kernel-vs-plain", f"waveflume-path state (moving walls at up to "
        f"{float(st.vel[moving].norm(dim=1).max()):.4f} m/s), {n} particles: "
        f"max|d| " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f"; kernel alone {ms:.3f} ms, with its wrapper {wrapped_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (CUDA events; {smi})")
    path_breakdown("waveflume-breakdown", step, carry, times, 10, smi)
    return launched["cellforce"]


def full_flume_path(device, smi):
    """Phase 21: the flume of phase 20 with a 2nd-order regular-wave piston,
    AWAS and a damping beach at the far end, its SWL, velocity and MaxZ
    gauges read on their own sub-ticks through ``Simulation.run`` (5 + about
    50 steps); then 5 + 20 steps with a multi-layer piston on mk 10, a
    relaxation zone and an external acceleration.  Returns the cellforce
    launches of the first run."""
    from dualsphysics_multilayer_tpu_torch import (Features, SolverOpts,
                                                   TpDensity)
    from dualsphysics_multilayer_tpu_torch.features import accinput as ACC
    from dualsphysics_multilayer_tpu_torch.features import awas as AW
    from dualsphysics_multilayer_tpu_torch.features import damping as DM
    from dualsphysics_multilayer_tpu_torch.features import gauges as G
    from dualsphysics_multilayer_tpu_torch.features import mlpiston as MLP
    from dualsphysics_multilayer_tpu_torch.features import relaxzone as RZ
    from dualsphysics_multilayer_tpu_torch.features import wavegen as WG
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (Simulation,
                                                                make_carry,
                                                                make_step)
    case = cases.waveflume2d(dp=DP_FLUME, device=device)
    csp, dom, n, dp = case.csp, case.dom, case.np_total, case.csp.dp
    depth, height, period = 0.4, 0.1, 1.25
    stroke, _ = WG.biesel_piston(height, period, depth)
    feats = Features(
        motions=(WG.piston_waves(10, height=height, period=period, depth=depth,
                                 order=2),),
        awas=(AW.AwasZsurf(mk=10, height=height, period=period, depth=depth,
                           swl=depth, gauge_x=0.1),),
        damping=(DM.DampingPlane(point=(5.0, 0.0, 0.0),
                                 limitpoint=(6.0, 0.0, 0.0)),))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(csp, opts, dom, case.state, feats)
    sim.carry = sim.advance(sim.carry, float("inf"), 5)
    # the run's clock includes the warm-up: 60 steps of its dt, so about 50
    # more, with the gauges on a grid of a fifth of that
    span = 60 * float(sim.carry.dt_pre)
    gs = G.GaugeSystem(csp, dom, [
        G.GaugeSwl("swl", (1.0, 0.0, 0.2), (1.0, 0.0, 0.7), 0.5 * dp),
        G.GaugeVel("vel", (0.3, 0.0, 0.2)),
        G.GaugeMaxZ("maxz", (0.5, 0.0, 0.0), 0.9, 2.0 * dp)],
        computedts={"swl": span / 5, "vel": span / 5, "maxz": span / 5})
    readings = []

    def on_subtick(s, t):
        cells = None if s.carry.rebuild else s.carry.cells
        readings.append((t, gs.run(t, s.carry.st, cells, at_save=False)))

    nstep0 = sim.carry.nstep
    reset_counts()
    t0 = time.perf_counter()
    sim.run(tmax=span, tout=span, next_subtick=gs.next_time,
            on_subtick=on_subtick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    nsteps = sim.carry.nstep - nstep0
    single_phase_counts(launched, "cellforce", 2, nsteps)
    check(len(readings) >= 4, f"{len(readings)} gauge sub-ticks")
    for t, r in readings:
        check(set(r) == {"swl", "vel", "maxz"}, f"gauges at {t}: {set(r)}")
        for k, v in r.items():
            check(bool(np.isfinite(np.asarray(v, np.float64)).all()),
                  f"gauge {k} at {t} not finite: {v}")
        z = float(r["swl"][2])
        check(abs(z - depth) <= stroke, f"SWL {z} m outside the depth {depth} "
              f"m +- the stroke {stroke:.4f} m")
    awas = sim.carry.awas
    check(bool(torch.isfinite(awas).all()), f"AWAS correction {awas}")
    rmin, rmax = fluid_rho_range(sim.carry.st, True, csp.rhopzero)
    last = readings[-1][1]
    say("full-flume", f"{n} particles, piston_waves(order=2) H {height} m T "
        f"{period} s (stroke {stroke:.4f} m) + AWAS + damping beach: "
        f"Simulation.run over {span:.6f} s, {nsteps} steps after 5 warm-up in "
        f"{wall:.3f} s ({launched['cellforce']} cellforce launches), "
        f"{len(readings)} gauge sub-ticks; last: SWL z {float(last['swl'][2]):.5f} "
        f"m, velocity {np.round(np.asarray(last['vel']), 6).tolist()} m/s, MaxZ "
        f"{last['maxz']:.5f} m; AWAS correction {awas.tolist()} m; fluid rho "
        f"[{rmin:.2f}, {rmax:.2f}] ({smi})")

    # a multi-layer piston on mk 10 (three layers, 0.6 s of table), a
    # relaxation zone toward the same regular wave and an external
    # acceleration of the fluid
    times = (0.0, 0.2, 0.4, 0.6)
    vels = np.array([[0.0, 0.0, 0.0], [0.1, 0.08, 0.05], [0.12, 0.1, 0.06],
                     [0.0, 0.0, 0.0]])
    feats2 = Features(
        mlpistons=(MLP.make_piston1d(10, times, vels, 0.0, 1.0),),
        relaxzones=(RZ.RelaxZoneRegular(center=(3.0, 0.0, 0.0), width=1.0,
                                        height=0.05, period=period,
                                        depth=depth, swl=depth),),
        accinputs=(ACC.AccInput(mkfluid=0, times=(0.0, 1.0),
                                acclin=(0.2, 0.0, 0.0, 0.2, 0.0, 0.1)),))
    step = make_step(csp, opts, dom, feats2)
    carry = make_carry(case.state, csp, opts, dom, feats2)
    carry, times2, launched2 = run_steps(step, carry, 5, 20)
    single_phase_counts(launched2, "cellforce", 2, 25)
    check_state(carry, 25, None)
    rmin, rmax = fluid_rho_range(carry.st, True, csp.rhopzero)
    say("full-flume", f"multi-layer piston + relaxation zone + external "
        f"acceleration: 20 steps after 5 warm-up, p50 step {statistics.median(times2) * 1e3:.3f} ms; "
        f"{launched2['cellforce']} cellforce launches, fluid rho "
        f"[{rmin:.2f}, {rmax:.2f}] ({smi})")
    return launched["cellforce"]


def main():
    check(torch.cuda.is_available(), "no CUDA device: the port's smoke run "
          "needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpDensity,
                                                   TpKernel, TpShifting, TpVisco)
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    from dualsphysics_multilayer_tpu_torch.models.wcsph import make_carry, make_step
    from dualsphysics_multilayer_tpu_torch.ops.cuda import build

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say("device", f"{kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    built = build.build_cuda_libraries()
    say("build", ", ".join(f"{name} ({', '.join(build.LIBRARIES[name][0])}) "
                           f"built and loaded in {s:.2f} s"
                           for name, s in built.items())
        + " (one nvcc per source, started together)")
    registers = {}   # kernel instance: its ptxas register line
    for name in built:
        with open(build.library_path(name) + ".log") as f:
            entry = "?"
            for line in f:
                m = re.search(r"entry function '([^']+)'", line)
                if m:
                    entry = kernel_label(m.group(1))
                if "registers" in line or "spill" in line:
                    say("ptxas", f"{name} {entry}: {line.strip()}")
                if "registers" in line:
                    registers[entry] = line.strip()

    # 3. cellforce vs plain at ~50k particles
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    case = cases.dambreak3d(dp=DP_50K, obstacle=True, device=device)
    pos, vel, rho, code = perturbed_state(case, device, case.csp.rhopzero)
    cells, args = sorted_args(case.dom, pos, vel, rho, code)
    err, ms, wrapped_ms, plain_ms = compare_cellforce(
        case.csp, opts, case.dom, cells, args, reps=7)
    say("kernel-vs-plain", f"{case.np_total} particles: max|d ace| "
        f"{err['ace']:.3e}, max|d ar| {err['ar']:.3e}, |d viscdtmax| "
        f"{err['viscdtmax']:.3e}; kernel alone {ms:.3f} ms, with its wrapper "
        f"{wrapped_ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events; {smi})")

    # 4. dam-break main path at bench.py's default size
    case = cases.dambreak3d(dp=DP_BENCH, obstacle=True, device=device)
    n = case.np_total
    step = make_step(case.csp, opts, case.dom)
    carry = make_carry(flowing_state(case, device), case.csp, opts, case.dom)
    nrebuild0 = carry.nrebuild
    nwarm, nsteps = 5, 50
    carry, times, launched = run_steps(step, carry, nwarm, nsteps)
    check(launched["cellforce"] == 2 * (nwarm + nsteps),
          f"{launched} kernel launches in {nwarm + nsteps} steps, expected "
          f"cellforce 2 per step")
    check_state(carry, nwarm + nsteps, nrebuild0)
    st = carry.st
    rmin, rmax = fluid_rho_range(st, True, case.csp.rhopzero)
    p50 = statistics.median(times)
    say("main-path", f"{n} particles, {nsteps} steps after {nwarm} warm-up: "
        f"p50 step {p50 * 1e3:.3f} ms, {n / p50:.1f} particle-steps/s; "
        f"{launched['cellforce']} kernel launches, {carry.nrebuild - nrebuild0} "
        f"rebuilds inside the steps, overflow {carry.overflow}, t "
        f"{carry.t_host:.6f} s, fluid rho [{rmin:.2f}, {rmax:.2f}] ({smi})")

    # cellforce vs plain on the final main-path state, and its bound there
    err, ms, wrapped_ms, plain_ms = compare_cellforce(
        case.csp, opts, case.dom, carry.cells, (st.pos, st.vel, st.rho, st.code),
        reps=5)
    cand, pairs = pair_counts(case.csp, case.dom, carry.cells, st.pos, st.code,
                              inclusive=False)
    b = bound(cellforce_bytes(n, case.dom.ncells, opts),
              pairs * OPS_PER_PAIR["cellforce"])
    say("kernel-vs-plain", f"main-path state, {n} particles: max|d ace| "
        f"{err['ace']:.3e}, max|d ar| {err['ar']:.3e}; kernel alone {ms:.3f} "
        f"ms, with its wrapper {wrapped_ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(CUDA events); {cand} "
        f"candidates, {pairs} in-support pairs with a fluid-side target; bound "
        f"{b[0] * 1e3:.2f} us by {b[1]} ({smi})")
    records = {"cellforce": dict(launches=launched["cellforce"],
                                 max_abs_err=err["ace"], ms=ms,
                                 plain_ms=plain_ms, bound_ms=b[0],
                                 bound_by=b[1])}

    # 5. NN kernels vs plain at bench.py's nnmud size
    case, phases = NM.wet_dambreak_nn(dp=NN_DP, device=device)
    records.update(nn_kernels_vs_plain(case, phases, device, smi))
    # kernels 4 and 6 at a third of the dp (330,781 particles), where one
    # thread per target fills the card too
    nn_kernels_vs_plain(*NM.wet_dambreak_nn(dp=NN_DP / 3, device=device),
                        device, smi, label="nn-kernel-vs-plain-large",
                        full=False)

    # 6. NN main path: SPH Morris, Fourtakas
    nwarm, nsteps = 5, 50
    launched, step, carry = nn_path(case, phases, nn_opts("LAMINAR_SPS", "SPH"),
                                    device, nwarm, nsteps, "nn-main-path", smi)
    for k in ("nnforce_p1", "nnforce_p3"):
        check(launched[k] == 2 * (nwarm + nsteps),
              f"{launched} in {nwarm + nsteps} steps, expected {k} 2 per step")
        records[k]["launches"] = launched[k]

    # 7. NN FDA path: FDA Morris
    nwarm, nsteps = 5, 20
    launched, _, _ = nn_path(case, phases, nn_opts("LAMINAR_SPS", "FDA"),
                             device, nwarm, nsteps, "nn-fda-path", smi)
    check(launched["nnforce_fda"] == 2 * (nwarm + nsteps),
          f"{launched} in {nwarm + nsteps} steps, expected nnforce_fda 2 per step")
    records["nnforce_fda"]["launches"] = launched["nnforce_fda"]

    # 8. NN step breakdown, continuing the SPH Morris run
    traced_breakdown(step, carry, 10, ("nnforce_p1", "nnforce_p3"), smi)

    # 9. the other cellforce instances vs plain at ~50k particles
    variant_kernels_vs_plain(device, smi)

    # 10. laminar+SPS path: -viscolamsps:1e-6 -shifting:2
    case = cases.dambreak3d(dp=DP_BENCH, obstacle=True, visco=LAMSPS_VISCO,
                            need_sps=True, device=device)
    opts = SolverOpts(tvisco=TpVisco.LAMINAR_SPS, tdensity=TpDensity.FOURTAKAS,
                      shiftmode=TpShifting.NO_FIXED)
    name, rec = variant_path("lamsps-path", lamsps_csp(DP_BENCH), opts, case,
                             device, smi)
    records[name] = rec

    # 11. cubic path: -cubic
    case = cases.dambreak3d(dp=DP_BENCH, obstacle=True, device=device)
    name, rec = variant_path("cubic-path",
                             case.csp.replace(tkernel=TpKernel.CUBIC),
                             SolverOpts(tdensity=TpDensity.FOURTAKAS), case,
                             device, smi)
    records[name] = rec

    # 12. the floating and mDBC instances vs plain on the floating box
    floating_kernels_vs_plain(device, registers, smi)

    # 13. floating box path: bench.py's floatingbox options
    floating_path(device, smi)

    # 14. mDBC dam break path: -mdbc
    mdbc_path(device, smi)

    # 15. the other NN instances vs plain on phase 5's state
    case, phases = NM.wet_dambreak_nn(dp=NN_DP, device=device)
    instances = nn_variant_kernels_vs_plain(case, phases, device, registers,
                                            smi)

    # 16. NN shifting path: -shifting:2 on phase 6's options
    opts = nn_opts("LAMINAR_SPS", "SPH", "NO_FIXED")
    kernels = ("nnforce_p1", "nnforce_p3")
    launched = nn_variant_path(case, phases, case.csp, opts, 5, 50,
                               "nn-shift-path", kernels, device, smi)
    for k in kernels:
        instances[nn_instance(k, case.csp, opts)]["launches"] = launched[k]

    # 17. NN cubic path: FDA Morris with -cubic -shifting:2
    cubic = case.csp.replace(tkernel=TpKernel.CUBIC)
    opts = nn_opts("LAMINAR_SPS", "FDA", "NO_FIXED")
    launched = nn_variant_path(case, phases, cubic, opts, 5, 20,
                               "nn-cubic-path", ("nnforce_fda",), device, smi)
    instances[nn_instance("nnforce_fda", cubic, opts)]["launches"] = \
        launched["nnforce_fda"]
    for name in ("nnforce_p1", "nnforce_p3", "nnforce_fda"):
        records[name]["instances"] = [
            dict(instance=k, variant=r["variant"], launches=r.get("launches", 0),
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"])
            for k, r in instances.items() if r["kernel"] == name]

    # 18. the two hardware probes
    records.update(probes_phase(device, smi))

    # 19. Verlet dam break: BENCH_STEP=verlet at 267,469 particles
    paths = {"dambreak3d": records["cellforce"]["launches"]}
    paths["verlet"] = verlet_path(device, smi)

    # 20. bench.py's wave flume: the sinusoidal piston
    paths["waveflume"] = waveflume_path(device, smi)

    # 21. the full flume: wave generator, AWAS, damping, gauges; then a
    # multi-layer piston and a relaxation zone
    paths["full-flume"] = full_flume_path(device, smi)
    records["cellforce"]["path_launches"] = paths

    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep,
        launches=records[name]["launches"],
        max_abs_err=records[name]["max_abs_err"], ms=records[name]["ms"],
        plain_ms=records[name]["plain_ms"], bound_ms=records[name]["bound_ms"],
        bound_by=records[name]["bound_by"], library_ms=None,
        **{k: records[name][k] for k in ("instances", "path_launches")
           if k in records[name]})
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
