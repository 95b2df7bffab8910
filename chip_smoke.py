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
    ptxas registers (``cellforce_kernel<KER,VISC,SHIFT,FT,SYM>``, FT = 1
    with floating bodies, SYM = 1 with the symmetry plane);
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
    external acceleration of the fluid;
22. CLI: ``cli.main`` in-process, ``-builtin dambreak3d`` at 267,469
    particles from rest with ``-ddtramp:0.004:0.002:0.3 -savedt
    -sv:binx,info -svtimers -svpips -svres -nortimes``, 4 PARTs of 1.8 ms
    (about 100 steps): cellforce exactly twice per step and no other
    kernel; every PART read back with the port's reader (ids a permutation
    of the case's, finite ``Posd``, fluid density within 10% of rho0),
    SaveDt.csv one row per step, the other channels present; then
    ``-partbegin:2`` into a second directory, its first step at its
    PART's time (the ramp goes on), its Part_0004 within 0.25*dp of the
    first run's by id; the same two runs under ``-verlet`` without the
    ramp, whose restart takes its M1 state from its PART: every PART read
    back, Part_0004 within 0.25*dp of the uninterrupted run's (the
    velocities' distance printed beside max|vel|); a ``-verlet`` run with
    the ramp from rest to 2.4 ms, its fluid density range per PART printed
    (the leapfrog leaves +-10% under the ramp's DDT of 0.3, as JAX's does:
    ``tests/port/test_torch_runloop.py``); then the ms per PART
    save on the
    host clock (binx, median of 5; binx with VTK, once) and the bytes a
    save copies from the device, counted by ``io.partdata.HostCopy``;
23. step values: kernels 1-3 at about 50k particles (phase 9's state)
    under a DDT coefficient and a viscosity other than the constants', each
    against its plain version under the same values (phase 3's rule) and
    each moved by them more than ten times that rule away from the
    constants' forces; then the main path (phase 4's case and flow) with
    the DDT ramp, a 3-row viscosity table and the SaveDt ring: 5 + 50
    steps, cellforce twice per step, one finite ring row per step, the
    launch values changed over the run, one device-to-host copy per step
    in 10 steps traced with ``torch.profiler`` (a trace without device
    activity fails), and its p50 step printed beside phase 4's; then the
    host cost of the values alone: the path without them and with a ramp
    and a table that give the constants' values (the same flow) plus the
    SaveDt ring, stepped in alternation from the same flowing start (5 +
    100 steps each), the quartiles of each path's step and of their
    step-by-step difference; and ``step_values`` and the SaveDt row alone,
    per call;
24. XML dam break: an inline ``*_Def.xml`` drawing the three boxes of
    ``cases.dambreak3d(obstacle=True)`` at bench.py's dp for
    BENCH_NP=300000 (DensityDT=2, Visco=0.1, symplectic), loaded with
    ``io.xmlcase.load_case`` (its host seconds printed) and run through
    ``cli.main(["-case", ...])``, the entry point of ``python -m
    dualsphysics_multilayer_tpu_torch.cli -case``: its 267,469 particles'
    sorted positions and codes equal to the builtin's (else how many
    differ), PARTs 0-3 of 1.2 ms read back with the fluid density within
    10%, cellforce exactly twice per step and no other kernel; then 5 + 20
    steps of the loaded case from rest for the step's p50;
25. XML NN wet dam break: an inline XML with the two ``<nnphases>`` of
    ``wet_dambreak_nn`` at bench.py's nnmud size (37,143 particles; SPH
    Morris and Fourtakas), through ``-case`` twice: VelocityGradientType=2
    (nnforce_p1 and nnforce_p3 exactly twice per step) and 1 (nnforce_fda
    twice per step), no other kernel; PARTs 0-3 of 0.2 ms read back, each
    phase's fluid density within 10% of its rest density;
26. symmetry: phase 24's dam break cut at its tank's mid-plane, which
    moves to y = 0, under ``Symmetry=1`` (no front wall; the obstacle's
    half, 0.06 m, centred on the plane), at phase 24's dp (about half
    of its 267,469 particles), through ``-case``: PARTs
    0-3 read back, cellforce's SYM instance exactly twice per step
    (counted as ``cellforce_sym``) and no other kernel, the fluid front
    beside the full case's of phase 24 at the same time (printed, not
    gated), 5 + 20 steps from rest for the p50; then the four SYM
    instances (Wendland and cubic, with and without NO_FIXED shifting)
    against the plain mirror pass on a flowing state (rtol as in phase 9),
    with their bound (the pairs and the image pairs of this state) and
    registers, and 10 steps of each from that state;
27. ``<initialize>``: phase 24's dam break with a linear ``fluidvelocity``
    profile (0 to 0.5 m/s over the column) and a ``boundnormal_plane`` per
    wall face, through ``-case``: mDBC walls, every wall with a normal,
    cellforce and the mDBC pre-pass exactly twice per step each, PARTs
    read back with the wall density within 10%; then ``-builtin
    dambreak2d -mdbc -initnorpla:...`` at phase 14's size, whose normals
    must equal those of the same plane in an ``<initialize>`` node, with
    the same counts;
28. NN under mDBC: phase 25's XML with ``<initialize><boundnormal_parts>``
    on its tank, through ``-case`` for SPH (nnforce_p1, nnforce_p3) and FDA
    (nnforce_fda), each under the case's Fourtakas diffusion and under
    ``-ddt:1`` (Molteni): mDBC walls, the run's line that its step runs no
    mDBC pre-pass, the kernels exactly twice per step and no other, PART 3
    read back with each phase's density within 10%; then kernels 4 and 6
    under mDBC walls with Molteni against their plain versions, each timed
    alone under DBC and under mDBC walls, and the count of targets whose
    continuity the walls' rule changes (must be above 0);
29. channel2d: ``-builtin channel2d -dp 0.0014`` through ``cli.main``
    (64,120 live particles, two PARTs of 4 ms, ~200 steps), each step
    recorded by id: conversions, spawns, captures and destructions
    printed, the live count exactly the start plus the spawns less the
    destructions, a rebuild after every step that spawned and only then or
    when the skin contract asks, cellforce exactly twice per step and no
    other kernel, overflow 0, the fluid density within 15% (the zones'
    start from rest, ``CHANNEL_RHO_TOL``), the PARTs read back; then 5 +
    20 steps for the p50, one device-to-host copy per step
    over 10 traced steps, a traced breakdown, and kernel 1 against its
    plain version on the final state (rtol 2e-3) with its bound;
30. an inout duct through ``-case`` (``duct_xml``: 0.6 m long, 0.2 x 0.2
    m, DBC walls, ~270k particles at dp 0.005, a ``<zone3d><box>`` inlet
    imposing 0.5 m/s and an outlet whose velocity and density are
    extrapolated): phase 29's checks, and the extrapolated members finite
    and within 10% of rest density;
31. periodic: the x-periodic channel (``cases.periodic_channel2d``, ~61.6k
    particles at dp 0.002, ghost_cap 1024) through the library API, all
    fluid at 1 m/s: no normal particle lost, wraps > 0, the spread of the
    fluid's vx bounded, the fluid density within 1%, cellforce and the
    periodic divide twice per step, overflow 0; the timing of phase 29,
    and kernel 1 against its plain version on a state with its ghost rows;
32. DEM in 3D through ``-case`` (``dem_xml``): phase 24's dam break at
    DP_BENCH with two floating 0.1 m boxes (rhopbody 800) downstream of
    the obstacle, ``RigidAlgorithm=2`` and ``<properties>``; box 52 moved
    0.1 dp towards box 51 (nearest particles 0.9 dp apart) in a PART 0
    the CLI starts from (``-partbegin:0``), ~50 steps: box-box contacts
    from the first step, box-wall contacts within the run, no box particle
    within 0.5 dp of the other box or a wall, both boxes rigid, finite;
    then the timing (one device-to-host copy per step, DEM's pass alone)
    and kernel 1's floating instance (FT = 1) in 3D against its plain
    version on the final state with its bound;
33. the moored box through ``-case`` (``moored_xml``, the XML twin of
    ``floatingbox2d`` at DP_FLOAT, 62,033 particles, with
    examples/03_floating_moored.py's two MoorDyn lines in a file beside
    it): each step's fairlead nodes within 1e-5 m of the body's fairleads,
    finite tensions, a MooringsLines file and two MooringsPoints.csv rows
    per save, the lines' relaxation's host seconds; the timing with the
    rigid update and the lines' substep alone; then 20 steps through
    ``Features`` of a quasi-static ``MooringCfg`` and a ``ForcePointsCfg``;
34. Chrono in 3D through ``-case`` (``chrono_xml``): phase 24's dam break
    with a floating flap (0.02 x 0.5 x 0.2 m) hinged to the ground at its
    lower edge (axis y) and held by a linear spring, and a collision box
    (``box.obj``) on a fixed floor mesh (``floor.obj``, a patch under
    it), ~50 steps: the
    hinge point within 1.5% of its arm of ``rotpoint``, off-axis angles
    under 0.02 rad, the box above the floor mesh; the timing with the
    rigid update (KKT solve, mesh contact) alone, kernel 1's floating
    instance against its plain version; a restart from PART 1 refused
    without ``-restartchrono`` (JAX's message) and run with it;
35. the neighbour-list mode (``SolverOpts(use_nbrlist=True)``, ``auto_m``,
    ``nbr_skin`` 0.5) on the dam break at DP_BENCH beside the default
    layout from phase 4's flowing state: 55 default steps, then the
    list's steps to the same time; step counts within 2, positions by id
    within 0.05 dp, overflow 0, cellforce exactly twice per step and no
    other kernel, one device-to-host copy per step, the rebuilds, each
    layout's p50 and mean step and candidates per in-support pair, the
    overflow count's ms per rebuild, kernel 1 against its plain version
    on the list's layout with its bound; then ``nbr_m=8``, which must leave
    through ``check_diagnostics`` naming the list's capacity;
36. the tools (``tools.main``, ``dsphtorchtools``) over PARTs 0-2 of the
    dam break at DP_BENCH from ``cli.main`` and phase 32's PartFloat.fbi4:
    partvtk, measuretool (10^4 points, then 200 -elevation columns),
    isosurface (the default 2 dp node grid; triangles in every PART),
    computeforces on the obstacle (mk 12) and the tank (mk 11),
    floatinginfo, flowtool, tracerparts and bifileinfo; each device tool a
    second time with
    ``-cpu``, the files agreeing within rtol 1e-6 (abs 1e-9), none empty;
    host seconds per PART and the pairs each sum visited.

Each kernel is timed twice: alone (``ms``: CUDA events around 20
back-to-back launches of the C launcher on prepared inputs, per launch,
median of 5) and with its wrapper (channel packing, checks, allocation;
median of 7).  The last two lines are a JSON record of the kernels (with
each kernel's bound: the larger of the bytes it must move over 3.35 TB/s
and the f32 operations of this run's in-support pairs over 67 TFLOP/s,
the H100 SXM peaks; for the FMA probe its steps over the SM's 128 f32
lanes at the SM's maximum clock; for the window-load probe the largest of
its device-memory bytes, its loads' bytes through the SMs' load paths and
its operations; the rows of kernels 1, 2, 4 and 6 list their other
instances under ``instances``: the SYM instances of phase 26, the mDBC runs
of kernels 4 and 6 with their DBC time as ``dbc_ms``) and the result line
``{"ok": true, "device": {...}}``.  Every launch count comes from its
path's run, counted from 0 just before it (the probes' from their
tables); cellforce's row adds ``path_launches``, its launches on the dam
break (phase 4), the Verlet path, the wave flume, the full flume, the CLI
(phase 22), the main path with step values (phase 23) and the XML dam
break (phase 24), and the ``<initialize>`` and ``-initnorpla`` runs
(phase 27), the channel, the duct and the periodic channel (phases
29-31), the couplings (phases 32-34) and the neighbour-list mode (phase
35), with ``open_states``, kernel 1
against its plain version on the final states of phases 29-31 and their
step's p50 and trace, and ``coupling_states``, the same for phases 32-34
with the couplings' pieces alone (DEM's pass, the rigid update with the
lines, the lines' substep, the rigid update with Chrono), and
``nbrlist_state``, the same for phase 35 on the list's layout with its
p50 step beside the default layout's, the overflow count's ms and each
layout's candidates per pair; the NN
kernels' rows add theirs on phases 6-7, the XML runs of phase 25 and the
mDBC runs of phase 28.
Imports no JAX.
"""

import atexit
import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
# phase 22: 4 PARTs of 1.8 ms at DP_BENCH, ~100 steps (dt ~7e-5 s after the
# DtIni step), the DDT ramp's two ends inside them
CLI_TOUT = 0.0018
CLI_RAMP = "0.004:0.002:0.3"
STEP_VALUES_PAIRS = 100  # phase 23: timed steps of each path, alternated
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
                      ftomassp=None, ddtkh=None, visco=None):
    """The cellforce kernel of this configuration vs its plain version on
    the same inputs (``ddtkh`` and ``visco``: a step's launch values in
    place of the constants'): errors and the times of the kernel alone,
    with its wrapper, and of the plain version."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.ops import forces as F
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    name = CF.kernel_name(csp, opts)
    rtol = RTOL_CUBIC if csp.tkernel == td.TpKernel.CUBIC else RTOL
    run = (csp, opts, dom, cells, *args, spstau, ftomassp)
    over = dict(ddtkh=ddtkh, visco=visco)
    got = CF.interaction_forces_cuda(*run, **over)
    want = F.interaction_forces_plain(*run, **over)
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
        "cellforce", f"dsph_{name}", CF.make_params(csp, opts, dom, n, **over),
        [pospress, velrho, kind, cells.cell, cells.begin, spstau, ftmass]
        + outs))
    wrapped_ms = cuda_ms(lambda: CF.interaction_forces_cuda(*run, **over),
                         reps)
    plain_ms = cuda_ms(lambda: F.interaction_forces_plain(*run, **over), reps)
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
            ("floating", csp, SolverOpts(tdensity=fourtakas, **walls),
             "<2,1,0,1,0>"),
            ("floating+molteni-mdbc", csp,
             SolverOpts(tdensity=TpDensity.MOLTENI, **walls), "<2,1,0,1,0>"),
            ("floating-cubic", csp.replace(tkernel=TpKernel.CUBIC),
             SolverOpts(tdensity=fourtakas, **walls), "<1,1,0,1,0>"),
            ("floating-lamsps", lam,
             SolverOpts(tvisco=TpVisco.LAMINAR_SPS, tdensity=fourtakas,
                        **walls), "<2,2,0,1,0>")):
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


def read_parts(pd, directory, n, rho0):
    """Every Part_XXXX.bi4 of ``directory`` read back with the port's
    reader, each checked: its ids a permutation of the case's ``n``, its
    positions finite, its fluid density within 10% of ``rho0``.  Returns
    {cpart: the part's dict}."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    parts = {}
    for f in sorted(os.listdir(directory)):
        if not re.fullmatch(r"Part_\d{4}\.bi4", f):
            continue
        d = pd.read_part(os.path.join(directory, f))
        check(np.array_equal(np.sort(d["idp"]), np.arange(n)),
              f"{f}: ids are not a permutation of the case's {n}")
        check(bool(np.isfinite(d["pos"]).all()), f"{f}: Posd not finite")
        fluid = td.code_type(d["code"].astype(np.int64)) == td.TYPE_FLUID
        r = d["rhop"][fluid]
        check(0.9 * rho0 <= r.min() and r.max() <= 1.1 * rho0,
              f"{f}: fluid density [{r.min()}, {r.max()}] out of +-10% of "
              f"{rho0}")
        parts[d["cpart"]] = d
    return parts


def save_ms(sim, directory, reps, **channels):
    """(milliseconds of one PART save of ``sim`` through an OutputManager
    with ``channels`` (the device-to-host copies and the files), median of
    ``reps``; the bytes the last save copied from the device)."""
    from dualsphysics_multilayer_tpu_torch.io.output import OutputManager
    from dualsphysics_multilayer_tpu_torch.models import cases
    om = OutputManager(directory, cases.Case(
        csp=sim.csp, dom=sim.dom, state=sim.state, npb=0, np_total=sim.state.n,
        meta=dict(name="dambreak3d")), nortimes=True, **channels)
    times = []
    for k in range(reps):
        sim.part = k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        om(sim)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), om.last_save_bytes


def cli_path(device, smi):
    """Phase 22: the CLI in-process on the card, ``-builtin dambreak3d`` at
    267,469 particles from rest with the DDT ramp, ~100 steps over 4 PARTs;
    every PART read back; then ``-partbegin:2`` into a second directory,
    its Part_0004 against the first run's; then the ms per PART save.
    Returns the cellforce launches of the first run."""
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import Simulation
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    root = tempfile.mkdtemp(prefix="_smoke_cli_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        first, again = os.path.join(root, "run"), os.path.join(root, "again")
        argv = ["-builtin", "dambreak3d", "-dp", repr(DP_BENCH),
                f"-tmax:{4 * CLI_TOUT!r}", f"-tout:{CLI_TOUT!r}",
                f"-ddtramp:{CLI_RAMP}", "-savedt", "-sv:binx,info",
                "-svtimers", "-svpips", "-svres", "-nortimes"]
        reset_counts()
        t0 = time.perf_counter()
        check(cli.main(argv + ["-dirout", first]) == 0, "the CLI failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        case = cases.dambreak3d(dp=DP_BENCH, device=device)
        n, rho0 = case.np_total, case.csp.rhopzero
        parts = read_parts(PD, first, n, rho0)
        check(sorted(parts) == [0, 1, 2, 3, 4], f"PARTs {sorted(parts)}")
        nsteps = parts[4]["nstep"]
        single_phase_counts(launched, "cellforce", 2, nsteps)
        with open(os.path.join(first, "SaveDt.csv")) as f:
            rows = f.read().splitlines()[1:]
        check([int(r.split(";")[0]) for r in rows] == list(range(nsteps)),
              f"SaveDt.csv has {len(rows)} rows for {nsteps} steps")
        for name in ("PartInfo.csv", "Timers.csv", "PIPS.csv", "Run.csv",
                     "Run.out", "Part_Head.ibi4"):
            check(os.path.exists(os.path.join(first, name)), f"no {name}")
        with open(os.path.join(first, "PIPS.csv")) as f:
            pips = dict(zip(*[line.strip().split(";") for line in f]))
        say("cli", f"-builtin dambreak3d, {n} particles: {nsteps} steps and "
            f"5 PARTs in {wall:.3f} s ({launched['cellforce']} cellforce "
            f"launches), all read back (ids a permutation, finite Posd, fluid "
            f"rho within 10%), SaveDt.csv {len(rows)} rows; PIPS real pairs "
            f"{pips['real_pairs']}, checked {pips['checked_pairs']} ({smi})")

        check(cli.main(argv + ["-partbegin:2", first, "-dirout", again]) == 0,
              "the restarted CLI run failed")
        rparts = read_parts(PD, again, n, rho0)
        check(sorted(rparts) == [2, 3, 4], f"restart PARTs {sorted(rparts)}")
        with open(os.path.join(again, "SaveDt.csv")) as f:
            t_first = float(f.read().splitlines()[1].split(";")[1])
        t_part = float(np.float32(parts[2]["timestep"]))
        check(abs(t_first - t_part) <= 1e-6 * t_part, f"the restart's first "
              f"step ran at t {t_first}, not at its PART's {t_part}")
        a, b = parts[4], rparts[4]
        pa = a["pos"][np.argsort(a["idp"])]
        pb = b["pos"][np.argsort(b["idp"])]
        dev = float(np.abs(pa - pb).max())
        check(dev < 0.25 * DP_BENCH, f"restart Part_0004 {dev} m from the "
              f"first run's (0.25 dp = {0.25 * DP_BENCH} m)")
        say("cli", f"-partbegin:2: Part_0002-0004, the first step at the "
            f"PART's t {t_first:.7e} s (the ramp goes on), Part_0004 within "
            f"{dev:.3e} m of the first run's by id (0.25 dp = "
            f"{0.25 * DP_BENCH:.3e} m), {rparts[4]['nstep']} steps after the "
            f"restart")

        # the same under -verlet, without the DDT ramp (a leapfrog with
        # the ramp's DDT of 0.3 leaves +-10% in ~25 steps from rest, and
        # loses 15k particles by 3 ms): the restart's M1 state is its PART's
        vfirst, vagain = (os.path.join(root, "verlet"),
                          os.path.join(root, "verlet_again"))
        vargv = [a for a in argv if not a.startswith("-ddtramp")] \
            + ["-verlet"]
        check(cli.main(vargv + ["-dirout", vfirst]) == 0,
              "the -verlet CLI run failed")
        check(cli.main(vargv + ["-partbegin:2", vfirst, "-dirout", vagain])
              == 0, "the restarted -verlet CLI run failed")
        a = read_parts(PD, vfirst, n, rho0)[4]
        b = read_parts(PD, vagain, n, rho0)[4]
        oa, ob = np.argsort(a["idp"]), np.argsort(b["idp"])
        dev = float(np.abs(a["pos"][oa] - b["pos"][ob]).max())
        dvel = float(np.abs(a["vel"][oa] - b["vel"][ob]).max())
        vmax = float(np.abs(a["vel"]).max())
        check(dev < 0.25 * DP_BENCH, f"-verlet restart Part_0004 {dev} m "
              f"from the first run's (0.25 dp = {0.25 * DP_BENCH} m)")
        say("cli", f"-verlet, then -partbegin:2: Part_0004 within {dev:.3e} m "
            f"(0.25 dp = {0.25 * DP_BENCH:.3e} m) and {dvel:.3e} m/s of the "
            f"uninterrupted run's by id (max|vel| {vmax:.3e} m/s), "
            f"{a['nstep']} and {b['nstep']} steps, PARTs read back (fluid rho "
            f"within 10%)")

        # -verlet with the ramp from rest to 2.4 ms, printed and not held
        # to the density gate: the leapfrog swings the density out of
        # +-10% under the ramp's 0.3, in the JAX package as in the port
        # (test_torch_runloop.py::test_verlet_under_a_strong_ddt_leaves_rest_as_jax_does)
        vramp = os.path.join(root, "verlet_ramp")
        check(cli.main(vargv + [f"-ddtramp:{CLI_RAMP}", "-tmax:0.0024",
                                "-tout:0.0006", "-dirout", vramp]) == 0,
              "the -verlet -ddtramp CLI run failed")
        rows = []
        for k in range(5):
            d = PD.read_part(os.path.join(vramp, PD.part_filename(k)))
            fl = td.code_type(d["code"].astype(np.int64)) == td.TYPE_FLUID
            r = d["rhop"][fl]
            rows.append(f"{d['timestep'] * 1e3:.1f} ms step {d['nstep']} "
                        f"[{r.min():.1f}, {r.max():.1f}] {len(d['idp'])} live")
        say("cli", f"-verlet -ddtramp:{CLI_RAMP} from rest, fluid rho: "
            + "; ".join(rows))

        sim = Simulation(case.csp, SolverOpts(tdensity=TpDensity.FOURTAKAS),
                         case.dom, flowing_state(case, device))
        sim.carry = sim.advance(sim.carry, float("inf"), 5)
        saves = os.path.join(root, "saves")
        binx, nbytes = save_ms(sim, os.path.join(saves, "binx"), 5)
        vtk, vtk_bytes = save_ms(sim, os.path.join(saves, "vtk"), 1,
                                 save_vtk=True)
        check(nbytes == vtk_bytes > 0, f"a save copied {nbytes} bytes, with "
              f"VTK {vtk_bytes}: each array once")
        say("cli", f"one PART save at {n} particles (the state in cell "
            f"order, {nbytes} bytes copied from the device, "
            f"{nbytes / n:g} per particle): binx {binx:.3f} ms (median of "
            f"5), binx,vtk {vtk:.3f} ms (once, {vtk_bytes} bytes), host "
            f"clock ({smi})")
        return launched["cellforce"]
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 24: the dam break of CaseDambreak_Def.xml, the three boxes of
# cases.dambreak3d(obstacle=True), at the dp of DP_BENCH
DAMBREAK_XML = """<?xml version="1.0"?>
<case><casedef>
 <constantsdef>
  <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/>
  <hswl value="0.3" auto="false"/><gamma value="7"/>
  <speedsystem value="0" auto="true"/><coefsound value="20"/>
  <speedsound value="0" auto="true"/><coefh value="1.0"/>
  <cflnumber value="0.2"/>
 </constantsdef>
 <geometry>
  <definition dp="{dp!r}">
   <pointmin x="-0.05" y="-0.05" z="-0.05"/><pointmax x="2" y="1" z="1"/>
  </definition>
  <commands><mainlist>
   <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
    <point x="0" y="0" z="0"/><size x="0.4" y="0.67" z="0.3"/></drawbox>
   <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right|front|back</boxfill>
    <point x="0" y="0" z="0"/><size x="1.6" y="0.67" z="0.4"/></drawbox>
   <setmkbound mk="1"/><drawbox><boxfill>top|left|right|front|back</boxfill>
    <point x="0.9" y="0.24" z="0"/><size x="0.12" y="0.12" z="0.45"/></drawbox>
  </mainlist></commands>
 </geometry>
</casedef>
<execution>
 <parameters>
  <parameter key="StepAlgorithm" value="2"/><parameter key="Kernel" value="2"/>
  <parameter key="ViscoTreatment" value="1"/><parameter key="Visco" value="0.1"/>
  <parameter key="DensityDT" value="2"/>
  <parameter key="TimeMax" value="{tmax!r}"/><parameter key="TimeOut" value="{tout!r}"/>
 </parameters>
 <simulationdomain><posmin x="default" y="default" z="default"/>
  <posmax x="default" y="default" z="default + 100%"/></simulationdomain>
</execution>
</case>
"""
XML_TOUT = 0.0012     # phase 24: 3 intervals of 1.2 ms (~50 steps)
# phase 25: the 2D wet dam break of wet_dambreak_nn (01_WetDambreak): a
# water layer, the mud column over it, the tank; the two phases
NN_XML = """<?xml version="1.0"?>
<case><casedef>
 <constantsdef>
  <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/>
  <hswl value="0.3" auto="false"/><gamma value="7"/>
  <speedsystem value="0" auto="true"/><coefsound value="20"/>
  <speedsound value="0" auto="true"/><coefh value="1.0"/>
  <cflnumber value="0.2"/>
 </constantsdef>
 <geometry>
  <definition dp="{dp!r}">
   <pointmin x="-0.05" y="0" z="-0.05"/><pointmax x="2.1" y="0" z="1.1"/>
  </definition>
  <commands><mainlist>
   <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
    <point x="0" y="0" z="0"/><size x="2" y="0" z="0.15"/></drawbox>
   <setmkfluid mk="1"/><drawbox><boxfill>solid</boxfill>
    <point x="0" y="0" z="0"/><size x="0.5" y="0" z="0.3"/></drawbox>
   <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right</boxfill>
    <point x="0" y="0" z="0"/><size x="2" y="0" z="1"/></drawbox>
  </mainlist></commands>
 </geometry>
</casedef>
<execution>
 <special>
  <nnphases>
   <phase mkfluid="0"><rhop value="1000"/><csound value="{cs_w!r}"/>
    <visco value="0.05"/><tau_yield value="0.0005"/><HBP_m value="0"/>
    <HBP_n value="1"/></phase>
   <phase mkfluid="1"><rhop value="1500"/><csound value="{cs_m!r}"/>
    <visco value="0.1"/><tau_yield value="0.001"/><HBP_m value="10"/>
    <HBP_n value="1"/></phase>
  </nnphases>
 </special>
 <parameters>
  <parameter key="StepAlgorithm" value="2"/><parameter key="Kernel" value="2"/>
  <parameter key="ViscoTreatment" value="2"/><parameter key="DensityDT" value="2"/>
  <parameter key="VelocityGradientType" value="{velgrad}"/>
  <parameter key="TimeMax" value="{tmax!r}"/><parameter key="TimeOut" value="{tout!r}"/>
 </parameters>
</execution>
</case>
"""
NN_XML_TOUT = 2e-4    # phase 25: 3 intervals of 0.2 ms (~25 steps)


def xml_dambreak_path(device, smi):
    """Phase 24: the dam break's XML through ``load_case`` (timed on the
    host) and through ``cli.main`` with ``-case``, as ``python -m
    dualsphysics_multilayer_tpu_torch.cli -case`` runs it: its particles
    against ``cases.dambreak3d``'s, PARTs 0-3 read back, cellforce twice
    per step; then 5 + 20 steps of the loaded case for the step's p50.
    Returns (the cellforce launches of the CLI run, (t, the fluid front x)
    of its last PART)."""
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    root = tempfile.mkdtemp(prefix="_smoke_xml_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        path = os.path.join(root, "Dambreak_Def.xml")
        with open(path, "w") as f:
            f.write(DAMBREAK_XML.format(dp=DP_BENCH, tmax=3 * XML_TOUT,
                                        tout=XML_TOUT))
        t0 = time.perf_counter()
        case, opts, _run = load_case(path, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ref = cases.dambreak3d(dp=DP_BENCH, obstacle=True, device=device)
        n = case.np_total

        def rows(st):
            r = np.column_stack([st.pos.cpu().numpy(),
                                 st.code.cpu().numpy()])
            return r[np.lexsort(r.T[::-1])]

        same = n == ref.np_total and np.array_equal(rows(case.state),
                                                    rows(ref.state))
        if not same:
            a, b = rows(case.state), rows(ref.state)
            extra = len({tuple(x) for x in a} - {tuple(x) for x in b})
            missing = len({tuple(x) for x in b} - {tuple(x) for x in a})
            say("xml-dambreak", f"{n} particles against the builtin's "
                f"{ref.np_total}: {extra} not in the builtin, {missing} of "
                f"the builtin's missing")
        check(same, "the XML dam break's particles differ from "
              "cases.dambreak3d's")
        out = os.path.join(root, "out")
        reset_counts()
        t0 = time.perf_counter()
        check(cli.main(["-case", path, "-sv:binx", "-nortimes",
                        "-dirout", out]) == 0, "the -case run failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        parts = read_parts(PD, out, n, case.csp.rhopzero)
        check(sorted(parts) == [0, 1, 2, 3], f"PARTs {sorted(parts)}")
        nsteps = parts[3]["nstep"]
        single_phase_counts(launched, "cellforce", 2, nsteps)
        step = make_step(case.csp, opts, case.dom)
        _carry, times, _ = run_steps(
            step, make_carry(case.state, case.csp, opts, case.dom), 5, 20)
        p50 = statistics.median(times)
        say("xml-dambreak", f"-case with the dam break's three boxes at dp "
            f"{DP_BENCH:.6g}: {n} particles, the builtin's {ref.np_total} "
            f"(sorted positions and codes equal); load_case {load_s:.3f} s "
            f"on the host; the CLI run {nsteps} steps and 4 PARTs in "
            f"{wall:.3f} s ({launched['cellforce']} cellforce launches), all "
            f"read back (fluid rho within 10%); 20 steps from rest after 5: "
            f"p50 {p50 * 1e3:.3f} ms ({smi})")
        return launched["cellforce"], (parts[3]["timestep"],
                                       fluid_front(parts[3]))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def xml_nn_path(device, smi):
    """Phase 25: the NN wet dam break's XML through ``cli.main`` with
    ``-case``, once with VelocityGradientType=2 (SPH: nnforce_p1 and
    nnforce_p3 twice per step) and once with 1 (FDA: nnforce_fda twice per
    step): PARTs 0-3 of each read back, each phase's fluid density within
    10% of its rest density.  Returns {path: {kernel: launches}}."""
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    _case, phases = NM.wet_dambreak_nn(dp=NN_DP, device=device)
    root = tempfile.mkdtemp(prefix="_smoke_xmlnn_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    out = {}
    try:
        for velgrad, label, kernels in ((2, "SPH", ("nnforce_p1", "nnforce_p3")),
                                        (1, "FDA", ("nnforce_fda",))):
            path = os.path.join(root, f"WetDambreak{label}_Def.xml")
            with open(path, "w") as f:
                f.write(NN_XML.format(
                    dp=NN_DP, cs_w=phases.phases[0].csound,
                    cs_m=phases.phases[1].csound, velgrad=velgrad,
                    tmax=3 * NN_XML_TOUT, tout=NN_XML_TOUT))
            t0 = time.perf_counter()
            case, _opts, _run = load_case(path, device=device)
            load_s = time.perf_counter() - t0
            n = case.np_total
            check(case.meta["phases"] == phases, f"phases {case.meta['phases']}"
                  f" against wet_dambreak_nn's {phases}")
            d = os.path.join(root, label)
            reset_counts()
            t0 = time.perf_counter()
            check(cli.main(["-case", path, "-sv:binx", "-nortimes",
                            "-dirout", d]) == 0, f"the {label} -case run failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = counts()
            parts = {}
            for k in range(4):
                p = PD.read_part(os.path.join(d, PD.part_filename(k)))
                check(np.array_equal(np.sort(p["idp"]), np.arange(n)),
                      f"{label} Part_{k:04d}: ids not the case's")
                check(bool(np.isfinite(p["pos"]).all()),
                      f"{label} Part_{k:04d}: Posd not finite")
                parts[k] = p
            ranges = []
            code = parts[3]["code"].astype(np.int64)
            fluid = (code >> 16) & 3 == 3
            for i, ph in enumerate(phases.phases):
                r = parts[3]["rhop"][fluid & ((code & 0xFFFF) == i)]
                check(r.size > 0 and 0.9 * ph.rho0 <= r.min()
                      and r.max() <= 1.1 * ph.rho0, f"{label} phase {i} "
                      f"density out of +-10% of {ph.rho0}")
                ranges.append((float(r.min()), float(r.max())))
            nsteps = parts[3]["nstep"]
            want = {**dict.fromkeys(launched, 0),
                    **{k: 2 * nsteps for k in kernels}}
            check(launched == want, f"{label}: {launched} in {nsteps} steps, "
                  f"expected {kernels} twice per step and no other kernel")
            out[f"xml-nn-{label.lower()}"] = {k: launched[k] for k in kernels}
            say("xml-nn", f"-case {label} (VelocityGradientType={velgrad}), "
                f"{n} particles (wet_dambreak_nn's {_case.np_total}), "
                f"load_case {load_s:.3f} s: {nsteps} steps and 4 PARTs in "
                f"{wall:.3f} s, launches {launched}; PARTs read back, phase "
                + ", ".join(f"{i} rho [{a:.2f}, {b:.2f}]"
                            for i, (a, b) in enumerate(ranges)) + f" ({smi})")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 26: the dam break of phase 24 cut at its tank's mid-plane (y =
# 0.335 m), which moves to y = 0 under Symmetry=1: the tank without its
# front wall, the fluid column from the plane on, and the obstacle (0.12 m
# wide, 0.035 m off the mid-plane in the full case) as a half of 0.06 m
# centred on the plane
HALF_XML = DAMBREAK_XML.replace(
    '<pointmax x="2" y="1" z="1"/>', '<pointmax x="2" y="0.5" z="1"/>').replace(
    '<size x="0.4" y="0.67" z="0.3"/>', '<size x="0.4" y="0.335" z="0.3"/>').replace(
    '<boxfill>bottom|left|right|front|back</boxfill>\n'
    '    <point x="0" y="0" z="0"/><size x="1.6" y="0.67" z="0.4"/>',
    '<boxfill>bottom|left|right|back</boxfill>\n'
    '    <point x="0" y="0" z="0"/><size x="1.6" y="0.335" z="0.4"/>').replace(
    '<boxfill>top|left|right|front|back</boxfill>\n'
    '    <point x="0.9" y="0.24" z="0"/><size x="0.12" y="0.12" z="0.45"/>',
    '<boxfill>top|left|right|back</boxfill>\n'
    '    <point x="0.9" y="0" z="0"/><size x="0.12" y="0.06" z="0.45"/>').replace(
    '<parameter key="DensityDT" value="2"/>',
    '<parameter key="DensityDT" value="2"/>'
    '<parameter key="Symmetry" value="1"/>')
# phase 27: the faces of phase 24's tank (mk 0) and obstacle (mk 1):
# (mk, axis, the box's limits along it, which limit, the normal's sign
# into the fluid)
DAMBREAK_FACES = (
    (0, "z", (0.0, 0.4), 0, 1), (0, "x", (0.0, 1.6), 0, 1),
    (0, "x", (0.0, 1.6), 1, -1), (0, "y", (0.0, 0.67), 0, 1),
    (0, "y", (0.0, 0.67), 1, -1), (1, "z", (0.0, 0.45), 1, 1),
    (1, "x", (0.9, 1.02), 0, -1), (1, "x", (0.9, 1.02), 1, 1),
    (1, "y", (0.24, 0.36), 0, -1), (1, "y", (0.24, 0.36), 1, 1))


def init_xml(dp):
    """Phase 27's case: phase 24's dam break with an ``<initialize>`` of a
    linear fluid velocity profile along x and one ``<boundnormal_plane>``
    per wall face (the tank is one mk), each restricted by ``onlypos`` to
    its face's layer of the dp lattice, its plane half a dp into the fluid
    (``point auto``)."""
    ops = []
    for mk, axis, (lo, hi), end, sign in DAMBREAK_FACES:
        c = (math.floor(hi / dp + 1e-6) if end else math.ceil(lo / dp - 1e-6)) * dp
        normal = " ".join(f'{a}="{sign if a == axis else 0}"' for a in "xyz")
        ops.append(f'<boundnormal_plane mkbound="{mk}"><point auto="true"/>'
                   f'<normal {normal}/><onlypos><posmin {axis}="{c - dp / 2!r}"/>'
                   f'<posmax {axis}="{c + dp / 2!r}"/></onlypos>'
                   f'</boundnormal_plane>')
    special = ("""<special><initialize>
  <fluidvelocity mkfluid="0"><direction x="1" y="0" z="0"/>
   <velocity2 v="0" v2="0.5" z="0" z2="0.3"/></fluidvelocity>
  """ + "\n  ".join(ops) + """
 </initialize></special>
 <parameters>""").replace("{", "{{").replace("}", "}}")
    return DAMBREAK_XML.replace(" <parameters>", " " + special)
INIT_PLANE = ("mkbound=0:normal=0:0:1:point=auto", """<initialize>
 <boundnormal_plane mkbound="0"><point auto="true"/><normal x="0" y="0" z="1"/>
 </boundnormal_plane></initialize>""")
# phase 28: the NN wet dam break of phase 25 with its tank's normals from
# <initialize>
NN_INIT_XML = NN_XML.replace(" <special>", """ <special>
  <initialize><boundnormal_parts mkbound="0"/></initialize>""")


def recording_simulations():
    """(restore, made): ``wcsph.Simulation`` replaced by a subclass that
    keeps (state, opts, csp, dom) of every simulation built, as the CLI
    builds it;
    ``restore()`` puts the class back."""
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    made, original = [], W.Simulation

    class Recorded(original):
        def __init__(self, csp, opts, dom, st, *a, **k):
            super().__init__(csp, opts, dom, st, *a, **k)
            made.append((st, opts, csp, dom))

    W.Simulation = Recorded
    return (lambda: setattr(W, "Simulation", original)), made


def counted_prepass():
    """(restore, calls): ``mdbc.mdbc_correction`` counted."""
    from dualsphysics_multilayer_tpu_torch.ops import mdbc as MD
    calls, original = [0], MD.mdbc_correction

    def counted(*a, **k):
        calls[0] += 1
        return original(*a, **k)

    MD.mdbc_correction = counted
    return (lambda: setattr(MD, "mdbc_correction", original)), calls


def image_pairs(csp, dom, cells, pos, code):
    """In-support pairs of fluid-side targets with the candidates' mirror
    images in the plane y = 0 (targets with y <= kernelsize, the target's
    own image included): the pair work the symmetry plane adds."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.ops import forces as F
    live = td.is_active(code) & (cells.cell < dom.ncells)
    fluidside = td.code_type(code) >= td.TYPE_FLOATING
    total = 0
    for t, j, valid in F.candidate_chunks(dom, cells, live, 1 << 22):
        dr = pos[t, None, :] - pos[j]
        dr[..., 1] = pos[t, None, 1] + pos[j, 1]
        rr2 = (dr * dr).sum(dim=-1)
        near = (pos[t, 1] <= csp.kernelsize) & fluidside[t]
        total += int((valid & live[j] & near[:, None] & (rr2 >= td.ALMOSTZERO)
                      & (rr2 < csp.kernelsize2)).sum())
    return total


def fluid_front(part):
    """The largest x of the fluid in a PART."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    fluid = td.code_type(part["code"].astype(np.int64)) == td.TYPE_FLUID
    return float(part["pos"][fluid, 0].max())


def symmetry_path(device, registers, full_front, smi):
    """Phase 26: half of phase 24's dam break under Symmetry=1 through
    ``cli.main(["-case", ...])``: PARTs read back, cellforce's SYM instance
    twice per step and no other kernel, the fluid front against the full
    case's (``full_front``: (t, x) of phase 24's last PART), not gated;
    5 + 20 steps from rest for the p50; then each SYM instance (Wendland,
    cubic, each with and without NO_FIXED shifting) against the plain
    mirror pass on a flowing state, with its bound, and 10 steps of each
    from there.  Returns {instance: record}."""
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpDensity,
                                                   TpKernel, TpShifting)
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    root = tempfile.mkdtemp(prefix="_smoke_xmlsym_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        path = os.path.join(root, "DambreakHalf_Def.xml")
        with open(path, "w") as f:
            f.write(HALF_XML.format(dp=DP_BENCH, tmax=3 * XML_TOUT,
                                    tout=XML_TOUT))
        t0 = time.perf_counter()
        case, opts, _run = load_case(path, device=device)
        load_s = time.perf_counter() - t0
        n = case.np_total
        check(opts.symmetry and opts.tdensity == TpDensity.FOURTAKAS,
              f"the half case's options {opts}")
        ymin = float(case.state.pos[:, 1].min())
        check(ymin >= 0.0, f"a particle at y = {ymin} < 0")
        out = os.path.join(root, "out")
        reset_counts()
        t0 = time.perf_counter()
        check(cli.main(["-case", path, "-sv:binx", "-nortimes",
                        "-dirout", out]) == 0, "the symmetry -case run failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        parts = read_parts(PD, out, n, case.csp.rhopzero)
        check(sorted(parts) == [0, 1, 2, 3], f"PARTs {sorted(parts)}")
        nsteps = parts[3]["nstep"]
        single_phase_counts(launched, "cellforce_sym", 2, nsteps)
        front = fluid_front(parts[3])
        tfull, xfull = full_front
        step = make_step(case.csp, opts, case.dom)
        _carry, times, rest = run_steps(
            step, make_carry(case.state, case.csp, opts, case.dom), 5, 20)
        single_phase_counts(rest, "cellforce_sym", 2, 25)
        p50 = statistics.median(times)
        say("symmetry", f"-case with Symmetry=1, half of phase 24's dam break "
            f"at dp {DP_BENCH:.6g}: {n} particles ({n / 267469:.4f} of the "
            f"full case's 267,469), load_case {load_s:.3f} s on the host; the "
            f"CLI run {nsteps} steps and 4 PARTs in {wall:.3f} s, launches "
            f"{ {k: v for k, v in launched.items() if v} }, all read back "
            f"(fluid rho within 10%); fluid front x {front:.6f} m at t "
            f"{parts[3]['timestep']:.6f} s, the full case's {xfull:.6f} m at "
            f"t {tfull:.6f} s (not gated); 20 steps from rest after 5: p50 "
            f"{p50 * 1e3:.3f} ms, cellforce_sym {rest['cellforce_sym']} "
            f"launches ({smi})")

        # the SYM instances against the plain mirror pass
        st = flowing_state(case, device, seed=5)
        cells, args = sorted_args(case.dom, st.pos, st.vel, st.rho, st.code)
        cand, pairs = pair_counts(case.csp, case.dom, cells, args[0], args[3],
                                  inclusive=False)
        images = image_pairs(case.csp, case.dom, cells, args[0], args[3])
        near = int((args[0][:, 1] <= case.csp.kernelsize).sum())
        records = {}
        nofixed = TpShifting.NO_FIXED
        for label, ker, shift in (("wendland", TpKernel.WENDLAND, TpShifting.NONE),
                                  ("wendland+shift", TpKernel.WENDLAND, nofixed),
                                  ("cubic", TpKernel.CUBIC, TpShifting.NONE),
                                  ("cubic+shift", TpKernel.CUBIC, nofixed)):
            csp = case.csp.replace(tkernel=ker)
            o = SolverOpts(tdensity=TpDensity.FOURTAKAS, symmetry=True,
                           shiftmode=shift)
            name = CF.kernel_name(csp, o)
            err, ms, wrapped_ms, plain_ms = compare_cellforce(
                csp, o, case.dom, cells, args, reps=5)
            # the instance without the plane, alone on the same state
            pospress, velrho, kind = CF.channels(csp, *args)
            flat = dataclasses.replace(o, symmetry=False)
            outs = [torch.empty((n, 3), device=device)] + [
                torch.empty(n, device=device) for _ in range(2)] + [None] + (
                [torch.empty((n, 4), device=device),
                 torch.empty(n, dtype=torch.bool, device=device)]
                if shift != TpShifting.NONE else [None, None])
            flat_ms = launch_ms(bare_launcher(
                "cellforce", f"dsph_{name}",
                CF.make_params(csp, flat, case.dom, n),
                [pospress, velrho, kind, cells.cell, cells.begin, None, None]
                + outs))
            b = bound(cellforce_bytes(n, case.dom.ncells, o),
                      (pairs + images) * ops_per_pair(name, o))
            instance = (f"cellforce_kernel<{ker.value},1,"
                        f"{int(shift != TpShifting.NONE)},0,1>")
            step = make_step(csp, o, case.dom)
            carry, _times, ran = run_steps(
                step, make_carry(st, csp, o, case.dom), 0, 10)
            check_state(carry, 10, None)
            single_phase_counts(ran, CF.counter_name(csp, o), 2, 10)
            launches = (launched["cellforce_sym"] + rest["cellforce_sym"]
                        if label == "wendland" else 0) + ran[CF.counter_name(csp, o)]
            records[instance] = dict(
                kernel=name, variant=f"symmetry {label}", launches=launches,
                max_abs_err=err["ace"], ms=ms, plain_ms=plain_ms,
                bound_ms=b[0], bound_by=b[1], flat_ms=flat_ms)
            say("symmetry-vs-plain", f"{label}, {n} particles ({near} within "
                f"the kernel size of the plane): max|d| "
                + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                + f"; kernel alone {ms:.3f} ms (the instance without the plane "
                f"{flat_ms:.3f} ms), with its wrapper "
                f"{wrapped_ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events); "
                f"{cand} candidates, {pairs} in-support pairs with a "
                f"fluid-side target plus {images} with images; bound "
                f"{b[0] * 1e3:.2f} us by {b[1]}; {instance}: "
                f"{registers.get(instance, '?')}; 10 steps from there: "
                f"{ran[CF.counter_name(csp, o)]} launches, {launches} on "
                f"phase 26 ({smi})")
        return records
    finally:
        shutil.rmtree(root, ignore_errors=True)


def initialize_path(device, smi):
    """Phase 27: phase 24's dam break with ``<initialize>`` (a linear fluid
    velocity profile, the walls' normals from a plane per face) through
    ``cli.main(["-case", ...])``: mDBC walls with their normals, cellforce
    and the mDBC pre-pass twice per step, PARTs read back; then ``dsphtorch
    -builtin dambreak2d -mdbc -initnorpla:...`` at phase 14's size, whose
    normals must equal those of the same plane in an ``<initialize>``
    node.  Returns {path: cellforce launches}."""
    import shutil
    import tempfile
    import xml.etree.ElementTree as ET
    from dualsphysics_multilayer_tpu_torch import TpBoundary
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch.features import initialize as INI
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.ops import mdbc as MD
    root = tempfile.mkdtemp(prefix="_smoke_xmlinit_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    out = {}
    try:
        path = os.path.join(root, "DambreakInit_Def.xml")
        with open(path, "w") as f:
            f.write(init_xml(DP_BENCH).format(dp=DP_BENCH, tmax=3 * XML_TOUT,
                                              tout=XML_TOUT))
        restore_sim, made = recording_simulations()
        restore_pre, prepasses = counted_prepass()
        reset_counts()
        t0 = time.perf_counter()
        try:
            check(cli.main(["-case", path, "-sv:binx", "-nortimes", "-dirout",
                            os.path.join(root, "out")]) == 0,
                  "the <initialize> -case run failed")
            torch.cuda.synchronize()
        finally:
            restore_sim()
            restore_pre()
        wall = time.perf_counter() - t0
        launched = counts()
        st, opts, csp, dom = made[0]
        n = st.n
        check(opts.tboundary == TpBoundary.MDBC and st.boundnormal is not None,
              f"tboundary {opts.tboundary}, normals {st.boundnormal is not None}")
        walls = td.is_bound(st.code)
        nrm = st.boundnormal.norm(dim=1)
        with_normal = int((nrm[walls] > 0).sum())
        check(with_normal == int(walls.sum()),
              f"{int(walls.sum()) - with_normal} walls without a normal")
        fluid = td.is_fluid(st.code)
        vx = st.vel[fluid, 0]
        check(float(vx.min()) >= -1e-6 and float(vx.max()) <= 0.5 + 1e-6
              and float(vx.max()) > 0.4, f"fluid vx [{float(vx.min())}, "
              f"{float(vx.max())}] outside the profile's [0, 0.5]")
        parts = read_parts(PD, os.path.join(root, "out"), n, 1000.0)
        check(sorted(parts) == [0, 1, 2, 3], f"PARTs {sorted(parts)}")
        nsteps = parts[3]["nstep"]
        single_phase_counts(launched, "cellforce", 2, nsteps)
        check(prepasses[0] == 2 * nsteps,
              f"{prepasses[0]} mDBC pre-passes in {nsteps} steps")
        wr = parts[3]["rhop"][(parts[3]["code"].astype(np.int64) >> 16) & 3 < 2]
        check(900.0 <= wr.min() and wr.max() <= 1100.0,
              f"wall density [{wr.min()}, {wr.max()}] out of +-10% of rho0")
        out["initialize"] = launched["cellforce"]
        # the pre-pass alone on the run's first state (torch ops, as in
        # phase 14)
        cells, args = sorted_args(dom, st.pos, st.vel, st.rho, st.code)
        order = cells.order
        run = (csp, opts, dom, cells, *args, st.boundnormal[order],
               None if st.motionvel is None else st.motionvel[order])
        prepass_ms = cuda_ms(lambda: MD.mdbc_correction(*run), reps=3)
        say("initialize", f"-case with <initialize> (linear fluidvelocity, "
            f"a boundnormal_plane per face of mk 0 and 1), {n} particles, "
            f"{with_normal} "
            f"walls with normals (|n| {float(nrm[walls].min()):.4g}-"
            f"{float(nrm[walls].max()):.4g} m), tboundary {opts.tboundary.name}, "
            f"fluid vx [{float(vx.min()):.3f}, {float(vx.max()):.3f}] m/s: "
            f"{nsteps} steps and 4 PARTs in {wall:.3f} s (load and normals "
            f"included), launches { {k: v for k, v in launched.items() if v} }, "
            f"{prepasses[0]} mDBC pre-passes; PARTs read back, wall rho "
            f"[{wr.min():.2f}, {wr.max():.2f}]; the pre-pass alone "
            f"{prepass_ms:.3f} ms on the first state (CUDA events, median of "
            f"3; torch ops) ({smi})")

        # -initnorpla on the builtin 2D dam break against <initialize>
        spec, node = INIT_PLANE
        restore_sim, made = recording_simulations()
        restore_pre, prepasses = counted_prepass()
        reset_counts()
        try:
            check(cli.main(["-builtin", "dambreak2d", "-dp", repr(DP_2D),
                            "-mdbc", f"-initnorpla:{spec}", "-tmax:0.002",
                            "-tout:0.001", "-sv:binx", "-nortimes", "-dirout",
                            os.path.join(root, "out2d")]) == 0,
                  "the -initnorpla run failed")
            torch.cuda.synchronize()
        finally:
            restore_sim()
            restore_pre()
        launched = counts()
        st, opts = made[0][:2]
        case = cases.dambreak2d(dp=DP_2D, mdbc=True, device=device)
        want = INI.apply_initialize(INI.parse_initialize_xml(ET.fromstring(node)),
                                    case.csp, case.state)
        check(opts.tboundary == TpBoundary.MDBC, f"tboundary {opts.tboundary}")
        check(torch.equal(st.boundnormal, want.boundnormal),
              "-initnorpla's normals differ from <initialize>'s")
        changed = int((want.boundnormal != case.state.boundnormal).any(dim=1).sum())
        check(changed > 0, "the plane changed no normal")
        parts = read_parts(PD, os.path.join(root, "out2d"), st.n, 1000.0)
        nsteps = parts[max(parts)]["nstep"]
        single_phase_counts(launched, "cellforce", 2, nsteps)
        check(prepasses[0] == 2 * nsteps,
              f"{prepasses[0]} mDBC pre-passes in {nsteps} steps")
        out["initnorpla"] = launched["cellforce"]
        say("initialize", f"-builtin dambreak2d -mdbc -initnorpla:{spec}, "
            f"{st.n} particles: normals equal to the same plane's in "
            f"<initialize> ({changed} walls changed from the drawn faces'), "
            f"{nsteps} steps, {launched['cellforce']} cellforce launches, "
            f"{prepasses[0]} mDBC pre-passes ({smi})")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def nn_mdbc_path(device, registers, smi):
    """Phase 28: the NN wet dam break of phase 25 with its tank's normals
    from ``<initialize>``, through ``cli.main(["-case", ...])``: SPH
    (nnforce_p1 and nnforce_p3) and FDA (nnforce_fda), each under the
    case's Fourtakas diffusion and under ``-ddt:1`` (Molteni, whose wall
    rule mDBC changes); then kernels 4 and 6 under mDBC walls with Molteni
    against their plain versions, and each timed alone under DBC and mDBC
    walls.  Returns ({path: {kernel: launches}}, {instance: record})."""
    import contextlib
    import io
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpBoundary,
                                                   TpDensity, TpVelGrad,
                                                   TpVisco)
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
    from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
    _case, phases = NM.wet_dambreak_nn(dp=NN_DP, device=device)
    root = tempfile.mkdtemp(prefix="_smoke_xmlnnmdbc_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    out = {}
    try:
        for velgrad, label, kernels in ((2, "SPH", ("nnforce_p1", "nnforce_p3")),
                                        (1, "FDA", ("nnforce_fda",))):
            path = os.path.join(root, f"WetDambreakInit{label}_Def.xml")
            with open(path, "w") as f:
                f.write(NN_INIT_XML.format(
                    dp=NN_DP, cs_w=phases.phases[0].csound,
                    cs_m=phases.phases[1].csound, velgrad=velgrad,
                    tmax=3 * NN_XML_TOUT, tout=NN_XML_TOUT))
            for ddt in ("fourtakas", "molteni"):
                d = os.path.join(root, f"{label}-{ddt}")
                restore_sim, made = recording_simulations()
                reset_counts()
                text = io.StringIO()
                t0 = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(text):
                        rc = cli.main(["-case", path, "-sv:binx", "-nortimes",
                                       "-dirout", d]
                                      + (["-ddt:1"] if ddt == "molteni" else []))
                    torch.cuda.synchronize()
                finally:
                    restore_sim()
                print(text.getvalue(), end="", flush=True)
                check(rc == 0, f"the {label} {ddt} -case run failed")
                wall = time.perf_counter() - t0
                launched = counts()
                st, opts = made[0][:2]
                check(opts.tboundary == TpBoundary.MDBC
                      and st.boundnormal is not None
                      and opts.tdensity == (TpDensity.MOLTENI if ddt == "molteni"
                                            else TpDensity.FOURTAKAS),
                      f"{label} {ddt}: options {opts}")
                check(NM.MDBC_NOTE in text.getvalue(),
                      f"{label} {ddt}: the run did not say it runs no pre-pass")
                n = st.n
                p3 = PD.read_part(os.path.join(d, PD.part_filename(3)))
                check(np.array_equal(np.sort(p3["idp"]), np.arange(n))
                      and bool(np.isfinite(p3["pos"]).all()),
                      f"{label} {ddt}: Part_0003 ids or positions")
                code = p3["code"].astype(np.int64)
                fluid = (code >> 16) & 3 == 3
                ranges = []
                for i, ph in enumerate(phases.phases):
                    r = p3["rhop"][fluid & ((code & 0xFFFF) == i)]
                    check(r.size > 0 and 0.9 * ph.rho0 <= r.min()
                          and r.max() <= 1.1 * ph.rho0, f"{label} {ddt} phase "
                          f"{i} density out of +-10% of {ph.rho0}")
                    ranges.append((float(r.min()), float(r.max())))
                nsteps = p3["nstep"]
                want = {**dict.fromkeys(launched, 0),
                        **{k: 2 * nsteps for k in kernels}}
                check(launched == want, f"{label} {ddt}: {launched} in {nsteps} "
                      f"steps, expected {kernels} twice per step and no other")
                out[f"xml-nn-mdbc-{label.lower()}-{ddt}"] = {
                    k: launched[k] for k in kernels}
                say("nn-mdbc", f"-case {label} with <initialize> normals, "
                    f"{ddt} diffusion, {n} particles, mDBC walls without a "
                    f"pre-pass (said so): {nsteps} steps and 4 PARTs in "
                    f"{wall:.3f} s, launches "
                    f"{ {k: v for k, v in launched.items() if v} }; phase "
                    + ", ".join(f"{i} rho [{a:.2f}, {b:.2f}]"
                                for i, (a, b) in enumerate(ranges)) + f" ({smi})")

        # kernels 4 and 6 under mDBC walls (Molteni) against their plain
        # versions, and alone under DBC and mDBC walls
        case, _opts, _run = load_case(path, device=device)
        tb = phases.tables(case.csp, device)
        rho0 = tb["rho0"][torch.clamp(case.state.code & 0xFFFF, 0,
                                      phases.count - 1).long()]
        pos, vel, rho, code = perturbed_state(case, device, rho0, sim2d=True)
        cells, args = sorted_args(case.dom, pos, vel, rho, code)
        ch = NN.channels(case.csp, phases, tb, args[2], args[3])
        n = args[0].shape[0]
        rows = [torch.cat([args[0], ch.press[:, None]], dim=1).contiguous(),
                torch.cat([args[1], args[2][:, None]], dim=1).contiguous(),
                ch.kind, ch.phase, cells.cell, cells.begin]
        cand, pairs = pair_counts(case.csp, case.dom, cells, args[0], args[3],
                                  inclusive=True)
        state_bytes = n * (16 + 16 + 4 + 4 + 4) + (case.dom.ncells + 1) * 4
        records = {}
        for name, velgrad, outputs, out_bytes in (
                ("nnforce_p1", TpVelGrad.SPH, ("ace", "ar", "gradvel"), 44),
                ("nnforce_fda", TpVelGrad.FDA, ("ace", "ar", "etamax"), 24)):
            times, plain_ar = {}, {}
            for walls in (TpBoundary.MDBC, TpBoundary.DBC):
                o = SolverOpts(tvisco=TpVisco.LAMINAR_SPS, velgrad=velgrad,
                               tdensity=TpDensity.MOLTENI, tboundary=walls)
                run = (case.csp, o, phases, case.dom, cells, *args[:3], ch)
                got, want = NF.pass1(*run), NN.pass1_plain(*run)
                torch.cuda.synchronize()
                plain_ar[walls.name] = want.ar
                errs = {k: close(f"{name} {walls.name} {k}", getattr(got, k),
                                 getattr(want, k)) for k in outputs}
                outs = [torch.empty_like(got.ace), torch.empty_like(got.ar),
                        torch.empty_like(got.viscdt),
                        torch.empty_like(getattr(got, outputs[-1])), None, None]
                times[walls.name], same = nn_launch_ms(
                    name, NF.make_params(case.csp, o, phases, case.dom, n),
                    rows, outs)
                if walls == TpBoundary.MDBC:
                    plain_ms = cuda_ms(lambda: NN.pass1_plain(*run))
                    b = bound(state_bytes + n * out_bytes,
                              pairs * OPS_PER_PAIR[name])
                    instance = nn_instance(name, case.csp, o)
                    records[f"{instance} mdbc"] = dict(
                        kernel=name, variant="mdbc molteni",
                        max_abs_err=errs["ace"], ms=times["MDBC"],
                        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1])
                    say("nn-mdbc-vs-plain", f"{name} under mDBC walls, Molteni, "
                        f"{n} particles: max|d| " + ", ".join(
                            f"{k} {v:.3e}" for k, v in errs.items())
                        + f"{same}; plain {plain_ms:.3f} ms; bound "
                        f"{b[0] * 1e3:.2f} us by {b[1]}; {instance}: "
                        f"{registers.get(instance, '?')} ({smi})")
            changed = int((plain_ar["MDBC"] != plain_ar["DBC"]).sum())
            check(changed > 0, f"{name}: mDBC walls changed no target's ar")
            say("nn-mdbc-vs-plain", f"{name} alone, Molteni: {times['DBC']:.4f} "
                f"ms under DBC walls, {times['MDBC']:.4f} ms under mDBC walls "
                f"(CUDA events, median of 5 x 20 launches); the walls' rule "
                f"changes the continuity of {changed} targets ({smi})")
            records[f"{nn_instance(name, case.csp, o)} mdbc"]["dbc_ms"] = \
                times["DBC"]
        return out, records
    finally:
        shutil.rmtree(root, ignore_errors=True)


def count_d2h(step, carry, nsteps, tries=3):
    """(device-to-host copies per step, the carry) over ``nsteps`` steps
    traced with ``torch.profiler`` (CUDA activity); copies None when the
    trace holds no device activity.  Every step copies at least once (its
    ``_sync_flags``), so a trace with fewer copies than steps has dropped
    events: it is taken again over the next ``nsteps``, up to ``tries``
    traces, and the last one's count is returned."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(nsteps):
                carry = step(carry)
            torch.cuda.synchronize()
        ev = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if not ev:
            return None, carry
        copies = sum("DtoH" in name for name in ev)
        if copies >= nsteps:
            break
        say("profiler", f"a trace of {nsteps} steps held {copies} "
            f"device-to-host copies and {len(ev)} device events: dropped "
            f"events, traced again")
    return copies / nsteps, carry


def step_values_path(device, main_p50, smi):
    """Phase 23: kernels 1-3 against their plain versions under a step's
    DDT ramp and table viscosity at ~50k particles, and away from the
    constants' forces; then the main path with the ramp, a viscosity table
    and the SaveDt ring: launches, one device-to-host copy per step, and
    its p50 step beside the main path's; then that path with values equal
    to the constants' against the path without, stepped in alternation."""
    from dualsphysics_multilayer_tpu_torch import (Features, SolverOpts,
                                                   TpDensity, TpKernel,
                                                   TpVisco)
    from dualsphysics_multilayer_tpu_torch.features.viscoinput import ViscoInput
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (
        _record_dt as record_dt, make_carry, make_step, step_values)
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    case = cases.dambreak3d(dp=DP_50K, obstacle=True, need_sps=True,
                            device=device)
    pos, vel, rho, code = perturbed_state(case, device, case.csp.rhopzero)
    cells, args = sorted_args(case.dom, pos, vel, rho, code)
    n = args[0].shape[0]
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    spstau = torch.zeros((n, 6), dtype=torch.float32, device=device)
    for label, csp, o, tau in (
            ("cellforce", case.csp, opts, None),
            ("cellforce_cubic", case.csp.replace(tkernel=TpKernel.CUBIC), opts,
             None),
            ("cellforce_lamsps", lamsps_csp(DP_50K, 1e-2),
             dataclasses.replace(opts, tvisco=TpVisco.LAMINAR_SPS), spstau)):
        ddtkh, visco = 0.3 * csp.kernelsize, 6.0 * csp.visco
        err, ms, wrapped_ms, plain_ms = compare_cellforce(
            csp, o, case.dom, cells, args, reps=3, spstau=tau, ddtkh=ddtkh,
            visco=visco)
        run = (csp, o, case.dom, cells, *args, tau, None)
        over = CF.interaction_forces_cuda(*run, ddtkh=ddtkh, visco=visco)
        base = CF.interaction_forces_cuda(*run)
        moved = {}
        for k in ("ace", "ar"):
            w = getattr(over, k)
            moved[k] = float((w - getattr(base, k)).abs().max()
                             / w.abs().max())
            check(moved[k] > 10 * RTOL, f"{label}: the launch values moved "
                  f"{k} by {moved[k]:.3e} of its largest value only")
        say("step-values", f"{label}, {n} particles, ddtkh {ddtkh:.5g} and "
            f"visco {visco:.5g} for the constants' {csp.ddtkh:.5g} and "
            f"{csp.visco:.5g}: max|d| against plain " + ", ".join(
                f"{k} {v:.3e}" for k, v in err.items())
            + f"; away from the constants' forces by ace {moved['ace']:.3e}, "
            f"ar {moved['ar']:.3e} of their largest value; kernel alone "
            f"{ms:.3f} ms, with its wrapper {wrapped_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms ({smi})")

    # the main path with the ramp, a viscosity table and the SaveDt ring
    case = cases.dambreak3d(dp=DP_BENCH, obstacle=True, device=device)
    csp, n = case.csp, case.np_total
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, savedt=64,
                      ddtramp=(2e-3, 1e-3, 0.3))
    feats = Features(viscotime=ViscoInput((0.0, 2e-3, 4e-3),
                                          (0.1, 0.3, 0.05)))
    step = make_step(csp, opts, case.dom, feats)
    carry = make_carry(flowing_state(case, device), csp, opts, case.dom, feats)
    nrebuild0 = carry.nrebuild
    nwarm, nsteps = 5, 50
    carry, times, launched = run_steps(step, carry, nwarm, nsteps)
    single_phase_counts(launched, "cellforce", 2, nwarm + nsteps)
    check_state(carry, nwarm + nsteps, nrebuild0)
    rmin, rmax = fluid_rho_range(carry.st, True, csp.rhopzero)
    first = step_values(csp, opts, feats, 0.0)
    last = step_values(csp, opts, feats, carry.tabs_host)
    check(first != last, "the launch values did not change over the run")
    check(bool(torch.isfinite(carry.dthist).all())
          and int((carry.dthist[:, 1] > 0).sum()) == nwarm + nsteps,
          "the SaveDt ring does not hold one finite row per step")
    p50 = statistics.median(times)
    d2h, carry = count_d2h(step, carry, 10)
    check(d2h is not None, "the profiler's trace of 10 steps holds no device "
          "activity: device-to-host copies not counted")
    check(d2h == 1, f"{d2h} device-to-host copies per step, expected 1")
    note = f"{d2h:g} device-to-host copy per step over 10 traced steps"
    say("step-values", f"main path with -ddtramp and a viscosity table, {n} "
        f"particles, {nsteps} steps after {nwarm} warm-up: p50 step "
        f"{p50 * 1e3:.3f} ms (the main path's {main_p50 * 1e3:.3f} ms in this "
        f"call); {launched['cellforce']} cellforce launches, "
        f"{carry.nrebuild - nrebuild0} rebuilds; ddtkh {first[0]:.5g} -> "
        f"{last[0]:.5g}, visco {first[1]:.5g} -> {last[1]:.5g} at t "
        f"{carry.tabs_host:.6f} s; {note}; fluid rho [{rmin:.2f}, {rmax:.2f}] "
        f"({smi})")

    # the host cost of the step values and the SaveDt ring alone: a ramp
    # and a table that give the constants' values, so both paths run the
    # same flow, stepped in alternation from the same flowing start (the
    # order swapped every step), 5 warm-up and STEP_VALUES_PAIRS timed
    # steps each; then the two host calls alone
    plain_opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    same_opts = dataclasses.replace(opts, ddtramp=(2e-3, 1e-3, csp.ddtvalue))
    same_feats = Features(viscotime=ViscoInput((0.0, 4e-3),
                                               (csp.visco, csp.visco)))
    paths = {
        "without": [make_step(csp, plain_opts, case.dom),
                    make_carry(flowing_state(case, device), csp, plain_opts,
                               case.dom)],
        "with": [make_step(csp, same_opts, case.dom, same_feats),
                 make_carry(flowing_state(case, device), csp, same_opts,
                            case.dom, same_feats)]}
    times = {"without": [], "with": []}
    for k in range(5 + STEP_VALUES_PAIRS):
        for label in (("without", "with") if k % 2 else ("with", "without")):
            path = paths[label]
            t0 = time.perf_counter()
            path[1] = path[0](path[1])
            torch.cuda.synchronize()
            if k >= 5:
                times[label].append(time.perf_counter() - t0)
    ends = {k: v[1] for k, v in paths.items()}
    check(step_values(csp, same_opts, same_feats, ends["with"].tabs_host)
          [1] == float(np.float32(csp.visco)), "the neutral table moved visco")
    flow = float((ends["with"].st.pos - ends["without"].st.pos).abs().max())
    quart = {k: statistics.quantiles(v, n=4) for k, v in times.items()}
    quart["with - without"] = statistics.quantiles(
        [a - b for a, b in zip(times["with"], times["without"])], n=4)
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        step_values(csp, same_opts, same_feats, 1.5e-3)
    values_us = (time.perf_counter() - t0) / reps * 1e6
    c = ends["with"]
    row = [c.tabs, c.dt_pre, c.dt_pre, c.dt_pre, c.dt_pre, c.dt_pre]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        record_dt(c, row)
    torch.cuda.synchronize()
    record_us = (time.perf_counter() - t0) / reps * 1e6
    say("step-values", f"{STEP_VALUES_PAIRS} steps each of the path without "
        f"and with the values at the constants' (ramp to ddtvalue, table at "
        f"visco) and the SaveDt ring, in alternation, the same flow "
        f"({ends['with'].nrebuild} and {ends['without'].nrebuild} divides, "
        f"positions {flow:.3e} m apart at the end); p25 / p50 / p75 of the "
        f"step: " + "; ".join(
            f"{k} " + " / ".join(f"{x * 1e3:.3f}" for x in q) + " ms"
            for k, q in quart.items())
        + f"; alone, step_values {values_us:.2f} us and the SaveDt row "
        f"{record_us:.2f} us per call (mean of {reps}) ({smi})")
    return launched["cellforce"]


# ---- phases 29-31: open boundaries -------------------------------------
CHANNEL_DP = 0.0014    # phase 29: 64,120 live particles, ~200 steps
CHANNEL_TOUT = 0.004   # two PARTs of 4 ms (dt ~3e-5 s)
# phase 29's fluid density bound: the zones start pushing fluid at rest at
# 0.5 m/s with cs0 = 10 m/s, a water hammer of v/c = 5% that doubles where
# it meets a wall; the inlet's wall corners peak at 11.7% at dp 0.0014
# (the JAX package's channel2d at dp 0.004 peaks where the port does, at
# 1064.69), so the bound is 2 v/c + 5%
CHANNEL_RHO_TOL = 0.15
DUCT_DP = 0.005        # phase 30: ~190k fluid, ~270k particles in all
DUCT_TMAX = 0.014      # ~80 steps of ~1.7e-4 s: one layer crosses at each zone
PERIODIC_DP = 0.002    # phase 31: ~61.6k particles, ~460 ghosts a side
PERIODIC_STEPS = 150   # the lattice's last column sits 1e-4 m below the edge
# phase 31's Galilean check: the spread (max - min) of vx in the stream's
# core after the steps; this phase on the CPU through the g++ twins (dp
# 0.004 and 0.01, 150 steps) gives 1e-5 m/s, the bound is 100 times that
PERIODIC_VX_SPREAD = 1e-3


def duct_xml(dp, tmax):
    """Phase 30's case: a duct 0.6 m long with a 0.2 x 0.2 m cross-section,
    DBC walls three particles thick on its four sides reaching past both
    zones, zero gravity, a speed of sound of 10 m/s, the fluid moving at
    0.5 m/s (``<initialize>``); a ``<zone3d><box>`` inlet at x = 0
    imposing 0.5 m/s and one at x = 0.6 whose velocity and density are
    extrapolated (mode 2) and which captures fluid (inputtreatment 1)."""
    def v(x):
        return repr(round(x, 10))
    L, W, lay = 0.6, 0.2, 4
    w = (lay + 2) * dp
    t = 3 * dp
    return f"""<?xml version="1.0"?>
<case><casedef>
 <constantsdef>
  <gravity x="0" y="0" z="0"/><rhop0 value="1000"/>
  <hswl value="{v(W)}" auto="false"/><gamma value="7"/>
  <speedsystem value="0" auto="true"/><coefsound value="20"/>
  <speedsound value="10" auto="false"/><coefh value="1.0"/>
  <cflnumber value="0.2"/>
 </constantsdef>
 <geometry>
  <definition dp="{v(dp)}">
   <pointmin x="{v(-w - dp)}" y="{v(-t - dp)}" z="{v(-t - dp)}"/>
   <pointmax x="{v(L + w + dp)}" y="{v(W + t + dp)}" z="{v(W + t + dp)}"/>
  </definition>
  <commands><mainlist>
   <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
    <point x="{v(dp)}" y="0" z="0"/><size x="{v(L - 2 * dp)}" y="{v(W)}" z="{v(W)}"/></drawbox>
   <setmkbound mk="0"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="{v(-w)}" y="{v(-t)}" z="{v(-t)}"/><size x="{v(L + 2 * w)}" y="{v(W + 2 * t)}" z="{v(2 * dp)}"/></drawbox>
   <drawbox><boxfill>solid</boxfill>
    <point x="{v(-w)}" y="{v(-t)}" z="{v(W + dp)}"/><size x="{v(L + 2 * w)}" y="{v(W + 2 * t)}" z="{v(2 * dp)}"/></drawbox>
   <drawbox><boxfill>solid</boxfill>
    <point x="{v(-w)}" y="{v(-t)}" z="0"/><size x="{v(L + 2 * w)}" y="{v(2 * dp)}" z="{v(W)}"/></drawbox>
   <drawbox><boxfill>solid</boxfill>
    <point x="{v(-w)}" y="{v(W + dp)}" z="0"/><size x="{v(L + 2 * w)}" y="{v(2 * dp)}" z="{v(W)}"/></drawbox>
  </mainlist></commands>
 </geometry>
</casedef>
<execution>
 <special>
  <initialize>
   <fluidvelocity mkfluid="0"><direction x="1" y="0" z="0"/>
    <velocity v="0.5"/></fluidvelocity>
  </initialize>
  <inout>
   <inoutzone>
    <layers value="{lay}"/>
    <zone3d><box><point x="0" y="0" z="0"/><size x="0" y="{v(W)}" z="{v(W)}"/>
     <direction x="1" y="0" z="0"/></box></zone3d>
    <imposevelocity mode="0"><velocity v="0.5"/></imposevelocity>
    <imposerhop mode="0"/>
    <inputtreatment value="0"/>
   </inoutzone>
   <inoutzone>
    <layers value="{lay}"/>
    <zone3d><box><point x="{v(L)}" y="0" z="0"/><size x="0" y="{v(W)}" z="{v(W)}"/>
     <direction x="-1" y="0" z="0"/></box></zone3d>
    <imposevelocity mode="2"/>
    <imposerhop mode="2"/>
    <inputtreatment value="1"/>
   </inoutzone>
  </inout>
 </special>
 <parameters>
  <parameter key="StepAlgorithm" value="2"/><parameter key="Kernel" value="2"/>
  <parameter key="ViscoTreatment" value="1"/><parameter key="Visco" value="0.02"/>
  <parameter key="DensityDT" value="1"/>
  <parameter key="TimeMax" value="{v(tmax)}"/><parameter key="TimeOut" value="{v(tmax / 2)}"/>
 </parameters>
</execution>
</case>
"""


def transitions(code0, code1):
    """[conversions, spawns, captures, destructions, other exclusions, live
    before, live after] between two typecode arrays indexed by id (a
    tensor, on the device)."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    a0, a1 = td.is_active(code0), td.is_active(code1)
    io0, io1 = td.is_inout(code0), td.is_inout(code1)
    destroyed = a0 & io0 & (td.code_special(code1) == td.SPECIAL_OUT_MOVE)
    return torch.stack([
        (a0 & io0 & a1 & ~io1).sum(), (~a0 & a1).sum(),
        (a0 & td.is_fluid(code0) & ~io0 & a1 & io1).sum(), destroyed.sum(),
        (a0 & ~a1 & ~destroyed).sum(), a0.sum(), a1.sum()])


def by_id(values, idp):
    out = torch.empty_like(values)
    out[idp] = values
    return out


def open_runs():
    """(restore, sims, log): ``wcsph.Simulation`` replaced by a subclass
    whose steps record, for each step, whether it started with a rebuild,
    [conversions, spawns, captures, destructions, other exclusions, live
    before, live after] by id, the skin contract's verdict and the flag
    the step left for the next one (a read per step: for the checks, not
    for timing); ``sims`` the simulations built."""
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    sims, log, original = [], [], W.Simulation

    class Recorded(original):
        def __init__(self, csp, opts, dom, st, feats=None, step=None, **k):
            super().__init__(csp, opts, dom, st, feats=feats, step=step, **k)
            inner = step or W.make_step(csp, opts, dom, feats)
            margin = W._margin(csp, dom)

            def recorded(carry):
                st0 = carry.st
                code0 = by_id(st0.code, st0.idp)
                nreb = carry.nrebuild
                carry = inner(carry)
                st1 = carry.st
                vals = torch.cat([
                    transitions(code0, by_id(st1.code, st1.idp)).float(),
                    W._rebuild_needed(csp, margin, carry).float()[None]])
                log.append((carry.nrebuild - nreb, vals.tolist(),
                            carry.rebuild))
                return carry

            self.advance = W.make_advance(csp, opts, dom, feats,
                                          step=recorded)
            sims.append(self)

    W.Simulation = Recorded
    return (lambda: setattr(W, "Simulation", original)), sims, log


def check_open_log(label, log):
    """The totals of :func:`open_runs`' log, checked: the live count of
    each step is the last one's plus its spawns less its destructions, no
    other particle left, and a step starts with a rebuild exactly when the
    step before spawned or its skin contract asked."""
    tot = np.zeros(5, np.int64)
    rebuilds = forced = 0
    for k, (rebuilt, v, flag) in enumerate(log):
        conv, spawn, capt, destr, other, live0, live1 = (int(x) for x in v[:7])
        check(other == 0, f"{label}: step {k}: {other} particle(s) left the "
              f"run other than through an outlet")
        check(live1 == live0 + spawn - destr, f"{label}: step {k}: live "
              f"{live1} != {live0} + {spawn} spawned - {destr} destroyed")
        check(flag == (spawn > 0 or v[7] > 0), f"{label}: step {k} left the "
              f"rebuild flag {flag} with {spawn} spawns and the skin "
              f"contract's {bool(v[7])}")
        if k:
            check(rebuilt == int(log[k - 1][2]), f"{label}: step {k} "
                  f"rebuilt {rebuilt} time(s) after the flag "
                  f"{log[k - 1][2]}")
        tot += [conv, spawn, capt, destr, other]
        rebuilds += rebuilt
        forced += int(spawn > 0 and not v[7] > 0)
    live0, live1 = int(log[0][1][5]), int(log[-1][1][6])
    check(live1 == live0 + tot[1] - tot[3], f"{label}: live {live1} != "
          f"{live0} + {tot[1]} - {tot[3]}")
    return dict(conversions=int(tot[0]), spawns=int(tot[1]),
                captures=int(tot[2]), destructions=int(tot[3]),
                live0=live0, live1=live1, rebuilds=rebuilds,
                forced=forced)


def read_open_parts(pd, directory, rho0, tol):
    """Every Part_XXXX.bi4 of an open-boundary run read back: ids unique,
    positions finite, fluid density within ``tol`` of ``rho0``.  Returns
    {cpart: the part's dict}."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    parts = {}
    for f in sorted(os.listdir(directory)):
        if not re.fullmatch(r"Part_\d{4}\.bi4", f):
            continue
        d = pd.read_part(os.path.join(directory, f))
        check(len(np.unique(d["idp"])) == len(d["idp"]),
              f"{f}: repeated ids")
        check(bool(np.isfinite(d["pos"]).all()), f"{f}: Posd not finite")
        fluid = td.code_type(d["code"].astype(np.int64)) == td.TYPE_FLUID
        r = d["rhop"][fluid]
        check((1 - tol) * rho0 <= r.min() and r.max() <= (1 + tol) * rho0,
              f"{f}: fluid density [{r.min()}, {r.max()}] out of +-{tol:g} "
              f"of {rho0}")
        parts[d["cpart"]] = d
    return parts


def open_kernel_vs_plain(label, csp, opts, dom, st, smi, cells=None):
    """Kernel 1 against its plain version on ``st`` (divided afresh unless
    ``cells`` is its layout), rtol 2e-3, with its bound there; returns
    the record's numbers."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    if cells is None:
        cells, args = sorted_args(dom, st.pos, st.vel, st.rho, st.code)
    else:
        args = (st.pos, st.vel, st.rho, st.code)
    err, ms, wrapped_ms, plain_ms = compare_cellforce(csp, opts, dom, cells,
                                                      args, reps=5)
    n = args[0].shape[0]
    cand, pairs = pair_counts(csp, dom, cells, args[0], args[3],
                              inclusive=False)
    b = bound(cellforce_bytes(n, dom.ncells, opts),
              pairs * OPS_PER_PAIR["cellforce"])
    live = int(td.is_active(args[3]).sum())
    say(label, f"kernel 1 vs plain on {n} rows ({live} active): max|d ace| "
        f"{err['ace']:.3e}, max|d ar| {err['ar']:.3e}; kernel alone "
        f"{ms:.4f} ms, with its wrapper {wrapped_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms (CUDA events); {cand} candidates, {pairs} "
        f"in-support pairs with a fluid-side target; bound "
        f"{b[0] * 1e3:.2f} us by {b[1]} ({smi})")
    return dict(max_abs_err=err["ace"], ms=ms, wrapped_ms=wrapped_ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], rows=n)


def open_timing(label, step, carry, smi, nwarm=5, nsteps=20):
    """The p50 of ``nsteps`` steps after ``nwarm`` (cellforce exactly twice
    per step, no other kernel), the device-to-host copies per step over 10
    traced steps (must be 1) and a traced breakdown of 10 more."""
    carry, times, launched = run_steps(step, carry, nwarm, nsteps)
    single_phase_counts(launched, "cellforce", 2, nwarm + nsteps)
    check(carry.overflow == 0, f"{label}: overflow {carry.overflow}")
    p50 = statistics.median(times)
    d2h, carry = count_d2h(step, carry, 10)
    check(d2h is not None, f"{label}: the profiler's trace of 10 steps holds "
          f"no device activity")
    check(d2h == 1, f"{label}: {d2h} device-to-host copies per step, "
          f"expected 1")
    r = trace_steps(step, carry, 10, ("cellforce",))
    check(r is not None, f"{label}: the trace holds no device activity")
    say(label, f"{nsteps} steps after {nwarm}: p50 {p50 * 1e3:.3f} ms; "
        f"{d2h:g} device-to-host copy per step; 10 traced steps: window "
        f"{r['window_ms']:.3f} ms per step, device busy {r['busy_ms']:.3f} "
        f"ms, idle share {r['idle_share']:.4f}, {r['ops']:.1f} device "
        f"operations per step, cellforce {r['kernel_ms']['cellforce']:.4f} "
        f"ms per step ({smi})")
    return carry, dict(p50_ms=p50 * 1e3, busy_ms=r["busy_ms"],
                       ops=r["ops"], idle_share=r["idle_share"],
                       cellforce_ms=r["kernel_ms"]["cellforce"])


def open_cli_path(label, argv, device, smi, extrap=False, rho_tol=0.1):
    """Phases 29 and 30: ``cli.main(argv)`` in-process on the card with
    the steps recorded (:func:`open_runs`), checked as
    :func:`check_open_log` says, cellforce exactly twice per step and no
    other kernel, overflow 0, the fluid density within ``rho_tol`` of
    rest, the PARTs read back (the last one's particles the live count);
    with ``extrap`` the extrapolated members finite and within 10% of rest
    density.  Then
    the timing of the final state and kernel 1 against its plain version
    on it.  Returns (the CLI run's cellforce launches, the record)."""
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.models.wcsph import make_step
    root = tempfile.mkdtemp(prefix="_smoke_open_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    restore, sims, log = open_runs()
    try:
        argv = [a.replace("{root}", root) for a in argv]
        out = os.path.join(root, "out")
        reset_counts()
        t0 = time.perf_counter()
        try:
            check(cli.main(argv + ["-sv:binx", "-nortimes", "-dirout", out])
                  == 0, f"{label}: the CLI run failed")
        finally:
            restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        sim, = sims
        carry = sim.carry
        nsteps = carry.nstep
        check(len(log) == nsteps, f"{label}: {len(log)} recorded steps")
        single_phase_counts(launched, "cellforce", 2, nsteps)
        check(carry.overflow == 0, f"{label}: overflow {carry.overflow} "
              f"(ghosts {carry.overflow_ghosts}, inout "
              f"{carry.overflow_inout})")
        tally = check_open_log(label, log)
        check(tally["conversions"] > 0 and tally["spawns"] > 0
              and tally["destructions"] > 0, f"{label}: {tally}")
        st = carry.st
        rho0 = sim.csp.rhopzero
        fluid = td.is_fluid(st.code) & td.is_active(st.code)
        rmin, rmax = float(st.rho[fluid].min()), float(st.rho[fluid].max())
        check((1 - rho_tol) * rho0 <= rmin and rmax <= (1 + rho_tol) * rho0,
              f"{label}: fluid density [{rmin}, {rmax}] out of "
              f"+-{rho_tol:g} of {rho0}")
        parts = read_open_parts(PD, out, rho0, rho_tol)
        last = parts[max(parts)]
        check(len(last["idp"]) == tally["live1"], f"{label}: the last PART "
              f"holds {len(last['idp'])} particles, the run "
              f"{tally['live1']}")
        note = ""
        if extrap:
            io = td.is_inout(st.code) & td.is_active(st.code)
            ok = (torch.isfinite(st.vel[io]).all()
                  & torch.isfinite(st.rho[io]).all()
                  & ((st.rho[io] - rho0).abs() <= 0.1 * rho0).all())
            check(bool(ok), f"{label}: extrapolated members out of range")
            note = (f"; members' rho [{float(st.rho[io].min()):.2f}, "
                    f"{float(st.rho[io].max()):.2f}], vx "
                    f"[{float(st.vel[io, 0].min()):.4f}, "
                    f"{float(st.vel[io, 0].max()):.4f}]")
        say(label, f"{' '.join(argv[:4])}: {tally['live0']} live particles "
            f"in {st.n} slots, {nsteps} steps, {sorted(parts)} PARTs read "
            f"back in {wall:.3f} s: {tally['conversions']} conversions, "
            f"{tally['spawns']} spawns, {tally['captures']} captures, "
            f"{tally['destructions']} destructions, live {tally['live0']} -> "
            f"{tally['live1']} (= start + spawns - destructions); "
            f"{tally['rebuilds']} rebuilds inside the steps ({tally['forced']} "
            f"forced by a spawn alone); {launched['cellforce']} cellforce "
            f"launches; overflow 0; fluid rho [{rmin:.2f}, {rmax:.2f}]"
            f"{note} ({smi})")
        step = make_step(sim.csp, sim.opts, sim.dom, sim.feats)
        carry, rec = open_timing(label, step, carry, smi)
        rec.update(open_kernel_vs_plain(label, sim.csp, sim.opts, sim.dom,
                                        carry.st, smi))
        rec.update(live=tally["live1"], slots=st.n, nsteps=nsteps, **tally)
        return launched["cellforce"], rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def channel_path(device, smi):
    """Phase 29: ``dsphtorch -builtin channel2d -dp 0.0014`` (the inlet at
    0.5 m/s, the outlet at the far end; two PARTs of 4 ms, ~200 steps)."""
    return open_cli_path("channel2d", [
        "-builtin", "channel2d", "-dp", repr(CHANNEL_DP),
        f"-tmax:{2 * CHANNEL_TOUT!r}", f"-tout:{CHANNEL_TOUT!r}"], device, smi,
        rho_tol=CHANNEL_RHO_TOL)


def duct_path(device, smi):
    """Phase 30: :func:`duct_xml` at dp 0.005 through ``-case``."""
    from dualsphysics_multilayer_tpu_torch import cli  # noqa: F401
    import tempfile
    d = tempfile.mkdtemp(prefix="_smoke_duct_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    path = os.path.join(d, "Duct_Def.xml")
    with open(path, "w") as f:
        f.write(duct_xml(DUCT_DP, DUCT_TMAX))
    try:
        return open_cli_path("duct-inout", ["-case", path], device, smi,
                             extrap=True)
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)


def counted_divides():
    """(restore, calls): ``celldiv.divide_cells`` counted where the step
    and the periodic interaction call it."""
    from dualsphysics_multilayer_tpu_torch.features import periodic as PER
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
    calls, original = [0], cd.divide_cells

    def counted(*a, **k):
        calls[0] += 1
        return original(*a, **k)

    cd.divide_cells = counted

    def restore():
        cd.divide_cells = original

    assert W.cd is cd and PER.cd is cd
    return restore, calls


def periodic_path(device, smi):
    """Phase 31: the x-periodic channel of the JAX package's tests
    (``cases.periodic_channel2d``) at dp 0.002 through the library API,
    ghost_cap 1024: all fluid at 1 m/s along x, the lattice shifted so its
    last column sits 1e-4 m below the edge, ``PERIODIC_STEPS`` steps.  No
    normal particle lost, wraps > 0, the spread of the fluid's vx under
    ``PERIODIC_VX_SPREAD`` (a uniform stream stays uniform), the fluid
    density within 1%, cellforce twice and the periodic divide twice per
    step, overflow 0; then timing, and kernel 1 against its plain version
    on the final state with its ghost rows."""
    from dualsphysics_multilayer_tpu_torch import Features, SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.features import periodic as PER
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    case = cases.periodic_channel2d(dp=PERIODIC_DP, ghost_cap=1024,
                                    device=device)
    cfg = case.meta["periodic"]
    st = case.state
    fl = td.is_fluid(st.code)
    pos = st.pos.clone()
    pos[fl, 0] += PERIODIC_DP - 1e-4
    st = dataclasses.replace(st, pos=pos, vel=torch.where(
        fl[:, None], torch.tensor([1.0, 0.0, 0.0], device=device), 0.0))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    feats = Features(periodic=cfg)
    step = make_step(case.csp, opts, case.dom, feats)
    carry = make_carry(st, case.csp, opts, case.dom, feats)
    normal0 = int((td.is_active(st.code) & td.is_normal(st.code)).sum())
    x0 = by_id(carry.st.pos[:, 0], carry.st.idp)
    _rows, ghosts0 = PER.ghost_rows(cfg, case.csp, carry.st)
    nghost0 = int(td.is_periodic(_rows["code"]).sum())
    restore, divides = counted_divides()
    nreb = carry.nrebuild
    try:
        carry, times, launched = run_steps(step, carry, 0, PERIODIC_STEPS)
    finally:
        restore()
    single_phase_counts(launched, "cellforce", 2, PERIODIC_STEPS)
    rebuilt = carry.nrebuild - nreb
    check(divides[0] == 2 * PERIODIC_STEPS + rebuilt, f"{divides[0]} divides "
          f"in {PERIODIC_STEPS} steps with {rebuilt} rebuilds, expected 2 "
          f"per step and one per rebuild")
    check(carry.overflow == 0, f"periodic: overflow {carry.overflow}")
    s = carry.st
    normal1 = int((td.is_active(s.code) & td.is_normal(s.code)).sum())
    check(normal1 == normal0, f"periodic: {normal0} normal particles -> "
          f"{normal1}")
    x1 = by_id(s.pos[:, 0], s.idp)
    wraps = int((x1 < x0 - 0.5 * cfg.hi[0]).sum())
    check(wraps > 0, "periodic: no particle wrapped")
    fluid = td.is_fluid(s.code) & td.is_active(s.code)
    vx = s.vel[fluid, 0]
    # the bed's friction and the free surface shape the stream near them:
    # the check reads the core, 4 kernel sizes from both
    ks = case.csp.kernelsize
    z = s.pos[:, 2]
    core = fluid & (z > 4 * ks) & (z < case.meta["zsurf"] - 4 * ks)
    spread = float(s.vel[core, 0].max() - s.vel[core, 0].min())
    check(spread < PERIODIC_VX_SPREAD, f"periodic: the core's vx spread "
          f"{spread}")
    rmin, rmax = fluid_rho_range(s, True, case.csp.rhopzero)
    rho0 = case.csp.rhopzero
    check(0.99 * rho0 <= rmin and rmax <= 1.01 * rho0,
          f"periodic: fluid density [{rmin}, {rmax}] out of +-1%")
    say("periodic", f"x-periodic channel at dp {PERIODIC_DP}: {case.np_total} "
        f"particles, {nghost0} ghost rows at the start (cap 2x{cfg.ghost_cap}"
        f"), {PERIODIC_STEPS} steps: {launched['cellforce']} cellforce "
        f"launches, {divides[0]} divides ({rebuilt} skin-contract rebuilds), "
        f"{wraps} wraps, normal particles {normal0} -> {normal1}, fluid vx "
        f"mean {float(vx.mean()):.5f} in [{float(vx.min()):.5f}, "
        f"{float(vx.max()):.5f}], the core's spread {spread:.5f} m/s, "
        f"fluid rho "
        f"[{rmin:.2f}, {rmax:.2f}], overflow 0 ({smi})")
    carry, rec = open_timing("periodic", step, carry, smi)
    rows, _ov = PER.ghost_rows(cfg, case.csp, dataclasses.replace(
        carry.st, pos=PER.wrap(cfg, carry.st.pos, carry.st.code)))
    gst = dataclasses.replace(carry.st, pos=rows["pos"], vel=rows["vel"],
                              rho=rows["rho"], code=rows["code"])
    rec.update(open_kernel_vs_plain("periodic", case.csp, opts, case.dom,
                                    gst, smi))
    rec.update(launches=launched["cellforce"], wraps=wraps, vx_spread=spread,
               ghosts=int(td.is_periodic(rows["code"]).sum()))
    return launched["cellforce"], rec


# ---------------------------------------------------------------------------
# phases 32-34: the floating bodies' couplings
# ---------------------------------------------------------------------------

COUPLING_TOUT = 0.0012   # phases 32 and 34: 3 intervals of 1.2 ms (~50 steps)
MOORED_TOUT = 0.00065    # phase 33: 2 intervals of 0.65 ms (~50 steps)
MOORED_TMAXIC = 0.25     # phase 33: seconds of the lines' relaxation
BOX_SIDE = 0.1           # phase 32: the DEM boxes' side
FLAP = (0.02, 0.5, 0.2)  # phase 34: the flap's size (x, y, z)
COLBOX = 0.06            # phase 34: the collision box's side
# the boxes' and the walls' materials (<properties>): soft plastic boxes on
# stiffer walls
BOX_PROPS = dict(young=1e6, poisson=0.3, kfric=0.3, restitu=0.6)
WALL_PROPS = dict(young=1e7, poisson=0.3, kfric=0.4, restitu=0.6)


def _property(name, p):
    return (f'<property name="{name}"><Young_Modulus value="{p["young"]!r}"/>'
            f'<PoissonRatio value="{p["poisson"]!r}"/>'
            f'<Kfric value="{p["kfric"]!r}"/>'
            f'<Restitution_Coefficient value="{p["restitu"]!r}"/></property>')


def _dambreak_with(dp, tmax, tout, draw="", casedef="", special="",
                   params=""):
    """Phase 24's dam break with more geometry (``draw``), casedef nodes,
    ``<special>`` nodes and parameters."""
    xml = DAMBREAK_XML.format(dp=dp, tmax=tmax, tout=tout)
    xml = xml.replace("  </mainlist></commands>",
                      draw + "\n  </mainlist></commands>")
    xml = xml.replace("</casedef>", casedef + "\n</casedef>")
    xml = xml.replace(" <parameters>", f" <special>{special}</special>\n"
                      " <parameters>")
    return xml.replace(" </parameters>", params + "\n </parameters>")


def _lattice_box(mk, i0, n, dp):
    """A solid ``<drawbox>`` of mk ``mk`` over the lattice indices ``i0`` to
    ``i0 + n`` (each a triple) of spacing ``dp``."""
    p = [repr(i * dp) for i in i0]
    s = [repr(k * dp) for k in n]
    return (f'<setmkbound mk="{mk}"/><drawbox><boxfill>solid</boxfill>'
            f'<point x="{p[0]}" y="{p[1]}" z="{p[2]}"/>'
            f'<size x="{s[0]}" y="{s[1]}" z="{s[2]}"/></drawbox>')


def dem_boxes(dp):
    """Phase 32's boxes: lattice indices (start, count) of box 51 resting on
    the floor downstream of the obstacle and of box 52 beside it, one
    lattice step away along x (the script moves it 0.1 dp closer)."""
    n = int(round(BOX_SIDE / dp))
    i1 = (int(round(1.12 / dp)), int(round(0.2 / dp)), 1)
    i2 = (i1[0] + n + 1, i1[1], 1)
    return (i1, (n, n, n)), (i2, (n, n, n))


def dem_xml(dp, tmax, tout):
    """Phase 32's case: the dam break with the two 0.1 m boxes (rhopbody
    800) and ``RigidAlgorithm=2``, ``<properties>`` for the boxes and the
    walls."""
    (i1, n1), (i2, n2) = dem_boxes(dp)
    draw = _lattice_box(51, i1, n1, dp) + "\n" + _lattice_box(52, i2, n2, dp)
    casedef = (
        '<floatings><floating mkbound="51" rhopbody="800" property="box"/>'
        '<floating mkbound="52" rhopbody="800" property="box"/></floatings>'
        f'<properties>{_property("box", BOX_PROPS)}'
        f'{_property("wall", WALL_PROPS)}<links><link mkbound="0,1" '
        'property="wall"/></links></properties>')
    return _dambreak_with(dp, tmax, tout, draw, casedef, params=(
        '<parameter key="RigidAlgorithm" value="2"/>'))


def stepping_runs(on_step):
    """(restore, sims): ``wcsph.Simulation`` replaced by a subclass whose
    steps call ``on_step(carry)`` after each step (a read per step: for
    the checks, not for timing); ``sims`` the simulations built."""
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    sims, original = [], W.Simulation

    class Recorded(original):
        def __init__(self, csp, opts, dom, st, feats=None, step=None, **k):
            super().__init__(csp, opts, dom, st, feats=feats, step=step, **k)
            inner = step or W.make_step(csp, opts, dom, feats)

            def recorded(carry):
                carry = inner(carry)
                on_step(carry)
                return carry

            self.advance = W.make_advance(csp, opts, dom, feats,
                                          step=recorded)
            self.inner_step = inner
            sims.append(self)

    W.Simulation = Recorded
    return (lambda: setattr(W, "Simulation", original)), sims


def piece_ms(label, fn, reps=7):
    """A piece of a step alone: (CUDA-event ms per call, device operations
    per call, device busy ms per call) over one traced call."""
    from torch.profiler import ProfilerActivity, profile
    ms = cuda_ms(fn, reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    check(bool(ev), f"{label}: the trace holds no device activity")
    busy, cur_s, cur_e = 0.0, ev[0][0], ev[0][1]
    for s0, e0 in ev[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy = (busy + cur_e - cur_s) * 1e-3
    return ms, len(ev), busy


def coupling_timing(label, step, carry, smi, pieces):
    """The p50 of 20 steps after 5 (cellforce exactly twice per step), one
    device-to-host copy per step over 10 traced steps, a traced breakdown
    of 10 more, and each of ``pieces`` ({name: (calls per step, fn)})
    alone (:func:`piece_ms`)."""
    carry, times, launched = run_steps(step, carry, 5, 20)
    single_phase_counts(launched, "cellforce", 2, 25)
    p50 = statistics.median(times)
    d2h, carry = count_d2h(step, carry, 10)
    check(d2h is not None, f"{label}: the profiler's trace of 10 steps holds "
          f"no device activity")
    check(d2h == 1, f"{label}: {d2h} device-to-host copies per step, "
          f"expected 1")
    r = trace_steps(step, carry, 10, ("cellforce",))
    check(r is not None, f"{label}: the trace holds no device activity")
    rec = dict(p50_ms=p50 * 1e3, busy_ms=r["busy_ms"], ops=r["ops"],
               idle_share=r["idle_share"],
               cellforce_ms=r["kernel_ms"]["cellforce"], pieces={})
    parts = []
    for name, (per_step, fn) in pieces.items():
        ms, ops, busy = piece_ms(f"{label} {name}", fn)
        rec["pieces"][name] = dict(per_step=per_step, ms=ms, ops=ops,
                                   busy_ms=busy)
        parts.append(f"{name} {per_step} per step: {ms:.4f} ms a call "
                     f"(CUDA events), {ops} device operations, device busy "
                     f"{busy:.4f} ms")
    say(label, f"20 steps after 5: p50 {p50 * 1e3:.3f} ms; {d2h:g} "
        f"device-to-host copy per step; 10 traced steps: window "
        f"{r['window_ms']:.3f} ms per step, device busy {r['busy_ms']:.3f} "
        f"ms, idle share {r['idle_share']:.4f}, {r['ops']:.1f} device "
        f"operations per step, cellforce {r['kernel_ms']['cellforce']:.4f} "
        f"ms per step; alone: " + "; ".join(parts) + f" ({smi})")
    return carry, rec


def floating_kernel_vs_plain(label, csp, opts, dom, carry, ftcfg, smi):
    """Kernel 1's floating instance (FT = 1) against its plain version on
    the final state, rtol 2e-3, timed alone, with its bound."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.features import floating as FT
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    st = carry.st
    ftomassp = FT.body_tables(ftcfg, tuple(csp.gravity), st.pos.device).massp
    args = (st.pos, st.vel, st.rho, st.code)
    err, ms, wrapped_ms, plain_ms = compare_cellforce(
        csp, opts, dom, carry.cells, args, reps=5, ftomassp=ftomassp)
    n = st.n
    cand, pairs = pair_counts(csp, dom, carry.cells, st.pos, st.code,
                              inclusive=False)
    name = CF.kernel_name(csp, opts)
    b = bound(cellforce_bytes(n, dom.ncells, opts) + 4 * n,
              pairs * ops_per_pair(name, opts))
    nft = int(td.is_floating(st.code).sum())
    say(label, f"kernel 1's floating instance ({name}, FT = 1) vs plain on "
        f"the final state, {n} particles ({nft} floating): max|d ace| "
        f"{err['ace']:.3e}, max|d ar| {err['ar']:.3e}; kernel alone "
        f"{ms:.4f} ms, with its wrapper {wrapped_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms (CUDA events); {cand} candidates, {pairs} "
        f"in-support pairs with a fluid-side target; bound "
        f"{b[0] * 1e3:.2f} us by {b[1]} ({smi})")
    return dict(rows=n, floating=nft, max_abs_err=err["ace"], ms=ms,
                wrapped_ms=wrapped_ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1])


def _by_id_rows(st, ids):
    """The slots of the particles ``ids`` (a device tensor) in ``st``."""
    slot = torch.empty_like(st.idp)
    slot[st.idp] = torch.arange(st.n, device=st.idp.device)
    return slot[ids]


def _min_dist(a, b):
    return float(torch.cdist(a.double(), b.double()).min()) if len(a) and \
        len(b) else float("inf")


def dem_path(device, smi):
    """Phase 32: DEM contact in 3D through ``-case``: phase 24's dam break at
    DP_BENCH with two floating boxes (0.1 m, rhopbody 800) downstream of
    the obstacle, box 51 resting on the floor and box 52 beside it, its
    nearest particles 0.9 dp from box 51's, ``RigidAlgorithm=2`` and
    ``<properties>``.  The GenCase lattice holds no two particles closer
    than dp, so the script loads the case, moves box 52 0.1 dp towards box
    51 and writes that state as PART 0 (with its PartFloat.fbi4); the CLI
    runs the case from it with ``-partbegin:0`` (~50 steps).  Each step is
    recorded: box-box contacts (overlap > 0) from the first step, box-wall
    contacts within the run, no particle of a box within 0.5 dp of the
    other box or a wall, each box rigid, the state and the bodies finite;
    cellforce twice per step.  Then the timing with DEM's pass alone, one
    device-to-host copy per step, and kernel 1's floating instance against
    its plain version on the final state."""
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.features import dem as DEM
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.io.output import OutputManager
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    dp = DP_BENCH
    root = tempfile.mkdtemp(prefix="_smoke_dem_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        path = os.path.join(root, "Dem_Def.xml")
        with open(path, "w") as f:
            f.write(dem_xml(dp, 3 * COUPLING_TOUT, COUPLING_TOUT))
        case, opts, _run = load_case(path, device=device)
        feats = case.meta["features"]
        check(feats is not None and feats.dem is not None
              and feats.floating.count == 2, "the DEM case's features")
        st = case.state
        body = td.code_value(st.code)
        isft = td.is_floating(st.code)
        box2 = isft & (body == 1)
        pos = st.pos.clone()
        pos[box2, 0] -= 0.1 * dp
        center = st.ft.center.clone()
        center[1, 0] -= 0.1 * dp
        st = dataclasses.replace(st, pos=pos, ft=dataclasses.replace(
            st.ft, center=center))
        prep = os.path.join(root, "prep")
        sim0 = W.Simulation(case.csp, opts, case.dom, st, feats=feats)
        OutputManager(prep, dataclasses.replace(case, state=st),
                      feats=feats)(sim0)
        ids = [st.idp[isft & (body == b)] for b in (0, 1)]
        gap = _min_dist(st.pos[isft & (body == 0)], st.pos[box2])
        check(abs(gap - 0.9 * dp) < 1e-3 * dp, f"the boxes' nearest "
              f"particles {gap / dp:.4f} dp apart, expected 0.9")
        lo = st.pos[isft].min(0).values - 0.05
        hi = st.pos[isft].max(0).values + 0.05
        near = ((td.code_type(st.code) < td.TYPE_FLOATING)
                & (st.pos >= lo).all(1) & (st.pos <= hi).all(1))
        wall_ids = st.idp[near]
        spans0 = [float((st.pos[isft & (body == b)][0]
                         - st.pos[isft & (body == b)][-1]).norm())
                  for b in (0, 1)]
        end_ids = [torch.stack([ids[b][0], ids[b][-1]]) for b in (0, 1)]
        log = []

        def on_step(carry):
            s = carry.st
            b = [s.pos[_by_id_rows(s, ids[k])] for k in (0, 1)]
            w = s.pos[_by_id_rows(s, wall_ids)]
            d12 = torch.cdist(b[0], b[1])
            dw = torch.cdist(torch.cat(b), w)
            span = [float((s.pos[_by_id_rows(s, end_ids[k])][0]
                           - s.pos[_by_id_rows(s, end_ids[k])][1]).norm())
                    for k in (0, 1)]
            fin = all(bool(torch.isfinite(getattr(s, k)).all())
                      for k in ("pos", "vel", "rho")) and all(
                bool(torch.isfinite(getattr(s.ft, k)).all())
                for k in ("center", "fvel", "fomega", "angles"))
            log.append(dict(bb=int((d12 < dp).sum()),
                            bw=int((dw < dp).sum()),
                            dbb=float(d12.min()), dbw=float(dw.min()),
                            span=span, finite=fin))

        out = os.path.join(root, "out")
        restore, sims = stepping_runs(on_step)
        reset_counts()
        t0 = time.perf_counter()
        try:
            check(cli.main(["-case", path, "-partbegin:0", prep, "-sv:binx",
                            "-nortimes", "-dirout", out]) == 0,
                  "the -case run of the DEM boxes failed")
        finally:
            restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        nsteps = len(log)
        check(nsteps >= 30, f"the DEM run made {nsteps} steps")
        single_phase_counts(launched, "cellforce", 2, nsteps)
        check(log[0]["bb"] > 0, "no box-box DEM contact at the first step")
        first_bw = next((k for k, r in enumerate(log) if r["bw"] > 0), None)
        check(first_bw is not None, "no box-wall DEM contact in the run")
        dbb = min(r["dbb"] for r in log)
        dbw = min(r["dbw"] for r in log)
        check(dbb >= 0.5 * dp and dbw >= 0.5 * dp, f"a box particle came "
              f"within {min(dbb, dbw) / dp:.3f} dp of the other box or a wall")
        dspan = max(abs(s - s0) for r in log for s, s0 in zip(r["span"],
                                                               spans0))
        check(dspan < 1e-3 * dp, f"a box deformed by {dspan / dp:.2e} dp")
        check(all(r["finite"] for r in log), "the state or the bodies went "
              "non-finite")
        sim = sims[0]
        carry = sim.carry
        check(carry.overflow == 0, f"DEM: overflow {carry.overflow}")
        parts = read_parts(PD, out, case.np_total, case.csp.rhopzero)
        # the bodies' history for phase 36's floatinginfo
        KEPT["float"] = tempfile.mkdtemp(prefix="_smoke_keep_",
                                         dir=os.path.dirname(root))
        atexit.register(shutil.rmtree, KEPT["float"], True)
        shutil.copy(os.path.join(out, "PartFloat.fbi4"), KEPT["float"])
        ft = carry.st.ft
        say("dem-3d", f"-case -partbegin:0 with two {BOX_SIDE} m boxes at dp "
            f"{dp:.6g}: {case.np_total} particles ({int(isft.sum())} "
            f"floating), {nsteps} steps and PARTs {sorted(parts)} in "
            f"{wall:.3f} s ({launched['cellforce']} cellforce launches); "
            f"box-box contacts at step 1: {log[0]['bb']} (max "
            f"{max(r['bb'] for r in log)}), box-wall contacts from step "
            f"{first_bw + 1} (max {max(r['bw'] for r in log)}); nearest "
            f"box-box {dbb / dp:.4f} dp, box-wall {dbw / dp:.4f} dp; spans "
            f"kept within {dspan / dp:.2e} dp; body fvel "
            f"{ft.fvel.tolist()}, overflow 0 ({smi})")
        csp, dom = sim.csp, sim.dom
        step = sim.inner_step
        layout = DEM.DemLayout()

        def dem_pass():
            s = carry.st
            return DEM.apply_dem(feats.dem, csp, dom, carry.cells, s.pos,
                                 s.vel, s.code, s.idp, carry.dt_pre,
                                 layout=layout)

        dem_pass()
        carry, rec = coupling_timing("dem-3d", step, carry, smi, {
            "dem pass": (2, dem_pass)})
        rec.update(floating_kernel_vs_plain("dem-3d", csp, sim.opts, dom,
                                            carry, feats.floating, smi))
        rec.update(launches=launched["cellforce"], steps=nsteps,
                   contacts_bb_step1=log[0]["bb"], first_bw_step=first_bw + 1)
        return launched["cellforce"], rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def moored_xml(dp, tmax, tout):
    """Phase 33's case: the XML twin of ``cases.floatingbox2d(dp)`` (a 2 x
    1.2 m tank, water 0.5 m deep, a 0.2 m box of rhopbody 500 at (0.9,
    0.42)) with ``<special><moorings>`` reading MOORED_MOORDYN beside it."""
    return f"""<?xml version="1.0"?>
<case><casedef>
 <constantsdef>
  <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/>
  <hswl value="0.5" auto="false"/><gamma value="7"/>
  <speedsystem value="0" auto="true"/><coefsound value="20"/>
  <speedsound value="0" auto="true"/><coefh value="1.0"/>
  <cflnumber value="0.2"/>
 </constantsdef>
 <geometry>
  <definition dp="{dp!r}">
   <pointmin x="-0.05" y="0" z="-0.05"/><pointmax x="2.1" y="0" z="1.3"/>
  </definition>
  <commands><mainlist>
   <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
    <point x="0" y="0" z="0"/><size x="2" y="0" z="0.5"/></drawbox>
   <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right</boxfill>
    <point x="0" y="0" z="0"/><size x="2" y="0" z="1.2"/></drawbox>
   <setmkbound mk="45"/><drawbox><boxfill>solid</boxfill>
    <point x="0.9" y="0" z="0.42"/><size x="0.2" y="0" z="0.2"/></drawbox>
  </mainlist></commands>
 </geometry>
 <floatings><floating mkbound="45" rhopbody="500"/></floatings>
</casedef>
<execution>
 <special>
  <moorings>
   <mooredfloatings><floating mkbound="45"/></mooredfloatings>
   <moordyn file="moordyn.xml"/>
  </moorings>
 </special>
 <parameters>
  <parameter key="StepAlgorithm" value="2"/><parameter key="Kernel" value="2"/>
  <parameter key="ViscoTreatment" value="1"/><parameter key="Visco" value="0.05"/>
  <parameter key="DensityDT" value="2"/>
  <parameter key="TimeMax" value="{tmax!r}"/><parameter key="TimeOut" value="{tout!r}"/>
 </parameters>
</execution>
</case>
"""


def moored_moordyn(center):
    """examples/03_floating_moored.py's two lines as a MoorDyn+ file: each
    0.45 m, EA 2.9e3 N, 10 segments, 3.7 mm, 0.06 kg/m, from the floor 0.4
    m either side of the box's centre to fairleads 0.1 m either side of it
    and 0.05 m below; the seabed at z = 0."""
    cx, _cy, cz = (float(c) for c in center)
    lines = "".join(f"""
  <line><vesselconnection bodyref="45" x="{cx + s * 0.1!r}" y="0" z="{cz - 0.05!r}"/>
   <fixconnection x="{cx + s * 0.4!r}" y="0" z="0"/>
   <length value="0.45"/><segments value="10"/></line>""" for s in (-1, 1))
    return f"""<?xml version="1.0"?>
<moordyn>
 <solverOptions><freesurface value="0.5"/><waterDepth value="0.5"/>
  <tmaxIC value="{MOORED_TMAXIC!r}"/></solverOptions>
 <bodies><body ref="45"/></bodies>
 <lines>
  <linedefault><ea value="2.9e3"/><diameter value="3.7e-3"/>
   <massDenInAir value="0.06"/><ba value="-0.8"/></linedefault>{lines}
 </lines>
</moordyn>
"""


def moored_path(device, smi):
    """Phase 33: the moored box through ``-case``: ``moored_xml`` at
    DP_FLOAT (62,033 particles) with its MoorDyn file (the XML twin of
    ``floatingbox2d`` and examples/03_floating_moored.py's two lines),
    ~50 steps.  After each step each line's fairlead node sits on the
    body's fairlead point within 1e-5 m and the fairlead tensions are
    finite; each save writes a MooringsLines file and one
    MooringsPoints.csv row per line; the lines' relaxation's host seconds.
    Then the timing with the rigid update and the lines' substep alone,
    and 20 steps through ``Features`` of the quasi-static ``MooringCfg``
    with a ``ForcePointsCfg``."""
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import Features, cli
    from dualsphysics_multilayer_tpu_torch.features import floating as FT
    from dualsphysics_multilayer_tpu_torch.features import moorings as MO
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    root = tempfile.mkdtemp(prefix="_smoke_moor_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        ref = cases.floatingbox2d(dp=DP_FLOAT, device=device)
        path = os.path.join(root, "Moored_Def.xml")
        with open(path, "w") as f:
            f.write(moored_xml(DP_FLOAT, 2 * MOORED_TOUT, MOORED_TOUT))
        with open(os.path.join(root, "moordyn.xml"), "w") as f:
            f.write(moored_moordyn(ref.state.ft.center[0].tolist()))
        case, opts, _run = load_case(path, device=device)
        check(case.np_total == ref.np_total, f"the XML twin draws "
              f"{case.np_total} particles, floatingbox2d {ref.np_total}")
        feats = case.meta["features"]
        cfg = feats.moorings
        check(cfg is not None and len(cfg.lines) == 2, "the moorings' lines")
        log = []

        def on_step(carry):
            pf, _ = cfg._fairlead_kin(carry.st.ft)
            node = torch.stack([carry.moor.pos[k, ln.nseg]
                                for k, ln in enumerate(cfg.lines)])
            tens = cfg.fairlead_tensions(carry.moor)
            log.append((float((node - pf).norm(dim=1).max()),
                        bool(torch.isfinite(tens).all()),
                        tens.norm(dim=1).tolist()))

        out = os.path.join(root, "out")
        restore, sims = stepping_runs(on_step)
        reset_counts()
        t0 = time.perf_counter()
        try:
            check(cli.main(["-case", path, "-sv:binx", "-nortimes",
                            "-dirout", out]) == 0,
                  "the -case run of the moored box failed")
        finally:
            restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        sim = sims[0]
        nsteps = len(log)
        check(nsteps >= 30, f"the moored run made {nsteps} steps")
        single_phase_counts(launched, "cellforce", 2, nsteps)
        off = max(r[0] for r in log)
        check(off < 1e-5, f"a fairlead node {off:.3e} m off its fairlead")
        check(all(r[1] for r in log), "a fairlead tension went non-finite")
        vtk = sorted(os.listdir(os.path.join(out, "MooringsVtk")))
        check(vtk == [f"MooringsLines_{k:04d}.vtk" for k in range(3)],
              f"MooringsVtk holds {vtk}")
        with open(os.path.join(out, "MooringsPoints.csv")) as f:
            rows = f.read().splitlines()
        check(len(rows) == 1 + 3 * 2, f"MooringsPoints.csv holds "
              f"{len(rows) - 1} rows, expected 2 per save")
        carry = sim.carry
        tens = log[-1][2]
        say("moored-box", f"-case with two MoorDyn lines at dp "
            f"{DP_FLOAT:.6g}: {case.np_total} particles, {nsteps} steps and "
            f"3 PARTs in {wall:.3f} s ({launched['cellforce']} cellforce "
            f"launches); the lines' relaxation ({MOORED_TMAXIC} s at "
            f"{cfg.stable_dtm():.3e} s substeps) {carry.moor_init_s:.3f} s "
            f"on the host, {cfg.nsub} substep(s) per step; fairlead nodes "
            f"within {off:.2e} m of their fairleads; fairlead tensions "
            f"{[round(t, 4) for t in tens]} N; 3 MooringsLines files, "
            f"{len(rows) - 1} MooringsPoints rows; body center "
            f"{carry.st.ft.center[0].tolist()} ({smi})")
        csp, dom = sim.csp, sim.dom
        st = carry.st
        fts = st.ft
        ace = torch.zeros_like(st.vel)

        def rigid():
            face, fom = cfg.forces(fts, carry.moor, tabs=carry.tabs)
            return FT.run_floating(feats.floating, csp, fts, carry.tabs,
                                   carry.dt_pre, False, st.pos, st.vel,
                                   st.code, ace, ext_face=face,
                                   ext_fomegaace=fom)

        def substeps():
            return cfg.advance(carry.moor, fts, carry.dt_pre)

        carry, rec = coupling_timing("moored-box", sim.inner_step, carry, smi,
                                     {"rigid update with the lines": (2, rigid),
                                      "lines' advance": (1, substeps)})
        rec.update(floating_kernel_vs_plain("moored-box", csp, sim.opts, dom,
                                            carry, feats.floating, smi))
        rec.update(launches=launched["cellforce"], steps=nsteps,
                   moor_init_s=carry.moor_init_s, nsub=cfg.nsub)
        # the quasi-static lines and a force point through Features
        c0 = tuple(float(x) for x in case.state.ft.center[0].tolist())
        qs = MO.MooringCfg(nbodies=1, lines=tuple(
            MO.MooringLine(0, (c0[0] + s * 0.4, 0.0, 0.0),
                           (s * 0.1, 0.0, -0.05), 0.55, 2.9e3, 2.0)
            for s in (-1, 1)))
        fp = MO.ForcePointsCfg(nbodies=1, points=(MO.ForcePoint(
            0, (0.1, 0.0, 0.1), times=(0.0, 0.001), forces=(0, 0, 0,
                                                            2.0, 0, -1.0)),))
        qfeats = Features(floating=feats.floating, moorings=qs,
                          forcepoints=fp)
        qstep = make_step(csp, opts, dom, qfeats)
        qcarry = make_carry(case.state, csp, opts, dom, qfeats)
        qcarry, times, launched2 = run_steps(qstep, qcarry, 0, 20)
        single_phase_counts(launched2, "cellforce", 2, 20)
        qft = qcarry.st.ft
        check(all(bool(torch.isfinite(getattr(qft, k)).all())
                  for k in ("center", "fvel", "fomega", "angles")),
              "the quasi-static moored box went non-finite")
        d2h, qcarry = count_d2h(qstep, qcarry, 5)
        check(d2h == 1, f"quasi-static lines: {d2h} device-to-host copies "
              f"per step")
        face, fom = qs.forces(qft)
        say("moored-box", f"20 steps of the quasi-static MooringCfg (2 taut "
            f"lines) and a ForcePointsCfg through Features: p50 "
            f"{statistics.median(times) * 1e3:.3f} ms, {d2h:g} "
            f"device-to-host copy per step, the lines' force on the body "
            f"{face[0].tolist()} N, fvel {qft.fvel[0].tolist()} ({smi})")
        rec.update(quasi_static_p50_ms=statistics.median(times) * 1e3)
        return launched["cellforce"] + launched2["cellforce"], rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _obj_box(lo, hi):
    """An ``.obj`` of the box [lo, hi] (6 quads)."""
    v = [(float(x), float(y), float(z)) for x in (lo[0], hi[0])
         for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    return "\n".join(["v %r %r %r" % p for p in v]
                     + ["f %d %d %d %d" % tuple(i + 1 for i in q)
                        for q in quads]) + "\n"


def chrono_geometry(dp):
    """Phase 34's bodies in lattice indices: the flap (mk 51) downstream of
    the column and the collision box (mk 52) downstream of the obstacle,
    each one lattice step above the floor; and the flap's hinge point (its
    bottom layer's centre) and spring ends."""
    nf = tuple(int(round(s / dp)) for s in FLAP)
    i_flap = (int(round(0.6 / dp)), int(round(0.085 / dp)), 1)
    nb = int(round(COLBOX / dp))
    i_box = (int(round(1.2 / dp)), int(round(0.3 / dp)), 1)
    lo = np.array(i_flap) * dp
    size = np.array(nf) * dp
    rot = (float(lo[0] + size[0] / 2), float(lo[1] + size[1] / 2),
           float(lo[2]))
    top = (rot[0], rot[1], float(lo[2] + size[2]))
    return (i_flap, nf), (i_box, (nb, nb, nb)), rot, top


def chrono_xml(dp, tmax, tout):
    """Phase 34's case: the dam break with a floating flap (rhopbody 800)
    hinged to the ground at its lower edge (axis y), turning about it at 2
    rad/s, and held by a linear spring, and a collision box (rhopbody 800, ``box.obj``) on the fixed
    floor mesh (``floor.obj``), ``<collision>`` on."""
    (i_flap, nf), (i_box, nb), rot, top = chrono_geometry(dp)
    draw = (_lattice_box(51, i_flap, nf, dp) + "\n"
            + _lattice_box(52, i_box, nb, dp))
    # the flap turns at 2 rad/s about its hinge from the start
    arm = float(nf[2]) * dp / 2
    casedef = (
        '<floatings><floating mkbound="51" rhopbody="800">'
        f'<linearvelini x="{2.0 * arm!r}" y="0" z="0"/>'
        '<angularvelini x="0" y="2" z="0"/></floating>'
        '<floating mkbound="52" rhopbody="800" property="box"/></floatings>'
        f'<properties>{_property("box", BOX_PROPS)}'
        f'{_property("wall", WALL_PROPS)}<links><link mkbound="0" '
        'property="wall"/></links></properties>')

    def p(tag, x):
        return f'<{tag} x="{x[0]!r}" y="{x[1]!r}" z="{x[2]!r}"/>'

    special = f"""<chrono>
   <collision activate="true"><distancedp value="0.5"/></collision>
   <bodyfixed id="ground" mkbound="0" modelfile="floor.obj"/>
   <bodyfloating id="flap" mkbound="51"/>
   <bodyfloating id="box" mkbound="52" modelfile="box.obj"/>
   <link_hinge idbody1="flap" idbody2="ground">{p("rotpoint", rot)}
    <rotvector x="0" y="1" z="0"/></link_hinge>
   <link_linearspring idbody1="flap" idbody2="ground">{p("point_fb1", top)}
    {p("point_fb2", (top[0] + 0.3, top[1], top[2]))}
    <stiffness value="50"/><damping value="1"/><rest_length value="0.3"/>
   </link_linearspring>
  </chrono>"""
    return _dambreak_with(dp, tmax, tout, draw, casedef, special)


def chrono_meshes(dp):
    """(box.obj, floor.obj): the box's faces dp/2 outside its particles;
    a 0.5 x 0.5 m floor patch under it, 0.497 dp below its bottom face:
    the contact distance is 0.5 dp, so the box starts in contact with an
    overlap of 0.003 dp, where the contact about carries its weight."""
    _flap, (i_box, nb), _rot, _top = chrono_geometry(dp)
    lo = np.array(i_box) * dp - dp / 2
    hi = (np.array(i_box) + np.array(nb)) * dp + dp / 2
    zf = float(lo[2] - 0.497 * dp)
    cx, cy = (float(x) for x in (lo[:2] + hi[:2]) / 2)
    corners = [(cx + sx * 0.25, cy + sy * 0.25)
               for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    floor = "".join(f"v {x!r} {y!r} {zf!r}\n" for x, y in corners) \
        + "f 1 2 3 4\n"
    return _obj_box(lo, hi), floor


def chrono_path(device, smi):
    """Phase 34: Chrono in 3D through ``-case``: ``chrono_xml`` at DP_BENCH
    (~50 steps): the flap's hinge point stays within 1.5% of its arm of
    ``rotpoint`` and its off-axis angles under 0.02 rad
    (tests/test_chrono.py:79, :83), the collision box stays above the floor
    mesh, cellforce twice per step; then the timing with the rigid update
    (the KKT solve and the mesh contact) alone, one device-to-host copy per
    step, kernel 1's floating instance against its plain version; then a
    restart from PART 1 that leaves with JAX's message without
    ``-restartchrono`` and runs with it."""
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch.features import floating as FT
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    dp = DP_BENCH
    root = tempfile.mkdtemp(prefix="_smoke_chrono_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        path = os.path.join(root, "Chrono_Def.xml")
        with open(path, "w") as f:
            f.write(chrono_xml(dp, 3 * COUPLING_TOUT, COUPLING_TOUT))
        box_obj, floor_obj = chrono_meshes(dp)
        with open(os.path.join(root, "box.obj"), "w") as f:
            f.write(box_obj)
        with open(os.path.join(root, "floor.obj"), "w") as f:
            f.write(floor_obj)
        _flap, _box, rot, _top = chrono_geometry(dp)
        rot_t = torch.tensor(rot, dtype=torch.float32, device=device)
        log, ctx = [], {}

        def on_step(carry):
            ft = carry.st.ft
            if "c0" not in ctx:
                # the flap's initial centre: rotpoint less the hinge's
                # body-local anchor
                local = ctx["sims"][0].feats.chrono.local1[0]
                ctx["c0"] = rot_t - torch.tensor(local, dtype=torch.float32,
                                                 device=device)
            c0 = ctx["c0"]
            R = FT._euler_rot(ft.angles)[0]
            hinge = ft.center[0] + R @ (rot_t - c0)
            log.append((float((hinge - rot_t).norm()),
                        float(ft.angles[0, [0, 2]].abs().max()),
                        float(ft.center[1, 2]),
                        all(bool(torch.isfinite(getattr(ft, k)).all())
                            for k in ("center", "fvel", "fomega",
                                      "angles"))))

        out = os.path.join(root, "out")
        restore, sims = stepping_runs(on_step)
        ctx["sims"] = sims
        reset_counts()
        t0 = time.perf_counter()
        try:
            check(cli.main(["-case", path, "-sv:binx", "-nortimes",
                            "-dirout", out]) == 0,
                  "the -case run of the Chrono bodies failed")
        finally:
            restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        sim = sims[0]
        nsteps = len(log)
        check(nsteps >= 30, f"the Chrono run made {nsteps} steps")
        single_phase_counts(launched, "cellforce", 2, nsteps)
        arm = float((rot_t - ctx["c0"]).norm())
        drift = max(r[0] for r in log)
        tilt = max(r[1] for r in log)
        check(drift < 0.015 * arm, f"the flap's hinge point drifted "
              f"{drift:.3e} m, {drift / arm:.2%} of its arm")
        check(tilt < 0.02, f"the flap's off-axis angle reached {tilt:.4f} rad")
        check(all(r[3] for r in log), "the bodies went non-finite")
        feats = sim.feats
        cc = feats.chcontact
        zbox0 = float(cc.center0[1][2])
        zmin = min(r[2] for r in log)
        check(zmin > zbox0 - 0.5 * dp, f"the collision box sank "
              f"{(zbox0 - zmin) / dp:.3f} dp into the floor mesh")
        parts = read_parts(PD, out, sim.state.n, sim.csp.rhopzero)
        ft = sim.carry.st.ft
        say("chrono-3d", f"-case with a hinged flap ({FLAP} m) and a "
            f"collision box at dp {dp:.6g}: {sim.state.n} particles, "
            f"{nsteps} steps and PARTs {sorted(parts)} in {wall:.3f} s "
            f"({launched['cellforce']} cellforce launches); hinge point "
            f"within {drift:.3e} m of rotpoint ({drift / arm:.3%} of the "
            f"{arm:.4f} m arm), off-axis angles <= {tilt:.2e} rad; the box's "
            f"centre z from {zbox0:.6f} to {float(ft.center[1, 2]):.6f} (its "
            f"lowest {zmin:.6f}); flap fomega {ft.fomega[0].tolist()} ({smi})")
        carry = sim.carry
        csp, dom = sim.csp, sim.dom
        st = carry.st
        ace = torch.zeros_like(st.vel)

        def rigid():
            return FT.run_floating(feats.floating, csp, st.ft, carry.tabs,
                                   carry.dt_pre, False, st.pos, st.vel,
                                   st.code, ace, chrono=feats.chrono,
                                   chcontact=feats.chcontact)

        def rigid_plain():
            return FT.run_floating(feats.floating, csp, st.ft, carry.tabs,
                                   carry.dt_pre, False, st.pos, st.vel,
                                   st.code, ace)

        carry, rec = coupling_timing("chrono-3d", sim.inner_step, carry, smi,
                                     {"rigid update with Chrono": (2, rigid),
                                      "rigid update alone": (2, rigid_plain)})
        rec.update(floating_kernel_vs_plain("chrono-3d", csp, sim.opts, dom,
                                            carry, feats.floating, smi))
        rec.update(launches=launched["cellforce"], steps=nsteps,
                   hinge_drift=drift / arm, tilt=tilt)
        # a restart from PART 1: JAX's gate, then the run with the flag
        again = ["-case", path, "-partbegin:1", out, "-sv:binx", "-nortimes",
                 f"-tmax:{2 * COUPLING_TOUT!r}", "-dirout",
                 os.path.join(root, "again")]
        try:
            cli.main(again)
            refused = None
        except SystemExit as e:
            refused = str(e)
        check(refused is not None and "-restartchrono" in refused,
              f"a restart of the Chrono case without -restartchrono: "
              f"{refused!r}")
        reset_counts()
        check(cli.main(again + ["-restartchrono"]) == 0,
              "the restart with -restartchrono failed")
        launched2 = counts()
        check(os.path.exists(os.path.join(root, "again", "Part_0002.bi4")),
              "the restart wrote no PART 2")
        say("chrono-3d", f"restart from PART 1: without -restartchrono "
            f"\"{refused}\"; with it, PART 2 written "
            f"({launched2['cellforce']} cellforce launches) ({smi})")
        return launched["cellforce"] + launched2["cellforce"], rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- phases 35-36: the neighbour-list mode and the tools ---------------------
NBR_STEPS = 50           # phase 35: steps of each layout after NBR_WARM
NBR_WARM = 5
NBR_TINY_M = 8           # phase 35: a capacity every target overflows
TOOL_POINTS = (40, 10, 25)   # phase 36: MeasureTool's -points grid (10^4)
TOOL_COLUMNS = (40, 5)       # phase 36: -elevation columns along x, y
KEPT = {}                # files an earlier phase keeps for phase 36


def by_id_pos(st):
    out = torch.empty_like(st.pos)
    out[st.idp] = st.pos
    return out


def nbrlist_path(device, smi):
    """Phase 35: the 3D dam break at DP_BENCH under ``SolverOpts(
    use_nbrlist=True)`` (``auto_m``, ``nbr_skin`` 0.5) beside the default
    layout, both from :func:`flowing_state`: the default layout's
    NBR_WARM + NBR_STEPS steps, then the list's steps to the same time.
    Step counts within 2, positions by id within 0.05 dp, overflow 0,
    cellforce exactly twice per step and no other kernel, one
    device-to-host copy per step, the rebuilds; the p50 step of each, the
    overflow count's ms per rebuild and the candidates per in-support pair
    of each layout; kernel 1 against its plain version on the list's
    final layout with its bound; then a run with ``nbr_m`` NBR_TINY_M that
    must leave through ``check_diagnostics`` with the overflow message.
    Returns (cellforce launches of the list's run, its record)."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    from dualsphysics_multilayer_tpu_torch.ops import nbrlist as NB
    case = cases.dambreak3d(dp=DP_BENCH, obstacle=True, device=device)
    csp, n = case.csp, case.np_total
    base = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    listed = dataclasses.replace(base, use_nbrlist=True)
    st0 = flowing_state(case, device)
    runs = {}
    target = None
    for label, opts in (("default", base), ("nbrlist", listed)):
        step = W.make_step(csp, opts, case.dom)
        carry = W.make_carry(st0, csp, opts, case.dom)
        nrebuild0 = carry.nrebuild
        reset_counts()
        times = []
        while (carry.nstep < NBR_WARM + NBR_STEPS if target is None
               else carry.t_host < target and carry.nstep < 2 * NBR_STEPS):
            t0 = time.perf_counter()
            carry = step(carry)
            torch.cuda.synchronize()
            if carry.nstep > NBR_WARM:
                times.append(time.perf_counter() - t0)
        launched = counts()
        single_phase_counts(launched, "cellforce", 2, carry.nstep)
        check_state(carry, carry.nstep, nrebuild0)
        target = carry.t_host if target is None else target
        cand, pairs = pair_counts(csp, carry.dom, carry.cells, carry.st.pos,
                                  carry.st.code, inclusive=False)
        runs[label] = dict(step=step, carry=carry, launched=launched,
                           p50=statistics.median(times),
                           mean=statistics.fmean(times), cand=cand,
                           pairs=pairs)
    a, b = runs["default"]["carry"], runs["nbrlist"]["carry"]
    check(abs(a.nstep - b.nstep) <= 2, f"the list made {b.nstep} steps to "
          f"t = {target:.6g} s, the default layout {a.nstep}")
    live = td_active(a.st) & td_active(b.st)
    dpos = float((by_id_pos(a.st) - by_id_pos(b.st))[live].abs().max())
    check(dpos < 0.05 * csp.dp, f"max |d pos| {dpos:.3e} m between the "
          f"layouts, over 0.05 dp")
    spec = NB.layout(csp, listed, case.dom)[1]
    check(b.dom == NB.list_domain(case.dom, csp, listed)
          and b.nbr_overflow is not None and int(b.nbr_overflow) == 0,
          "the list's run is not on the list's grid or counts an overflow")
    step = runs["nbrlist"]["step"]
    d2h, b = count_d2h(step, b, 10)
    check(d2h == 1, f"nbrlist: {d2h} device-to-host copies per step, "
          f"expected 1")
    count_ms = cuda_ms(lambda: NB.overflow_count(b.dom, b.cells, b.st.pos,
                                                 spec), reps=5)
    for label, r in runs.items():
        c = r["carry"]
        say("nbrlist", f"{label}: {c.nstep} steps to t {c.t_host:.6f} s, "
            f"p50 step {r['p50'] * 1e3:.3f} ms (mean {r['mean'] * 1e3:.3f}, "
            f"the divides included), {c.nrebuild} divides, "
            f"cells of {c.dom.scell * 1e3:.3f} mm ({c.dom.ncells} cells), "
            f"{r['cand']} candidates for {r['pairs']} in-support pairs "
            f"({r['cand'] / r['pairs']:.2f} per pair), cellforce "
            f"{r['launched']['cellforce']} launches ({smi})")
    say("nbrlist", f"{n} particles: max |d pos| by id {dpos:.3e} m "
        f"({dpos / csp.dp:.2e} dp) after {runs['nbrlist']['carry'].nstep} "
        f"list steps; capacity "
        f"{spec.m} (auto_m), row cap {spec.row_cap}, overflow 0; the "
        f"overflow count {count_ms:.3f} ms per rebuild (CUDA events); "
        f"{d2h:g} device-to-host copy per step ({smi})")
    rec = open_kernel_vs_plain("nbrlist", csp, listed, b.dom, b.st, smi,
                               cells=b.cells)
    rec.update(launches=runs["nbrlist"]["launched"]["cellforce"],
               steps=runs["nbrlist"]["carry"].nstep,
               p50_ms=runs["nbrlist"]["p50"] * 1e3,
               default_p50_ms=runs["default"]["p50"] * 1e3,
               mean_ms=runs["nbrlist"]["mean"] * 1e3,
               default_mean_ms=runs["default"]["mean"] * 1e3,
               count_ms=count_ms,
               cand_per_pair=runs["nbrlist"]["cand"] / runs["nbrlist"]["pairs"],
               default_cand_per_pair=(runs["default"]["cand"]
                                      / runs["default"]["pairs"]),
               rebuilds=b.nrebuild, max_dpos=dpos)

    tiny = dataclasses.replace(listed, nbr_m=NBR_TINY_M)
    sim = W.Simulation(csp, tiny, case.dom, st0, log=lambda *_: None)
    sim.errdir = tempfile.gettempdir()
    try:
        sim.run(tmax=2 * float(csp.dtini), tout=2 * float(csp.dtini))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "neighbour list's capacity" in refused,
          f"a run with nbr_m={NBR_TINY_M} left with {refused!r}")
    say("nbrlist", f"nbr_m={NBR_TINY_M}: check_diagnostics raised \""
        f"{refused}\" after {sim.carry.nstep} steps ({smi})")
    return rec["launches"], rec


def td_active(st):
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    out = torch.empty_like(st.code, dtype=torch.bool)
    out[st.idp] = td.is_active(st.code)
    return out


def vtk_sections(buf):
    """The sections of a legacy binary VTK file of ``io/vtkout.py``:
    (header line, big-endian array or None) pairs."""
    out, i, npts, scalar = [], 0, 0, "float"
    while i < len(buf):
        j = buf.index(b"\n", i)
        line, i = buf[i:j].decode(), j + 1
        w = line.split()
        if not w:
            continue
        size = dtype = None
        if w[0] == "POINTS":
            npts, size, dtype = int(w[1]), 3 * int(w[1]), ">f4"
        elif w[0] in ("VERTICES", "POLYGONS", "LINES"):
            size, dtype = int(w[2]), ">i4"
        elif w[0] == "POINT_DATA":
            npts = int(w[1])
        elif w[0] == "VECTORS":
            size, dtype = 3 * npts, ">f4"
        elif w[0] == "SCALARS":
            scalar = w[2]
        elif w[0] == "LOOKUP_TABLE":
            size, dtype = npts, ">i4" if scalar == "int" else ">f4"
        arr = None
        if size is not None:
            arr = np.frombuffer(buf, dtype, size, i)
            i += 4 * size
        out.append((line, arr))
    return out


NUMBER = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def same_outputs(label, want_dir, got_dir):
    """Raise unless the two directories hold the same files, none empty,
    with the same text and every number within rtol 1e-6 (abs 1e-9);
    VTK files section by section.  Returns the number of files."""
    names = sorted(os.listdir(want_dir))
    check(names and sorted(os.listdir(got_dir)) == names,
          f"{label}: files {names} on the card, "
          f"{sorted(os.listdir(got_dir))} on the CPU")
    for name in names:
        a = open(os.path.join(want_dir, name), "rb").read()
        b = open(os.path.join(got_dir, name), "rb").read()
        check(len(a) > 0, f"{label}: {name} is empty")
        if name.endswith(".vtk"):
            sa, sb = vtk_sections(a), vtk_sections(b)
            check([h for h, _ in sa] == [h for h, _ in sb],
                  f"{label}: {name} sections differ")
            pairs = [(x, y) for (_, x), (_, y) in zip(sa, sb)
                     if x is not None]
        else:
            ta, tb = (re.split(r"([;,\s]+)", f.decode()) for f in (a, b))
            check(len(ta) == len(tb), f"{label}: {name} differs in length")
            diff = [(x, y) for x, y in zip(ta, tb) if x != y]
            check(all(NUMBER.match(x) and NUMBER.match(y) for x, y in diff),
                  f"{label}: {name} differs outside its numbers")
            pairs = [(np.array([float(x) for x, _ in diff]),
                      np.array([float(y) for _, y in diff]))]
        for x, y in pairs:
            ok = np.array_equal(x, y) if x.dtype.kind == "i" else bool(
                np.all(np.abs(y - x) <= 1e-9 + 1e-6 * np.abs(x)))
            check(ok, f"{label}: {name} disagrees beyond rtol 1e-6")
    return len(names)


def tools_path(device, smi):
    """Phase 36: the tools over PARTs of the 3D dam break at DP_BENCH
    written by ``cli.main`` (PARTs 0-2, ~50 steps) and phase 32's
    PartFloat.fbi4: partvtk, measuretool (a -points grid of 10^4 points,
    then -elevation columns), isosurface (its default 2 dp node grid),
    computeforces on the obstacle (mk 12, which the water has not reached
    yet) and on the tank (mk 11), floatinginfo, flowtool, tracerparts and
    bifileinfo.  Each device tool runs on the card, then
    with -cpu on the same files: the files must agree (:func:
    `same_outputs`), none empty, and the iso-surface must hold triangles.
    Prints each run's host seconds per PART and the pairs its sums
    visited."""
    import shutil
    from dualsphysics_multilayer_tpu_torch import cli, tools
    from dualsphysics_multilayer_tpu_torch.tools import common as TC
    root = tempfile.mkdtemp(prefix="_smoke_tools_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        parts = os.path.join(root, "parts")
        check(cli.main(["-builtin", "dambreak3d", "-dp", repr(DP_BENCH),
                        f"-tmax:{2 * CLI_TOUT!r}", f"-tout:{CLI_TOUT!r}",
                        "-sv:binx", "-nortimes", "-dirout", parts]) == 0,
              "the CLI run for the tools failed")
        nparts = len([f for f in os.listdir(parts)
                      if re.fullmatch(r"Part_\d{4}\.bi4", f)])
        check(nparts == 3, f"{nparts} PARTs for the tools")
        boxes = os.path.join(root, "boxes.txt")
        with open(boxes, "w") as f:
            f.write("BOX @Column\n0 0 0\n0.4 0 0\n0.4 0.67 0\n0 0.67 0\n"
                    "0 0 0.4\n0.4 0 0.4\n0.4 0.67 0.4\n0 0.67 0.4\n"
                    "BOX @Ahead\n0.4 0 0\n1.6 0 0\n1.6 0.67 0\n0.4 0.67 0\n"
                    "0.4 0 0.4\n1.6 0 0.4\n1.6 0.67 0.4\n0.4 0.67 0.4\n")
        nx, ny, nz = TOOL_POINTS
        grid = (f"-pointsdef:ptls[x=0.01:{0.6 / nx!r}:{nx},"
                f"y=0.01:{0.65 / ny!r}:{ny},z=0.005:{0.35 / nz!r}:{nz}]")
        cx, cy = TOOL_COLUMNS
        columns = (f"-pointsdef:ptls[x=0.01:{0.6 / cx!r}:{cx},"
                   f"y=0.05:{0.6 / cy!r}:{cy}]")
        runs = [
            ("partvtk", ["-dirin", parts, "-savevtk", "OUT/fluid.vtk",
                         "-onlytype:-all,+fluid", "-vars:+press,+vol"]),
            ("measuretool", ["-dirin", parts, grid,
                             "-vars:+rhop,+vel,+press", "-savecsv",
                             "OUT/probe", "-onlytype:-all,+fluid"]),
            ("measuretool", ["-dirin", parts, columns, "-elevation",
                             "-savecsv", "OUT/eta.csv",
                             "-onlytype:-all,+fluid"]),
            ("isosurface", ["-dirin", parts, "-saveiso", "OUT/iso.vtk"]),
            ("computeforces", ["-dirin", parts, "-onlymk:12", "-viscoart:0.1",
                               "-savecsv", "OUT/forces",
                               "-momentex_xyz:0.9:0.3:0"]),
            ("computeforces", ["-dirin", parts, "-onlymk:11", "-viscoart:0.1",
                               "-savecsv", "OUT/forces",
                               "-momentex_xyz:0.2:0.3:0"]),
            ("floatinginfo", ["-dirin", KEPT["float"], "-savemotion",
                              "OUT/motion"]),
            ("flowtool", ["-dirin", parts, "-fileboxes", boxes, "-savecsv",
                          "OUT/flow.csv"]),
            ("tracerparts", ["-dirin", parts, "-savevtk", "OUT/traj.vtk",
                             "-maxparts:200"]),
            ("bifileinfo", [os.path.join(parts, "Part_0001.bi4")]),
        ]
        rec = {}
        for k, (name, argv) in enumerate(runs):
            label = f"{name}-{k}"
            dirs = {}
            for where in ("card", "cpu"):
                if where == "cpu" and name not in DEVICE_TOOLS:
                    break
                out = os.path.join(root, f"{label}-{where}")
                os.makedirs(out)
                args = [a.replace("OUT", out) for a in argv]
                TC.PAIR_STATS["visited"] = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()) as said:
                    rc = tools.main([name] + args + (
                        ["-cpu"] if where == "cpu" else []))
                if where == "card":
                    torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                check(rc in (0, None), f"{label} returned {rc}")
                check(name != "bifileinfo" or "ARRAY Posd" in said.getvalue(),
                      f"bifileinfo printed no Posd array")
                dirs[where] = out
                rec.setdefault(label, {})[where] = dict(
                    s_per_part=secs / (1 if name == "bifileinfo" else
                                       nparts),
                    pairs=TC.PAIR_STATS["visited"])
            if name != "bifileinfo":
                files = same_outputs(label, dirs["card"], dirs.get("cpu",
                                                                   dirs["card"]))
            else:
                files = 0
            r = rec[label]
            say("tools", f"{label}: " + ", ".join(
                f"{w} {v['s_per_part']:.3f} s per PART ({v['pairs']} pairs "
                f"summed)" for w, v in r.items())
                + (f"; {files} files, card and -cpu within rtol 1e-6"
                   if "cpu" in r else f"; {files} files") + f" ({smi})")
        iso = [f for f in os.listdir(dirs_of(root, "isosurface"))]
        tris = [sum(int(h.split()[1]) for h, _ in vtk_sections(open(
            os.path.join(dirs_of(root, "isosurface"), f), "rb").read())
            if h.startswith("POLYGONS")) for f in sorted(iso)]
        check(len(tris) == nparts and min(tris) > 0,
              f"the fluid's iso-surface triangles per PART: {tris}")
        say("tools", f"isosurface of the fluid at half its particle mass: "
            f"{tris} triangles per PART ({smi})")
        return rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


DEVICE_TOOLS = ("measuretool", "isosurface", "computeforces")


def dirs_of(root, name):
    return next(os.path.join(root, d) for d in sorted(os.listdir(root))
                if d.startswith(f"{name}-") and d.endswith("-card"))


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
    p50 = main_p50 = statistics.median(times)
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

    # 22. the CLI: -builtin dambreak3d with the DDT ramp, PARTs read back,
    # a restart, the ms per PART save
    paths["cli"] = cli_path(device, smi)

    # 23. a step's DDT ramp and table viscosity as launch values
    paths["step-values"] = step_values_path(device, main_p50, smi)

    # 24. the dam break from its XML through -case
    paths["xml-dambreak"], full_front = xml_dambreak_path(device, smi)
    records["cellforce"]["path_launches"] = paths

    # 25. the NN wet dam break from its XML through -case, SPH and FDA
    nn_paths = xml_nn_path(device, smi)
    records["nnforce_p1"]["path_launches"] = {
        "nn": records["nnforce_p1"]["launches"],
        "xml-nn-sph": nn_paths["xml-nn-sph"]["nnforce_p1"]}
    records["nnforce_p3"]["path_launches"] = {
        "nn": records["nnforce_p3"]["launches"],
        "xml-nn-sph": nn_paths["xml-nn-sph"]["nnforce_p3"]}
    records["nnforce_fda"]["path_launches"] = {
        "nn-fda": records["nnforce_fda"]["launches"],
        "xml-nn-fda": nn_paths["xml-nn-fda"]["nnforce_fda"]}

    # 26. half the dam break under Symmetry=1 through -case, and the SYM
    # instances of kernels 1 and 2 against the plain mirror pass
    sym = symmetry_path(device, registers, full_front, smi)
    for name in ("cellforce", "cellforce_cubic"):
        records[name]["instances"] = [
            dict(instance=k, **{f: r[f] for f in (
                "variant", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "flat_ms")})
            for k, r in sym.items() if r["kernel"] == name]

    # 27. <initialize> normals and velocity through -case, -initnorpla
    paths.update(initialize_path(device, smi))

    # 28. the NN wet dam break under mDBC walls from <initialize>
    nn_mdbc, nn_mdbc_records = nn_mdbc_path(device, registers, smi)
    for path, launched in nn_mdbc.items():
        for name, k in launched.items():
            records[name]["path_launches"][path] = k
    for key, r in nn_mdbc_records.items():
        name = r["kernel"]
        records[name]["instances"].append(dict(
            instance=key, launches=sum(
                v.get(name, 0) for v in nn_mdbc.values()),
            **{f: r[f] for f in ("variant", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "dbc_ms")}))

    # 29-31. open boundaries: channel2d through -builtin, the duct's
    # <special><inout> through -case, the periodic channel through the API
    paths["channel2d"], open_records = channel_path(device, smi)
    paths["duct-inout"], rec = duct_path(device, smi)
    open_records = {"channel2d": open_records, "duct-inout": rec}
    paths["periodic"], open_records["periodic"] = periodic_path(device, smi)
    records["cellforce"]["open_states"] = {
        k: {f: r[f] for f in ("rows", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "p50_ms", "busy_ms",
                              "ops", "idle_share")}
        for k, r in open_records.items()}

    # 32-34. the floating bodies' couplings: DEM in 3D, the moored box,
    # Chrono links and mesh contact in 3D, each through -case
    coupling_records = {}
    for name, path_fn in (("dem-3d", dem_path), ("moored-box", moored_path),
                          ("chrono-3d", chrono_path)):
        paths[name], coupling_records[name] = path_fn(device, smi)
    records["cellforce"]["coupling_states"] = {
        k: {f: r[f] for f in ("rows", "floating", "max_abs_err", "ms",
                              "wrapped_ms", "plain_ms", "bound_ms",
                              "bound_by", "p50_ms", "busy_ms", "ops",
                              "idle_share", "pieces")}
        for k, r in coupling_records.items()}

    # 35. the neighbour-list mode at full size beside the default layout
    paths["nbrlist"], records["cellforce"]["nbrlist_state"] = \
        nbrlist_path(device, smi)

    # 36. the post-processing tools over PARTs at full size, card and -cpu
    tools_path(device, smi)

    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep,
        launches=records[name]["launches"],
        max_abs_err=records[name]["max_abs_err"], ms=records[name]["ms"],
        plain_ms=records[name]["plain_ms"], bound_ms=records[name]["bound_ms"],
        bound_by=records[name]["bound_by"], library_ms=None,
        **{k: records[name][k] for k in ("instances", "path_launches",
                                          "open_states", "coupling_states",
                                          "nbrlist_state")
           if k in records[name]})
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
