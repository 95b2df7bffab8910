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
   each into separate zeroed buffers giving the same sha256 per output,
   and at this size each also in its wide instance (the phase table in a
   device array, as beyond 8 phases) on the same inputs, bit-equal to the
   parameter-table instance, the two timed alone in three alternating
   turns; the three kernels again at a third of the dp (330,781
   particles), then at
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
    save copies from the device, counted by ``io.partdata.HostCopy``, and
    the write of one such PART alone through the C++ writer
    (``native=True``, the default) and the pure writer, in turns, the
    files byte-equal;
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
    host seconds per PART and the pairs each sum visited;
37. domain decomposition (``parallel/sharding.py``): the dam break at
    DP_BENCH from rest on one device until its front is 5 cm past the
    2-rank slab edge (x = 0.82 m; about t = 0.27 s); then from that state
    20 one-device steps against 2 ranks on ``cuda:0`` over gloo
    (``ShardedSimulation(..., backend="gloo")``; gloo takes the CUDA
    tensors as they are): positions by id within 1e-4 dp after 20 steps,
    t within rtol 1e-5; after 200, overflow 0, the fluid density within
    10% of rho0, particles migrated and fluid ghost rows on both ranks;
    then 10 more steps, rank 0's traced with ``torch.profiler`` for its
    device-to-host copies (the step's flag copy and gloo's inside its
    collectives); each kernel's launches on each rank, counted there,
    against the one-device run's per step; rows and bytes exchanged per
    step, migrants per rebuild, rebuilds, each step's p50 against the
    one-device p50 (one card shared: a check, not a speed), the
    exchange's ms per interaction (CUDA events); the ranks run
    ``shard_job``, this script's own job of counted, timed and traced
    steps; then one rank over NCCL (world 1: its group start and
    all_reduce on the card) within 1e-6 dp of the one-device run;
38. the other sharded paths, 2 ranks on ``cuda:0`` over gloo, 20 steps
    (and 10 traced) each from one start of the ranks, against their
    one-device runs
    (positions by id within 1e-4 dp): the NN wet dam break at 37,143
    particles from rest (kernels 4-6 on both ranks; its wet bed crosses
    x = 1.0 m, so fluid ghosts from the first step), the 2D floating box
    at 62,033 (body centre within 1e-6 m) and the 2D mDBC dam break at
    61,589 (the pre-pass between two refreshes, a 2-cell halo); then
    ``dsphtorch -builtin dambreak3d -shard:1`` through ``cli.main``, its
    PARTs read back and equal by id, within 1e-6 dp, to the unsharded
    CLI's;
39. the open boundaries and DEM under domain decomposition, 2 ranks on
    ``cuda:0`` over gloo, one start of the ranks, 20 steps (and 10
    traced) per job against its one-device run: ``-builtin channel2d``
    at 64,120 live particles (the case ``cli.main`` hands its
    ``-shard:2`` run) and phase 30's duct through ``load_case`` at
    283,711 (inlet/outlet zones; the live fluid count within 2, its
    centre of mass within 2e-3 dp, each live id once, a spawn on rank 0,
    fluid migrated to rank 1), phase 32's DEM boxes through ``-case`` at
    274,219 with box 51 across the slab edge (body centres within 1e-6
    m, velocities within 1e-5 m/s; each body's rows on each rank; DEM's
    pass on rank 0 timed with CUDA events) and a y-periodic 3D tank of
    ``tests/test_sharding.py:513-575``'s geometry at dp 0.4/60 m, its
    fluid flowing along +y (positions by id within 1e-4 dp, rows wrapped
    and migrated); the inout and periodic jobs' slab edge sits 5 um right
    of a fluid column (the channel's fluid starts at its inlet's velocity);
    kernel 1's launches on each rank against
    the one-device run's per step, rows and bytes per refresh, each
    job's p50 against the one-device p50;
40. the 3D coastal run-up (BASELINE config 5, ``cases.coastal_runup3d``
    at coastal.py's geometry: 8 x 2 m, 0.5 m deep, a 1:10 beach from x =
    3 m, a solitary wave of 0.12 m; dp = (V/N)^(1/3) by coastal.py's
    rule), Fourtakas, DBC, through ``make_carry``/``make_step``: (a) N =
    10M (~11M particles): the count, the grid, the host build's seconds
    and memory, the card's bytes per particle; kernel 1 against its plain
    version on the initial state (phase 3's rule; the kernel alone by
    CUDA events, 20 launches, median of 5, the plain version once) with
    its bound; 5 warm-up and 30 timed steps (more, up to 100, until a
    rebuild has happened): kernel 1 exactly twice a step and no other
    kernel, a rebuild, a finite state, the fluid density within 10%,
    overflow 0, the Kahan position residual written and within its
    position's ulp, the p50 and particle-steps/s, ``utils.timers.
    profile_step``'s three phases, 3 steps traced (idle share, device
    operations) and one device-to-host copy per step over 5; (b) one PART
    of that state through ``io.output.OutputManager`` (the C++ writer),
    read back and equal by id (pos, vel, rho, code), its ms and bytes;
    (c) N = 50M (~54M particles): the build, 2 warm-up and 5 timed steps
    with the checks of (a) but the rebuild, the p50 and the card's peak
    bytes per particle; (d) N = 2M over 2 ranks on ``cuda:0`` over gloo,
    SHARD_COMPARE steps against the one-device run by id within 1e-6 dp,
    live rows per rank, the report of phase 37; (e) ``dsphtorch -builtin
    coastal_runup3d -dp 0.04`` (still water) through ``cli.main``, PARTs
    0-2 read back; (f) ``parallel.sharding.dryrun(2, backend="gloo")``:
    its three lines, kernel 1 six times on rank 0;
41. NN phase tables beyond 8: the wet dam break of phase 5 with its mud
    column in 11 strata (``layered_dambreak_nn``: 12 phases of distinct
    rest density, consistency, yield stress, power index and, every
    third stratum, bi-viscosity constants; 37,143 particles), where
    kernels 4-6 run their wide instances (``nnforce_*_kernel<...,1>``:
    the table in a device array, ``NnParams.phtab``): each kernel against
    its plain pass and the whole interaction in phase 5's five
    configurations by phase 5's rule; 5 + 50 SPH Morris steps (nnforce_p1
    and nnforce_p3 exactly twice per step) and 5 + 20 FDA Morris steps
    (nnforce_fda twice per step) with phase 6's checks for every phase; a
    12-phase ``<nnphases>`` XML (the strata drawn as boxes) through
    ``cli.main(["-case", ...])``, SPH, PART 3 read back with every
    phase's density within 10%, nnforce_p1 and nnforce_p3 twice per step
    and no other kernel; the kernels' times printed beside phase 5's
    2-phase ones (parameter table and device table) and the p50 steps
    beside phases 6-7's;
42. a domain without a cell skin (cells of the kernel size, JAX
    ``celldiv.make_domain``'s default): the 3D dam break of phase 4 at
    267,469 particles beside the case's skinned domain, 5 + 20 steps of
    each from phase 4's flow: cellforce exactly twice per step and no
    other kernel, a rebuild at every step of the skinless run (each of
    its interactions divides its own positions), overflow 0, the density
    within 10%, positions by id within 1e-4 dp of the skinned run's, the
    p50 step of each;
43. the last inputs JAX runs and the port refused
    (:func:`last_inputs_path`): phase 26's half dam break (133,804
    particles) through the library with ``SolverOpts(symmetry=True,
    tvisco=LAMINAR_SPS)``, kernel 3's four SYM instances (Wendland and
    cubic, with and without NO_FIXED shifting) against the plain mirror
    pass (rtol 2e-3, 4e-3 cubic), each timed alone beside the same
    instance without the plane, with its bound ((pairs + image pairs) x
    its operations per pair) and ptxas registers and spills, then 5 + 20
    steps of ``-viscolamsps:1e-6 -shifting:2`` with the plane
    (cellforce_lamsps_sym exactly twice per step); a half tank with a
    0.1 m floating box on the plane (``half_float_xml``, loaded without
    the Symmetry key, given ``symmetry=True``): the FT x SYM instances of
    kernels 1-3 against their plain versions alike, then 5 + 20 steps
    (cellforce_sym twice per step, the box rigid, its centre and velocity
    printed); phase 30's inout duct on cells of the kernel size beside
    the case's domain, 5 + 20 steps each (a rebuild every step of the
    skinless run, the same live ids, spawns and overflow, positions by id
    within 1e-4 dp); and skinless domains over 2 ranks sharing the card
    (gloo), 20 steps each from one start of the ranks: the dam break from
    phase 37's state past the slab edge, the NN wet dam break and the
    duct with its zones, against their one-device skinless runs
    (positions by id within 1e-4 dp), a rebuild every step, a fresh
    ghost exchange before each interaction (and before the duct's
    extrapolation), no refresh, the collectives and exchanges per step
    and rank 0's p50;
44. the twins of the JAX package's examples and of verify_e2e.py on the
    card (:func:`twins_path`): ``port_verify_e2e.py`` to its tmax of 0.2 s
    with its own pass rule (overflow 0, density in (900, 1150), the front's
    advance/H > 0.5 at t* > 1; a FAIL fails the phase); the twins of
    examples/02-04 through ``main(max_steps=1)`` at their own dp, to their
    first save; the twin of 01 (``sh examples/torch/01_dambreak.sh``) on
    phase 24's dam-break XML and that of 05 on phase 25's NN XML (SPH),
    each in a process of its own for 2 intervals, whose CLI prints the
    child's kernel launches; the twin of 06, the dry run over 2 ranks
    sharing the card over gloo; and a y-periodic duct with an inlet and an
    outlet whose velocity and density are extrapolated
    (:func:`periodic_duct`, ~200k particles) for 20 steps.  Each run
    launches kernel 1 twice per step (05: kernels 4 and 5) and no other,
    keeps its state finite and its fluid density within 10% of rho0, and
    ends with overflow 0; each prints its p50 step (the CLI twins their
    mean step) and wall seconds.

Each kernel is timed twice: alone (``ms``: CUDA events around 20
back-to-back launches of the C launcher on prepared inputs, per launch,
median of 5) and with its wrapper (channel packing, checks, allocation;
median of 7).  The last two lines are a JSON record of the kernels (with
each kernel's bound: the larger of the bytes it must move over 3.35 TB/s
and the f32 operations of this run's in-support pairs over 67 TFLOP/s,
the H100 SXM peaks; for the FMA probe its steps over the SM's 128 f32
lanes at the SM's maximum clock; for the window-load probe the largest of
its device-memory bytes, its loads' bytes through the SMs' load paths and
its operations; the rows of kernels 1-4 and 6 list their other
instances under ``instances``: the SYM instances of phases 26 and 43
(with the instance without the plane alone as ``flat_ms``, and phase
43's with their ptxas ``registers`` and ``spills``), the mDBC runs
of kernels 4 and 6 with their DBC time as ``dbc_ms``, the wide instances of
kernels 4-6 at 12 phases of phase 41; the NN kernels' rows add
``table_ms``, phase 5's times of each with the parameter table and the
device table) and the result line
``{"ok": true, "device": {...}}``.  Every launch count comes from its
path's run, counted from 0 just before it (the probes' from their
tables); cellforce's row adds ``path_launches``, its launches on the dam
break (phase 4), the Verlet path, the wave flume, the full flume, the CLI
(phase 22), the main path with step values (phase 23) and the XML dam
break (phase 24), and the ``<initialize>`` and ``-initnorpla`` runs
(phase 27), the channel, the duct and the periodic channel (phases
29-31), the couplings (phases 32-34), the neighbour-list mode (phase
35), the coastal run-up (phase 40: ~10M, ~50M, the CLI and rank 0 of
the dry run), the skinless domain (phase 42), phase 43's half tank
with its box and skinless duct (kernel 3's row: its symmetry path) and
phase 44's runs (``verify-e2e``, ``twin-01`` to ``twin-06`` but 05,
``periodic-inout``; kernels 4-5: ``twin-05``), with
``open_states``, kernel 1
against its plain version on the final states of phases 29-31 and their
step's p50 and trace, ``coastal_states``, phase 40's at ~10M (kernel
against plain, p50, trace, ``profile_step``, memory, the PART) and ~50M
(p50, memory), and ``coupling_states``, the same for phases 32-34
with the couplings' pieces alone (DEM's pass, the rigid update with the
lines, the lines' substep, the rigid update with Chrono), and
``nbrlist_state``, the same for phase 35 on the list's layout with its
p50 step beside the default layout's, the overflow count's ms and each
layout's candidates per pair, and ``shard_launches``, each rank's
launches of that kernel on the sharded paths of phases 37-39, 40 and 43,
counted in the rank; the NN
kernels' rows add theirs on phases 6-7, the XML runs of phase 25, the
mDBC runs of phase 28 and the 12-phase runs of phase 41.
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


def nn_table_ms(name, table, wide, rows, outs, ins=(), turns=3):
    """NN kernel ``name`` with the parameters' phase table (params
    ``table``) and with the device table (``wide``) on the same inputs:
    raises unless their outputs are bit-equal; then each alone
    (:func:`launch_ms`), in ``turns`` alternating turns.  Returns the two
    medians (ms)."""
    args = rows + list(ins)
    got = []
    for params in (table, wide):
        bufs = [None if o is None else torch.zeros_like(o) for o in outs]
        check(bare_launcher("nnforce", f"dsph_{name}", params,
                            args + bufs)() == 0, f"{name} launch failed")
        torch.cuda.synchronize()
        got.append([o for o in bufs if o is not None])
    check(all(torch.equal(a, b) for a, b in zip(*got)),
          f"{name}: the device table's instance differs from the parameter "
          f"table's on the same inputs")
    ms = ([], [])
    for _ in range(turns):
        for k, params in enumerate((table, wide)):
            ms[k].append(launch_ms(bare_launcher("nnforce", f"dsph_{name}",
                                                 params, args + outs)))
    return statistics.median(ms[0]), statistics.median(ms[1])


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
    ms = instance_ms(csp, opts, dom, cells, args, spstau, ftomassp, **over)
    wrapped_ms = cuda_ms(lambda: CF.interaction_forces_cuda(*run, **over),
                         reps)
    plain_ms = cuda_ms(lambda: F.interaction_forces_plain(*run, **over), reps)
    return err, ms, wrapped_ms, plain_ms


def instance_ms(csp, opts, dom, cells, args, spstau=None, ftomassp=None,
                **over):
    """One cellforce instance alone (:func:`launch_ms`) on these inputs
    (``over``: a step's launch values, as for :func:`compare_cellforce`)."""
    from dualsphysics_multilayer_tpu_torch import TpShifting, TpVisco
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    n, dev = args[0].shape[0], args[0].device
    lam = opts.tvisco == TpVisco.LAMINAR_SPS
    shift = opts.shiftmode != TpShifting.NONE
    pospress, velrho, kind = CF.channels(csp, *args)
    outs = [torch.empty((n, 3), device=dev), torch.empty(n, device=dev),
            torch.empty(n, device=dev),
            torch.empty((n, 6), device=dev) if lam else None,
            torch.empty((n, 4), device=dev) if shift else None,
            torch.empty(n, dtype=torch.bool, device=dev) if shift else None]
    return launch_ms(bare_launcher(
        "cellforce", f"dsph_{CF.kernel_name(csp, opts)}",
        CF.make_params(csp, opts, dom, n, **over),
        [pospress, velrho, kind, cells.cell, cells.begin,
         spstau if lam else None,
         CF.floating_mass(csp, opts, args[3], ftomassp)] + outs))


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
                        full=True, wide_too=False):
    """Phases 5 and 41: each NN kernel against its plain pass on the same
    inputs, two launches of each bit-equal, then the whole interaction in
    five configurations (``full``); with ``wide_too``, each kernel's wide
    instance (the phase table in a device array) on the same inputs too,
    bit-equal to the parameter-table one, the two timed in turns (phase
    41).  Returns the kernels' records (without launches)."""
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
        params = NF.make_params(csp, opts, phases, dom, n,
                                NF.table_device(phases, device))
        ms, same = nn_launch_ms(name, params, rows, outs, ins)
        wrapped_ms = cuda_ms(lambda: kernel_fn(*run))
        plain_ms = cuda_ms(lambda: plain_fn(*run))
        b = bound(state_bytes + n * out_bytes, pairs * OPS_PER_PAIR[name])
        records[name] = dict(max_abs_err=errs["ace"], ms=ms, plain_ms=plain_ms,
                             bound_ms=b[0], bound_by=b[1])
        if wide_too:
            records[name]["table_ms"], records[name]["wide_ms"] = \
                nn_table_ms(name, params, NF.make_params(
                    csp, opts, phases, dom, n, str(device)), rows, outs, ins)
            same += (f"; parameter table {records[name]['table_ms']:.4f} ms, "
                     f"device table {records[name]['wide_ms']:.4f} ms, "
                     f"bit-equal")
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


def nn_path(case, phases, opts, device, nwarm, nsteps, label, smi, csp=None,
            p50s=None):
    """Phases 6, 7, 16, 17 and 41: ``nwarm + nsteps`` NN steps from a
    flowing start, under the case's constants or ``csp``; returns (the
    launch counts, the step, the final carry) and puts the p50 step (s)
    in ``p50s[label]``."""
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
    if p50s is not None:
        p50s[label] = p50
    say(label, f"{n} particles, {nsteps} steps after {nwarm} warm-up: p50 step "
        f"{p50 * 1e3:.3f} ms, {n / p50:.1f} particle-steps/s; launches "
        f"{launched}, {carry.nrebuild - nrebuild0} rebuilds inside the steps, "
        f"t {carry.t_host:.6f} s, dt_pre {float(carry.dt_pre):.4g} s, fluid rho "
        + ", ".join(f"phase {k} [{a:.2f}, {b:.2f}]" for k, (a, b) in
                    enumerate(ranges)) + f" ({smi})")
    return launched, step, carry


def nn_instance(kernel, csp, opts, wide=False):
    """The ptxas name of the instance of ``kernel`` that these constants and
    options launch, with the parameters' phase table or (``wide``) the
    device table."""
    from dualsphysics_multilayer_tpu_torch import TpShifting
    from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
    ker = csp.tkernel.value
    if kernel == "nnforce_p3":
        return f"nnforce_p3_kernel<{ker},{NF.VISC[opts.tvisco]},{int(wide)}>"
    return (f"{kernel}_kernel<{ker},{int(opts.shiftmode != TpShifting.NONE)},"
            f"{int(wide)}>")


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


def write_ms(part, directory, reps=5):
    """(ms of ``io.jbinary.write_file`` of the tree of the file ``part``
    with native=True and with native=False, the medians of ``reps`` each
    in turns; the file's bytes).  The two files must be byte-equal."""
    from dualsphysics_multilayer_tpu_torch.io import jbinary as JB
    tree = JB.read_file(part)
    os.makedirs(directory, exist_ok=True)
    out = {True: os.path.join(directory, "native.bi4"),
           False: os.path.join(directory, "pure.bi4")}
    times = {True: [], False: []}
    for _ in range(reps):
        for native in (True, False):
            t0 = time.perf_counter()
            JB.write_file(out[native], tree, filecode="JPartDataBi4",
                          native=native)
            times[native].append((time.perf_counter() - t0) * 1e3)
    with open(out[True], "rb") as a, open(out[False], "rb") as b, \
            open(part, "rb") as c:
        got, want, orig = a.read(), b.read(), c.read()
    check(got == want == orig, "the C++ and the pure writer's files differ")
    return (statistics.median(times[True]), statistics.median(times[False]),
            len(got))


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
        native_ms, pure_ms, size = write_ms(
            os.path.join(saves, "binx", PD.part_filename(0)),
            os.path.join(saves, "rewrite"))
        say("cli", f"the write of that PART ({size} bytes) alone: the C++ "
            f"writer (native=True, the default) {native_ms:.3f} ms, the "
            f"pure writer (native=False) {pure_ms:.3f} ms, median of 5 each "
            f"in turns, the files byte-equal, host clock ({smi})")
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
            flat_ms = instance_ms(csp, dataclasses.replace(o, symmetry=False),
                                  case.dom, cells, args)
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


def layered_nn_xml(phases, dp, velgrad, tmax, tout):
    """Phase 25's XML with the mud column drawn as ``phases.count - 1``
    strata of equal height, mkfluid 1.. from the bottom, and the phase
    table ``phases`` in ``<nnphases>``."""
    layers = phases.count - 1
    h = 0.3 / layers
    mud = "".join(
        f'<setmkfluid mk="{k}"/><drawbox><boxfill>solid</boxfill>\n'
        f'    <point x="0" y="0" z="{(k - 1) * h!r}"/>'
        f'<size x="0.5" y="0" z="{h!r}"/></drawbox>\n   '
        for k in range(1, layers + 1))
    table = "".join(
        f'<phase mkfluid="{p.mkfluid}"><rhop value="{p.rho0!r}"/>'
        f'<csound value="{p.csound!r}"/><visco value="{p.visco!r}"/>'
        f'<tau_yield value="{p.tau_yield!r}"/>'
        f'<tau_max value="{p.tau_max!r}"/><Bi_multi value="{p.bi_multi!r}"/>'
        f'<HBP_m value="{p.hbp_m!r}"/><HBP_n value="{p.hbp_n!r}"/></phase>\n'
        for p in phases.phases)
    xml = NN_XML.format(dp=dp, cs_w=0.0, cs_m=0.0, velgrad=velgrad,
                        tmax=tmax, tout=tout)
    start = xml.index('<setmkfluid mk="1"/>')
    xml = xml[:start] + mud + xml[xml.index('<setmkbound'):]
    start = xml.index("<nnphases>") + len("<nnphases>\n")
    return xml[:start] + table + xml[xml.index("  </nnphases>"):]


def nn_phases_path(device, registers, records, p50s, smi):
    """Phase 41: the NN wet dam break with a phase table of 12 phases
    (``layered_dambreak_nn``: its mud column in 11 strata of distinct rest
    density, consistency, yield stress, power index and, every third,
    bi-viscosity constants) at phase 5's size: kernels 4-6 (their wide
    instances: the table in a device array) against their plain passes and
    the whole interaction in phase 5's five configurations, by phase 5's
    rule; 5 + 50 SPH Morris steps (nnforce_p1 and nnforce_p3 twice per
    step) and 5 + 20 FDA Morris steps (nnforce_fda twice per step) through
    ``make_carry``/``make_nn_step``, each phase's density within 10%; a
    12-phase ``<nnphases>`` XML through ``cli.main(["-case", ...])``, SPH,
    PARTs 0-3 read back; the times beside phase 5's 2-phase kernels and
    phases 6-7's steps.  Returns ({path: {kernel: launches}},
    {instance: record})."""
    import shutil
    import tempfile
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    case, phases = NM.layered_dambreak_nn(dp=NN_DP, device=device)
    check(phases.count == 12, f"{phases.count} phases")
    counts12 = torch.bincount(case.state.code[(case.state.code >> 16) & 3 == 3]
                              & 0xFFFF).tolist()
    check(len(counts12) == 12 and min(counts12) > 0,
          f"fluid particles per phase {counts12}")
    say("nn12-case", f"{case.np_total} particles, 12 phases, fluid per phase "
        f"{counts12}, rho0 " + ", ".join(f"{p.rho0:g}" for p in phases.phases))
    kern = nn_kernels_vs_plain(case, phases, device, smi,
                               label="nn12-kernel-vs-plain")
    out, instances = {}, {}
    for label, opts, kernels in (
            ("nn12-main-path", nn_opts("LAMINAR_SPS", "SPH"),
             ("nnforce_p1", "nnforce_p3")),
            ("nn12-fda-path", nn_opts("LAMINAR_SPS", "FDA"),
             ("nnforce_fda",))):
        nwarm, nsteps = (5, 50) if len(kernels) == 2 else (5, 20)
        launched, _, _ = nn_path(case, phases, opts, device, nwarm, nsteps,
                                 label, smi, p50s=p50s)
        want = {**dict.fromkeys(launched, 0),
                **{k: 2 * (nwarm + nsteps) for k in kernels}}
        check(launched == want, f"{label}: {launched} in {nwarm + nsteps} "
              f"steps, expected {kernels} twice per step and no other kernel")
        out[label] = {k: launched[k] for k in kernels}
        for k in kernels:
            instance = nn_instance(k, case.csp, opts, wide=True)
            instances[instance] = dict(
                kernel=k, variant="12 phases", launches=launched[k],
                registers=registers.get(instance, "?"), **kern[k])

    # the same table through an XML: -case, SPH
    root = tempfile.mkdtemp(prefix="_smoke_nn12_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        path = os.path.join(root, "WetDambreakLayers_Def.xml")
        with open(path, "w") as f:
            f.write(layered_nn_xml(phases, NN_DP, 2, 3 * NN_XML_TOUT,
                                   NN_XML_TOUT))
        loaded, _opts, _run = load_case(path, device=device)
        check(loaded.meta["phases"] == phases,
              f"the XML's phases {loaded.meta['phases']}")
        d = os.path.join(root, "out")
        reset_counts()
        check(cli.main(["-case", path, "-sv:binx", "-nortimes", "-dirout",
                        d]) == 0, "the 12-phase -case run failed")
        torch.cuda.synchronize()
        launched = counts()
        p = PD.read_part(os.path.join(d, PD.part_filename(3)))
        nsteps = p["nstep"]
        want = {**dict.fromkeys(launched, 0),
                **{k: 2 * nsteps for k in ("nnforce_p1", "nnforce_p3")}}
        check(launched == want, f"xml 12 phases: {launched} in {nsteps} "
              f"steps, expected nnforce_p1 and nnforce_p3 twice per step")
        code = p["code"].astype(np.int64)
        fluid = (code >> 16) & 3 == 3
        for i, ph in enumerate(phases.phases):
            r = p["rhop"][fluid & ((code & 0xFFFF) == i)]
            check(r.size > 0 and 0.9 * ph.rho0 <= r.min()
                  and r.max() <= 1.1 * ph.rho0,
                  f"xml 12 phases: phase {i} density out of +-10%")
        check(bool(np.isfinite(p["pos"]).all()), "xml 12 phases: Posd")
        out["xml-nn12-sph"] = {k: launched[k]
                               for k in ("nnforce_p1", "nnforce_p3")}
        say("nn12-xml", f"-case with 12 <nnphases>, {loaded.np_total} "
            f"particles: {nsteps} steps, launches {launched}, PART 3 read "
            f"back with every phase's density within 10% ({smi})")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    say("nn12-vs-2", "kernels alone, 12 phases (device table) against 2 "
        "(phase 5: parameter table / device table): " + "; ".join(
            f"{k} {kern[k]['ms']:.4f} ms against {records[k]['table_ms']:.4f}"
            f" / {records[k]['wide_ms']:.4f} ms"
            for k in ("nnforce_p1", "nnforce_p3", "nnforce_fda"))
        + f"; p50 step SPH {p50s['nn12-main-path'] * 1e3:.3f} ms against "
        f"{p50s['nn-main-path'] * 1e3:.3f}, FDA "
        f"{p50s['nn12-fda-path'] * 1e3:.3f} ms against "
        f"{p50s['nn-fda-path'] * 1e3:.3f} (phases 6-7; {smi})")
    return out, instances


SKINLESS_STEPS = 20      # phase 42: steps of each domain after 5 warm-up


def skinless_path(device, smi):
    """Phase 42: the 3D dam break at DP_BENCH on a domain without a cell
    skin (cells of the kernel size, JAX ``celldiv.make_domain``'s default,
    which the port runs with a rebuild at every step and a divide of its
    own at each interaction, ``wcsph.fresh_interaction``) beside the
    case's domain, both from :func:`flowing_state`: 5 + SKINLESS_STEPS
    steps of each, cellforce exactly twice per step and no other kernel,
    overflow 0, the density within 10%, a rebuild at every step of the
    skinless run, positions by id within 1e-4 dp of the other run's, the
    p50 step of each.  Returns the cellforce launches of the skinless
    run."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
    case = cases.dambreak3d(dp=DP_BENCH, obstacle=True, device=device)
    csp, d = case.csp, case.dom
    flat = cd.make_domain(d.posmin, [p + k * d.scell for p, k in
                                     zip(d.posmin, d.nc)], csp.kernelsize)
    check(W.skinless(csp, flat) and not W.skinless(csp, d),
          "the skinless domain has a skin")
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    st0 = flowing_state(case, device)
    runs = {}
    for label, dom in (("skinned", d), ("skinless", flat)):
        step = W.make_step(csp, opts, dom)
        carry = W.make_carry(st0, csp, opts, dom)
        nrebuild0 = carry.nrebuild
        carry, times, launched = run_steps(step, carry, 5, SKINLESS_STEPS)
        single_phase_counts(launched, "cellforce", 2, carry.nstep)
        check_state(carry, 5 + SKINLESS_STEPS, nrebuild0)
        fluid_rho_range(carry.st, True, csp.rhopzero)
        runs[label] = (carry, statistics.median(times), launched,
                       carry.nrebuild - nrebuild0)
    rebuilt = runs["skinless"][3]
    check(rebuilt == 5 + SKINLESS_STEPS, f"the skinless run rebuilt "
          f"{rebuilt} times in {5 + SKINLESS_STEPS} steps")
    a, b = runs["skinned"][0], runs["skinless"][0]
    live = td_active(a.st) & td_active(b.st)
    dpos = float((by_id_pos(a.st) - by_id_pos(b.st))[live].abs().max())
    check(dpos <= 1e-4 * csp.dp, f"max |d pos| {dpos:.3e} m between the "
          f"domains, over 1e-4 dp")
    say("skinless", f"{case.np_total} particles, {5 + SKINLESS_STEPS} steps "
        f"each: cells of {flat.scell * 1e3:.3f} mm (skinned "
        f"{d.scell * 1e3:.3f}); p50 step {runs['skinless'][1] * 1e3:.3f} ms "
        f"({rebuilt} rebuilds, 2 divides of its own a step) against "
        f"{runs['skinned'][1] * 1e3:.3f} ms ({runs['skinned'][3]} rebuilds); "
        f"max |d pos| by id {dpos:.3e} m ({dpos / csp.dp:.2e} dp); cellforce "
        f"{runs['skinless'][2]['cellforce']} launches ({smi})")
    return runs["skinless"][2]["cellforce"]


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
                   params="", base=None):
    """Phase 24's dam break (or ``base``, a form of it) with more geometry
    (``draw``), casedef nodes, ``<special>`` nodes and parameters."""
    xml = (base or DAMBREAK_XML).format(dp=dp, tmax=tmax, tout=tout)
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


def dem_boxes(dp, x=1.12, y=0.2):
    """Phase 32's boxes: lattice indices (start, count) of box 51 resting on
    the floor downstream of the obstacle, its corner at (``x``, ``y``), and
    of box 52 beside it, one lattice step away along x (the script moves it
    0.1 dp closer)."""
    n = int(round(BOX_SIDE / dp))
    i1 = (int(round(x / dp)), int(round(y / dp)), 1)
    i2 = (i1[0] + n + 1, i1[1], 1)
    return (i1, (n, n, n)), (i2, (n, n, n))


def dem_xml(dp, tmax, tout, **at):
    """Phase 32's case: the dam break with the two 0.1 m boxes (rhopbody
    800; ``at``: box 51's corner, :func:`dem_boxes`) and
    ``RigidAlgorithm=2``, ``<properties>`` for the boxes and the walls."""
    (i1, n1), (i2, n2) = dem_boxes(dp, **at)
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


def piece_ms(label, fn, reps=7, tries=3):
    """A piece of a step alone: (CUDA-event ms per call, device operations
    per call, device busy ms per call) over one traced call, traced again
    (up to ``tries`` times) when the profiler caught no device activity,
    as it can drop a trace's events."""
    from torch.profiler import ProfilerActivity, profile
    ms = cuda_ms(fn, reps)
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if ev:
            break
    check(bool(ev), f"{label}: {tries} traces hold no device activity")
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

SHARD_TMAX = 0.4       # phase 37: the one-device run's cap (s); it stops
SHARD_PAST = 0.05      # once the front is this far (m) past the slab edge
SHARD_COMPARE = 20     # phases 37-39: steps held against the one-device run
SHARD_DUCT = 120       # phase 39: the duct's steps; its inlet's layers
#                        cross at steps 1, ~57 and ~114 (1,681 spawns
#                        each), the outlet's back layer leaves at ~57, so
#                        the third layer takes the outlet's dead's ids
SHARD_STEPS = 200      # phase 37: steps of the density and migration checks
SHARD_TRACE = 10       # phases 37-39: further steps, rank 0's traced
SHARD_LIMIT = 600.0    # seconds: each start of the ranks


def live_by_id(st):
    """(ids, positions) of the particles still in the run that a rank
    owns (no ghost rows), ordered by id."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    m = td.is_active(st.code) & ~td.is_periodic(st.code)
    idp, pos = st.idp[m], st.pos[m]
    o = torch.argsort(idp)
    return idp[o], pos[o]


def shard_error(label, got, want):
    """Max |d pos| by id between a sharded carry and a one-device one,
    which must hold the same ids."""
    gi, gp = live_by_id(got.st)
    wi, wp = live_by_id(want.st)
    check(torch.equal(gi, wi), f"{label}: the sharded run holds other ids")
    return float((gp - wp).abs().max())


def timed_steps(step, carry, nsteps):
    """(carry, host seconds of each step, launch counts)."""
    reset_counts()
    times = []
    for _ in range(nsteps):
        t0 = time.perf_counter()
        carry = step(carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return carry, times, counts()


def row_width(st):
    """int32 columns of one exchanged row of ``st``."""
    from dualsphysics_multilayer_tpu_torch.parallel import sharding as S
    rows = torch.zeros(1, dtype=torch.long, device=st.pos.device)
    return S._pack(st, S._names(st), rows).shape[1]


def shard_job(group, jobs):
    """What every rank runs in phases 37-39 (at module level, so that the
    spawned ranks import it): for each (args, marks) of ``jobs``,
    ``sharding.rank_start`` on ``args``, the counted steps to ``marks``
    with each refresh's exchange and each DEM pass timed by CUDA events,
    then SHARD_TRACE
    more steps, rank 0's traced with ``torch.profiler`` for its
    device-to-host copies (-1 on the other ranks).  Rank 0 returns, per
    job, (every rank's counters, the carries at the marks, its host
    seconds per counted step)."""
    from torch.profiler import ProfilerActivity, profile
    from dualsphysics_multilayer_tpu_torch.features import dem as DEM
    from dualsphysics_multilayer_tpu_torch.parallel import sharding as S
    out = []
    apply_dem = DEM.apply_dem
    for args, marks in jobs:
        run = S.rank_start(group, *args, log=lambda *a: None)
        events, dem_events = [], []

        def timed_dem(*a, dem_events=dem_events, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            res = apply_dem(*a, **k)
            e1.record()
            dem_events.append((e0, e1))
            return res

        DEM.apply_dem = timed_dem

        def timed(st, halo, refresh=run.dd.refresh, events=events):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            st = refresh(st, halo)
            b.record()
            events.append((a, b))
            return st

        run.dd.refresh = timed
        carries, times = S.rank_steps(run, marks)
        carry, copies = run.sim.carry, -1
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CUDA]) if group.rank == 0
              else contextlib.nullcontext()) as prof:
            for _ in range(SHARD_TRACE):
                carry = run.step(carry)
            torch.cuda.synchronize()
        if prof is not None:
            copies = sum("DtoH" in e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        run.sim.carry = carry
        DEM.apply_dem = apply_dem
        counts = S.rank_counts(run)
        counts.update(exchanges=len(events), exchange_ms=sum(
            a.elapsed_time(b) for a, b in events), traced_d2h=copies,
            dem_calls=len(dem_events), dem_ms=sum(
                a.elapsed_time(b) for a, b in dem_events))
        stats = S.gather_counts(group, counts)
        out.append(None if stats is None else (stats, carries, times))
    return out if group.rank == 0 else None


def shard_steps(sims, marks):
    """``shard_job`` of each of ``sims`` (equal in ranks, device and
    backend) to ``marks`` (one tuple for all, or one per simulation) over
    one start of their ranks: per simulation, (every rank's counters, the
    carries at the marks, rank 0's host seconds per step)."""
    if not isinstance(marks[0], (list, tuple)):
        marks = [marks] * len(sims)
    return sims[0].launch(shard_job, ([(s._args(), tuple(m))
                                       for s, m in zip(sims, marks)],))


def shard_launches(label, stats, ref, nref):
    """Each kernel's launches on every rank against the one-device run's:
    ``ref`` the counts of its ``nref`` steps, so a rank that ran n steps
    launched each kernel n/nref times as often.  Returns {kernel: [each
    rank's launches]} of the kernels the path launched."""
    for r, s in enumerate(stats):
        for k, v in ref.items():
            if k in s:
                check(s[k] * nref == v * s["nstep"],
                      f"{label}: rank {r} launched {k} {int(s[k])} times in "
                      f"{int(s['nstep'])} steps, the one-device run {v} "
                      f"times in {nref}")
    return {k: [int(s[k]) for s in stats] for k, v in ref.items()
            if v and k in stats[0]}


def shard_report(label, sim, stats, launched, smi):
    """One line per rank: its launches of each kernel, rebuilds, migrants
    and ghost rows per rebuild, bytes and collectives per step, the
    exchange's ms; rank 0's device-to-host copies per step in its traced
    steps (the step's flag copy and gloo's copies inside its
    collectives)."""
    cfg = sim.cfg
    width = row_width(sim.state0)
    out = []
    for r, s in enumerate(stats):
        reb = max(s["nrebuild"], 1.0)
        nsteps = int(s["nstep"])
        per = dict(
            launches={k: v[r] for k, v in launched.items()},
            rebuilds=int(s["nrebuild"]),
            migrants_per_rebuild=s["migrants"] / reb,
            ghost_rows_per_rebuild=s["ghost_rows"] / reb,
            fluid_ghosts_per_rebuild=s["fluid_ghosts"] / reb,
            bytes_per_step=s["bytes"] / nsteps,
            collectives_per_step=s["collectives"] / nsteps,
            exchange_ms=s["exchange_ms"] / max(s["exchanges"], 1.0))
        traced = ""
        if s["traced_d2h"] >= 0:
            per["traced_d2h_per_step"] = s["traced_d2h"] / SHARD_TRACE
            traced = (f"; traced over its last {SHARD_TRACE} steps "
                      f"(torch.profiler): {per['traced_d2h_per_step']:.2f} "
                      f"device-to-host copies per step (the step's flag "
                      f"copy and gloo's inside its collectives)")
        out.append(per)
        kernels = ", ".join(f"{k} {v}" for k, v in per["launches"].items())
        say(label, f"rank {r}: launches {kernels} in {nsteps} steps; "
            f"{per['rebuilds']} rebuilds (the first divide among them), "
            f"{per['migrants_per_rebuild']:.1f} migrants and "
            f"{per['ghost_rows_per_rebuild']:.1f} ghost rows "
            f"({per['fluid_ghosts_per_rebuild']:.1f} fluid) received per "
            f"rebuild; each refresh sends {cfg.ghost_cap} rows of {width} "
            f"int32 to each neighbour; {per['bytes_per_step']:.0f} bytes "
            f"into {per['collectives_per_step']:.2f} collectives per step; "
            f"the exchange {per['exchange_ms']:.3f} ms per refresh (CUDA "
            f"events, {int(s['exchanges'])} refreshes){traced} ({smi})")
    return out


def shard_path(device, smi):
    """Phase 37: the dam break at DP_BENCH over 2 ranks sharing the card,
    from a state whose front has crossed the slab edge, against the
    one-device run; then one rank over NCCL."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    from dualsphysics_multilayer_tpu_torch.parallel import sharding as S
    case = cases.dambreak3d(dp=DP_BENCH, obstacle=True, device=device)
    csp, dom, n = case.csp, case.dom, case.np_total
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    cfg = S.make_shard_cfg(dom, 2, n)
    edge = cfg.gdom.posmin[0] + cfg.ncx_loc * cfg.gdom.scell
    step = make_step(csp, opts, dom)
    carry = make_carry(case.state, csp, opts, dom)

    def front_of(st):
        fluid = td.is_fluid(st.code) & td.is_active(st.code)
        return float(st.pos[fluid, 0].max()), fluid

    t0 = time.perf_counter()
    front = 0.0
    while front < edge + SHARD_PAST and carry.t_host < SHARD_TMAX:
        for _ in range(100):
            carry = step(carry)
        front, _ = front_of(carry.st)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = carry.st
    front, fluid = front_of(st)
    beyond = int((fluid & (st.pos[:, 0] >= edge)).sum())
    check(front > edge and beyond > 0, f"the front {front} m has not "
          f"crossed the slab edge {edge} m")
    say("shard-path", f"{n} particles from rest to t {carry.t_host:.6f} s "
        f"in {carry.nstep} one-device steps ({secs:.1f} s): front x "
        f"{front:.4f} m, {beyond} fluid particles beyond the 2-rank slab "
        f"edge x {edge:.4f} m ({cfg.ncx_loc} of {cfg.gdom.nc[0]} cell "
        f"columns a slab); n_local {cfg.n_local}, ghost_cap "
        f"{cfg.ghost_cap}, mig_cap {cfg.mig_cap}, {cfg.n_ext} slots a rank "
        f"({smi})")
    st_mid = st
    ref, times1, launched = timed_steps(
        step, make_carry(st_mid, csp, opts, dom), SHARD_COMPARE)
    check(launched["cellforce"] == 2 * SHARD_COMPARE,
          f"{launched} in the one-device reference's {SHARD_COMPARE} steps")
    p50_1 = statistics.median(times1)

    sim = S.ShardedSimulation(csp, opts, dom, st_mid, ndev=2,
                              backend="gloo", limit=SHARD_LIMIT)
    reset_counts()
    t0 = time.perf_counter()
    ((stats, carries, times),) = shard_steps([sim], [SHARD_COMPARE,
                                                     SHARD_STEPS])
    secs = time.perf_counter() - t0
    c20, c200 = carries
    err = shard_error("shard-path", c20, ref)
    check(err <= 1e-4 * csp.dp, f"2 ranks drift {err} m from the one-device "
          f"run in {SHARD_COMPARE} steps (1e-4 dp = {1e-4 * csp.dp})")
    check(abs(c20.t_host - ref.t_host) <= 1e-5 * ref.t_host,
          f"t {c20.t_host} against {ref.t_host}")
    check(c200.nstep == SHARD_STEPS and c200.overflow == 0,
          f"nstep {c200.nstep}, overflow {c200.overflow}")
    for k in ("pos", "vel", "rho"):
        check(bool(torch.isfinite(getattr(c200.st, k)).all()),
              f"sharded state {k} not finite")
    rmin, rmax = fluid_rho_range(c200.st, True, csp.rhopzero)
    check(sum(s["migrants"] for s in stats) > 0, "no particle migrated")
    check(all(s["fluid_ghosts"] > 0 for s in stats),
          f"a rank received no fluid ghost row: {stats}")
    check(all(s["nstep"] == SHARD_STEPS + SHARD_TRACE for s in stats),
          f"steps per rank {[s['nstep'] for s in stats]}")
    ranks = shard_launches("shard-path", stats, launched, SHARD_COMPARE)
    check(stats[0]["traced_d2h"] >= SHARD_TRACE,
          f"rank 0's trace: {stats[0]['traced_d2h']} device-to-host copies "
          f"in {SHARD_TRACE} steps")
    p50 = statistics.median(times)
    say("shard-path", f"2 ranks on cuda:0 over gloo: {SHARD_COMPARE} steps "
        f"within {err:.3e} m of the one-device run (1e-4 dp "
        f"{1e-4 * csp.dp:.3e}), t {c20.t_host:.9f} against "
        f"{ref.t_host:.9f}; {SHARD_STEPS} steps in {secs:.1f} s (the ranks' "
        f"start included): overflow 0, fluid rho [{rmin:.2f}, {rmax:.2f}], "
        f"p50 step {p50 * 1e3:.3f} ms on rank 0 against the one-device "
        f"{p50_1 * 1e3:.3f} ms (one card shared by two ranks over gloo: "
        f"a check, not a speed) ({smi})")
    per_rank = shard_report("shard-path", sim, stats, ranks, smi)

    one = S.ShardedSimulation(csp, opts, dom, st_mid, ndev=1,
                              limit=SHARD_LIMIT)
    reset_counts()
    (c1,), times_1 = one.steps([SHARD_COMPARE])
    err1 = shard_error("shard-nccl", c1, ref)
    check(err1 <= 1e-6 * csp.dp, f"one NCCL rank drifts {err1} m from the "
          f"one-device run")
    nccl = shard_launches("shard-nccl", one.stats, launched, SHARD_COMPARE)
    check(one.stats[0]["collectives"] >= 2 * SHARD_COMPARE,
          f"one NCCL rank: {one.stats[0]}")
    say("shard-nccl", f"1 rank over NCCL: {SHARD_COMPARE} steps within "
        f"{err1:.3e} m of the one-device run, "
        f"{int(one.stats[0]['collectives'])} collectives on the card, "
        f"p50 step {statistics.median(times_1) * 1e3:.3f} ms ({smi})")
    return dict(ranks=ranks, nccl=nccl, p50_ms=p50 * 1e3,
                one_device_p50_ms=p50_1 * 1e3, per_rank=per_rank,
                state=st_mid)


def shard_paths(device, smi):
    """Phase 38: the NN wet dam break, the floating box and the 2D mDBC
    dam break over 2 ranks sharing the card, against their one-device
    runs; then -shard:1 through the CLI."""
    import shutil
    from dualsphysics_multilayer_tpu_torch import (Features, SolverOpts,
                                                   TpBoundary, TpDensity,
                                                   TpSlipMode, cli)
    from dualsphysics_multilayer_tpu_torch.io import partdata as pd
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    from dualsphysics_multilayer_tpu_torch.parallel import sharding as S
    runs = {}
    case, phases = NM.wet_dambreak_nn(dp=NN_DP, device=device)
    opts = nn_opts("LAMINAR_SPS", "SPH")
    runs["nn"] = (case, opts, case.state, None, phases,
                  NM.make_nn_step(case.csp, opts, case.dom, phases))
    case = cases.floatingbox2d(dp=DP_FLOAT, device=device)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True,
                      tboundary=TpBoundary.MDBC, slipmode=TpSlipMode.NO_SLIP)
    feats = Features(floating=case.meta["ftcfg"])
    runs["floating"] = (case, opts, flowing_state(case, device, sim2d=True),
                        feats, None, make_step(case.csp, opts, case.dom,
                                               feats))
    case = cases.dambreak2d(dp=DP_2D, mdbc=True, device=device)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, tboundary=TpBoundary.MDBC,
                      slipmode=TpSlipMode.VEL0)
    runs["mdbc"] = (case, opts, flowing_state(case, device, sim2d=True),
                    None, None, make_step(case.csp, opts, case.dom))
    refs, sims = {}, {}
    for name, (case, opts, st, feats, phases, step) in runs.items():
        refs[name] = timed_steps(step, make_carry(st, case.csp, opts,
                                                  case.dom, feats),
                                 SHARD_COMPARE)
        sims[name] = S.ShardedSimulation(case.csp, opts, case.dom, st,
                                         feats=feats, ndev=2, phases=phases,
                                         backend="gloo", limit=SHARD_LIMIT)
    reset_counts()
    t0 = time.perf_counter()
    outs = shard_steps(list(sims.values()), [SHARD_COMPARE])
    secs = time.perf_counter() - t0
    say("shard-paths", f"3 paths x {SHARD_COMPARE} steps over one start of "
        f"2 ranks on cuda:0 (gloo) in {secs:.1f} s ({smi})")
    out = {}
    for (name, sim), (stats, (got,), times) in zip(sims.items(), outs):
        case = runs[name][0]
        ref, times1, launched = refs[name]
        err = shard_error(name, got, ref)
        check(err <= 1e-4 * case.csp.dp, f"{name}: 2 ranks drift {err} m")
        check(got.overflow == 0 and got.nstep == SHARD_COMPARE,
              f"{name}: overflow {got.overflow}, nstep {got.nstep}")
        ranks = shard_launches(name, stats, launched, SHARD_COMPARE)
        want = (("nnforce_p1", "nnforce_p3") if name == "nn"
                else ("cellforce",))
        check(sorted(ranks) == sorted(want), f"{name}: the one-device run "
              f"launched {sorted(ranks)}, expected {sorted(want)}")
        if name == "nn":
            check(all(s["fluid_ghosts"] > 0 for s in stats),
                  f"{name}: a rank received no fluid ghost row")
        extra = ""
        if name == "floating":
            dc = float((got.st.ft.center - ref.st.ft.center).abs().max())
            check(dc <= 1e-6, f"floating: body centre off by {dc} m")
            extra = f", body centre within {dc:.3e} m"
        say("shard-paths", f"{name}: {case.np_total} particles, "
            f"{SHARD_COMPARE} steps within {err:.3e} m of the one-device "
            f"run (1e-4 dp {1e-4 * case.csp.dp:.3e}){extra}; p50 step "
            f"{statistics.median(times) * 1e3:.3f} ms on rank 0 against "
            f"{statistics.median(times1) * 1e3:.3f} ({smi})")
        out[name] = dict(ranks=ranks,
                         p50_ms=statistics.median(times) * 1e3,
                         one_device_p50_ms=statistics.median(times1) * 1e3,
                         per_rank=shard_report(f"shard-{name}", sim, stats,
                                               ranks, smi))

    root = tempfile.mkdtemp(prefix="_smoke_shard_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        argv = ["-builtin", "dambreak3d", "-dp", repr(DP_BENCH),
                f"-tmax:{2 * CLI_TOUT!r}", f"-tout:{CLI_TOUT!r}", "-sv:binx",
                "-nortimes"]
        dirs = [os.path.join(root, k) for k in ("one", "shard")]
        check(cli.main(argv + ["-dirout", dirs[0]]) == 0, "the CLI failed")
        reset_counts()
        check(cli.main(argv + ["-shard:1", "-dirout", dirs[1]]) == 0,
              "the CLI failed under -shard:1")
        launched = counts()
        n = cases.dambreak3d(dp=DP_BENCH, device="cpu").np_total
        a, b = (read_parts(pd, d, n, 1000.0) for d in dirs)
        check(sorted(a) == sorted(b) == [0, 1, 2], f"PARTs {sorted(a)}, "
              f"{sorted(b)}")
        err = max(float(np.abs(a[k]["pos"] - b[k]["pos"]).max()) for k in a)
        check(all(np.array_equal(a[k]["idp"], b[k]["idp"]) for k in a)
              and err <= 1e-6 * DP_BENCH, f"-shard:1 PARTs off by {err} m")
        say("shard-cli", f"dsphtorch -builtin dambreak3d -shard:1: 3 PARTs "
            f"read back, equal by id to the unsharded CLI's within {err:.3e} "
            f"m; {launched['cellforce']} cellforce launches ({smi})")
        out["cli"] = dict(ranks={k: [v] for k, v in launched.items()
                                 if v and k in KERNELS})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 39: open boundaries and DEM under domain decomposition ------
SHARD_GAP = 5e-6       # phase 39: the slab edge this far right of a column
PERIODIC3D_DP = 0.4 / 60   # phase 39's y-periodic tank: 60 rows a period
PERIODIC3D_GAP = 3e-4  # its last row this far below the periodic edge


class _Captured(Exception):
    """Raised by :func:`cli_case`'s stand-in to leave ``cli.main``."""


def cli_case(argv, root):
    """(csp, opts, dom, state, feats) that ``dsphtorch argv -shard:2``
    hands its ``ShardedSimulation``, taken from ``cli.main`` before any
    rank starts."""
    from dualsphysics_multilayer_tpu_torch import cli
    got = {}

    def capture(args, torch_, csp, opts, dom, st, feats, phases, t0, dev):
        got.update(csp=csp, opts=opts, dom=dom, st=st, feats=feats)
        raise _Captured

    original, cli._sharded = cli._sharded, capture
    try:
        cli.main(argv + ["-shard:2", "-nortimes", "-dirout",
                         os.path.join(root, "out")])
    except _Captured:
        pass
    finally:
        cli._sharded = original
    check(bool(got), f"cli.main({argv}) reached no sharded run")
    return tuple(got[k] for k in ("csp", "opts", "dom", "st", "feats"))


def edge_after_column(dom, x, gap=SHARD_GAP):
    """``dom`` with its x origin moved left so that the 2-rank slab edge
    lies ``gap`` right of the last of the x-coordinates ``x`` left of the
    old edge (two columns more, so the grid still covers the particles):
    a column of particles then crosses the edge within the steps."""
    from dualsphysics_multilayer_tpu_torch.parallel import sharding as S
    cfg = S.make_shard_cfg(dom, 2, 1)
    edge = dom.posmin[0] + cfg.ncx_loc * dom.scell
    xc = float(x[x < edge].max())
    check(edge - xc < dom.scell, f"no particle within a cell left of the "
          f"slab edge {edge}")
    ncx = cfg.gdom.nc[0] + 2
    x0 = xc + gap - (ncx // 2) * dom.scell
    return dataclasses.replace(dom, posmin=(x0,) + tuple(dom.posmin[1:]),
                               nc=(ncx,) + tuple(dom.nc[1:]))


def periodic_tank(device):
    """Phase 39's y-periodic tank: ``tests/test_sharding.py:513-575``'s
    slab (water 0.9 x 0.4 x 0.2 m over a floor, walls in x, open in y)
    at PERIODIC3D_DP, the fluid flowing along +y at 0.5 m/s with a seeded
    jitter of 0.05 m/s, the period 0.4 m with the last row PERIODIC3D_GAP
    below its edge, the slab edge SHARD_GAP right of a fluid column.
    Returns (csp, opts, dom, state, feats)."""
    from dualsphysics_multilayer_tpu_torch import (Features, SolverOpts,
                                                   TpDensity)
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.features.periodic import \
        PeriodicCfg
    from dualsphysics_multilayer_tpu_torch.models import cases
    dp = PERIODIC3D_DP
    csp = td.make_ctesph(simulate2d=False, dp=dp, hswl=0.2, coefh=1.0,
                         visco=0.05, coefsound=20.0)
    d = cases.Draw(dp=dp, simulate2d=False)
    d.box((0, 0, 0), (0.9 - dp, 0.4 - dp, 0.2), ptype=td.TYPE_FLUID, mk=0)
    d.box((-3 * dp, 0, -3 * dp), (0.9 + 2 * dp, 0.4 - dp, -dp),
          ptype=td.TYPE_FIXED, mk=0, faces="solid")
    d.box((-3 * dp, 0, 0), (-dp, 0.4 - dp, 0.4), ptype=td.TYPE_FIXED, mk=0,
          faces="solid")
    d.box((0.9, 0, 0), (0.9 + 2 * dp, 0.4 - dp, 0.4), ptype=td.TYPE_FIXED,
          mk=0, faces="solid")
    pos, code = d.build()
    st = cases._make_state(csp, pos, code, zsurf=0.2, device=device)
    fluid = td.is_fluid(st.code)
    rng = np.random.default_rng(39)
    vel = torch.tensor(rng.normal(0.0, 0.05, (st.n, 3)), dtype=torch.float32,
                       device=device)
    vel[:, 1] += 0.5
    st = dataclasses.replace(st, vel=torch.where(fluid[:, None], vel, 0.0))
    ytop = float(pos[:, 1].max())
    hi = ytop + PERIODIC3D_GAP
    feats = Features(periodic=PeriodicCfg(
        axes=(False, True, False), lo=(0.0, hi - 0.4, 0.0), hi=(0.0, hi, 0.0),
        ghost_cap=int(1.5 * st.n * csp.kernelsize / 0.4)))
    dom = edge_after_column(cases._make_domain(csp, pos, headroom=2.0),
                            pos[np.asarray(fluid.cpu()), 0])
    return csp, SolverOpts(tdensity=TpDensity.FOURTAKAS), dom, st, feats


def shard_feats_path(device, smi):
    """Phase 39: the open boundaries and DEM under domain decomposition, 2
    ranks on ``cuda:0`` over gloo, one start of the ranks for the four
    jobs, each 20 steps (the duct 120, over which it spawns more
    particles than its free pool held at the start) against its one-device run and 10 more traced:
    ``-builtin channel2d`` (phase 29's size) and phase 30's duct through
    ``load_case`` (inlet/outlet zones: the live fluid count within 2, its
    centre of mass within 2e-3 dp, every live id unique, a spawn on rank
    0, fluid migrated to rank 1, and in the duct spawns holding ids of
    particles that were on rank 1 at the start, which the free pool's
    sharing brought back; the channel's fluid starts at the inlet's
    velocity, the duct's flows as its case says), phase 32's DEM boxes through ``-case``
    with box 51 across the slab edge (body centres within 1e-6 m and
    velocities within 1e-5 m/s) and the y-periodic tank (positions by id
    within 1e-4 dp, rows wrapped through the periodic edge and migrated
    across the slab edge).  The inout and periodic jobs' slab edge is
    moved just right of a fluid column (:func:`edge_after_column`), which
    crosses it in the first step: the rebuild that the first step's
    spawns or wraps force migrates it."""
    import shutil
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    from dualsphysics_multilayer_tpu_torch.parallel import sharding as S
    root = tempfile.mkdtemp(prefix="_smoke_shardfeat_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        jobs = {}
        csp, opts, dom, st, feats = cli_case(
            ["-builtin", "channel2d", "-dp", repr(CHANNEL_DP),
             f"-tmax:{2 * CHANNEL_TOUT!r}"], os.path.join(root, "channel"))
        # the channel's fluid already at the inlet's velocity (the case
        # starts it at rest), so that it crosses the slab edge
        inner = td.is_fluid(st.code) & td.is_active(st.code)
        vin = feats.inout.zones[0].vel_profile[0]
        st = dataclasses.replace(st, vel=torch.where(
            (inner & ~td.is_inout(st.code))[:, None],
            torch.tensor([vin, 0.0, 0.0], device=st.vel.device), st.vel))
        fluid_x = st.pos[inner, 0]
        jobs["channel2d"] = (csp, opts, edge_after_column(
            dom, fluid_x.cpu().numpy()), st, feats)
        path = os.path.join(root, "Duct_Def.xml")
        with open(path, "w") as f:
            f.write(duct_xml(DUCT_DP, DUCT_TMAX))
        case, opts, _run = load_case(path, device=device)
        st = case.state
        fluid_x = st.pos[td.is_fluid(st.code) & td.is_active(st.code), 0]
        jobs["duct-inout"] = (case.csp, opts, edge_after_column(
            case.dom, fluid_x.cpu().numpy()), st, case.meta["features"])
        # box 51 across the 2-rank slab edge, clear of the obstacle in y
        path = os.path.join(root, "Dem_Def.xml")
        with open(path, "w") as f:
            f.write(dem_xml(DP_BENCH, 3 * COUPLING_TOUT, COUPLING_TOUT))
        case, _, _ = load_case(path, device="cpu")
        cfg = S.make_shard_cfg(case.dom, 2, 1)
        edge = cfg.gdom.posmin[0] + cfg.ncx_loc * cfg.gdom.scell
        with open(path, "w") as f:
            f.write(dem_xml(DP_BENCH, 3 * COUPLING_TOUT, COUPLING_TOUT,
                            x=edge - 0.5 * BOX_SIDE, y=0.45))
        jobs["dem-3d"] = cli_case(["-case", path],
                                  os.path.join(root, "dem"))
        jobs["yperiodic-3d"] = periodic_tank(device)

        refs, sims, starts = {}, {}, {}
        nsteps = {name: SHARD_COMPARE for name in jobs}
        nsteps["duct-inout"] = SHARD_DUCT
        for name, (csp, opts, dom, st, feats) in jobs.items():
            refs[name] = timed_steps(make_step(csp, opts, dom, feats),
                                     make_carry(st, csp, opts, dom, feats),
                                     nsteps[name])
            sims[name] = S.ShardedSimulation(csp, opts, dom, st, feats=feats,
                                             ndev=2, backend="gloo",
                                             limit=SHARD_LIMIT)
            starts[name] = S._owner(sims[name].cfg, st.pos[:, 0])
        reset_counts()
        t0 = time.perf_counter()
        outs = shard_steps(list(sims.values()),
                           [[nsteps[name]] for name in sims])
        secs = time.perf_counter() - t0
        say("shard-feats", f"4 jobs x {nsteps} steps (and {SHARD_TRACE} "
            f"traced) over one start of 2 ranks on cuda:0 (gloo) in "
            f"{secs:.1f} s ({smi})")
        out = {}
        for (name, sim), (stats, (got,), times) in zip(sims.items(), outs):
            csp, opts, dom, st, feats = jobs[name]
            ref, times1, launched = refs[name]
            label = f"shard-{name}"
            check(got.nstep == ref.nstep == nsteps[name] and got.overflow
                  == 0 == ref.overflow, f"{label}: nstep {got.nstep}/"
                  f"{ref.nstep}, overflow {got.overflow}/{ref.overflow}")
            check(abs(got.t_host - ref.t_host) <= 1e-5 * ref.t_host,
                  f"{label}: t {got.t_host} against {ref.t_host}")
            for k in ("pos", "vel", "rho"):
                check(bool(torch.isfinite(getattr(got.st, k)).all()),
                      f"{label}: {k} not finite")
            ranks = shard_launches(label, stats, launched, nsteps[name])
            check(sorted(ranks) == ["cellforce"], f"{label}: the one-device "
                  f"run launched {sorted(ranks)}")
            gi, gp = live_by_id(got.st)
            check(len(torch.unique(gi)) == len(gi),
                  f"{label}: a live id twice in the gathered state")
            mig = [int(s["migrants"]) for s in stats]
            extra = ""
            if feats.inout is not None:
                dp = csp.dp

                def fluid(s):
                    m = (td.is_active(s.code) & ~td.is_periodic(s.code)
                         & td.is_fluid(s.code))
                    return int(m.sum()), s.pos[m].double().mean(0)

                n1, com1 = fluid(ref.st)
                n2, com2 = fluid(got.st)
                dcom = float((com1 - com2).abs().max())
                check(abs(n1 - n2) <= 2 and dcom <= 2e-3 * dp,
                      f"{label}: live fluid {n2} against {n1}, centre of "
                      f"mass off by {dcom} m (2e-3 dp {2e-3 * dp})")
                live0 = st.idp[td.is_active(st.code)]
                new = ~torch.isin(gi, live0)
                spawn0 = int((S._owner(sim.cfg, gp[new, 0]) == 0).sum())
                check(spawn0 > 0, f"{label}: no spawn on rank 0")
                check(mig[1] > 0, f"{label}: no fluid migrated to rank 1")
                # ids back from rank 1: members of a spawning zone on rank
                # 0's slab whose id was live on rank 1's at the start
                owner0 = torch.full((st.n,), -1, dtype=torch.long,
                                    device=st.idp.device)
                live = td.is_active(st.code)
                owner0[st.idp[live].long()] = starts[name][live]
                m = td.is_active(got.st.code) & ~td.is_periodic(got.st.code)
                spawner = S._spawners(feats).to(m.device)[
                    td.code_inout(got.st.code[m]).long()]
                back = int((spawner & (owner0[got.st.idp[m].long()] == 1)
                            & (S._owner(sim.cfg, got.st.pos[m, 0]) == 0))
                           .sum())
                pool0 = sum(len(p) for p in S.spare_ids(sim.cfg, st, feats))
                if name == "duct-inout":
                    check(back > 0, f"{label}: no id came back from rank 1 "
                          f"in {nsteps[name]} steps")
                extra = (f"live fluid {n2} against {n1}, centre of mass "
                         f"within {dcom:.3e} m (2e-3 dp {2e-3 * dp:.3e}); "
                         f"{int(new.sum())} spawned ids live ({spawn0} on "
                         f"rank 0's slab) of a free pool of {pool0} ids at "
                         f"the start, and {back} spawning-zone members on "
                         f"rank 0's slab with ids live on rank 1's at the "
                         f"start; each id once")
            else:
                wi, wp = live_by_id(ref.st)
                check(torch.equal(gi, wi), f"{label}: other ids")
                err = float((gp - wp).abs().max())
            if feats.dem is not None:
                dc = float((got.st.ft.center - ref.st.ft.center).abs().max())
                dv = float((got.st.ft.fvel - ref.st.ft.fvel).abs().max())
                check(dc <= 1e-6 and dv <= 1e-5, f"{label}: body centres off "
                      f"by {dc} m, velocities by {dv} m/s")
                body = td.code_value(st.code)
                isft = td.is_floating(st.code)
                rows = {b: [int((isft & (body == b) & (starts[name] == r))
                                .sum()) for r in range(2)]
                        for b in range(feats.floating.count)}
                check(any(min(v) > 0 for v in rows.values()),
                      f"{label}: no body on both ranks: {rows}")
                dem_ms = stats[0]["dem_ms"] / max(stats[0]["dem_calls"], 1)
                extra = (f"body centres within {dc:.3e} m, velocities within "
                         f"{dv:.3e} m/s, positions by id within {err:.3e} m; "
                         f"each body's rows on ranks 0/1 at the start "
                         f"{rows}; DEM's pass on rank 0 {dem_ms:.3f} ms a "
                         f"call (CUDA events, {int(stats[0]['dem_calls'])} "
                         f"calls)")
            if feats.periodic is not None:
                check(err <= 1e-4 * csp.dp, f"{label}: 2 ranks drift {err} m "
                      f"(1e-4 dp {1e-4 * csp.dp})")
                hi = feats.periodic.hi[1]
                wrapped = int((ref.st.pos[:, 1] < st.pos[:, 1].min()
                               - 0.5 * csp.dp).sum())
                check(wrapped > 0, f"{label}: no row wrapped through y = "
                      f"{hi}")
                check(sum(mig) > 0, f"{label}: no particle crossed the slab "
                      f"edge")
                extra = (f"positions by id within {err:.3e} m (1e-4 dp "
                         f"{1e-4 * csp.dp:.3e}); {wrapped} rows wrapped "
                         f"through y = {hi:.5f} m")
            p50, p50_1 = statistics.median(times), statistics.median(times1)
            say(label, f"{int(td.is_active(st.code).sum())} live particles "
                f"in {st.n} slots, halo {sim.cfg.halo} cell(s): {extra}; "
                f"migrants received by rank {mig}; p50 step {p50 * 1e3:.3f} "
                f"ms on rank 0 against the one-device {p50_1 * 1e3:.3f} ms "
                f"(one card shared by two ranks over gloo: a check, not a "
                f"speed) ({smi})")
            out[name] = dict(ranks=ranks, p50_ms=p50 * 1e3,
                             one_device_p50_ms=p50_1 * 1e3,
                             per_rank=shard_report(label, sim, stats, ranks,
                                                   smi))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# BASELINE config 5 (coastal.py:40-55): an 8 x 2 m flume, 0.5 m deep, a
# 1:10 beach from x = 3 m, the solitary wave of 0.12 m
COASTAL_GEOM = dict(length=8.0, width=2.0, depth=0.5, slope_start=3.0,
                    slope=0.1, wave_height=0.12)
COASTAL_NP = 10_000_000        # phase 40a-b: coastal.py's rule for dp
COASTAL_NP_LARGE = 50_000_000  # phase 40c: the config's upper end
COASTAL_NP_SHARD = 2_000_000   # phase 40d: coastal.py's one-device default
COASTAL_WARM, COASTAL_STEPS = 5, 30     # phase 40a
COASTAL_MORE = 100             # phase 40a: further steps allowed for a rebuild
COASTAL_LARGE_WARM, COASTAL_LARGE_STEPS = 2, 5   # phase 40c
COASTAL_CLI_DP = 0.04          # phase 40e: still water, ~9 steps
COASTAL_CLI_TMAX = 0.004


def coastal_dp(n_target):
    """coastal.py's dp for ``n_target`` particles: (V / N)^(1/3), V the
    flume's water L W D less the beach's wedge (at most half of it)."""
    g = COASTAL_GEOM
    length, width, depth = g["length"], g["width"], g["depth"]
    wedge = 0.5 * max(0.0, length - g["slope_start"]) ** 2 * g["slope"] * width
    vol = length * width * depth - min(wedge, length * width * depth * 0.5)
    return (vol / n_target) ** (1.0 / 3.0)


def host_rss():
    """(this process's resident bytes now, its peak so far: ru_maxrss)."""
    import resource
    with open("/proc/self/statm") as f:
        now = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def free_device():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def coastal_build(label, n_target, device, smi):
    """``cases.coastal_runup3d`` at coastal.py's dp for ``n_target`` on the
    card: the case, printed with its count, grid, host seconds and memory
    (resident and peak, the peak the process's whole run's), and the
    device bytes the build left and its peak, per particle."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    free_device()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rss0, peak0 = host_rss()
    dp = coastal_dp(n_target)
    t0 = time.perf_counter()
    case = cases.coastal_runup3d(dp=dp, **COASTAL_GEOM, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rss1, peak1 = host_rss()
    n = case.np_total
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    nfluid = int(td.is_fluid(case.state.code).sum())
    with open("/proc/meminfo") as f:
        total = int(f.readline().split()[1]) * 1024
    say(label, f"coastal_runup3d at dp {dp * 1e3:.4f} mm (N = {n_target:,}): "
        f"{n:,} particles ({nfluid:,} fluid, {case.npb:,} boundary), nc "
        f"{case.dom.nc} ({case.dom.ncells:,} cells); built in {secs:.2f} s "
        f"on the host, resident {rss0 / 2**30:.2f} -> {rss1 / 2**30:.2f} GiB, "
        f"the process's peak {peak0 / 2**30:.2f} -> {peak1 / 2**30:.2f} GiB "
        f"of the host's {total / 2**30:.1f} GiB; on the card "
        f"{held / n:.1f} bytes per particle held, {peak / n:.1f} at the "
        f"build's peak ({held / 2**30:.3f} / {peak / 2**30:.3f} GiB) ({smi})")
    return case, dict(n=n, nfluid=nfluid, npb=case.npb, dp=dp,
                      nc=list(case.dom.nc), build_s=secs, rss=rss1,
                      peak_rss=peak1, device_bytes=held, device_peak=peak)


def coastal_steps(label, case, device, nwarm, nsteps, smi, more=0):
    """``make_carry``/``make_step`` of the case (Fourtakas, DBC): ``nwarm``
    + ``nsteps`` steps, then up to ``more`` further ones until a rebuild
    has happened inside the steps (``more`` 0: none required); kernel 1
    exactly twice a step and no other kernel, overflow 0, a finite state,
    the fluid density within 10%, the position residual written and
    within its position's ulp.  Returns (step, carry, the timed steps'
    seconds, the launches, the bytes allocated on the card at most over
    make_carry and the steps)."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    free_device()
    base = torch.cuda.memory_allocated()     # the case's state among it
    torch.cuda.reset_peak_memory_stats()
    step = make_step(case.csp, opts, case.dom)
    carry = make_carry(case.state, case.csp, opts, case.dom)
    nrebuild0 = carry.nrebuild
    carry, times, _ = run_steps(step, carry, nwarm, nsteps)
    while more and carry.nrebuild == nrebuild0 and \
            carry.nstep < nwarm + nsteps + more:
        carry = step(carry)
    torch.cuda.synchronize()
    launched = counts()
    nrun = carry.nstep
    single_phase_counts(launched, "cellforce", 2, nrun)
    check_state(carry, nrun, nrebuild0 if more else None)
    rmin, rmax = fluid_rho_range(carry.st, True, case.csp.rhopzero)
    # the Kahan residual carries the trajectory below float32's ulp
    # (9.5e-7 m at x = 8 m): written, and within its position's ulp
    st = carry.st
    live = td.is_fluid(st.code) & td.is_active(st.code)
    pos, pose = st.pos[live].abs(), st.pose[live].abs()
    ulp = torch.nextafter(pos, torch.full_like(pos, math.inf)) - pos
    written = int((pose > 0).any(dim=1).sum())
    check(written > 0, f"{label}: no fluid row carries a position residual")
    check(bool((pose <= ulp).all()), f"{label}: a position residual exceeds "
          f"its position's ulp")
    residual = (f"{written:,} of {int(live.sum()):,} fluid rows carry a "
                f"position residual, max {float(pose.max()):.3e} m, at most "
                f"{float((pose / ulp).max()):.3f} of its position's ulp")
    del pos, pose, ulp
    peak = torch.cuda.max_memory_allocated()
    n = case.np_total
    p50 = statistics.median(times)
    say(label, f"{n:,} particles, {nsteps} steps after {nwarm} warm-up"
        + (f" and {nrun - nwarm - nsteps} more" if nrun > nwarm + nsteps
           else "") + f": p50 step {p50 * 1e3:.3f} ms, {n / p50:.1f} "
        f"particle-steps/s; cellforce {launched['cellforce']} launches in "
        f"{nrun} steps, {carry.nrebuild - nrebuild0} rebuilds after the "
        f"first divide, overflow {carry.overflow}, t {carry.t_host:.6f} s, "
        f"dt {float(carry.dt_pre):.4e} s, fluid rho [{rmin:.2f}, "
        f"{rmax:.2f}]; {residual}; allocated on the card at most "
        f"{peak / n:.1f} bytes "
        f"per particle over make_carry and the steps ({peak / 2**30:.3f} "
        f"GiB; {base / 2**30:.3f} GiB before, the state among it) ({smi})")
    return step, carry, times, launched, peak


def coastal_kernel_vs_plain(label, case, smi):
    """Kernel 1 against its plain version on the case's initial state
    (phase 3's rule), the kernel alone timed with CUDA events (20
    launches, median of 5), the plain version once; the bound from this
    state's in-support pairs."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch.ops import forces as F
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    csp, dom, st = case.csp, case.dom, case.state
    cells, args = sorted_args(dom, st.pos, st.vel, st.rho, st.code)
    run = (csp, opts, dom, cells, *args)
    got = CF.interaction_forces_cuda(*run)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    want = F.interaction_forces_plain(*run)
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    err = {k: close(f"cellforce {k}", getattr(got, k), getattr(want, k))
           for k in ("ace", "ar")}
    err["viscdtmax"] = close_scalar("cellforce viscdtmax", got.viscdtmax,
                                    want.viscdtmax)
    del want
    n = args[0].shape[0]
    pospress, velrho, kind = CF.channels(csp, *args)
    outs = [torch.empty_like(x) for x in (got.ace, got.ar, got.ar)]
    ms = launch_ms(bare_launcher(
        "cellforce", "dsph_cellforce", CF.make_params(csp, opts, dom, n),
        [pospress, velrho, kind, cells.cell, cells.begin, None, None]
        + outs + [None, None, None]))
    cand, pairs = pair_counts(csp, dom, cells, args[0], args[3],
                              inclusive=False)
    b_ms, b_by = bound(cellforce_bytes(n, dom.ncells, opts),
                       pairs * OPS_PER_PAIR["cellforce"])
    say(label, f"kernel 1 against its plain version on the initial state, "
        f"{n:,} particles: max|d ace| {err['ace']:.3e}, max|d ar| "
        f"{err['ar']:.3e}, |d viscdtmax| {err['viscdtmax']:.3e}; kernel "
        f"alone {ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events); "
        f"{cand:,} candidates, {pairs:,} in-support pairs with a fluid-side "
        f"target ({cand / max(pairs, 1):.2f} per pair); bound "
        f"{b_ms * 1e3:.2f} us by {b_by}, the kernel at "
        f"{100 * b_ms / ms:.2f}% of it ({smi})")
    return dict(rows=n, max_abs_err=err["ace"], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, pairs=pairs, candidates=cand)


def coastal_part(label, case, carry, smi):
    """Phase 40b: one PART of the run's state through the run loop's
    writer (``io.output.OutputManager``, the C++ writer), read back and
    equal by id to the state."""
    import shutil
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.io.output import OutputManager
    from dualsphysics_multilayer_tpu_torch.models.wcsph import Simulation
    sim = Simulation.__new__(Simulation)
    sim.csp, sim.dom, sim.carry = case.csp, case.dom, carry
    sim.time, sim.walltime, sim.part = carry.t_host, 0.0, 0
    root = tempfile.mkdtemp(prefix="_smoke_coastal_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        om = OutputManager(root, case, nortimes=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        om(sim)
        ms = (time.perf_counter() - t0) * 1e3
        copied = om.last_save_bytes
        path = os.path.join(root, PD.part_filename(0))
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        part = PD.read_part(path)
        read_s = time.perf_counter() - t0
        st = carry.st
        o = np.argsort(part["idp"])
        idp = st.idp.cpu().numpy()
        so = np.argsort(idp)
        check(np.array_equal(part["idp"][o], idp[so]),
              f"{label}: the PART holds other ids")
        for key, got, want in (
                ("pos", part["pos"][o], st.pos.cpu().numpy()[so]),
                ("vel", part["vel"][o], st.vel.cpu().numpy()[so]),
                ("rho", part["rhop"][o], st.rho.cpu().numpy()[so]),
                ("code", part["code"][o].astype(np.int64),
                 st.code.cpu().numpy()[so].astype(np.int64))):
            check(np.array_equal(got, want), f"{label}: the PART's {key} "
                  f"differs from the state's by id")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(label, f"one PART of {st.n:,} particles through OutputManager (the "
        f"C++ writer): {ms:.1f} ms on the host clock, {copied:,} bytes "
        f"copied from the card ({copied / st.n:.0f} per particle), a file "
        f"of {size:,} bytes, read back in {read_s:.2f} s, equal by id to "
        f"the state (pos, vel, rho, code) ({smi})")
    return dict(ms=ms, bytes_copied=copied, file_bytes=size)


def coastal_shard(label, device, smi):
    """Phase 40d: the case at COASTAL_NP_SHARD over 2 ranks on ``cuda:0``
    (gloo) against the one-device run, SHARD_COMPARE steps, by id."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    from dualsphysics_multilayer_tpu_torch.parallel import sharding as S
    case, _ = coastal_build(label, COASTAL_NP_SHARD, device, smi)
    csp, dom, st0 = case.csp, case.dom, case.state
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    ref, times1, launched = timed_steps(
        make_step(csp, opts, dom), make_carry(st0, csp, opts, dom),
        SHARD_COMPARE)
    check(launched["cellforce"] == 2 * SHARD_COMPARE,
          f"{launched} in the one-device reference's {SHARD_COMPARE} steps")
    sim = S.ShardedSimulation(csp, opts, dom, st0, ndev=2, backend="gloo",
                              limit=SHARD_LIMIT)
    reset_counts()
    t0 = time.perf_counter()
    ((stats, (got,), times),) = shard_steps([sim], [SHARD_COMPARE])
    secs = time.perf_counter() - t0
    err = shard_error(label, got, ref)
    check(err <= 1e-6 * csp.dp, f"{label}: 2 ranks drift {err} m from the "
          f"one-device run in {SHARD_COMPARE} steps (1e-6 dp = "
          f"{1e-6 * csp.dp})")
    check(got.overflow == 0, f"{label}: overflow {got.overflow}")
    rmin, rmax = fluid_rho_range(got.st, True, csp.rhopzero)
    ranks = shard_launches(label, stats, launched, SHARD_COMPARE)
    cfg = sim.cfg

    def rows(st):
        live = td.is_active(st.code)
        return torch.bincount(S._owner(cfg, st.pos[live, 0]),
                              minlength=cfg.ndev).tolist()

    say(label, f"2 ranks on cuda:0 over gloo: {SHARD_COMPARE} steps within "
        f"{err:.3e} m of the one-device run (1e-6 dp {1e-6 * csp.dp:.3e}), "
        f"t {got.t_host:.9f} against {ref.t_host:.9f}, overflow 0, fluid rho "
        f"[{rmin:.2f}, {rmax:.2f}]; live rows per rank {rows(st0)} at the "
        f"start, {rows(got.st)} at the end (slabs of {cfg.ncx_loc} of "
        f"{cfg.gdom.nc[0]} cell columns, {cfg.n_ext:,} slots a rank); "
        f"{secs:.1f} s with the ranks' start; p50 step "
        f"{statistics.median(times) * 1e3:.3f} ms on rank 0 against the "
        f"one-device {statistics.median(times1) * 1e3:.3f} ms (one card "
        f"shared by two ranks over gloo: a check, not a speed) ({smi})")
    per_rank = shard_report(label, sim, stats, ranks, smi)
    return dict(ranks=ranks, err=err, per_rank=per_rank,
                p50_ms=statistics.median(times) * 1e3,
                one_device_p50_ms=statistics.median(times1) * 1e3)


def coastal_cli(label, device, smi):
    """Phase 40e: ``dsphtorch -builtin coastal_runup3d -dp
    COASTAL_CLI_DP`` (still water) through ``cli.main``: PARTs 0-2 read
    back, kernel 1 twice a step and no other kernel."""
    import shutil
    from dualsphysics_multilayer_tpu_torch import cli
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    from dualsphysics_multilayer_tpu_torch.models import cases
    case = cases.coastal_runup3d(dp=COASTAL_CLI_DP, device=device)
    root = tempfile.mkdtemp(prefix="_smoke_coastal_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        argv = ["-builtin", "coastal_runup3d", "-dp", repr(COASTAL_CLI_DP),
                f"-tmax:{COASTAL_CLI_TMAX!r}",
                f"-tout:{COASTAL_CLI_TMAX / 2!r}", "-nortimes",
                "-dirout", root]
        reset_counts()
        t0 = time.perf_counter()
        check(cli.main(argv) == 0, f"{label}: the CLI failed")
        wall = time.perf_counter() - t0
        launched = counts()
        parts = read_parts(PD, root, case.np_total, case.csp.rhopzero)
        check(sorted(parts) == [0, 1, 2], f"{label}: PARTs {sorted(parts)}")
        nsteps = parts[2]["nstep"]
        single_phase_counts(launched, "cellforce", 2, nsteps)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(label, f"dsphtorch {' '.join(argv[:-2])}: {case.np_total:,} "
        f"particles, PARTs 0-2 read back (ids, finite positions, fluid "
        f"density within 10%), {nsteps} steps in {wall:.1f} s, cellforce "
        f"{launched['cellforce']} launches ({smi})")
    return launched["cellforce"]


def coastal_dryrun(label, smi):
    """Phase 40f: ``sharding.dryrun(2, backend="gloo")`` on ``cuda:0``:
    its three lines, and kernel 1's launches on rank 0 (this process)."""
    from dualsphysics_multilayer_tpu_torch.parallel import sharding as S
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        S.dryrun(2, backend="gloo")
    wall = time.perf_counter() - t0
    lines = [x for x in out.getvalue().splitlines()
             if x.startswith("dryrun_multichip(2): ")]
    check(len(lines) == 3, f"{label}: {out.getvalue()!r}")
    launched = counts()
    check(launched["cellforce"] == 6, f"{label}: rank 0 launched "
          f"{launched}, expected cellforce twice in each case's step")
    for x in lines:
        say(label, x)
    say(label, f"{wall:.1f} s with the ranks' start; cellforce "
        f"{launched['cellforce']} launches on rank 0 ({smi})")
    return launched["cellforce"]


def coastal_path(device, smi):
    """Phase 40: the 3D coastal run-up (BASELINE config 5) at ~10M and
    ~50M particles on the card, a PART at ~10M, 2 ranks at ~2M, the CLI
    and the dry run.  Returns (cellforce's launches per run, the records
    at ~10M and ~50M, the 2-rank run's record)."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch.utils.timers import profile_step
    paths = {}
    # a. ~10M particles
    case, built = coastal_build("coastal-10m", COASTAL_NP, device, smi)
    rec = coastal_kernel_vs_plain("coastal-10m", case, smi)
    free_device()
    step, carry, times, launched, peak = coastal_steps(
        "coastal-10m", case, device, COASTAL_WARM, COASTAL_STEPS, smi,
        more=COASTAL_MORE)
    paths["coastal-10m"] = launched["cellforce"]
    p50 = statistics.median(times)
    phases = profile_step(case.csp, SolverOpts(tdensity=TpDensity.FOURTAKAS),
                          case.dom, carry.st, reps=10)
    r = trace_steps(step, carry, 3, ("cellforce",))
    check(r is not None, "coastal-10m: the trace of 3 steps holds no device "
          "activity")
    d2h, carry = count_d2h(step, carry, 5)
    check(d2h == 1, f"coastal-10m: {d2h} device-to-host copies per step, "
          f"expected 1")
    say("coastal-10m", "profile_step (reps 10, host clock around "
        "synchronised calls): " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in phases.items())
        + f"; 3 traced steps: window {r['window_ms']:.3f} ms per step, "
        f"device busy {r['busy_ms']:.3f} ms, idle share "
        f"{r['idle_share']:.4f}, {r['ops']:.1f} device operations per "
        f"step, cellforce {r['kernel_ms']['cellforce']:.3f} ms per step; "
        f"{d2h:g} device-to-host copy per step over 5 traced steps ({smi})")
    # b. one PART of the run's state
    part = coastal_part("coastal-part", case, carry, smi)
    rec.update(p50_ms=p50 * 1e3, particle_steps_per_s=case.np_total / p50,
               busy_ms=r["busy_ms"], ops=r["ops"],
               idle_share=r["idle_share"], profile_step_ms={
                   k: v * 1e3 for k, v in phases.items()},
               device_peak_bytes_per_particle=peak / case.np_total,
               build=built, part=part)
    del case, step, carry
    free_device()
    # c. ~50M particles
    case, built = coastal_build("coastal-50m", COASTAL_NP_LARGE, device, smi)
    step, carry, times, launched, peak = coastal_steps(
        "coastal-50m", case, device, COASTAL_LARGE_WARM, COASTAL_LARGE_STEPS,
        smi)
    paths["coastal-50m"] = launched["cellforce"]
    p50 = statistics.median(times)
    large = dict(rows=case.np_total, p50_ms=p50 * 1e3,
                 particle_steps_per_s=case.np_total / p50,
                 device_peak_bytes_per_particle=peak / case.np_total,
                 build=built)
    del case, step, carry
    free_device()
    # d. 2 ranks sharing the card
    shard = coastal_shard("coastal-shard", device, smi)
    free_device()
    # e. the CLI, f. the dry run
    paths["coastal-cli"] = coastal_cli("coastal-cli", device, smi)
    paths["dryrun-rank0"] = coastal_dryrun("coastal-dryrun", smi)
    return paths, dict(coastal_10m=rec, coastal_50m=large), shard


# ---------------------------------------------------------------------------
# phase 43: the symmetry plane with laminar+SPS and with floating bodies, the
# skinless domain with inlet/outlet zones and under -shard
# ---------------------------------------------------------------------------

SYM_STEPS = 20         # phase 43: timed steps of the symmetry paths after 5
SKINLESS_SHARD = 20    # phase 43: sharded skinless steps against one device
SYM_VISCO = 1e-4       # phase 43: the laminar viscosity of the comparisons


def half_float_xml(dp, tmax, tout):
    """Phase 43's half tank with a floating box on the plane: phase 26's
    half dam break without its Symmetry key (the loaders refuse the plane
    with floating bodies, JSph.cpp:1174-1179), one of phase 32's 0.1 m
    boxes (rhopbody 800) inside the fluid column, drawn from y = 0 so that
    its other half is its image, and ``RigidAlgorithm=1``."""
    n = int(round(BOX_SIDE / dp))
    i0 = (int(round(0.15 / dp)), 0, int(round(0.1 / dp)))
    return _dambreak_with(
        dp, tmax, tout, _lattice_box(51, i0, (n, n // 2, n), dp),
        '<floatings><floating mkbound="51" rhopbody="800"/></floatings>',
        params='<parameter key="RigidAlgorithm" value="1"/>',
        base=HALF_XML.replace('<parameter key="Symmetry" value="1"/>', ""))


def ptxas_of(instance, library="cellforce"):
    """(spill line, register line) of ``instance`` in ``library``'s ptxas
    log."""
    from dualsphysics_multilayer_tpu_torch.ops.cuda import build
    entry, spill = None, "?"
    with open(build.library_path(library) + ".log") as f:
        for line in f:
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry, spill = kernel_label(m.group(1)), "?"
            elif entry == instance and "spill" in line:
                spill = line.strip()
            elif entry == instance and "registers" in line:
                return spill, line.strip()
    return spill, "?"


def sym_instances_vs_plain(label, variants, dom, cells, args, spstau, smi,
                           ftomassp=None):
    """Each (name, csp, opts) of ``variants``, a SYM instance of kernels
    1-3, against the plain mirror pass on the same inputs (rtol 2e-3,
    4e-3 with the cubic spline), timed alone beside the same instance
    without the plane, with its bound ((pairs + image pairs) x its
    operations per pair; the slot masses' bytes with floating bodies) and
    its ptxas registers and spills.  Returns {instance: record}."""
    from dualsphysics_multilayer_tpu_torch import TpShifting
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    n = args[0].shape[0]
    csp0 = variants[0][1]
    cand, pairs = pair_counts(csp0, dom, cells, args[0], args[3],
                              inclusive=False)
    images = image_pairs(csp0, dom, cells, args[0], args[3])
    near = int((args[0][:, 1] <= csp0.kernelsize).sum())
    nft = int(td.is_floating(args[3]).sum())
    records = {}
    for variant, csp, opts in variants:
        name = CF.kernel_name(csp, opts)
        err, ms, wrapped_ms, plain_ms = compare_cellforce(
            csp, opts, dom, cells, args, reps=3, spstau=spstau,
            ftomassp=ftomassp)
        flat_ms = instance_ms(csp, dataclasses.replace(opts, symmetry=False),
                              dom, cells, args, spstau, ftomassp)
        ft = int(ftomassp is not None and opts.with_floating)
        b = bound(cellforce_bytes(n, dom.ncells, opts) + 4 * n * ft,
                  (pairs + images) * ops_per_pair(name, opts))
        instance = (f"cellforce_kernel<{csp.tkernel.value},"
                    f"{opts.tvisco.value},"
                    f"{int(opts.shiftmode != TpShifting.NONE)},{ft},1>")
        spill, regs = ptxas_of(instance)
        records[instance] = dict(
            kernel=name, variant=variant, launches=0,
            max_abs_err=err["ace"], ms=ms, plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], flat_ms=flat_ms, registers=regs,
            spills=spill)
        say(label, f"{variant} ({instance}), {n} particles ({near} within "
            f"the kernel size of the plane, {nft} floating): max|d| "
            + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
            + f"; kernel alone {ms:.4f} ms (the instance without the plane "
            f"{flat_ms:.4f} ms, {ms / flat_ms:.3f}x), with its wrapper "
            f"{wrapped_ms:.4f} ms, plain {plain_ms:.3f} ms (CUDA events); "
            f"{cand} candidates, {pairs} in-support pairs with a fluid-side "
            f"target plus {images} with images; bound {b[0] * 1e3:.2f} us "
            f"by {b[1]}; ptxas: {regs}; {spill} ({smi})")
    return records


def sps_constants(csp, visco):
    """``csp`` with laminar viscosity ``visco`` and the Smagorinsky and
    Blin constants of a laminar+SPS case at its dp."""
    lam = lamsps_csp(csp.dp, visco=visco)
    return csp.replace(visco=visco, spssmag=lam.spssmag, spsblin=lam.spsblin)


def seeded_tau(code, seed):
    """(n,6) SPS stress: N(0, 1e-3) on the fluid, zero elsewhere."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    rng = np.random.default_rng(seed)
    return torch.where(td.is_fluid(code)[:, None], torch.tensor(
        rng.normal(0.0, 1e-3, (code.shape[0], 6)), dtype=torch.float32,
        device=code.device), 0.0).contiguous()


def symmetry_lamsps_path(device, smi):
    """Phase 43, part 1: phase 26's half dam break (133,804 particles)
    through the library with ``SolverOpts(symmetry=True,
    tvisco=LAMINAR_SPS)``, which the loaders refuse: the four SYM
    instances of kernel 3 (Wendland and cubic, with and without NO_FIXED
    shifting) against the plain mirror pass on a perturbed state with a
    seeded SPS stress, then 5 + SYM_STEPS steps of the reference's
    ``-viscolamsps:1e-6 -shifting:2`` with the plane from phase 4's flow:
    cellforce_lamsps_sym exactly twice per step and no other kernel, the
    state and the SPS stress finite, the density within 10%, the p50.
    Returns (records, launches)."""
    import shutil
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpDensity,
                                                   TpKernel, TpShifting,
                                                   TpVisco)
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    root = tempfile.mkdtemp(prefix="_smoke_symlam_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        path = os.path.join(root, "DambreakHalf_Def.xml")
        with open(path, "w") as f:
            f.write(HALF_XML.format(dp=DP_BENCH, tmax=3 * XML_TOUT,
                                    tout=XML_TOUT))
        case, opts, _run = load_case(path, device=device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(opts.symmetry, "the half case's Symmetry=1 did not load")
    n, dom = case.np_total, case.dom
    pos, vel, rho, code = perturbed_state(case, device, case.csp.rhopzero,
                                          seed=7)
    cells, args = sorted_args(dom, pos, vel, rho, code)
    tau = seeded_tau(args[3], 8)
    lam = sps_constants(case.csp, SYM_VISCO)
    nofixed = TpShifting.NO_FIXED
    variants = []
    for label, ker, shift in (("wendland", TpKernel.WENDLAND, TpShifting.NONE),
                              ("wendland+shift", TpKernel.WENDLAND, nofixed),
                              ("cubic", TpKernel.CUBIC, TpShifting.NONE),
                              ("cubic+shift", TpKernel.CUBIC, nofixed)):
        variants.append((f"symmetry laminar+SPS {label}",
                         lam.replace(tkernel=ker),
                         SolverOpts(tvisco=TpVisco.LAMINAR_SPS,
                                    tdensity=TpDensity.FOURTAKAS,
                                    symmetry=True, shiftmode=shift)))
    records = sym_instances_vs_plain("symmetry-lamsps-vs-plain", variants,
                                     dom, cells, args, tau, smi)
    csp = sps_constants(case.csp, LAMSPS_VISCO)
    o = SolverOpts(tvisco=TpVisco.LAMINAR_SPS, tdensity=TpDensity.FOURTAKAS,
                   symmetry=True, shiftmode=nofixed)
    st = flowing_state(case, device)
    st = dataclasses.replace(st, spstau=torch.zeros((n, 6), device=device))
    carry, times, launched = run_steps(
        make_step(csp, o, dom), make_carry(st, csp, o, dom), 5, SYM_STEPS)
    single_phase_counts(launched, "cellforce_lamsps_sym", 2, 5 + SYM_STEPS)
    check_state(carry, 5 + SYM_STEPS, None)
    check(bool(torch.isfinite(carry.st.spstau).all()), "spstau not finite")
    rmin, rmax = fluid_rho_range(carry.st, True, csp.rhopzero)
    p50 = statistics.median(times)
    k = launched["cellforce_lamsps_sym"]
    records["cellforce_kernel<2,2,1,0,1>"]["launches"] = k
    say("symmetry-lamsps", f"half dam break, {n} particles, -viscolamsps:1e-6 "
        f"-shifting:2 with the plane through the library: 20 steps after 5 "
        f"from a flow of 1 m/s: p50 {p50 * 1e3:.3f} ms, {k} "
        f"cellforce_lamsps_sym launches, {carry.nrebuild} divides, fluid rho "
        f"[{rmin:.2f}, {rmax:.2f}], max |spstau| "
        f"{float(carry.st.spstau.abs().max()):.3e} ({smi})")
    return records, k, p50 * 1e3


def symmetry_floating_path(device, smi):
    """Phase 43, part 2: :func:`half_float_xml` at DP_BENCH, loaded without
    the Symmetry key and run with ``symmetry=True``: the FT x SYM instances
    of kernels 1 and 2 (artificial viscosity) and of kernel 3 (laminar+SPS),
    Wendland and cubic, with and without NO_FIXED shifting, against the
    plain mirror pass on a perturbed state with the box's particle mass;
    then 5 + SYM_STEPS steps of the case from rest: cellforce_sym (its FT
    x SYM instance) exactly twice per step, the state and the body finite,
    the box rigid, the density within 10%, the body's centre and
    velocity printed.  Returns (records, launches)."""
    import shutil
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpDensity,
                                                   TpKernel, TpShifting,
                                                   TpVisco)
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.features import floating as FT
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    root = tempfile.mkdtemp(prefix="_smoke_symft_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        path = os.path.join(root, "HalfFloat_Def.xml")
        with open(path, "w") as f:
            f.write(half_float_xml(DP_BENCH, 3 * XML_TOUT, XML_TOUT))
        case, opts, _run = load_case(path, device=device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    feats = case.meta["features"]
    check(opts.with_floating and not opts.symmetry and feats is not None
          and feats.floating.count == 1, f"the half tank's options {opts}")
    opts = dataclasses.replace(opts, symmetry=True)
    n, dom, csp = case.np_total, case.dom, case.csp
    st = case.state
    isft = td.is_floating(st.code)
    check(float(st.pos[isft, 1].min()) == 0.0, "the box is not on the plane")
    ftomassp = FT.body_tables(feats.floating, tuple(csp.gravity),
                              device).massp
    pos, vel, rho, code = perturbed_state(case, device, csp.rhopzero, seed=9)
    cells, args = sorted_args(dom, pos, vel, rho, code)
    tau = seeded_tau(args[3], 10)
    lam = sps_constants(csp, SYM_VISCO)
    nofixed, none = TpShifting.NO_FIXED, TpShifting.NONE
    fd = dict(tdensity=TpDensity.FOURTAKAS, symmetry=True, with_floating=True)
    variants = []
    for kname, c, visc in (("kernel 1", csp.replace(tkernel=TpKernel.WENDLAND),
                            TpVisco.ARTIFICIAL),
                           ("kernel 2", csp.replace(tkernel=TpKernel.CUBIC),
                            TpVisco.ARTIFICIAL),
                           ("kernel 3 wendland",
                            lam.replace(tkernel=TpKernel.WENDLAND),
                            TpVisco.LAMINAR_SPS),
                           ("kernel 3 cubic",
                            lam.replace(tkernel=TpKernel.CUBIC),
                            TpVisco.LAMINAR_SPS)):
        for shift in (none, nofixed):
            variants.append((
                f"symmetry + floating, {kname}"
                + (" + shift" if shift != none else ""), c,
                SolverOpts(tvisco=visc, shiftmode=shift, **fd)))
    records = sym_instances_vs_plain("symmetry-floating-vs-plain", variants,
                                     dom, cells, args, tau, smi,
                                     ftomassp=ftomassp)
    check(opts.tvisco == TpVisco.ARTIFICIAL and opts.shiftmode == none
          and csp.tkernel == TpKernel.WENDLAND, f"the path's options {opts}")
    ends = st.idp[isft][torch.tensor([0, -1], device=device)]
    span0 = float((st.pos[isft][0] - st.pos[isft][-1]).norm())
    step = make_step(csp, opts, dom, feats)
    carry, times, launched = run_steps(
        step, make_carry(st, csp, opts, dom, feats), 5, SYM_STEPS)
    single_phase_counts(launched, "cellforce_sym", 2, 5 + SYM_STEPS)
    check_state(carry, 5 + SYM_STEPS, None)
    ft = carry.st.ft
    for k in ("center", "fvel", "fomega"):
        check(bool(torch.isfinite(getattr(ft, k)).all()), f"body {k} not "
              f"finite")
    e = carry.st.pos[_by_id_rows(carry.st, ends)]
    dspan = abs(float((e[0] - e[1]).norm()) - span0)
    check(dspan < 1e-3 * csp.dp, f"the box deformed by {dspan / csp.dp:.2e} dp")
    rmin, rmax = fluid_rho_range(carry.st, True, csp.rhopzero)
    p50 = statistics.median(times)
    k = launched["cellforce_sym"]
    records["cellforce_kernel<2,1,0,1,1>"]["launches"] = k
    say("symmetry-floating", f"half tank with a {BOX_SIDE} m box on the "
        f"plane (rhopbody 800, RigidAlgorithm=1), {n} particles "
        f"({int(isft.sum())} floating): 20 steps after 5 from rest: p50 "
        f"{p50 * 1e3:.3f} ms, {k} cellforce_sym launches; body centre "
        f"{[round(x, 6) for x in ft.center[0].tolist()]} m, fvel "
        f"{[round(x, 6) for x in ft.fvel[0].tolist()]} m/s, fomega "
        f"{[round(x, 6) for x in ft.fomega[0].tolist()]} rad/s (its y "
        f"motion is not held to the plane, as in JAX); rigid within "
        f"{dspan / csp.dp:.2e} dp; fluid rho [{rmin:.2f}, {rmax:.2f}] "
        f"({smi})")
    return records, k, p50 * 1e3


def flat_domain(csp, dom):
    """``dom``'s extent in cells of the kernel size: a domain without a
    cell skin."""
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
    flat = cd.make_domain(dom.posmin, dom.posmax, csp.kernelsize,
                          simulate2d=dom.simulate2d)
    check(W.skinless(csp, flat), "the flat domain has a skin")
    return flat


def duct_case(device):
    """Phase 30's duct through ``load_case``: (case, opts, its zones)."""
    import shutil
    from dualsphysics_multilayer_tpu_torch.io.xmlcase import load_case
    root = tempfile.mkdtemp(prefix="_smoke_duct43_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        path = os.path.join(root, "Duct_Def.xml")
        with open(path, "w") as f:
            f.write(duct_xml(DUCT_DP, DUCT_TMAX))
        case, opts, _run = load_case(path, device=device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    feats = case.meta["features"]
    check(feats is not None and feats.inout is not None, "the duct's zones")
    return case, opts, feats


def skinless_duct_path(device, smi):
    """Phase 43, part 3: phase 30's duct (its extrapolated outlet reads a
    divide of the post-step positions there) on the case's domain and on
    cells of the kernel size, 5 + SYM_STEPS steps of each from its start:
    cellforce exactly twice per step, a rebuild at every step of the
    skinless run, the live ids, spawns and overflow counts of both runs
    equal, positions by id within 1e-4 dp, the p50 of each.  Returns
    (the skinless run's launches, its p50 ms, the skinned p50 ms)."""
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    case, opts, feats = duct_case(device)
    csp = case.csp
    flat = flat_domain(csp, case.dom)
    act0 = td_active(case.state)
    runs = {}
    for label, dom in (("skinned", case.dom), ("skinless", flat)):
        carry = W.make_carry(case.state, csp, opts, dom, feats)
        nrebuild0 = carry.nrebuild
        carry, times, launched = run_steps(W.make_step(csp, opts, dom, feats),
                                           carry, 5, SYM_STEPS)
        single_phase_counts(launched, "cellforce", 2, 5 + SYM_STEPS)
        check_state(carry, 5 + SYM_STEPS, None)
        runs[label] = dict(carry=carry, p50=statistics.median(times),
                           launches=launched["cellforce"],
                           rebuilds=carry.nrebuild - nrebuild0,
                           live=td_active(carry.st))
    a, b = runs["skinned"], runs["skinless"]
    check(b["rebuilds"] == 5 + SYM_STEPS, f"the skinless duct rebuilt "
          f"{b['rebuilds']} times in {5 + SYM_STEPS} steps")
    spawns = {k: int((r["live"] & ~act0).sum()) for k, r in runs.items()}
    ovf = {k: (r["carry"].overflow, r["carry"].overflow_inout)
           for k, r in runs.items()}
    check(torch.equal(a["live"], b["live"]) and ovf["skinned"] == (0, 0)
          == ovf["skinless"], f"the runs' live sets differ by "
          f"{int((a['live'] ^ b['live']).sum())} ids; spawns {spawns}, "
          f"overflow (all, inout) {ovf}")
    check(spawns["skinless"] > 0, "no spawn in the duct's steps")
    live = a["live"]
    dpos = float((by_id_pos(a["carry"].st) - by_id_pos(b["carry"].st))[live]
                 .abs().max())
    check(dpos <= 1e-4 * csp.dp, f"max |d pos| {dpos:.3e} m between the "
          f"domains, over 1e-4 dp")
    say("skinless-duct", f"phase 30's duct, {int(live.sum())} live "
        f"particles after {5 + SYM_STEPS} steps of each domain: skinless "
        f"(cells of {flat.scell * 1e3:.3f} mm, {b['rebuilds']} rebuilds) "
        f"p50 {b['p50'] * 1e3:.3f} ms against the skinned "
        f"{a['p50'] * 1e3:.3f} ms ({a['rebuilds']} rebuilds); "
        f"{spawns['skinless']} spawns in each, the same live ids, overflow "
        f"0; max |d pos| by id {dpos:.3e} m ({dpos / csp.dp:.2e} dp); "
        f"cellforce {b['launches']} launches ({smi})")
    return b["launches"], b["p50"] * 1e3, a["p50"] * 1e3


def skinless_shard_path(device, smi, dam_state):
    """Phase 43, part 4: skinless domains over 2 ranks sharing the card
    (gloo), one start of the ranks for three jobs of SKINLESS_SHARD steps:
    the 3D dam break from ``dam_state`` (phase 37's, its front past the
    slab edge), the NN wet dam break at NN_DP (SPH Morris, a 2-cell halo)
    from phase 6's flow and the duct with its zones, each against its
    one-device skinless run: positions by id within 1e-4 dp (bit-equal
    said when they are), a rebuild (migration) at every step, a fresh
    ghost exchange before each interaction and none refreshed in place,
    each kernel as often per step as on one device; the collectives and
    exchanges per step and rank 0's p50.  Returns {path: {kernel: each
    rank's launches}}."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    from dualsphysics_multilayer_tpu_torch.parallel import sharding as S
    dam = cases.dambreak3d(dp=DP_BENCH, obstacle=True, device=device)
    nn, phases = NM.wet_dambreak_nn(dp=NN_DP, device=device)
    duct, dopts, dfeats = duct_case(device)
    jobs = {
        "dambreak3d": (dam.csp, SolverOpts(tdensity=TpDensity.FOURTAKAS),
                       flat_domain(dam.csp, dam.dom), dam_state, None, None,
                       dam.csp.dp),
        "nn": (nn.csp, nn_opts("LAMINAR_SPS", "SPH"),
               flat_domain(nn.csp, nn.dom),
               flowing_state(nn, device, sim2d=True), None, phases, NN_DP),
        "duct": (duct.csp, dopts, flat_domain(duct.csp, duct.dom),
                 duct.state, dfeats, None, DUCT_DP),
    }
    refs, sims = {}, {}
    for name, (csp, opts, dom, st, feats, ph, dp) in jobs.items():
        if ph is None:
            step = W.make_step(csp, opts, dom, feats)
        else:
            step = NM.make_nn_step(csp, opts, dom, ph)
        carry, times, launched = timed_steps(
            step, W.make_carry(st, csp, opts, dom, feats), SKINLESS_SHARD)
        check(carry.overflow == 0, f"skinless {name}: overflow "
              f"{carry.overflow} on one device")
        refs[name] = (carry, statistics.median(times), launched)
        sims[name] = S.ShardedSimulation(csp, opts, dom, st, feats=feats,
                                         ndev=2, phases=ph, backend="gloo",
                                         limit=SHARD_LIMIT)
    reset_counts()
    t0 = time.perf_counter()
    outs = S.steps_together(list(sims.values()), (SKINLESS_SHARD,))
    secs = time.perf_counter() - t0
    ranks = {}
    per_step = dict(dambreak3d=2, nn=2, duct=3)
    for (name, sim), (carries, times) in zip(sims.items(), outs):
        label = f"skinless-shard-{name}"
        got = carries[-1]
        ref, p50_1, launched = refs[name]
        dp = jobs[name][-1]
        check(got.nstep == SKINLESS_SHARD and got.overflow == 0,
              f"{label}: nstep {got.nstep}, overflow {got.overflow}")
        err = shard_error(label, got, ref)
        check(err <= 1e-4 * dp, f"{label}: 2 ranks drift {err} m from the "
              f"one-device run (1e-4 dp = {1e-4 * dp})")
        stats = sim.stats
        for r, s in enumerate(stats):
            check(s["nrebuild"] == 1 + SKINLESS_SHARD
                  and s["refreshes"] == 0 and s["ghost_exchanges"]
                  == per_step[name] * SKINLESS_SHARD, f"{label}: rank {r} "
                  f"{s['nrebuild']} rebuilds, {s['refreshes']} refreshes, "
                  f"{s['ghost_exchanges']} exchanges in {SKINLESS_SHARD} "
                  f"steps")
        check(all(s["fluid_ghosts"] > 0 for s in stats),
              f"{label}: a rank received no fluid ghost row")
        ranks[f"skinless-{name}-2-ranks"] = shard_launches(
            label, stats, launched, SKINLESS_SHARD)
        p50 = statistics.median(times)
        migr = sum(int(s["migrants"]) for s in stats)
        say(label, f"{sim.state0.n} slots, 2 ranks on cuda:0 over gloo, "
            f"{SKINLESS_SHARD} steps: "
            + ("bit-equal to" if err == 0.0 else
               f"within {err:.3e} m ({err / dp:.2e} dp) of")
            + f" the one-device skinless run; per step on each rank: "
            + "; ".join(f"rank {r} {s['collectives'] / SKINLESS_SHARD:.2f} "
                        f"collectives, {s['ghost_exchanges'] / SKINLESS_SHARD:.2f}"
                        f" ghost exchanges ({s['ghost_rows'] / max(s['ghost_exchanges'], 1):.1f}"
                        f" rows each), {s['bytes'] / SKINLESS_SHARD:.0f} "
                        f"bytes" for r, s in enumerate(stats))
            + f"; {migr} migrants; p50 step {p50 * 1e3:.3f} ms on rank 0 "
            f"against the one-device {p50_1 * 1e3:.3f} ms (one card shared "
            f"by two ranks: a check, not a speed) ({smi})")
    say("skinless-shard", f"the three jobs in one start of the ranks: "
        f"{secs:.1f} s ({smi})")
    return ranks


def last_inputs_path(device, smi, dam_state):
    """Phase 43: parts 1-4 (:func:`symmetry_lamsps_path`,
    :func:`symmetry_floating_path`, :func:`skinless_duct_path`,
    :func:`skinless_shard_path`).  Returns (instance records, launches by
    path, shard launches by path)."""
    t0 = time.perf_counter()
    lam, k_lam, _ = symmetry_lamsps_path(device, smi)
    flt, k_flt, _ = symmetry_floating_path(device, smi)
    k_duct, _, _ = skinless_duct_path(device, smi)
    ranks = skinless_shard_path(device, smi, dam_state)
    say("last-inputs", f"phase 43 in {time.perf_counter() - t0:.1f} s "
        f"({smi})")
    return ({**lam, **flt}, {"symmetry-lamsps": k_lam,
                             "symmetry-floating": k_flt,
                             "skinless-duct": k_duct}, ranks)


# ---------------------------------------------------------------------------
# phase 44: the examples' twins, port_verify_e2e, periodic + inout
# ---------------------------------------------------------------------------

PDUCT = dict(length=0.2, width=0.2, height=0.06, layers=3, vel=0.5,
             jitter=(0.05, 0.5))
PDUCT_DP = 0.0025        # phase 44: ~200k particles
PDUCT_STEPS = 20


def periodic_duct(dp, device):
    """A y-periodic duct with an x inlet and an x outlet: water ``height``
    deep over a bed three particles thick, ``length`` between the zones'
    planes, the period ``width`` (box [-dp/2, width - dp/2)), gravity.  The
    inlet (imposed ``vel``, hydrostatic density under a calculated zsurf,
    an AWAS correction) spans the middle 40% of the width, so no member of
    it lies within a kernel size of a periodic edge; the outlet (velocity
    and density extrapolated, capturing fluid) spans all of it.  The fluid,
    members included, moves at ``vel`` along x plus noise of ``jitter``
    (m/s, kg/m^3) seeded with 0.  Returns (csp, dom, state, Features, the
    drawn lattice)."""
    from dualsphysics_multilayer_tpu_torch import Features
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.features import inout as IO
    from dualsphysics_multilayer_tpu_torch.features import periodic as PER
    from dualsphysics_multilayer_tpu_torch.models import cases
    L, W, H = PDUCT["length"], PDUCT["width"], PDUCT["height"]
    lay = PDUCT["layers"]
    csp = td.make_ctesph(simulate2d=False, dp=dp, hswl=H, visco=0.02)
    d = cases.Draw(dp=dp)
    w = (lay + 2) * dp
    d.box((dp, 0, 0), (L - dp, W - dp, H), ptype=td.TYPE_FLUID, mk=0)
    d.box((-w, 0, -3 * dp), (L + w, W - dp, -dp), ptype=td.TYPE_FIXED, mk=0)
    pos, code = d.build()
    yc = 0.5 * (W - dp)
    aw = IO.InOutAwas(inletmode=True, depth=H, zsurf_t=(0.0, 1.0),
                      zsurf_v=(H + 0.6 * dp, H + 0.6 * dp), gauge_x=3 * dp,
                      gauge_y=yc, z0=-0.5 * dp)
    inlet = IO.InOutZone(p0=(0.0, yc, H / 2), direction=(1, 0, 0),
                         layers=lay, tangent1=(0, 0, 1), size1=H + dp,
                         size2=0.4 * W, vel_profile=(PDUCT["vel"], 0, 0),
                         rho_mode="hydrostatic", zsurf=H, zsurf_calc=True,
                         awas=aw)
    outlet = IO.InOutZone(p0=(L, yc, H / 2), direction=(-1, 0, 0),
                          layers=lay, tangent1=(0, 0, 1), size1=H + dp,
                          size2=W, vel_extrap=True, rho_extrap=True)
    iocfg = IO.InOutCfg(zones=(inlet, outlet))
    ks = csp.kernelsize
    near = int(max((pos[:, 1] < ks).sum(), (pos[:, 1] >= W - dp - ks).sum()))
    pcfg = PER.PeriodicCfg(axes=(False, True, False), lo=(0, -dp / 2, 0),
                           hi=(0, W - dp / 2, 0),
                           ghost_cap=int(1.5 * near) + 64)
    spare = IO.slots_required(iocfg, csp) + int(
        3 * len(IO.zone_points(inlet, csp)) / lay) + 256
    st = cases._make_state(csp, pos, code, H, device=device,
                           capacity=pos.shape[0] + spare)
    st = IO.init_inout(iocfg, csp, st)
    rng = np.random.default_rng(0)
    jitter = PDUCT["jitter"]
    fl = td.is_fluid(st.code) & td.is_active(st.code)
    m = int(fl.sum())
    vel = st.vel.clone()
    vel[fl] = torch.tensor([PDUCT["vel"], 0.0, 0.0], device=device) \
        + torch.tensor(rng.normal(0, jitter[0], (m, 3)), dtype=torch.float32,
                       device=device)
    rho = st.rho.clone()
    rho[fl] += torch.tensor(rng.normal(0, jitter[1], m), dtype=torch.float32,
                            device=device)
    st = dataclasses.replace(st, vel=vel, rho=rho)
    dom = cases._make_domain(csp, pos, headroom=0.5)
    return csp, dom, st, Features(periodic=pcfg, inout=iocfg), pos


TWIN_STEPS = 1           # phase 44: the twins stop at their first save
TWIN03_TOUT = 0.01       # phase 44: twin 03's first save (its own is 0.1 s)


def load_file(path, name):
    """The module of a script of the checkout (a twin, port_verify_e2e.py),
    imported without running its ``__main__`` block."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def timed_run_steps():
    """Every step that ``Simulation.run`` makes inside the block, timed on
    the host after a device synchronisation: yields the list of seconds
    (``models.wcsph.make_advance`` builds its step through the module's
    ``make_step``)."""
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    orig = W.make_step
    times = []

    def make_step(*args, **kw):
        step = orig(*args, **kw)

        def timed(carry):
            t0 = time.perf_counter()
            carry = step(carry)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return carry
        return timed

    W.make_step = make_step
    try:
        yield times
    finally:
        W.make_step = orig


def sim_twin(label, module, smi, **kw):
    """A twin's ``main(max_steps=TWIN_STEPS, **kw)`` (its own case and dp,
    its own save interval unless ``kw`` gives one; it stops at its first
    save): kernel 1 twice per step and no other kernel, overflow 0, the
    state finite, the fluid density within 10% of rho0.  Returns
    (launches, p50 s, wall s, steps)."""
    reset_counts()
    t0 = time.perf_counter()
    with timed_run_steps() as times, contextlib.redirect_stdout(
            io.StringIO()) as out:
        sim = module.main(max_steps=TWIN_STEPS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    print(out.getvalue(), end="", flush=True)
    c = sim.carry
    nsteps = c.nstep
    single_phase_counts(launched, "cellforce", 2, nsteps)
    check(len(times) == nsteps, f"{label}: {len(times)} timed steps of "
          f"{nsteps}")
    check_state(c, nsteps, None)
    rmin, rmax = fluid_rho_range(c.st, True, sim.csp.rhopzero)
    lines = out.getvalue().splitlines()
    p50 = statistics.median(times)
    say(label, f"{lines[-1]!r} after {nsteps} steps ({len(lines)} lines "
        f"printed); cellforce {launched['cellforce']} launches, overflow 0, "
        f"fluid rho [{rmin:.2f}, {rmax:.2f}]; p50 step {p50 * 1e3:.3f} ms, "
        f"wall {wall:.1f} s ({smi})")
    return launched["cellforce"], p50, wall, nsteps


def cli_twin(label, argv, root, env, dirout):
    """A twin that runs ``python -m dualsphysics_multilayer_tpu_torch.cli``
    in a process of its own, from ``root``, with ``-svsteps -svtimers``
    and its output in ``dirout``: exit code 0 (the run loop raises on an
    overflow), its CLI line ``done: ... launches={...}`` (the child's
    kernel launches, counted from its start), one interval of one step
    per row of its ``Timers.csv`` (timed after a device synchronisation,
    its PART's save left out, after the initial PART's row).  Returns (the launches, steps, the steps'
    p50 s, wall s of the child's run, wall s of the command)."""
    t0 = time.perf_counter()
    r = subprocess.run(argv + ["-svsteps", "-svtimers", "-dirout", dirout],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=900)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"{label}: exit code {r.returncode}: "
          f"{r.stdout[-1500:]} {r.stderr[-3000:]}")
    m = re.search(r"done: t=\S+ steps=(\d+) wall=([\d.]+)s .* "
                  r"launches=(\{.*\})", r.stdout)
    check(m is not None, f"{label}: no done line in {r.stdout[-1500:]!r}")
    nsteps = int(m.group(1))
    with open(os.path.join(dirout, "Timers.csv")) as f:
        head, *rows = f.read().splitlines()
    sep = head[len("Part")]
    rows = [x.split(sep) for x in rows]
    # the initial PART's row (no step), then one row a step
    check([x[2] for x in rows] == ["0"] + ["1"] * nsteps,
          f"{label}: Timers.csv's steps {[x[2] for x in rows]} for "
          f"{nsteps} steps")
    rows = rows[1:]
    p50 = statistics.median(float(x[3]) for x in rows)
    return json.loads(m.group(3)), nsteps, p50, float(m.group(2)), wall


def part_densities(directory, groups):
    """Each PART of ``directory``: the ids of the first, positions finite,
    the fluid density of each (select(code), rho0) of ``groups`` within
    10% of its rho0.  Returns (the PARTs' count, [min, max] per group)."""
    from dualsphysics_multilayer_tpu_torch.io import partdata as PD
    names = sorted(f for f in os.listdir(directory)
                   if re.fullmatch(r"Part_\d{4}\.bi4", f))
    ids0, ranges = None, [[np.inf, -np.inf] for _ in groups]
    for f in names:
        d = PD.read_part(os.path.join(directory, f))
        ids = np.sort(d["idp"])
        ids0 = ids if ids0 is None else ids0
        check(np.array_equal(ids, ids0), f"{f}: ids differ from the first "
              f"PART's")
        check(bool(np.isfinite(d["pos"]).all()), f"{f}: Posd not finite")
        code = d["code"].astype(np.int64)
        for rg, (select, rho0) in zip(ranges, groups):
            r = d["rhop"][select(code)]
            check(r.size > 0 and 0.9 * rho0 <= r.min()
                  and r.max() <= 1.1 * rho0, f"{f}: fluid density out of "
                  f"+-10% of {rho0}")
            rg[:] = [min(rg[0], r.min()), max(rg[1], r.max())]
    return len(names), ranges


def periodic_duct_path(device, smi):
    """Phase 44's periodic + inout duct (:func:`periodic_duct`) at
    ``PDUCT_DP`` for ``PDUCT_STEPS`` steps: cellforce twice per step and no
    other kernel, overflow 0, the inlet's spawns, the state finite, the
    fluid density within 10%; the outlet's members within a kernel size of
    a periodic edge, whose mirror nodes read the periodic images."""
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models.wcsph import (make_carry,
                                                                make_step)
    csp, dom, st, feats, _lat = periodic_duct(PDUCT_DP, device)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    pcfg = feats.periodic
    step = make_step(csp, opts, dom, feats)
    carry = make_carry(st, csp, opts, dom, feats)
    live0 = int(td.is_active(carry.st.code).sum())
    ids0 = set(carry.st.idp[td.is_active(carry.st.code)].tolist())
    carry, times, launched = run_steps(step, carry, 0, PDUCT_STEPS)
    single_phase_counts(launched, "cellforce", 2, PDUCT_STEPS)
    check_state(carry, PDUCT_STEPS, None)
    s = carry.st
    act = td.is_active(s.code)
    spawned = len(set(s.idp[act].tolist()) - ids0)
    check(spawned > 0, "periodic duct: the inlet spawned nothing")
    rmin, rmax = fluid_rho_range(s, True, csp.rhopzero)
    y = s.pos[:, 1]
    edge = act & (td.code_inout(s.code) == 2) & (
        torch.minimum(y - pcfg.lo[1], pcfg.hi[1] - y) < csp.kernelsize)
    p50 = statistics.median(times)
    say("periodic-inout", f"y-periodic duct at dp {PDUCT_DP}: {live0} live "
        f"of {s.n} slots, ghost_cap {pcfg.ghost_cap}; {PDUCT_STEPS} steps: "
        f"{launched['cellforce']} cellforce launches, {carry.nrebuild} "
        f"rebuilds, {spawned} spawns, {int(act.sum())} live, "
        f"{int(edge.sum())} outlet members within a kernel size of a "
        f"periodic edge, fluid rho [{rmin:.2f}, {rmax:.2f}], overflow 0; "
        f"p50 step {p50 * 1e3:.3f} ms ({smi})")
    return launched["cellforce"], p50


def twins_path(device, smi):
    """Phase 44: ``port_verify_e2e.py`` at its full tmax with its own pass
    rule, the twins of examples/01-06 on the card and phase 44's periodic
    + inout duct.  Returns ({path: cellforce launches}, {path: {NN kernel:
    launches}})."""
    import shutil
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="_smoke_twins_", dir=here)
    cwd = os.getcwd()
    paths, nn = {}, {}
    try:
        os.chdir(root)
        # port_verify_e2e: VERIFY OK or the phase fails
        pve = load_file("port_verify_e2e.py", "port_verify_e2e")
        reset_counts()
        t0 = time.perf_counter()
        with timed_run_steps() as times:
            ok, rows = pve.main()
        wall = time.perf_counter() - t0
        launched = counts()
        nsteps = len(times)
        single_phase_counts(launched, "cellforce", 2, nsteps)
        last = rows[-1]
        check(ok, f"port_verify_e2e: VERIFY FAIL at {last}")
        check(0.9e3 <= min(r[4] for r in rows)
              and max(r[5] for r in rows) <= 1.1e3,
              f"port_verify_e2e: fluid density out of +-10%: {rows}")
        say("verify-e2e", f"VERIFY OK: front advance/H "
            f"{(last[3] - pve.FRONT0) / pve.H:.4f} at t* {last[2]:.4f} "
            f"(part {last[0]}, t {last[1]:.4f} s), fluid rho [{last[4]:.2f}, "
            f"{last[5]:.2f}], overflow {last[6]}; {nsteps} steps, "
            f"cellforce {launched['cellforce']} launches; p50 step "
            f"{statistics.median(times) * 1e3:.3f} ms, wall {wall:.1f} s "
            f"({smi})")
        paths["verify-e2e"] = launched["cellforce"]

        # twins 02-04 through main(max_steps=...)
        for key, name in (("02", "02_waveflume"),
                          ("03", "03_floating_moored"),
                          ("04", "04_inout_channel")):
            mod = load_file(f"examples/torch/{name}.py", f"twin_{key}")
            kw = dict(tout=TWIN03_TOUT) if key == "03" else {}
            paths[f"twin-{key}"] = sim_twin(f"twin-{key}", mod, smi,
                                            **kw)[0]

        # twins 01 and 05: the CLI in processes of their own, on phase
        # 24's dam-break XML and phase 25's NN XML, each for 2 intervals
        env = dict(os.environ, PYTHON=sys.executable, PYTHONPATH=os.pathsep
                   .join(p for p in (here, os.environ.get("PYTHONPATH"))
                         if p))
        xml = os.path.join(root, "Dambreak_Def.xml")
        with open(xml, "w") as f:
            f.write(DAMBREAK_XML.format(dp=DP_BENCH, tmax=3 * XML_TOUT,
                                        tout=XML_TOUT))
        d01 = os.path.join(root, "out01")
        launched, nsteps, p50, run_s, wall = cli_twin("twin-01", [
            "sh", os.path.join(here, "examples", "torch", "01_dambreak.sh"),
            "-case", xml, f"-tmax:{2 * XML_TOUT!r}",
            f"-tout:{XML_TOUT!r}", "-sv:binx"], root, env, d01)
        check(launched == {"cellforce": 2 * nsteps}, f"twin-01: {launched} "
              f"in {nsteps} steps, expected cellforce twice per step")
        nparts, ranges = part_densities(d01, [(lambda c: td.code_type(c)
                                               == td.TYPE_FLUID, 1000.0)])
        say("twin-01", f"examples/torch/01_dambreak.sh -case (phase 24's "
            f"XML at dp {DP_BENCH:.6g}) -tmax:{2 * XML_TOUT:g}: "
            f"{nsteps} steps, {nparts} PARTs read back, fluid rho "
            f"[{ranges[0][0]:.2f}, {ranges[0][1]:.2f}], launches "
            f"{launched}; p50 step {p50 * 1e3:.3f} ms (the child's "
            f"Timers.csv), the run {run_s:.1f} s with a PART a step, the "
            f"command {wall:.1f} s ({smi})")
        paths["twin-01"] = launched["cellforce"]
        _case, phases = NM.wet_dambreak_nn(dp=NN_DP, device=device)
        xml = os.path.join(root, "WetDambreak_Def.xml")
        with open(xml, "w") as f:
            f.write(NN_XML.format(
                dp=NN_DP, cs_w=phases.phases[0].csound,
                cs_m=phases.phases[1].csound, velgrad=2,
                tmax=3 * NN_XML_TOUT, tout=NN_XML_TOUT))
        d05 = os.path.join(root, "out05")
        launched, nsteps, p50, run_s, wall = cli_twin("twin-05", [
            sys.executable, os.path.join(here, "examples", "torch",
                                         "05_nn_mud_dambreak.py"),
            "-case", xml, f"-tmax:{2 * NN_XML_TOUT!r}",
            f"-tout:{NN_XML_TOUT!r}"], root, env, d05)
        want = {"nnforce_p1": 2 * nsteps, "nnforce_p3": 2 * nsteps}
        check(launched == want, f"twin-05: {launched} in {nsteps} steps, "
              f"expected nnforce_p1 and nnforce_p3 twice per step")
        groups = [((lambda c, i=i: ((c >> 16) & 3 == 3)
                    & ((c & 0xFFFF) == i)), ph.rho0)
                  for i, ph in enumerate(phases.phases)]
        nparts, ranges = part_densities(d05, groups)
        say("twin-05", f"examples/torch/05_nn_mud_dambreak.py -case (phase "
            f"25's SPH XML at dp {NN_DP:.6g}) -tmax:{2 * NN_XML_TOUT:g}: "
            f"{nsteps} steps, {nparts} PARTs read back, phase "
            + ", ".join(f"{i} rho [{a:.2f}, {b:.2f}]"
                        for i, (a, b) in enumerate(ranges))
            + f", launches {launched}; p50 step {p50 * 1e3:.3f} ms (the "
            f"child's Timers.csv), the run {run_s:.1f} s with a PART a step,"
            f" the command {wall:.1f} s ({smi})")
        nn["twin-05"] = launched

        # twin 06: the dry run over 2 ranks sharing the card (gloo)
        mod = load_file("examples/torch/06_sharded_runup.py", "twin_06")
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            nranks = mod.main()
        wall = time.perf_counter() - t0
        launched = counts()
        print(out.getvalue(), end="", flush=True)
        lines = out.getvalue().splitlines()
        check(nranks == max(2, torch.cuda.device_count())
              and sum(x.startswith(f"dryrun_multichip({nranks}): ")
                      for x in lines) == 3
              and lines[-1] == f"sharded step OK on {nranks} ranks",
              f"twin-06: {lines}")
        check(launched["cellforce"] == 6, f"twin-06: rank 0 launched "
              f"{launched}, expected cellforce twice in each case's step")
        say("twin-06", f"{lines[-1]!r}: rank 0 {launched['cellforce']} "
            f"cellforce launches, wall {wall:.1f} s with the ranks' start "
            f"({smi})")
        paths["twin-06"] = launched["cellforce"]
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    paths["periodic-inout"] = periodic_duct_path(device, smi)[0]
    return paths, nn


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
    records.update(nn_kernels_vs_plain(case, phases, device, smi,
                                       wide_too=True))
    # kernels 4 and 6 at a third of the dp (330,781 particles), where one
    # thread per target fills the card too
    nn_kernels_vs_plain(*NM.wet_dambreak_nn(dp=NN_DP / 3, device=device),
                        device, smi, label="nn-kernel-vs-plain-large",
                        full=False)

    # 6. NN main path: SPH Morris, Fourtakas
    nwarm, nsteps = 5, 50
    nn_p50s = {}
    launched, step, carry = nn_path(case, phases, nn_opts("LAMINAR_SPS", "SPH"),
                                    device, nwarm, nsteps, "nn-main-path", smi,
                                    p50s=nn_p50s)
    for k in ("nnforce_p1", "nnforce_p3"):
        check(launched[k] == 2 * (nwarm + nsteps),
              f"{launched} in {nwarm + nsteps} steps, expected {k} 2 per step")
        records[k]["launches"] = launched[k]

    # 7. NN FDA path: FDA Morris
    nwarm, nsteps = 5, 20
    launched, _, _ = nn_path(case, phases, nn_opts("LAMINAR_SPS", "FDA"),
                             device, nwarm, nsteps, "nn-fda-path", smi,
                             p50s=nn_p50s)
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

    # 37-38. domain decomposition: the dam break over 2 ranks sharing the
    # card and over one NCCL rank, then the NN, floating and mDBC paths
    # and -shard:1 through the CLI
    shard = {"dambreak3d": shard_path(device, smi)}
    shard.update(shard_paths(device, smi))
    # 39. the open boundaries and DEM under domain decomposition: the
    # channel and the duct's zones, the DEM boxes, the y-periodic tank
    feats = shard_feats_path(device, smi)
    # 40. the coastal run-up (BASELINE config 5) at ~10M and ~50M
    # particles, a PART, 2 ranks, the CLI and the dry run
    coastal, records["cellforce"]["coastal_states"], coastal_shard = \
        coastal_path(device, smi)
    paths.update(coastal)
    # 41. the NN wet dam break with 12 phases: kernels 4-6 over the phase
    # table in a device array, the SPH and FDA paths, a 12-phase XML
    nn12, nn12_records = nn_phases_path(device, registers, records, nn_p50s,
                                        smi)
    for path, launched in nn12.items():
        for name, k in launched.items():
            records[name]["path_launches"][path] = k
    # 42. a domain without a cell skin: the 3D dam break over kernel 1
    paths["skinless"] = skinless_path(device, smi)
    # 43. the last inputs JAX runs and the port refused: the symmetry plane
    # with laminar+SPS and with floating bodies, the skinless domain with
    # inlet/outlet zones and under -shard
    inst43, paths43, ranks43 = last_inputs_path(
        device, smi, shard["dambreak3d"].pop("state"))
    records["cellforce_lamsps"].setdefault("path_launches", {})[
        "symmetry-lamsps"] = paths43.pop("symmetry-lamsps")
    paths.update(paths43)
    for key, r in inst43.items():
        records[r["kernel"]].setdefault("instances", []).append(dict(
            instance=key, **{f: r[f] for f in (
                "variant", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "flat_ms", "registers", "spills")}))
    # 44. the twins of examples/01-06 and port_verify_e2e.py on the card,
    # and periodic boundaries with inlet/outlet zones
    paths44, nn44 = twins_path(device, smi)
    paths.update(paths44)
    for path, launched in nn44.items():
        for name, k in launched.items():
            records[name]["path_launches"][path] = k
    for key, r in nn12_records.items():
        records[r["kernel"]]["instances"].append(dict(
            instance=key, **{f: r[f] for f in (
                "variant", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by")}))
    for name in ("nnforce_p1", "nnforce_p3", "nnforce_fda"):
        records[name]["table_ms"] = {"2 phases, parameter table":
                                     records[name]["table_ms"],
                                     "2 phases, device table":
                                     records[name].pop("wide_ms")}
    for path, ranks in (("dambreak3d-2-ranks", shard["dambreak3d"]["ranks"]),
                        ("dambreak3d-nccl", shard["dambreak3d"]["nccl"]),
                        ("nn-2-ranks", shard["nn"]["ranks"]),
                        ("floating-2-ranks", shard["floating"]["ranks"]),
                        ("mdbc-2-ranks", shard["mdbc"]["ranks"]),
                        ("cli-shard-1", shard["cli"]["ranks"]),
                        ("coastal-2-ranks", coastal_shard["ranks"])) + tuple(
            (f"{k}-2-ranks", v["ranks"]) for k, v in feats.items()) + tuple(
            ranks43.items()):
        for name, per_rank in ranks.items():
            records[name].setdefault("shard_launches", {})[path] = per_rank

    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep,
        launches=records[name]["launches"],
        max_abs_err=records[name]["max_abs_err"], ms=records[name]["ms"],
        plain_ms=records[name]["plain_ms"], bound_ms=records[name]["bound_ms"],
        bound_by=records[name]["bound_by"], library_ms=None,
        **{k: records[name][k] for k in ("instances", "path_launches",
                                          "open_states", "coupling_states",
                                          "nbrlist_state", "shard_launches",
                                          "coastal_states", "table_ms")
           if k in records[name]})
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
