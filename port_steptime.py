"""p50 step times of the PyTorch/CUDA port's paths on one NVIDIA GPU, for
comparing two checkouts in one run (parent, change, change, parent):

    python3 port_steptime.py [--root DIR]
        [--paths main,nn,nn12,lamsps,cubic,floatingbox,mdbc,skinless]
        [--trace N]

``--root`` is the checkout whose ``dualsphysics_multilayer_tpu_torch`` is
imported (default: the directory of this script); the cases, the flowing
start (fluid at 1 m/s along x, seeded 0.05 m/s jitter) and the trace come
from this script's ``chip_smoke.py``.  Paths:

* ``main``: the 3D dam break at 267,469 particles (BENCH_NP=300000),
  Wendland, artificial viscosity, Fourtakas;
* ``lamsps``: the same with laminar+SPS viscosity 1e-6 and NO_FIXED
  shifting (the reference's ``-viscolamsps:1e-6 -shifting:2``);
* ``cubic``: the same with the cubic spline (``-cubic``);
* ``nn``: the 2D wet dam break NN at 37,143 particles, SPH Morris;
* ``nn12``: the same with its mud column in 11 strata, 12 phases
  (``nnewtonian.layered_dambreak_nn``: kernels 4-6 read the phase table
  from a device array);
* ``floatingbox``: the 2D floating box at 62,033 particles with bench.py's
  floatingbox options (Fourtakas, floating bodies, mDBC walls without
  normals, so no pre-pass);
* ``mdbc``: the 2D dam break with mDBC walls at 61,589 particles,
  Fourtakas, VEL0 (the CLI's ``-mdbc``);
* ``skinless``: ``main`` on cells of the kernel size (a domain without a
  cell skin: a rebuild every step, a divide at each interaction).

A path may be named more than once (``nn,nn12,nn12,nn``): each runs on
its own case, in the order given.

Prints one JSON line per path: particles, p50 step of 50 steps after 5
warm-up (host clock around a step that ends in
``torch.cuda.synchronize()``), particle-steps/s and rebuilds inside the
steps (warm-up included); with ``--trace N``, N more steps under
``torch.profiler`` (``chip_smoke.trace_steps``: device busy time and
operations per step, the idle share of the traced window, the pair
kernels' device time), then N more steps with the step's parts timed
(``part_times``).  A path the checkout does not cover prints why.  Needs
one CUDA device; imports no JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke as CS   # before --root joins sys.path: this checkout's

NWARM, NSTEPS = 5, 50
KERNELS = ("cellforce", "nnforce")   # name parts of the pair kernels


def make_path(path, device):
    """(particles, step, carry) of ``path`` at its flowing start."""
    import dualsphysics_multilayer_tpu_torch as P
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    if path in ("floatingbox", "mdbc"):
        flt = path == "floatingbox"
        case = (cases.floatingbox2d(dp=CS.DP_FLOAT, device=device) if flt
                else cases.dambreak2d(dp=CS.DP_2D, mdbc=True, device=device))
        csp = case.csp
        opts = P.SolverOpts(
            tdensity=td.TpDensity.FOURTAKAS, with_floating=flt,
            tboundary=td.TpBoundary.MDBC,
            slipmode=td.TpSlipMode.NO_SLIP if flt else td.TpSlipMode.VEL0)
        step = P.make_step(csp, opts, case.dom,
                           P.Features(floating=case.meta["ftcfg"]) if flt
                           else None)
    elif path in ("nn", "nn12"):
        from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
        build = NM.wet_dambreak_nn if path == "nn" else NM.layered_dambreak_nn
        case, phases = build(dp=CS.NN_DP, device=device)
        csp = case.csp
        opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS,
                            tdensity=td.TpDensity.FOURTAKAS)
        step = P.make_nn_step(csp, opts, case.dom, phases)
    else:
        lamsps = path == "lamsps"
        case = cases.dambreak3d(dp=CS.DP_BENCH, obstacle=True, device=device,
                                **(dict(visco=CS.LAMSPS_VISCO, need_sps=True)
                                   if lamsps else {}))
        csp = case.csp
        opts = P.SolverOpts(tdensity=td.TpDensity.FOURTAKAS)
        if lamsps:
            csp = CS.lamsps_csp(CS.DP_BENCH)
            opts = P.SolverOpts(tvisco=td.TpVisco.LAMINAR_SPS,
                                tdensity=td.TpDensity.FOURTAKAS,
                                shiftmode=td.TpShifting.NO_FIXED)
        elif path == "cubic":
            csp = csp.replace(tkernel=td.TpKernel.CUBIC)
        elif path == "skinless":
            from dualsphysics_multilayer_tpu_torch.ops import celldiv as cd
            d = case.dom
            case.dom = cd.make_domain(d.posmin, [p + k * d.scell for p, k in
                                                 zip(d.posmin, d.nc)],
                                      csp.kernelsize)
        step = P.make_step(csp, opts, case.dom)
    st = CS.flowing_state(case, device, sim2d=csp.simulate2d)
    return case.np_total, step, P.make_carry(st, csp, opts, case.dom)


def part_times(step, carry, nsteps):
    """Host-clock ms per step of the step's parts over ``nsteps`` steps:
    the pair interaction (``forces.interaction_forces``), the mDBC
    pre-pass (``mdbc.mdbc_correction``) and the rigid-body update
    (``floating.run_floating``), each between two device synchronisations,
    so each holds its host dispatch and its device time; ``step_ms`` is the
    whole step under the same synchronisations.  Parts the checkout lacks
    or the path never calls are left out."""
    import importlib
    parts = {"interaction": ("ops.forces", "interaction_forces"),
             "mdbc_prepass": ("ops.mdbc", "mdbc_correction"),
             "rigid_solve": ("features.floating", "run_floating")}
    spent, saved = {}, {}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    for name, (module, attr) in parts.items():
        try:
            mod = importlib.import_module(
                f"dualsphysics_multilayer_tpu_torch.{module}")
        except ImportError:
            continue
        saved[name] = (mod, getattr(mod, attr))
        setattr(mod, attr, timed(name, saved[name][1]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nsteps):
            carry = step(carry)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name, (mod, fn) in saved.items():
            setattr(mod, parts[name][1], fn)
    out = {f"{k}_ms": v * 1e3 / nsteps for k, v in spent.items()}
    out["step_ms"] = total * 1e3 / nsteps
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--paths",
                    default="main,nn,lamsps,cubic,floatingbox,mdbc")
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: port_steptime.py times the port on a GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    for path in args.paths.split(","):
        out = dict(root=root, path=path, gpu=smi)
        try:
            n, step, carry = make_path(path, device)
        except (NotImplementedError, AttributeError, ValueError) as e:
            print(json.dumps(dict(out, unsupported=str(e))), flush=True)
            continue
        nrebuild0, times = carry.nrebuild, []
        for k in range(NWARM + NSTEPS):
            t0 = time.perf_counter()
            carry = step(carry)
            torch.cuda.synchronize()
            if k >= NWARM:
                times.append(time.perf_counter() - t0)
        p50 = statistics.median(times)
        out.update(particles=n, steps=NSTEPS, p50_step_ms=p50 * 1e3,
                   particle_steps_per_s=n / p50,
                   rebuilds=carry.nrebuild - nrebuild0)
        if args.trace:
            r = CS.trace_steps(step, carry, args.trace, KERNELS)
            if r is None:
                out.update(trace="not measured: no device activity")
            else:
                r["pair_kernel_ms"] = sum(r.pop("kernel_ms").values())
                out.update(r)
            out.update(parts=part_times(step, carry, args.trace))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
