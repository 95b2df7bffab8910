"""p50 step times of the PyTorch/CUDA port's paths on one NVIDIA GPU, for
comparing two checkouts in one run (parent, change, change, parent):

    python3 port_steptime.py [--root DIR] [--paths main,nn,lamsps,cubic]
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
* ``nn``: the 2D wet dam break NN at 37,143 particles, SPH Morris.

Prints one JSON line per path: particles, p50 step of 50 steps after 5
warm-up (host clock around a step that ends in
``torch.cuda.synchronize()``), particle-steps/s and rebuilds inside the
steps (warm-up included); with ``--trace N``, N more steps under
``torch.profiler`` (``chip_smoke.trace_steps``: device busy time and
operations per step, the idle share of the traced window, the pair
kernels' device time).  A path the checkout does not cover prints why.
Needs one CUDA device; imports no JAX.
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
    if path == "nn":
        from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
        case, phases = NM.wet_dambreak_nn(dp=CS.NN_DP, device=device)
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
        step = P.make_step(csp, opts, case.dom)
    st = CS.flowing_state(case, device, sim2d=csp.simulate2d)
    return case.np_total, step, P.make_carry(st, csp, opts, case.dom)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--paths", default="main,nn,lamsps,cubic")
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
        except NotImplementedError as e:
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
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
