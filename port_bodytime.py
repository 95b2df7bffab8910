"""Kernel 1 and the default instances of the three NN kernels alone, for
this checkout and a parent, in turns, on one NVIDIA GPU:

    python3 port_bodytime.py [--parent DIR] [--rounds 2]

Each checkout (this one, ``committed``; the one at ``--parent``, with its
own package and ``chip_smoke.py``, ``parent``) runs in a process of its
own.  The cases and the timing are ``chip_smoke.py``'s: kernel 1 on phase
4's case (the 3D dam break at 267,469 particles in a seeded perturbed
state), alone (CUDA events around 20 back-to-back launches, median of 5),
three times; then phase 5's NN kernels (nnforce_p1, nnforce_p3,
nnforce_fda, Wendland without shifting) alone on the 2D wet dam break at
37,143 particles.  Prints one JSON line per run: the checkout, kernel 1's
three times, the NN kernels' times, and the ptxas registers of kernel 1's
main-path instances and of the NN kernels' default instances.  Needs one
CUDA device; imports no JAX.
"""

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def time_kernels():
    """In a checkout's directory: kernel 1 on phase 4's case and the NN
    kernels on phase 5's, alone; prints the JSON line."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as CS
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    from dualsphysics_multilayer_tpu_torch.ops.cuda import build
    dev = torch.device("cuda", 0)
    case = cases.dambreak3d(dp=CS.DP_BENCH, obstacle=True, device=dev)
    pos, vel, rho, code = CS.perturbed_state(case, dev, case.csp.rhopzero)
    cells, args = CS.sorted_args(case.dom, pos, vel, rho, code)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    alone = [CS.compare_cellforce(case.csp, opts, case.dom, cells, args,
                                  reps=1)[1] for _ in range(3)]
    nncase, phases = NM.wet_dambreak_nn(dp=CS.NN_DP, device=dev)
    nn_ms = {k: r["ms"] for k, r in
             CS.nn_kernels_vs_plain(nncase, phases, dev, "").items()}
    registers = {}   # instance <KER,VISC,SHIFT[,FT]>: ptxas registers
    with open(build.library_path("cellforce") + ".log") as f:
        entry = None
        for line in f:
            m = re.search(r"cellforce_kernelILi(\d)ELi(\d)ELb(\d)E(?:Lb(\d)E)?",
                          line)
            if "entry function" in line:
                entry = m and "<" + ",".join(g for g in m.groups() if g) + ">"
            m = re.search(r"Used (\d+) registers", line)
            if m and entry and entry.startswith("<2,1,0"):
                registers[entry] = int(m.group(1))
    with open(build.library_path("nnforce") + ".log") as f:
        entry = None
        for line in f:
            e = re.search(r"entry function '([^']+)'", line)
            if e:
                # the parent's kernels are no templates; the default
                # instances are <2,0> (p1, FDA) and <2> (p3)
                entry = CS.kernel_label(e.group(1))
                entry = entry if entry.endswith(("kernel", "<2,0>", "<2>")) \
                    else None
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                registers[entry] = int(m.group(1))
    print(json.dumps(dict(dir=os.getcwd(), n=case.np_total, alone_ms=alone,
                          nn_ms=nn_ms, registers=registers)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        return time_kernels()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: port_bodytime.py times kernel 1 on a GPU")
    dirs = {"committed": ROOT}
    if args.parent:
        dirs["parent"] = os.path.abspath(args.parent)
    order = list(dirs)
    for _ in range(args.rounds):
        for body in order + order[::-1]:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--time"], cwd=dirs[body], capture_output=True,
                               text=True)
            line = (r.stdout.strip().splitlines() or ["{}"])[-1]
            out = dict(body=body, **json.loads(line)) if r.returncode == 0 \
                else dict(body=body, failed=r.stderr[-1500:])
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
