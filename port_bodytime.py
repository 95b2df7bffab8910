"""Kernel 1 alone on the main path's case for two forms of the pair body,
and the parent's, in turns, on one NVIDIA GPU:

    python3 port_bodytime.py [--parent DIR] [--rounds 2]

* ``committed``: this checkout's ``csrc/``, where the floating mass lives
  in instances of its own (``FT``), so the main path's instance has no
  floating-mass code;
* ``runtime-test``: the same body with the floating-mass test in every
  instance (``if (ft_c && ftmass != nullptr)``, ``FT`` ignored), the form
  the body had first;
* ``parent``: the checkout at ``--parent`` (its own package and
  ``chip_smoke.py``), when given.

Each body runs in a process of its own, from a copy of this checkout's
package and ``chip_smoke.py`` under ``_build/bodytime/`` for
``runtime-test``.  The case and the timing are ``chip_smoke.py`` phase 4's:
the 3D dam break at 267,469 particles in a seeded perturbed state, the
kernel alone (CUDA events around 20 back-to-back launches, median of 5),
three times.  Prints one JSON line per run: the body, the three times, and
the ptxas registers of the main path's instance.  Needs one CUDA device;
imports no JAX.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "dualsphysics_multilayer_tpu_torch"
FT_LOAD = ("      if constexpr (FT) {\n"
           "        if (ft_c) mass2 = ftmass[j];\n"
           "      }\n")
RUNTIME_LOAD = "      if (ft_c && ftmass != nullptr) mass2 = ftmass[j];\n"


def runtime_test_copy() -> str:
    """A copy of this checkout's package and chip_smoke.py whose body tests
    for the floating mass in every instance; returns its directory."""
    dest = os.path.join(ROOT, PKG, "_build", "bodytime", "runtime-test")
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dest, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dest)
    body = os.path.join(dest, PKG, "csrc", "pairbody.cuh")
    with open(body) as f:
        text = f.read()
    if FT_LOAD not in text:
        raise RuntimeError("pairbody.cuh has no FT floating-mass block")
    with open(body, "w") as f:
        f.write(text.replace(FT_LOAD, RUNTIME_LOAD))
    return dest


def time_kernel1():
    """In a body's directory: kernel 1 alone on phase 4's case; prints the
    JSON line."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as CS
    from dualsphysics_multilayer_tpu_torch import SolverOpts, TpDensity
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.ops.cuda import build
    dev = torch.device("cuda", 0)
    case = cases.dambreak3d(dp=CS.DP_BENCH, obstacle=True, device=dev)
    pos, vel, rho, code = CS.perturbed_state(case, dev, case.csp.rhopzero)
    cells, args = CS.sorted_args(case.dom, pos, vel, rho, code)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    alone = [CS.compare_cellforce(case.csp, opts, case.dom, cells, args,
                                  reps=1)[1] for _ in range(3)]
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
    print(json.dumps(dict(dir=os.getcwd(), n=case.np_total, alone_ms=alone,
                          registers=registers)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        return time_kernel1()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: port_bodytime.py times kernel 1 on a GPU")
    dirs = {"committed": ROOT, "runtime-test": runtime_test_copy()}
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
