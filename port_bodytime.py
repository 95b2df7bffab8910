"""TPU kernels 1-3 and the default instances of the three NN kernels alone,
for this checkout and a parent, in turns, on one NVIDIA GPU:

    python3 port_bodytime.py [--parent DIR] [--rounds 2]

Each checkout (this one, ``committed``; the one at ``--parent``, with its
own package and ``chip_smoke.py``, ``parent``) runs in a process of its
own, committed, parent, parent, committed in each round.  The cases and
the timing are ``chip_smoke.py``'s.  Kernels 1-3 run on the 3D dam break at
267,469 particles (phase 4's case) in one seeded perturbed state, with a
seeded SPS stress: kernel 1 as on the main path (Wendland, artificial
viscosity, Fourtakas), kernel 2 with the cubic spline (phase 11's
instance), kernel 3 with laminar+SPS viscosity 1e-6 and NO_FIXED shifting
(phase 10's instance).  Each is timed alone (CUDA events around 20
back-to-back launches of its C launcher, median of 5) three times and with
its wrapper (median of 7); the sha256 of each of its output arrays (ace,
ar, per-target viscdt, and gradvel, shift and the shifting flags where the
instance writes them) is taken on these identical inputs, so equal hashes
across checkouts show bit-equal results.  Then phase 5's NN kernels
(nnforce_p1, nnforce_p3, nnforce_fda, Wendland without shifting) alone on
the 2D wet dam break at 37,143 particles.  Prints one JSON line per run:
the checkout, the kernels' times and hashes, and from ptxas' log the
registers, stack frame, spill stores and loads and shared memory of every
``cellforce_kernel`` instance and of the NN kernels' default instances.
Needs one CUDA device; imports no JAX.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def ptxas_table(log, keep):
    """{instance: {registers, stack, spill_stores, spill_loads, smem}} of
    the kernels of a library's ptxas log whose label ``keep`` accepts (the
    stack frame holds local arrays and spills, in bytes per thread)."""
    import chip_smoke as CS
    out, entry = {}, None
    with open(log) as f:
        for line in f:
            e = re.search(r"entry function '([^']+)'", line)
            if e:
                entry = CS.kernel_label(e.group(1))
                entry = entry if keep(entry) else None
                continue
            if entry is None:
                continue
            rec = out.setdefault(entry, {})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                rec["stack"], rec["spill_stores"], rec["spill_loads"] = map(
                    int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rec["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                rec["smem"] = int(m.group(1)) if m else 0
    return out


def time_cellforce(name, csp, opts, dom, cells, args, spstau):
    """One kernel of 1-3 on these inputs: its times alone and with its
    wrapper, and the sha256 of each output array."""
    import torch
    import chip_smoke as CS
    from dualsphysics_multilayer_tpu_torch.ops.cuda import cellforce as CF
    n = args[0].shape[0]
    fr = CF.interaction_forces_cuda(csp, opts, dom, cells, *args, spstau)
    outs = dict(ace=fr.ace, ar=fr.ar, viscdt=torch.empty_like(fr.ar),
                gradvel=fr.spsgradvel, shift=fr.shiftposfs,
                shiftblk=fr.shift_blocked)
    outs = {k: None if v is None else torch.empty_like(v)
            for k, v in outs.items()}
    pospress, velrho, kind = CF.channels(csp, *args)
    launch = CS.bare_launcher(
        "cellforce", f"dsph_{name}", CF.make_params(csp, opts, dom, n),
        [pospress, velrho, kind, cells.cell, cells.begin, spstau, None]
        + list(outs.values()))
    alone = [CS.launch_ms(launch) for _ in range(3)]
    wrapper = CS.cuda_ms(lambda: CF.interaction_forces_cuda(
        csp, opts, dom, cells, *args, spstau))
    CS.check(launch() == 0, f"{name} launch failed")
    torch.cuda.synchronize()
    sha = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16]
           for k, v in outs.items() if v is not None}
    return dict(alone_ms=alone, wrapper_ms=wrapper, sha256=sha)


def time_kernels():
    """In a checkout's directory: kernels 1-3 and the NN kernels, alone;
    prints the JSON line."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    import chip_smoke as CS
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpDensity,
                                                   TpKernel, TpShifting, TpVisco)
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    from dualsphysics_multilayer_tpu_torch.ops.cuda import build
    dev = torch.device("cuda", 0)
    case = cases.dambreak3d(dp=CS.DP_BENCH, obstacle=True, device=dev)
    pos, vel, rho, code = CS.perturbed_state(case, dev, case.csp.rhopzero)
    cells, args = CS.sorted_args(case.dom, pos, vel, rho, code)
    rng = np.random.default_rng(2)
    tau = torch.where(td.is_fluid(args[3])[:, None], torch.tensor(
        rng.normal(0.0, 1e-3, (pos.shape[0], 6)), dtype=torch.float32,
        device=dev), 0.0).contiguous()
    fourtakas = TpDensity.FOURTAKAS
    runs = {
        "cellforce": (case.csp, SolverOpts(tdensity=fourtakas), None),
        "cellforce_cubic": (case.csp.replace(tkernel=TpKernel.CUBIC),
                            SolverOpts(tdensity=fourtakas), None),
        "cellforce_lamsps": (CS.lamsps_csp(CS.DP_BENCH), SolverOpts(
            tvisco=TpVisco.LAMINAR_SPS, tdensity=fourtakas,
            shiftmode=TpShifting.NO_FIXED), tau)}
    kernels = {name: time_cellforce(name, csp, opts, case.dom, cells, args, sps)
               for name, (csp, opts, sps) in runs.items()}
    nncase, phases = NM.wet_dambreak_nn(dp=CS.NN_DP, device=dev)
    nn_ms = {k: r["ms"] for k, r in
             CS.nn_kernels_vs_plain(nncase, phases, dev, "").items()}
    ptxas = ptxas_table(build.library_path("cellforce") + ".log",
                        lambda e: e.startswith("cellforce_kernel"))
    ptxas.update(ptxas_table(build.library_path("nnforce") + ".log",
                             lambda e: e.endswith(("<2,0>", "<2>"))))
    print(json.dumps(dict(dir=os.getcwd(), n=case.np_total, kernels=kernels,
                          nn_ms=nn_ms, ptxas=ptxas)), flush=True)


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
        sys.exit("no CUDA device: port_bodytime.py times kernels on a GPU")
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
