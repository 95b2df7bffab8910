"""TPU kernels 1-3, every instance of NN kernels 4-6 and the window-load
probe (kernel 8) alone, for this checkout and a parent, in turns, on one
NVIDIA GPU:

    python3 port_bodytime.py [--parent DIR] [--variant DIR ...] [--rounds 2]
                             [--only nn|probe]

Each checkout (this one, ``committed``; the one at ``--parent``, with its
own package and ``chip_smoke.py``, ``parent``; each ``--variant``, named by
its directory) runs in a process of its own, in the order given and then
reversed in each round (committed, parent, parent, committed).  The cases and
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
across checkouts show bit-equal results (``--only nn`` skips kernels
1-3).  Then every instance of nnforce_p1 and nnforce_fda
(``<KER,SHIFT>``: Wendland or cubic, without shifting or with NO_FIXED; SPH
Morris and FDA Morris, Fourtakas) and of nnforce_p3 (Wendland or cubic, in
each viscous form: artificial, Morris, ConsEq, on a seeded eta and tau)
alone on phase 5's perturbed 2D wet dam break at bench.py's nnmud size
(37,143 particles) and at a third of its dp (330,781 particles), timed as
above three times, with the sha256 of the outputs from two launches on the
same inputs into separate buffers (zeroed for pass 3, which adds into
ace; equal: deterministic); then the window-load probe in its four modes
(aligned or not, from global or shared memory) at phase 18's 512 loads
over 64 windows, timed alike, with the sha256 of its output (``--only
probe``: the probe alone).  A variant to time (another
``GATHER_CHAIN_ROWS``, say) is a copy of the package and ``chip_smoke.py``
under ``_scratch/NAME`` with the constant edited, passed as ``--variant
_scratch/NAME``.  Prints one
JSON line per run: the checkout, the kernels' times and hashes, and from
ptxas' log the registers, stack frame, spill stores and loads and shared
memory of every ``cellforce_kernel``, every NN kernel instance and every
``probe_gather_kernel``.  Needs one CUDA device; imports no JAX.
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


def nn_outputs(name, shifting, n, dev):
    """Fresh output buffers of ``name``'s C launcher: ace, ar, viscdt and
    gradvel (p1) or etamax (FDA), then shift and shiftblk, or None."""
    import torch
    f32 = dict(dtype=torch.float32, device=dev)
    last = (n, 6) if name == "nnforce_p1" else (n,)
    outs = [torch.empty((n, 3), **f32), torch.empty(n, **f32),
            torch.empty(n, **f32), torch.empty(last, **f32)]
    if not shifting:
        return outs + [None, None]
    return outs + [torch.empty((n, 4), **f32),
                   torch.empty(n, dtype=torch.bool, device=dev)]


def time_nn(dev):
    """Every instance of nnforce_p1, nnforce_fda and nnforce_p3 alone at
    37,143 and 330,781 particles: {"<n> <instance>": {alone_ms, sha256,
    repeatable}}."""
    import numpy as np
    import torch
    import chip_smoke as CS
    from dualsphysics_multilayer_tpu_torch import TpKernel
    from dualsphysics_multilayer_tpu_torch.models import nnewtonian as NM
    from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
    from dualsphysics_multilayer_tpu_torch.ops.cuda import nnforce as NF
    out = {}
    for div in (1, 3):
        case, phases = NM.wet_dambreak_nn(dp=CS.NN_DP / div, device=dev)
        tb = phases.tables(case.csp, dev)
        rho0 = tb["rho0"][torch.clamp(case.state.code & 0xFFFF, 0,
                                      phases.count - 1).long()]
        pos, vel, rho, code = CS.perturbed_state(case, dev, rho0, sim2d=True)
        cells, (spos, svel, srho, scode) = CS.sorted_args(case.dom, pos, vel,
                                                          rho, code)
        ch = NN.channels(case.csp, phases, tb, srho, scode)
        n = spos.shape[0]
        rows = [torch.cat([spos, ch.press[:, None]], dim=1).contiguous(),
                torch.cat([svel, srho[:, None]], dim=1).contiguous(), ch.kind,
                ch.phase, cells.cell, cells.begin]
        # pass 3's eta and tau, seeded
        rng = np.random.default_rng(3)
        eta = torch.tensor(rng.uniform(0.05, 0.15, n), dtype=torch.float32,
                           device=dev)
        tau = torch.tensor(rng.normal(0.0, 1.0, (n, 6)), dtype=torch.float32,
                           device=dev)
        for ker in ("WENDLAND", "CUBIC"):
            csp = case.csp.replace(tkernel=TpKernel[ker])
            for name, velgrad in (("nnforce_p1", "SPH"), ("nnforce_fda", "FDA")):
                for shift in ("NONE", "NO_FIXED"):
                    opts = CS.nn_opts("LAMINAR_SPS", velgrad, shift)
                    params = NF.make_params(csp, opts, phases, case.dom, n)
                    sha = []
                    for _ in range(2):
                        outs = nn_outputs(name, shift != "NONE", n, dev)
                        launch = CS.bare_launcher("nnforce", f"dsph_{name}",
                                                  params, rows + outs)
                        CS.check(launch() == 0, f"{name} launch failed")
                        torch.cuda.synchronize()
                        sha.append(hashlib.sha256(b"".join(
                            o.cpu().numpy().tobytes() for o in outs
                            if o is not None)).hexdigest()[:16])
                    out[f"{n} {name}_kernel<{csp.tkernel.value},"
                        f"{int(shift != 'NONE')}>"] = dict(
                        alone_ms=[CS.launch_ms(launch) for _ in range(3)],
                        sha256=sha[0], repeatable=sha[0] == sha[1])
            # pass 3 in each viscous form, on the seeded eta and tau: adds
            # into ace, so each launch of the hashes starts from zeros
            for tvisco in ("ARTIFICIAL", "LAMINAR_SPS", "CONST_EQ"):
                opts = CS.nn_opts(tvisco, "SPH")
                params = NF.make_params(csp, opts, phases, case.dom, n)
                sha = []
                for _ in range(2):
                    ace = torch.zeros((n, 3), device=dev)
                    launch = CS.bare_launcher("nnforce", "dsph_nnforce_p3",
                                              params, rows + [eta, tau, ace])
                    CS.check(launch() == 0, "nnforce_p3 launch failed")
                    torch.cuda.synchronize()
                    sha.append(hashlib.sha256(
                        ace.cpu().numpy().tobytes()).hexdigest()[:16])
                out[f"{n} nnforce_p3 {csp.tkernel.value} {tvisco}"] = dict(
                    alone_ms=[CS.launch_ms(launch) for _ in range(3)],
                    sha256=sha[0], repeatable=sha[0] == sha[1])
    return out


def time_probe(dev):
    """The window-load probe alone in its four modes on phase 18's inputs
    (512 loads, 64 windows): {mode: {alone_ms, sha256}}."""
    import torch
    import chip_smoke as CS
    from dualsphysics_multilayer_tpu_torch.tools import probes as PR
    buf, offs = PR.gather_inputs(PR.NITER, dev)
    out = {}
    for staged in (False, True):
        for aligned in (True, False):
            res = torch.empty((PR.GROUPS, PR.ROWS, PR.LANES), device=dev)
            launch = CS.bare_launcher(
                "probes", "dsph_probe_gather",
                PR.GatherParams(niter=PR.NITER, aligned=int(aligned),
                                staged=int(staged), groups=PR.GROUPS),
                [buf, offs, res])
            CS.check(launch() == 0, "probe_gather launch failed")
            torch.cuda.synchronize()
            out[f"aligned={int(aligned)} staged={int(staged)}"] = dict(
                alone_ms=[CS.launch_ms(launch) for _ in range(3)],
                sha256=hashlib.sha256(
                    res.cpu().numpy().tobytes()).hexdigest()[:16])
    return out


def time_kernels(only):
    """In a checkout's directory, alone: kernels 1-3 (``only`` "all"),
    every instance of NN kernels 4-6 ("all", "nn"), the window-load probe
    ("all", "nn", "probe"); prints the JSON line."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    import chip_smoke as CS
    from dualsphysics_multilayer_tpu_torch import (SolverOpts, TpDensity,
                                                   TpKernel, TpShifting, TpVisco)
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases
    from dualsphysics_multilayer_tpu_torch.ops.cuda import build
    dev = torch.device("cuda", 0)
    kernels, ptxas, nn = {}, {}, {}
    if only == "all":
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
        kernels = {name: time_cellforce(name, csp, opts, case.dom, cells, args,
                                        sps)
                   for name, (csp, opts, sps) in runs.items()}
        ptxas = ptxas_table(build.library_path("cellforce") + ".log",
                            lambda e: e.startswith("cellforce_kernel"))
    if only in ("all", "nn"):
        nn = time_nn(dev)
    probe = time_probe(dev)
    ptxas.update(ptxas_table(build.library_path("nnforce") + ".log",
                             lambda e: e.startswith("nnforce")))
    ptxas.update(ptxas_table(build.library_path("probes") + ".log",
                             lambda e: e.startswith("probe_gather")))
    print(json.dumps(dict(dir=os.getcwd(), kernels=kernels, nn=nn,
                          probe_gather=probe, ptxas=ptxas)),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("all", "nn", "probe"),
                    default="all")
    ap.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        return time_kernels(args.only)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: port_bodytime.py times kernels on a GPU")
    dirs = {"committed": ROOT}
    if args.parent:
        dirs["parent"] = os.path.abspath(args.parent)
    for d in args.variant:
        dirs[os.path.basename(os.path.normpath(d))] = os.path.abspath(d)
    order = list(dirs)
    for _ in range(args.rounds):
        for body in order + order[::-1]:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--time", "--only", args.only], cwd=dirs[body],
                               capture_output=True, text=True)
            line = (r.stdout.strip().splitlines() or ["{}"])[-1]
            out = dict(body=body, **json.loads(line)) if r.returncode == 0 \
                else dict(body=body, failed=r.stderr[-1500:])
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
