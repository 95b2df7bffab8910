"""Command-line entry point of the torch port.

Counterpart of `dualsphysics_multilayer_tpu/cli.py` (the reference's
`main.cpp` + `JSphCfgRun`, flag surface `JSphCfgRun.cpp:85-208`): loads a
case XML (``io/xmlcase.py``) or builds a builtin case, merges the
command-line overrides over the case's settings, optionally restarts from a
PART, runs the solver on the card (or on the CPU with ``-cpu``, through the
kernels' plain versions) and writes bi4/VTK/CSV output and the run resume.
A case with ``<special><nnphases>`` runs the multiphase non-Newtonian step
(``models/nnewtonian.make_nn_step``); a case with ``<special><inout>`` and
``-builtin channel2d`` run their inlet/outlet zones (``features/inout.py``;
the JAX CLI builds no ``Features`` for ``channel2d`` and runs its zone
particles as inert fluid), and refuse a restart, as the reference does.
``-initnorpla``/``-initnorpart`` give the walls normals
(``features/initialize.py``) after any restart and make the run an mDBC
run, as the JAX CLI does.  A case's floating-body couplings (DEM, Chrono
links and mesh contact, moorings) run through its ``Features``; a restart
of a Chrono case needs ``-restartchrono``, as the reference's does, and a
restart of a moored case starts its lines from their relaxed state at the
restored bodies.  ``-shard[:N]`` splits the run into N x-slabs, one rank
per card (``parallel/sharding.py``; ``-shard`` alone: every card), on
NCCL; more ranks than cards leave with a message; with ``-cpu`` the N
ranks run on the CPU over gloo.  PARTs are saved from rank 0 after a
gather ordered by id.

    python -m dualsphysics_multilayer_tpu_torch.cli -case Dambreak_Def.xml \\
        -dirout out
    python -m dualsphysics_multilayer_tpu_torch.cli -builtin dambreak3d \\
        -dp 0.01 -tmax:1.6 -tout:0.02 -dirout out
    dsphtorch -cpu -builtin dambreak2d -dp 0.05 -tmax:0.01 -tout:0.005
    dsphtorch -builtin dambreak3d -partbegin:20 out_prev -dirout out2
    dsphtorch -builtin channel2d -dp 0.0014 -tmax:0.008 -dirout out
    dsphtorch -builtin coastal_runup3d -dp 0.04 -tmax:0.01 -dirout out
    dsphtorch -builtin dambreak3d -shard:2 -dirout out
    dsphtorch -cpu -builtin dambreak2d -dp 0.05 -shard:2 -tmax:0.01
    dsphtorch -cpu -builtin channel2d -dp 0.02 -shard:2 -tmax:0.01

Reference colon-form flags (-tmax:1.6, -partbegin:20 dir, -svpips:2) are
accepted alongside space-separated values, and ``-opt FILE`` reads more
options from a file.  ``-pallas``/``-no-pallas``, the JAX package's choice
between its two implementations of the same physics, run the port's one
path (:data:`PALLAS_NOTE`).  Options whose setting the port does not run
leave with a message that names them: ``-cellmode:half``, as in the JAX
CLI; so do the XML nodes the loader refuses, the options the NN step
refuses and the features ``-shard`` refuses (x-periodic boundaries and
the wave paddles' AWAS; it runs inlet/outlet zones, DEM contact and y/z-
periodic boundaries).  ``-cpu -shard`` without a count runs one rank, as
the JAX CLI's ``-shard`` runs over the one device of its CPU backend.  A
``DsphConfig.xml`` at $DSPHCONFIG, in the cwd or beside the package gives
the defaults of ``-createdirs`` and ``-csvsep`` (:func:`load_dsphconfig`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from . import __version__ as VERSION

# flags that take a value and may appear in the reference's colon form
_COLON_FLAGS = {
    "gpu",
    "tmax", "tout", "cfl", "dp", "ddt", "ddtvalue", "shifting", "verlet",
    "rhopout", "svpips", "ftpause", "domain_fixed", "cellmode",
    "mdbc_threshold", "csvsep", "createdirs", "nsteps", "partbegin",
    "viscoart", "viscolamsps", "viscoboundfactor", "sv", "ompthreads",
    "savedt", "initnorpla", "initnorpart", "ddtramp", "svextraparts",
    "saveposdouble", "shard",
}
# flags that are boolean but may carry :0/:1
_BOOL_FLAGS = {"svres", "svtimers", "svdomainvtk", "svsteps", "nortimes",
               "createdirs", "svnormals", "cellfixed", "restartchrono",
               "mdbc_fast", "stable"}

BUILTINS = ("dambreak2d", "dambreak3d", "floatingbox2d", "waveflume2d",
            "channel2d", "coastal_runup3d")
# -pallas/-no-pallas pick the JAX package's Pallas kernels or its XLA
# bucket path, the same physics; the port has one path
PALLAS_NOTE = ("-pallas/-no-pallas: the port has one path, the hand-written "
               "CUDA kernels on the card (their plain versions with -cpu); "
               "the option changes nothing")


def _normalize(argv):
    """Expand -opt response files and split reference colon-form flags."""
    out = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a == "-opt":
            i += 1
            with open(argv[i]) as f:
                argv[i + 1:i + 1] = f.read().split()
        elif a.startswith("-") and ":" in a[1:]:
            name, val = a[1:].split(":", 1)
            if name in _COLON_FLAGS:
                # "=" form so values starting with "-" (negative domain
                # coordinates) are not mistaken for options by argparse
                out.append(f"-{name}={val}")
            elif name in _BOOL_FLAGS:
                out.extend([f"-{name}"] if val not in ("0", "false")
                           else [])
            else:
                out.append(a)
        else:
            out.append(a)
        i += 1
    return out


def build_parser():
    p = argparse.ArgumentParser(
        prog="dsphtorch",
        description="SPH solver on PyTorch with hand-written CUDA kernels "
                    "(the torch port of dualsphysics_multilayer_tpu)")
    p.add_argument("-cpu", action="store_true",
                   help="run on the CPU through the kernels' plain versions "
                        "(reference -cpu, JSphCfgRun.cpp:93)")
    p.add_argument("-gpu", nargs="?", const="0", default=None,
                   help="run on CUDA device [:id] (the default: device 0)")
    p.add_argument("-case", help="DualSPHysics case XML (*_Def.xml)")
    p.add_argument("-builtin", help="built-in case: " + " ".join(BUILTINS))
    p.add_argument("-dp", type=float, default=0.0, help="override dp (builtin)")
    p.add_argument("-name", default=None, help="case name override")
    p.add_argument("-runname", default=None, help="run name (Run.csv)")
    p.add_argument("-dirout", default="out", help="output directory")
    p.add_argument("-dirdataout", default="",
                   help="subdirectory for PART data (empty = directly in "
                        "dirout)")
    p.add_argument("-tmax", type=float, default=None)
    p.add_argument("-tout", type=float, default=None)
    p.add_argument("-symplectic", action="store_true")
    p.add_argument("-verlet", type=int, nargs="?", const=40, default=None,
                   metavar="STEPS")
    p.add_argument("-wendland", action="store_true")
    p.add_argument("-cubic", action="store_true")
    p.add_argument("-viscoart", type=float, default=None, metavar="V")
    p.add_argument("-viscolamsps", type=float, default=None, metavar="V")
    p.add_argument("-viscoboundfactor", type=float, default=None)
    p.add_argument("-ddt", type=int, default=None, choices=[0, 1, 2, 3])
    p.add_argument("-ddtvalue", type=float, default=None)
    p.add_argument("-ddtramp", default=None, metavar="TRAMP:TMAX:MAXVALUE",
                   help="initial DDT ramp: total ramp time, time at "
                        "maxvalue, maxvalue (reference -ddtramp, "
                        "RunInitialDDTRamp JSphCpuSingle.cpp:650)")
    p.add_argument("-shifting", type=int, default=None, choices=[0, 1, 2, 3])
    p.add_argument("-dbc", action="store_true", help="force classic DBC")
    p.add_argument("-mdbc", action="store_true")
    p.add_argument("-mdbc_noslip", action="store_true")
    p.add_argument("-mdbc_freeslip", action="store_true")
    p.add_argument("-mdbc_fast", action="store_true",
                   help="accepted for compatibility (the pre-pass solves "
                        "in single precision)")
    p.add_argument("-mdbc_threshold", type=float, default=None)
    p.add_argument("-cfl", type=float, default=None)
    p.add_argument("-ftpause", type=float, default=None)
    p.add_argument("-rhopout", default=None, metavar="MIN:MAX")
    p.add_argument("-domain_fixed", default=None,
                   metavar="XMIN:YMIN:ZMIN:XMAX:YMAX:ZMAX",
                   help="fix the simulation domain limits")
    p.add_argument("-cellmode", default=None, choices=["full", "half"],
                   help="cell size 2h (full); half is refused")
    p.add_argument("-cellfixed", action="store_true",
                   help="accepted for compatibility: the cell grid is "
                        "always fixed")
    p.add_argument("-stable", action="store_true",
                   help="accepted for compatibility: the kernels sum in a "
                        "fixed order, with no atomics")
    p.add_argument("-ompthreads", type=int, default=None,
                   help="accepted for compatibility (host thread count)")
    p.add_argument("-sv", default="binx",
                   help="output formats: binx,info,vtk,csv,none (comma list)")
    p.add_argument("-svres", action="store_true", default=True,
                   help="write Run.csv summary (default on)")
    p.add_argument("-no-svres", dest="svres", action="store_false")
    p.add_argument("-svtimers", action="store_true",
                   help="write per-interval timing CSV (Timers.csv)")
    p.add_argument("-shard", type=int, nargs="?", const=0, default=None,
                   metavar="N",
                   help="domain decomposition into N x-slabs, one rank "
                        "per card (default: every card; with -cpu N ranks "
                        "on the CPU)")
    p.add_argument("-svpips", type=int, nargs="?", const=1, default=None,
                   metavar="MODE", help="compute the PIPS throughput metric")
    p.add_argument("-svdomainvtk", action="store_true",
                   help="write the domain box as VTK")
    p.add_argument("-svnormals", action="store_true",
                   help="save per-PART boundary-normal VTK "
                        "(SaveVtkNormals, JSphCpuSingle.cpp:1177)")
    p.add_argument("-saveposdouble", type=int, nargs="?", const=1, default=1,
                   metavar="0/1",
                   help="PART position precision: 1=double (default here; "
                        "restart-exact), 0=float (the reference default)")
    p.add_argument("-svextraparts", default="", metavar="N|LIST",
                   help="PART cadence for extra data (mDBC normals): "
                        "interval N or a range list '2,10-20' "
                        "(JDsExtraDataSave::Config)")
    p.add_argument("-svsteps", action="store_true",
                   help="debug: save a PART after every step")
    p.add_argument("-nortimes", action="store_true",
                   help="strip wall-clock times from bi4 (byte-diffable "
                        "outputs, reference -nortimes)")
    p.add_argument("-savedt", type=int, nargs="?", const=4096, default=None,
                   metavar="CAP", help="record per-dt diagnostics (SaveDt.csv)")
    p.add_argument("-createdirs", type=int, default=1,
                   help="accepted for compatibility: directories are "
                        "always created")
    p.add_argument("-csvsep", type=int, default=0,
                   help="CSV separator: 0=semicolon 1=comma")
    p.add_argument("-partbegin", default=None, metavar="N[:FIRST]",
                   help="restart from PART N (directory: -restartdir or "
                        "the next positional token)")
    p.add_argument("-restartdir", default=None,
                   help="directory holding the restart PART files")
    p.add_argument("-restartchrono", action="store_true",
                   help="allow a restart of a case with Chrono links")
    p.add_argument("-nsteps", type=int, default=None,
                   help="debug: stop at the first save after N steps")
    p.add_argument("-pallas", action="store_true", default=None,
                   help="the JAX package's Pallas switch (one path here)")
    p.add_argument("-no-pallas", dest="pallas", action="store_false")
    p.add_argument("-initnorpla", action="append", default=[],
                   help="mDBC wall normals from a plane: mkbound=LIST:"
                        "normal=x:y:z[:point=x:y:z|point=auto][:maxdisth=H]"
                        "[:limitdist=D] (JSphCfgRun.cpp:162)")
    p.add_argument("-initnorpart", action="append", default=[],
                   help="mDBC wall normals from the particles: "
                        "mkbound=LIST[:maxdisth=H] (JSphCfgRun.cpp:166)")
    p.add_argument("-ver", action="store_true", help="print version and exit")
    p.add_argument("-info", action="store_true",
                   help="print features/hardware JSON and exit")
    p.add_argument("rest", nargs="*", help=argparse.SUPPRESS)
    return p


def refuse(args):
    """Leave with a message naming the first option whose setting the port
    does not run."""
    if args.case and not os.path.isfile(args.case):
        raise SystemExit(f"-case {args.case}: no such file")
    if args.builtin is not None and args.builtin not in BUILTINS:
        raise SystemExit(f"-builtin {args.builtin}: unknown case (the port "
                         f"builds {', '.join(BUILTINS)})")
    if args.shard is not None and args.shard < 0:
        raise SystemExit(f"-shard:{args.shard}: give a rank count >= 1")
    if args.cellmode == "half":
        raise SystemExit(
            "-cellmode:half is not supported: the port's cells are the "
            "kernel size plus a rebuild skin wide, and its kernels walk 3 "
            "cells per axis; use -cellmode:full")


def _features():
    return ["wcsph", "dbc", "mdbc", "verlet", "symplectic", "wendland",
            "cubic", "ddt", "ddtramp", "shifting", "laminar+sps", "floating",
            "motion", "damping", "accinput", "gauges", "viscotime", "bi4",
            "vtk", "csv", "restart", "savedt", "xmlcase", "nnphases",
            "symmetry", "initialize", "initnorpla", "initnorpart",
            "nn-mdbc", "inout", "periodic", "dem", "moorings",
            "forcepoints", "chrono", "chcontact", "shard", "cuda"]


def _info(torch):
    cuda = torch.cuda.is_available()
    return {
        "name": "dualsphysics_multilayer_tpu_torch", "version": VERSION,
        "features": {
            "solvers": ["wcsph", "nnewtonian-multiphase"],
            "kernels": ["wendland", "cubic"],
            "steps": ["symplectic", "verlet"],
            "viscosity": ["artificial", "laminar+sps", "consteq-hbp",
                          "time-table"],
            "ddt": ["none", "molteni", "fourtakas", "fourtakas-full",
                    "initial-ramp"],
            "boundary": ["dbc", "mdbc(vel0,noslip,freeslip)",
                         "symmetry(y=0)", "inout", "periodic(library)"],
            "initialize": ["fluidvelocity", "boundnormal_set",
                           "boundnormal_plane", "boundnormal_sphere",
                           "boundnormal_cylinder", "boundnormal_parts",
                           "-initnorpla", "-initnorpart"],
            "bodies": ["floating-6dof", "dem(RigidAlgorithm=2)",
                       "moorings(moordyn)", "forcepoints(library)",
                       "chrono-links", "chrono-mesh-contact"],
            "waves": ["piston", "flap", "irregular", "solitary", "focused",
                      "relaxation-zones", "multilayer-piston", "awas"],
            "io": ["bi4", "vtk", "csv", "restart", "savedt", "fbi4", "obi4",
                   "parthead", "run-csv", "case-xml", "moorings-vtk-csv"],
            "builtin": list(BUILTINS),
        },
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": ([torch.cuda.get_device_name(k)
                     for k in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
    }


def _launches():
    """The CUDA kernels' launches in this process, as JSON (those that
    ran; ``{}`` on the CPU, where their plain versions run)."""
    from .ops.cuda import cellforce, nnforce
    return json.dumps({k: v for d in (cellforce.launches, nnforce.launches)
                       for k, v in d.items() if v})


def _device(args, torch):
    if args.cpu:
        return torch.device("cpu")
    return torch.device("cuda", int(args.gpu or 0))


def _build_case(args, device):
    """(case, opts, run values): the case XML through ``io.xmlcase``, or
    the builtin case (Fourtakas DDT, tmax 1, tout 0.05), with the state the
    options need: the M1 state under -verlet (the initial velocity and
    density; a restart takes them from its PART) and a zero SPS stress
    under -viscolamsps, as the XML loader builds them, and the walls'
    normals under -mdbc for dambreak2d (the JAX CLI's rule).  channel2d's
    spare slots cover its inflow up to the run's tmax (the JAX CLI's
    builder sizes them for 2 s).  The other builtins take their builder's
    defaults but dp, as in the JAX CLI: ``coastal_runup3d`` is still water
    (``wave_height=0``)."""
    import torch
    from .models import cases as C
    from .ops.forces import SolverOpts
    from .typesdef import TpDensity
    if args.case:
        from .io.xmlcase import load_case
        case, opts, run = load_case(args.case, mdbc=args.mdbc, device=device)
    else:
        kw = dict(device=device)
        if args.dp:
            kw["dp"] = args.dp
        if args.builtin == "dambreak2d" and args.mdbc:
            kw["mdbc"] = True
        if args.builtin == "channel2d":
            kw["t_horizon"] = args.tmax if args.tmax is not None else 1.0
        case = getattr(C, args.builtin)(**kw)
        opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
        run = dict(tmax=1.0, tout=0.05)
    st = case.state
    if args.verlet is not None and st.velm1 is None:
        st = dataclasses.replace(st, velm1=st.vel.clone(),
                                 rhom1=st.rho.clone())
    if args.viscolamsps is not None and st.spstau is None:
        st = dataclasses.replace(st, spstau=torch.zeros(
            (st.n, 6), dtype=torch.float32, device=st.pos.device))
    return dataclasses.replace(case, state=st), opts, run


def _overrides(args, csp, opts):
    """(csp, opts) with the command line's settings (JSph::
    LoadConfigCommands analog)."""
    from .typesdef import (TpBoundary, TpDensity, TpKernel, TpShifting,
                           TpSlipMode, TpStep, TpVisco)
    oc = {}
    if args.verlet is not None:
        oc.update(tstep=TpStep.VERLET, verlet_steps=args.verlet)
    if args.symplectic:
        oc.update(tstep=TpStep.SYMPLECTIC)
    if args.viscoart is not None:
        oc.update(tvisco=TpVisco.ARTIFICIAL)
        csp = csp.replace(visco=args.viscoart)
    if args.viscolamsps is not None:
        # the Smagorinsky/Blin constants of make_ctesph(tvisco=LAMINAR_SPS)
        oc.update(tvisco=TpVisco.LAMINAR_SPS)
        dim = 2 if csp.simulate2d else 3
        dp_sps = (csp.dp * csp.dp * dim) ** 0.5 / dim
        csp = csp.replace(visco=args.viscolamsps,
                          spssmag=(0.12 * dp_sps) ** 2,
                          spsblin=(2.0 / 3.0) * 0.0066 * dp_sps * dp_sps)
    if args.ddt is not None:
        oc.update(tdensity=TpDensity(args.ddt))
    if args.shifting is not None:
        oc.update(shiftmode=TpShifting(args.shifting))
    if args.dbc:
        oc.update(tboundary=TpBoundary.DBC)
    if args.mdbc or args.mdbc_noslip or args.mdbc_freeslip:
        slip = (TpSlipMode.NO_SLIP if args.mdbc_noslip
                else TpSlipMode.FREE_SLIP if args.mdbc_freeslip
                else TpSlipMode.VEL0)
        oc.update(tboundary=TpBoundary.MDBC, slipmode=slip)
    if args.mdbc_threshold is not None:
        oc.update(mdbc_threshold=args.mdbc_threshold)
    if args.savedt is not None:
        oc.update(savedt=args.savedt)
    opts = dataclasses.replace(opts, **oc)
    if args.wendland:
        csp = csp.replace(tkernel=TpKernel.WENDLAND)
    if args.cubic:
        csp = csp.replace(tkernel=TpKernel.CUBIC)
    if args.viscoboundfactor is not None:
        csp = csp.replace(viscoboundfactor=args.viscoboundfactor)
    if args.cfl is not None:
        csp = csp.replace(cflnumber=args.cfl)
    if args.rhopout:
        lo, hi = args.rhopout.split(":")
        csp = csp.replace(rhopoutmin=float(lo), rhopoutmax=float(hi))
    if args.ddtvalue is not None:
        csp = csp.replace(ddtvalue=args.ddtvalue,
                          ddtkh=csp.kernelsize * args.ddtvalue)
    if args.ddtramp:
        # -ddtramp:tramp:tmax:maxvalue (validation per JSphCfgRun.cpp:349-353)
        v = [float(x) for x in args.ddtramp.split(":")]
        tramp, tmaxv, vmax = (v + [0.0, 0.0, 0.0])[:3]
        if tramp > 0 and vmax > 0:
            opts = dataclasses.replace(
                opts, ddtramp=(tramp, min(tmaxv, tramp), vmax))
    return csp, opts


def _domain(args, dom):
    if not args.domain_fixed:
        return dom
    # -domain_fixed:xmin:ymin:zmin:xmax:ymax:zmax (JSphCfgRun.cpp:176): the
    # cell grid over the fixed box, with the case grid's cell size
    from .ops import celldiv as cd
    f = [float(x) for x in args.domain_fixed.split(":")]
    if len(f) != 6 or any(f[i + 3] <= f[i] for i in range(3)):
        raise SystemExit("-domain_fixed needs xmin:ymin:zmin:xmax:ymax:"
                         "zmax with max > min on every axis")
    return cd.make_domain(tuple(f[:3]), tuple(f[3:6]), dom.scell,
                          simulate2d=dom.simulate2d)


def _write_domain_vtk(dirout, dom):
    import numpy as np
    from .io import vtkout
    lo, hi = np.asarray(dom.posmin), np.asarray(dom.posmax)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]],
                       np.float32)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
             (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
    vtkout.write_vtk_mesh(os.path.join(dirout, "Domain.vtk"), corners,
                          lines=[np.array(e) for e in edges])


def _log_config(dirout, case, csp, opts, dom, tmax):
    """The resolved configuration (JSph::VisuConfig, JSph.cpp:1463-1614)
    into Run.out."""
    from .utils.log import RunLog
    rlog = RunLog(dirout, echo=False)
    rlog.print("[VisuConfig] resolved run configuration:")
    for k in ("dp", "kernelh", "kernelsize", "cs0", "cteb", "gamma",
              "rhopzero", "massfluid", "massbound", "visco",
              "viscoboundfactor", "cflnumber", "dtini", "dtmin",
              "ddtvalue", "ddtkh", "eta2", "gravity", "simulate2d",
              "rhopoutmin", "rhopoutmax", "shiftcoef", "shifttfs"):
        rlog.print(f"  {k}={getattr(csp, k, None)}")
    for k in ("tstep", "tvisco", "tdensity", "tboundary", "slipmode",
              "shiftmode", "symmetry", "with_floating", "verlet_steps",
              "savedt", "ddtramp"):
        rlog.print(f"  {k}={getattr(opts, k, None)}")
    rlog.print(f"  np={case.np_total} npb={case.npb} tmax={tmax:g} "
               f"domain={dom.posmin}..{dom.posmax} cells={dom.nc}")
    return rlog


def _sharded(args, torch, csp, opts, dom, st, feats, phases, t0, device):
    """The ``-shard[:N]`` run (without N every card, or with ``-cpu`` one
    rank), leaving with the message of a feature or a rank count it
    refuses."""
    from .parallel.sharding import ShardedSimulation
    try:
        return ShardedSimulation(csp, opts, dom, st, feats=feats,
                                 ndev=args.shard, phases=phases, t0=t0,
                                 device=device.type)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(f"-shard: {e}") from None


def load_dsphconfig(paths=None):
    """The machine's DsphConfig.xml defaults (the reference's JDsphConfig,
    which reads it beside the binary; JAX `cli.py:192-215`): the first file
    of ``paths``, or of $DSPHCONFIG, ``DsphConfig.xml`` in the cwd and
    beside this package.  Returns ``createdirs`` and ``csvsep`` from
    ``<common><createdirs v>`` and ``<csvseparator v>``, {} without a
    file."""
    import xml.etree.ElementTree as ET
    cand = paths or [
        os.environ.get("DSPHCONFIG", ""),
        os.path.join(os.getcwd(), "DsphConfig.xml"),
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "DsphConfig.xml"),
    ]
    for p in cand:
        if p and os.path.isfile(p):
            com = ET.parse(p).getroot().find("common")
            out = {}
            if com is not None:
                for tag, key in (("createdirs", "createdirs"),
                                 ("csvseparator", "csvsep")):
                    el = com.find(tag)
                    if el is not None and el.get("v") is not None:
                        out[key] = int(float(el.get("v")))
            return out
    return {}


def main(argv=None):
    argv = _normalize(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    # the machine's defaults; flags given still win
    parser.set_defaults(**load_dsphconfig())
    args = parser.parse_args(argv)
    if args.ver:
        print(json.dumps({"name": "dualsphysics_multilayer_tpu_torch",
                          "version": VERSION, "features": _features()}))
        return 0
    import torch
    if args.info:
        print(json.dumps(_info(torch), indent=1))
        return 0
    refuse(args)
    if args.pallas is not None:
        print(f"[dsphtorch] {PALLAS_NOTE}")
    if not args.case and not args.builtin:
        print("error: give -case <xml> or -builtin <name>", file=sys.stderr)
        return 2

    from .features.featureset import Features
    from .io.output import OutputManager, OutputTime, restart_state
    from .io.partdata import part_filename
    from .models.wcsph import Simulation
    from .typesdef import TpBoundary
    from .utils.runinfo import TerminateCheck, save_res
    from .utils.timers import Timers

    device = _device(args, torch)
    try:
        case, opts, run = _build_case(args, device)
    except NotImplementedError as e:
        # an XML node of a feature the port does not run
        raise SystemExit(f"-case {args.case}: {e}") from None
    csp, opts = _overrides(args, case.csp, opts)
    dom = _domain(args, case.dom)
    tmax = args.tmax if args.tmax is not None else run["tmax"]
    tout = args.tout if args.tout is not None else run["tout"]
    if args.tout is None and run.get("tout_table") is not None:
        # <special><timeout> (JDsOutputTime)
        tout = OutputTime(run["tout_table"])

    st = case.state
    t0 = 0.0
    part0 = 0
    feats = case.meta.get("features")
    if feats is None and "inout" in case.meta:
        # channel2d runs its zones
        feats = Features(inout=case.meta["inout"])
    if args.partbegin is not None:
        if feats is not None and feats.inout is not None:
            # the reference's restriction (JSphCpuSingle_InOut.cpp:76)
            source = (f"-case {args.case}" if args.case
                      else f"-builtin {args.builtin}")
            raise SystemExit(f"{source}: Restart with inlet/outlet "
                             f"conditions is not allowed.")
        if feats is not None and feats.chrono is not None \
                and not args.restartchrono:
            # the reference's -restartchrono gate (JSph RestartCheckData;
            # JAX cli.py:400-405)
            raise SystemExit("Restart with active Chrono coupling needs "
                             "-restartchrono:1 (contact state is not saved "
                             "in the PART files).")
        part0 = int(str(args.partbegin).split(":")[0])
        pdir = args.restartdir or (args.rest[0] if args.rest else args.dirout)
        path = os.path.join(pdir, part_filename(part0))
        st, t0, _ = restart_state(path, st)
        print(f"restart from {path} at t={t0:.6f}")
    if args.initnorpla or args.initnorpart:
        # wall normals from the command line, after a restart and before
        # the run, with mDBC walls (the JAX CLI's rule, cli.py:413-421)
        from .features.initialize import apply_initialize, parse_initnor_cli
        ops = [op for spec in args.initnorpla
               for op in parse_initnor_cli(spec, kind="plane")]
        ops += [op for spec in args.initnorpart
                for op in parse_initnor_cli(spec, kind="parts")]
        st = apply_initialize(ops, csp, st)
        opts = dataclasses.replace(opts, tboundary=TpBoundary.MDBC)

    if feats is None and ("ftcfg" in case.meta or "motion" in case.meta):
        feats = Features(
            motions=(case.meta["motion"],) if "motion" in case.meta else (),
            floating=case.meta.get("ftcfg"))
    if feats is not None and feats.floating is not None:
        if args.ftpause is not None:
            feats = dataclasses.replace(
                feats, floating=dataclasses.replace(
                    feats.floating, ftpause=args.ftpause))
        opts = dataclasses.replace(opts, with_floating=True)

    # a restart goes on with the time (so the DDT ramp, the viscosity table
    # and the motions too) and the PART numbers of the run it continues, as
    # the reference's -partbegin does (the JAX CLI starts again at PART 0
    # and its step clock at 0)
    step = None
    phases = case.meta.get("phases")
    if phases is not None:
        # a multiphase NN case (<special><nnphases>): the NN step, which
        # refuses what it does not run (forces_nn.check_supported_nn) and
        # every feature of the case, naming its XML node
        from .models.nnewtonian import MDBC_NOTE, make_nn_step
        try:
            step = make_nn_step(csp, opts, dom, phases, feats)
        except (NotImplementedError, ValueError) as e:
            raise SystemExit(f"-case {args.case}: {e}") from None
        if opts.tboundary == TpBoundary.MDBC:
            print(f"[dsphtorch] {MDBC_NOTE}")
    if args.shard is not None:
        sim = _sharded(args, torch, csp, opts, dom, st, feats, phases, t0,
                       device)
    else:
        sim = Simulation(csp, opts, dom, st, feats=feats, step=step, t0=t0)
    sim.part = part0
    sim.errdir = args.dirout
    pom = run.get("partsoutmax")
    if pom is not None and pom < 1.0:
        sim.partsoutmax = pom
    gsys = None
    if case.meta.get("gauges"):
        # <special><gauges>, written to Gauge_*.csv at each save; a gauge's
        # <computedt> ticks inside the save interval (JDsGaugeSystem.cpp:447)
        from .features.gauges import GaugeSystem
        gsys = GaugeSystem(csp, dom, case.meta["gauges"],
                           windows=case.meta.get("gauge_windows"),
                           computedts=case.meta.get("gauge_computedts"))
    sv = set(args.sv.split(","))
    datadir = os.path.join(args.dirout, args.dirdataout) \
        if args.dirdataout else args.dirout
    sep = ";" if args.csvsep == 0 else ","
    on_save = None
    if sv - {"none"}:
        on_save = OutputManager(datadir, case, save_vtk="vtk" in sv,
                                save_info="info" in sv, feats=feats,
                                casename=args.name, nortimes=args.nortimes,
                                posdouble=bool(args.saveposdouble),
                                extraparts=args.svextraparts,
                                svnormals=args.svnormals, gauges=gsys,
                                save_csv="csv" in sv, csvsep=sep)
        if run.get("ftmotion_tout") is not None:
            on_save.ftmotion_tout = run["ftmotion_tout"]
    os.makedirs(args.dirout, exist_ok=True)
    if args.svdomainvtk and on_save is not None:
        _write_domain_vtk(args.dirout, dom)
    terminate = TerminateCheck(args.dirout) if on_save is not None else None

    print(f"[dsphtorch] case={case.meta.get('name')} np={case.np_total} "
          f"dp={csp.dp:g} h={csp.kernelh:g} cs0={csp.cs0:g} "
          f"device={device}")
    rlog = _log_config(args.dirout, case, csp, opts, dom, tmax)
    timers = Timers()
    timers_rows = [] if args.svtimers else None
    if timers_rows is not None:
        inner = on_save
        last = [0]
        timers.start("Interval")

        def on_save_timed(s):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = timers.stop("Interval")
            timers_rows.append([s.part, f"{s.time:.6f}",
                                s.carry.nstep - last[0], f"{dt:.4f}"])
            last[0] = s.carry.nstep
            if inner:
                timers.start("Save")
                inner(s)
                timers.stop("Save")
            timers.start("Interval")

        on_save = on_save_timed
    next_subtick = on_subtick = None
    if gsys is not None and gsys.computedts:
        next_subtick = gsys.next_time

        def on_subtick(s, t_abs):
            cells = None if s.carry.rebuild else s.carry.cells
            gsys.run(t_abs, s.state, cells, at_save=False)

    timers.start("Run")
    sim.run(tmax=tmax, tout=tout, on_save=on_save, max_steps=args.nsteps,
            terminate=terminate, every_step=args.svsteps,
            next_subtick=next_subtick, on_subtick=on_subtick)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = timers.stop("Run")
    nstep = sim.carry.nstep
    psps = case.np_total * nstep / max(wall, 1e-9)
    print(f"[dsphtorch] done: t={sim.time:.6g} steps={nstep} "
          f"wall={wall:.3f}s ({psps:.3g} particle-steps/s) parts={sim.part} "
          f"dtmodif={int(sim.carry.dtmodif)} launches={_launches()}")
    if timers_rows:
        with open(os.path.join(args.dirout, "Timers.csv"), "w") as f:
            f.write(sep.join(["Part", "Time", "Steps", "WallSeconds"]) + "\n")
            for r in timers_rows:
                f.write(sep.join(str(x) for x in r) + "\n")
        rlog.print(timers.table())
    rlog.finish()
    if args.svpips is not None:
        from .utils.pips import pips_report
        rep = pips_report(csp, dom, sim.state, wall / max(nstep, 1))
        with open(os.path.join(args.dirout, "PIPS.csv"), "w") as f:
            f.write(sep.join(rep.keys()) + "\n")
            f.write(sep.join(str(v) for v in rep.values()) + "\n")
        print(f"[dsphtorch] PIPS: {rep}")
    if args.svres and sv - {"none"}:
        save_res(args.dirout,
                 runname=args.runname or case.meta.get("name", "run"),
                 appname=f"dsphtorch-{VERSION}", casenp=case.np_total,
                 tsim=sim.time, ttot=wall, timestep=sim.time, nstep=nstep,
                 part=sim.part, nout=0, maxparticles=case.np_total,
                 maxcells=dom.ncells, nbound=case.npb, nfixed=case.npb,
                 dp=csp.dp, kernelh=csp.kernelh, runmode=device.type,
                 configinfo=f"tstep={opts.tstep.name}", csvsep=sep,
                 device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
