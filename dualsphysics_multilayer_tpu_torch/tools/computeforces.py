"""ComputeForces: linear force (and moments) exerted by the fluid on a set
of boundary/floating particles, per PART.

Rebuild of the closed `ComputeForces` binary (CLI:
the reference's `doc/help/ComputeForces_Help.out`).  ForceFluid follows the
momentum-equation sum the help cites ("eq.48, Dominguez et al 2022") — the
same pairwise pressure + artificial-viscosity interaction the solver's force
kernel computes (`JSphCpu.cpp:713-764`), evaluated for the selected particles
against their fluid neighbours:

  a_i = sum_j  m_j [ (P_i+P_j)/(rho_i rho_j) + Pi_ij ] grad_i W_ij
  ForceFluid_i = m_i a_i                                   [N]
  Weight = m g,  ForceTotal = ForceFluid + Weight          (floating only)

Moments: -momentaxisin/-momentaxisex/-momentin_xyz/-momentex_xyz give
sum_i r_i x F_i about the given axes (extrinsic axes do not rotate).

The pair sums run in float64 on the card unless ``-cpu`` is given, with
the host version's float32 pair terms.

Counterpart of `dualsphysics_multilayer_tpu/tools/computeforces.py`.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import typesdef as td
from ..io import vtkout
from . import common as C


def fluid_forces(d, sel_idx, *, visco=0.0, viscoboundfactor=0.0,
                 gravity=(0.0, 0.0, -9.81), device=None):
    """Per-selected-particle fluid force [N] (pressure + artificial visc),
    (n_sel, 3) float64 on the host; the sums on ``device`` (default: the
    card, ``common.tool_device``).  The pair terms keep the host
    version's types: the pressure and viscous terms in float32, their
    products with the kernel gradient in float64."""
    dev = device if device is not None else C.tool_device(False)
    pos, vel, rhop = d["pos"], d["vel"], d["rhop"]
    typ = C.type_of(d)
    h = d["ctes"]["H"]
    cs0 = np.sqrt(d["ctes"]["Gamma"] * d["ctes"]["B"] / d["ctes"]["Rhop0"])
    sim2d = d.get("data2d", False)
    fluid = np.where(typ == td.TYPE_FLUID)[0]

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    p64, vel32, rho32 = t(np.asarray(pos, np.float64)), t(vel), t(rhop)
    press, mass = t(C.press_of(d)), t(C.mass_of(d))
    fl, si = t(fluid.astype(np.int64)), t(np.asarray(sel_idx, np.int64))
    tgt = p64[si]
    v = visco * (1.0 + viscoboundfactor) if viscoboundfactor else visco
    ace = torch.zeros((len(sel_idx), 3), dtype=torch.float64, device=dev)
    for ti, sj in C.device_pairs(p64[fl], tgt, 2.0 * h):
        j = fl[sj]
        i = si[ti]
        dr = tgt[ti] - p64[j]
        rr2 = dr[:, 0] * dr[:, 0] + dr[:, 1] * dr[:, 1] + dr[:, 2] * dr[:, 2]
        nz = rr2 > 1e-18
        i, j, dr, rr2, ti = i[nz], j[nz], dr[nz], rr2[nz], ti[nz]
        fac = C.wendland_fac_t(sim2d, h, rr2)
        prs = (press[i] + press[j]) / (rho32[i] * rho32[j])
        pi_ij = torch.zeros_like(prs)
        if visco > 0:
            dv = (vel32[i] - vel32[j]).double()
            dot = (dv[:, 0] * dr[:, 0] + dv[:, 1] * dr[:, 1]
                   + dv[:, 2] * dr[:, 2])
            amubar = h * dot / (rr2 + 0.01 * h * h)
            robar = 0.5 * (rho32[i] + rho32[j])
            pi_ij = torch.where(dot < 0, -v * cs0 * amubar / robar.double(),
                                0.0).float()
        w = (mass[j] * (prs + pi_ij)).double()
        ace.index_add_(0, ti, (w * fac)[:, None] * dr)
    force = -ace * mass[si][:, None].double()
    return force.cpu().numpy()


def parse_args(argv):
    cfg = dict(dirin=".", filexml=None, first=None, last=None, files=None,
               filters=C.Filters(), out=C.OutCfg(), visco=0.0, vbf=0.0,
               gravity=(0.0, 0.0, -9.81), moments=[], savecsv=None,
               saveascii=None, savevtk=None, balancex=False,
               fixedfilter=False, cpu=False)
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(__doc__)
            sys.exit(0)
        elif a == "-dirin":
            i += 1
            cfg["dirin"] = argv[i]
        elif a == "-filexml":
            i += 1
            cfg["filexml"] = argv[i]
        elif a.startswith("-first:"):
            cfg["first"] = int(a.split(":")[1])
        elif a.startswith("-last:"):
            cfg["last"] = int(a.split(":")[1])
        elif a.startswith("-files:"):
            cfg["files"] = a.split(":", 1)[1]
        elif a.startswith("-threads"):
            pass
        elif a.startswith("-viscoart:"):
            f = a.split(":")[1:]
            cfg["visco"] = float(f[0])
            if len(f) > 1:
                cfg["vbf"] = float(f[1])
        elif a.startswith("-viscolam:") or a == "-viscoauto":
            pass  # laminar tool viscosity not distinguished; auto = bi4 ctes
        elif a.startswith("-gravity:"):
            cfg["gravity"] = tuple(float(x) for x in a.split(":")[1:4])
        elif a == "-balancex":
            cfg["balancex"] = True
        elif a.startswith("-momentaxis:"):
            f = [float(x) for x in a.split(":")[1:7]]
            cfg["moments"].append(("in", f[:3], f[3:], "Mom"))
        elif a.startswith(("-momentaxisin:", "-momentaxisex:")):
            kind = "in" if "axisin" in a else "ex"
            f = a.split(":")[1:]
            cfg["moments"].append((kind, [float(x) for x in f[:3]],
                                   [float(x) for x in f[3:6]],
                                   f[6] if len(f) > 6 else f"M{kind}"))
        elif a.startswith(("-momentin_xyz:", "-momentex_xyz:")):
            kind = "in" if "in_" in a else "ex"
            p = [float(x) for x in a.split(":")[1:4]]
            for ax, v in zip("XYZ", np.eye(3)):
                cfg["moments"].append((kind, p, (np.asarray(p) + v).tolist(),
                                       f"M{kind}{ax}"))
        elif a.startswith("-onlypos:"):
            cfg["filters"].onlypos = tuple(float(x) for x in a.split(":")[1:7])
        elif a.startswith("-onlymk:"):
            cfg["filters"].onlymk = C.parse_range_filter(a.split(":", 1)[1])
        elif a.startswith("-onlyid:"):
            cfg["filters"].onlyid = C.parse_range_filter(a.split(":", 1)[1])
        elif a == "-onlyidfile":
            i += 1
            with open(argv[i]) as f:
                cfg["filters"].onlyid = np.array(
                    [int(x) for x in f.read().split()], np.int64)
        elif a == "-fixedfilter":
            cfg["fixedfilter"] = True
        elif a == "-savecsv":
            i += 1
            cfg["savecsv"] = argv[i]
        elif a == "-saveascii":
            i += 1
            cfg["saveascii"] = argv[i]
        elif a == "-savevtk":
            i += 1
            cfg["savevtk"] = argv[i]
        elif a.startswith("-createdirs:"):
            cfg["out"].createdirs = a.endswith("1")
        elif a.startswith("-csvsep:"):
            cfg["out"].csvsep = int(a.split(":")[1])
        elif a == "-cpu":
            cfg["cpu"] = True
        elif a == "-opt":
            i += 1
            with open(argv[i]) as f:
                argv[i + 1:i + 1] = f.read().split()
        else:
            raise SystemExit(f"computeforces: unknown option '{a}'")
        i += 1
    return cfg


def run(cfg):
    parts = C.find_parts(cfg["dirin"], cfg["first"], cfg["last"],
                         cfg["files"])
    blocks = None
    fx = C.resolve_filexml(cfg["filexml"], cfg["dirin"])
    if fx and os.path.exists(fx):
        blocks = C.load_mkblocks_xml(fx)
    dev = C.tool_device(cfg["cpu"])
    rows = []
    written = []
    fixed_ids = None
    g = np.asarray(cfg["gravity"])
    for cpart, path in parts:
        d = C.load_part(path)
        if fixed_ids is not None:
            sel_idx = np.where(np.isin(d["idp"], fixed_ids))[0]
        else:
            sel = cfg["filters"].apply(d, blocks)
            # default selection excludes plain fluid (force ON something)
            if cfg["filters"].onlytype is None and \
                    cfg["filters"].onlymk is None and \
                    cfg["filters"].onlyid is None:
                sel &= C.type_of(d) != td.TYPE_FLUID
            sel_idx = np.where(sel)[0]
            if cfg["fixedfilter"]:
                fixed_ids = d["idp"][sel_idx]
        force = fluid_forces(d, sel_idx, visco=cfg["visco"],
                             viscoboundfactor=cfg["vbf"], gravity=g,
                             device=dev)
        ftotal = force.sum(0)
        mass = C.mass_of(d)[sel_idx]
        weight = mass.sum() * g
        row = [cpart, d["timestep"], *ftotal, *weight, *(ftotal + weight)]
        hdr = ["Part", "Time", "ForceFluid.x", "ForceFluid.y", "ForceFluid.z",
               "Weight.x", "Weight.y", "Weight.z",
               "ForceTotal.x", "ForceTotal.y", "ForceTotal.z"]
        if cfg["balancex"]:
            cen = (d["pos"][sel_idx] * mass[:, None]).sum(0) / \
                max(mass.sum(), 1e-30)
            row += [mass.sum(), cen[0]]
            hdr += ["Mass", "Center.x"]
        for kind, p1, p2, name in cfg["moments"]:
            axis = np.asarray(p2) - np.asarray(p1)
            axis = axis / max(np.linalg.norm(axis), 1e-30)
            r = d["pos"][sel_idx] - np.asarray(p1)
            mom = np.cross(r, force).sum(0)
            row.append(float(mom @ axis))
            hdr.append(name)
        rows.append((hdr, row))
        if cfg["savevtk"]:
            p = C.prepare_path(C.numbered(cfg["savevtk"], cpart), cfg["out"])
            vtkout.write_vtk_particles(p, d["pos"][sel_idx],
                                       {"Force": force.astype(np.float32)})
            written.append(p)
    if rows:
        hdr = rows[0][0]
        if cfg["savecsv"]:
            base = cfg["savecsv"]
            if not base.endswith(".csv"):
                base += ".csv"
            written.append(C.write_csv(base, hdr, [r for _, r in rows],
                                       cfg["out"]))
        if cfg["saveascii"]:
            written.append(C.write_ascii(cfg["saveascii"],
                                         [r for _, r in rows], cfg["out"]))
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = run(parse_args(argv))
    print(f"ComputeForces: wrote {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
