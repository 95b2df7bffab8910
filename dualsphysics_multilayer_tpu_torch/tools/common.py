"""Shared machinery of the post-processing tools.

Counterpart of `dualsphysics_multilayer_tpu/tools/common.py` (the JAX
package's rebuild of the reference's closed post-tools, PartVTK,
MeasureTool, IsoSurface, ComputeForces, FloatingInfo, BoundaryVTK,
PartVTKOut, TracerParts, FlowTool and BIFileInfo, from their help dumps):

* PART-series discovery (``-dirin/-first/-last/-files``),
* particle filters (``-onlypos/-onlymk/-onlyid/-onlytype/-onlyvel``, the
  JRangeFilter "1,3-5" grammar of reference `JRangeFilter.cpp`),
* derived variables (press/mass/vol/type/mk/energies, PartVTK's ``-vars``),
* the neighbour pairs of the tools' SPH sums: :func:`pair_indices` on the
  host (numpy float64; the boundary-normal estimate of
  ``features/initialize.py`` uses it too) and :func:`device_pairs`, the
  same search in torch float64 on a device, chunked by a pair budget,
  which the sums of MeasureTool, IsoSurface and ComputeForces run on:
  on the card unless ``-cpu`` is given (:func:`tool_device`),
* CSV/ASCII writers honoring ``-csvsep``/``-createdirs``.
"""

from __future__ import annotations

import glob
import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np
import torch

from .. import typesdef as td
from ..io import partdata

# GenCase mk offsets (reference JSphMk: mk = mkbound+MkBoundFirst or
# mkfluid+MkFluidFirst, with MkFluidFirst=1, MkBoundFirst=11 by default)
MKFLUIDFIRST = 1
MKBOUNDFIRST = 11


# ---------------------------------------------------------------------------
# PART series
# ---------------------------------------------------------------------------

def parse_range_filter(txt):
    """JRangeFilter grammar: "1,3-5,7" -> sorted int array."""
    vals = set()
    for tok in str(txt).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "-" in tok[1:]:
            i = tok.index("-", 1)
            lo, hi = int(tok[:i]), int(tok[i + 1:])
            vals.update(range(lo, hi + 1))
        else:
            vals.add(int(tok))
    return np.array(sorted(vals), dtype=np.int64)


def find_parts(dirin, first=None, last=None, files=None):
    """Discover Part_XXXX.bi4 files; returns list of (cpart, path)."""
    out = []
    for p in sorted(glob.glob(os.path.join(dirin, "Part_*.bi4"))):
        m = re.match(r"Part_(\d+)\.bi4$", os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    if files is not None:
        keep = set(parse_range_filter(files).tolist())
        out = [fp for fp in out if fp[0] in keep]
    if first is not None:
        out = [fp for fp in out if fp[0] >= first]
    if last is not None:
        out = [fp for fp in out if fp[0] <= last]
    if not out:
        raise SystemExit(f"no PART files found in '{dirin}'")
    return out


@dataclass
class MkBlock:
    mk: int
    mktype: int          # td.TYPE_*
    begin: int
    count: int


def load_mkblocks_xml(path):
    """Read the <particles> block table from a GenCase-generated run XML
    (the `-filexml` input; reference JCaseParts)."""
    root = ET.parse(path).getroot()
    parts = root.find(".//particles")
    blocks = []
    if parts is None:
        return blocks
    tmap = {"fixed": td.TYPE_FIXED, "moving": td.TYPE_MOVING,
            "floating": td.TYPE_FLOATING, "fluid": td.TYPE_FLUID}
    for el in parts:
        if el.tag not in tmap:
            continue
        mkb = el.get("mkbound")
        mkf = el.get("mkfluid")
        mk = el.get("mk")
        if mk is None:
            mk = (int(mkf) + MKFLUIDFIRST if mkf is not None
                  else int(mkb) + MKBOUNDFIRST)
        blocks.append(MkBlock(mk=int(mk), mktype=tmap[el.tag],
                              begin=int(el.get("begin", 0)),
                              count=int(el.get("count", 0))))
    return blocks


def resolve_filexml(arg, dirin):
    if arg and arg.upper() == "AUTO":
        # the run copies its case XML next to the output (reference behavior)
        cands = glob.glob(os.path.join(dirin, "*.xml"))
        return cands[0] if cands else None
    return arg


def mk_of(d, blocks=None):
    """Per-particle mk.  With an XML block table: by idp range (exact
    reference semantics); else derived from the typecode value bits."""
    idp, code = d["idp"], d["code"]
    if blocks:
        mk = np.zeros(len(idp), np.int32)
        for b in blocks:
            sel = (idp >= b.begin) & (idp < b.begin + b.count)
            mk[sel] = b.mk
        return mk
    if code is None:
        return np.zeros(len(idp), np.int32)
    val = (code & td.CODE_VALUE_MASK).astype(np.int32)
    typ = (code >> td.CODE_TYPE_SHIFT) & td.CODE_TYPE_MASK
    return np.where(typ == td.TYPE_FLUID, val + MKFLUIDFIRST,
                    val + MKBOUNDFIRST)


def type_of(d):
    code = d["code"]
    if code is not None:
        return ((code >> td.CODE_TYPE_SHIFT) & td.CODE_TYPE_MASK).astype(
            np.int32)
    c = d["counts"]
    idp = d["idp"]
    nfx, nmv = c["CaseNfixed"], c["CaseNmoving"]
    nft = c["CaseNfloat"]
    typ = np.full(len(idp), td.TYPE_FLUID, np.int32)
    typ[idp < nfx] = td.TYPE_FIXED
    typ[(idp >= nfx) & (idp < nfx + nmv)] = td.TYPE_MOVING
    typ[(idp >= nfx + nmv) & (idp < nfx + nmv + nft)] = td.TYPE_FLOATING
    return typ


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

_TYPE_GROUPS = {
    "bound": (td.TYPE_FIXED, td.TYPE_MOVING, td.TYPE_FLOATING),
    "fixed": (td.TYPE_FIXED,),
    "moving": (td.TYPE_MOVING,),
    "floating": (td.TYPE_FLOATING,),
    "fluid": (td.TYPE_FLUID,),
}


def parse_typesel(txt, preselected=("fixed", "moving", "floating", "fluid")):
    """Parse "-all,+fluid" style include/exclude type lists."""
    chosen = {t: True for t in preselected}
    for tok in str(txt).split(","):
        tok = tok.strip()
        if not tok:
            continue
        sign = tok[0] not in "-"
        name = tok.lstrip("+-")
        if name == "all":
            for k in _TYPE_GROUPS:
                if k not in ("bound",):
                    chosen[k] = sign
        elif name == "bound":
            for k in ("fixed", "moving", "floating"):
                chosen[k] = sign
        elif name in _TYPE_GROUPS:
            chosen[name] = sign
        else:
            raise SystemExit(f"unknown type selector '{tok}'")
    types = set()
    for k, on in chosen.items():
        if on:
            types.update(_TYPE_GROUPS[k])
    return types


@dataclass
class Filters:
    onlypos: tuple | None = None          # (xmin..zmax)
    onlymk: np.ndarray | None = None
    onlyid: np.ndarray | None = None
    onlytype: set | None = None
    onlyvel: tuple | None = None          # (vmin, vmax)

    def copy(self):
        return Filters(self.onlypos, self.onlymk, self.onlyid,
                       self.onlytype, self.onlyvel)

    def apply(self, d, blocks=None):
        n = len(d["pos"])
        sel = np.ones(n, bool)
        if self.onlypos is not None:
            p = d["pos"]
            lo, hi = self.onlypos[:3], self.onlypos[3:]
            sel &= np.all((p >= lo) & (p <= hi), axis=1)
        if self.onlymk is not None:
            sel &= np.isin(mk_of(d, blocks), self.onlymk)
        if self.onlyid is not None:
            sel &= np.isin(d["idp"], self.onlyid)
        if self.onlytype is not None:
            sel &= np.isin(type_of(d), list(self.onlytype))
        if self.onlyvel is not None:
            v = np.linalg.norm(d["vel"], axis=1)
            sel &= (v >= self.onlyvel[0]) & (v <= self.onlyvel[1])
        return sel


# ---------------------------------------------------------------------------
# derived variables
# ---------------------------------------------------------------------------

def press_of(d):
    """Tait EOS from the ctes stored in the bi4 (FunSphEos.h:56-64)."""
    c = d["ctes"]
    b, rho0, gamma = c["B"], c["Rhop0"], c.get("Gamma", 7.0)
    return (b * ((d["rhop"] / rho0) ** gamma - 1.0)).astype(np.float32)


def mass_of(d):
    c = d["ctes"]
    typ = type_of(d)
    return np.where(typ == td.TYPE_FLUID, c["MassFluid"],
                    c["MassBound"]).astype(np.float32)


def compute_vars(d, names, blocks=None, enpotzero=(0.0, 0.0, 0.0),
                 gravity=(0.0, 0.0, -9.81)):
    """Computed/stored variable registry (PartVTK `-vars`)."""
    out = {}
    g = np.asarray(gravity)
    for nm in names:
        if nm == "idp":
            out["Idp"] = d["idp"]
        elif nm == "vel":
            out["Vel"] = d["vel"]
        elif nm == "rhop":
            out["Rhop"] = d["rhop"]
        elif nm == "press":
            out["Press"] = press_of(d)
        elif nm == "mass":
            out["Mass"] = mass_of(d)
        elif nm == "vol":
            out["Vol"] = (mass_of(d) / d["rhop"]).astype(np.float32)
        elif nm == "type":
            out["Type"] = type_of(d)
        elif nm == "mk":
            out["Mk"] = mk_of(d, blocks)
        elif nm == "enkin":
            out["EnKin"] = (0.5 * mass_of(d)
                            * (d["vel"] ** 2).sum(1)).astype(np.float32)
        elif nm == "enpot":
            rel = d["pos"] - np.asarray(enpotzero)
            out["EnPot"] = (-mass_of(d) * (rel @ g)).astype(np.float32)
        elif nm == "enint":
            # internal (elastic compression) energy of the Tait EOS:
            # e = B/rho0 * ((r^(g-1)-1)/(g-1) + r^-1 - 1) * m / ... per unit
            c = d["ctes"]
            r = d["rhop"] / c["Rhop0"]
            gam = c.get("Gamma", 7.0)
            e = c["B"] / c["Rhop0"] * ((r ** (gam - 1) - 1) / (gam - 1)
                                       + 1.0 / r - 1.0)
            out["EnInt"] = (mass_of(d) * e).astype(np.float32)
        elif nm == "energy":
            out.update(compute_vars(d, ["enkin", "enpot", "enint"], blocks,
                                    enpotzero, gravity))
            out["EnTot"] = out["EnKin"] + out["EnPot"] + out["EnInt"]
        elif nm == "entot":
            sub = compute_vars(d, ["enkin", "enpot", "enint"], blocks,
                               enpotzero, gravity)
            out["EnTot"] = sub["EnKin"] + sub["EnPot"] + sub["EnInt"]
        elif nm in ("ace", "vor"):
            pass  # computed by callers that own the SPH re-interaction
        else:
            raise SystemExit(f"unknown variable '{nm}'")
    return out


def parse_vars(txt, preselected):
    chosen = list(preselected)
    for tok in str(txt).split(","):
        tok = tok.strip()
        if not tok:
            continue
        sign = tok[0] not in "-"
        name = tok.lstrip("+-")
        if name == "all":
            chosen = (["idp", "vel", "rhop", "press", "mass", "vol", "type",
                       "mk", "ace", "vor", "energy"] if sign else [])
        elif sign and name not in chosen:
            chosen.append(name)
        elif not sign and name in chosen:
            chosen.remove(name)
    return chosen


# ---------------------------------------------------------------------------
# neighbour pairs
# ---------------------------------------------------------------------------

def pair_indices(src_pos, tgt_pos, radius):
    """All (ti, sj) pairs with |tgt[ti]-src[sj]| < radius via cell binning,
    in numpy float64 on the host: the host analog of the solver's
    cell-linked neighbour search (JCellDivCpu)."""
    src = np.asarray(src_pos, np.float64)
    tgt = np.asarray(tgt_pos, np.float64)
    if len(src) == 0 or len(tgt) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    org = src.min(0) - radius
    cell = np.maximum(np.floor((src - org) / radius).astype(np.int64), 0)
    ncel = cell.max(0) + 1
    strides = np.array([ncel[1] * ncel[2], ncel[2], 1], np.int64)
    key = cell @ strides
    order = np.argsort(key, kind="stable")
    skey = key[order]
    # target cells may lie off the source grid: skipped there, and the
    # distance test decides the rest
    tcell = np.floor((tgt - org) / radius).astype(np.int64)
    ti_all, sj_all = [], []
    r2 = radius * radius
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nc = tcell + (dx, dy, dz)
                ok = np.all((nc >= 0) & (nc < ncel), axis=1)
                if not ok.any():
                    continue
                tk = nc[ok] @ strides
                lo = np.searchsorted(skey, tk, side="left")
                hi = np.searchsorted(skey, tk, side="right")
                cnt = hi - lo
                nz = cnt > 0
                if not nz.any():
                    continue
                tidx = np.where(ok)[0][nz]
                lo, cnt = lo[nz], cnt[nz]
                ti = np.repeat(tidx, cnt)
                # the ragged ranges lo[k] .. lo[k] + cnt[k]
                sj = np.repeat(lo, cnt) + (np.arange(cnt.sum())
                                           - np.repeat(np.cumsum(cnt) - cnt,
                                                       cnt))
                sj = order[sj]
                d2 = ((tgt[ti] - src[sj]) ** 2).sum(1)
                keep = d2 < r2
                ti_all.append(ti[keep])
                sj_all.append(sj[keep])
    if not ti_all:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    return np.concatenate(ti_all), np.concatenate(sj_all)


# the pair budget of one chunk of :func:`device_pairs` (the candidates of
# its targets before the distance test)
MAX_PAIRS = 1 << 24
# the pairs the tools' sums visited since the last reset (``visited``)
PAIR_STATS = {"visited": 0}


def tool_device(cpu: bool) -> torch.device:
    """The device of a tool's sums: the CPU with ``-cpu``, else the card;
    without a card and without ``-cpu`` the tool leaves with an error
    rather than run on the host."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the tool's sums run on the card "
                         "(give -cpu to run them on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def device_pairs(src, tgt, radius, max_pairs: int = MAX_PAIRS):
    """Yield ``(ti, sj)`` chunks (int64, on the device of ``src`` and
    ``tgt``, (n,3) float64 tensors) of the pairs with |tgt[ti] - src[sj]|
    < radius: :func:`pair_indices`'s cell binning and test in torch.  The
    targets are taken in runs whose candidates (the 27 cells around each)
    stay within ``max_pairs``, which bounds the pair temporaries; one read
    to the host sizes the runs, and one per run its candidate count."""
    if len(src) == 0 or len(tgt) == 0:
        return
    dev = src.device
    org = src.min(dim=0).values - radius
    cell = torch.clamp(torch.floor((src - org) / radius).long(), min=0)
    ncel = cell.max(dim=0).values + 1
    strides = torch.stack([ncel[1] * ncel[2], ncel[2],
                           torch.ones_like(ncel[2])])
    skey, order = torch.sort((cell * strides).sum(dim=1), stable=True)
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)
    nc = torch.floor((tgt - org) / radius).long()[:, None, :] + offs
    ok = ((nc >= 0) & (nc < ncel)).all(dim=-1)
    tk = (nc * strides).sum(dim=-1)
    lo = torch.searchsorted(skey, tk, side="left")
    cnt = torch.where(ok, torch.searchsorted(skey, tk, side="right") - lo, 0)
    csum = np.cumsum(cnt.sum(dim=1).cpu().numpy())
    r2 = radius * radius
    m, a = len(tgt), 0
    while a < m:
        base = csum[a - 1] if a else 0
        b = max(a + 1, int(np.searchsorted(csum, base + max_pairs, "right")))
        b = min(b, m)
        c = cnt[a:b].reshape(-1)
        total = int(csum[b - 1] - base)
        if total:
            t = torch.arange(a, b, device=dev).repeat_interleave(len(_OFFSETS))
            ti = torch.repeat_interleave(t, c, output_size=total)
            first = torch.cumsum(c, dim=0) - c
            sj = order[torch.repeat_interleave(lo[a:b].reshape(-1) - first, c,
                                               output_size=total)
                       + torch.arange(total, device=dev)]
            d = tgt[ti] - src[sj]
            keep = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                    + d[:, 2] * d[:, 2]) < r2
            ti, sj = ti[keep], sj[keep]
            PAIR_STATS["visited"] += len(ti)
            yield ti, sj
        a = b


def wendland_wab_t(sim2d, h, rr2):
    """:func:`wendland_wab` on a tensor, with the same operations."""
    qq = torch.sqrt(rr2) / h
    awen = (0.557 / (h * h) if sim2d else 0.41778 / (h ** 3))
    wqq = 2.0 * qq + 1.0
    wqq1 = torch.clamp(1.0 - 0.5 * qq, min=0.0)
    wqq2 = wqq1 * wqq1
    return awen * wqq * wqq2 * wqq2


def wendland_fac_t(sim2d, h, rr2):
    """:func:`wendland_fac` on a tensor, with the same operations."""
    rad = torch.sqrt(rr2)
    qq = rad / h
    bwen = (-2.7852 / (h ** 3) if sim2d else -2.08891 / (h ** 4))
    wqq1 = torch.clamp(1.0 - 0.5 * qq, min=0.0)
    return bwen * qq * wqq1 * wqq1 * wqq1 / torch.clamp(rad, min=1e-18)


def wendland_wab(csp2d, h, rr2):
    """Wendland C2 W(r) with the reference's constants
    (FunSphKernel.h:191-216)."""
    qq = np.sqrt(rr2) / h
    awen = (0.557 / (h * h) if csp2d else 0.41778 / (h ** 3))
    wqq = 2.0 * qq + 1.0
    wqq1 = np.maximum(1.0 - 0.5 * qq, 0.0)
    wqq2 = wqq1 * wqq1
    return awen * wqq * wqq2 * wqq2


def wendland_fac(csp2d, h, rr2):
    """Wendland gradient factor fac = (1/r)(dW/dr) (FunSphKernel.h:217-222)."""
    rad = np.sqrt(rr2)
    qq = rad / h
    bwen = (-2.7852 / (h ** 3) if csp2d else -2.08891 / (h ** 4))
    wqq1 = np.maximum(1.0 - 0.5 * qq, 0.0)
    return bwen * qq * wqq1 * wqq1 * wqq1 / np.maximum(rad, 1e-18)


# ---------------------------------------------------------------------------
# output helpers
# ---------------------------------------------------------------------------

@dataclass
class OutCfg:
    createdirs: bool = True
    csvsep: int = 0      # 0=semicolon 1=comma

    @property
    def sep(self):
        return ";" if self.csvsep == 0 else ","


def prepare_path(path, cfg: OutCfg):
    d = os.path.dirname(path)
    if d and cfg.createdirs:
        os.makedirs(d, exist_ok=True)
    return path


def numbered(path, cpart):
    """file.vtk -> file_0012.vtk (reference per-PART naming)."""
    base, ext = os.path.splitext(path)
    return f"{base}_{cpart:04d}{ext}"


def write_csv(path, header, rows, cfg: OutCfg):
    prepare_path(path, cfg)
    sep = cfg.sep
    with open(path, "w") as f:
        f.write(sep.join(header) + "\n")
        for r in rows:
            f.write(sep.join(str(x) for x in r) + "\n")
    return path


def write_ascii(path, rows, cfg: OutCfg):
    prepare_path(path, cfg)
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(str(x) for x in r) + "\n")
    return path


def load_part(path):
    return partdata.read_part(path)


def fmt3(v):
    return [f"{v[0]:.7e}", f"{v[1]:.7e}", f"{v[2]:.7e}"]
