"""DEM contact forces for floating bodies (``RigidAlgorithm=2``).

Counterpart of `dualsphysics_multilayer_tpu/features/dem.py` (reference
`JSphCpu::InteractionForcesDEM`, JSphCpu.cpp:828-960): floating particles
feel a visco-elastic Hertzian normal force plus a regularised Coulomb
tangential force against boundary particles and particles of other
floating bodies whose lattice spheres (radius dp/2) overlap, with the
JAX package's model and arithmetic:

* tau = (1 - nu^2)/E per mk or body, kn = 4/(3 (tau1+tau2)) sqrt(dp/4);
* effective mass m1/2 against a wall, m1 m2/(m1+m2) between bodies;
* overlap o = dp - |r12|, contact where o > 0;
* fn = kn o^1.5 - gn o^0.25 (v12.n), ft = min(kfric fn tanh(8 vt),
  2 (kn dt - gn) vt / 7);
* the dt term (0.2*40/3.21) (m*/kn)^-0.4 |vn|^0.2 of every candidate pair,
  whose maximum joins ``viscdtmax``.

The port's state is permuted at every rebuild, so the tables are keyed by
particle id (``DemCfg``; ``convert.demcfg`` maps the JAX package's
slot-keyed tables through the template's ids).  :class:`DemLayout` finds
the floating rows of a layout once per divide, through an id-to-slot
scatter (no sort, no read to the host).  The candidates of each floating
row are the neighbour rows of its cell (``celldiv.point_ranges``, valid
under the skin contract: the contact range dp lies far inside the kernel
size), each read to a static ``celldiv.row_cap`` slots; a longer row
counts into the step's overflow.  Under the neighbour-list mode the
candidates are the list's rows (JAX ``apply_dem_nbr``): the same block,
read around the target's build-time position, masked to the slots whose
build-time positions lie within the list's radius of it.  The pairs are
one dense masked block per chunk of targets, as in JAX; the sums over a
target's candidates run in row order.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph
from ..ops import celldiv as cd


@dataclass(frozen=True, eq=False)
class DemCfg:
    """Static DEM tables (the reference's StDemData, `DualSphDef.h:
    259-268`), each (nid,) and indexed by particle id."""
    ft_ids: np.ndarray      # (nf,) ids of the floating particles
    c_tau: np.ndarray       # (1-nu^2)/E
    c_kfric: np.ndarray
    c_restitu: np.ndarray
    c_mass: np.ndarray      # body mass (floating); unused for walls
    c_massp: np.ndarray     # particle mass (floating target side)
    c_group: np.ndarray     # int32 contact group (mk or 10000+body); -1 none
    c_isbound: np.ndarray   # bool


def make_dem(csp: CteSph, code, ftcfg, *, float_props, bound_props=None,
             idp=None) -> DemCfg:
    """The DEM tables of the particles ``code`` (slot order, ids ``idp``;
    by default the slots are the ids), on the host: the types of walls and
    floating particles never change.

    ``float_props``: per body ``dict(young=, poisson=, kfric=, restitu=)``;
    ``bound_props``: ``{mk: dict(...)}`` for wall mks; a wall without an
    entry takes the first body's values (JAX ``make_dem``)."""
    code = np.asarray(code.cpu() if torch.is_tensor(code) else code)
    n = len(code)
    ctype = td.code_type(code)
    cval = td.code_value(code).astype(np.int64)
    isfloat = ctype == td.TYPE_FLOATING
    isbound = ctype < td.TYPE_FLOATING

    def tau_of(p):
        return (1.0 - p["poisson"] ** 2) / p["young"]

    c_tau = np.full(n, 1.0, np.float32)
    c_kfric = np.zeros(n, np.float32)
    c_restitu = np.full(n, 0.5, np.float32)
    c_mass = np.ones(n, np.float32)
    c_massp = np.full(n, csp.massbound, np.float32)
    c_group = np.full(n, -1, np.int32)
    for b, props in enumerate(float_props):
        sel = isfloat & (cval == b)
        c_tau[sel] = tau_of(props)
        c_kfric[sel] = props["kfric"]
        c_restitu[sel] = props["restitu"]
        c_mass[sel] = ftcfg.mass[b]
        c_massp[sel] = ftcfg.massp[b]
        c_group[sel] = 10000 + b
    default = float_props[0]
    bprops = dict(bound_props or {})
    for mk in np.unique(cval[isbound]):
        props = bprops.get(int(mk), default)
        sel = isbound & (cval == mk)
        c_tau[sel] = tau_of(props)
        c_kfric[sel] = props["kfric"]
        c_restitu[sel] = props["restitu"]
        c_group[sel] = int(mk)
    ids = np.arange(n) if idp is None else np.asarray(
        idp.cpu() if torch.is_tensor(idp) else idp).astype(np.int64)
    return by_slot(np.flatnonzero(isfloat), c_tau, c_kfric, c_restitu,
                   c_mass, c_massp, c_group, isbound, ids)


def by_slot(ft_idx, c_tau, c_kfric, c_restitu, c_mass, c_massp, c_group,
            c_isbound, ids) -> DemCfg:
    """A ``DemCfg`` from tables indexed by slot (the JAX package's) and the
    id ``ids[k]`` of slot k."""
    ids = np.asarray(ids, np.int64)
    nid = int(ids.max()) + 1 if len(ids) else 0

    def keyed(a, fill):
        a = np.asarray(a)
        out = np.full(nid, fill, a.dtype)
        out[ids] = a
        return out

    return DemCfg(ft_ids=ids[np.asarray(ft_idx, np.int64)],
                  c_tau=keyed(c_tau, 1.0), c_kfric=keyed(c_kfric, 0.0),
                  c_restitu=keyed(c_restitu, 0.5),
                  c_mass=keyed(c_mass, 1.0), c_massp=keyed(c_massp, 1.0),
                  c_group=keyed(c_group, -1),
                  c_isbound=keyed(c_isbound, False))


# columns of the packed property table
_TAU, _KFRIC, _REST, _MASS, _MASSP, _GROUP, _ISBOUND = range(7)


@functools.lru_cache(maxsize=16)
def _tables(cfg: DemCfg, device):
    """(props (nid, 7) f32, ft_ids (nf,) int64) on ``device``, made once;
    the contact group (< 2^24) and the wall flag are exact in f32."""
    props = np.stack([cfg.c_tau, cfg.c_kfric, cfg.c_restitu, cfg.c_mass,
                      cfg.c_massp, cfg.c_group.astype(np.float32),
                      cfg.c_isbound.astype(np.float32)], axis=1)
    return (torch.tensor(props, dtype=torch.float32, device=device),
            torch.tensor(cfg.ft_ids, dtype=torch.int64, device=device))


class DemLayout:
    """The floating rows of a layout and its slots' properties, found once
    per divide: ``rows(cfg, cells, idp, code)`` computes them again only
    when ``cells`` is another divide than the last call's.  ``local``
    (one rank of a domain decomposition, which holds a part of the
    bodies' rows): only the floating ids the layout holds are kept, so the
    contact pass scales with the rank's rows (one read of their count per
    divide)."""

    def __init__(self, local: bool = False):
        self.local = local
        self._cells = None
        self._rows = None

    def rows(self, cfg: DemCfg, cells, idp, code):
        if cells is not self._cells:
            self._cells = cells
            self._rows = _layout_rows(cfg, idp, code, self.local)
        return self._rows


def _layout_rows(cfg: DemCfg, idp, code, local: bool = False):
    """(fidx (nf,) int64, slotprops (n, 7)): the slot of each floating id
    in this layout (``n`` where none holds it; with ``local`` only the
    ids it holds) and each slot's properties.  Ghost rows (periodic
    copies, and the dead rows of their blocks) carry a source's id but are
    never a target: only normal rows write the id-to-slot map."""
    props, ft_ids = _tables(cfg, idp.device)
    n = idp.shape[0]
    nid = props.shape[0]
    real = td.is_normal(code) & (idp >= 0) & (idp < nid)
    key = torch.where(real, idp, nid)
    slot = torch.full((nid + 1,), n, dtype=torch.int64, device=idp.device)
    slot[key] = torch.arange(n, device=idp.device)
    fidx = slot[ft_ids]
    if local:
        fidx = fidx[fidx < n]
    return fidx, props[torch.clamp(idp, 0, nid - 1)]


def apply_dem(cfg: DemCfg, csp: CteSph, dom: cd.Domain, cells: cd.CellDiv,
              pos, vel, code, idp, dt, layout: DemLayout | None = None,
              max_pairs: int = 1 << 23, ref=None, rcut2=None):
    """DEM contact accelerations on the layout ``cells`` (slots in cell
    order with ids ``idp``).  Returns ``(ace_add (n,3), demdtmax (),
    overflow ())``: ``ace_add`` is zero outside the floating rows,
    ``demdtmax`` joins the viscdt max, ``overflow`` (int32) counts the
    floating rows with a neighbour row longer than ``celldiv.row_cap``.
    ``dt`` is the step's dt (a 0-d tensor or a float).  ``max_pairs``
    bounds the padded pairs of one chunk of targets.  ``ref`` (n,3) and
    ``rcut2``: the neighbour list's build-time positions (the layout's
    ``pos0``) and squared radius (float32); the candidates are then the
    list's rows, j with |ref_i - ref_j|^2 <= rcut2 (JAX `nbrlist.py:160`,
    ``apply_dem_nbr``)."""
    n = pos.shape[0]
    f32, dev = pos.dtype, pos.device
    if layout is None:
        layout = DemLayout()
    fidx, slotprops = layout.rows(cfg, cells, idp, code)
    nf = fidx.shape[0]
    found = fidx < n
    rows = torch.clamp(fidx, max=n - 1)
    fcode = code[rows]
    p1valid = (found & td.is_floating(fcode) & td.is_active(fcode)
               & td.is_normal(fcode))
    starts, lens = cd.point_ranges(dom, cells,
                                   (pos if ref is None else ref)[rows])
    L = cd.row_cap(csp, dom)
    R = starts.shape[1]
    overflow = ((lens > L).any(dim=1) & p1valid).sum(dtype=torch.int32)
    dp = float(csp.dp)
    kn_geo = np.sqrt(np.float32(0.25) * np.float32(dp))
    off = torch.arange(L, device=dev)
    ace_f = torch.zeros((nf, 3), dtype=f32, device=dev)
    demdtmax = torch.zeros((), dtype=f32, device=dev)
    B = max(1, max_pairs // (R * L))
    for i0 in range(0, nf, B):
        t = slice(i0, min(i0 + B, nf))
        ok = off < lens[t, :, None]                               # (b,R,L)
        j = torch.where(ok, starts[t, :, None] + off, 0).reshape(
            ok.shape[0], R * L)
        ok = ok.reshape(j.shape) & p1valid[t, None]
        r1 = rows[t]
        p1 = slotprops[r1]                                         # (b,7)
        cp = slotprops[j]                                          # (b,M,7)
        ccode = code[j]
        dr = pos[r1][:, None, :] - pos[j]
        rr2 = (dr * dr).sum(dim=-1)
        rad = torch.sqrt(torch.clamp(rr2, min=1e-18))
        cgroup = cp[..., _GROUP]
        pair = (ok & (cgroup >= 0) & (cgroup != p1[:, None, _GROUP])
                & td.is_active(ccode) & ~td.is_fluid(ccode)
                & (rr2 >= td.ALMOSTZERO))
        if ref is not None:
            e = ref[r1][:, None, :] - ref[j]
            pair = pair & (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]
                           + e[..., 2] * e[..., 2] <= rcut2)
        m1 = p1[:, None, _MASS]
        cmass = cp[..., _MASS]
        nu_mass = torch.where(cp[..., _ISBOUND] > 0, 0.5 * m1,
                              m1 * cmass / (m1 + cmass))
        kn = 4.0 / (3.0 * (p1[:, None, _TAU] + cp[..., _TAU])) * kn_geo
        dv = vel[r1][:, None, :] - vel[j]
        nrm = dr / rad[..., None]
        vn = (dv * nrm).sum(dim=-1)
        demvisc = ((0.2 * 40.0 / 3.21) * torch.pow(nu_mass / kn, -0.4)
                   * torch.pow(vn.abs(), 0.2))
        demdtmax = torch.maximum(demdtmax,
                                 torch.where(pair, demvisc, 0.0).amax())
        overlap = dp - rad
        w = (pair & (overlap > 0.0)).to(f32)
        eij = torch.clamp(0.5 * (p1[:, None, _REST] + cp[..., _REST]),
                          1e-4, 0.999999)
        ln_e = torch.log(eij)
        gn = -(2.0 * ln_e * torch.sqrt(nu_mass * kn)) / torch.sqrt(
            math.pi + ln_e * ln_e)
        ovl = torch.clamp(overlap, min=0.0)
        fn = kn * ovl ** 1.5 - gn * ovl ** 0.25 * vn
        inv_mp1 = 1.0 / p1[:, None, _MASSP]
        ace = (w * fn * inv_mp1)[..., None] * nrm
        dvt = dv - vn[..., None] * nrm
        vt = torch.sqrt(torch.clamp((dvt * dvt).sum(dim=-1), min=1e-18))
        ft_elast = 2.0 * (kn * dt - gn) * vt / 7.0
        kfric = 0.5 * (p1[:, None, _KFRIC] + cp[..., _KFRIC])
        ft = torch.minimum(kfric * fn * torch.tanh(8.0 * vt), ft_elast)
        ace = ace + (w * ft * inv_mp1)[..., None] * (dvt / vt[..., None])
        ace_f[t] = ace.sum(dim=1)
    if csp.simulate2d:
        ace_f[:, 1] = 0.0
    # one write per floating row; the rows of absent ids go to a dump row
    out = torch.zeros((n + 1, 3), dtype=f32, device=dev)
    out[torch.where(p1valid, rows, n)] = ace_f
    return out[:n], demdtmax, overflow
