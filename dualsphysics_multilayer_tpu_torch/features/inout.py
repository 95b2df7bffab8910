"""Inlet/outlet open boundaries over spare particle slots, on torch
tensors.

Counterpart of `dualsphysics_multilayer_tpu/features/inout.py` (the
reference's `JSphInOut` family; runtime `JSphCpuSingle_InOut.cpp:72-251`
``InOutInit`` / ``InOutComputeStep``).  The population changes inside a
fixed number of slots: dead slots (special >= OUT) are the free pool.  Per
zone and per step (:func:`inout_step`, after the step's update):

1. members whose signed distance along the zone direction crosses the
   inlet plane (s > 0) become plain fluid, and with the conveyor refilling
   a replacement member is spawned one zone width behind each;
2. members leaving through the back of the zone (s < -width) are
   destroyed (OUT_MOVE, freeing their slot);
3. plain fluid inside the zone volume is captured as a member (outlets);
4. with the advanced refilling, every ``refillrate`` steps each hole of
   the zone's dp lattice gets a member;
5. every member takes the zone's velocity (uniform, linear or parabolic
   profile with a time series, a velocity grid, an AWAS correction) and
   density (constant or hydrostatic under the zone's zsurf: fixed, timed
   or calculated), or, in the extrapolated modes, the first-order MLS
   extrapolation from the fluid around its mirror node
   (:func:`inout_extrapolate`).

Zone tags live in typecode bits (``typesdef.code_inout``); members are
fluid-typed, so kernel 1 runs them without a branch of its own.

The slots are permuted at every rebuild, so "the k-th free slot" of the
JAX package (slot order; its bucket path's slot is the particle id) is
here the free slot with the k-th smallest ``idp``, and requests are ranked
by the id of the particle that makes them: a spawned particle carries the
id JAX gives it.  ``InOutCfg.n_usable`` limits the ids.  A spawn lands in a
slot of the layout's dead tail, which the kernels do not walk, so
:func:`inout_step` returns a device flag "a slot was filled" that forces
the next step's rebuild.  Nothing here reads the device: the counts stay
tensors and join the step's one device-to-host copy.

On one rank of a domain decomposition (``parallel/sharding.py``) the pass
runs on the rank's owned rows: its halo rows (periodic-coded copies of
other ranks' particles) are neither members nor requests, though the
extrapolation reads them as fluid around a mirror node; a spawn takes
only the slots the caller leaves it (``usable``: dead slots that hold an
id of the global state's free pool, never a slot the halo refresh
writes); the advanced refilling fills only the holes of its own slab; the
calculated zsurf and the AWAS column mass are reduced over
the ranks through the callbacks given (JAX's ``pmax`` and ``psum``).

Like the reference, a restart with inout zones is refused
(`JSphCpuSingle_InOut.cpp:76`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph
from ..ops import celldiv as cd
from ..ops import eos
from ..ops import kernels as K
from .devconst import vec as _vec
from .periodic import _id_rank
from .relaxzone import GridVel, _interp


@dataclass(frozen=True)
class InOutZone:
    """One open-boundary zone (reference `JSphInOutZone`): the box spanned
    by the inlet plane (through ``p0``, normal ``direction`` pointing into
    the fluid domain) and ``layers*dp`` of depth behind it, bounded
    laterally by ``tangent1``/``size1`` (and ``tangent2``/``size2`` in 3D)
    or, with ``shape`` "circle", by a disc of ``radius``."""
    p0: tuple
    direction: tuple
    layers: int
    tangent1: tuple
    size1: float
    tangent2: tuple = (0.0, 1.0, 0.0)
    size2: float = 0.0
    shape: str = "rect"
    radius: float = 0.0
    # velocity: v(z,t) = (c0 + c1*z + c2*z^2) * timeseries(t)
    vel_profile: tuple = (0.0, 0.0, 0.0)
    vel_times: tuple = ()       # ((t, factor), ...)
    vel_grid: GridVel | None = None
    rho_mode: str = "constant"  # constant | hydrostatic
    vel_extrap: bool = False
    rho_extrap: bool = False
    zsurf: float = 0.0
    zsurf_times: tuple = ()
    zsurf_calc: bool = False
    capture_fluid: bool = True
    refill: str = "simplefull"  # simplefull | simplezsurf | advanced
    refillrate: int = 10
    awas: "InOutAwas | None" = None


@dataclass(frozen=True)
class InOutAwas:
    """AWAS correction of a zone's imposed velocity (`JSphInOutVelAwas`,
    JSphInOutVelAwas.cpp:147-161): velcorr = +-(zgauge - ztarget) *
    sqrt(-g/depth), zgauge the column-mass elevation at the gauge over the
    bed ``z0``."""
    inletmode: bool = True
    startawas: float = 0.0
    depth: float = 1.0
    zsurf_t: tuple = ()
    zsurf_v: tuple = ()
    gauge_x: float = 0.0
    gauge_y: float = 0.0
    z0: float = 0.0
    band: float = 0.0

    def ztarget(self, tabs):
        return _interp(tabs, _vec(self.zsurf_t, tabs),
                       _vec(self.zsurf_v, tabs))


@dataclass(frozen=True)
class InOutCfg:
    zones: tuple                # (InOutZone, ...): zone z has tag z+1
    n_usable: int = 0           # free slots only among ids below (0: all)
    determlimit: float = 1e3    # MLS gate of the extrapolated modes

    def __post_init__(self):
        if len(self.zones) > td.MAX_INOUT_ZONES:
            raise ValueError(f"at most {td.MAX_INOUT_ZONES} inout zones")


def _unit(v):
    v = np.asarray(v, np.float64)
    return tuple(v / np.linalg.norm(v))


def _tensor(v, like):
    return _vec(_unit(v), like)


def zone_points(zone: InOutZone, csp: CteSph):
    """Initial member lattice of a zone (numpy f64): ``layers`` planes of
    dp-spaced points, layer l at signed distance -l*dp, the first ON the
    inlet plane (`JSphInOutPoints`, line/box/circle)."""
    dp = csp.dp
    d = np.asarray(_unit(zone.direction))
    t1 = np.asarray(_unit(zone.tangent1))
    if zone.shape == "circle":
        r = zone.radius
        nr = max(1, int(round(2 * r / dp)))
        u = (np.arange(nr + 1) - nr / 2.0) * dp
        t2 = np.asarray(_unit(zone.tangent2))
        U1, U2 = np.meshgrid(u, u, indexing="ij")
        keep = U1 ** 2 + U2 ** 2 <= (r + 1e-9) ** 2
        lat = (U1[keep][:, None] * t1[None, :]
               + U2[keep][:, None] * t2[None, :])
    else:
        n1 = max(1, int(round(zone.size1 / dp)))
        u1 = (np.arange(n1) - (n1 - 1) / 2.0) * dp
        if csp.simulate2d or zone.size2 <= 0:
            lat = u1[:, None] * t1[None, :]
        else:
            t2 = np.asarray(_unit(zone.tangent2))
            n2 = max(1, int(round(zone.size2 / dp)))
            u2 = (np.arange(n2) - (n2 - 1) / 2.0) * dp
            lat = (u1[:, None, None] * t1[None, None, :]
                   + u2[None, :, None] * t2[None, None, :]).reshape(-1, 3)
    p0 = np.asarray(zone.p0, np.float64)
    pts = np.concatenate([p0[None, :] - l * dp * d[None, :] + lat
                          for l in range(zone.layers)], axis=0)
    if zone.rho_mode == "hydrostatic" and zone.zsurf:
        pts = pts[pts[:, 2] <= zone.zsurf + 0.25 * dp]
    return pts


def _free_ids(cfg: InOutCfg, code, idp):
    """Free slots (not active, id below ``n_usable``)."""
    free = ~td.is_active(code)
    if cfg.n_usable:
        free = free & (idp < cfg.n_usable)
    return free


def init_inout(cfg: InOutCfg, csp: CteSph, st):
    """The zones' initial members in free slots of ``st``, zone by zone,
    the k-th point into the free slot of the k-th smallest id, with the
    imposed values at t = 0 (host side, at setup: ``InOutInit``,
    `JSphCpuSingle_InOut.cpp:72`).  Returns the state."""
    dev = st.pos.device
    pos = st.pos.cpu().numpy().astype(np.float64)
    vel = st.vel.cpu().numpy().astype(np.float64)
    rho = st.rho.cpu().numpy().astype(np.float64)
    code = st.code.cpu().numpy().copy()
    idp = st.idp.cpu().numpy()
    free = _free_ids(cfg, torch.from_numpy(code),
                     torch.from_numpy(idp)).numpy()
    free = np.flatnonzero(free)
    free = free[np.argsort(idp[free], kind="stable")]
    k = 0
    for zi, zone in enumerate(cfg.zones):
        pts = zone_points(zone, csp)
        m = len(pts)
        if k + m > len(free):
            raise ValueError(
                f"not enough free particle slots for inout zone {zi}: need "
                f"{k + m}, have {len(free)}: raise the state capacity "
                f"(reference analog: ResizeParticlesSize on InOutInit)")
        sl = free[k:k + m]
        k += m
        pos[sl] = pts
        code[sl] = td.code_set_inout(td.code_make(td.TYPE_FLUID, 0), zi + 1)
        v, r = _imposed(zone, csp, torch.tensor(pts, dtype=torch.float32),
                        torch.zeros((), dtype=torch.float32))
        vel[sl] = v.numpy()
        rho[sl] = r.numpy()

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    upd = dict(pos=f32(pos), vel=f32(vel), rho=f32(rho),
               code=torch.tensor(code, device=dev))
    if st.velm1 is not None:
        upd["velm1"] = upd["vel"]
    if st.rhom1 is not None:
        upd["rhom1"] = upd["rho"]
    return replace(st, **upd)


def _counted(code, images):
    """(code, kept): the codes of the state's rows followed by those of
    the periodic ``images`` (:func:`inout_step`'s), and the rows the
    column sums count: the owned rows and the images of owned rows."""
    owned = ~td.is_periodic(code)
    if images is None:
        return code, owned
    return (torch.cat([code, images["code"]]),
            torch.cat([owned, images["counted"]]))


def _zsurf_at(zone: InOutZone, csp: CteSph, tabs, st=None,
              reduce_max=None, images=None):
    """The zone's zsurf (JSphInOutZsurf) at ``tabs`` (0-d f32): fixed,
    from the time series, or calculated as the highest owned fluid z over
    the zone's lateral footprint in a 2*kernelsize band ahead of the plane,
    periodic images included (``reduce_max(x) -> x``: the maximum over the
    ranks)."""
    if zone.zsurf_times:
        return _interp(tabs, _vec([t for t, _ in zone.zsurf_times], tabs),
                       _vec([z for _, z in zone.zsurf_times], tabs))
    if zone.zsurf_calc and st is not None:
        pos = st.pos if images is None else torch.cat([st.pos,
                                                       images["pos"]])
        code, kept = _counted(st.code, images)
        rel = pos - _vec(zone.p0, pos)[None, :]
        s = rel @ _tensor(zone.direction, pos)
        m = (td.is_fluid(code) & td.is_active(code) & kept
             & (s >= 0.0)
             & (s <= 2.0 * csp.kernelsize)
             & ((rel @ _tensor(zone.tangent1, pos)).abs()
                <= zone.size1 * 0.5 + 0.5 * csp.dp))
        if not csp.simulate2d and zone.size2 > 0:
            m = m & ((rel @ _tensor(zone.tangent2, pos)).abs()
                     <= zone.size2 * 0.5 + 0.5 * csp.dp)
        zc = torch.where(m, pos[:, 2], float(zone.zsurf)).amax()
        return zc if reduce_max is None else reduce_max(zc)
    return torch.tensor(zone.zsurf, dtype=torch.float32,
                        device=tabs.device)


def _imposed(zone: InOutZone, csp: CteSph, pos, tabs, zsurf=None):
    """Imposed (vel, rho) at the positions at time ``tabs`` (the
    reference's `JSphInOutVel` analytical modes and the zone's rhop
    modes)."""
    z = pos[:, 2]
    if zone.vel_grid is not None:
        gvx, gvz = zone.vel_grid.at(pos, tabs)
        vel = torch.stack([gvx, torch.zeros_like(gvx), gvz], dim=-1)
    else:
        c0, c1, c2 = zone.vel_profile
        mag = c0 + c1 * z + c2 * z * z
        if zone.vel_times:
            mag = mag * _interp(tabs, _vec([t for t, _ in zone.vel_times], z),
                                _vec([v for _, v in zone.vel_times], z))
        vel = mag[:, None] * _tensor(zone.direction, pos)[None, :]
    if zone.rho_mode == "hydrostatic":
        zs = zone.zsurf if zsurf is None else zsurf
        rho = eos.hydrostatic_rho(csp, z, zs)
    else:
        rho = torch.full_like(z, csp.rhopzero)
    return vel, rho


def _awas_velcorr(aw: InOutAwas, csp: CteSph, pos, code, tabs,
                  reduce_sum=None, images=None):
    """The zone's AWAS velocity correction at ``tabs`` (0-d), from the
    owned fluid's column mass, periodic images included (``reduce_sum(x)
    -> x``: the sum over the ranks)."""
    dp = csp.dp
    band = aw.band or 1.5 * dp
    if images is not None:
        pos = torch.cat([pos, images["pos"]])
    code, kept = _counted(code, images)
    fluid = td.is_fluid(code) & td.is_active(code) & kept
    inband = fluid & ((pos[:, 0] - aw.gauge_x).abs() <= band)
    if csp.simulate2d:
        colarea = 2.0 * band
        vol_per = dp ** 2
    else:
        inband = inband & ((pos[:, 1] - aw.gauge_y).abs() <= 0.5 * dp)
        colarea = 2.0 * band * dp
        vol_per = dp ** 3
    colmass = torch.where(inband, vol_per, 0.0).sum()
    if reduce_sum is not None:
        colmass = reduce_sum(colmass)
    zgauge = aw.z0 + colmass / colarea
    gz = float(csp.gravity[2]) if csp.gravity[2] else -9.81
    coefdepth = math.sqrt(-gz / aw.depth)
    diff = zgauge - aw.ztarget(tabs)
    corr = (diff if aw.inletmode else -diff) * coefdepth
    return torch.where(tabs >= aw.startawas, corr, 0.0)


def any_extrap(cfg: InOutCfg) -> bool:
    return any(z.vel_extrap or z.rho_extrap for z in cfg.zones)


def can_spawn(zone: InOutZone) -> bool:
    """Whether the zone may spawn particles: the advanced refilling, an
    extrapolated, gridded or timed velocity, or a profile that points along
    the zone's direction (into the fluid) at ``p0``.  A fixed profile
    pointing out of the domain (an outlet) only destroys and captures."""
    if (zone.refill == "advanced" or zone.vel_extrap
            or zone.vel_grid is not None or zone.vel_times):
        return True
    c0, c1, c2 = zone.vel_profile
    z = zone.p0[2]
    return c0 + c1 * z + c2 * z * z > 0.0


def extrap_cap(cfg: InOutCfg, csp: CteSph) -> int:
    """Members of the extrapolated zones one pass takes (a static size, so
    no count is read): 1.5x the zones' lattices and 64.  Members beyond
    count into the step's inout overflow."""
    m = sum(len(zone_points(z, csp)) for z in cfg.zones
            if z.vel_extrap or z.rho_extrap)
    return int(math.ceil(1.5 * m)) + 64


def inout_extrapolate(cfg: InOutCfg, csp: CteSph, dom: cd.Domain,
                      cells: cd.CellDiv, st, max_pairs: int = 1 << 22,
                      order=None, images=None):
    """Ghost-node extrapolation of the zones with extrapolated velocity or
    density (`InteractionInOutExtrap_Double`, JSphCpu_InOut.cpp:55-238):
    each member mirrors across its inlet plane into the fluid, the
    non-inout fluid within kernelsize of the mirror node (halo rows
    included) builds the
    first-order MLS system (3x3 in 2D, 4x4 in 3D) with four right-hand
    sides (mass-weighted density, volume-weighted velocity), and the
    corrected field is evaluated back at the member; below ``determlimit``
    the Shepard value, and with no fluid around the current value.

    The candidates come from the neighbour rows of the step's layout
    (``celldiv.point_ranges``, valid under the skin contract, as the mDBC
    pre-pass reads them; the JAX package divides afresh).  ``order``: the
    state's slot of each of the layout's rows when the state is not in the
    layout's order (a divide of its own positions, ``cells.order``; None
    when it is).  ``images``: the periodic images of the state's rows
    (:func:`inout_step`'s), which are sources too, as JAX's ghosts in its
    state are; the state's and the images' rows are then divided afresh
    together and ``cells`` is not read.  Sizes are
    static (:func:`extrap_cap` members, ``celldiv.row_cap`` slots a row), so
    nothing is read to the host.  Returns (vel, rho, overflow): members
    beyond the cap plus members with a longer row."""
    pos, vel, rho, code = st.pos, st.vel, st.rho, st.code
    n = pos.shape[0]
    f32, dev = pos.dtype, pos.device
    active = td.is_active(code)
    itag = td.code_inout(code)
    # the sources: the state's rows, then any periodic images
    spos, svel, srho, scode = pos, vel, rho, code
    if images is not None:
        spos, svel, srho, scode = (
            torch.cat([a, images[k]]) for a, k in (
                (pos, "pos"), (vel, "vel"), (rho, "rho"), (code, "code")))
        cells, _ = cd.divide_cells(dom, spos, scode)
        order = cells.order
    sel = torch.zeros(n, dtype=torch.bool, device=dev)
    wantv = torch.zeros_like(sel)
    wantr = torch.zeros_like(sel)
    ghost = pos
    owned = active & ~td.is_periodic(code)
    for zi, zone in enumerate(cfg.zones):
        if not (zone.vel_extrap or zone.rho_extrap):
            continue
        member = (itag == zi + 1) & owned
        d = _tensor(zone.direction, pos)
        s = (pos - _vec(zone.p0, pos)[None, :]) @ d
        ghost = torch.where(member[:, None], pos - (2.0 * s)[:, None] * d,
                            ghost)
        sel = sel | member
        if zone.vel_extrap:
            wantv = wantv | member
        if zone.rho_extrap:
            wantr = wantr | member
    cap = extrap_cap(cfg, csp)
    L = cd.row_cap(csp, dom)
    # the members, compacted in slot order into ``cap`` rows
    rank = torch.cumsum(sel, 0) - 1
    idx = torch.full((cap + 1,), n, dtype=torch.long, device=dev)
    idx[torch.where(sel & (rank < cap), rank, cap)] = torch.arange(n,
                                                                   device=dev)
    idx = idx[:cap]
    used = idx < n
    idxc = torch.clamp(idx, max=n - 1)
    gpos = ghost[idxc]
    starts, lens = cd.point_ranges(dom, cells, gpos)
    lens = torch.where(used[:, None], lens, 0)
    overflow = (torch.clamp(sel.sum() - cap, min=0)
                + ((lens > L).any(dim=1) & used).sum()).to(torch.int32)
    lens = torch.clamp(lens, max=L)
    fluid_c = td.is_fluid(scode) & td.is_active(scode) & ~td.is_inout(scode)

    dims = [0, 2] if csp.simulate2d else [0, 1, 2]
    d = 1 + len(dims)
    mass = csp.massfluid
    amat = torch.zeros((cap, d, d), dtype=f32, device=dev)
    b = torch.zeros((cap, d, 4), dtype=f32, device=dev)
    R = starts.shape[1]
    B = max(1, max_pairs // (R * L))
    off = torch.arange(L, device=dev)
    for i0 in range(0, cap, B):
        t = torch.arange(i0, min(i0 + B, cap), device=dev)
        valid = (off < lens[t, :, None]).reshape(len(t), -1)
        j = torch.where(valid.reshape(len(t), R, L),
                        starts[t, :, None] + off, 0).reshape(len(t), -1)
        if order is not None:
            j = order[j]
        dr = gpos[t, None, :] - spos[j]
        rr2 = (dr * dr).sum(dim=-1)
        pair = (valid & fluid_c[j] & (rr2 <= csp.kernelsize2)
                & (rr2 >= 1e-18))
        pw = pair.to(f32)
        rr2s = torch.where(pair, rr2, csp.kernelsize2)
        wab = pw * K.kernel_wab(csp, rr2s)
        fr = (pw * K.kernel_fac(csp, rr2s))[..., None] * dr[..., dims]
        volp2 = mass / srho[j]
        vwab = wab * volp2
        # rows [Shepard, d/dx_a]; columns [1, dx_a]
        rows = torch.cat([vwab[..., None], fr * volp2[..., None]], dim=-1)
        cols = torch.cat([torch.ones_like(vwab)[..., None], dr[..., dims]],
                         dim=-1)
        amat[t] = torch.einsum("bpi,bpj->bij", rows, cols)
        # right-hand sides: [mass*wab, mass*fr] (density) and the rows
        # times each velocity component
        bw = torch.cat([(mass * wab)[..., None], mass * fr], dim=-1)
        b[t] = torch.cat([bw.sum(dim=1)[..., None],
                          torch.einsum("bpi,bpq->biq", rows, svel[j])], dim=-1)
    determ = torch.linalg.det(amat)
    ok1 = determ.abs() >= cfg.determlimit
    eye = torch.eye(d, dtype=f32, device=dev)
    sol = torch.linalg.solve_ex(torch.where(ok1[:, None, None], amat, eye),
                                b)[0]
    dposd = (pos[idxc] - gpos)[:, dims]
    val1 = sol[:, 0, :] - (dposd[:, :, None] * sol[:, 1:, :]).sum(dim=1)
    a11 = amat[:, 0, 0]
    ok0 = a11 > 0
    val0 = b[:, 0, :] / torch.where(ok0, a11, 1.0)[:, None]
    cur = torch.cat([rho[idxc, None], vel[idxc]], dim=1)
    val = torch.where(ok1[:, None], val1,
                      torch.where(ok0[:, None], val0, cur))
    full = torch.zeros((n + 1, 4), dtype=f32, device=dev)
    full[idx] = val
    full = full[:n]
    new_rho = torch.where(wantr, full[:, 0], rho)
    new_vel = torch.where(wantv[:, None], full[:, 1:], vel)
    if csp.simulate2d:
        new_vel = new_vel.clone()
        new_vel[:, 1] = 0.0
    return new_vel, new_rho, overflow


def inout_step(cfg: InOutCfg, csp: CteSph, st, tabs, nstep=None, dom=None,
               cells=None, usable=None, owns=None, reduce_max=None,
               reduce_sum=None, order=None, images=None):
    """One transition pass of every zone at time ``tabs`` (0-d), the
    step's ``nstep`` (a host int: the advanced refilling's tick; None ticks
    always).  ``dom`` and ``cells``, the step's layout, serve the
    extrapolated modes (``order`` as for :func:`inout_extrapolate`).  One rank of a domain decomposition passes
    ``usable`` ((n,) bool, the slots a spawn may take), ``owns(pos) ->
    (m,) bool`` (the points its slab owns: the advanced refilling fills
    only their holes) and the reductions
    over the ranks of the calculated zsurf and the AWAS column mass
    (``reduce_max(x) -> x``, ``reduce_sum(x) -> x``).  Under periodic
    boundaries ``images`` (``periodic.images``: pos, vel, rho, code,
    counted) are the periodic images of the state's rows, which JAX keeps
    in its state as ghosts: they are sources of the calculated zsurf, the
    AWAS column and the extrapolation, as JAX's ghosts are, and take the
    transitions JAX's ghosts take (a member past its plane becomes fluid,
    one out through the back dies; no capture), but neither spawn nor take
    a value: the state's rows do that.  Returns (state,
    overflow, filled): the 0-d int32 count of spawn requests that found no
    free slot (and extrapolation members beyond its cap), and a 0-d bool,
    whether a slot was filled."""
    pos, vel, rho, code = st.pos, st.vel, st.rho, st.code
    n = pos.shape[0]
    dev = pos.device
    dp = csp.dp
    idp = st.idp
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    filled = torch.zeros((), dtype=torch.bool, device=dev)
    slots = torch.arange(n, device=dev)

    def take(code, req, rank):
        """(recv, src, overflow, any): the slots that receive a request
        (the k-th request by ``rank`` goes to the free slot of the k-th
        smallest id), the index of each one's request, the requests that
        found no free slot, and whether any was placed."""
        free = _free_ids(cfg, code, idp)
        if usable is not None:
            free = free & usable
        nfree = free.sum(dtype=torch.int32)
        nreq = req.sum(dtype=torch.int32)
        frank = _id_rank(free, idp, n)
        slot_of_rank = torch.full((n + 1,), n, dtype=torch.long, device=dev)
        slot_of_rank[torch.where(free, frank, n).long()] = slots
        ok = req & (rank < nfree)
        dst = torch.where(ok, slot_of_rank[torch.clamp(rank, 0, n - 1)
                                           .long()], n)
        src = torch.full((n + 1,), -1, dtype=torch.long, device=dev)
        src[dst] = torch.arange(req.shape[0], device=dev)
        src = src[:n]
        return src >= 0, torch.clamp(src, min=0), \
            torch.clamp(nreq - nfree, min=0), ok.any()

    images0 = images
    for zi, zone in enumerate(cfg.zones):
        tag = zi + 1
        d = _tensor(zone.direction, pos)
        t1 = _tensor(zone.tangent1, pos)
        p0 = _vec(zone.p0, pos)
        width = zone.layers * dp
        rel = pos - p0[None, :]
        s = rel @ d
        if images is not None:
            icode = images["code"]
            imember = (td.code_inout(icode) == tag) & td.is_active(icode)
            si = (images["pos"] - p0[None, :]) @ d
            icode = torch.where(imember & (si > 0.0),
                                td.code_set_inout(icode, 0), icode)
            icode = torch.where(imember & (si < -width), td.code_set_special(
                icode, td.SPECIAL_OUT_MOVE), icode)
            images = dict(images, code=icode)
        # a rank's halo rows are other ranks' particles: not members
        owned = td.is_active(code) & ~td.is_periodic(code)
        member = (td.code_inout(code) == tag) & owned
        if zone.shape == "circle":
            t2 = _tensor(zone.tangent2, pos)
            u1, u2 = rel @ t1, rel @ t2
            lat_ok = u1 * u1 + u2 * u2 <= (zone.radius + 0.5 * dp) ** 2
        else:
            lat_ok = (rel @ t1).abs() <= (zone.size1 * 0.5 + 0.5 * dp)
            if not csp.simulate2d and zone.size2 > 0:
                t2 = _tensor(zone.tangent2, pos)
                lat_ok = lat_ok & ((rel @ t2).abs()
                                   <= (zone.size2 * 0.5 + 0.5 * dp))

        # 1) member -> fluid at the inlet plane (strictly past it: the
        # first lattice layer sits ON the plane)
        cross = member & (s > 0.0)
        code = torch.where(cross, td.code_set_inout(code, 0), code)
        # 2) members leaving through the back are destroyed
        out_back = member & (s < -width)
        code = torch.where(out_back,
                           td.code_set_special(code, td.SPECIAL_OUT_MOVE),
                           code)
        # 3) plain fluid inside the zone volume is captured
        if zone.capture_fluid:
            plain = (td.is_fluid(code) & ~td.is_inout(code)
                     & td.is_normal(code))
            cap = plain & (s < 0.0) & (s >= -width) & lat_ok
            code = torch.where(cap, td.code_set_inout(code, tag), code)

        if zone.refill != "advanced":
            # 4) conveyor: a replacement one width behind each crosser;
            # simplezsurf only below the zone's zsurf
            spawn_pos = pos - width * d[None, :]
            req = cross
            if zone.refill == "simplezsurf" and (
                    zone.zsurf or zone.zsurf_times or zone.zsurf_calc):
                zs = _zsurf_at(zone, csp, tabs, st, reduce_max, images0)
                req = req & (spawn_pos[:, 2] <= zs + 0.25 * dp)
            recv, src, ovf, any_ok = take(code, req, _id_rank(req, idp, n))
            newcode = td.code_set_inout(
                td.code_set_special(code, td.SPECIAL_NORMAL), tag)
            pos = torch.where(recv[:, None], spawn_pos[src], pos)
            vel = torch.where(recv[:, None], vel[src], vel)
            rho = torch.where(recv, rho[src], rho)
            code = torch.where(recv, newcode[src], code)
            overflow = overflow + ovf
            filled = filled | any_ok
        elif nstep is None or nstep % max(zone.refillrate, 1) == 0:
            # 4') advanced refilling: every hole of the zone's dp lattice
            # without a member within dp/2 gets one (reverse flows,
            # depleting outlets)
            latpts = torch.tensor(zone_points(zone, csp), dtype=pos.dtype,
                                  device=dev)
            u1span = int(round(zone.size1 / dp)) + 3
            nkey = zone.layers * 2 * u1span
            use2 = not csp.simulate2d and zone.size2 > 0
            if use2:
                t2z = _tensor(zone.tangent2, pos)
                u2span = int(round(zone.size2 / dp)) + 3
                nkey = nkey * 2 * u2span

            def key(p):
                r = p - p0[None, :]
                k = (torch.round(-(r @ d) / dp).to(torch.int32) * (2 * u1span)
                     + (torch.round(r @ t1 / dp).to(torch.int32) + u1span))
                if use2:
                    k = k * (2 * u2span) + (torch.round(r @ t2z / dp)
                                            .to(torch.int32) + u2span)
                return k

            # halo members cover holes too; a rank fills only its own
            memb = (td.code_inout(code) == tag) & td.is_active(code)
            covered = torch.zeros(nkey + 1, dtype=torch.int32, device=dev)
            covered[torch.where(memb, torch.clamp(key(pos), 0, nkey - 1),
                                nkey).long()] = 1
            hole = covered[torch.clamp(key(latpts), 0, nkey - 1).long()] == 0
            if owns is not None:
                hole = hole & owns(latpts)
            recv, src, ovf, any_ok = take(
                code, hole, torch.cumsum(hole, 0, dtype=torch.int32) - 1)
            newc = td.code_set_inout(td.code_make(td.TYPE_FLUID, 0), tag)
            pos = torch.where(recv[:, None], latpts[src], pos)
            vel = torch.where(recv[:, None], 0.0, vel)
            rho = torch.where(recv, float(csp.rhopzero), rho)
            code = torch.where(recv, newc, code)
            overflow = overflow + ovf
            filled = filled | any_ok

        # 5) impose the zone's velocity and density on every member (the
        # extrapolated quantities come from the pass below)
        member2 = ((td.code_inout(code) == tag) & td.is_active(code)
                   & ~td.is_periodic(code))
        iv, ir = _imposed(zone, csp, pos, tabs, zsurf=_zsurf_at(
            zone, csp, tabs, st, reduce_max, images0))
        if zone.awas is not None and not zone.vel_extrap:
            # subtracted (InterpolateVelCpu, JSphInOutGridData.cpp:383)
            vc = _awas_velcorr(zone.awas, csp, pos, code, tabs, reduce_sum,
                               images)
            iv = iv - vc * d[None, :]
        if not zone.vel_extrap:
            vel = torch.where(member2[:, None], iv, vel)
        if not zone.rho_extrap:
            rho = torch.where(member2, ir, rho)

    if any_extrap(cfg):
        if dom is None or cells is None:
            raise ValueError("inout zones with extrapolated vel/rhop modes "
                             "need the domain and the layout")
        vel, rho, ovf = inout_extrapolate(
            cfg, csp, dom, cells, replace(st, pos=pos, vel=vel, rho=rho,
                                          code=code), order=order,
            images=images)
        overflow = overflow + ovf

    upd = dict(pos=pos, vel=vel, rho=rho, code=code)
    if st.velm1 is not None:
        upd["velm1"] = torch.where(td.is_inout(code)[:, None], vel, st.velm1)
    if st.rhom1 is not None:
        upd["rhom1"] = torch.where(td.is_inout(code), rho, st.rhom1)
    return replace(st, **upd), overflow, filled


def slots_required(cfg: InOutCfg, csp: CteSph, t_horizon: float = 0.0) -> int:
    """Slot budget: the zones' initial members plus the inflow over
    ``t_horizon`` at the profile's peak velocity."""
    total = 0
    for zone in cfg.zones:
        pts = len(zone_points(zone, csp))
        total += pts
        if t_horizon > 0:
            c0, c1, c2 = zone.vel_profile
            zs = [zone.p0[2] - zone.size1, zone.p0[2] + zone.size1]
            vmax = max(abs(c0 + c1 * z + c2 * z * z) for z in zs)
            perlayer = pts / max(zone.layers, 1)
            total += int(math.ceil(vmax * t_horizon / csp.dp) * perlayer)
    return total

