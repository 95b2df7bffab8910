"""Domain decomposition on ``torch.distributed``: x-slabs, migration, halo
rows and global reductions.

Counterpart of `dualsphysics_multilayer_tpu/parallel/sharding.py` (the
reference's MGDIV_X design, which it reserves but never ships): the global
cell grid is split into **slabs along x**, one rank per slab and one
process per rank (``parallel/group.py``).  Each rank holds ``n_ext =
n_local + 2*ghost_cap`` particle slots and runs the port's own steps
(``models/wcsph.py``, ``models/nnewtonian.py``) on them, so kernels 1 and
4-6 run on each rank's rows unchanged; the decomposition enters those
steps through one object, :class:`SlabRank` (their ``dd`` argument):

* **Layout.**  The port's one layout, the cell-sorted divide rebuilt when
  the skin contract breaks, per slab: JAX's amortized rowdiv path
  (``_shard_rebuild``, ``_refresh_ghosts``), not its group-run path.  At a
  rebuild (every rank at the same step: the flag is reduced with MAX before
  the step's one copy) a rank kills its stale ghosts, **migrates** the
  particles whose x-cell belongs to another slab to the adjacent rank
  (:func:`migrate`), sends the owned rows of its ``halo`` edge cell
  columns to its neighbours as **ghost rows** (:func:`exchange_ghosts`;
  ``halo`` 1, or 2 for the NN pipeline and mDBC walls), and divides owned
  and ghost rows together on its slab's grid (:func:`slab_domain`:
  ``ncx_loc + 2*halo`` columns), recording the slots each neighbour's
  ghosts came from and landed in (:class:`HaloState`).
* **Interactions.**  Before each one the ghost rows' values are refreshed
  in their recorded slots by one exchange (:func:`_refresh_ghosts`), with
  no divide: the skin contract keeps the ghost set sufficient, as it keeps
  the layout valid.  Under mDBC the pre-pass runs between two refreshes.
  A slab without a cell skin (cells of the kernel size, ``wcsph.skinless``)
  has no such contract: its rebuild, at every step, migrates and divides
  the owned rows, and before each interaction the stale ghost rows die and
  fresh ones are exchanged (:meth:`SlabRank.exchange`, JAX's
  ``make_sharded_step``), which the interaction divides with the owned
  rows (``wcsph.fresh_interaction``).
  Ghost rows carry the periodic special code, so they stay out of AceMax,
  the floating sums, the rebuild test and the inlet/outlet pass, and
  whatever the integrators do to them is overwritten at the next refresh.
* **Open boundaries and DEM** (JAX's sharded step, `sharding.py:833-878`,
  `:911-968`), each on the same layout over kernel 1: y/z-periodic
  boundaries wrap the owned rows, refresh the ghost rows and image both
  in each interaction (``features/periodic.py``); DEM runs over owned and
  ghost rows, the owned ones its targets, its dt term among the MAX
  maxima; the inlet/outlet pass runs on the owned rows, a spawn landing
  in a dead slot that holds an id of the global state's free pool
  (:func:`spare_ids`, split between the ranks, and shared out again at
  every rebuild by :func:`_rebalance_pool` in proportion to the spawns
  each rank has made, so the ids of particles that die on a rank that
  does not spawn go back to the ranks that do), never
  in a slot the refresh writes nor the last one, and its calculated zsurf
  and AWAS column mass are reduced over the ranks.  Every overflow count
  of a step joins the one MAX of its rebuild flag.
* **Reductions.**  One ``all_reduce(MAX)`` of the stacked ``[velmax,
  acemax, viscdtmax(, viscetadtmax)]`` per interaction (JAX's three
  ``pmax``), one of ``[rebuild flag, overflow counts]`` per step, one MAX
  of each calculated zsurf and one SUM of each AWAS column mass of the
  inlet/outlet zones, one SUM of the free pool's table per rebuild when
  a zone can spawn, and one
  ``all_reduce(SUM)`` of the floating bodies' partial sums per rigid
  update, after which the body solve, the moorings and Chrono run
  replicated on every rank.
* **Static sizes.**  Migrants and ghosts travel in buffers of ``mig_cap``
  and ``ghost_cap`` rows per direction (one ``all_to_all_single`` with
  split sizes), padded with dead rows; rows beyond a capacity, or finding
  no free slot, are counted on the device into the step's overflow
  (``StepCarry.overflow_shard``), which fails the run: never silent.
  Every rank keeps its last slot dead, so an index list's padding always
  names a dead slot.  Dead slots hold id -1, except those holding an id
  of the free pool; migrants and ghost rows land only in slots of id -1,
  so no id is lost.

:class:`ShardedSimulation` runs the loop (the CLI's ``-shard[:N]``):
rank 0 is the calling process, saves PARTs after a gather ordered by id,
and runs the diagnostics on the gathered state; :func:`dryrun` steps JAX's
three dry-run cases over N ranks.  Refused here, each with a
``NotImplementedError`` naming it: x-periodic boundaries (JAX's own
words) and the wave paddles' AWAS (``Features.awas``), whose surface
measurement needs the columns of every slab (the JAX sharded step skips
it silently).  The neighbour-list mode is a single-device layout: the
sharded steps walk their slab's grid, as JAX's do.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph, TpBoundary, TpStep
from ..features.featureset import Features
from ..models import nnewtonian as NM
from ..models import wcsph as W
from ..models.wcsph import SimState
from ..ops import celldiv as cd
from ..ops.forces import SolverOpts
from . import group as G


@dataclass(frozen=True)
class ShardCfg:
    """Static sharding configuration (JAX ``ShardCfg``; its bucket fields
    ``cellcap``/``maxcells`` belong to the TPU layouts)."""
    ndev: int
    gdom: cd.Domain       # global cell grid (nc[0] divisible by ndev)
    ldom: cd.Domain       # slab grid (ncx_loc + 2*halo columns) at gdom's
    #                       posmin; rank r's own: slab_domain(cfg, r)
    n_local: int          # owned-particle capacity per rank
    mig_cap: int          # max migrants per direction per rebuild
    ghost_cap: int        # max ghost rows per direction
    # halo width in cells: 1 for first-order neighbourhoods; 2 for the NN
    # pipeline (the stress pass reads the ghosts' own neighbourhood field
    # eta) and mDBC walls (a ghost node reaches |normal| + kernelsize)
    halo: int = 1

    @property
    def ncx_loc(self) -> int:
        return self.gdom.nc[0] // self.ndev

    @property
    def n_ext(self) -> int:
        """Slots per rank: the owned capacity and room for the ghosts."""
        return self.n_local + 2 * self.ghost_cap


def make_shard_cfg(gdom: cd.Domain, ndev: int, n_local: int,
                   mig_cap: int = 0, ghost_cap: int = 0,
                   halo: int = 1) -> ShardCfg:
    """JAX's ``make_shard_cfg``: the grid grows in x until its columns
    split evenly (cells beyond the fluid stay empty); default capacities
    ``ghost_cap = max(256, halo*(n_local//4))`` and ``mig_cap = max(256,
    n_local//8)``, neither beyond ``n_local``."""
    ncx = gdom.nc[0]
    if ncx % ndev:
        ncx = int(math.ceil(ncx / ndev) * ndev)
        gdom = replace(gdom, nc=(ncx, gdom.nc[1], gdom.nc[2]))
    ncx_loc = ncx // ndev
    if not ghost_cap:
        ghost_cap = max(256, halo * (n_local // 4))
    if not mig_cap:
        mig_cap = max(256, n_local // 8)
    ghost_cap = min(ghost_cap, n_local)
    mig_cap = min(mig_cap, n_local)
    ldom = cd.Domain(posmin=gdom.posmin, scell=gdom.scell,
                     nc=(ncx_loc + 2 * halo, gdom.nc[1], gdom.nc[2]),
                     simulate2d=gdom.simulate2d)
    return ShardCfg(ndev=ndev, gdom=gdom, ldom=ldom, n_local=n_local,
                    mig_cap=mig_cap, ghost_cap=ghost_cap, halo=halo)


def slab_domain(cfg: ShardCfg, rank: int) -> cd.Domain:
    """Rank ``rank``'s grid: ``cfg.ldom`` with its origin ``halo`` columns
    left of the slab (JAX ``_shard_origin``; the port's domains carry their
    origin, so the kernels and the mDBC pre-pass take it as they are)."""
    g = cfg.gdom
    x0 = g.posmin[0] + (rank * cfg.ncx_loc - cfg.halo) * g.scell
    return replace(cfg.ldom, posmin=(x0, g.posmin[1], g.posmin[2]))


# ---------------------------------------------------------------------------
# rows: the state's per-particle fields packed bit for bit into int32 rows
# ---------------------------------------------------------------------------

_DEAD = td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE)
_OPT_ARRAYS = ("velm1", "rhom1", "spstau", "boundnormal", "motionvel")


def _names(st: SimState):
    return ["pos", "vel", "rho", "code", "idp", "pose"] + [
        k for k in _OPT_ARRAYS if getattr(st, k) is not None]


def _cols(t):
    """(m, w) int32 view of ``t`` (m, ...): float32 and int32 fields one
    column per element, int64 two."""
    t = t.reshape(t.shape[0], -1).contiguous()
    return t if t.dtype == torch.int32 else t.view(torch.int32)


def _code_col(st: SimState, names) -> int:
    """The column of the typecode in packed rows."""
    return sum(_cols(getattr(st, k)[:1]).shape[1]
               for k in names[:names.index("code")])


def _pack(st: SimState, names, rows):
    """(m, k) int32: the fields ``names`` of slots ``rows``, bit for bit."""
    return torch.cat([_cols(getattr(st, k)[rows]) for k in names], dim=1)


def _unpack(buf, st: SimState, names) -> dict:
    """The fields of packed rows ``buf``, shaped like ``st``'s."""
    out, c = {}, 0
    for k in names:
        like = getattr(st, k)
        w = (int(np.prod(like.shape[1:], dtype=np.int64))
             * like.element_size() // 4)
        col = buf[:, c:c + w].contiguous()
        if like.dtype != torch.int32:
            col = col.view(like.dtype)
        out[k] = col.reshape((buf.shape[0],) + tuple(like.shape[1:]))
        c += w
    return out


def _compact(flags, cap: int):
    """(rows (cap,), valid (cap,), overflow): the first ``cap`` flagged
    slots in slot order (JAX ``_pack``), the padding naming the last slot,
    which is always dead; ``overflow`` the flagged slots beyond ``cap``."""
    n = flags.shape[0]
    rank = torch.cumsum(flags.to(torch.int32), 0) - 1
    dst = torch.where(flags & (rank < cap), rank, cap).long()
    rows = torch.full((cap + 1,), n - 1, dtype=torch.long, device=flags.device)
    rows[dst] = torch.arange(n, device=flags.device)
    cnt = flags.sum()
    valid = torch.arange(cap, device=flags.device) < cnt
    return rows[:cap], valid, torch.clamp(cnt - cap, min=0)


def _plain_free(st: SimState):
    """(n,) bool: the dead slots of id -1 (no free-pool id), never the
    last one."""
    free = (st.code == _DEAD) & (st.idp < 0)
    free[st.n - 1] = False
    return free


def _merge_into_free(st: SimState, names, recv):
    """Write received rows into dead slots of id -1, never the last one
    (a slot holding a free-pool id keeps it).  Returns (state, dst (m,),
    overflow, received): ``dst`` the slot of each received row (the last
    slot where it is padding or found no room), ``received`` the valid
    rows."""
    n = st.n
    fields = _unpack(recv, st, names)
    valid = fields["code"] != _DEAD
    free = _plain_free(st)
    m = recv.shape[0]
    slots, _, _ = _compact(free, m)
    rrank = torch.cumsum(valid.to(torch.int32), 0) - 1
    can = valid & (rrank < free.sum())
    dst = torch.where(can, slots[torch.clamp(rrank, 0, m - 1)], n - 1)
    fields["code"] = torch.where(can, fields["code"], _DEAD)
    st = replace(st, **{k: getattr(st, k).index_put((dst,), v)
                        for k, v in fields.items()})
    return st, dst, (valid & ~can).sum(), valid.sum()


def _dead_rows(like: SimState, m: int) -> dict:
    """Fields of ``m`` dead slots (JAX ``shard_state``'s fill, with id
    -1)."""
    out = {}
    for k in _names(like):
        a = getattr(like, k)
        out[k] = torch.zeros((m,) + tuple(a.shape[1:]), dtype=a.dtype,
                             device=a.device)
    out["code"].fill_(_DEAD)
    out["pos"].fill_(-1e6)
    out["rho"].fill_(1000.0)
    out["idp"].fill_(-1)
    return out


# ---------------------------------------------------------------------------
# host-side distribution
# ---------------------------------------------------------------------------

def _owner(cfg: ShardCfg, x):
    """The rank owning x-coordinates ``x`` (numpy or torch): its x-cell's
    slab, clamped to the ranks."""
    g = cfg.gdom
    if torch.is_tensor(x):
        xcell = torch.floor((x - g.posmin[0]) / g.scell).long()
        return torch.clamp(torch.div(xcell, cfg.ncx_loc,
                                     rounding_mode="floor"), 0, cfg.ndev - 1)
    xcell = np.floor((x - g.posmin[0]) / g.scell).astype(np.int64)
    return np.clip(xcell // cfg.ncx_loc, 0, cfg.ndev - 1)


def shard_state(cfg: ShardCfg, st: SimState) -> SimState:
    """Distribute a canonical state into the (ndev*n_local) sharded layout
    by owner slab (JAX ``shard_state``, done once at the start): rank r's
    live particles, in their order, from row r*n_local, the rest dead;
    particles already excluded are left out, and the body state stays
    replicated."""
    names = _names(st)
    d = {k: getattr(st, k).cpu().numpy() for k in names}
    code = d["code"]
    live = ((code >> td.CODE_SPECIAL_SHIFT) & td.CODE_SPECIAL_MASK) \
        < td.SPECIAL_OUT_POS
    owner = _owner(cfg, d["pos"][:, 0])
    out = {k: np.zeros((cfg.ndev * cfg.n_local,) + a.shape[1:], a.dtype)
           for k, a in d.items()}
    out["code"][:] = _DEAD
    out["pos"][:] = -1e6
    out["rho"][:] = 1000.0
    for dev in range(cfg.ndev):
        sel = np.where(live & (owner == dev))[0]
        if len(sel) > cfg.n_local:
            raise ValueError(f"shard {dev} needs {len(sel)} slots > n_local="
                             f"{cfg.n_local}")
        lo = dev * cfg.n_local
        for k, a in d.items():
            out[k][lo:lo + len(sel)] = a[sel]
    dev = st.pos.device
    kw = {k: None for k in _OPT_ARRAYS}
    kw.update({k: torch.from_numpy(v).to(dev) for k, v in out.items()})
    return SimState(ft=st.ft, **kw)


def _pool_bounds(weight, total):
    """(ndev+1,) int64: the bounds of each rank's block of a free pool of
    ``total`` ids (0-d) in id order, in proportion to ``weight`` (ndev,)
    float64, evenly where it sums to 0 (one rule for :func:`spare_ids` and
    :func:`_rebalance_pool`)."""
    weight = torch.where(weight.sum() > 0, weight, torch.ones_like(weight))
    cuts = torch.round(torch.cumsum(weight, 0) / weight.sum() * total)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=cuts.device),
                      cuts.to(torch.int64)])


def _spawners(feats: Features | None):
    """(nzones+1,) bool by inout tag: the zones that can spawn
    (``features.inout.can_spawn``); None without such a zone."""
    from ..features import inout as IO
    if feats is None or feats.inout is None:
        return None
    can = [False] + [IO.can_spawn(z) for z in feats.inout.zones]
    return torch.tensor(can) if any(can) else None


def spare_ids(cfg: ShardCfg, st: SimState, feats: Features | None = None):
    """The ids of the global state's free pool (its inactive slots, those
    below ``InOutCfg.n_usable`` when set: the one-device run's free slots)
    split between the ranks without repeats, one int64 array a rank, in
    contiguous blocks of id order: in proportion to the members each rank
    owns at the start of the inout zones that can spawn, evenly without
    such members (:func:`_pool_bounds`).  A rank keeps its block in its
    dead slots, so each spawn takes an id that the one-device run could
    also have given, and no id is given twice."""
    from ..features import inout as IO
    code, idp = st.code.cpu(), st.idp.cpu()
    live = td.is_active(code)
    iocfg = feats.inout if feats is not None else None
    free = ~live if iocfg is None else IO._free_ids(iocfg, code, idp)
    ids = np.sort(idp[free].numpy())
    weight = torch.zeros(cfg.ndev, dtype=torch.float64)
    spawners = _spawners(feats)
    if spawners is not None:
        member = spawners[td.code_inout(code).long()] & live
        weight.index_add_(0, _owner(cfg, st.pos[member, 0].cpu()),
                          torch.ones(int(member.sum()), dtype=torch.float64))
    bounds = _pool_bounds(weight, len(ids))
    return np.split(ids, bounds[1:-1].numpy())


def _rank_state(cfg: ShardCfg, sharded: SimState, rank: int, device,
                spare) -> SimState:
    """Rank ``rank``'s ``n_ext`` slots: its ``n_local`` rows of the
    sharded layout and ``2*ghost_cap`` dead ones for the ghosts; its first
    dead slots hold the free-pool ids ``spare`` (:func:`spare_ids`), the
    other dead ones id -1."""
    lo = rank * cfg.n_local
    pad = _dead_rows(sharded, 2 * cfg.ghost_cap)
    own = {k: getattr(sharded, k)[lo:lo + cfg.n_local]
           for k in _names(sharded)}
    dead = own["code"] == _DEAD
    nth = torch.cumsum(dead.to(torch.int64), 0) - 1
    spare = torch.as_tensor(np.asarray(spare, np.int64))
    if len(spare) > int(dead.sum()):
        raise ValueError(f"shard {rank}: {len(spare)} free-pool ids for "
                         f"{int(dead.sum())} dead slots")
    own["idp"] = torch.where(dead, -1, own["idp"])
    pooled = dead & (nth < len(spare))
    own["idp"][pooled] = spare.to(own["idp"].device)[nth[pooled]]
    kw = {k: torch.cat([own[k], pad[k]]).to(device)
          for k in _names(sharded)}
    ft = sharded.ft
    if ft is not None:
        ft = type(ft)(**{k: v.to(device) for k, v in vars(ft).items()})
    return replace(sharded, ft=ft, **kw)


# ---------------------------------------------------------------------------
# migration, ghost selection, rebuild and refresh (one rank)
# ---------------------------------------------------------------------------

@dataclass
class HaloState:
    """The halo's fixed index lists between two rebuilds (JAX
    ``HaloState``): the slots whose rows go to each neighbour, and the
    slots the neighbours' ghosts landed in, in the order they arrive; the
    padding names the rank's last slot, which stays dead.  The skin
    contract that keeps the layout valid keeps this set sufficient: a
    particle within the kernel radius of an owned one before the next
    rebuild was within ``halo`` cells of the slab's edge at this one."""
    send_l: torch.Tensor      # (ghost_cap,) int64
    send_r: torch.Tensor
    slot_l: torch.Tensor      # (ghost_cap,) ghosts from the left neighbour
    slot_r: torch.Tensor

    def moved(self, slot_of) -> "HaloState":
        """The lists after the state's slots moved to ``slot_of`` (n,) (a
        divide's ``celldiv.slots_of``).  The padding stays the last slot:
        that slot is dead, so a stable divide sorts it last."""
        return HaloState(*(slot_of[x] for x in (
            self.send_l, self.send_r, self.slot_l, self.slot_r)))


def _halo_state(cfg: ShardCfg, n: int, device, send=None, landed=None,
                slot_of=None):
    """The HaloState of one ghost exchange (:func:`exchange_ghosts`'s
    ``send`` and ``landed``), its slots taken through ``slot_of`` when the
    state was divided since; without an exchange, padding only."""
    last = torch.full((cfg.ghost_cap,), n - 1, dtype=torch.long,
                      device=device)
    if send is None:
        return HaloState(last, last, last, last)
    move = (lambda x: x) if slot_of is None else (lambda x: slot_of[x])

    def sent(rows, val):
        return torch.where(val, move(rows), n - 1)

    def arrived(dst):
        return last if dst is None else torch.where(dst != n - 1, move(dst),
                                                    n - 1)

    return HaloState(send_l=sent(*send[0]), send_r=sent(*send[1]),
                     slot_l=arrived(landed[0]), slot_r=arrived(landed[1]))


def _kill_ghosts(st: SimState) -> SimState:
    """The state with its ghost rows dead (id -1)."""
    stale = td.is_periodic(st.code)
    return replace(st, code=torch.where(stale, _DEAD, st.code),
                   idp=torch.where(stale, -1, st.idp))


def _bounds(cfg: ShardCfg, rank: int):
    g = cfg.gdom
    lbnd = g.posmin[0] + rank * cfg.ncx_loc * g.scell
    return lbnd, lbnd + cfg.ncx_loc * g.scell


def migrate(cfg: ShardCfg, st: SimState, rank: int, group: G.Group):
    """Move the live particles whose owner slab changed to the adjacent
    rank (single-slab hops: the displacement bound that triggers the
    rebuild keeps them within one cell).  Live particles beyond the global
    grid in x become OUT_POS, as in JAX.  Returns (state, overflow,
    migrants received)."""
    g = cfg.gdom
    n = st.n
    code = st.code
    live = td.is_active(code) & ~td.is_periodic(code)
    xcell = torch.floor((st.pos[:, 0] - g.posmin[0]) / g.scell).long()
    out_x = live & ((xcell < 0) | (xcell >= g.nc[0]))
    code = torch.where(out_x, td.code_set_special(code, td.SPECIAL_OUT_POS),
                       code)
    live = live & ~out_x
    owner = _owner(cfg, st.pos[:, 0])
    st = replace(st, code=code)
    names = _names(st)
    rows_l, val_l, ov_l = _compact(live & (owner < rank), cfg.mig_cap)
    rows_r, val_r, ov_r = _compact(live & (owner > rank), cfg.mig_cap)
    from_l, from_r = group.exchange(
        _pack(st, names, rows_l) if rank > 0 else None,
        _pack(st, names, rows_r) if rank < group.world - 1 else None)
    # the rows sent free their slots; their ids live on elsewhere
    sent = torch.cat([torch.where(val_l, rows_l, n - 1),
                      torch.where(val_r, rows_r, n - 1)])
    st = replace(st, code=st.code.index_fill(0, sent, _DEAD),
                 idp=st.idp.index_fill(0, sent, -1))
    recv = [r for r in (from_l, from_r) if r is not None]
    ov, got = ov_l + ov_r, torch.zeros((), dtype=torch.long,
                                       device=st.pos.device)
    if recv:
        st, _, ovm, got = _merge_into_free(st, names, torch.cat(recv))
        ov = ov + ovm
    return st, ov, got


def exchange_ghosts(cfg: ShardCfg, st: SimState, rank: int,
                    group: G.Group):
    """Send the live rows within ``cfg.halo`` cells of each slab edge to
    that neighbour and land the neighbours' rows in free slots as ghosts
    (the periodic special code).  Returns (state, send, landed, overflow,
    ghost rows received, fluid ghost rows received): ``send`` the (rows,
    valid) sent to each side, ``landed`` the slots of each side's arrivals
    (None without a neighbour)."""
    lbnd, rbnd = _bounds(cfg, rank)
    reach = cfg.halo * cfg.gdom.scell
    live = td.is_active(st.code)
    x = st.pos[:, 0]
    names = _names(st)
    left, right = rank > 0, rank < group.world - 1
    rows_l, val_l, ov_l = _compact(live & (x < lbnd + reach) & left,
                                   cfg.ghost_cap)
    rows_r, val_r, ov_r = _compact(live & (x >= rbnd - reach) & right,
                                   cfg.ghost_cap)
    recv = group.exchange(_pack(st, names, rows_l) if left else None,
                          _pack(st, names, rows_r) if right else None)
    ov = ov_l + ov_r
    zero = torch.zeros((), dtype=torch.long, device=st.pos.device)
    nghost, nfluid = zero, zero
    landed = []
    ci = _code_col(st, names)
    for buf in recv:
        if buf is None:
            landed.append(None)
            continue
        code = buf[:, ci]
        ghost = code != _DEAD
        nfluid = nfluid + (ghost & td.is_fluid(code)).sum()
        buf = buf.clone()
        buf[:, ci] = torch.where(
            ghost, td.code_set_special(code, td.SPECIAL_PERIODIC), code)
        st, dst, ovm, got = _merge_into_free(st, names, buf)
        ov = ov + ovm
        nghost = nghost + got
        landed.append(dst)
    return (st, ((rows_l, val_l), (rows_r, val_r)), landed, ov, nghost,
            nfluid)


@dataclass(frozen=True)
class PoolPlan:
    """What :func:`_rebalance_pool` needs: the inout zones, which of them
    can spawn (by tag, :func:`_spawners`) and the most ids a rank enters
    (the global state's free pool at the start)."""
    cfg: object                 # features.inout.InOutCfg
    spawners: torch.Tensor      # (nzones+1,) bool
    cap: int


def _rebalance_pool(st: SimState, group: G.Group, pool: PoolPlan,
                    spawns):
    """The free pool shared out again between the ranks, in one SUM of a
    (world, cap+2) int64 table: each rank enters its ``spawns`` so far
    (0-d: spawns and spawn requests that found no slot), the members it
    owns of the zones that can spawn and up to ``pool.cap`` of its pool's
    ids, the lowest (any more stay where they are); the slots of the ids
    entered die, and each rank takes its block of the table's ids in id
    order (:func:`_pool_bounds`) into dead slots of id -1: in proportion
    to the spawns, or to the members before any spawn.  The ids of
    particles that died on a rank that does not spawn (an outlet's) so
    come back to the ranks that do, and a rank whose zone spawns a whole
    layer at once holds the pool as the one-device run does.  Returns
    (state, overflow: the ids that found no slot)."""
    from ..features import inout as IO
    n, dev = st.n, st.idp.device
    rank, world, cap = group.rank, group.world, pool.cap
    big = torch.iinfo(torch.int64).max
    pooled = IO._free_ids(pool.cfg, st.code, st.idp) & (st.idp >= 0)
    key, order = torch.sort(torch.where(pooled, st.idp.long(), big))
    key, order = key[:cap], order[:cap]
    give = key < big
    member = (pool.spawners.to(dev)[td.code_inout(st.code).long()]
              & td.is_active(st.code) & ~td.is_periodic(st.code))
    table = torch.zeros((world, cap + 2), dtype=torch.int64, device=dev)
    table[rank, 0] = spawns
    table[rank, 1] = member.sum()
    table[rank, 2:] = torch.where(give, key + 1, 0)
    table = group.all_reduce(table, "sum")
    ids = table[:, 2:].reshape(-1)
    ids = torch.sort(torch.where(ids > 0, ids - 1, big)).values
    weight = table[:, :2].to(torch.float64)
    weight = torch.where(weight[:, 0].sum() > 0, weight[:, 0], weight[:, 1])
    bounds = _pool_bounds(weight, (ids < big).sum())
    k = torch.arange(ids.shape[0], device=dev)
    mine = (k >= bounds[rank]) & (k < bounds[rank + 1])
    rows = torch.where(give, order, n - 1)
    st = replace(st, code=st.code.index_fill(0, rows, _DEAD),
                 idp=st.idp.index_fill(0, rows, -1))
    free = _plain_free(st)
    slots, _, _ = _compact(free, ids.shape[0])
    nth = torch.cumsum(mine.to(torch.int32), 0) - 1
    ok = mine & (nth < free.sum())
    dst = torch.where(ok, slots[torch.clamp(nth, 0, ids.shape[0] - 1)],
                      n - 1)
    idp = st.idp.index_put((dst,), torch.where(ok, ids, -1).to(st.idp.dtype))
    return replace(st, idp=idp), (mine & ~ok).sum()


def _shard_rebuild(cfg: ShardCfg, st: SimState, rank: int, group: G.Group,
                   dom: cd.Domain, pool: PoolPlan | None = None,
                   spawns=0, ghosts: bool = True):
    """One rank's rebuild (JAX ``_shard_rebuild``): stale ghosts die,
    owners migrate, the free pool is shared out again (``pool``, given
    when a zone can spawn, with the rank's ``spawns`` so far:
    :func:`_rebalance_pool`), fresh ghosts land in
    free slots (not with ``ghosts`` False: a slab without a cell skin
    exchanges them before each interaction), and owned and ghost rows are
    divided on the slab's grid ``dom``; the halo's index lists follow the
    state into its new slot order.  Returns (state, CellDiv, HaloState,
    overflow, [migrants, ghost rows, fluid ghost rows])."""
    n = st.n
    st, mig_ov, nmig = migrate(cfg, _kill_ghosts(st), rank, group)
    if pool is not None:
        st, pool_ov = _rebalance_pool(st, group, pool, spawns)
        mig_ov = mig_ov + pool_ov
    zero = torch.zeros((), dtype=torch.long, device=st.pos.device)
    send = landed = None
    gov = nghost = nfluid = zero
    if ghosts:
        st, send, landed, gov, nghost, nfluid = exchange_ghosts(cfg, st, rank,
                                                                group)
    cells, code = cd.divide_cells(dom, st.pos, st.code)
    st = replace(st, code=code).permuted(cells.order)
    halo = _halo_state(cfg, n, st.pos.device, send, landed,
                       cd.slots_of(cells))
    return st, cells, halo, mig_ov + gov, [nmig, nghost, nfluid]


def _refresh_ghosts(cfg: ShardCfg, st: SimState, halo: HaloState,
                    group: G.Group) -> SimState:
    """The ghost rows' values from their owners, in their recorded slots
    (JAX ``_refresh_ghosts``): one exchange, no divide.  A ghost whose
    owner left the run dies with it."""
    if group.world == 1:
        return st
    names = _names(st)
    rank = group.rank
    from_l, from_r = group.exchange(
        _pack(st, names, halo.send_l) if rank > 0 else None,
        _pack(st, names, halo.send_r) if rank < group.world - 1 else None)
    n = st.n
    for buf, slots in ((from_l, halo.slot_l), (from_r, halo.slot_r)):
        if buf is None:
            continue
        fields = _unpack(buf, st, names)
        code = fields["code"]
        alive = td.is_active(code) & (slots != n - 1)
        fields["code"] = torch.where(
            alive, td.code_set_special(code, td.SPECIAL_PERIODIC), _DEAD)
        fields["idp"] = torch.where(alive, fields["idp"], -1)
        st = replace(st, **{k: getattr(st, k).index_put((slots,), v)
                            for k, v in fields.items()})
    return st


class SlabRank:
    """One rank of the decomposition as the port's steps see it (their
    ``dd``): its slab's grid ``dom``, the rebuild, the refresh, the fresh
    exchange of a slab without a cell skin (``skinless``) and the
    reductions.  ``rebuilds`` keeps each rebuild's [migrants, ghost rows,
    fluid ghost rows] and ``exchanges`` each fresh exchange's [ghost rows,
    fluid ghost rows] as 0-d device tensors (read after a run); ``halo``
    is the last fresh exchange's :class:`HaloState`, in the state's slot
    order."""

    def __init__(self, cfg: ShardCfg, group: G.Group,
                 pool: PoolPlan | None = None, skinless: bool = False):
        self.cfg, self.group, self.pool = cfg, group, pool
        self.skinless = skinless
        self.dom = slab_domain(cfg, group.rank)
        self.rebuilds = []
        self.exchanges = []
        self.refreshes = 0
        self.halo = None
        dev = group.device
        self.spawns = torch.zeros((), dtype=torch.int64, device=dev)
        self.exchange_overflow = torch.zeros((), dtype=torch.int64,
                                             device=dev)

    def rebuild(self, carry: W.StepCarry) -> W.StepCarry:
        """Migration, the free pool, the ghost rows (not on a skinless
        slab) and the divide (:func:`_shard_rebuild`)."""
        st, cells, halo, ov, stats = _shard_rebuild(
            self.cfg, carry.st, self.group.rank, self.group, self.dom,
            self.pool, self.spawns, ghosts=not self.skinless)
        self.rebuilds.append(stats)
        self.exchange_overflow = torch.zeros_like(self.exchange_overflow)
        return replace(carry, st=st, cells=cells, pos0=st.pos, dom=self.dom,
                       halo=halo, shard_overflow=ov, nbr_overflow=None,
                       nrebuild=carry.nrebuild + 1, rebuild=False)

    def refresh(self, st: SimState, halo: HaloState) -> SimState:
        self.refreshes += 1
        return _refresh_ghosts(self.cfg, st, halo, self.group)

    def exchange(self, st: SimState) -> SimState:
        """A skinless slab's ghost rows before an interaction (JAX
        ``_sharded_interaction``, `sharding.py:821-830`): the stale ones
        die and the live rows within ``cfg.halo`` cells of each slab edge
        land afresh in free slots (:func:`exchange_ghosts`).  The state
        keeps its slot order; ``halo`` records the exchange for
        :meth:`refresh` and :meth:`spawn_slots`, its overflow joins the
        step's (:meth:`overflow`)."""
        st, send, landed, ov, nghost, nfluid = exchange_ghosts(
            self.cfg, _kill_ghosts(st), self.group.rank, self.group)
        self.halo = _halo_state(self.cfg, st.n, st.pos.device, send, landed)
        self.exchange_overflow = torch.maximum(self.exchange_overflow, ov)
        self.exchanges.append([nghost, nfluid])
        return st

    def overflow(self, carry: W.StepCarry):
        """The step's rows beyond a capacity: the last rebuild's, and on a
        skinless slab the largest of the fresh exchanges since."""
        return torch.maximum(carry.shard_overflow, self.exchange_overflow)

    def reduce_max(self, *vals):
        """The values (0-d tensors or None) reduced with MAX over the
        ranks, in one collective."""
        live = [v for v in vals if v is not None]
        red = iter(self.group.all_reduce(torch.stack(
            [v.to(torch.float32) for v in live])).unbind(0))
        return tuple(None if v is None else next(red) for v in vals)

    def reduce_sum(self, x):
        return self.group.all_reduce(x, "sum")

    def agree(self, need, overflows):
        """(need, [each of ``overflows``]) reduced with MAX over the ranks,
        in one collective."""
        v = self.group.all_reduce(torch.stack(
            [need.to(torch.float32)]
            + [o.to(torch.float32) for o in overflows]))
        return v[0] > 0, list(v[1:].unbind(0))

    def owns(self, pos):
        """(m,) bool: the points ``pos`` (m, 3) this rank's slab owns."""
        return _owner(self.cfg, pos[:, 0]) == self.group.rank

    def spawned(self, count):
        """Add ``count`` (0-d: the inlet/outlet pass's spawns and its
        requests that found no slot) to the rank's spawns, which weigh its
        share of the free pool."""
        self.spawns = self.spawns + count

    def spawn_slots(self, st: SimState, halo: HaloState):
        """(n,) bool: the slots an inlet/outlet spawn may take, those
        holding a free-pool id (dead ones hold -1 otherwise), never a slot
        the refresh writes, nor the last one."""
        n = st.n
        written = torch.cat([halo.slot_l, halo.slot_r, torch.full(
            (1,), n - 1, dtype=torch.long, device=st.idp.device)])
        return (st.idp >= 0).index_fill(0, written, False)


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------

def _check_sharded_feats(feats: Features | None):
    """The features a sharded step runs (JAX ``_check_sharded_feats``):
    the shard-local hooks (motion, damping, relaxation zones, multi-layer
    pistons, accinput, the viscosity table), the floating bodies with
    their replicated couplings and DEM, y/z-periodic boundaries and the
    inlet/outlet zones.  x-periodic boundaries raise NotImplementedError
    in JAX's words, and so does the wave paddles' AWAS, which JAX's
    sharded step never runs."""
    if feats is None:
        return None
    if feats.periodic is not None and feats.periodic.axes[0]:
        raise NotImplementedError(
            "x-periodic conflicts with the x-slab decomposition; shard "
            "along a non-periodic axis (y/z periodicity is supported)")
    if feats.awas:
        raise NotImplementedError(
            "the torch port does not cover AWAS, whose surface measurement "
            "needs every slab's columns (Features.awas), under -shard")
    return feats


def _slab_opts(opts: SolverOpts) -> SolverOpts:
    # the sharded steps walk their slab's grid, as JAX's do: the
    # neighbour-list mode is a single-device layout
    return replace(opts, use_nbrlist=False)


def make_sharded_step(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                      dd: SlabRank, feats: Features | None = None):
    """One rank's symplectic step over kernel 1 (JAX
    ``make_sharded_step_rowdiv``): the port's own step on the slab's
    grid, with the decomposition in ``dd``."""
    feats = _check_sharded_feats(feats)
    return W.make_symplectic_step(csp, _slab_opts(opts), dd.dom, feats, dd)


def make_sharded_step_verlet(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                             dd: SlabRank, feats: Features | None = None):
    """One rank's Verlet step (JAX ``make_sharded_step_rowdiv_verlet``):
    one interaction a step; ``velm1``/``rhom1`` ride migration and the
    halo like any other field."""
    feats = _check_sharded_feats(feats)
    return W.make_verlet_step(csp, _slab_opts(opts), dd.dom, feats, dd)


def make_sharded_step_nn(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                         phases, dd: SlabRank, feats: Features | None = None):
    """One rank's symplectic step over the NN pipeline (kernels 4-6; JAX
    ``make_sharded_step_nn``).  Requires ``cfg.halo >= 2``."""
    if cfg.halo < 2:
        raise ValueError("sharded NN needs make_shard_cfg(..., halo=2): "
                         "ghost effective viscosity is a neighbourhood "
                         "field consumed by the stress pass")
    feats = _check_sharded_feats(feats)
    return NM.make_nn_step(csp, opts, dd.dom, phases, feats, dd)


def _rank_step(cfg, csp, opts, dd, feats, phases):
    if phases is not None:
        return make_sharded_step_nn(cfg, csp, opts, phases, dd, feats)
    if opts.tstep == TpStep.VERLET:
        return make_sharded_step_verlet(cfg, csp, opts, dd, feats)
    return make_sharded_step(cfg, csp, opts, dd, feats)


# ---------------------------------------------------------------------------
# the run loop
# ---------------------------------------------------------------------------

def _owned(st: SimState):
    """Slots that hold a particle of this rank: neither ghost nor dead."""
    return (st.code != _DEAD) & ~td.is_periodic(st.code)


def gather_state(cfg: ShardCfg, st: SimState, group: G.Group):
    """Rank 0: every rank's particles in one state ordered by id, the
    body state rank 0's (it is replicated); other ranks: None.  Every rank
    sends ``n_ext`` rows, its particles first."""
    names = _names(st)
    rows, _, _ = _compact(_owned(st), st.n)
    bufs = group.gather(_pack(st, names, rows))
    if bufs is None:
        return None
    buf = torch.cat(bufs)
    buf = buf[buf[:, _code_col(st, names)] != _DEAD]
    fields = _unpack(buf, st, names)
    order = torch.argsort(fields["idp"])
    kw = {k: None for k in _OPT_ARRAYS}
    kw.update({k: v[order] for k, v in fields.items()})
    return SimState(ft=st.ft, **kw)


class _RankSimulation(W.Simulation):
    """One rank's run loop: ``wcsph.Simulation.run`` over the rank's step,
    its diagnostics taken on the gathered state (:class:`_Saves`)."""

    def __init__(self, csp, opts, dd: SlabRank, state, feats, step, t0,
                 log):
        self.csp, self.opts, self.dom, self.feats = csp, opts, dd.dom, feats
        self.carry = W.make_carry(state, csp, _slab_opts(opts), dd.dom,
                                  feats, t0=t0, dd=dd)
        self.advance = W.make_advance(csp, opts, dd.dom, feats, step=step)
        self.part = 0
        self.time = t0
        self.log = log
        self._nfluid0 = None

    def check_diagnostics(self):
        pass


class _Saves:
    """The callbacks every rank passes to its run loop: a gather at each
    save (and gauge sub-tick) and, on rank 0, the diagnostics on the
    gathered state followed by the caller's callback; the host decisions
    of rank 0 (the TERMINATE file, the gauges' next tick) broadcast so that
    every rank's loop takes the same path."""

    def __init__(self, cfg, group, view, on_save=None, on_subtick=None,
                 terminate=None, next_subtick=None):
        self.cfg, self.group, self.view = cfg, group, view
        self.user_save, self.user_subtick = on_save, on_subtick
        self.user_terminate, self.user_next = terminate, next_subtick

    def _gathered(self, sim):
        st = gather_state(self.cfg, sim.carry.st, self.group)
        if st is None:
            return None
        v = self.view
        v.carry = replace(sim.carry, st=st, cells=None, rebuild=True,
                          halo=None, pos0=None)
        v.time, v.part = sim.time, sim.part
        v.walltime = getattr(sim, "walltime", 0.0)
        return v

    def on_save(self, sim):
        v = self._gathered(sim)
        if v is not None:
            v.check_diagnostics()
            if self.user_save is not None:
                self.user_save(v)

    def on_subtick(self, sim, t_abs):
        v = self._gathered(sim)
        if v is not None and self.user_subtick is not None:
            self.user_subtick(v, t_abs)

    def _lockstep(self, fn, *args):
        val = fn(*args) if self.group.rank == 0 else None
        x = torch.tensor([math.nan if val is None else float(val)],
                         dtype=torch.float64, device=self.group.device)
        x = float(self.group.broadcast(x)[0])
        return None if math.isnan(x) else x

    def poll(self):
        return self._lockstep(lambda: self.user_terminate.poll())

    def next_subtick(self, t_abs):
        return self._lockstep(self.user_next, t_abs)


def _launches():
    from ..ops.cuda import cellforce as CF
    from ..ops.cuda import nnforce as NF
    return {**CF.launches, **NF.launches}


STAT_KEYS = ("nstep", "nrebuild", "migrants", "ghost_rows", "fluid_ghosts",
             "refreshes", "ghost_exchanges", "collectives", "bytes")


@dataclass
class RankRun:
    """One rank's run as :func:`rank_start` sets it up: its decomposition,
    its run loop (``sim.carry`` the rank's carry), its step, the callbacks
    of its saves and the kernels' launch counters at its start."""
    dd: SlabRank
    sim: _RankSimulation
    step: object
    saves: _Saves
    launched0: dict


def rank_start(group: G.Group, cfg: ShardCfg, csp: CteSph,
               opts: SolverOpts, state: SimState, feats, phases, t0: float,
               part0: int, hooks: dict | None = None,
               log=print) -> RankRun:
    """What every rank sets up first: its slots of ``state``, its step and
    its run loop, from the arguments of :meth:`ShardedSimulation._args`;
    the group's and the rebuilds' counters start at 0.  ``hooks``: rank
    0's callbacks (``on_save``, ``on_subtick``, ``terminate``,
    ``next_subtick``) and the view's ``errdir``, ``partsoutmax``."""
    launched0 = _launches()
    group.reset_counts()
    spare = spare_ids(cfg, state, feats)
    spawners = _spawners(feats)
    pool = None if spawners is None else PoolPlan(
        feats.inout, spawners, max(1, sum(len(s) for s in spare)))
    dd = SlabRank(cfg, group, pool, skinless=W.skinless(csp, cfg.gdom))
    st = _rank_state(cfg, shard_state(cfg, state), group.rank, group.device,
                     spare[group.rank])
    step = _rank_step(cfg, csp, opts, dd, feats, phases)
    sim = _RankSimulation(csp, opts, dd, st, feats, step, t0,
                          log if group.rank == 0 else (lambda *a: None))
    sim.part = part0
    view = W.Simulation.__new__(W.Simulation)
    view.csp, view.opts, view.dom, view.feats = csp, opts, cfg.gdom, feats
    view.log, view._nfluid0 = log, None
    hooks = hooks or {}
    for k in ("errdir", "partsoutmax"):
        if k in hooks:
            setattr(view, k, hooks[k])
    saves = _Saves(cfg, group, view, hooks.get("on_save"),
                   hooks.get("on_subtick"), hooks.get("terminate"),
                   hooks.get("next_subtick"))
    return RankRun(dd, sim, step, saves, launched0)


def rank_steps(run: RankRun, marks):
    """Counted steps: the rank's step up to each of ``marks`` (step
    counts), the state gathered at each.  Returns (rank 0: the carry at
    each mark, holding the gathered state; other ranks: Nones, each step's
    host seconds on this rank)."""
    sim, group = run.sim, run.dd.group
    sync = (torch.cuda.synchronize if group.device.type == "cuda"
            else (lambda: None))
    carry, carries, times = sim.carry, [], []
    for mark in marks:
        while carry.nstep < mark:
            sync()
            t1 = time.perf_counter()
            carry = run.step(carry)
            sync()
            times.append(time.perf_counter() - t1)
        sim.carry = carry
        v = run.saves._gathered(sim)
        if v is not None:
            v.check_diagnostics()
        carries.append(None if v is None else v.carry)
    return carries, times


def rank_counts(run: RankRun) -> dict:
    """This rank's counters since its start: :data:`STAT_KEYS` and each
    kernel's launches under its counter's name (``cellforce``,
    ``nnforce_p1``, ...)."""
    dd, carry = run.dd, run.sim.carry
    reb = [sum(int(s[i]) for s in dd.rebuilds) for i in range(3)]
    exc = [sum(int(s[i]) for s in dd.exchanges) for i in range(2)]
    out = dict(nstep=carry.nstep, nrebuild=carry.nrebuild, migrants=reb[0],
               ghost_rows=reb[1] + exc[0], fluid_ghosts=reb[2] + exc[1],
               refreshes=dd.refreshes, ghost_exchanges=len(dd.exchanges),
               **dd.group.counts)
    out.update({k: v - run.launched0[k] for k, v in _launches().items()})
    return out


def gather_counts(group: G.Group, counts: dict):
    """Rank 0: every rank's ``counts`` (numbers under the same keys on
    every rank), one dict a rank; other ranks: None."""
    keys = sorted(counts)
    vals = group.gather(torch.tensor([float(counts[k]) for k in keys],
                                     dtype=torch.float64,
                                     device=group.device))
    return None if vals is None else [dict(zip(keys, v.tolist()))
                                      for v in vals]


def _rank_main(group: G.Group, args, job: dict, hooks: dict | None = None,
               log=print):
    """What every rank runs: :func:`rank_start` on ``args``, then either
    the run loop (``job["kind"] == "run"``) or :func:`rank_steps` to
    ``job["marks"]``.  Rank 0 returns (its view of the run, every rank's
    :func:`rank_counts`, the marks' carries, each step's host seconds)."""
    run = rank_start(group, *args, hooks=hooks, log=log)
    marks, times = [], []
    if job["kind"] == "run":
        flags, saves = job["hooks"], run.saves
        run.sim.run(job["tmax"], job["tout"], on_save=saves.on_save,
                    max_steps=job.get("max_steps"),
                    terminate=saves if flags["terminate"] else None,
                    next_subtick=(saves.next_subtick
                                  if flags["next_subtick"] else None),
                    on_subtick=(saves.on_subtick if flags["on_subtick"]
                                else None),
                    every_step=job.get("every_step", False))
    else:
        marks, times = rank_steps(run, job["marks"])
    stats = gather_counts(group, rank_counts(run))
    if group.rank != 0:
        return None
    # a run's last save gathered its final state into the view
    return run.saves.view, stats, marks, times


def _rank_jobs(group: G.Group, jobs, log=print):
    """:func:`_rank_main` for each (args, job) of ``jobs`` in turn, in one
    start of the ranks."""
    return [_rank_main(group, args, job, log=log) for args, job in jobs]


class ShardedSimulation:
    """Host-side run loop over ``ndev`` ranks (JAX ``ShardedSimulation``,
    the CLI's ``-shard[:N]``): the save schedule and diagnostics of
    ``wcsph.Simulation`` with the step split into x-slabs.  ``ndev``: the
    ranks, by default one per card (one on the CPU, JAX's CPU backend's
    device count); ``device``: "cuda" (the state's
    device by default) or "cpu"; ``backend``: None for the rule of
    ``parallel/group.py`` (NCCL with a card per rank, gloo on the CPU),
    "gloo" to share cards.  Each rank holds the whole state's count of
    owned slots (slabs are unequal in live rows).  ``phases`` selects the
    NN step.  ``limit``: a whole start's seconds, past which the ranks are
    killed.

    :meth:`run` starts the ranks, runs the loop on each and returns with
    ``state`` (the gathered state, ordered by id), ``carry`` (rank 0's,
    holding that state), ``time``, ``part`` and ``stats`` (each rank's
    :func:`rank_counts`); ``on_save`` and the gauge callbacks receive a
    ``wcsph.Simulation`` view of the gathered state, in this process.
    :meth:`steps` runs counted steps instead."""

    def __init__(self, csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 state: SimState, feats: Features | None = None,
                 ndev: int = 0, phases=None, log=print, t0: float = 0.0,
                 device=None, backend: str | None = None,
                 limit: float | None = None):
        self.csp, self.opts, self.dom = csp, opts, dom
        self.feats = _check_sharded_feats(feats)
        self.phases = phases
        device = torch.device(device if device is not None
                              else state.pos.device.type)
        if not ndev:
            # every card, or the CPU as one device (JAX's CPU backend)
            ndev = torch.cuda.device_count() if device.type == "cuda" else 1
        G.plan(ndev, device.type, backend)      # refuses before any start
        W.check_ids(state, self.feats)
        halo = 2 if (phases is not None
                     or opts.tboundary == TpBoundary.MDBC) else 1
        if self.feats is not None and self.feats.inout is not None:
            # a conveyor spawn lands up to layers*dp behind its crosser: it
            # stays inside the slab's grid until the next migration (JAX
            # `sharding.py:1489-1498`); the ranks split the free pool by id
            # (spare_ids), below n_usable as on one device
            band = max(z.layers * csp.dp for z in self.feats.inout.zones)
            halo = max(halo, int(math.ceil(band / dom.scell)))
        self.cfg = make_shard_cfg(dom, ndev, state.n, halo=halo)
        self.device, self.backend, self.limit = device.type, backend, limit
        self.state0 = state
        self.log = log
        self.t0 = t0
        self.part = 0
        self.time = t0
        self.errdir = "."
        self.partsoutmax = None
        self.state = state
        self.carry = None
        self.stats = None

    def launch(self, fn, args=(), local=None):
        """``group.launch(fn, ...)`` on this simulation's ranks, device,
        backend and limit: ``fn(group, *args)`` on every rank, rank 0's
        result returned."""
        return G.launch(fn, self.cfg.ndev, args, device=self.device,
                        backend=self.backend, limit=self.limit, log=self.log,
                        local=local)

    def run(self, tmax: float, tout, on_save=None, max_steps=None,
            terminate=None, next_subtick=None, on_subtick=None,
            every_step=False):
        """``wcsph.Simulation.run`` over the ranks, from the state given at
        construction."""
        t0 = time.time()
        hooks = dict(on_save=on_save, on_subtick=on_subtick,
                     terminate=terminate, next_subtick=next_subtick)
        job = dict(kind="run", tmax=tmax, tout=tout, max_steps=max_steps,
                   every_step=every_step,
                   hooks={k: v is not None for k, v in hooks.items()})
        hooks.update(errdir=self.errdir, partsoutmax=self.partsoutmax)
        view, self.stats, _, _ = self.launch(
            _rank_main, (self._args(), job),
            local=dict(hooks=hooks, log=self.log))
        self.carry, self.state = view.carry, view.carry.st
        self.time, self.part = view.time, view.part
        self.walltime = time.time() - t0
        return self

    def _args(self):
        """:func:`rank_start`'s arguments after the group."""
        return (self.cfg, self.csp, self.opts, self.state0, self.feats,
                self.phases, self.t0, self.part)

    def steps(self, marks):
        """Run ``max(marks)`` steps from the state given at construction;
        returns (the carry at each mark, holding the gathered state, and
        rank 0's host seconds per step).  Sets ``stats``."""
        return steps_together([self], marks)[0]

    def _took(self, out):
        _, self.stats, carries, times = out
        self.carry = carries[-1]
        self.state = self.carry.st
        return carries, times


def steps_together(sims, marks):
    """:meth:`ShardedSimulation.steps` of several simulations over one
    start of the ranks (their counts, devices and backends equal): a list
    of (carries, times), one per simulation.  ``marks``: one tuple for all,
    or one per simulation."""
    s0 = sims[0]
    key = (s0.cfg.ndev, s0.device, s0.backend)
    if any((s.cfg.ndev, s.device, s.backend) != key for s in sims):
        raise ValueError("steps_together: the simulations differ in ranks, "
                         "device or backend")
    if not isinstance(marks[0], (list, tuple)):
        marks = [marks] * len(sims)
    jobs = [(s._args(), dict(kind="steps", marks=tuple(m)))
            for s, m in zip(sims, marks)]
    outs = s0.launch(_rank_jobs, (jobs,), local=dict(log=s0.log))
    return [s._took(out) for s, out in zip(sims, outs)]


def dryrun(n: int, device=None, backend=None) -> None:
    """One step of each of JAX's three dry-run cases over ``n`` ranks
    (JAX ``dryrun``, `sharding.py:1356-1455`; ``__graft_entry__.
    dryrun_multichip``), from one start of the ranks: the small 3D dam
    break (dp 0.06, tank 0.9 x 0.3 x 0.3 m, no obstacle), the same with
    its walls at x > 0.82 m moving (mk 9, a RECT motion of -0.05 m/s along
    x) and a damping plane, and its mDBC form (VEL0, a 2-cell halo).
    Raises unless each made a step with overflow 0; prints JAX's three
    lines.  ``device``: the ranks' ("cuda", the default, or "cpu");
    ``backend``: as for :class:`ShardedSimulation` (``"gloo"`` for ranks
    sharing a card)."""
    from ..features.damping import DampingPlane
    from ..features.motion import RECT, MotionDef, Segment
    from ..models import cases
    from ..typesdef import TpDensity, TpSlipMode

    device = "cuda" if device is None else device
    geom = dict(dp=0.06, tank=(0.9, 0.3, 0.3), column=(0.3, 0.3, 0.2),
                obstacle=False, device=device)
    case = cases.dambreak3d(**geom)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    st = case.state
    strip = (td.code_type(st.code) < td.TYPE_FLUID) & (st.pos[:, 0] > 0.82)
    moving = replace(st, code=torch.where(
        strip, td.code_make(td.TYPE_MOVING, 9), st.code))
    feats = Features(
        motions=(MotionDef(mk=9, segments=(
            Segment(kind=RECT, t0=0.0, t1=10.0, params=(-0.05, 0, 0)),)),),
        damping=(DampingPlane(point=(0.55, 0.15, 0.15),
                              limitpoint=(0.8, 0.15, 0.15)),))
    case_m = cases.dambreak3d(**geom, mdbc=True)
    opts_m = SolverOpts(tdensity=TpDensity.FOURTAKAS,
                        tboundary=TpBoundary.MDBC, slipmode=TpSlipMode.VEL0)
    run = dict(ndev=n, device=device, backend=backend)
    sims = [ShardedSimulation(case.csp, opts, case.dom, st, **run),
            ShardedSimulation(case.csp, opts, case.dom, moving, feats=feats,
                              **run),
            ShardedSimulation(case_m.csp, opts_m, case_m.dom, case_m.state,
                              **run)]
    out = [carries[-1] for carries, _ in steps_together(sims, (1,))]
    for label, c in zip(("", "feats ", "mdbc "), out):
        if c.nstep < 1:
            raise RuntimeError(f"sharded {label}step did not run")
        if c.overflow:
            raise RuntimeError(f"{label}overflow={c.overflow}")
    c = out[0]
    print(f"dryrun_multichip({n}): OK — nstep={c.nstep}, t={c.t_host:.2e}, "
          f"dt={float(c.dt_pre):.2e}, path=rowdiv")
    print(f"dryrun_multichip({n}): featured path OK — nstep={out[1].nstep} "
          f"(motion+damping over the ranks)")
    print(f"dryrun_multichip({n}): mDBC path OK — nstep={out[2].nstep} "
          f"(ghost-node correction + halo refresh over the ranks)")
