"""Periodic open boundaries on the cell-sorted GPU layout.

Counterpart of `dualsphysics_multilayer_tpu/features/periodic.py` (the
reference's `JSphCpuSingle::RunPeriodic`, JSphCpuSingle.cpp:361-431): at
every interaction

1. normal particles that crossed a periodic edge wrap by the period (the
   wrap persists in the state, as in JAX);
2. old ghosts die (a state converted from the JAX package may hold some);
3. the particles within KernelSize of an edge, and the ghosts of the axes
   before (which covers the corners), are copied to the opposite side as
   ghosts marked SPECIAL_PERIODIC, carrying vel, rho, the SPS stress and
   the mDBC normals and wall velocity.

The JAX package keeps the ghosts in a fixed tail of its state.  The port
permutes its slots at every rebuild, so a fixed tail cannot hold: here the
ghosts are rows that exist only inside one interaction
(:func:`periodic_interaction`).  The state's rows and ``2*naxes*ghost_cap``
ghost rows (the unused ones OUT_IGNORE) are divided together, run through
the interaction (kernel 1 on the card: ghost rows are ordinary fluid or
wall rows), and the real rows' results are gathered back into the state's
slot order.  Each side takes at most ``ghost_cap`` ghosts, chosen as JAX
chooses them: the first in slot order, which in a JAX state is id order
(the real particles by ``idp``, then the ghosts of the axes before in
their block order).  The rest count into the returned overflow, on the
device.  The ids must be a permutation of 0..n-1 (``models.wcsph.
make_carry`` checks it).  The inlet/outlet pass after a step reads the
images of the state's rows as it stands (:func:`images`), as JAX's zones
read the ghosts its state keeps.

On one rank of a domain decomposition (``parallel/sharding.py``) the
state also holds the x-halo rows, which carry the periodic special code
and their owners' ids, and dead slots; :func:`periodic_interaction` then
wraps the owned rows, refreshes the halo rows (wrapped on their own
ranks) and images both, which covers the slab's corners, and the ranks
come from the masked rows only, in id order.  Each rank images distinct
particles, so the global ``ghost_cap`` bounds its images too.  x-periodic
conflicts with the x-slabs and is refused there.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .. import typesdef as td
from ..typesdef import CteSph
from ..ops import celldiv as cd
from ..ops import forces as F

# the per-row fields a ghost row carries (the interaction's inputs)
GHOST_FIELDS = ("pos", "vel", "rho", "code", "idp", "spstau",
                "boundnormal", "motionvel")


@dataclass(frozen=True)
class PeriodicCfg:
    axes: tuple            # e.g. (True, False, False) for x-periodic
    lo: tuple              # periodic box lower corner
    hi: tuple              # upper corner (period = hi - lo per axis)
    ghost_cap: int         # ghosts per side of each axis

    @property
    def naxes(self):
        return sum(1 for a in self.axes if a)


def _dead_code():
    return td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE)


def wrap(cfg: PeriodicCfg, pos, code):
    """Positions of the active normal particles that crossed an edge,
    shifted back by the period (JAX step 1)."""
    normal = td.is_normal(code) & td.is_active(code)
    for ax in range(3):
        if not cfg.axes[ax]:
            continue
        L = cfg.hi[ax] - cfg.lo[ax]
        x = pos[:, ax]
        shift = torch.where(x >= cfg.hi[ax], -L,
                            torch.where(x < cfg.lo[ax], L, 0.0))
        pos = pos.clone()
        pos[:, ax] = x + torch.where(normal, shift, 0.0)
    return pos


def _id_rank(mask, idp, n):
    """The rank of each row among the rows of ``mask`` in id order (valid
    where ``mask``, whose ids lie below ``n``): an id-indexed cumulative
    count, no sort and no read to the host.  Only the masked rows write
    their ids, so a dead slot or a halo row whose id another row also
    holds leaves the count alone."""
    byid = torch.zeros(n + 1, dtype=torch.int32, device=mask.device)
    byid[torch.where(mask, idp, n)] = 1
    return torch.cumsum(byid[:n], 0, dtype=torch.int32)[
        torch.clamp(idp, 0, n - 1)] - 1


def ghost_rows(cfg: PeriodicCfg, csp: CteSph, st):
    """(rows, overflow): a dict of the state's ``GHOST_FIELDS`` with
    ``2*naxes*ghost_cap`` ghost rows after the state's rows, and the 0-d
    int32 count of edge particles beyond ``ghost_cap`` (JAX steps 2-3)."""
    rows, overflow, _ = _ghost_rows(cfg, csp, st)
    return rows, overflow


def _ghost_rows(cfg: PeriodicCfg, csp: CteSph, st, halo: bool = False):
    """:func:`ghost_rows` and each row's origin, the state's slot it copies
    (``(n + 2*naxes*ghost_cap,)`` int64).  ``halo``: the state is one rank
    of a domain decomposition, whose periodic-coded rows are its live
    halo rows: they are kept and imaged like owned rows (without it they
    are stale ghosts and die)."""
    n = st.n
    G = cfg.ghost_cap
    ks = csp.kernelsize
    dev = st.pos.device
    rows = {k: getattr(st, k) for k in GHOST_FIELDS
            if getattr(st, k) is not None}
    dead = _dead_code()
    if not halo:
        rows["code"] = torch.where(td.is_periodic(rows["code"]), dead,
                                   rows["code"])
    origin = torch.arange(n, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    garange = torch.arange(G, device=dev)
    for ax in range(3):
        if not cfg.axes[ax]:
            continue
        L = cfg.hi[ax] - cfg.lo[ax]
        nrows = rows["pos"].shape[0]
        live = td.is_active(rows["code"])
        x = rows["pos"][:, ax]
        blocks, origins = [], []
        for shift in (L, -L):
            near = live & ((x < cfg.lo[ax] + ks) if shift > 0
                           else (x >= cfg.hi[ax] - ks))
            # slot order: the real rows by id, then the earlier axes'
            # ghost rows in block order
            nreal = near[:n].sum(dtype=torch.int32)
            rank = torch.cat([
                _id_rank(near[:n], st.idp, n),
                nreal + torch.cumsum(near[n:], 0, dtype=torch.int32) - 1])
            cnt = near.sum(dtype=torch.int32)
            overflow = overflow + torch.clamp(cnt - G, min=0)
            src = torch.zeros(G + 1, dtype=torch.long, device=dev)
            src[torch.where(near & (rank < G), rank, G).long()] = \
                torch.arange(nrows, device=dev)
            src = src[:G]
            valid = garange < cnt
            blk = {k: v[src] for k, v in rows.items()}
            blk["pos"][:, ax] = blk["pos"][:, ax] + shift
            blk["code"] = torch.where(
                valid, td.code_set_special(blk["code"], td.SPECIAL_PERIODIC),
                dead)
            blocks.append(blk)
            origins.append(origin[src])
        rows = {k: torch.cat([v] + [b[k] for b in blocks])
                for k, v in rows.items()}
        origin = torch.cat([origin] + origins)
    return rows, overflow, origin


def images(cfg: PeriodicCfg, csp: CteSph, st, halo: bool = False):
    """(images, overflow): the ghost rows of :func:`ghost_rows` alone, for
    the inlet/outlet pass after a step (``features/inout.py``), as a dict
    of their pos, vel, rho and code, and ``counted``, the live images of
    the rank's own rows (not of its halo rows, whose own rank counts
    them); and the 0-d int32 count of edge particles beyond ``ghost_cap``.
    JAX keeps its ghosts in the state through the step, where its zones
    read them as sources; here they are made again from the state as it
    stands.  ``halo`` as for :func:`_ghost_rows`."""
    rows, overflow, origin = _ghost_rows(cfg, csp, st, halo)
    n = st.n
    img = {k: rows[k][n:] for k in ("pos", "vel", "rho", "code")}
    img["counted"] = (td.is_active(img["code"])
                      & ~td.is_periodic(st.code)[origin[n:]])
    return img, overflow


def periodic_interaction(cfg: PeriodicCfg, csp: CteSph, dom: cd.Domain, st,
                         interact, refresh=None):
    """One interaction under periodic boundaries.  Wraps the state, builds
    its ghost rows, divides the rows together and runs ``interact(rows,
    cells, refresh) -> (rows, Forces)`` on them in cell order; returns (the
    wrapped state with the interaction's vel, rho and code of its rows, the
    Forces of its rows with ``overflow`` set).  The state's own slot order
    is left as it is, so the step's arrays (the predictor's, ``pose``) stay
    valid.

    ``refresh(st) -> st``: one rank's halo refresh under a domain
    decomposition (None otherwise).  The halo rows are refreshed after the
    wrap and before the images are made, and kept; the ``refresh`` handed
    to ``interact`` (None without one) brings the rows' vel and rho up to
    date again through the state, the images from their origins (the
    second refresh after the mDBC pre-pass)."""
    st = replace(st, pos=wrap(cfg, st.pos, st.code))
    if refresh is not None:
        st = refresh(st)
    rows, overflow, origin = _ghost_rows(cfg, csp, st,
                                         halo=refresh is not None)
    cells, code = cd.divide_cells(dom, rows["pos"], rows["code"])
    order = cells.order
    back = cd.slots_of(cells)[:st.n]
    again = None
    if refresh is not None:
        src = origin[order]

        def again(srt):
            s = refresh(replace(st, vel=srt.vel[back], rho=srt.rho[back]))
            return replace(srt, vel=s.vel[src], rho=s.rho[src])

    srt, fr = interact(_rows_state(st, rows, code, order), cells, again)
    st = replace(st, vel=srt.vel[back], rho=srt.rho[back],
                 code=srt.code[back])
    return st, replace(F.gathered(fr, back), overflow=overflow)


def _rows_state(st, rows, code, order):
    """The rows as a state in cell order: the interaction's fields, the
    ids (a ghost row carries its source's, which DEM's id-keyed tables
    read), the body state, and no residuals or M1 state (the interaction
    reads none of them)."""
    kw = {k: None for k in vars(st)}
    kw.update({k: v[order] for k, v in rows.items()})
    kw["code"] = code[order]
    kw["ft"] = st.ft
    return type(st)(**kw)
