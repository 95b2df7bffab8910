"""Cell division for the GPU layout: particles sorted by cell with a begin
index per cell, the layout of the original DualSPHysics GPU solver (PreSort
+ radix sort + CalcBeginEndCell).

Counterpart of `dualsphysics_multilayer_tpu/ops/celldiv.py` for ``Domain``,
``make_domain``, ``cell_coords`` and, as :func:`point_ranges`,
``point_candidates``.  The JAX package's TPU layouts (fixed
buckets, row padding, lane chunks) are not ported: here the state arrays
themselves are permuted into cell order, so the particles of one cell are a
contiguous slot range and the 3 cells of one (dy, dz) neighbour row are one
contiguous range as well (x is the fastest key).  There is no per-cell
capacity, so nothing can overflow.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import typesdef as td


@dataclass(frozen=True)
class Domain:
    """Static cell grid (`JSph::ConfigCellDivision`): lower corner, cell
    width ``scell`` (kernelsize plus the rebuild skin) and cell counts."""
    posmin: tuple            # (x,y,z) map lower corner
    scell: float             # cell width
    nc: tuple                # (ncx, ncy, ncz) cell counts
    simulate2d: bool = False
    # a grid whose map limits a divide also keeps (the neighbour list's
    # coarser grid over the case's domain, ``ops/nbrlist.list_domain``)
    within: "Domain | None" = None

    @property
    def ncells(self) -> int:
        return self.nc[0] * self.nc[1] * self.nc[2]

    @property
    def posmax(self) -> tuple:
        return tuple(self.posmin[i] + self.nc[i] * self.scell for i in range(3))


def make_domain(posmin, posmax, kernelsize, *, simulate2d=False, borders=0.0,
                skin=0.0) -> Domain:
    """Cell grid covering [posmin-borders, posmax+borders] with cells of
    kernelsize*(1+skin): the skin lets one divide serve every step until the
    particles have moved ``skin*kernelsize`` in total (see
    ``models.wcsph``)."""
    posmin = tuple(float(p) - borders for p in posmin)
    posmax = tuple(float(p) + borders for p in posmax)
    scell = float(kernelsize) * (1.0 + skin)
    nc = tuple(max(1, int(math.ceil((posmax[i] - posmin[i]) / scell)))
               for i in range(3))
    if simulate2d:
        nc = (nc[0], 1, nc[2])
    return Domain(posmin=posmin, scell=scell, nc=nc, simulate2d=simulate2d)


def cell_coords(dom: Domain, pos):
    """Integer cell coordinates of each position (may be out of range)."""
    origin = torch.tensor(dom.posmin, dtype=pos.dtype, device=pos.device)
    rel = (pos - origin) * (1.0 / dom.scell)
    return torch.floor(rel).to(torch.int32)


def _inside(dom: Domain, cxyz):
    nc = torch.tensor(dom.nc, dtype=torch.int32, device=cxyz.device)
    return ((cxyz >= 0) & (cxyz < nc)).all(dim=1)


@dataclass
class CellDiv:
    """A divide in the GPU layout, valid for state arrays permuted by
    ``order``.  Slot k of the sorted state lies in cell ``cell[k]``; the
    slots of cell c are ``begin[c] <= k < begin[c+1]``.  Dead slots (inactive
    or outside the map at the divide) carry ``cell == ncells`` and sit after
    ``begin[ncells]``."""
    cell: torch.Tensor       # (n,) int32 cell id of each sorted slot
    begin: torch.Tensor      # (ncells+1,) int32 first slot of each cell
    order: torch.Tensor      # (n,) int64 sorted slot k holds particle order[k]


def slots_of(cells: CellDiv) -> torch.Tensor:
    """(n,) int64: the sorted slot of each particle of the divided order
    (the inverse of ``cells.order``), to gather results back."""
    back = torch.empty_like(cells.order)
    back[cells.order] = torch.arange(cells.order.shape[0],
                                     device=cells.order.device)
    return back


def divide_cells(dom: Domain, pos, code):
    """Sort particles by linear cell id (x fastest).  Returns ``(CellDiv,
    new_code)`` where ``new_code`` (in the input order) marks formerly active
    particles that left the map (``dom``'s grid, and ``dom.within``'s when
    set) as OUT_POS, as the JAX divides do."""
    ncx, ncy, ncz = dom.nc
    ncells = dom.ncells
    cxyz = cell_coords(dom, pos)
    inside = _inside(dom, cxyz)
    if dom.within is not None:
        inside = inside & _inside(dom.within, cell_coords(dom.within, pos))
    active = td.is_active(code)
    newly_out = active & ~inside
    new_code = torch.where(newly_out,
                           td.code_set_special(code, td.SPECIAL_OUT_POS), code)
    live = active & inside
    key = (cxyz[:, 2] * ncy + cxyz[:, 1]) * ncx + cxyz[:, 0]
    key = torch.where(live, key, ncells)
    skey, order = torch.sort(key, stable=True)
    cells = torch.arange(ncells + 1, dtype=torch.int32, device=pos.device)
    begin = torch.searchsorted(skey, cells, out_int32=True)
    return CellDiv(cell=skey, begin=begin, order=order), new_code


def row_ranges(dom: Domain, cells: CellDiv, cx, cy, cz, live):
    """(start, length) of the (dy, dz) neighbour rows of cells (cx, cy, cz),
    (m, R) each with R = 9 (3 in 2D), dz-major then dy as the kernels walk
    them: the x-cells cx-1..cx+1 of one row, clamped to the grid, are one
    contiguous slot range.  Rows outside the grid, and every row where
    ``live`` is false, have length 0."""
    ncx, ncy, ncz = dom.nc
    x0 = torch.clamp(cx - 1, min=0)
    x1 = torch.clamp(cx + 1, max=ncx - 1)
    begin = cells.begin.long()
    dys = (0,) if dom.simulate2d else (-1, 0, 1)
    starts, lens = [], []
    for dz in (-1, 0, 1):
        for dy in dys:
            y, z = cy + dy, cz + dz
            ok = live & (y >= 0) & (y < ncy) & (z >= 0) & (z < ncz)
            row = torch.where(ok, (z * ncy + y) * ncx, 0)
            s = begin[row + x0]
            e = begin[row + x1 + 1]
            starts.append(s)
            lens.append(torch.where(ok, e - s, 0))
    return torch.stack(starts, dim=1), torch.stack(lens, dim=1)


def point_ranges(dom: Domain, cells: CellDiv, points):
    """(start, length), (m, R) each, of the neighbour rows around arbitrary
    query points (m,3): the cell is the point's own, not a slot's (JAX
    ``celldiv.point_candidates``, the mDBC ghost nodes' search).  A point
    outside the grid has no candidates.

    On a layout divided when the candidates stood at ``pos0``, the rows
    still hold every candidate j within ``kernelsize`` of a point g while
    each candidate has moved at most d since (the skin contract, d <
    ``scell - kernelsize``): |g - pos0_j| <= kernelsize + d < scell, so j
    lies in g's cell or a neighbour of it."""
    cxyz = cell_coords(dom, points).long()
    nc = torch.tensor(dom.nc, dtype=torch.int64, device=points.device)
    inside = ((cxyz >= 0) & (cxyz < nc)).all(dim=1)
    cxyz = torch.where(inside[:, None], cxyz, 0)
    return row_ranges(dom, cells, cxyz[:, 0], cxyz[:, 1], cxyz[:, 2], inside)


def row_cap(csp, dom: Domain) -> int:
    """Slots of one neighbour row (3 cells along x) a pass with static
    sizes reads per candidate row: a dp lattice squeezed to 0.85 dp
    (``features/inout.py`` extrapolation, ``features/dem.py``).  The
    callers count longer rows into the step's overflow."""
    q = dom.scell / (0.85 * csp.dp)
    return int(math.ceil(3 * q + 1)) * int(math.ceil(q + 1)) ** (
        1 if csp.simulate2d else 2)


def range_chunks(starts, lens, max_pairs: int):
    """Yield ``(t, j, valid)`` for chunks of rows of ``starts``/``lens``
    (m, R): ``t`` (b,) row numbers, ``j`` (b, R*L) the slots of their R
    ranges, each padded to the longest range L (slot 0 in the padding),
    and ``valid`` (b, R*L) false in the padding.  A chunk holds at most
    ``max_pairs`` padded slots, which bounds the pair temporaries (the
    analog of the JAX bucket path's cell chunks)."""
    m, R = starts.shape
    L = max(int(lens.max()), 1) if m else 1
    B = max(1, max_pairs // (R * L))
    off = torch.arange(L, device=starts.device)
    for i0 in range(0, m, B):
        t = torch.arange(i0, min(i0 + B, m), device=starts.device)
        valid = off < lens[t, :, None]                          # (b, R, L)
        j = torch.where(valid, starts[t, :, None] + off, 0).reshape(len(t), -1)
        yield t, j, valid.reshape(len(t), -1)
