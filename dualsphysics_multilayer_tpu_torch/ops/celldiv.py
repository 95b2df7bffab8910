"""Cell division for the GPU layout: particles sorted by cell with a begin
index per cell, the layout of the original DualSPHysics GPU solver (PreSort
+ radix sort + CalcBeginEndCell).

Counterpart of `dualsphysics_multilayer_tpu/ops/celldiv.py` for ``Domain``,
``make_domain`` and ``cell_coords``.  The JAX package's TPU layouts (fixed
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


def divide_cells(dom: Domain, pos, code):
    """Sort particles by linear cell id (x fastest).  Returns ``(CellDiv,
    new_code)`` where ``new_code`` (in the input order) marks formerly active
    particles that left the map as OUT_POS, as the JAX divides do."""
    ncx, ncy, ncz = dom.nc
    ncells = dom.ncells
    cxyz = cell_coords(dom, pos)
    nc = torch.tensor(dom.nc, dtype=torch.int32, device=pos.device)
    inside = ((cxyz >= 0) & (cxyz < nc)).all(dim=1)
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
