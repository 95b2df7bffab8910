"""The neighbour-list mode (``SolverOpts.use_nbrlist``) on the GPU layout.

Counterpart of `dualsphysics_multilayer_tpu/ops/nbrlist.py`.  The JAX
package compacts each target's candidates within ``rcut = kernelsize +
nbr_skin*dp`` into a fixed ``(n, M)`` table on a grid of cell side
``rcut``, rebuilt when a particle has moved ``nbr_skin*dp/2``.  The port
keeps its one layout (cell-sorted state, one target per thread, a
gather-only walk) and reproduces what a user can observe of the mode:

* the grid: the step divides on :func:`list_domain`, cells of side
  ``rcut`` over the case domain's bounds, whose map limits still mark
  escapes as ``OUT_POS`` (``Domain.within``); the skin contract's margin
  is then ``nbr_skin*dp``, and its lookahead rule (``models/wcsph.py``)
  is at least as strict as the list's ``needs_rebuild``, so both keep
  every pair within ``kernelsize``;
* the capacity: at each rebuild :func:`overflow_count` counts every
  target's neighbours within ``rcut`` (JAX ``build``'s test) and sums what
  exceeds ``M = nbr_m or auto_m``; the step's one device-to-host copy
  carries it, and ``Simulation.check_diagnostics`` raises on it;
* DEM's candidates: the rows of the list, the slots whose build-time
  positions lie within ``rcut`` of the target's (``features/dem.py``).

There is no ``(n, M)`` table on the card: kernels 1-3 walk the list's
layout as they walk any other.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..typesdef import CteSph
from . import celldiv as cd
from .forces import SolverOpts, neighbour_ranges


@dataclass(frozen=True)
class ListSpec:
    """The list's capacity ``m`` (neighbours per target), its radius, and
    the slots :func:`overflow_count` reads of one neighbour row of the
    list's grid (``celldiv.row_cap``)."""
    m: int
    rcut: float
    row_cap: int

    @property
    def rcut2(self) -> float:
        """``rcut**2`` rounded to float32, as JAX compares it with the
        float32 squared distances (`nbrlist.py:82`, `:160`)."""
        return float(np.float32(self.rcut * self.rcut))


def auto_m(csp: CteSph, skin_dp: float) -> int:
    """Neighbour capacity: lattice points within kernelsize + skin, with
    compression margin, rounded up to a multiple of 8 (JAX ``auto_m``)."""
    r = csp.kernelsize / csp.dp + skin_dp
    if csp.simulate2d:
        m = math.pi * (r + 0.5) ** 2 * 1.15
    else:
        m = 4.0 / 3.0 * math.pi * (r + 0.5) ** 3 * 1.10
    return int(-(-m // 8) * 8)


def capacity(csp: CteSph, opts: SolverOpts) -> int:
    """Neighbours per target: ``nbr_m``, or :func:`auto_m` when it is 0."""
    return opts.nbr_m or auto_m(csp, opts.nbr_skin)


def list_domain(dom: cd.Domain, csp: CteSph, opts: SolverOpts) -> cd.Domain:
    """The list's grid (JAX ``build``'s ``bdom``, `nbrlist.py:85-86`):
    cells of side ``rcut`` over ``dom``'s bounds, keeping ``dom``'s map
    limits for the escape test."""
    rcut = csp.kernelsize + opts.nbr_skin * csp.dp
    grid = cd.make_domain(dom.posmin, dom.posmax, rcut,
                          simulate2d=dom.simulate2d)
    return replace(grid, within=dom)


def layout(csp: CteSph, opts: SolverOpts, dom: cd.Domain):
    """(the domain the single-phase step divides on, its ``ListSpec`` or
    None): the list's grid under ``opts.use_nbrlist``, else ``dom``."""
    if not opts.use_nbrlist:
        return dom, None
    grid = list_domain(dom, csp, opts)
    return grid, ListSpec(m=capacity(csp, opts), rcut=grid.scell,
                          row_cap=cd.row_cap(csp, grid))


def overflow_count(dom: cd.Domain, cells: cd.CellDiv, pos, spec: ListSpec,
                   max_pairs: int = 1 << 24):
    """Σ max(0, count_i - m) over the live slots of a fresh divide (0-d
    int64 on the device): ``count_i`` the slots within ``rcut`` of slot i,
    itself excluded, with JAX's float32 test ``rr2 <= rcut**2``
    (`nbrlist.py:157-160`).  Each neighbour row is read to the static
    ``spec.row_cap`` slots, so the pass reads nothing to the host; the
    slots of a longer row beyond it (a state denser than 0.85 dp) count
    as neighbours, which can only raise the sum."""
    n = pos.shape[0]
    live = cells.cell < dom.ncells
    starts, lens = neighbour_ranges(dom, cells, live)
    L = spec.row_cap
    R = starts.shape[1]
    excess = torch.clamp(lens - L, min=0).sum(dim=1)
    off = torch.arange(L, device=pos.device)
    total = torch.zeros((), dtype=torch.int64, device=pos.device)
    B = max(1, max_pairs // (R * L))
    for i0 in range(0, n, B):
        t = torch.arange(i0, min(i0 + B, n), device=pos.device)
        ok = off < lens[t, :, None]
        j = torch.where(ok, starts[t, :, None] + off, 0).reshape(len(t), R * L)
        d = pos[t, None, :] - pos[j]
        rr2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        keep = ok.reshape(j.shape) & (rr2 <= spec.rcut2) & (j != t[:, None])
        count = keep.sum(dim=1) + excess[t]
        total += torch.clamp(count - spec.m, min=0).sum()
    return total
