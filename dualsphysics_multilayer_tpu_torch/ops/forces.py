"""WCSPH force interaction over the cell-sorted layout.

Counterpart of `dualsphysics_multilayer_tpu/ops/forces.py`.
:func:`interaction_forces` sends CUDA tensors to the hand-written kernel
(`ops/cuda/cellforce.py`) and CPU tensors to :func:`interaction_forces_plain`,
the plain torch version of the same function: it walks the same 9 (3 in 2D)
contiguous neighbour ranges per target as the kernel, gathers them padded to
the longest range, and evaluates :func:`pairphys.pair_terms`.

Acceleration excludes gravity (added by the integrator), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import typesdef as td
from ..typesdef import (CteSph, TpBoundary, TpDensity, TpKernel, TpShifting,
                        TpStep, TpVisco)
from . import eos
from . import pairphys as PP
from .celldiv import CellDiv, Domain
from .pairphys import FLT_MAX


@dataclass(frozen=True)
class SolverOpts:
    """Solver configuration; the JAX package's ``SolverOpts`` fields that
    the port's slice reads.  Values the slice does not cover raise
    ``NotImplementedError`` in :func:`check_supported`."""
    tstep: TpStep = TpStep.SYMPLECTIC
    tvisco: TpVisco = TpVisco.ARTIFICIAL
    tdensity: TpDensity = TpDensity.FOURTAKAS
    tboundary: TpBoundary = TpBoundary.DBC
    shiftmode: TpShifting = TpShifting.NONE
    with_floating: bool = False
    use_nbrlist: bool = False
    symmetry: bool = False


@dataclass
class Forces:
    """Force accumulators of one interaction, in the state's slot order.
    (Shifting and SPS accumulators come with their slices.)"""
    ace: torch.Tensor          # (n,3) acceleration without gravity
    ar: torch.Tensor           # (n,)  drho/dt, density diffusion folded in
    viscdtmax: torch.Tensor    # ()    max dot(dv,dr)/(rr2+eta2) over pairs, >= 0


def check_supported(csp: CteSph, opts: SolverOpts) -> None:
    """Raise NotImplementedError for any configuration outside the slice."""
    unsupported = [
        (opts.tstep != TpStep.SYMPLECTIC, f"tstep={opts.tstep.name}"),
        (opts.tvisco != TpVisco.ARTIFICIAL, f"tvisco={opts.tvisco.name}"),
        (opts.tboundary != TpBoundary.DBC, f"tboundary={opts.tboundary.name}"),
        (opts.shiftmode != TpShifting.NONE, f"shiftmode={opts.shiftmode.name}"),
        (opts.with_floating, "with_floating=True"),
        (opts.use_nbrlist, "use_nbrlist=True"),
        (opts.symmetry, "symmetry=True"),
        (csp.tkernel != TpKernel.WENDLAND, f"tkernel={csp.tkernel.name}"),
    ]
    for bad, name in unsupported:
        if bad:
            raise NotImplementedError(f"the torch port does not cover {name} yet")


def interaction_forces(csp: CteSph, opts: SolverOpts, dom: Domain,
                       cells: CellDiv, pos, vel, rho, code) -> Forces:
    """One interaction on state arrays in ``cells`` order: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if pos.device.type == "cuda":
        from .cuda import cellforce as CF
        return CF.interaction_forces_cuda(csp, opts, dom, cells, pos, vel,
                                          rho, code)
    if pos.device.type != "cpu":
        raise ValueError(f"interaction_forces: no path for device {pos.device}")
    return interaction_forces_plain(csp, opts, dom, cells, pos, vel, rho, code)


def neighbour_ranges(dom: Domain, cells: CellDiv, live):
    """(start, length) of each target's (dy, dz) neighbour ranges, (n, R)
    each with R = 9 (3 in 2D): the x-neighbours -1..+1 of one row, clamped
    to the grid, are one contiguous slot range."""
    ncx, ncy, ncz = dom.nc
    cell = cells.cell.long()
    cx, cy, cz = cell % ncx, (cell // ncx) % ncy, cell // (ncx * ncy)
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


def interaction_forces_plain(csp: CteSph, opts: SolverOpts, dom: Domain,
                             cells: CellDiv, pos, vel, rho, code,
                             max_pairs: int = 1 << 21) -> Forces:
    """Plain torch version of the cellforce kernel.  Targets are processed
    in chunks of at most ``max_pairs`` padded candidate slots, which bounds
    the pair temporaries (the analog of the JAX bucket path's cell chunks)."""
    check_supported(csp, opts)
    n = pos.shape[0]
    f32 = pos.dtype
    press = eos.press_from_rho(csp, rho)
    act = td.is_active(code)
    fluidside, floating, _fixed, mass = PP.particle_flags(csp, code)
    live = act & (cells.cell < dom.ncells)
    starts, lens = neighbour_ranges(dom, cells, live)
    R = starts.shape[1]
    L = max(int(lens.max()), 1) if n else 1
    B = max(1, max_pairs // (R * L))
    off = torch.arange(L, device=pos.device)

    ace = torch.zeros((n, 3), dtype=f32, device=pos.device)
    ar = torch.zeros(n, dtype=f32, device=pos.device)
    visc = torch.full((n,), -FLT_MAX, dtype=f32, device=pos.device)
    for i0 in range(0, n, B):
        t = torch.arange(i0, min(i0 + B, n), device=pos.device)
        valid = off < lens[t, :, None]                          # (b, R, L)
        j = torch.where(valid, starts[t, :, None] + off, 0).reshape(len(t), -1)
        valid = valid.reshape(len(t), -1)
        dr = pos[t, None, :] - pos[j]
        rr2 = (dr * dr).sum(dim=-1)
        pair = (valid & (j != t[:, None]) & act[j]
                & (rr2 >= td.ALMOSTZERO) & (rr2 < csp.kernelsize2))
        p = PP.PairInputs(
            dr=dr, rr2=rr2, pair=pair, dv=vel[t, None, :] - vel[j],
            mass2=mass[j], rho1=rho[t, None], rho2=rho[j],
            press1=press[t, None], press2=press[j],
            bound_t=~fluidside[t, None], bound_c=~fluidside[j],
            ft_t=floating[t, None], ft_c=floating[j])
        terms = PP.pair_terms(csp, opts, p)
        ace[t] = terms.ace.sum(dim=1)
        art = terms.ar.sum(dim=1)
        if opts.tdensity != TpDensity.NONE:
            blocked = terms.delta_blocked.any(dim=1) | (floating[t] & live[t])
            art = art + torch.where(blocked, 0.0, terms.delta.sum(dim=1))
        ar[t] = art
        visc[t] = terms.visc.amax(dim=1)
    if csp.simulate2d:
        ace[:, 1] = 0.0
    viscdtmax = torch.clamp(visc.amax(), min=0.0)
    return Forces(ace=ace, ar=ar, viscdtmax=viscdtmax)
