"""mDBC boundary correction (modified Dynamic Boundary Condition) on torch
tensors.

Counterpart of `dualsphysics_multilayer_tpu/ops/mdbc.py` (reference
`JSphCpu::InteractionMdbcCorrectionT2`, JSphCpu.cpp:1020-1190): every
boundary particle that carries a normal mirrors a ghost node into the fluid
at ``pos + boundnormal``; the fluid neighbours of the ghost node build a
first-order moving-least-squares system (3x3 in 2D, 4x4 in 3D) whose
solution extrapolates the density back to the boundary particle, and the
Shepard-normalised ghost velocity gives the wall velocity of the slip mode:

* VEL0: the boundary velocity stays as it is (density only);
* NO_SLIP: v = 2*v_wall - v_ghost;
* FREE_SLIP: the ghost's tangential velocity kept, its normal one reversed.

Below the determinant gate (``DETERMLIMIT``) the density falls back to the
Shepard value where the Shepard sum is positive, else to rho0.  The JAX
package wrote this pass in jnp, not Pallas, so it stays torch ops here: the
ghost nodes' candidates come from their neighbour rows in the current
layout (``celldiv.point_ranges``, valid between rebuilds under the skin
contract), padded to the longest range, and the systems are solved in one
batch (``torch.linalg.det`` / ``solve_ex``).  Only the boundary particles
with a normal are computed; the others keep their values, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import typesdef as td
from ..typesdef import CteSph, TpSlipMode
from . import celldiv as cd
from . import kernels as K

DETERMLIMIT = 1e-3   # first-order gate (reference `determlimit`)

FIRST_ORDER, SHEPARD, RHO0 = 0, 1, 2   # GhostNodes.branch


@dataclass
class GhostNodes:
    """The ghost-node systems of the boundary particles that carry a
    normal, ``m`` of them."""
    idx: torch.Tensor      # (m,) their slots
    determ: torch.Tensor   # (m,) determinant of the first-order matrix
    branch: torch.Tensor   # (m,) FIRST_ORDER, SHEPARD or RHO0
    rho: torch.Tensor      # (m,) extrapolated density of that branch
    velg: torch.Tensor     # (m,3) Shepard-normalised ghost velocity
    sumwab: torch.Tensor   # (m,) Shepard sum (kernel completeness)


def ghost_nodes(csp: CteSph, dom: cd.Domain, cells: cd.CellDiv, pos, vel,
                rho, code, boundnormal, max_pairs: int = 1 << 18) -> GhostNodes:
    """The ghost-node sums, the gated solve and its branch per boundary
    particle (JAX `mdbc.py:44-132`).  Candidates are the active fluid
    particles within ``kernelsize`` of the ghost node, each of mass
    ``massfluid``."""
    f32, dev = pos.dtype, pos.device
    sel = (td.is_bound(code) & td.is_active(code)
           & ((boundnormal * boundnormal).sum(dim=1) > 0))
    idx = torch.nonzero(sel).squeeze(1)
    m = idx.shape[0]
    nrm = boundnormal[idx]
    gpos = pos[idx] + nrm
    # the MLS system's axes: x, z in 2D; x, y, z in 3D
    axes = [0, 2] if csp.simulate2d else [0, 1, 2]
    d = len(axes) + 1
    fluid = td.is_fluid(code) & td.is_active(code)
    mass = csp.massfluid
    rhop1 = torch.zeros(m, dtype=f32, device=dev)
    grad = torch.zeros((m, d - 1), dtype=f32, device=dev)
    sumwab = torch.zeros(m, dtype=f32, device=dev)
    velg = torch.zeros((m, 3), dtype=f32, device=dev)
    amat = torch.zeros((m, d, d), dtype=f32, device=dev)
    for t, j, valid in cd.range_chunks(*cd.point_ranges(dom, cells, gpos),
                                       max_pairs):
        dr = gpos[t, None, :] - pos[j]
        rr2 = (dr * dr).sum(dim=-1)
        pair = valid & fluid[j] & (rr2 <= csp.kernelsize2)
        pw = pair.to(f32)
        rr2s = torch.where(pair, rr2, csp.kernelsize2)
        wab = pw * K.kernel_wab(csp, rr2s)
        fr = (pw * K.kernel_fac(csp, rr2s))[..., None] * dr[..., axes]
        volp2 = mass / rho[j]
        vwab = wab * volp2
        rhop1[t] = (mass * wab).sum(dim=1)
        grad[t] = (mass * fr).sum(dim=1)
        sumwab[t] = vwab.sum(dim=1)
        velg[t] = (vwab[..., None] * vel[j]).sum(dim=1)
        # rows [Shepard, d/dx_a]; columns [1, dx_a]
        rows = torch.cat([vwab[..., None], fr * volp2[..., None]], dim=-1)
        cols = torch.cat([torch.ones_like(vwab)[..., None], dr[..., axes]],
                         dim=-1)
        amat[t] = (rows[..., :, None] * cols[..., None, :]).sum(dim=1)

    determ = torch.linalg.det(amat)
    first = determ.abs() >= DETERMLIMIT
    eye = torch.eye(d, dtype=f32, device=dev)
    amat_safe = torch.where(first[:, None, None], amat, eye)
    b = torch.cat([rhop1[:, None], grad], dim=1)
    sol = torch.linalg.solve_ex(amat_safe, b[..., None])[0][..., 0]
    rho1st = sol[:, 0] + (-sol[:, 1:] * -nrm[:, axes]).sum(dim=-1)
    a11 = amat[:, 0, 0]
    shepard = a11 > 0
    a11s = torch.where(shepard, a11, 1.0)
    rho0th = rhop1 / a11s
    branch = torch.where(first, FIRST_ORDER,
                         torch.where(shepard, SHEPARD, RHO0))
    rhog = torch.where(first, rho1st,
                       torch.where(shepard, rho0th, csp.rhopzero))
    velg = velg / a11s[:, None]
    if csp.simulate2d:
        velg[:, 1] = 0.0
    return GhostNodes(idx=idx, determ=determ, branch=branch, rho=rhog,
                      velg=velg, sumwab=sumwab)


def mdbc_correction(csp: CteSph, opts, dom: cd.Domain, cells: cd.CellDiv,
                    pos, vel, rho, code, boundnormal, motionvel=None):
    """Returns (vel, rho) with the boundary values corrected, the state
    in ``cells`` order.  ``opts.mdbc_threshold`` > 0 corrects only the
    particles whose Shepard sum reaches it; ``motionvel`` (n,3) is the wall
    velocity of NO_SLIP and FREE_SLIP (zero when None)."""
    g = ghost_nodes(csp, dom, cells, pos, vel, rho, code, boundnormal)
    idx = g.idx
    apply = (g.sumwab >= opts.mdbc_threshold if opts.mdbc_threshold > 0
             else torch.ones_like(g.sumwab, dtype=torch.bool))
    new_rho = rho.index_copy(0, idx, torch.where(apply, g.rho, rho[idx]))
    if opts.slipmode == TpSlipMode.VEL0:
        return vel, new_rho
    vg = g.velg
    mv = (torch.zeros_like(vg) if motionvel is None else motionvel[idx])
    if opts.slipmode == TpSlipMode.NO_SLIP:
        vfinal = 2.0 * mv - vg
    else:  # FREE_SLIP (the reference marks it experimental; same form)
        nrm = boundnormal[idx]
        norm = torch.sqrt((nrm * nrm).sum(dim=1, keepdim=True))
        nhat = nrm.abs() / torch.where(norm > 0, norm, 1.0)
        normvel = vg * nhat
        tangvel = vg - normvel
        moving = (mv * mv).sum(dim=1, keepdim=True) > 0
        vfinal = torch.where(moving, 2.0 * (mv * nhat) - normvel,
                             tangvel - normvel)
    new_vel = vel.index_copy(0, idx, torch.where(apply[:, None], vfinal,
                                                  vel[idx]))
    return new_vel, new_rho
