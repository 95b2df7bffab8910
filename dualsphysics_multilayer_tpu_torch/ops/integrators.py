"""Time integrators on torch tensors: symplectic predictor/corrector, Verlet,
and the variable-dt controller.  Counterpart of
`dualsphysics_multilayer_tpu/ops/integrators.py`, term for term and in the
same order of operations, so that f32 results agree to the last bits.

* `JSphCpu::ComputeSymplecticPre`  (JSphCpu.cpp:1406)
* `JSphCpu::ComputeSymplecticCorr` (JSphCpu.cpp:1510)
* `JSphCpu::ComputeVerlet*`        (JSphCpu.cpp:1300-1400)
* `JSphCpu::DtVariable`            (JSphCpu.cpp:1614-1639)

Gravity is added here (interaction ``ace`` excludes it).  Out-of-range
density marks formerly-normal fluid particles OUT_RHOP.
"""

from __future__ import annotations

import torch

from .. import typesdef as td
from ..typesdef import CteSph


def _split_masks(code):
    act = td.is_active(code)
    bound = td.is_bound(code) & act
    floating = td.is_floating(code) & act
    fluid = td.is_fluid(code) & act
    return bound, floating, fluid


def _mark_outrhop(csp: CteSph, code, rho, fluid):
    out = fluid & td.is_normal(code) & ((rho < csp.rhopoutmin)
                                        | (rho > csp.rhopoutmax))
    return torch.where(out, td.code_set_special(code, td.SPECIAL_OUT_RHOP), code)


def _gravity(csp: CteSph, like):
    return torch.tensor(csp.gravity, dtype=like.dtype, device=like.device)


def symplectic_pre(csp: CteSph, pos, vel, rho, code, ace, ar, dt):
    """Predictor half-step (JSphCpu.cpp:1406-1500).  Returns
    (pos_new, vel_new, rho_new, code_new)."""
    dt05 = dt * 0.5
    bound, floating, fluid = _split_masks(code)
    rho_new = rho + dt05 * ar
    rho_new = torch.where((bound | floating) & (rho_new < csp.rhopzero),
                          csp.rhopzero, rho_new)
    vel_new = vel + (ace + _gravity(csp, vel)) * dt05
    # bound/floating velocities pass through unchanged
    vel_new = torch.where(fluid[:, None], vel_new, vel)
    pos_new = torch.where(fluid[:, None], pos + vel * dt05, pos)
    return pos_new, vel_new, rho_new, _mark_outrhop(csp, code, rho_new, fluid)


def comp_pos_update(pos, pose, disp, fluid):
    """Compensated (Kahan two-sum) position accumulation: ``pos + pose``
    carries the position to ~2x24 bits while ``pos`` stays plain f32.

    The three lines must run in exactly this order and without contraction
    to FMA; torch eager runs each as its own rounded f32 operation."""
    y = disp + pose
    pos_new = pos + y
    pose_new = y - (pos_new - pos)
    fl = fluid[:, None]
    return torch.where(fl, pos_new, pos), torch.where(fl, pose_new, pose)


def symplectic_corr(csp: CteSph, pos_pre, vel_pre, rho_pre, rho_now, code,
                    ace, ar, dt, pose):
    """Corrector full step (JSphCpu.cpp:1510-1610).  ``rho_now`` is the
    predictor-stage density; ``pose`` is the compensated-position residual.
    Returns (pos_new, vel_new, rho_new, code_new, pose_new)."""
    dt05 = dt * 0.5
    bound, floating, fluid = _split_masks(code)
    eps_rdot = (-ar / rho_now) * dt
    rho_new = rho_pre * (2.0 - eps_rdot) / (2.0 + eps_rdot)
    rho_new = torch.where((bound | floating) & (rho_new < csp.rhopzero),
                          csp.rhopzero, rho_new)
    vel_new = vel_pre + (ace + _gravity(csp, vel_pre)) * dt
    vel_new = torch.where(fluid[:, None], vel_new, vel_pre)
    disp = (vel_pre + vel_new) * dt05
    code_new = _mark_outrhop(csp, code, rho_new, fluid)
    pos_new, pose_new = comp_pos_update(pos_pre, pose, disp, fluid)
    return pos_new, vel_new, rho_new, code_new, pose_new


def verlet(csp: CteSph, pos, vel, rho, velm1, rhom1, code, ace, ar, dt,
           use_m1, pose):
    """Verlet step (JSphCpu.cpp:1300-1400): leapfrog (dt2=2dt against the M1
    state) when ``use_m1``, else the Euler re-anchoring step.  Returns
    (pos, vel_new, rho_new, code, pose)."""
    bound, floating, fluid = _split_masks(code)
    acegr = ace + _gravity(csp, vel)
    use_m1 = torch.as_tensor(use_m1, device=vel.device)
    base_v = torch.where(use_m1, velm1, vel)
    base_r = torch.where(use_m1, rhom1, rho)
    dt2 = torch.where(use_m1, 2.0 * dt, dt)
    rho_new = base_r + dt2 * ar
    rho_new = torch.where((bound | floating) & (rho_new < csp.rhopzero),
                          csp.rhopzero, rho_new)
    vel_new = base_v + acegr * dt2
    vel_new = torch.where(fluid[:, None], vel_new, vel)
    disp = vel * dt + acegr * (0.5 * dt * dt)
    code_new = _mark_outrhop(csp, code, rho_new, fluid)
    pos_new, pose_new = comp_pos_update(pos, pose, disp, fluid)
    return pos_new, vel_new, rho_new, code_new, pose_new


def dt_variable_parts(csp: CteSph, acemax, velmax, viscdtmax):
    """Adaptive dt (JSphCpu.cpp:1614-1639): dt1 = sqrt(h/|a|max);
    dt2 = h/(max(cs0,10*velmax) + h*viscdtmax); dt = CFL*min, clamped to
    DtMin.  Returns (dt, clamped?, dt1, dt2) as 0-d tensors."""
    h = csp.kernelh
    dt1 = torch.where(acemax > 0, torch.sqrt(h / torch.clamp(acemax, min=1e-30)),
                      3.4e38)
    dt2 = h / (torch.clamp(velmax * 10.0, min=csp.cs0) + h * viscdtmax)
    dt = csp.cflnumber * torch.minimum(dt1, dt2)
    if csp.dtfixed:
        dt = torch.full_like(dt, csp.dtfixed)
    bad = torch.isnan(dt) | torch.isinf(dt) | (dt < csp.dtmin)
    return torch.where(bad, csp.dtmin, dt), bad, dt1, dt2


def dt_variable(csp: CteSph, acemax, velmax, viscdtmax):
    """(dt, clamped?) — see :func:`dt_variable_parts`."""
    dt, bad, _, _ = dt_variable_parts(csp, acemax, velmax, viscdtmax)
    return dt, bad


def velocity_max(csp: CteSph, vel, code):
    """Max |v| for the dt control (JSphCpu.cpp:452-480): fluid and floating
    particles unless DtAllParticles."""
    sel = td.is_active(code)
    if not csp.dtallparticles:
        sel = sel & ~td.is_bound(code)
    v2 = (vel * vel).sum(dim=-1)
    return torch.sqrt(torch.where(sel, v2, 0.0).amax())


def ace_max(ace, code):
    """Max |ace| for dt1 (JSphCpuSingle.cpp:584-644): fluid-side normal
    particles."""
    sel = ~td.is_bound(code) & td.is_normal(code)
    a2 = (ace * ace).sum(dim=-1)
    return torch.sqrt(torch.where(sel, a2, 0.0).amax())
