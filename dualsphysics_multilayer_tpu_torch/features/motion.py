"""Scripted boundary motion (moving walls, pistons, flaps) on torch tensors.

Counterpart of `dualsphysics_multilayer_tpu/features/motion.py` (the
reference's `JMotion` stack with the `JMotionMov` primitives): a motion is
a function of time, a per-mk timeline of analytic segments evaluated at
the start of the step (``t``) and one ``dt`` later.  The segment kinds,
their parameter layouts and the composition rules are the JAX package's;
the arithmetic runs in f32 in the same order.

Times are 0-d device tensors (the carry's ``tabs`` and the step's ``dt``):
the constants of a segment go to the device as small tensors and nothing is
read back to the host, so a step's motion costs a few dozen small device
operations and no synchronisation.

:func:`apply_motion` moves the moving boundary particles of each block as
`JSphCpu::RunMotion` does (JSphCpu.cpp:1752-1790): a displacement (linear,
or a rotation about an axis plus a displacement) and the motion velocity,
which the next interaction reads (DBC walls push the fluid through the dv
terms).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import typesdef as td
from .devconst import vec as _vec

# segment kinds (the JAX package's numbering)
WAIT = 0
RECT = 1       # constant velocity;        params: vx vy vz
RECT_ACE = 2   # accelerated linear;       params: vx0.. ax..
SIN_RECT = 3   # sinusoidal linear;        params: freq, phase, ampx..z[, ramp]
ROT = 4        # constant angular vel;     params: axis p1(3), p2(3), degrees/s
ROT_ACE = 5    # accelerated rotation;     params: + ang accel
SIN_ROT = 6    # sinusoidal rotation;      params: p1, p2, freq, phase, amp(deg)
TABLE = 7      # velocity time series (linear interpolation)
SPECTRUM = 8   # sum of sinusoids; params: dir(3), ramptime;
#                times: omegas; values: (amp, phase)*
SPECTRUM_ROT = 9  # rotational spectrum; params: p1(3) p2(3) ramptime
# circular paths (JMotionMovCir*): the block translates along the circle a
# reference point sweeps about the axis, its orientation unchanged;
# params: p1(3), p2(3), the rotation twin's angle law, then ref(3) last
CIR = 10
CIR_ACE = 11
SIN_CIR = 12
ROT_FILE = 13   # rotation angle time series; times: knots, values: angle (rad)
TABLE_POS = 14  # position time series; times: knots, values: (x,y,z) knots

_CIR_LAW = {CIR: ROT, CIR_ACE: ROT_ACE, SIN_CIR: SIN_ROT}
_ROT_KINDS = (ROT, ROT_ACE, SIN_ROT, SPECTRUM_ROT, ROT_FILE)

_F32 = torch.float32


@dataclass(frozen=True)
class Segment:
    kind: int
    t0: float
    t1: float
    params: tuple = ()
    # table and spectrum payloads (times, values) as tuples
    times: tuple = ()
    values: tuple = ()


@dataclass(frozen=True)
class MotionDef:
    """Timeline of segments for one moving mk block."""
    mk: int
    segments: tuple          # of Segment
    loop_t: float = 0.0      # if > 0 the timeline repeats with this period
    # times past loop_start wrap into [loop_start, loop_start + loop_t)
    loop_start: float = 0.0
    t_end: float = 0.0       # no displacement past this time (0: none)


def _wgramp(t, tr):
    """Wave-generator start-up envelope tau^2 (3 tau^2 - 8 tau + 6),
    tau = min(t/tr, 1) (JWaveRegular::CalcFunRamp; env(1) = 1,
    env'(1) = 0)."""
    tau = torch.clamp(t / tr, max=1.0)
    return tau * tau * (3.0 * tau * tau - 8.0 * tau + 6.0)


def _wgramp_d(t, tr):
    """d/dt of :func:`_wgramp`."""
    tau = torch.clamp(t / tr, max=1.0)
    return torch.where(t < tr, 12.0 * tau * (tau - 1.0) ** 2 / tr, 0.0)


def _window(seg: Segment, t0, t1):
    """(a, b, active_end): the step [t0, t1] clipped to the segment, in
    segment-relative time, and whether t1 lies inside the segment."""
    a = torch.clamp(t0 - seg.t0, min=0.0)
    b = torch.clamp(t1 - seg.t0, 0.0, seg.t1 - seg.t0)
    b = torch.maximum(b, a)
    return a, b, (t1 >= seg.t0) & (t1 < seg.t1)


def _knot(times, tt, k):
    """Index of the table interval holding tt (clipped to the table)."""
    tt = torch.clamp(tt, times[0], times[-1])
    i = torch.searchsorted(times, tt.reshape(1), right=True)[0] - 1
    return tt, torch.clamp(i, 0, k - 2)


def _sum_sines(amp, w, ph, tt, tr):
    """(x(tt), dx/dt(tt)) of the sum amp sin(w tt + ph), enveloped by the
    start-up ramp when tr > 0."""
    s = (amp * torch.sin(w * tt + ph)).sum()
    dv = (amp * w * torch.cos(w * tt + ph)).sum()
    if tr > 0:
        return _wgramp(tt, tr) * s, _wgramp(tt, tr) * dv + _wgramp_d(tt, tr) * s
    return s, dv


def _segment_disp_vel(seg: Segment, t0, t1):
    """Displacement over [t0, t1] (clipped to the segment) and the velocity
    at t1 of a linear segment: ((3,), (3,))."""
    a, b, active_end = _window(seg, t0, t1)
    zero = torch.zeros(3, dtype=_F32, device=t1.device)
    if seg.kind == RECT:
        v = _vec(seg.params[:3], t1)
        disp = v * (b - a)
        vel = torch.where(active_end, v, 0.0)
    elif seg.kind == RECT_ACE:
        v0 = _vec(seg.params[:3], t1)
        ac = _vec(seg.params[3:6], t1)
        disp = v0 * (b - a) + 0.5 * ac * (b * b - a * a)
        vel = torch.where(active_end, v0 + ac * b, 0.0)
    elif seg.kind == SIN_RECT:
        f, ph = seg.params[0], seg.params[1]
        amp = _vec(seg.params[2:5], t1)
        w = 2.0 * math.pi * f
        if len(seg.params) > 5 and seg.params[5] > 0:
            # start-up ramp: x = env(t) A sin(wt + ph)
            tr = seg.params[5]
            ea, eb = _wgramp(a, tr), _wgramp(b, tr)
            disp = amp * (eb * torch.sin(w * b + ph) - ea * torch.sin(w * a + ph))
            denv = _wgramp_d(b, tr)
            vel = torch.where(active_end,
                              amp * (denv * torch.sin(w * b + ph)
                                     + eb * w * torch.cos(w * b + ph)), 0.0)
        else:
            disp = amp * (torch.sin(w * b + ph) - torch.sin(w * a + ph))
            vel = torch.where(active_end, amp * w * torch.cos(w * b + ph), 0.0)
    elif seg.kind == SPECTRUM:
        dirv = _vec(seg.params[:3], t1)
        tr = seg.params[3] if len(seg.params) > 3 else 0.0
        w = _vec(seg.times, t1)
        ap = _vec(seg.values, t1).reshape(-1, 2)
        xa, _ = _sum_sines(ap[:, 0], w, ap[:, 1], a, tr)
        xb, vb = _sum_sines(ap[:, 0], w, ap[:, 1], b, tr)
        disp = dirv * (xb - xa)
        vel = torch.where(active_end, dirv * vb, 0.0)
    elif seg.kind == TABLE:
        # knots are absolute, a and b segment-relative; the displacement is
        # the integral of the piecewise-linear velocity (cumulative
        # trapezoids at the knots)
        k = len(seg.times)
        times = _vec(seg.times, t1) - seg.t0
        vals = _vec(seg.values, t1).reshape(k, 3)
        cum = torch.cat([torch.zeros((1, 3), dtype=_F32, device=t1.device),
                         torch.cumsum(0.5 * (vals[1:] + vals[:-1])
                                      * (times[1:] - times[:-1])[:, None],
                                      dim=0)])

        def pos_at(tt):
            tt, i = _knot(times, tt, k)
            dtl = tt - times[i]
            vi = vals[i] + (vals[i + 1] - vals[i]) * (
                dtl / torch.clamp(times[i + 1] - times[i], min=1e-12))
            return cum[i] + 0.5 * (vals[i] + vi) * dtl, vi

        pa, _ = pos_at(a)
        pb, vb = pos_at(b)
        disp = pb - pa
        vel = torch.where(active_end, vb, 0.0)
    elif seg.kind == TABLE_POS:
        k = len(seg.times)
        times = _vec(seg.times, t1) - seg.t0
        ps = _vec(seg.values, t1).reshape(k, 3)

        def pos_at(tt):
            tt, i = _knot(times, tt, k)
            span = torch.clamp(times[i + 1] - times[i], min=1e-12)
            f = (tt - times[i]) / span
            return ps[i] + (ps[i + 1] - ps[i]) * f, (ps[i + 1] - ps[i]) / span

        pa, _ = pos_at(a)
        pb, vb = pos_at(b)
        disp = pb - pa
        vel = torch.where(active_end, vb, 0.0)
    else:  # WAIT
        disp, vel = zero, zero
    return torch.where(t1 > seg.t0, disp, 0.0), vel


def _segment_angle(seg: Segment, t0, t1):
    """Rotation angle swept over [t0, t1] (radians) and the angular speed
    at t1."""
    a, b, active_end = _window(seg, t0, t1)
    d2r = math.pi / 180.0
    kind = _CIR_LAW.get(seg.kind, seg.kind)
    if kind == ROT_FILE:
        k = len(seg.times)
        times = _vec(seg.times, t1) - seg.t0
        angs = _vec(seg.values, t1)

        def ang_at(tt):
            tt, i = _knot(times, tt, k)
            span = torch.clamp(times[i + 1] - times[i], min=1e-12)
            f = (tt - times[i]) / span
            return angs[i] + (angs[i + 1] - angs[i]) * f, \
                (angs[i + 1] - angs[i]) / span

        anga, _ = ang_at(a)
        angb, wb = ang_at(b)
        return torch.where(t1 > seg.t0, angb - anga, 0.0), \
            torch.where(active_end, wb, 0.0)
    if kind == ROT:
        w = seg.params[6] * d2r
        dang = w * (b - a)
        wend = torch.where(active_end, w, 0.0)
    elif kind == ROT_ACE:
        w0 = seg.params[6] * d2r
        al = seg.params[7] * d2r
        dang = w0 * (b - a) + 0.5 * al * (b * b - a * a)
        wend = torch.where(active_end, w0 + al * b, 0.0)
    elif kind == SPECTRUM_ROT:
        tr = seg.params[6] if len(seg.params) > 6 else 0.0
        w = _vec(seg.times, t1)
        ap = _vec(seg.values, t1).reshape(-1, 2)
        xa, _ = _sum_sines(ap[:, 0], w, ap[:, 1], a, tr)
        xb, wb = _sum_sines(ap[:, 0], w, ap[:, 1], b, tr)
        dang = xb - xa
        wend = torch.where(active_end, wb, 0.0)
    else:  # SIN_ROT
        f, ph, amp = seg.params[6], seg.params[7], seg.params[8] * d2r
        w = 2.0 * math.pi * f
        if len(seg.params) > 9 and seg.params[9] > 0:
            tr = seg.params[9]
            ea, eb = _wgramp(a, tr), _wgramp(b, tr)
            dang = amp * (eb * torch.sin(w * b + ph) - ea * torch.sin(w * a + ph))
            wend = torch.where(active_end,
                               amp * (_wgramp_d(b, tr) * torch.sin(w * b + ph)
                                      + eb * w * torch.cos(w * b + ph)), 0.0)
        else:
            dang = amp * (torch.sin(w * b + ph) - torch.sin(w * a + ph))
            wend = torch.where(active_end, amp * w * torch.cos(w * b + ph), 0.0)
    return torch.where(t1 > seg.t0, dang, 0.0), wend


def _axis_of(seg: Segment, like):
    """(point on the axis, unit axis) of a rotation or circle segment."""
    p1 = np.asarray(seg.params[:3], np.float32)
    p2 = np.asarray(seg.params[3:6], np.float32)
    ax = p2 - p1
    ax = ax / max(np.linalg.norm(ax), 1e-12)
    return _vec(p1.tolist(), like), _vec(ax.tolist(), like)


def _rot_matrix(axis, ang):
    """Rodrigues rotation matrix (3,3) about the unit ``axis`` by ``ang``."""
    c, s = torch.cos(ang), torch.sin(ang)
    x, y, z = axis[0], axis[1], axis[2]
    o = 0.0 * x
    kmat = torch.stack([torch.stack([o, -z, y]), torch.stack([z, o, -x]),
                        torch.stack([-y, x, o])])
    eye = torch.eye(3, dtype=_F32, device=axis.device)
    return eye * c + s * kmat + (1 - c) * torch.outer(axis, axis)


def motion_step(mdef: MotionDef, t, dt):
    """One moving block over [t, t + dt], ``t`` and ``dt`` 0-d f32 tensors.

    Returns (disp (3,), vel (3,), rot (3,3), center (3,), has_rot, axis
    (3,), wvel ()): linear segments add their displacements and velocities,
    rotations add their angles about the (last) axis, as in JAX."""
    t = torch.as_tensor(t, dtype=_F32)
    dt = torch.as_tensor(dt, dtype=_F32, device=t.device)
    if mdef.t_end:
        te = _vec((mdef.t_end,), t)[0]
        t, dt = torch.minimum(t, te), torch.clamp(
            torch.minimum(t + dt, te) - torch.minimum(t, te), min=0.0)
    if mdef.loop_t:
        ls = np.float32(mdef.loop_start)
        t = torch.where(t < ls, t,
                        ls + torch.remainder(t - ls, mdef.loop_t))
    t0, t1 = t, t + dt
    disp = torch.zeros(3, dtype=_F32, device=t.device)
    vel = torch.zeros(3, dtype=_F32, device=t.device)
    ang = torch.zeros((), dtype=_F32, device=t.device)
    wvel = torch.zeros((), dtype=_F32, device=t.device)
    axis = _vec([0.0, 1.0, 0.0], t)
    center = torch.zeros(3, dtype=_F32, device=t.device)
    has_rot = False
    for seg in mdef.segments:
        if seg.kind in _ROT_KINDS:
            da, wv = _segment_angle(seg, t0, t1)
            ang = ang + da
            wvel = wvel + wv
            center, axis = _axis_of(seg, t)
            has_rot = True
        elif seg.kind in _CIR_LAW:
            # translate along the circle the reference point sweeps:
            # disp = (R(ang1) - R(ang0)) (ref - c), vel = w x radius(t1)
            start = _vec((seg.t0,), t)[0]
            ang0, _ = _segment_angle(seg, start, t0)
            ang1, wv = _segment_angle(seg, start, t1)
            c, ax = _axis_of(seg, t)
            r0 = _vec(seg.params[-3:], t) - c
            p0 = _rot_matrix(ax, ang0) @ r0
            p1 = _rot_matrix(ax, ang1) @ r0
            disp = disp + (p1 - p0)
            vel = vel + torch.linalg.cross(wv * ax, p1)
        else:
            d, v = _segment_disp_vel(seg, t0, t1)
            disp = disp + d
            vel = vel + v
    rot = _rot_matrix(axis, ang) if has_rot else torch.eye(
        3, dtype=_F32, device=t.device)
    return disp, vel, rot, center, has_rot, axis, wvel


def apply_motion(motions, t, dt, pos, vel, code):
    """Move every block of ``motions`` over [t, t + dt] (JSphCpu::RunMotion,
    MoveLinBound / MoveMatBound).  Returns (pos, vel)."""
    if not motions:
        return pos, vel
    moving = td.is_moving(code) & td.is_active(code)
    mkv = td.code_value(code)
    for mdef in motions:
        sel = (moving & (mkv == mdef.mk))[:, None]
        disp, mvel, rot, center, has_rot, axis, wvel = motion_step(mdef, t, dt)
        if has_rot:
            newp = (pos - center) @ rot.T + center + disp
            omega = (axis * wvel).expand_as(newp)
            pvel = torch.linalg.cross(omega, newp - center) + mvel
        else:
            newp = pos + disp
            pvel = mvel.expand_as(pos)
        pos = torch.where(sel, newp, pos)
        vel = torch.where(sel, pvel, vel)
    return pos, vel


# ---- constructors -----------------------------------------------------------

def piston_sinusoidal(mk, *, freq, amplitude, direction=(1.0, 0.0, 0.0),
                      tstart=0.0, tend=1e30, phase=0.0) -> MotionDef:
    """Sinusoidal piston x = A sin(2 pi f t + phase) along ``direction``
    (`JMotionMov` MovRectSinu)."""
    d = np.asarray(direction, np.float64)
    amp = tuple(float(a) for a in amplitude * d)
    return MotionDef(mk=mk, segments=(
        Segment(kind=SIN_RECT, t0=tstart, t1=tend,
                params=(freq, phase) + amp),))


def linear_motion(mk, *, vel, tstart=0.0, tend=1e30) -> MotionDef:
    return MotionDef(mk=mk, segments=(
        Segment(kind=RECT, t0=tstart, t1=tend, params=tuple(vel)),))


def rotation_motion(mk, *, axis_p1, axis_p2, degrees_per_s, tstart=0.0,
                    tend=1e30) -> MotionDef:
    return MotionDef(mk=mk, segments=(
        Segment(kind=ROT, t0=tstart, t1=tend,
                params=tuple(axis_p1) + tuple(axis_p2) + (degrees_per_s,)),))


def table_motion(mk, times, velocities, *, tstart=0.0) -> MotionDef:
    """Velocity time-series motion (the `mvfile` path)."""
    times = tuple(float(x) + tstart for x in times)
    vals = tuple(float(v) for row in velocities for v in row)
    return MotionDef(mk=mk, segments=(
        Segment(kind=TABLE, t0=times[0], t1=times[-1], times=times,
                values=vals),))
