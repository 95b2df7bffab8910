"""Time-varying external accelerations per mk block, on torch tensors.

Counterpart of `dualsphysics_multilayer_tpu/features/accinput.py` (the
reference's `JDsAccInput`): each input drives one fluid mk (or a set of
boundary mks) with a linear and an angular acceleration series, optionally
in place of gravity.  The angular terms follow `JDsAccInput::RunCpu`
(JDsAccInput.cpp:340-395):

    a += dw/dt x r  +  w x (w x r)  +  2 w x (v - v_frame)

with w and v_frame integrated from the series by forward Euler when the
input is made (JDsAccInput.cpp:242-268).  The reference's Coriolis lines
drop v_frame from one product each; this computes the full cross product,
as the JAX package does (the two agree whenever v_frame is zero).  The
accelerations join the interaction's ``ace`` before the dt control, as
`PreInteractionVars_Forces` does (JSphCpu.cpp:445).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import typesdef as td
from .devconst import vec as _vec


@dataclass(frozen=True)
class AccInput:
    mkfluid: int = -1            # fluid mk target (-1 when mkbound is used)
    mkbound: tuple = ()          # boundary mk targets
    times: tuple = ()            # (k,)
    acclin: tuple = ()           # (k*3,) linear acceleration samples
    accang: tuple = ()           # (k*3,) angular acceleration (rad/s^2) or ()
    centre: tuple = (0.0, 0.0, 0.0)
    gravity_enabled: bool = True   # False: this input replaces gravity
    tstart: float = 0.0          # activation window
    tend: float = 1e30
    # frame velocities integrated from the series (made in __post_init__)
    vellin: tuple = ()           # (k*3,)
    velang: tuple = ()           # (k*3,)

    def __post_init__(self):
        if self.times and not self.vellin:
            lin, ang = _integrate(self.times, self.acclin, self.accang)
            object.__setattr__(self, "vellin", lin)
            object.__setattr__(self, "velang", ang)

    def at(self, t):
        """(acclin, accang, vellin, velang), each (3,), at the 0-d ``t``."""
        times = _vec(self.times, t)
        k = len(self.times)
        tt = torch.clamp(t, times[0], times[-1])
        i = torch.clamp(torch.searchsorted(times, tt.reshape(1),
                                           right=True)[0] - 1, 0, max(k - 2, 0))
        # i + 1 clamped, as the JAX gather clamps it, for a one-row table
        i1 = torch.clamp(i + 1, max=k - 1)
        w = (tt - times[i]) / torch.clamp(times[i1] - times[i], min=1e-12)

        def table(vals):
            if not vals:
                return torch.zeros(3, dtype=torch.float32, device=t.device)
            tab = _vec(vals, t).reshape(k, 3)
            return tab[i] + (tab[i1] - tab[i]) * w

        return (table(self.acclin), table(self.accang), table(self.vellin),
                table(self.velang))


def _integrate(times, acclin, accang):
    """Forward-Euler frame velocities from the acceleration series
    (JDsAccInput.cpp:242-268)."""
    t = np.asarray(times, np.float64)
    k = len(t)
    lin = np.asarray(acclin, np.float64).reshape(k, 3) if acclin \
        else np.zeros((k, 3))
    ang = np.asarray(accang, np.float64).reshape(k, 3) if accang \
        else np.zeros((k, 3))
    vlin = np.zeros((k, 3))
    vang = np.zeros((k, 3))
    for i in range(1, k):
        dt = t[i] - t[i - 1]
        vlin[i] = vlin[i - 1] + lin[i] * dt
        vang[i] = vang[i - 1] + ang[i] * dt
    return tuple(vlin.reshape(-1)), tuple(vang.reshape(-1))


def load_accinput_csv(path):
    """The reference's acctimesfile CSV: rows ``time alinx aliny alinz
    [aangx aangy aangz]``, '#' comments, space, ';' or ',' separators."""
    times, lins, angs = [], [], []
    with open(path) as f:
        for line in f:
            toks = [p for p in line.split("#", 1)[0]
                    .replace(";", " ").replace(",", " ").split() if p]
            if not toks:
                continue
            try:
                vals = [float(x) for x in toks]
            except ValueError:
                continue
            times.append(vals[0])
            row = vals[1:] + [0.0] * max(0, 7 - len(vals))
            lins.extend(row[0:3])
            angs.extend(row[3:6])
    if not times:
        raise ValueError(f"accinput file {path!r} has no data rows")
    return tuple(times), tuple(lins), tuple(angs)


def apply_accinput(inputs, csp, t, pos, vel, code, ace):
    """``ace`` (the interaction's, without gravity) plus the external
    accelerations of ``inputs`` at the 0-d time ``t``, term for term as
    `JDsAccInput::RunCpu`."""
    if not inputs:
        return ace
    mkv = td.code_value(code)
    act = td.is_active(code)
    fluid = td.is_fluid(code) & act
    bound = ~td.is_fluid(code) & act
    for inp in inputs:
        if inp.mkbound:
            sel = torch.zeros_like(bound)
            for mk in inp.mkbound:
                sel = sel | (mkv == mk)
            sel = bound & sel
        else:
            sel = fluid & (mkv == inp.mkfluid)
        on = (t >= inp.tstart) & (t <= inp.tend)
        alin, aang, vlin, vang = inp.at(t)
        add = alin.expand_as(ace)
        if not inp.gravity_enabled:
            add = add - _vec(csp.gravity, ace)
        if inp.accang:
            r = pos - _vec(inp.centre, pos)
            cross = torch.linalg.cross
            # dw/dt x r, w x (w x r) (centripetal), 2 w x (v - v_frame)
            add = add + cross(aang.expand_as(r), r)
            inner = cross(vang.expand_as(r), r)
            add = add + cross(vang.expand_as(r), inner)
            add = add + cross((2.0 * vang).expand_as(r), vel - vlin)
        ace = torch.where((sel & on)[:, None], ace + add, ace)
    return ace
