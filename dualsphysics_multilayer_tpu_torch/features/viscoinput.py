"""Time-varying viscosity input (the JDsViscoInput channel).

Counterpart of `dualsphysics_multilayer_tpu/features/viscoinput.py`
(reference `JDsViscoInput.h/cpp`): a CSV table (time, viscosity) loaded by
the ``<parameters>`` key ``ViscoTime``; each step the solver looks up
``Visco = table(TimeStep)`` before the force interaction
(`JSphCpuSingle.cpp:1092` ``ViscoTime->GetVisco``).

The step reads its absolute time on the host, from the one device-to-host
copy it already makes (``models.wcsph._sync_flags``), so the lookup runs on
the host in float32 and the value goes to the kernels as a launch
parameter: no device operation and no host read of its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ViscoInput:
    """Static (times, values) viscosity time series."""
    times: tuple        # strictly increasing
    values: tuple

    def visco_at(self, tabs):
        """Linear interpolation in float32, clamped at the ends (the
        reference's JLinearValue::GetValue), with ``jnp.interp``'s
        arithmetic as the JAX package runs it."""
        xp = np.asarray(self.times, np.float32)
        fp = np.asarray(self.values, np.float32)
        x = np.float32(tabs)
        i = min(max(int(np.searchsorted(xp, x, side="right")), 1),
                len(xp) - 1)
        dx = xp[i] - xp[i - 1]
        if abs(dx) <= np.spacing(np.finfo(np.float32).eps):
            f = fp[i - 1]
        else:
            # one rounding of the product and sum, as XLA's fused
            # multiply-add on the JAX package's CPU path (the f64 product
            # of two f32 values is exact)
            q = np.float64((x - xp[i - 1]) / dx)
            f = np.float32(fp[i - 1] + q * np.float64(fp[i] - fp[i - 1]))
        if x < xp[0]:
            f = fp[0]
        if x > xp[-1]:
            f = fp[-1]
        return np.float32(f)


def load_viscoinput(path) -> ViscoInput:
    """Load the reference CSV/ASCII format: '#'-comments, one 'time value'
    pair per row, separators space/;/, (JReadDatafile + JDsViscoInput::
    LoadFile)."""
    times, values = [], []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = [p for p in line.replace(";", " ").replace(",", " ").split()
                     if p]
            if len(parts) < 2:
                continue
            try:
                tv, vv = float(parts[0]), float(parts[1])
            except ValueError:
                continue        # header row
            times.append(tv)
            values.append(vv)
    if not times:
        raise ValueError(f"ViscoTime file {path!r} has no (time, visco) rows")
    order = np.argsort(times)
    return ViscoInput(times=tuple(np.asarray(times)[order]),
                      values=tuple(np.asarray(values)[order]))
