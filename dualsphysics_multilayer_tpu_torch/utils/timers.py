"""Named phase timers (the reference's `JDsTimers`, CPU ontology
`JDsTimersCpu.h:28-85`, TmStart/TmStop/ShowTimes) and the step profiler.

Counterpart of `dualsphysics_multilayer_tpu/utils/timers.py` (``Timers``,
``profile_step``), on ``time.perf_counter``.  A timer reads the host
clock: around device work it measures launches unless the caller
synchronises the device first, as :func:`profile_step` does.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import replace

import torch


class Timers:
    """Named accumulating wall timers (TmStart/TmStop/ShowTimes analog)."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = {}

    def start(self, name):
        self._t0[name] = time.perf_counter()

    def stop(self, name):
        dt = time.perf_counter() - self._t0.pop(name)
        self.acc[name] += dt
        self.counts[name] += 1
        return dt

    def table(self):
        total = sum(self.acc.values()) or 1.0
        rows = [f"{'Timer':<24}{'calls':>8}{'total_s':>12}{'%':>8}"]
        for k in sorted(self.acc, key=lambda k: -self.acc[k]):
            rows.append(f"{k:<24}{self.counts[k]:>8}{self.acc[k]:>12.4f}"
                        f"{100 * self.acc[k] / total:>8.1f}")
        return "\n".join(rows)


def profile_step(csp, opts, dom, state, reps=10):
    """Per-phase times of one configuration (JAX ``profile_step``), each
    the host clock over ``reps`` calls after a first one, ending in
    ``torch.cuda.synchronize()`` when the state is on the card, so a time
    is the device's work plus its launches.  Returns {phase: seconds per
    call}: ``NL-Divide``, the divide and the permute of a rebuild
    (``wcsph._rebuild``); ``CF-Forces``, one interaction on the permuted
    state (the CUDA kernel on the card, its plain version on the CPU);
    ``SU-FullStep``, ``make_step`` over K = max(reps, 5) steps after K
    warm-up steps, per step."""
    from ..models.wcsph import make_carry, make_step
    from ..ops import celldiv as cd
    from ..ops import forces as F

    sync = (torch.cuda.synchronize if state.pos.device.type == "cuda"
            else (lambda: None))

    def timeit(fn, n):
        out = fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        sync()
        return out, (time.perf_counter() - t0) / n

    def divide():
        cells, code = cd.divide_cells(dom, state.pos, state.code)
        return cells, replace(state, code=code).permuted(cells.order)

    out = {}
    (cells, st), out["NL-Divide"] = timeit(divide, reps)
    _, out["CF-Forces"] = timeit(lambda: F.interaction_forces(
        csp, opts, dom, cells, st.pos, st.vel, st.rho, st.code,
        spstau=st.spstau), reps)
    step = make_step(csp, opts, dom)
    K = max(reps, 5)
    carry = make_carry(state, csp, opts, dom)
    for k in range(2 * K):
        if k == K:
            sync()
            t0 = time.perf_counter()
        carry = step(carry)
    sync()
    out["SU-FullStep"] = (time.perf_counter() - t0) / K
    return out
