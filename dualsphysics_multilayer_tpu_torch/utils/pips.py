"""PIPS — particle-pair interactions per second (the reference's headline
throughput metric, `JDsPips.h:50-80`, CLI `-svpips`).

Counterpart of `dualsphysics_multilayer_tpu/utils/pips.py`: counts the
*real* pair interactions (ALMOSTZERO <= rr2 <= KernelSize^2, ordered pairs
of live particles) and the *checked* candidates of one interaction from the
live state, and turns a measured step time into PIPS/GPIPS plus the
checked/real ratio of the neighbour search.

``real_pairs`` equals the JAX package's count on the same state.
``checked_pairs`` counts the port's own candidate walk: each live target's
9 (3 in 2D) contiguous slot ranges of ``csrc/cellwalk.cuh``, on a fresh
divide.  The JAX figure counts the bucket lanes of its layout, so the two
checked counts differ by design.
"""

from __future__ import annotations

import torch

from .. import typesdef as td
from ..ops import celldiv as cd
from ..ops import forces as F


def count_pairs(csp, dom, state, max_pairs: int = 1 << 22):
    """Returns (real_pairs, checked_candidates) for the current state: the
    JDsPips::ComputeCpu counting pass over a fresh divide."""
    cells, code = cd.divide_cells(dom, state.pos, state.code)
    o = cells.order
    pos, code = state.pos[o], code[o]
    live = td.is_active(code) & (cells.cell < dom.ncells)
    real = checked = 0
    for t, j, valid in F.candidate_chunks(dom, cells, live, max_pairs):
        dr = pos[t, None, :] - pos[j]
        rr2 = (dr * dr).sum(dim=-1)
        real += int((valid & (rr2 <= csp.kernelsize2)
                     & (rr2 >= td.ALMOSTZERO)).sum())
        checked += int(valid.sum())
    return real, checked


def pips_report(csp, dom, state, step_seconds, interactions_per_step=2):
    """One JDsPips-style report line."""
    real, checked = count_pairs(csp, dom, state)
    pis = real * interactions_per_step / step_seconds
    return dict(
        real_pairs=real,
        checked_pairs=checked,
        check_ratio=checked / max(real, 1),
        pips=pis,
        gpips=pis / 1e9,
    )
