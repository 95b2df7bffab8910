"""Shared helpers of the post-processing tools.

Counterpart of `dualsphysics_multilayer_tpu/tools/common.py`; the port
keeps what its run needs: the JRangeFilter grammar of ``-svextraparts`` and
``-initnorpart`` (reference `JRangeFilter.cpp`), and the host neighbour
search and Wendland kernel of the boundary-normal estimate
(``features/initialize.py`` InitBoundNormalParts).
"""

from __future__ import annotations

import numpy as np


def parse_range_filter(txt):
    """JRangeFilter grammar: "1,3-5,7" -> sorted int array."""
    vals = set()
    for tok in str(txt).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "-" in tok[1:]:
            i = tok.index("-", 1)
            lo, hi = int(tok[:i]), int(tok[i + 1:])
            vals.update(range(lo, hi + 1))
        else:
            vals.add(int(tok))
    return np.array(sorted(vals), dtype=np.int64)


def pair_indices(src_pos, tgt_pos, radius):
    """All (ti, sj) pairs with |tgt[ti] - src[sj]| < radius, by cell
    binning in float64: the host analog of the solver's cell-linked
    neighbour search (JCellDivCpu)."""
    src = np.asarray(src_pos, np.float64)
    tgt = np.asarray(tgt_pos, np.float64)
    if len(src) == 0 or len(tgt) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    org = src.min(0) - radius
    cell = np.maximum(np.floor((src - org) / radius).astype(np.int64), 0)
    ncel = cell.max(0) + 1
    strides = np.array([ncel[1] * ncel[2], ncel[2], 1], np.int64)
    key = cell @ strides
    order = np.argsort(key, kind="stable")
    skey = key[order]
    # target cells may lie off the source grid: skipped there, and the
    # distance test decides the rest
    tcell = np.floor((tgt - org) / radius).astype(np.int64)
    ti_all, sj_all = [], []
    r2 = radius * radius
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nc = tcell + (dx, dy, dz)
                ok = np.all((nc >= 0) & (nc < ncel), axis=1)
                if not ok.any():
                    continue
                tk = nc[ok] @ strides
                lo = np.searchsorted(skey, tk, side="left")
                hi = np.searchsorted(skey, tk, side="right")
                cnt = hi - lo
                nz = cnt > 0
                if not nz.any():
                    continue
                tidx = np.where(ok)[0][nz]
                lo, cnt = lo[nz], cnt[nz]
                ti = np.repeat(tidx, cnt)
                # the ragged ranges lo[k] .. lo[k] + cnt[k]
                sj = np.repeat(lo, cnt) + (np.arange(cnt.sum())
                                           - np.repeat(np.cumsum(cnt) - cnt,
                                                       cnt))
                sj = order[sj]
                d2 = ((tgt[ti] - src[sj]) ** 2).sum(1)
                keep = d2 < r2
                ti_all.append(ti[keep])
                sj_all.append(sj[keep])
    if not ti_all:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    return np.concatenate(ti_all), np.concatenate(sj_all)


def wendland_wab(sim2d, h, rr2):
    """Wendland C2 W(r) at squared distances ``rr2`` with the reference's
    constants (FunSphKernel.h:191-216), in numpy."""
    qq = np.sqrt(rr2) / h
    awen = (0.557 / (h * h) if sim2d else 0.41778 / (h ** 3))
    wqq = 2.0 * qq + 1.0
    wqq1 = np.maximum(1.0 - 0.5 * qq, 0.0)
    wqq2 = wqq1 * wqq1
    return awen * wqq * wqq2 * wqq2
