"""Shared helpers of the post-processing tools.

Counterpart of `dualsphysics_multilayer_tpu/tools/common.py`; the port
keeps the one function its run output needs, the JRangeFilter grammar of
``-svextraparts`` (reference `JRangeFilter.cpp`).
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
