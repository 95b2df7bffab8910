"""Constants of the feature configurations as device tensors.

A feature's tables (segment amplitudes, zone corners, velocity series) are
Python tuples; a step reads them as small f32 tensors on the state's
device.  Each is made once per device: a host-to-device copy from pageable
memory waits for the stream, so a step must not make one.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def vec(values, like):
    """``values`` (a flat sequence of numbers) as an f32 tensor on the
    device of the tensor ``like``; the caller must not write to it."""
    return _const(tuple(float(v) for v in values), like.device)
