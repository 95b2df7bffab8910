"""Turn the JAX package's objects, given as plain fields and numpy arrays,
into the port's, so both packages can compute on the same state.

* ``ctesph(fields)``: ``dataclasses.asdict`` of a JAX ``CteSph``; enums
  map by name, kernel constant bundles by field.
* ``domain(fields)``: ``dataclasses.asdict`` of a JAX ``Domain``.  Its
  bucket capacities (``cellcap``, ``maxcells``) belong to the TPU layouts
  and have no counterpart here.
* ``simstate(arrays)``: a mapping of numpy arrays (``pos``, ``vel``,
  ``rho``, ``code``, ``idp`` and optionally ``pose``, which starts at zero
  when absent or None).  uint32 typecodes become int32 (every code fits in
  26 bits); uint32 ids, including the 0xFFFFFFFF fill of padding slots,
  become int64 unchanged.

The JAX-side ``SimState`` fields of features outside the slice (Verlet M1
state, SPS stress, floating bodies, mDBC normals) raise when present.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from . import typesdef as td
from .models.wcsph import SimState
from .ops.celldiv import Domain

_UNPORTED_STATE = ("velm1", "rhom1", "spstau", "ft", "boundnormal",
                   "motionvel")


def _name(v):
    return v.name if hasattr(v, "name") else v


def ctesph(fields: Mapping) -> td.CteSph:
    kw = dict(fields)
    kw["tkernel"] = td.TpKernel[_name(kw["tkernel"])]
    kw["kwend"] = td.KWendlandCte(**dict(kw["kwend"]))
    kw["kcubic"] = td.KCubicCte(**dict(kw["kcubic"]))
    kw["gravity"] = tuple(float(g) for g in kw["gravity"])
    return td.CteSph(**kw)


def domain(fields: Mapping) -> Domain:
    return Domain(posmin=tuple(float(p) for p in fields["posmin"]),
                  scell=float(fields["scell"]),
                  nc=tuple(int(c) for c in fields["nc"]),
                  simulate2d=bool(fields["simulate2d"]))


def simstate(arrays: Mapping, device="cpu") -> SimState:
    for k in _UNPORTED_STATE:
        if arrays.get(k) is not None:
            raise NotImplementedError(f"the torch port does not cover "
                                      f"SimState.{k} yet")
    code = np.asarray(arrays["code"])
    if code.size and int(code.max()) >= 1 << td.CODE_BITS:
        raise ValueError(f"typecode above {td.CODE_BITS} bits: "
                         f"{int(code.max()):#x}")

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    pos = f32(arrays["pos"])
    pose = arrays.get("pose")
    return SimState(
        pos=pos, vel=f32(arrays["vel"]), rho=f32(arrays["rho"]),
        code=torch.tensor(code.astype(np.int32), device=device),
        idp=torch.tensor(np.asarray(arrays["idp"]).astype(np.int64),
                         device=device),
        pose=torch.zeros_like(pos) if pose is None else f32(pose))
