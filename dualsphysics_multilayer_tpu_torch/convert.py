"""Turn the JAX package's objects, given as plain fields and numpy arrays,
into the port's, so both packages can compute on the same state.

* ``ctesph(fields)``: ``dataclasses.asdict`` of a JAX ``CteSph``; enums
  map by name, kernel constant bundles by field.
* ``domain(fields)``: ``dataclasses.asdict`` of a JAX ``Domain``.  Its
  bucket capacities (``cellcap``, ``maxcells``) belong to the TPU layouts
  and have no counterpart here.
* ``simstate(arrays)``: a mapping of numpy arrays (``pos``, ``vel``,
  ``rho``, ``code``, ``idp`` and optionally ``pose``, which starts at zero
  when absent or None, ``spstau``, the laminar+SPS stress, ``boundnormal``
  and ``motionvel``, the mDBC normals and wall velocity, and ``ft``, a
  mapping of the floating bodies' ``center``, ``fvel``, ``fomega`` and
  ``angles``).  uint32 typecodes become int32 (every code fits in 26
  bits); uint32 ids, including the 0xFFFFFFFF fill of padding slots,
  become int64 unchanged.  The state goes to the card unless ``device``
  says otherwise.
* ``phasecfg(phases)``: a JAX ``PhaseCfg``, read by attribute, as the
  port's ``forces_nn.PhaseCfg`` with plain Python values.
  The Verlet M1 state (``velm1``, ``rhom1``) comes along when present.
* ``floatingcfg(cfg)``: a JAX ``FloatingCfg``, read by attribute, as the
  port's ``features.floating.FloatingCfg``.
* ``feature(obj)``: a JAX feature configuration, read by attribute and
  matched by class name, as the port's class of that name: ``MotionDef``
  (with its ``Segment``s), the damping zones, the relaxation zones (the
  external zone's ``InOutGridVel`` becomes a ``relaxzone.GridVel``),
  ``MLPiston1D``/``MLPiston2D``, ``AwasZsurf``, ``AccInput`` and the
  gauges.  ``features(feats)``: a JAX ``Features`` bundle, each of its
  tuples converted; the fields the port does not run are kept as they are,
  so the step still refuses them.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import fields

import numpy as np
import torch

from . import typesdef as td
from .features import accinput, awas, damping, gauges, mlpiston, motion
from .features import relaxzone
from .features.featureset import Features
from .features.floating import FloatingCfg, FloatingState
from .models.wcsph import SimState
from .ops.celldiv import Domain
from .ops.forces_nn import Phase, PhaseCfg


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


def simstate(arrays: Mapping, device="cuda") -> SimState:
    code = np.asarray(arrays["code"])
    if code.size and int(code.max()) >= 1 << td.CODE_BITS:
        raise ValueError(f"typecode above {td.CODE_BITS} bits: "
                         f"{int(code.max()):#x}")

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def opt(k):
        return None if arrays.get(k) is None else f32(arrays[k])

    pos = f32(arrays["pos"])
    ft = arrays.get("ft")
    return SimState(
        pos=pos, vel=f32(arrays["vel"]), rho=f32(arrays["rho"]),
        code=torch.tensor(code.astype(np.int32), device=device),
        idp=torch.tensor(np.asarray(arrays["idp"]).astype(np.int64),
                         device=device),
        pose=torch.zeros_like(pos) if arrays.get("pose") is None
        else f32(arrays["pose"]),
        spstau=opt("spstau"), boundnormal=opt("boundnormal"),
        motionvel=opt("motionvel"), velm1=opt("velm1"), rhom1=opt("rhom1"),
        ft=None if ft is None else FloatingState(
            **{k: f32(ft[k]) for k in ("center", "fvel", "fomega", "angles")}))


def phasecfg(phases) -> PhaseCfg:
    def one(p):
        return Phase(mkfluid=int(p.mkfluid), newtonian=bool(p.newtonian),
                     **{k: float(getattr(p, k)) for k in (
                         "rho0", "csound", "gamma", "visco", "tau_yield",
                         "tau_max", "bi_multi", "hbp_m", "hbp_n")})
    return PhaseCfg(phases=tuple(one(p) for p in phases.phases))


def floatingcfg(cfg) -> FloatingCfg:
    return FloatingCfg(count=int(cfg.count), ftpause=float(cfg.ftpause),
                       **{k: tuple(float(x) for x in getattr(cfg, k)) for k in (
                           "mass", "massp", "inertia0", "translation_dof",
                           "rotation_dof", "mkbound", "scaleforce")})


# the port's feature classes by name; the JAX package's have the same names
# and fields, apart from the external zone's grid (InOutGridVel -> GridVel)
_FEATURE_CLASSES = {cls.__name__: cls for cls in (
    motion.MotionDef, motion.Segment, damping.DampingPlane,
    damping.DampingBox, damping.DampingCylinder, relaxzone.RelaxZoneUniform,
    relaxzone.RelaxZoneRegular, relaxzone.RelaxZoneSpectrum,
    relaxzone.RelaxZoneExternal, mlpiston.MLPiston1D, mlpiston.MLPiston2D,
    awas.AwasZsurf, accinput.AccInput, gauges.GaugeVel, gauges.GaugeSwl,
    gauges.GaugeMaxZ, gauges.GaugeForce)}
_FEATURE_CLASSES["InOutGridVel"] = relaxzone.GridVel


def feature(obj):
    """The port's counterpart of the JAX feature configuration ``obj``,
    field by field (nested configurations converted too)."""
    cls = _FEATURE_CLASSES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port counterpart for {type(obj).__name__}")

    def value(v):
        if type(v).__name__ in _FEATURE_CLASSES:
            return feature(v)
        if isinstance(v, (tuple, list)):
            return tuple(value(x) for x in v)
        return v

    return cls(**{f.name: value(getattr(obj, f.name)) for f in fields(cls)})


def features(feats) -> Features:
    """A JAX ``Features`` bundle as the port's: ``floating`` through
    :func:`floatingcfg`, the tuples of configurations through
    :func:`feature`, the rest as it is."""
    kw = {}
    for f in fields(Features):
        v = getattr(feats, f.name)
        if f.name == "floating" and v is not None:
            v = floatingcfg(v)
        elif isinstance(v, tuple):
            v = tuple(feature(x) for x in v)
        kw[f.name] = v
    return Features(**kw)
