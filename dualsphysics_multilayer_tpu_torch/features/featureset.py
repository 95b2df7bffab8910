"""The feature bundle of a run (counterpart of
`dualsphysics_multilayer_tpu/features/featureset.py`): the reference
attaches a feature object when its XML node exists (`JSph::LoadCaseConfig`,
JSph.cpp:923-1184); the step reads this static bundle when it is made.

The fields are the JAX package's.  The port covers ``floating``,
``motions`` (``features/motion.py``), ``damping``, ``relaxzones``,
``mlpistons``, ``awas`` and ``accinputs``; any other non-empty field raises
``NotImplementedError`` naming it."""

from __future__ import annotations

from dataclasses import dataclass, fields

from .floating import FloatingCfg


# the fields the port's steps run
PORTED = ("motions", "damping", "accinputs", "floating", "relaxzones",
          "mlpistons", "awas")


@dataclass(frozen=True)
class Features:
    motions: tuple = ()
    damping: tuple = ()
    accinputs: tuple = ()
    floating: FloatingCfg | None = None
    periodic: object = None
    inout: object = None
    dem: object = None
    relaxzones: tuple = ()
    mlpistons: tuple = ()
    moorings: object = None
    forcepoints: object = None
    awas: tuple = ()
    viscotime: object = None
    chrono: object = None
    chcontact: object = None

    def check_supported(self) -> None:
        """Raise NotImplementedError naming the first feature the port does
        not cover."""
        for f in fields(self):
            value = getattr(self, f.name)
            if f.name not in PORTED and value is not None and value != ():
                raise NotImplementedError(f"the torch port does not cover "
                                          f"Features.{f.name} yet")
