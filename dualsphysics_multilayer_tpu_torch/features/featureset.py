"""The feature bundle of a run (counterpart of
`dualsphysics_multilayer_tpu/features/featureset.py`): the reference
attaches a feature object when its XML node exists (`JSph::LoadCaseConfig`,
JSph.cpp:923-1184); the step reads this static bundle when it is made.

The fields are the JAX package's.  The port covers ``floating``,
``motions`` (``features/motion.py``), ``damping``, ``relaxzones``,
``mlpistons``, ``awas``, ``accinputs``, ``viscotime``
(``features/viscoinput.py``), ``periodic`` (``features/periodic.py``,
reached through the library only, as in JAX: no XML node sets it) and
``inout`` (``features/inout.py``); any other non-empty field raises
``NotImplementedError`` naming it."""

from __future__ import annotations

from dataclasses import dataclass, fields

from .floating import FloatingCfg


# the fields the port's steps run
PORTED = ("motions", "damping", "accinputs", "floating", "relaxzones",
          "mlpistons", "awas", "viscotime", "periodic", "inout")

# the case XML's node behind each ported field, for refusals that name it
XML_NODES = {"motions": "<motion> or <special><wavepaddles>",
             "damping": "<special><damping>",
             "accinputs": "<special><accinputs>",
             "floating": "<floatings>",
             "relaxzones": "<special><relaxationzones>",
             "mlpistons": "<special><mlayerpistons>",
             "awas": "<special><wavepaddles> AWAS",
             "viscotime": "<parameter key=\"ViscoTime\">",
             "inout": "<special><inout>"}


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

    @property
    def any(self):
        """Whether any feature is set (the JAX ``Features.any``)."""
        return bool(self.motions or self.damping or self.accinputs
                    or self.floating or self.periodic or self.inout
                    or self.dem or self.relaxzones or self.mlpistons
                    or self.moorings or self.forcepoints or self.awas
                    or self.viscotime)

    def set_fields(self) -> list:
        """The names of the fields that are set (neither None nor empty)."""
        return [f.name for f in fields(self)
                if getattr(self, f.name) is not None
                and getattr(self, f.name) != ()]

    def check_supported(self) -> None:
        """Raise NotImplementedError naming the first feature the port does
        not cover: a field outside ``PORTED``, or ``periodic`` / ``inout``
        given as anything but the port's configuration (the JAX package's
        go through ``convert.feature`` first)."""
        from .inout import InOutCfg
        from .periodic import PeriodicCfg
        kinds = {"periodic": PeriodicCfg, "inout": InOutCfg}
        for name in self.set_fields():
            if name not in PORTED:
                raise NotImplementedError(f"the torch port does not cover "
                                          f"Features.{name} yet")
            if name in kinds and not isinstance(getattr(self, name),
                                                kinds[name]):
                raise NotImplementedError(
                    f"the torch port does not cover Features.{name} given "
                    f"as {type(getattr(self, name)).__name__}: it runs "
                    f"features.{name}.{kinds[name].__name__}")

    def check_none_set(self, what: str) -> None:
        """Raise NotImplementedError naming the first set feature and its
        XML node: for a step (``what``) that runs no feature hook."""
        for name in self.set_fields():
            node = XML_NODES.get(name)
            raise NotImplementedError(
                f"the torch port does not cover Features.{name}"
                + (f" ({node})" if node else "") + f" on {what}")
