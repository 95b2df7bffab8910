"""The feature bundle of a run (counterpart of
`dualsphysics_multilayer_tpu/features/featureset.py`): the reference
attaches a feature object when its XML node exists (`JSph::LoadCaseConfig`,
JSph.cpp:923-1184); the step reads this static bundle when it is made.

The fields are the JAX package's, and the port covers each: ``floating``,
``motions`` (``features/motion.py``), ``damping``, ``relaxzones``,
``mlpistons``, ``awas``, ``accinputs``, ``viscotime``
(``features/viscoinput.py``), ``periodic`` (``features/periodic.py``,
reached through the library only, as in JAX: no XML node sets it),
``inout`` (``features/inout.py``), ``dem`` (``features/dem.py``),
``moorings`` and ``forcepoints`` (``features/moorings.py``; force points
through the library only, as in JAX), ``chrono`` (``features/chrono.py``)
and ``chcontact`` (``features/chcollision.py``).  A field given as
anything but the port's configuration raises ``NotImplementedError``
naming it (the JAX package's go through ``convert.features`` first)."""

from __future__ import annotations

from dataclasses import dataclass, fields

from .floating import FloatingCfg


# the case XML's node behind each ported field, for refusals that name it
XML_NODES = {"motions": "<motion> or <special><wavepaddles>",
             "damping": "<special><damping>",
             "accinputs": "<special><accinputs>",
             "floating": "<floatings>",
             "relaxzones": "<special><relaxationzones>",
             "mlpistons": "<special><mlayerpistons>",
             "awas": "<special><wavepaddles> AWAS",
             "viscotime": "<parameter key=\"ViscoTime\">",
             "inout": "<special><inout>",
             "dem": "<parameter key=\"RigidAlgorithm\" value=\"2\">",
             "moorings": "<special><moorings>",
             "chrono": "<special><chrono>",
             "chcontact": "<special><chrono><collision>"}


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
        """Raise NotImplementedError naming the first feature given as
        another class than the port's configuration (the JAX package's go
        through ``convert.features`` first); the steps run every field."""
        for name in self.set_fields():
            kinds = _kinds().get(name)
            value = getattr(self, name)
            if kinds is not None and not isinstance(value, kinds):
                raise NotImplementedError(
                    f"the torch port does not cover Features.{name} given "
                    f"as {type(value).__name__}: it runs "
                    + " or ".join(f"features.{k.__module__.rsplit('.', 1)[-1]}"
                                  f".{k.__name__}" for k in kinds))

    def check_none_set(self, what: str) -> None:
        """Raise NotImplementedError naming the first set feature and its
        XML node: for a step (``what``) that runs no feature hook."""
        for name in self.set_fields():
            node = XML_NODES.get(name)
            raise NotImplementedError(
                f"the torch port does not cover Features.{name}"
                + (f" ({node})" if node else "") + f" on {what}")


def _kinds():
    """The port's configuration classes of the fields that name one class
    (the others are tuples of the port's feature objects, converted by
    ``convert.features``)."""
    from . import chcollision, chrono, dem, inout, moorings, periodic
    return {"periodic": (periodic.PeriodicCfg,), "inout": (inout.InOutCfg,),
            "dem": (dem.DemCfg,),
            "moorings": (moorings.MooringCfg, moorings.MoorDynCfg),
            "forcepoints": (moorings.ForcePointsCfg,),
            "chrono": (chrono.ChronoCfg,),
            "chcontact": (chcollision.ChContactCfg,)}
