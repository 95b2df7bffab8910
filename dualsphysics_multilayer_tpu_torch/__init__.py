"""PyTorch/CUDA port of the DualSPHysics-style WCSPH solver.

The JAX package ``dualsphysics_multilayer_tpu`` beside it is the reference;
module names here follow it.  This package imports torch and never JAX.
The pair interaction runs in a hand-written CUDA kernel for Hopper
(``csrc/cellforce.cu``) on CUDA tensors and in its plain torch version on
CPU tensors.
"""

from . import typesdef
from .typesdef import (CteSph, TpBoundary, TpDensity, TpKernel, TpShifting,
                       TpStep, TpVisco, make_ctesph)
from .ops.forces import SolverOpts
from .models.wcsph import (SimState, Simulation, StepCarry, make_advance,
                           make_carry, make_step)

__all__ = [
    "typesdef", "CteSph", "TpBoundary", "TpDensity", "TpKernel", "TpShifting",
    "TpStep", "TpVisco", "make_ctesph", "SolverOpts", "SimState", "Simulation",
    "StepCarry", "make_advance", "make_carry", "make_step",
]
