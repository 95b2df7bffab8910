"""PyTorch/CUDA port of the DualSPHysics-style WCSPH solver.

The JAX package ``dualsphysics_multilayer_tpu`` beside it is the reference;
module names here follow it.  This package imports torch and never JAX.
The pair interactions run in hand-written CUDA kernels for Hopper on CUDA
tensors (``csrc/cellforce.cu`` single phase, with floating bodies and mDBC
walls, ``csrc/nnforce.cu`` multiphase non-Newtonian) and in their plain
torch versions on CPU tensors.
"""

from . import typesdef
from .typesdef import (CteSph, TpBoundary, TpDensity, TpKernel, TpShifting,
                       TpSlipMode, TpStep, TpVelGrad, TpVisco, make_ctesph)
from .features.featureset import Features
from .ops.forces import SolverOpts
from .ops.forces_nn import Phase, PhaseCfg
from .models.wcsph import (SimState, Simulation, StepCarry, make_advance,
                           make_carry, make_step)
from .models.nnewtonian import make_nn_step

__all__ = [
    "typesdef", "CteSph", "TpBoundary", "TpDensity", "TpKernel", "TpShifting",
    "TpSlipMode", "TpStep", "TpVelGrad", "TpVisco", "make_ctesph", "Features",
    "SolverOpts", "Phase",
    "PhaseCfg", "SimState", "Simulation", "StepCarry", "make_advance",
    "make_carry", "make_step", "make_nn_step",
]
