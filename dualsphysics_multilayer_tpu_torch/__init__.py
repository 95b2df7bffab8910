"""PyTorch/CUDA port of the DualSPHysics-style WCSPH solver.

The JAX package ``dualsphysics_multilayer_tpu`` beside it is the reference;
module names here follow it.  This package imports torch and never JAX.
The pair interactions run in hand-written CUDA kernels for Hopper on CUDA
tensors (``csrc/cellforce.cu`` single phase, with floating bodies and mDBC
walls, ``csrc/nnforce.cu`` multiphase non-Newtonian, each with the cubic
spline and shifting) and in their plain torch versions on CPU tensors;
``tools/probes.py`` holds the two hardware probes.  ``io/`` loads case
XMLs (``io/xmlcase.py``) and writes and reads the run's output (PART .bi4
files, VTK, CSV, restart), ``utils/`` keeps its bookkeeping, and
``cli.py`` is the command line
(``python -m dualsphysics_multilayer_tpu_torch.cli``).
"""

__version__ = "0.1.0"   # cli.VERSION

from . import typesdef
from .typesdef import (CteSph, TpBoundary, TpDensity, TpKernel, TpRigidMode,
                       TpShifting, TpSlipMode, TpStep, TpVelGrad, TpVisco,
                       make_ctesph)
from .features.featureset import Features
from .ops.forces import SolverOpts
from .ops.forces_nn import Phase, PhaseCfg
from .models.wcsph import (SimState, Simulation, StepCarry, make_advance,
                           make_carry, make_step)
from .models.nnewtonian import make_nn_step

__all__ = [
    "__version__", "typesdef", "CteSph", "TpBoundary", "TpDensity",
    "TpKernel", "TpRigidMode", "TpShifting", "TpSlipMode", "TpStep",
    "TpVelGrad", "TpVisco", "make_ctesph", "Features",
    "SolverOpts", "Phase",
    "PhaseCfg", "SimState", "Simulation", "StepCarry", "make_advance",
    "make_carry", "make_step", "make_nn_step",
]
