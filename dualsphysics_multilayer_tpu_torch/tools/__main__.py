"""``python -m dualsphysics_multilayer_tpu_torch.tools <tool> <flags>``:
the ``dsphtorchtools`` dispatch."""

import sys

from . import main

sys.exit(main())
