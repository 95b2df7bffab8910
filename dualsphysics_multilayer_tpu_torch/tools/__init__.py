"""The post-processing tools and the hardware probes.

Counterpart of `dualsphysics_multilayer_tpu/tools/`: PartVTK, PartVTKOut,
MeasureTool, IsoSurface, ComputeForces, FloatingInfo, BoundaryVTK,
TracerParts, FlowTool, BIFileInfo and ReadSwash over the PARTs the port
writes, with the JAX package's flag grammar, runnable as

    python -m dualsphysics_multilayer_tpu_torch.tools.<name> <flags>
    dsphtorchtools <name> <flags>

The SPH sums of MeasureTool, IsoSurface and ComputeForces run in float64
on the card unless ``-cpu`` is given (``common.tool_device``); file
reading, filtering and writing stay on the host.  GenCase's writer is
``io.gencase.write_case``.  ``probes`` holds the hardware probes
(``python -m dualsphysics_multilayer_tpu_torch.tools.probes``).
"""

from __future__ import annotations

import sys

TOOLS = ("partvtk", "partvtkout", "measuretool", "isosurface",
         "computeforces", "floatinginfo", "boundaryvtk", "tracerparts",
         "flowtool", "bifileinfo", "readswash")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("tools:", ", ".join(TOOLS))
        return 0
    name = argv[0].lower()
    if name not in TOOLS:
        print(f"dsphtorchtools: unknown tool '{name}' (have: "
              f"{', '.join(TOOLS)})", file=sys.stderr)
        return 2
    import importlib
    mod = importlib.import_module(f".{name}", __package__)
    return mod.main(argv[1:])
