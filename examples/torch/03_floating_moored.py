"""Buoyant floating box held by two dynamic lumped-mass mooring lines
(the MoorDyn+ model re-implemented on the device): mDBC boundaries and the
6-DOF rigid solve (reference coupling: JDsMooredFloatings +
libdsphmoordyn), on the PyTorch/CUDA port: the twin of
examples/03_floating_moored.py, through ``MoorDynCfg``/``MoorDynLine``.

    python examples/torch/03_floating_moored.py [--cpu]

Runs on the card (cuda:0) unless ``--cpu``."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main(cpu=False, max_steps=None, tout=0.1):
    """Run the moored box (``max_steps``: stop at the first save at or past
    that many steps; ``tout``: the save interval); returns the
    ``Simulation``."""
    import dualsphysics_multilayer_tpu_torch as dsph
    from dualsphysics_multilayer_tpu_torch.features.featureset import Features
    from dualsphysics_multilayer_tpu_torch.features.moorings import (
        MoorDynCfg, MoorDynLine)
    from dualsphysics_multilayer_tpu_torch.models import cases

    case = cases.floatingbox2d(dp=0.01, device="cpu" if cpu else "cuda")
    ftcfg = case.meta["ftcfg"]
    c0 = case.state.ft.center[0].tolist()
    moor = MoorDynCfg(nbodies=1, lines=(
        MoorDynLine(body=0, anchor=(c0[0] - 0.4, 0.0, 0.0),
                    fairlead=(-0.1, 0.0, -0.05), length0=0.45,
                    ea=2.9e3, nseg=10, diameter=3.7e-3, massden=0.06),
        MoorDynLine(body=0, anchor=(c0[0] + 0.4, 0.0, 0.0),
                    fairlead=(0.1, 0.0, -0.05), length0=0.45,
                    ea=2.9e3, nseg=10, diameter=3.7e-3, massden=0.06)))
    feats = Features(floating=ftcfg, moorings=moor)
    opts = dsph.SolverOpts(tdensity=dsph.TpDensity.FOURTAKAS,
                           with_floating=True,
                           tboundary=dsph.TpBoundary.MDBC)
    sim = dsph.Simulation(case.csp, opts, case.dom, case.state, feats=feats)
    sim.run(tmax=1.5, tout=tout, max_steps=max_steps,
            on_save=lambda s: print(
                f"t={s.time:.2f}s  box center="
                f"{s.state.ft.center[0].cpu().numpy().round(4)}"))
    return sim


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv)
