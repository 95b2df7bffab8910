"""2-D wave flume with an SWL gauge at mid-flume (the reference wave-paddle
workflow, `_FmtXML_WavePaddles.xml`) on the PyTorch/CUDA port: the twin of
examples/02_waveflume.py, through ``Simulation.run`` and ``GaugeSystem``.

    python examples/torch/02_waveflume.py [--cpu]

Runs on the card (cuda:0) unless ``--cpu``.  As its JAX twin, it takes its
``Features`` from ``case.meta.get("features")``, which ``waveflume2d``
does not set: the piston of ``meta["motion"]`` stays still, so the gauge
reads still water (``ROADMAP.md`` §3)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main(cpu=False, max_steps=None):
    """Run the flume (``max_steps``: stop at the first save at or past that
    many steps); returns the ``Simulation``."""
    import dualsphysics_multilayer_tpu_torch as dsph
    from dualsphysics_multilayer_tpu_torch.features.gauges import (
        GaugeSwl, GaugeSystem)
    from dualsphysics_multilayer_tpu_torch.models import cases

    case = cases.waveflume2d(dp=0.01, device="cpu" if cpu else "cuda")
    feats = case.meta.get("features")
    sim = dsph.Simulation(case.csp,
                          dsph.SolverOpts(tdensity=dsph.TpDensity.FOURTAKAS),
                          case.dom, case.state, feats=feats)
    gs = GaugeSystem(case.csp, case.dom, gauges=(
        GaugeSwl("eta_mid", (3.0, 0, 0), (3.0, 0, 1.0), 0.02),))

    def on_save(s):
        out = gs.run(s.time, s.state)
        print(f"t={s.time:.2f}s  eta(x=3m)={out['eta_mid'][2]:.4f} m")

    sim.run(tmax=6.0, tout=0.2, on_save=on_save, max_steps=max_steps)
    gs.save_csv("out_waveflume")
    print("gauge CSV in out_waveflume/")
    return sim


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv)
