"""Open-boundary channel: an inlet at x=0 (uniform imposed velocity) and an
outlet at x=L (reference inletoutlet examples, SURVEY §2.10), on the
PyTorch/CUDA port: the twin of examples/04_inout_channel.py, through
``Features(inout=...)``.

    python examples/torch/04_inout_channel.py [--cpu]

Runs on the card (cuda:0) unless ``--cpu``."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main(cpu=False, max_steps=None):
    """Run the channel (``max_steps``: stop at the first save at or past
    that many steps); returns the ``Simulation``."""
    import dualsphysics_multilayer_tpu_torch as dsph
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.features.featureset import Features
    from dualsphysics_multilayer_tpu_torch.models import cases

    case = cases.channel2d(dp=0.01, vel=0.4, device="cpu" if cpu else "cuda")
    feats = Features(inout=case.meta["inout"])
    sim = dsph.Simulation(case.csp, dsph.SolverOpts(), case.dom, case.state,
                          feats=feats)

    def on_save(s):
        code = s.state.code
        nfl = int((td.is_fluid(code) & td.is_active(code)).sum())
        print(f"t={s.time:.2f}s  active fluid particles={nfl}")

    sim.run(tmax=1.5, tout=0.1, on_save=on_save, max_steps=max_steps)
    return sim


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv)
