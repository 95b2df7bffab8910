"""Non-Newtonian wet dam break: HBP (Herschel-Bulkley-Papanastasiou)
rheology, two phases, the mphase_nnewtonian/01_WetDambreak workflow, on
the PyTorch/CUDA port: the twin of examples/05_nn_mud_dambreak.py.  Runs
the SHIPPED NN case XML unmodified (its path is read from the JAX
example) through ``python -m dualsphysics_multilayer_tpu_torch.cli``.

    python examples/torch/05_nn_mud_dambreak.py [--cpu] [CLI arguments]

Runs on the card (cuda:0) unless ``--cpu``.  Further arguments go to the
CLI after these ones, so a later ``-case`` or ``-tmax`` takes their place."""
import ast
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def reference_case():
    """The ``-case`` path of examples/05_nn_mud_dambreak.py."""
    with open(os.path.join(ROOT, "examples", "05_nn_mud_dambreak.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.List):
            items = [getattr(e, "value", None) for e in node.elts]
            if "-case" in items:
                return items[items.index("-case") + 1]
    raise ValueError("examples/05_nn_mud_dambreak.py names no -case")


def main(cpu=False, max_steps=None, extra=()):
    """Run the CLI on the case (``max_steps``: its ``-nsteps``, a stop at
    the first save at or past that many steps; ``extra``: more CLI
    arguments); returns the CLI's exit code."""
    args = [sys.executable, "-m", "dualsphysics_multilayer_tpu_torch.cli",
            "-case", reference_case(),
            "-dirout", "out_nnmud", "-sv:binx", "-tmax:0.5", "-tout:0.05"]
    if cpu:
        args.insert(3, "-cpu")
    if max_steps is not None:
        args.append(f"-nsteps:{max_steps}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.abspath(ROOT), env.get("PYTHONPATH")) if p)
    return subprocess.call(args + list(extra), env=env)


if __name__ == "__main__":
    sys.exit(main(cpu="--cpu" in sys.argv,
                  extra=[a for a in sys.argv[1:] if a != "--cpu"]))
