"""Domain decomposition: the 3-D dam break split along x into slabs, one
rank each, with halo rows refreshed before each interaction (SURVEY §2.8),
on the PyTorch/CUDA port: the twin of examples/06_sharded_runup.py,
through ``parallel/sharding.dryrun``.

    python examples/torch/06_sharded_runup.py [--cpu]

The JAX example runs 8 virtual CPU devices.  Here the ranks run one per
card over NCCL where there are two cards or more, and two ranks share
cuda:0 over gloo on a one-card machine; ``--cpu`` runs two ranks on the
CPU."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main(cpu=False, max_steps=None):
    """One step of each of the dry run's three cases over the ranks
    (``max_steps``: unused, the dry run makes one step); returns the number
    of ranks."""
    import torch
    from dualsphysics_multilayer_tpu_torch.parallel.sharding import dryrun

    if cpu:
        n, run = 2, dict(device="cpu")
    else:
        cards = torch.cuda.device_count()
        n, run = ((cards, dict(device="cuda")) if cards > 1
                  else (2, dict(device="cuda", backend="gloo")))
    dryrun(n, **run)
    print("sharded step OK on", n, "ranks")
    return n


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv)
