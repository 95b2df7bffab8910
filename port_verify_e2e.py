"""End-to-end verify of the PyTorch/CUDA port: the 3D dam break through the
Simulation API over kernel 1 (``csrc/cellforce.cu``) on the card, the twin
of verify_e2e.py.

Observable: the dam front's advance against Koshizuka & Oka (1996) (front/H
at t* = t sqrt(2g/H)), the fluid density within (900, 1150), overflow 0.
Prints ``VERIFY OK`` or ``VERIFY FAIL`` and exits non-zero on FAIL.

    python port_verify_e2e.py [--cpu]

Runs on the card (cuda:0) unless ``--cpu`` (the plain interaction on the
CPU takes hours at this size).
"""
import sys

import numpy as np

H = 0.3        # initial fluid column height (dambreak3d geometry)
G = 9.81
FRONT0 = 0.4   # initial column width


def main(cpu=False, max_steps=None):
    """Run to tmax 0.20 s with a save every 0.04 s (``max_steps``: stop at
    the first save at or past that many steps); returns (ok, rows), a row
    (part, t, t*, front, rho min, rho max, overflow) per save."""
    import torch
    import dualsphysics_multilayer_tpu_torch as dsph
    from dualsphysics_multilayer_tpu_torch import typesdef as td
    from dualsphysics_multilayer_tpu_torch.models import cases

    device = "cpu" if cpu else "cuda"
    case = cases.dambreak3d(dp=0.012, obstacle=False, device=device)
    print("np", case.np_total, "device",
          "cpu" if cpu else torch.cuda.get_device_name(0))
    opts = dsph.SolverOpts(tdensity=dsph.TpDensity.FOURTAKAS)
    sim = dsph.Simulation(case.csp, opts, case.dom, case.state)
    rows = []

    def on_save(s):
        pos = s.state.pos.cpu().numpy()
        code = s.state.code.cpu().numpy()
        fl = (td.code_type(code) == td.TYPE_FLUID) & td.is_active(code)
        rho = s.state.rho.cpu().numpy()[fl]
        front = pos[fl, 0].max()
        ts = s.time * np.sqrt(2 * G / H)
        ovf = int(s.carry.overflow)
        rows.append((s.part, float(s.time), float(ts), float(front),
                     float(rho.min()), float(rho.max()), ovf))
        print(f"part {s.part} t={s.time:.3f} t*={ts:.2f} front={front:.3f} "
              f"rho=[{rho.min():.0f},{rho.max():.0f}] ovf={ovf}")

    sim.run(tmax=0.20, tout=0.04, on_save=on_save, max_steps=max_steps)
    last = rows[-1]
    adv = (last[3] - FRONT0) / H
    print(f"front advance/H at t*={last[2]:.2f}: {adv:.2f}")
    ok = (last[6] == 0 and 900 < last[4] and last[5] < 1150
          and 0.5 < adv and last[2] > 1.0)
    print("VERIFY", "OK" if ok else "FAIL")
    return ok, rows


if __name__ == "__main__":
    sys.exit(0 if main(cpu="--cpu" in sys.argv)[0] else 1)
