"""Built-in case construction for the port: the dp-lattice box drawing of
GenCase and the 3D dam break (`examples/main/01_DamBreak/
CaseDambreak_Def.xml`).

Counterpart of `dualsphysics_multilayer_tpu/models/cases.py` (``Draw.box``,
``Draw.build``, ``Case``, ``_make_state``, ``_make_domain``,
``dambreak3d``).  Lattices, ids, densities and the domain come out equal to
the JAX package's, which the tests check array for array.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph, make_ctesph
from ..ops import celldiv as cd
from ..ops import eos
from .wcsph import SimState

# cell-size skin for the rebuild-when-needed divide: candidate volume grows
# ~(1+skin)^3 in exchange for divide-free steps while displacements stay
# under skin*kernelsize
DOMAIN_SKIN = 1.0 / 16.0

_EPS = 1e-6


@dataclass
class Draw:
    """3D dp-lattice drawing canvas anchored at the origin, with
    last-draw-wins overwrite (GenCase ``setmkfluid``/``setmkbound`` +
    ``drawbox``)."""
    dp: float
    points: dict = field(default_factory=dict)   # (i,j,k) -> (ptype, mk)

    def _irange(self, lo, hi):
        i0 = int(math.ceil(lo / self.dp - _EPS))
        i1 = int(math.floor(hi / self.dp + _EPS))
        return list(range(i0, i1 + 1))

    def box(self, pmin, pmax, *, ptype, mk, faces="solid"):
        """Draw a box: ``faces`` is 'solid' or a '|'-joined subset of
        bottom, top, left, right, front, back (left/right = x faces,
        front/back = y faces, bottom/top = z faces)."""
        xs, ys, zs = (self._irange(pmin[a], pmax[a]) for a in range(3))
        want = None if faces == "solid" else {f.strip() for f in faces.split("|")}

        def sel(i, j, k):
            if want is None:
                return True
            return (("left" in want and i == xs[0])
                    or ("right" in want and i == xs[-1])
                    or ("front" in want and j == ys[0])
                    or ("back" in want and j == ys[-1])
                    or ("bottom" in want and k == zs[0])
                    or ("top" in want and k == zs[-1]))

        for k in zs:
            for j in ys:
                for i in xs:
                    if sel(i, j, k):
                        self.points[(i, j, k)] = (ptype, mk)

    def build(self):
        """Assign canonical ids (fixed < moving < floating < fluid; within a
        type, lattice order z, y, x) and return (pos f64 (np,3), code int32
        (np,))."""
        order = {td.TYPE_FIXED: 0, td.TYPE_MOVING: 1,
                 td.TYPE_FLOATING: 2, td.TYPE_FLUID: 3}
        items = sorted(self.points.items(),
                       key=lambda kv: (order[kv[1][0]], kv[0][2], kv[0][1],
                                       kv[0][0]))
        ijk = np.array([key for key, _ in items], dtype=np.float64).reshape(-1, 3)
        pos = ijk * self.dp
        code = np.array([td.code_make(t, mk) for _, (t, mk) in items],
                        dtype=np.int32)
        return pos, code


@dataclass
class Case:
    """A fully constructed runnable case (state on ``device``)."""
    csp: CteSph
    dom: cd.Domain
    state: SimState
    npb: int          # boundary particle count (fixed+moving)
    np_total: int
    meta: dict


def _make_state(csp: CteSph, pos, code, zsurf, *, device):
    """Initial state: positions cast from f64 to f32, zero velocity, and
    hydrostatic density for fluid (GenCase ``rhopgradient=2``) evaluated in
    f32 as the JAX package does; boundaries start at rho0."""
    n = pos.shape[0]
    z = torch.tensor(pos[:, 2], dtype=torch.float32)
    rho_hyd = eos.hydrostatic_rho(csp, z, zsurf).numpy()
    rho = np.where(td.code_type(code) == td.TYPE_FLUID, rho_hyd, csp.rhopzero)
    f32 = dict(dtype=torch.float32, device=device)
    return SimState(
        pos=torch.tensor(pos, **f32),
        vel=torch.zeros((n, 3), **f32),
        rho=torch.tensor(rho, **f32),
        code=torch.tensor(code, dtype=torch.int32, device=device),
        idp=torch.arange(n, dtype=torch.int64, device=device),
        pose=torch.zeros((n, 3), **f32),
    )


def _make_domain(csp: CteSph, pos, headroom):
    """Static cell grid from particle bounds + a 2*KernelSize halo + free-
    surface headroom as a fraction of the lattice height (the
    `<simulationdomain>` 'default + X%' idiom)."""
    ks = csp.kernelsize
    pmin = pos.min(axis=0) - 2 * ks
    pmax = pos.max(axis=0) + 2 * ks
    pmax[2] += headroom * (pos[:, 2].max() - pos[:, 2].min())
    return cd.make_domain(tuple(pmin), tuple(pmax), ks, skin=DOMAIN_SKIN)


def dambreak3d(dp=0.02, *, tank=(1.6, 0.67, 0.4), column=(0.4, 0.67, 0.3),
               obstacle=True, device="cpu") -> Case:
    """3D dam break with optional building obstacle (CaseDambreak_Def.xml):
    visco 0.1, coefsound 20, free-surface headroom 100% of the lattice
    height."""
    csp = make_ctesph(simulate2d=False, dp=dp, hswl=column[2], coefh=1.0,
                      visco=0.1, coefsound=20.0)
    d = Draw(dp=dp)
    d.box((0, 0, 0), column, ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), tank, ptype=td.TYPE_FIXED, mk=0,
          faces="bottom|left|right|front|back")
    if obstacle:
        d.box((0.9, 0.24, 0.0), (1.02, 0.36, 0.45),
              ptype=td.TYPE_FIXED, mk=1, faces="top|left|right|front|back")
    pos, code = d.build()
    dom = _make_domain(csp, pos, headroom=1.0)
    st = _make_state(csp, pos, code, zsurf=column[2], device=device)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="dambreak3d", dp=dp, zsurf=column[2]))
