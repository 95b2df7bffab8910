"""Built-in case construction for the port: the dp-lattice box drawing of
GenCase (3D, or 2D in the y = 0 plane) with the mDBC normals of its faces,
the 3D and 2D dam breaks (`examples/main/01_DamBreak/CaseDambreak_Def.xml`,
`CaseDambreakVal2D_Def.xml`), the 2D floating box and the 2D wave flume;
the 2D wet dam break of the multiphase non-Newtonian solver lives in
``models/nnewtonian.py``.

Counterpart of `dualsphysics_multilayer_tpu/models/cases.py` (``Draw.box``,
``Draw.build``, ``Case``, ``_make_state``, ``_make_domain``,
``dambreak3d``, ``dambreak2d``, ``floatingbox2d``, ``waveflume2d``; the
bucket capacities of the JAX builders, ``lattice_cellcap`` among them,
belong to the TPU layouts and have no counterpart here).  Lattices, ids,
densities, normals and the domain come out equal to the JAX package's,
which the tests check array for array.  Cases are built on the card unless
the caller asks for another device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import typesdef as td
from ..typesdef import CteSph, make_ctesph
from ..features import floating as FT
from ..features import motion as MOT
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
    """dp-lattice drawing canvas anchored at the origin, with
    last-draw-wins overwrite (GenCase ``setmkfluid``/``setmkbound`` +
    ``drawbox``).  With ``simulate2d`` every point lies in the y = 0 plane
    and boxes have no front/back faces."""
    dp: float
    simulate2d: bool = False
    points: dict = field(default_factory=dict)   # (i,j,k) -> (ptype, mk, normal)

    def _irange(self, lo, hi):
        i0 = int(math.ceil(lo / self.dp - _EPS))
        i1 = int(math.floor(hi / self.dp + _EPS))
        return list(range(i0, i1 + 1))

    def box(self, pmin, pmax, *, ptype, mk, faces="solid"):
        """Draw a box: ``faces`` is 'solid' or a '|'-joined subset of
        bottom, top, left, right, front, back (left/right = x faces,
        front/back = y faces, bottom/top = z faces).  A face point carries
        the mDBC normal: the sum of its faces' inward unit normals scaled
        to length dp (the ghost node lies one dp inside, JSphCpu.cpp:1036
        gpos = pos + boundnormal); a solid box's points carry none."""
        xs, ys, zs = (self._irange(pmin[a], pmax[a]) for a in range(3))
        if self.simulate2d:
            ys = [0]
        want = None if faces == "solid" else {f.strip() for f in faces.split("|")}
        depth = not self.simulate2d

        def inward(i, j, k):
            """Inward unit normals of the faces the point lies on."""
            return [n for on, n in (
                ("left" in want and i == xs[0], (1, 0, 0)),
                ("right" in want and i == xs[-1], (-1, 0, 0)),
                (depth and "front" in want and j == ys[0], (0, 1, 0)),
                (depth and "back" in want and j == ys[-1], (0, -1, 0)),
                ("bottom" in want and k == zs[0], (0, 0, 1)),
                ("top" in want and k == zs[-1], (0, 0, -1))) if on]

        for k in zs:
            for j in ys:
                for i in xs:
                    if want is None:
                        self.points[(i, j, k)] = (ptype, mk, (0.0, 0.0, 0.0))
                        continue
                    faces_on = inward(i, j, k)
                    if not faces_on:
                        continue
                    v = np.sum(faces_on, axis=0, dtype=np.float64)
                    nn = np.linalg.norm(v)
                    v = v / nn * self.dp if nn else np.zeros(3)
                    self.points[(i, j, k)] = (ptype, mk,
                                              tuple(float(x) for x in v))

    def build(self):
        """Assign canonical ids (fixed < moving < floating < fluid; within a
        type, lattice order z, y, x) and return (pos f64 (np,3), code int32
        (np,)); the points' mDBC normals land in ``self.normals`` (np,3)."""
        order = {td.TYPE_FIXED: 0, td.TYPE_MOVING: 1,
                 td.TYPE_FLOATING: 2, td.TYPE_FLUID: 3}
        items = sorted(self.points.items(),
                       key=lambda kv: (order[kv[1][0]], kv[0][2], kv[0][1],
                                       kv[0][0]))
        ijk = np.array([key for key, _ in items], dtype=np.float64).reshape(-1, 3)
        pos = ijk * self.dp
        code = np.array([td.code_make(t, mk) for _, (t, mk, _n) in items],
                        dtype=np.int32)
        self.normals = np.array([n for _, (_t, _mk, n) in items],
                                dtype=np.float64).reshape(-1, 3)
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


def _make_state(csp: CteSph, pos, code, zsurf, *, device, need_verlet=False,
                need_sps=False, normals=None):
    """Initial state: positions cast from f64 to f32, zero velocity, and
    hydrostatic density for fluid (GenCase ``rhopgradient=2``) evaluated in
    f32 as the JAX package does; boundaries and floating bodies start at
    rho0.  ``need_verlet`` adds the Verlet M1 state (the initial velocity
    and density); ``need_sps`` a zero SPS stress for laminar+SPS runs;
    ``normals`` (np,3) the mDBC normals, with a zero wall velocity."""
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
        velm1=torch.zeros((n, 3), **f32) if need_verlet else None,
        rhom1=torch.tensor(rho, **f32) if need_verlet else None,
        spstau=torch.zeros((n, 6), **f32) if need_sps else None,
        boundnormal=None if normals is None else torch.tensor(normals, **f32),
        motionvel=None if normals is None else torch.zeros((n, 3), **f32),
    )


def _make_domain(csp: CteSph, pos, headroom=0.5):
    """Static cell grid from particle bounds + a 2*KernelSize halo + free-
    surface headroom as a fraction of the lattice height (the
    `<simulationdomain>` 'default + X%' idiom); in 2D one cell row spans
    y = pos[0,1] +- KernelSize/2."""
    ks = csp.kernelsize
    pmin = pos.min(axis=0) - 2 * ks
    pmax = pos.max(axis=0) + 2 * ks
    pmax[2] += headroom * (pos[:, 2].max() - pos[:, 2].min())
    if csp.simulate2d:
        pmin[1] = pos[0, 1] - ks / 2
        pmax[1] = pos[0, 1] + ks / 2
    return cd.make_domain(tuple(pmin), tuple(pmax), ks,
                          simulate2d=csp.simulate2d, skin=DOMAIN_SKIN)


def dambreak3d(dp=0.02, *, tank=(1.6, 0.67, 0.4), column=(0.4, 0.67, 0.3),
               obstacle=True, visco=0.1, need_verlet=False, need_sps=False,
               mdbc=False, device="cuda") -> Case:
    """3D dam break with optional building obstacle (CaseDambreak_Def.xml):
    coefsound 20, free-surface headroom 100% of the lattice height.
    ``visco`` is the viscosity constant (artificial alpha, or the kinematic
    viscosity under laminar+SPS); ``need_sps`` allocates the zero SPS stress
    that laminar+SPS reads; ``mdbc`` gives the walls their normals.  As in
    the JAX package, the constants are those of artificial viscosity
    (``spssmag = spsblin = 0``); a laminar+SPS run takes
    ``make_ctesph(..., tvisco=LAMINAR_SPS)`` constants, as an XML case's
    do.  ``need_verlet`` allocates the M1 state the Verlet step reads."""
    csp = make_ctesph(simulate2d=False, dp=dp, hswl=column[2], coefh=1.0,
                      visco=visco, coefsound=20.0)
    d = Draw(dp=dp)
    d.box((0, 0, 0), column, ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), tank, ptype=td.TYPE_FIXED, mk=0,
          faces="bottom|left|right|front|back")
    if obstacle:
        d.box((0.9, 0.24, 0.0), (1.02, 0.36, 0.45),
              ptype=td.TYPE_FIXED, mk=1, faces="top|left|right|front|back")
    pos, code = d.build()
    dom = _make_domain(csp, pos, headroom=1.0)
    st = _make_state(csp, pos, code, zsurf=column[2], device=device,
                     need_verlet=need_verlet, need_sps=need_sps,
                     normals=d.normals if mdbc else None)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="dambreak3d", dp=dp, zsurf=column[2]))


def dambreak2d(dp=0.02, *, tank=(4.0, 3.0), column=(1.0, 2.0), visco=0.02,
               need_verlet=False, need_sps=False, mdbc=False,
               device="cuda") -> Case:
    """2D dam break (CaseDambreakVal2D_Def.xml geometry): a column of
    ``column`` (x, z) in a tank with bottom, left and right walls one
    particle thick; ``mdbc`` gives the walls their normals, ``need_verlet``
    the state its M1 arrays."""
    hswl = column[1]
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=hswl, coefh=1.0,
                      visco=visco, coefsound=20.0)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (column[0], 0, column[1]), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (tank[0], 0, tank[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|left|right")
    pos, code = d.build()
    dom = _make_domain(csp, pos)
    st = _make_state(csp, pos, code, zsurf=column[1], device=device,
                     need_verlet=need_verlet, need_sps=need_sps,
                     normals=d.normals if mdbc else None)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="dambreak2d", dp=dp, zsurf=column[1]))


def floatingbox2d(dp=0.02, *, tank=(2.0, 1.2), water=0.5,
                  box=(0.2, 0.2), box_pos=(0.9, 0.42), box_rho=500.0,
                  visco=0.05, ftpause=0.0, device="cuda") -> Case:
    """2D floating box in a water tank (the 'floating box in waves'
    family): a solid box of density ``box_rho`` drawn over the water, body
    0 of ``meta["ftcfg"]``, with its body state in ``state.ft``.  The walls
    carry no mDBC normals, as in the JAX package."""
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=water, coefh=1.0,
                      visco=visco, coefsound=20.0)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (tank[0], 0, water), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (tank[0], 0, tank[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|left|right")
    d.box((box_pos[0], 0, box_pos[1]),
          (box_pos[0] + box[0], 0, box_pos[1] + box[1]),
          ptype=td.TYPE_FLOATING, mk=0)
    pos, code = d.build()
    # the floating typecode's value is the body index
    isft = td.code_type(code) == td.TYPE_FLOATING
    ftcfg, ftstate = FT.make_floating([pos[isft]], [box_rho], csp,
                                      ftpause=ftpause, device=device)
    dom = _make_domain(csp, pos)
    st = _make_state(csp, pos, code, zsurf=water, device=device)
    st.ft = ftstate
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="floatingbox2d", dp=dp, zsurf=water,
                          ftcfg=ftcfg))


def waveflume2d(dp=0.02, *, flume=(6.0, 1.0), water=0.4, piston_freq=0.8,
                piston_amp=0.1, visco=0.02, coefsound=20.0, need_verlet=False,
                mdbc=False, device="cuda") -> Case:
    """2D wave flume with a sinusoidal piston wavemaker (the JAX package's
    ``waveflume2d``): still water of depth ``water`` over a bottom, a right
    wall, and a piston (moving mk 10) at x < 0 as thick as the kernel's
    support, which ``meta["motion"]`` (``piston_sinusoidal``) drives.  The
    piston's stroke x = -amp ... amp reaches past the domain's halo of
    2*kernelsize behind it when amp exceeds it.  ``mdbc`` gives the bottom,
    the right wall and the piston's face toward the water their normals
    (the JAX builder has no such option); ``need_verlet`` the state its M1
    arrays."""
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=water, coefh=1.0,
                      visco=visco, coefsound=coefsound)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (flume[0], 0, water), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (flume[0], 0, flume[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|right")
    # the piston: a column of moving wall thick enough to cover the kernel's
    # support, so that fast strokes do not push fluid through it
    nlay = max(2, int(math.ceil(csp.kernelsize / dp)) + 1)
    d.box((-nlay * dp, 0, 0), (-dp, 0, flume[1]), ptype=td.TYPE_MOVING, mk=10)
    if mdbc:
        # the piston's face at x = -dp looks along +x, into the water
        for key, (ptype, mk, _n) in d.points.items():
            if ptype == td.TYPE_MOVING and key[0] == -1:
                d.points[key] = (ptype, mk, (dp, 0.0, 0.0))
    pos, code = d.build()
    dom = _make_domain(csp, pos)
    st = _make_state(csp, pos, code, zsurf=water, device=device,
                     need_verlet=need_verlet,
                     normals=d.normals if mdbc else None)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    motion = MOT.piston_sinusoidal(10, freq=piston_freq, amplitude=piston_amp)
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="waveflume2d", dp=dp, zsurf=water,
                          motion=motion))
