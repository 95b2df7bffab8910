"""Wrapper of the hand-written CUDA pair kernels ``csrc/cellforce.cu``.

Counterpart of `dualsphysics_multilayer_tpu/ops/pallas/cellforce.py`: one
C launcher per TPU kernel, picked by :func:`kernel_name` from the smoothing
kernel and the viscosity,

* ``cellforce``: Wendland, artificial viscosity (`_kernel_v3` with
  `_make_phys_v4`, the main path);
* ``cellforce_cubic``: the cubic spline with its tensile correction,
  artificial viscosity (`_kernel_v3` with `_make_phys_v3`);
* ``cellforce_lamsps``: laminar+SPS viscosity, either kernel (the v1
  `_kernel`);

each with the shifting sums when ``opts.shiftmode`` names a mode, the
floating bodies' particle masses under ``opts.with_floating``, the mDBC
form of the Molteni diffusion under ``opts.tboundary == MDBC`` and the
lateral symmetry plane y = 0 under ``opts.symmetry`` (their SYM instances,
with any of the above, counted as ``cellforce_sym``,
``cellforce_cubic_sym`` and ``cellforce_lamsps_sym``).
A call:

1. per-particle channel prep, the `_fast_channels` analog: position with
   pressure and velocity with density packed as 16-byte rows, the particle
   kind (type, or -1 when inactive) and, with floating bodies, each slot's
   mass (the `ftomassp` channel);
2. the launch, on torch's current stream;
3. the `_forces_from_canon` analog: the kernel already writes ``ace``,
   ``ar`` (diffusion folded in), the SPS velocity gradient and the shifting
   sums; the wrapper reduces the per-target viscdt with ``torch.amax`` and
   clamps it at 0.

The wrapper takes CUDA tensors only and raises on anything the kernel does
not take; CPU tensors go to the plain version in ``ops/forces.py``.
:func:`interaction_forces_host_twin` runs the same bodies compiled by g++
on CPU tensors, for tests.
"""

from __future__ import annotations

import ctypes

import torch

from ... import typesdef as td
from ...typesdef import CteSph, TpKernel, TpShifting, TpVisco
from .. import eos
from .. import pairphys as PP
from ..celldiv import CellDiv, Domain
from ..forces import Forces, SolverOpts, check_spstau, check_supported
from . import build

# Kernel launches since the last reset, one count per kernel and one for
# the symmetry-plane instances of each; the only mutable module state.
launches = dict(cellforce=0, cellforce_cubic=0, cellforce_lamsps=0,
                cellforce_sym=0, cellforce_cubic_sym=0,
                cellforce_lamsps_sym=0)
# queued image slots carry this bit (kMirror in csrc/pairbody.cuh), so a
# symmetry launch takes fewer slots
MIRROR_BIT = 1 << 30


class CubicCte(ctypes.Structure):
    """Mirror of ``struct CubicCte`` in csrc/cellwalk.cuh, embedded in both
    kernels' parameters."""
    _fields_ = [(k, ctypes.c_float) for k in (
        "a2", "a24", "c1", "d1", "c2", "od_wdeltap")]

    @classmethod
    def of(cls, csp: CteSph) -> "CubicCte":
        kc = csp.kcubic
        return cls(a2=kc.a2, a24=kc.a24, c1=kc.c1, d1=kc.d1, c2=kc.c2,
                   od_wdeltap=kc.od_wdeltap)


class CfParams(ctypes.Structure):
    """Mirror of ``struct CfParams`` in csrc/pairbody.cuh."""
    _fields_ = ([(k, ctypes.c_int) for k in (
        "n", "ncx", "ncy", "ncz", "ncells", "sim2d", "tdensity", "tkernel",
        "shiftmode", "tboundary")]
        + [(k, ctypes.c_float) for k in (
            "kernelsize2", "kernelh", "bwen", "eta2", "cs0", "visco",
            "viscobound", "ddtkh", "ddtgz", "rhopzero", "ovgamma",
            "massfluid", "massbound", "almostzero")]
        + [("cubic", CubicCte), ("symmetry", ctypes.c_int),
           ("kernelsize", ctypes.c_float)])


def kernel_name(csp: CteSph, opts: SolverOpts) -> str:
    """The kernel that computes this configuration."""
    if opts.tvisco == TpVisco.LAMINAR_SPS:
        return "cellforce_lamsps"
    return "cellforce_cubic" if csp.tkernel == TpKernel.CUBIC else "cellforce"


def counter_name(csp: CteSph, opts: SolverOpts) -> str:
    """The ``launches`` entry of this configuration: the kernel's, or
    under ``opts.symmetry`` that of its symmetry-plane instances."""
    return kernel_name(csp, opts) + ("_sym" if opts.symmetry else "")


def make_params(csp: CteSph, opts: SolverOpts, dom: Domain, n: int,
                ddtkh=None, visco=None) -> CfParams:
    """The launch parameters, built per launch: ``ddtkh`` and ``visco``
    override the constants of ``csp`` (``pairphys.launch_values``)."""
    ncx, ncy, ncz = dom.nc
    visco, viscobound, ddtkh = PP.launch_values(csp, ddtkh, visco)
    return CfParams(
        n=n, ncx=ncx, ncy=ncy, ncz=ncz, ncells=dom.ncells,
        sim2d=int(csp.simulate2d), tdensity=opts.tdensity.value,
        tkernel=csp.tkernel.value, shiftmode=opts.shiftmode.value,
        tboundary=opts.tboundary.value,
        kernelsize2=csp.kernelsize2, kernelh=csp.kernelh, bwen=csp.kwend.bwen,
        eta2=csp.eta2, cs0=csp.cs0, visco=visco, viscobound=viscobound,
        ddtkh=ddtkh,
        ddtgz=csp.ddtgz, rhopzero=csp.rhopzero, ovgamma=1.0 / csp.gamma,
        massfluid=csp.massfluid, massbound=csp.massbound,
        almostzero=td.ALMOSTZERO, cubic=CubicCte.of(csp),
        symmetry=int(opts.symmetry), kernelsize=csp.kernelsize)


def channels(csp: CteSph, pos, vel, rho, code):
    """(pospress (n,4), velrho (n,4), kind (n,) int32) for the kernel."""
    press = eos.press_from_rho(csp, rho)
    pospress = torch.cat([pos, press[:, None]], dim=1).contiguous()
    velrho = torch.cat([vel, rho[:, None]], dim=1).contiguous()
    kind = torch.where(td.is_active(code), td.code_type(code), -1)
    return pospress, velrho, kind.to(torch.int32).contiguous()


def floating_mass(csp: CteSph, opts: SolverOpts, code, ftomassp):
    """(n,) f32 particle mass of each slot, read by the kernel at floating
    candidates only, when the run has floating bodies (``with_floating`` and
    ``ftomassp`` given); else None, and floating candidates weigh
    ``massfluid``."""
    if not opts.with_floating or ftomassp is None:
        return None
    return PP.particle_flags(csp, code, ftomassp, True)[3].contiguous()


def check_inputs(kernel: str, device_type: str, want: dict) -> None:
    """Raise ValueError unless every ``name: (tensor, dtype, shape)`` of
    ``want`` is a contiguous tensor of that dtype and shape on the first
    one's device, of type ``device_type``, and the first is not empty."""
    first = next(iter(want.values()))[0]
    for name, (x, dtype, shape) in want.items():
        if x.device.type != device_type or x.device != first.device:
            raise ValueError(f"{kernel}: {name} is on {x.device}, "
                             f"expected {first.device} ({device_type})")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{kernel}: {name} is {x.dtype}{tuple(x.shape)}, "
                             f"expected {dtype}{shape}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if first.shape[0] == 0:
        raise ValueError(f"{kernel}: no particles")


def state_inputs(dom: Domain, cells: CellDiv, pos, vel, rho, code) -> dict:
    """The state and divide arrays every pair kernel reads, for
    :func:`check_inputs`."""
    n = pos.shape[0]
    return {
        "pos": (pos, torch.float32, (n, 3)),
        "vel": (vel, torch.float32, (n, 3)),
        "rho": (rho, torch.float32, (n,)),
        "code": (code, torch.int32, (n,)),
        "cells.cell": (cells.cell, torch.int32, (n,)),
        "cells.begin": (cells.begin, torch.int32, (dom.ncells + 1,)),
    }


def _prepare(csp, opts, dom, cells, pos, vel, rho, code, spstau, ftomassp,
             device_type):
    """Check the configuration and the inputs; returns the kernel's name."""
    check_supported(csp, opts)
    check_spstau(opts, spstau)
    name = kernel_name(csp, opts)
    want = state_inputs(dom, cells, pos, vel, rho, code)
    if opts.tvisco == TpVisco.LAMINAR_SPS:
        want["spstau"] = (spstau, torch.float32, (pos.shape[0], 6))
    if ftomassp is not None:
        want["ftomassp"] = (ftomassp, torch.float32, (ftomassp.shape[0],))
    check_inputs(name, device_type, want)
    if opts.symmetry and pos.shape[0] >= MIRROR_BIT:
        raise ValueError(f"{name}: {pos.shape[0]} slots, the symmetry "
                         f"instances take fewer than {MIRROR_BIT}")
    return name


def _run(fn, name, csp, opts, dom, cells, pos, vel, rho, code, spstau,
         ftomassp, ddtkh, visco, extra=()):
    n = pos.shape[0]
    dev = pos.device
    use_sps = opts.tvisco == TpVisco.LAMINAR_SPS
    use_shift = opts.shiftmode != TpShifting.NONE
    pospress, velrho, kind = channels(csp, pos, vel, rho, code)
    ftmass = floating_mass(csp, opts, code, ftomassp)
    ace = torch.empty((n, 3), dtype=torch.float32, device=dev)
    ar = torch.empty(n, dtype=torch.float32, device=dev)
    viscdt = torch.empty(n, dtype=torch.float32, device=dev)
    gradvel = torch.empty((n, 6), dtype=torch.float32, device=dev) \
        if use_sps else None
    shift = torch.empty((n, 4), dtype=torch.float32, device=dev) \
        if use_shift else None
    shiftblk = torch.empty(n, dtype=torch.bool, device=dev) \
        if use_shift else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    params = make_params(csp, opts, dom, n, ddtkh, visco)
    err = fn(ctypes.byref(params), pospress.data_ptr(), velrho.data_ptr(),
             kind.data_ptr(), cells.cell.data_ptr(), cells.begin.data_ptr(),
             ptr(spstau if use_sps else None), ptr(ftmass), ace.data_ptr(),
             ar.data_ptr(), viscdt.data_ptr(), ptr(gradvel), ptr(shift),
             ptr(shiftblk), *extra)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    viscdtmax = torch.clamp(torch.amax(viscdt), min=0.0)
    return Forces(ace=ace, ar=ar, viscdtmax=viscdtmax, shiftposfs=shift,
                  shift_blocked=shiftblk, spsgradvel=gradvel)


def interaction_forces_cuda(csp: CteSph, opts: SolverOpts, dom: Domain,
                            cells: CellDiv, pos, vel, rho, code,
                            spstau=None, ftomassp=None, ddtkh=None,
                            visco=None) -> Forces:
    """One interaction through the CUDA kernel of this configuration (CUDA
    tensors only), counted in ``launches``; ``ddtkh`` and ``visco``
    override the constants of ``csp`` (:func:`make_params`)."""
    name = _prepare(csp, opts, dom, cells, pos, vel, rho, code, spstau,
                    ftomassp, "cuda")
    fn = getattr(build.cuda_library("cellforce"), f"dsph_{name}")
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        fr = _run(fn, name, csp, opts, dom, cells, pos, vel, rho, code, spstau,
                  ftomassp, ddtkh, visco, extra=(stream,))
    launches[counter_name(csp, opts)] += 1
    return fr


def interaction_forces_host_twin(csp: CteSph, opts: SolverOpts, dom: Domain,
                                 cells: CellDiv, pos, vel, rho, code,
                                 spstau=None, ftomassp=None, ddtkh=None,
                                 visco=None) -> Forces:
    """The kernel's body compiled by g++, on CPU tensors (for tests)."""
    name = _prepare(csp, opts, dom, cells, pos, vel, rho, code, spstau,
                    ftomassp, "cpu")
    fn = getattr(build.host_twin_library("cellforce"), f"dsph_{name}_host")
    return _run(fn, name, csp, opts, dom, cells, pos, vel, rho, code, spstau,
                ftomassp, ddtkh, visco)
