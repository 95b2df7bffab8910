"""Wrapper of the hand-written CUDA pair kernel ``csrc/cellforce.cu``.

Counterpart of `dualsphysics_multilayer_tpu/ops/pallas/cellforce.py` on the
main path (`interaction_forces_rows_v3` launching `_kernel_v3` with
`_make_phys_v4`):

1. per-particle channel prep, the `_fast_channels` analog: position with
   pressure and velocity with density packed as 16-byte rows, and the
   particle kind (type, or -1 when inactive);
2. the launch, on torch's current stream;
3. the `_forces_from_canon` analog: the kernel already writes ``ace`` and
   ``ar`` (diffusion folded in); the wrapper reduces the per-target viscdt
   with ``torch.amax`` and clamps it at 0.

The wrapper takes CUDA tensors only and raises on anything the kernel does
not take; CPU tensors go to the plain version in ``ops/forces.py``.
:func:`interaction_forces_host_twin` runs the same body compiled by g++ on
CPU tensors, for tests.
"""

from __future__ import annotations

import ctypes

import torch

from ... import typesdef as td
from ...typesdef import CteSph
from .. import eos
from ..celldiv import CellDiv, Domain
from ..forces import Forces, SolverOpts, check_supported
from . import build

# Kernel launches since the last reset; the only mutable module state.
launches = 0


class CfParams(ctypes.Structure):
    """Mirror of ``struct CfParams`` in csrc/pairbody.cuh."""
    _fields_ = ([(k, ctypes.c_int) for k in (
        "n", "ncx", "ncy", "ncz", "ncells", "sim2d", "tdensity")]
        + [(k, ctypes.c_float) for k in (
            "kernelsize2", "kernelh", "bwen", "eta2", "cs0", "visco",
            "viscobound", "ddtkh", "ddtgz", "rhopzero", "ovgamma",
            "massfluid", "massbound", "almostzero")])


def make_params(csp: CteSph, opts: SolverOpts, dom: Domain, n: int) -> CfParams:
    ncx, ncy, ncz = dom.nc
    return CfParams(
        n=n, ncx=ncx, ncy=ncy, ncz=ncz, ncells=dom.ncells,
        sim2d=int(csp.simulate2d), tdensity=opts.tdensity.value,
        kernelsize2=csp.kernelsize2, kernelh=csp.kernelh, bwen=csp.kwend.bwen,
        eta2=csp.eta2, cs0=csp.cs0, visco=csp.visco,
        viscobound=csp.visco * csp.viscoboundfactor, ddtkh=csp.ddtkh,
        ddtgz=csp.ddtgz, rhopzero=csp.rhopzero, ovgamma=1.0 / csp.gamma,
        massfluid=csp.massfluid, massbound=csp.massbound,
        almostzero=td.ALMOSTZERO)


def channels(csp: CteSph, pos, vel, rho, code):
    """(pospress (n,4), velrho (n,4), kind (n,) int32) for the kernel."""
    press = eos.press_from_rho(csp, rho)
    pospress = torch.cat([pos, press[:, None]], dim=1).contiguous()
    velrho = torch.cat([vel, rho[:, None]], dim=1).contiguous()
    kind = torch.where(td.is_active(code), td.code_type(code), -1)
    return pospress, velrho, kind.to(torch.int32).contiguous()


def _check(dom: Domain, cells: CellDiv, pos, vel, rho, code, device_type):
    n = pos.shape[0]
    want = {
        "pos": (pos, torch.float32, (n, 3)),
        "vel": (vel, torch.float32, (n, 3)),
        "rho": (rho, torch.float32, (n,)),
        "code": (code, torch.int32, (n,)),
        "cells.cell": (cells.cell, torch.int32, (n,)),
        "cells.begin": (cells.begin, torch.int32, (dom.ncells + 1,)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.device.type != device_type or x.device != pos.device:
            raise ValueError(f"cellforce: {name} is on {x.device}, "
                             f"expected {pos.device} ({device_type})")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"cellforce: {name} is {x.dtype}{tuple(x.shape)}, "
                             f"expected {dtype}{shape}")
        if not x.is_contiguous():
            raise ValueError(f"cellforce: {name} is not contiguous")
    if n == 0:
        raise ValueError("cellforce: no particles")


def _run(lib_fn, csp, opts, dom, cells, pos, vel, rho, code, extra=()):
    check_supported(csp, opts)
    n = pos.shape[0]
    pospress, velrho, kind = channels(csp, pos, vel, rho, code)
    ace = torch.empty((n, 3), dtype=torch.float32, device=pos.device)
    ar = torch.empty(n, dtype=torch.float32, device=pos.device)
    viscdt = torch.empty(n, dtype=torch.float32, device=pos.device)
    params = make_params(csp, opts, dom, n)
    err = lib_fn(ctypes.byref(params), pospress.data_ptr(), velrho.data_ptr(),
                 kind.data_ptr(), cells.cell.data_ptr(), cells.begin.data_ptr(),
                 ace.data_ptr(), ar.data_ptr(), viscdt.data_ptr(), *extra)
    if err != 0:
        raise RuntimeError(f"cellforce kernel launch failed: CUDA error {err}")
    viscdtmax = torch.clamp(torch.amax(viscdt), min=0.0)
    return Forces(ace=ace, ar=ar, viscdtmax=viscdtmax)


def interaction_forces_cuda(csp: CteSph, opts: SolverOpts, dom: Domain,
                            cells: CellDiv, pos, vel, rho, code) -> Forces:
    """One interaction through the CUDA kernel (CUDA tensors only)."""
    global launches
    _check(dom, cells, pos, vel, rho, code, "cuda")
    lib = build.cuda_library()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        fr = _run(lib.dsph_cellforce, csp, opts, dom, cells, pos, vel, rho,
                  code, extra=(stream,))
    launches += 1
    return fr


def interaction_forces_host_twin(csp: CteSph, opts: SolverOpts, dom: Domain,
                                 cells: CellDiv, pos, vel, rho,
                                 code) -> Forces:
    """The kernel's body compiled by g++, on CPU tensors (for tests)."""
    _check(dom, cells, pos, vel, rho, code, "cpu")
    lib = build.host_twin_library()
    return _run(lib.dsph_cellforce_host, csp, opts, dom, cells, pos, vel,
                rho, code)
