"""Wrapper of the hand-written multiphase non-Newtonian kernels
``csrc/nnforce.cu``.

Counterpart of `dualsphysics_multilayer_tpu/ops/pallas/nnforce.py`
`interaction_forces_nn_rows`, which launches the TPU kernels `_kernel_nn1`,
`_kernel_nn3` and `_kernel_fda`:

1. per-particle channel prep (``forces_nn.channels``, the analog of the
   TPU wrapper's channels): position with the per-phase pressure and
   velocity with density packed as 16-byte rows, the particle kind (type,
   or -1 when inactive) and the phase index; the phase constants travel in
   the parameter struct's tables;
2. ``nnforce_p1`` (or ``nnforce_fda``) on torch's current stream, writing
   ace, ar with the density diffusion folded in, the per-target viscdt and
   the velocity gradient (or the per-target eta max), and with a shifting
   mode the shifting sums and flags; the launcher picks the instance of the
   smoothing kernel and the shifting mode the parameters name;
3. pass 2 in plain torch between the launches (``forces_nn.pass2``);
4. ``nnforce_p3``, adding the viscous forces into ace, the instance of
   the smoothing kernel and the viscous form the parameters name;
5. 2D zeroing of ace[:,1], and the viscdt and eta reductions
   (``forces_nn.run_passes``).

The wrappers take CUDA tensors only and raise on anything the kernels do
not take; CPU tensors go to the plain version in ``ops/forces_nn.py``.
:func:`interaction_forces_nn_host_twin` runs the same bodies compiled by g++
on CPU tensors, for tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import typesdef as td
from ...typesdef import CteSph, TpShifting, TpVisco
from .. import forces_nn as NN
from ..celldiv import CellDiv, Domain
from ..forces import SolverOpts
from . import build
from .cellforce import CubicCte, check_inputs, state_inputs

# Kernel launches since the last reset, one count per kernel; the only
# mutable module state.
launches = dict(nnforce_p1=0, nnforce_p3=0, nnforce_fda=0)

# the viscous form of pass 3 (VISC_* of csrc/nnbody.cuh, the VISC of its
# instances) for each viscosity option
VISC = {TpVisco.ARTIFICIAL: 0, TpVisco.LAMINAR_SPS: 1, TpVisco.CONST_EQ: 2}
# NnParams table -> PhaseCfg.tables key
_TABLES = dict(cs0="cs0", mass="mass", visco="visco", tauy="tau_yield",
               taumax="tau_max", bimul="bi_multi", hbpm="hbp_m", hbpn="hbp_n")


class NnParams(ctypes.Structure):
    """Mirror of ``struct NnParams`` in csrc/nnbody.cuh."""
    _fields_ = ([(k, ctypes.c_int) for k in (
        "n", "ncx", "ncy", "ncz", "ncells", "sim2d", "tdensity", "visc",
        "gradvel", "tkernel", "shiftmode")]
        + [(k, ctypes.c_float) for k in (
            "kernelsize2", "kernelh", "bwen", "eta2", "ddtkh", "ddtgz",
            "rhopzero", "ovgamma", "massbound", "almostzero")]
        + [("cubic", CubicCte)]
        + [(k, ctypes.c_float * NN.MAX_PHASES) for k in _TABLES])


@functools.lru_cache(maxsize=32)
def make_params(csp: CteSph, opts: SolverOpts, phases: NN.PhaseCfg,
                dom: Domain, n: int) -> NnParams:
    """The kernels' parameters, the phase tables holding the f32 values of
    ``PhaseCfg.tables`` (cached: nothing writes the struct after)."""
    ncx, ncy, ncz = dom.nc
    tb = phases.tables(csp, "cpu")
    tables = {k: (ctypes.c_float * NN.MAX_PHASES)(*tb[src].tolist())
              for k, src in _TABLES.items()}
    return NnParams(
        n=n, ncx=ncx, ncy=ncy, ncz=ncz, ncells=dom.ncells,
        sim2d=int(csp.simulate2d), tdensity=opts.tdensity.value,
        visc=VISC[opts.tvisco], gradvel=int(NN.uses_gradvel(opts)),
        tkernel=csp.tkernel.value, shiftmode=opts.shiftmode.value,
        kernelsize2=csp.kernelsize2, kernelh=csp.kernelh, bwen=csp.kwend.bwen,
        eta2=csp.eta2, ddtkh=csp.ddtkh, ddtgz=csp.ddtgz,
        rhopzero=csp.rhopzero, ovgamma=1.0 / csp.gamma,
        massbound=csp.massbound, almostzero=td.ALMOSTZERO,
        cubic=CubicCte.of(csp), **tables)


def _device_type(twin: bool) -> str:
    return "cpu" if twin else "cuda"


def _check(kernel, twin, dom, cells, pos, vel, rho, ch: NN.NnChannels,
           extra=None):
    n = pos.shape[0]
    want = state_inputs(dom, cells, pos, vel, rho, ch.kind)
    want["kind"] = want.pop("code")
    want["phase"] = (ch.phase, torch.int32, (n,))
    want["press"] = (ch.press, torch.float32, (n,))
    want.update(extra or {})
    check_inputs(kernel, _device_type(twin), want)


def _launch(kernel: str, twin: bool, device, *args) -> None:
    """Run ``kernel`` on ``args``: the g++ twin, or the CUDA launcher on
    torch's current stream of ``device``, counted in ``launches``.  A
    non-zero error code raises."""
    if twin:
        err = getattr(build.host_twin_library("nnforce"),
                      f"dsph_{kernel}_host")(*args)
    else:
        fn = getattr(build.cuda_library("nnforce"), f"dsph_{kernel}")
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    if not twin:
        launches[kernel] += 1


def _ptr(x):
    return None if x is None else x.data_ptr()


def _rows(pos, vel, rho, ch: NN.NnChannels):
    """(pospress (n,4), velrho (n,4)) rows for the kernels."""
    return (torch.cat([pos, ch.press[:, None]], dim=1).contiguous(),
            torch.cat([vel, rho[:, None]], dim=1).contiguous())


def pass1(csp: CteSph, opts: SolverOpts, phases: NN.PhaseCfg, dom: Domain,
          cells: CellDiv, pos, vel, rho, ch: NN.NnChannels,
          twin: bool = False) -> NN.Pass1:
    """``nnforce_p1``, or ``nnforce_fda`` under ``forces_nn.uses_fda``,
    the instance of ``csp.tkernel`` and ``opts.shiftmode``."""
    kernel = "nnforce_fda" if NN.uses_fda(opts) else "nnforce_p1"
    _check(kernel, twin, dom, cells, pos, vel, rho, ch)
    n = pos.shape[0]
    f32 = dict(dtype=torch.float32, device=pos.device)
    shifting = opts.shiftmode != TpShifting.NONE
    out = NN.Pass1(ace=torch.empty((n, 3), **f32), ar=torch.empty(n, **f32),
                   viscdt=torch.empty(n, **f32),
                   gradvel=torch.zeros((n, 6), **f32),
                   etamax=torch.zeros(n, **f32),
                   shift=torch.empty((n, 4), **f32) if shifting else None,
                   shiftblk=torch.empty(n, dtype=torch.bool, device=pos.device)
                   if shifting else None)
    pospress, velrho = _rows(pos, vel, rho, ch)
    last = out.etamax if kernel == "nnforce_fda" else out.gradvel
    _launch(kernel, twin, pos.device,
            ctypes.byref(make_params(csp, opts, phases, dom, n)),
            pospress.data_ptr(), velrho.data_ptr(), ch.kind.data_ptr(),
            ch.phase.data_ptr(), cells.cell.data_ptr(), cells.begin.data_ptr(),
            out.ace.data_ptr(), out.ar.data_ptr(), out.viscdt.data_ptr(),
            last.data_ptr(), _ptr(out.shift), _ptr(out.shiftblk))
    return out


def pass3(csp: CteSph, opts: SolverOpts, phases: NN.PhaseCfg, dom: Domain,
          cells: CellDiv, pos, vel, rho, ch: NN.NnChannels, visco_eta, tau,
          ace, twin: bool = False) -> None:
    """``nnforce_p3``, the instance of ``csp.tkernel`` and the viscous form
    of ``opts.tvisco``: adds the viscous forces into ``ace``."""
    n = pos.shape[0]
    _check("nnforce_p3", twin, dom, cells, pos, vel, rho, ch, extra={
        "visco_eta": (visco_eta, torch.float32, (n,)),
        "tau": (tau, torch.float32, (n, 6)),
        "ace": (ace, torch.float32, (n, 3))})
    pospress, velrho = _rows(pos, vel, rho, ch)
    _launch("nnforce_p3", twin, pos.device,
            ctypes.byref(make_params(csp, opts, phases, dom, n)),
            pospress.data_ptr(), velrho.data_ptr(), ch.kind.data_ptr(),
            ch.phase.data_ptr(), cells.cell.data_ptr(), cells.begin.data_ptr(),
            visco_eta.data_ptr(), tau.data_ptr(), ace.data_ptr())


def _interaction(twin, csp, opts, phases, dom, cells, pos, vel, rho, code):
    check_inputs("nnforce", _device_type(twin),
                 state_inputs(dom, cells, pos, vel, rho, code))
    return NN.run_passes(csp, opts, phases, dom, cells, pos, vel, rho, code,
                         functools.partial(pass1, twin=twin),
                         functools.partial(pass3, twin=twin))


def interaction_forces_nn_cuda(csp: CteSph, opts: SolverOpts,
                               phases: NN.PhaseCfg, dom: Domain,
                               cells: CellDiv, pos, vel, rho,
                               code) -> NN.NnResult:
    """One NN interaction through the CUDA kernels (CUDA tensors only)."""
    return _interaction(False, csp, opts, phases, dom, cells, pos, vel, rho,
                        code)


def interaction_forces_nn_host_twin(csp: CteSph, opts: SolverOpts,
                                    phases: NN.PhaseCfg, dom: Domain,
                                    cells: CellDiv, pos, vel, rho,
                                    code) -> NN.NnResult:
    """The kernels' bodies compiled by g++, on CPU tensors (for tests)."""
    return _interaction(True, csp, opts, phases, dom, cells, pos, vel, rho,
                        code)
