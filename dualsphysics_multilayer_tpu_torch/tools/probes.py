"""The two hardware probes on the card, counterparts of the JAX package's
TPU probes, with their plain torch versions:

* ``fma`` (``csrc/probe_fma.cu``), the counterpart of ``vputime.py``'s
  ``make_kernel.kernel``: per thread, ``chains`` independent chains through
  a recurrence of one operation (fma alternating with max; the pair
  bodies' mix of fma, max, mul and compare; rsqrt; the approximate
  reciprocal), ``STEPS`` steps per iteration for ``rep`` iterations, the
  chains' sum written out.  Its rate in steps per SM per clock, against
  the 128 f32 lanes of a Hopper SM, says how far instruction issue bounds
  a loop like the pair kernels' candidate loop.  The TPU probe's
  constants (the v5e clock, the (32, 128) tile, vreg-ops per cycle) have no
  counterpart: the card's own SM count, clock and lanes take their place.
* ``gather`` (``csrc/probe_gather.cu``), the counterpart of
  ``probe_unaligned.py``'s ``kern``: ``niter`` loads of a 16 x 128 window
  of a (16, 4096) f32 buffer at offsets from a seeded table (clamped to
  [0, 3968], so no load leaves the buffer), aligned (offset rounded down
  to a multiple of 128) or not, each followed by
  ``acc = acc + cw*1.000001 + acc*cw``, over ``groups`` windows in flight,
  with the buffer read from global memory or staged in shared memory.  The
  TPU probe's first question, whether Mosaic compiles a lane slice at an
  offset that is not a multiple of 128, has no counterpart here: CUDA
  loads from any 4-byte-aligned address.  Its second, what a misaligned
  window costs, does: the pair kernels walk cell ranges that start at
  arbitrary slots.  The kernel spreads the windows' rows over the card,
  one chain of window loads per element, with the loads issued ahead of
  the FMAs; its bound counts the loads' bytes through the SMs' load paths
  (:func:`gather_bound_terms`).

The wrappers :func:`fma` and :func:`gather` launch the kernels on CUDA
tensors (counted in ``launches``) and run the plain versions on CPU
tensors; ``*_twin`` run the kernels' per-thread bodies compiled by g++
(exact rsqrt and reciprocal where the card uses its MUFU forms), for tests.

Run both probes' tables on one GPU with

    python -m dualsphysics_multilayer_tpu_torch.tools.probes
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.cuda import build

# FMA probe: operations (PROBE_* of csrc/probebody.cuh), chain counts, and
# recurrence steps per iteration (PROBE_STEPS; vputime.py's OPS)
OPS = ("fma", "mix", "rsqrt", "recip")
CHAINS = (1, 2, 4, 8)
STEPS = 64
REP = 4096            # iterations of the full table (vputime.py ran 50000)
F32_LANES = 128       # f32 FMA lanes of a Hopper SM
# gather probe: probe_unaligned.py's C, CW, W, NITER and G
ROWS, LANES, WIDTH = 16, 128, 4096
NITER, GROUPS = 512, 64
MAX_NITER = 16384     # GATHER_MAX_NITER: a block's window offsets, 64 KB
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12      # H100 SXM f32 outside the tensor cores, FLOP/s
# Bytes an SM's load path (the unified L1 and shared memory) delivers per
# clock: 32 banks of 32 bits per clock each (CUDA C++ Programming Guide,
# shared memory of compute capability 5.x on, which 9.0 keeps); the probe's
# staged aligned mode measures what a stream of window loads achieves.
SM_LOAD_BYTES = 128

# Kernel launches since the last reset, one count per kernel; the only
# mutable module state.
launches = dict(probe_fma=0, probe_gather=0)


class FmaParams(ctypes.Structure):
    """Mirror of ``struct FmaParams`` in csrc/probebody.cuh."""
    _fields_ = [(k, ctypes.c_int) for k in ("op", "chains", "rep", "n")]


class GatherParams(ctypes.Structure):
    """Mirror of ``struct GatherParams`` in csrc/probebody.cuh."""
    _fields_ = [(k, ctypes.c_int) for k in ("niter", "aligned", "staged",
                                            "groups")]


def _f32(v) -> float:
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fma_plain(x, op: str, chains: int, rep: int, steps: int = STEPS):
    """The FMA probe's recurrence on every element of ``x`` (f32), in torch:
    chains starting at x + c, ``rep`` iterations of ``steps`` steps, step j
    on chain j % chains with f = i * 1e-9 in iteration i; the chains' sum."""
    accs = [x + float(c) for c in range(chains)]
    for i in range(rep):
        f = _f32(np.float32(i) * np.float32(1e-9))
        one_f = _f32(np.float32(1.0) + np.float32(f))
        for j in range(steps):
            c = j % chains
            a = accs[c]
            if op == "fma":
                a = torch.maximum(a, x * f - a) if j % 2 else a * one_f + x
            elif op == "mix":
                k = j % 4
                if k == 0:
                    a = a * one_f + x
                elif k == 1:
                    a = torch.maximum(a, x - f)
                elif k == 2:
                    a = a * (x + f)
                else:
                    a = a + (a > f).to(torch.float32)
            elif op == "rsqrt":
                a = torch.rsqrt(torch.abs(a) + x + f)
            elif op == "recip":
                a = 1.0 / (torch.abs(a) + x + f)
            else:
                raise ValueError(f"unknown FMA probe operation {op!r}")
            accs[c] = a
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def fma32(a, b, c):
    """a * b + c on f32 tensors, rounded once to f32 (a fused multiply-add):
    the product is exact in f64 and the f64 sum's rounding error exact
    (Knuth's two-sum), which settles the one case where rounding the f64
    sum again to f32 would differ, a sum that lands on the midpoint of two
    f32 values."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    r = s.float()
    # the f32 value on the other side of s, and whether s is their midpoint
    other = torch.nextafter(r, torch.where(s > r.double(), 1.0, -1.0)
                            .mul(float("inf")).float())
    mid = (r.double() + other.double()) * 0.5 == s
    toward = ((other.double() > s) == (err > 0)) & (err != 0)
    return torch.where(mid & toward, other, r)


def gather_plain(buf, offs, aligned: bool, fused: bool = False):
    """The gather probe's window loop in torch: (16, 128) f32.  ``fused``:
    each step as the two fused multiply-adds the kernel's line compiles to
    with nvcc (t = cw * 1.000001 + acc, then acc = cw * acc + t, each
    rounded once), so the kernel's output equals it bit for bit; unfused,
    each product and sum is rounded, as the g++ twin does."""
    acc = torch.zeros((ROWS, LANES), dtype=torch.float32, device=buf.device)
    k = torch.tensor(1.000001, dtype=torch.float32, device=buf.device)
    for off in offs.tolist():
        off = min(max(off, 0), WIDTH - LANES)
        if aligned:
            off = off // LANES * LANES
        cw = buf[:, off:off + LANES]
        if fused:
            acc = fma32(cw, acc, fma32(cw, k, acc))
        else:
            acc = acc + cw * 1.000001 + acc * cw
    return acc


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, want: dict, device_type: str):
    for k, (x, dtype, shape) in want.items():
        if x.device.type != device_type:
            raise ValueError(f"{name}: {k} is on {x.device}, expected "
                             f"{device_type}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {k} is {x.dtype}{tuple(x.shape)}, "
                             f"expected {dtype}{shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")


def _fma_params(x, op, chains, rep) -> FmaParams:
    if op not in OPS or chains not in CHAINS or rep < 0:
        raise ValueError(f"probe_fma: op {op!r}, chains {chains}, rep {rep}: "
                         f"expected op in {OPS}, chains in {CHAINS}, rep >= 0")
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"probe_fma: x is {tuple(x.shape)}, expected (n,)")
    return FmaParams(op=OPS.index(op), chains=chains, rep=rep, n=x.shape[0])


def _gather_params(buf, offs, aligned, staged, groups) -> GatherParams:
    if groups <= 0:
        raise ValueError(f"probe_gather: groups {groups}, expected > 0")
    if offs.dim() != 1 or offs.shape[0] > MAX_NITER:
        raise ValueError(f"probe_gather: offs is {tuple(offs.shape)}, "
                         f"expected (niter,) with niter <= {MAX_NITER}")
    return GatherParams(niter=offs.shape[0], aligned=int(aligned),
                        staged=int(staged), groups=groups)


def _launcher(kernel: str, device, *args):
    """A call of ``kernel``'s CUDA launcher on ``args`` on torch's current
    stream of ``device``, counted in ``launches``; a non-zero error code
    raises."""
    fn = getattr(build.cuda_library("probes"), f"dsph_{kernel}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                               f"{err}")
        launches[kernel] += 1
    return launch


def _run(kernel: str, twin: bool, device, *args) -> None:
    if not twin:
        return _launcher(kernel, device, *args)()
    fn = getattr(build.host_twin_library("probes"), f"dsph_{kernel}_host")
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _fma(x, op, chains, rep, twin):
    p = _fma_params(x, op, chains, rep)
    _check("probe_fma", {"x": (x, torch.float32, (p.n,))},
           "cpu" if twin else "cuda")
    out = torch.empty_like(x)
    _run("probe_fma", twin, x.device, ctypes.byref(p), x.data_ptr(),
         out.data_ptr())
    return out


def fma(x, op: str, chains: int, rep: int):
    """The FMA probe on every element of ``x`` (n,) f32: the kernel for a
    CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        _fma_params(x, op, chains, rep)
        return fma_plain(x, op, chains, rep)
    return _fma(x, op, chains, rep, twin=False)


def fma_twin(x, op: str, chains: int, rep: int):
    """The kernel's body compiled by g++, on a CPU tensor (for tests)."""
    return _fma(x, op, chains, rep, twin=True)


def _gather(buf, offs, aligned, staged, groups, twin):
    p = _gather_params(buf, offs, aligned, staged, groups)
    _check("probe_gather", {"buf": (buf, torch.float32, (ROWS, WIDTH)),
                            "offs": (offs, torch.int32, (p.niter,))},
           "cpu" if twin else "cuda")
    if offs.device != buf.device:
        raise ValueError(f"probe_gather: offs is on {offs.device}, buf on "
                         f"{buf.device}")
    out = torch.empty((groups, ROWS, LANES), dtype=torch.float32,
                      device=buf.device)
    _run("probe_gather", twin, buf.device, ctypes.byref(p), buf.data_ptr(),
         offs.data_ptr(), out.data_ptr())
    return out


def gather(buf, offs, aligned: bool, staged: bool = False,
           groups: int = GROUPS):
    """The gather probe: buf (16, 4096) f32, offs (niter,) int32 (clamped to
    [0, 3968]); returns (groups, 16, 128), every group the same window loop.
    The kernel for CUDA tensors (``staged``: the buffer read from shared
    memory), the plain version for CPU ones."""
    if buf.device.type == "cpu":
        _gather_params(buf, offs, aligned, staged, groups)
        return gather_plain(buf, offs, aligned).expand(groups, ROWS, LANES)
    return _gather(buf, offs, aligned, staged, groups, twin=False)


def gather_twin(buf, offs, aligned: bool, staged: bool = False,
                groups: int = GROUPS):
    """The kernel's body compiled by g++, on CPU tensors (for tests)."""
    return _gather(buf, offs, aligned, staged, groups, twin=True)


# ---------------------------------------------------------------------------
# inputs and the tables on the card
# ---------------------------------------------------------------------------

def fma_input(n: int, device) -> torch.Tensor:
    """vputime.py's input: every element 1e-6."""
    return torch.full((n,), 1e-6, dtype=torch.float32, device=device)


def gather_inputs(niter: int, device, seed: int = 0):
    """(buf (16, 4096) standard normal, offs (niter,) in [0, 3968)) from
    ``seed``, as probe_unaligned.py draws them."""
    rng = np.random.default_rng(seed)
    buf = torch.tensor(rng.standard_normal((ROWS, WIDTH)), dtype=torch.float32,
                       device=device)
    offs = torch.tensor(rng.integers(0, WIDTH - LANES, niter), dtype=torch.int32,
                        device=device)
    return buf, offs


def full_threads(device) -> int:
    """Threads that fill every SM of ``device``."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def sm_clock_hz() -> float:
    """The SM clock's maximum, ``nvidia-smi --query-gpu=clocks.max.sm``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True).stdout.split()[0]
    return float(out) * 1e6


def event_ms(fn, count: int, reps: int = 5) -> float:
    """Median milliseconds of one call of ``fn``: CUDA events around
    ``count`` back-to-back calls (so the host's part of a call overlaps the
    card's), median over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def fma_bound_ms(n: int, rep: int, nsm: int, clock_hz: float) -> float:
    """The least time for n threads of rep * STEPS steps: one step per f32
    lane per clock on every SM."""
    return n * rep * STEPS / (nsm * F32_LANES * clock_hz) * 1e3


def gather_bound_terms(niter: int, groups: int, nsm: int,
                       clock_hz: float) -> dict:
    """The gather probe's least times in ms: ``dram``, the buffer, offsets
    and output moved once over the memory rate; ``load_path``, every window
    load's bytes through the SMs' load paths (``SM_LOAD_BYTES`` per SM per
    clock at ``clock_hz``); ``operations``, 2 FMA (4 flops) per element of
    every window load over the f32 peak."""
    nbytes = ROWS * WIDTH * 4 + niter * 4 + groups * ROWS * LANES * 4
    loaded = groups * niter * ROWS * LANES * 4
    flops = groups * niter * ROWS * LANES * 4
    return dict(dram=nbytes / PEAK_BYTES * 1e3,
                load_path=loaded / (nsm * SM_LOAD_BYTES * clock_hz) * 1e3,
                operations=flops / PEAK_F32 * 1e3)


def gather_bound(niter: int, groups: int, nsm: int, clock_hz: float):
    """(bound_ms, bound_by) of the gather probe: the largest of
    :func:`gather_bound_terms`, bound by "bytes" (device memory or the load
    path) or "operations"."""
    t = gather_bound_terms(niter, groups, nsm, clock_hz)
    by = max(t, key=t.get)
    return t[by], "operations" if by == "operations" else "bytes"


def fma_table(device, rep: int = REP):
    """The FMA probe for every operation and chain count at ``rep``
    iterations on threads filling every SM: rows of (op, chains, ms, steps
    per SM per clock, share of the SM's 128 f32 lanes)."""
    x = fma_input(full_threads(device), device)
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    clock = sm_clock_hz()
    rows = []
    for op in OPS:
        for chains in CHAINS:
            ms = event_ms(lambda: fma(x, op, chains, rep), count=2)
            rate = x.shape[0] * rep * STEPS / (ms * 1e-3 * clock * nsm)
            rows.append(dict(op=op, chains=chains, ms=ms, per_sm_clock=rate,
                             share=rate / F32_LANES))
    return rows


def gather_table(device, niter: int = NITER, groups: int = GROUPS):
    """The gather probe aligned and not, from global and from shared
    memory, and the staging alone (niter 0): rows of (aligned, staged,
    niter, ms, ns per window load over all groups, ns per window load of
    one block: ms over niter, one step of a chain).  Each time is the
    kernel's through its C launcher on prepared inputs and output (the
    wrapper's checks and allocation take longer than the kernel)."""
    buf, offs = gather_inputs(niter, device)
    out = torch.empty((groups, ROWS, LANES), dtype=torch.float32, device=device)

    def launch(offs, aligned, staged):
        p = _gather_params(buf, offs, aligned, staged, groups)
        return _launcher("probe_gather", device, ctypes.byref(p),
                         buf.data_ptr(), offs.data_ptr(), out.data_ptr())

    rows = []
    for staged in (False, True):
        for aligned in (True, False):
            ms = event_ms(launch(offs, aligned, staged), count=20)
            rows.append(dict(aligned=aligned, staged=staged, niter=niter,
                             ms=ms, ns_per_load=ms * 1e6 / (groups * niter),
                             ns_per_block_load=ms * 1e6 / niter))
    ms = event_ms(launch(offs[:0], False, True), count=20)
    rows.append(dict(aligned=False, staged=True, niter=0, ms=ms,
                     ns_per_load=None, ns_per_block_load=None))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rep", type=int, default=REP)
    ap.add_argument("--niter", type=int, default=NITER)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the probes measure the card")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"{smi}; {nsm} SMs, SM clock max {sm_clock_hz() / 1e6:.0f} MHz, "
          f"{full_threads(device)} threads, {args.rep} x {STEPS} steps each")
    for r in fma_table(device, args.rep):
        print(f"fma op={r['op']:6s} chains={r['chains']}  {r['ms']:9.4f} ms  "
              f"{r['per_sm_clock']:7.2f} steps/SM/clock  "
              f"{r['share'] * 100:6.2f}% of {F32_LANES} lanes")
    bound = gather_bound_terms(args.niter, GROUPS, nsm, sm_clock_hz())
    print("gather bound: " + ", ".join(f"{k} {v * 1e3:.2f} us"
                                        for k, v in bound.items()))
    for r in gather_table(device, args.niter):
        where = "shared" if r["staged"] else "global"
        if r["niter"] == 0:
            print(f"gather staging alone ({where}): {r['ms'] * 1e3:.2f} us")
            continue
        print(f"gather aligned={int(r['aligned'])} {where}: {r['ms'] * 1e3:.2f} "
              f"us, {r['ns_per_load']:.3f} ns per window load over "
              f"{GROUPS} windows, {r['ns_per_block_load']:.1f} ns per load "
              f"of one block")


if __name__ == "__main__":
    main()
