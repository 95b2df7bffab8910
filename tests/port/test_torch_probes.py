"""The two hardware probes (tools/probes.py): their plain torch versions
against the JAX package's TPU probe bodies, and the CPU twins of their
CUDA kernels (g++) against the plain versions.  The kernels themselves are
tested on the card by test_torch_cuda.py.

* FMA probe: ``vputime.make_kernel(chains, op, rep, ops)`` called on plain
  arrays, outside ``pallas_call``, at rep 3 and 8 steps an iteration, for
  fma, mix and rsqrt.  Its reciprocal, ``pl.reciprocal(approx=True)``,
  runs outside a kernel too, but as a coarse approximation (0.7% off after
  24 steps), so the recip recurrence is held against a numpy rendering of
  the probe's recurrence written here (:func:`numpy_recip`), with the exact
  f32 reciprocal the plain version takes.
* Gather probe: ``probe_unaligned.kern`` slices with ``pl.ds``, which does
  not run outside a kernel, so it runs inside ``pallas_call`` in interpret
  mode, as the JAX package's own tests run its Pallas kernels on the CPU,
  at 16 window loads (the module's NITER, 512, set to 16 for the test).

Tolerance: rtol 1e-5 with a floor of 1e-5 of the largest value, a few ulp
of the rep * steps (or niter) operations each element goes through, which
XLA may contract or order otherwise; the twins against the plain version
the same (the same f32 operations in the same order, exact rsqrt and
reciprocal on the CPU).
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import probe_unaligned
import vputime
from dualsphysics_multilayer_tpu_torch.tools import probes as PR

torch.set_num_threads(2)

RTOL = 1e-5


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")


def numpy_recip(x, chains, rep, steps):
    """vputime.py's "recip" recurrence in numpy f32 with the exact
    reciprocal: chains from x + c, a = 1 / (|a| + x + f) on chain j % chains
    at step j, f = i * 1e-9 in iteration i; the chains' sum."""
    accs = [x + np.float32(c) for c in range(chains)]
    for i in range(rep):
        f = np.float32(i) * np.float32(1e-9)
        for j in range(steps):
            c = j % chains
            accs[c] = np.float32(1) / (np.abs(accs[c]) + x + f)
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


@pytest.mark.parametrize("chains", PR.CHAINS)
@pytest.mark.parametrize("op", PR.OPS)
def test_fma_plain_matches_jax_probe(op, chains):
    rep, steps = 3, 8
    x = np.full((vputime.SUB, vputime.LANE), 1e-6, np.float32)
    if op == "recip":
        want = numpy_recip(x, chains, rep, steps)
    else:
        want = np.zeros_like(x)
        vputime.make_kernel(chains, op, rep=rep, ops=steps)(x, want)
    got = PR.fma_plain(torch.tensor(x), op, chains, rep, steps)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("op", PR.OPS)
def test_fma_twin_matches_plain(gxx, op):
    """The kernel's body (64 steps an iteration) for every chain count, on
    inputs around vputime.py's 1e-6."""
    x = torch.tensor(np.random.default_rng(1).uniform(0.5e-6, 2e-6, 96),
                     dtype=torch.float32)
    launched = dict(PR.launches)
    for chains in PR.CHAINS:
        want = PR.fma(x, op, chains, 2)         # the CPU path: plain
        assert_close(PR.fma_twin(x, op, chains, 2).numpy(), want.numpy())
        assert_close(want.numpy(), PR.fma_plain(x, op, chains, 2).numpy(),
                     rtol=0)
    assert PR.launches == launched            # no kernel launched on the CPU


@pytest.mark.parametrize("aligned", [True, False])
def test_gather_plain_matches_jax_probe(monkeypatch, aligned):
    niter = 16
    monkeypatch.setattr(probe_unaligned, "NITER", niter)
    buf, offs = PR.gather_inputs(niter, "cpu", seed=2)
    f = pl.pallas_call(
        functools.partial(probe_unaligned.kern, aligned=aligned),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec((PR.ROWS, PR.WIDTH), lambda a, *_: (0, 0))],
            out_specs=pl.BlockSpec((PR.ROWS, PR.LANES), lambda a, *_: (0, 0))),
        out_shape=jax.ShapeDtypeStruct((PR.ROWS, PR.LANES), jnp.float32),
        interpret=True)
    want = f(jnp.asarray(offs.numpy()), jnp.asarray(buf.numpy()))
    assert_close(PR.gather_plain(buf, offs, aligned).numpy(), want)
    if not aligned:
        assert (offs.numpy() % PR.LANES != 0).any()


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_twin_matches_plain(gxx, aligned, staged):
    buf, offs = PR.gather_inputs(24, "cpu", seed=3)
    got = PR.gather_twin(buf, offs, aligned, staged, groups=3)
    want = PR.gather(buf, offs, aligned, staged, groups=3)
    assert got.shape == want.shape == (3, PR.ROWS, PR.LANES)
    for g in range(3):
        assert_close(got[g].numpy(), want[g].numpy())


def test_probe_wrappers_reject_bad_inputs(gxx):
    x = torch.ones(8)
    buf, offs = PR.gather_inputs(4, "cpu")
    for bad in (dict(op="div"), dict(chains=3), dict(rep=-1)):
        kw = {**dict(op="fma", chains=1, rep=1), **bad}
        with pytest.raises(ValueError, match="probe_fma"):
            PR.fma(x, **kw)
    with pytest.raises(ValueError, match="float32"):
        PR.fma_twin(x.double(), "fma", 1, 1)
    with pytest.raises(ValueError, match="cuda"):
        PR._fma(x, "fma", 1, 1, twin=False)
    # offsets outside the buffer are clamped to its last window
    far = torch.tensor([-5, PR.WIDTH, 7], dtype=torch.int32)
    near = torch.tensor([0, PR.WIDTH - PR.LANES, 7], dtype=torch.int32)
    for aligned in (True, False):
        want = PR.gather_plain(buf, near, aligned)
        assert torch.equal(PR.gather_plain(buf, far, aligned), want)
        assert torch.equal(PR.gather_twin(buf, far, aligned, groups=1)[0], want)
    with pytest.raises(ValueError, match="float32"):
        PR.gather_twin(buf.double(), offs, True)
    with pytest.raises(ValueError, match="int32"):
        PR.gather_twin(buf, offs.long(), True)
