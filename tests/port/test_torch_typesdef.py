"""Port vocabulary against the JAX package: typecode accessors, constants,
smoothing kernels and the equation of state."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.ops import eos as jeos
from dualsphysics_multilayer_tpu.ops import kernels as jK
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.ops import eos
from dualsphysics_multilayer_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

ACCESSORS = ["code_type", "code_value", "code_special", "code_inout",
             "is_fluid", "is_floating", "is_bound", "is_fixed", "is_moving",
             "is_normal", "is_periodic", "is_out", "is_active", "is_inout"]


def all_codes():
    """Every type x special value, with mk values and inout tags."""
    codes = []
    for ptype in range(4):
        for special in range(6):
            for value in (0, 1, 0x7FFF, 0xFFFF):
                for tag in (0, 1, jtd.MAX_INOUT_ZONES):
                    c = jtd.code_make(ptype, value, special)
                    codes.append(jtd.code_set_inout(c, tag))
    return np.array(codes, np.uint32)


@pytest.mark.parametrize("name", ACCESSORS)
def test_typecode_accessors_match(name):
    codes = all_codes()
    assert int(codes.max()) < 1 << td.CODE_BITS
    want = np.asarray(getattr(jtd, name)(jnp.asarray(codes)))
    got = getattr(td, name)(torch.tensor(codes.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("special", range(6))
def test_typecode_set_fields_match(special):
    codes = all_codes()
    want = np.asarray(jtd.code_set_special(jnp.asarray(codes), special))
    got = td.code_set_special(torch.tensor(codes.astype(np.int32)), special)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    want = np.asarray(jtd.code_set_inout(jnp.asarray(codes), special + 3))
    got = td.code_set_inout(torch.tensor(codes.astype(np.int32)), special + 3)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert td.code_make(3, 7, special) == jtd.code_make(3, 7, special)


@pytest.mark.parametrize("kw", [
    dict(simulate2d=False, dp=0.02, hswl=0.3, visco=0.1),
    dict(simulate2d=True, dp=0.01, hswl=2.0, visco=0.02, ddtvalue=0.2),
    dict(simulate2d=False, dp=0.05, speedsound=40.0, hdp=1.5,
         viscoboundfactor=0.3, cflnumber=0.1, dtfixed=1e-4),
])
def test_make_ctesph_matches(kw):
    want = jtd.make_ctesph(**kw)
    got = td.make_ctesph(**kw)
    assert convert.ctesph(dataclasses.asdict(want)) == got
    assert got.dim == want.dim


def test_make_ctesph_rejects_no_speed():
    with pytest.raises(ValueError):
        td.make_ctesph(simulate2d=False, dp=0.02)


@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("tkernel", ["WENDLAND", "CUBIC"])
def test_kernels_match(sim2d, tkernel):
    kw = dict(simulate2d=sim2d, dp=0.05, hswl=0.25)
    jcsp = jtd.make_ctesph(tkernel=jtd.TpKernel[tkernel], **kw)
    csp = td.make_ctesph(tkernel=td.TpKernel[tkernel], **kw)
    rr2 = np.linspace(1e-6, csp.kernelsize2, 97).astype(np.float32)
    for jf, f in ((jK.kernel_wab, K.kernel_wab), (jK.kernel_fac, K.kernel_fac)):
        want = np.asarray(jf(jcsp, jnp.asarray(rr2)))
        got = f(csp, torch.tensor(rr2)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    # the kernel's support ends at q = 2: W and dW/dr vanish there
    edge = torch.tensor([csp.kernelsize2], dtype=torch.float64)
    if tkernel == "WENDLAND":
        assert abs(float(K.wendland_wab(csp, edge))) < 1e-12
    assert abs(float(K.kernel_fac(csp, edge))) < 1e-9


def test_eos_matches():
    csp = td.make_ctesph(simulate2d=False, dp=0.02, hswl=0.3)
    jcsp = jtd.make_ctesph(simulate2d=False, dp=0.02, hswl=0.3)
    rho = np.random.default_rng(0).uniform(950, 1060, 200).astype(np.float32)
    want = np.asarray(jeos.press_from_rho(jcsp, jnp.asarray(rho)))
    got = eos.press_from_rho(csp, torch.tensor(rho)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    z = np.linspace(-0.1, 0.4, 51).astype(np.float32)
    want = np.asarray(jeos.hydrostatic_rho(jcsp, jnp.asarray(z), 0.3))
    got = eos.hydrostatic_rho(csp, torch.tensor(z), 0.3).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # the inverse EOS undoes the EOS
    back = eos.rho_from_press(csp, eos.press_from_rho(csp, torch.tensor(rho)))
    np.testing.assert_allclose(back.numpy(), rho, rtol=1e-5)
