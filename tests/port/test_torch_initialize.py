"""The port's ``<special><initialize>`` operations
(``features/initialize.py``) against the JAX package's.

Every operation type is written as its XML element and parsed by both
packages' ``parse_initialize_xml`` (equal operations), then applied by both
``apply_initialize`` to one seeded 3D scene drawn with ``cases.Draw``
(a tank of fixed walls, two fluid blocks, a sphere and a cylinder), with a
seeded velocity and seeded normals on some walls: ``vel`` and
``boundnormal`` are compared array by array at rtol 1e-6 (both evaluate
the same float64 numpy expressions on the same float32 inputs).  The CLI
forms of ``parse_initnor_cli`` are compared the same way.  The loads of an
inline ``<initialize>`` case through both loaders are compared in
test_torch_xmlcase.py (``initialize``); ``-initnorpla``/``-initnorpart``
through both CLIs in test_torch_cli.py.  Nothing here compiles JAX.
"""

import dataclasses
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.features import initialize as jI
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch.features import initialize as I
from dualsphysics_multilayer_tpu_torch.tools import common

DP = 0.05

# name: the operation's element under <initialize>
OPS = {
    "fluid-uniform": """<fluidvelocity mkfluid="0">
        <direction x="1" y="0" z="0.5"/><velocity v="0.7"/></fluidvelocity>""",
    "fluid-linear": """<fluidvelocity mkfluid="1">
        <direction x="0" y="1" z="1"/>
        <velocity2 v="0.1" v2="0.5" z="0.02" z2="0.12"/></fluidvelocity>""",
    "fluid-parabolic": """<fluidvelocity mkfluid="0">
        <velocity3 v="0" v2="1" v3="0.4" z="0" z2="0.06" z3="0.14"/>
        <onlypos><posmin x="0.1" y="-1" z="-1"/></onlypos></fluidvelocity>""",
    "set": """<boundnormal_set mkbound="2"><normal x="0" y="0.6" z="0.8"/>
        </boundnormal_set>""",
    "plane": """<boundnormal_plane mkbound="0">
        <point x="0" y="0" z="0.01"/><normal x="0" y="0" z="1"/>
        <maxdisth v="2"/><onlypos><posmax x="10" y="10" z="0.001"/></onlypos>
        </boundnormal_plane>""",
    "plane-auto": """<boundnormal_plane mkbound="0">
        <point auto="true"/><normal x="-1" y="0" z="0"/>
        <limitdist vdp="0.5"/><maxdisth v="3"/></boundnormal_plane>""",
    "sphere-outside": """<boundnormal_sphere mkbound="2">
        <center x="0.45" y="0.15" z="0.15"/><radius v="0.09"/>
        <inside v="false"/></boundnormal_sphere>""",
    "sphere-inside": """<boundnormal_sphere mkbound="0">
        <center x="0.3" y="0.15" z="0.3"/><radius v="0.35"/>
        <maxdisth v="4"/></boundnormal_sphere>""",
    "cylinder": """<boundnormal_cylinder mkbound="3">
        <center1 x="0.15" y="0.22" z="0"/><center2 x="0.15" y="0.22" z="0.2"/>
        <radius v="0.06"/><inside v="false"/></boundnormal_cylinder>""",
    "cylinder-caps": """<boundnormal_cylinder mkbound="0">
        <center1 x="0.3" y="0.15" z="0"/><center2 x="0.3" y="0.15" z="0.3"/>
        <radius v="0.4"/><limit2 v="false"/></boundnormal_cylinder>""",
    "parts": """<boundnormal_parts mkbound="0"><maxdisth v="2"/>
        </boundnormal_parts>""",
    "inactive": """<boundnormal_set mkbound="0" active="false"/>""",
}


@pytest.fixture(scope="module")
def scene():
    """(JAX state, port state, JAX csp, port csp) of the scene: fixed
    walls (mk 0) around fluid of mk 0 and 1, a solid sphere (mk 2) and a
    cylinder (mk 3); a seeded velocity and normals on the sphere."""
    csp_kw = dict(simulate2d=False, dp=DP, hswl=0.15)
    jcsp = jtd.make_ctesph(**csp_kw)
    d = jcases.Draw(dp=DP, simulate2d=False)
    d.box((0, 0, 0), (0.6, 0.3, 0.3), ptype=jtd.TYPE_FIXED, mk=0,
          faces="bottom|left|right|front|back")
    d.box((0.05, 0.05, 0.05), (0.25, 0.25, 0.15), ptype=jtd.TYPE_FLUID, mk=0)
    d.box((0.3, 0.05, 0.05), (0.35, 0.25, 0.1), ptype=jtd.TYPE_FLUID, mk=1)
    d.sphere((0.45, 0.15, 0.15), 0.08, ptype=jtd.TYPE_FIXED, mk=2)
    d.cylinder((0.15, 0.22, 0.0), (0.15, 0.22, 0.2), 0.04,
               ptype=jtd.TYPE_FIXED, mk=3)
    pos, code = d.build()
    jst = jcases._make_state(jcsp, pos, code, zsurf=0.15)
    rng = np.random.default_rng(3)
    n = len(pos)
    normals = np.where((jtd.code_value(code) == 2)[:, None],
                       rng.normal(0.0, 0.02, (n, 3)), 0.0).astype(np.float32)
    jst = dataclasses.replace(
        jst, vel=jnp.asarray(rng.normal(0.0, 0.3, (n, 3)), jnp.float32),
        boundnormal=jnp.asarray(normals))
    arrays = {k: np.asarray(getattr(jst, k))
              for k in ("pos", "vel", "rho", "code", "idp", "boundnormal")}
    st = convert.simstate(arrays, device="cpu")
    return jst, st, jcsp, convert.ctesph(dataclasses.asdict(jcsp))


def same_ops(jops, ops):
    assert [type(o).__name__ for o in ops] == [type(o).__name__ for o in jops]
    for a, b in zip(jops, ops):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)


def apply_both(scene, jops, ops, with_normals=True):
    jst, st, jcsp, csp = scene
    if not with_normals:
        jst = dataclasses.replace(jst, boundnormal=None)
        st = dataclasses.replace(st, boundnormal=None)
    jout, out = jI.apply_initialize(jops, jcsp, jst), \
        I.apply_initialize(ops, csp, st)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel),
                               rtol=1e-6, atol=0)
    assert (out.boundnormal is None) == (jout.boundnormal is None)
    if jout.boundnormal is not None:
        np.testing.assert_allclose(out.boundnormal.numpy(),
                                   np.asarray(jout.boundnormal), rtol=1e-6,
                                   atol=0)
        assert out.boundnormal.dtype == out.vel.dtype == st.pos.dtype
    return jout, out


@pytest.mark.parametrize("name", list(OPS))
def test_operation_matches_jax(scene, name):
    node = ET.fromstring(f"<initialize>{OPS[name]}</initialize>")
    jops, ops = jI.parse_initialize_xml(node), I.parse_initialize_xml(node)
    same_ops(jops, ops)
    assert len(ops) == (0 if name == "inactive" else 1)
    jout, out = apply_both(scene, jops, ops)
    st = scene[1]
    changed = ((out.vel != st.vel).any(dim=1)
               | (out.boundnormal != st.boundnormal).any(dim=1))
    assert bool(changed.any()) == (name != "inactive")
    # without normals on the state, a normal operation brings them
    _, bare = apply_both(scene, jops, ops, with_normals=False)
    assert (bare.boundnormal is not None) == name.startswith(
        ("set", "plane", "sphere", "cylinder", "parts"))


def test_operations_apply_in_order(scene):
    node = ET.fromstring("<initialize>" + "".join(OPS.values())
                         + "</initialize>")
    jops, ops = jI.parse_initialize_xml(node), I.parse_initialize_xml(node)
    same_ops(jops, ops)
    apply_both(scene, jops, ops, with_normals=False)


@pytest.mark.parametrize("kind,spec", [
    ("plane", "mkbound=0:normal=0:0:1"),
    ("plane", "mkbound=0,2-3:normal=1:0:0:point=0.1:0:0:maxdisth=3"),
    ("plane", "mkbound=0:normal=0:-1:0:point=auto:limitdist=1"),
    ("parts", "mkbound=0-1:maxdisth=2.5"),
    ("parts", "mkbound=3"),
])
def test_cli_forms_match_jax(scene, kind, spec):
    jops = jI.parse_initnor_cli(spec, kind=kind)
    ops = I.parse_initnor_cli(spec, kind=kind)
    same_ops(jops, ops)
    apply_both(scene, jops, ops, with_normals=False)


def test_host_helpers_match_jax(scene):
    from dualsphysics_multilayer_tpu.tools import common as jcommon
    pos = scene[1].pos.numpy()
    for radius in (0.05, 0.11):
        want = np.stack(jcommon.pair_indices(pos[::3], pos, radius))
        got = np.stack(common.pair_indices(pos[::3], pos, radius))
        np.testing.assert_array_equal(got, want)
    rr2 = np.linspace(0.0, 0.03, 50)
    for sim2d in (False, True):
        np.testing.assert_array_equal(common.wendland_wab(sim2d, 0.08, rr2),
                                      jcommon.wendland_wab(sim2d, 0.08, rr2))
