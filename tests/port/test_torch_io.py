"""The port's run output against the JAX package's writers and readers,
with no JAX stepping.

* ``io/jbinary``: the port's writer (its C++ one, the default) is
  byte-equal to JAX's ``write_file(native=False)`` on a tree holding every
  value and array type, and each package reads the other's file; the C++
  writer equals the pure one on that tree and deeper ones, and a failed
  build of it raises, with no fallback.
* ``io/partdata``: the port's ``PartWriter`` on a state in a shuffled slot
  order (the port's slots move at every rebuild), read with JAX's
  ``read_file``, gives the items JAX's ``PartWriter`` writes for the same
  particles in id order, every value and array bit for bit, apart from the
  two text values that name the program (``RunCode``, ``AppName``).
* ``io/floatdata`` (PartFloat.fbi4, PartOut.obi4, Part_Head.ibi4) and
  ``io/extradata``: the same, plus round trips through the port's readers.
* ``io/vtkout``: equal arrays give equal bytes.
* ``OutputTime.interval``, ``TerminateCheck.poll`` and
  ``parse_range_filter`` agree with JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import typesdef as jtd
from dualsphysics_multilayer_tpu.io import extradata as jX
from dualsphysics_multilayer_tpu.io import floatdata as jFD
from dualsphysics_multilayer_tpu.io import jbinary as jJB
from dualsphysics_multilayer_tpu.io import output as jOUT
from dualsphysics_multilayer_tpu.io import partdata as jPD
from dualsphysics_multilayer_tpu.io import vtkout as jV
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu.tools import common as jcommon
from dualsphysics_multilayer_tpu.utils import runinfo as jRI
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.io import extradata as X
from dualsphysics_multilayer_tpu_torch.io import floatdata as FD
from dualsphysics_multilayer_tpu_torch.io import jbinary as JB
from dualsphysics_multilayer_tpu_torch.io import output as OUT
from dualsphysics_multilayer_tpu_torch.io import partdata as PD
from dualsphysics_multilayer_tpu_torch.io import vtkout as V
from dualsphysics_multilayer_tpu_torch.tools import common
from dualsphysics_multilayer_tpu_torch.utils import runinfo as RI

# the text values that name the program, the only ones allowed to differ
PROGRAM_TEXT = {"RunCode", "AppName"}


def every_type_tree(jb):
    """A tree with every value type and every array type of the format."""
    root = jb.JItem(name="AllTypes")
    root.set_text("T", "text value").set_bool("B", True)
    root.set("C", jb.CHAR, -7).set("UC", jb.UCHAR, 200)
    root.set("S", jb.SHORT, -30000).set("US", jb.USHORT, 60000)
    root.set_int("I", -123456).set_uint("U", 4000000000)
    root.set("LL", jb.LLONG, -(1 << 40)).set_ullong("ULL", 1 << 60)
    root.set_float("F", 1.25).set_double("D", -2.5e-300)
    root.set("I3", jb.INT3, (-1, 2, -3)).set_uint3("U3", (1, 2, 3))
    root.set("F3", jb.FLOAT3, (0.5, -0.25, 8.0))
    root.set_double3("D3", (1e-9, 2e9, -3.0))
    rng = np.random.default_rng(3)
    for name, typ, dtype in (("aC", jb.CHAR, np.int8), ("aUC", jb.UCHAR, np.uint8),
                             ("aS", jb.SHORT, np.int16),
                             ("aUS", jb.USHORT, np.uint16),
                             ("aI", jb.INT, np.int32), ("aU", jb.UINT, np.uint32),
                             ("aLL", jb.LLONG, np.int64),
                             ("aULL", jb.ULLONG, np.uint64)):
        info = np.iinfo(dtype)
        root.add_array(name, typ, rng.integers(info.min, info.max, 9,
                                               dtype=dtype, endpoint=True))
    root.add_array("aF", jb.FLOAT, rng.normal(size=7).astype(np.float32))
    root.add_array("aD", jb.DOUBLE, rng.normal(size=5))
    root.add_array("aI3", jb.INT3, rng.integers(-9, 9, (4, 3), dtype=np.int32))
    root.add_array("aU3", jb.UINT3, rng.integers(0, 9, (4, 3), dtype=np.uint32))
    root.add_array("aF3", jb.FLOAT3, rng.normal(size=(6, 3)).astype(np.float32))
    root.add_array("aD3", jb.DOUBLE3, rng.normal(size=(3, 3)))
    sub = root.child("PART_0001")
    sub.set_uint("Cpart", 1)
    sub.add_array("Posd", jb.DOUBLE3, np.arange(9.0).reshape(3, 3))
    sub.child("Nested").set_text("Empty", "")
    return root


def test_jbinary_bytes_equal_and_cross_read(tmp_path):
    port, jax_ = tmp_path / "port.bi4", tmp_path / "jax.bi4"
    JB.write_file(port, every_type_tree(JB), filecode="AllTypes")
    jJB.write_file(jax_, every_type_tree(jJB), filecode="AllTypes",
                   native=False)
    assert port.read_bytes() == jax_.read_bytes()
    assert_items_equal(JB.read_file(jax_), jJB.read_file(port), set())


def test_native_writer_bytes_equal_pure(tmp_path):
    """The port's C++ writer (the default) writes the pure writer's bytes
    on every value and array type, an item's own float formats, and
    children at several depths, in order."""
    root = every_type_tree(JB)
    extra = root.child("Second")
    extra.fmtfloat, extra.fmtdouble = "%g", "%.17g"
    extra.set_float("F", -0.1)
    extra.child("Deep").child("Deeper").add_array(
        "x", JB.FLOAT, np.arange(3, dtype=np.float32))
    native, pure = tmp_path / "native.bi4", tmp_path / "pure.bi4"
    JB.write_file(native, root, filecode="AllTypes", native=True)
    JB.write_file(pure, root, filecode="AllTypes", native=False)
    assert native.read_bytes() == pure.read_bytes()
    back = JB.read_file(native)
    assert back.find("Second").find("Deep").find("Deeper").array(
        "x").data.tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(OSError, match="cannot create"):
        JB.write_file(tmp_path / "no" / "such.bi4", root, native=True)


def test_native_write_raises_when_build_fails(monkeypatch, tmp_path):
    """A failed build of the C++ writer raises from ``write_file``; it
    does not fall back to the pure writer."""
    from dualsphysics_multilayer_tpu_torch import native
    from dualsphysics_multilayer_tpu_torch.ops.cuda import build

    def fail(name, sources):
        raise RuntimeError(f"kernel build failed ({name})")

    monkeypatch.setattr(build, "host_library", fail)
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="jbinary_native"):
            JB.write_file(tmp_path / "x.bi4", every_type_tree(JB))
        assert not (tmp_path / "x.bi4").exists()
        JB.write_file(tmp_path / "x.bi4", every_type_tree(JB), native=False)
    finally:
        native.library.cache_clear()


def assert_items_equal(a, b, skip):
    """Two read trees hold the same items, values (types, and values bit
    for bit) and arrays, apart from the values named in ``skip``."""
    assert a.name == b.name
    assert (a.fmtfloat, a.fmtdouble) == (b.fmtfloat, b.fmtdouble)
    ka = [k for k in a.values if k not in skip]
    kb = [k for k in b.values if k not in skip]
    assert ka == kb, a.name
    for k in ka:
        (ta, va), (tb, vb) = a.values[k], b.values[k]
        assert ta == tb, k
        assert np.asarray(va).tobytes() == np.asarray(vb).tobytes(), \
            (a.name, k, va, vb)
    assert [x.name for x in a.arrays] == [x.name for x in b.arrays], a.name
    for xa, xb in zip(a.arrays, b.arrays):
        assert xa.type == xb.type, xa.name
        assert xa.data.dtype == xb.data.dtype, xa.name
        assert xa.data.tobytes() == xb.data.tobytes(), (a.name, xa.name)
    assert len(a.items) == len(b.items), a.name
    for ia, ib in zip(a.items, b.items):
        assert_items_equal(ia, ib, skip)


@pytest.fixture(scope="module")
def states():
    """A JAX dam-break state with a seeded velocity and density, two fluid
    particles excluded (one by position, one by density), mDBC normals on
    the walls; and the port's copy of it in a shuffled slot order."""
    case = jcases.dambreak2d(dp=0.1, mdbc=True)
    st = case.state
    n = st.n
    rng = np.random.default_rng(11)
    code = np.asarray(st.code).copy()
    fluid = np.flatnonzero(jtd.code_type(code) == jtd.TYPE_FLUID)
    code[fluid[3]] = jtd.code_make(jtd.TYPE_FLUID, 0, jtd.SPECIAL_OUT_POS)
    code[fluid[8]] = jtd.code_make(jtd.TYPE_FLUID, 0, jtd.SPECIAL_OUT_RHOP)
    arrays = dict(
        pos=np.asarray(st.pos) + rng.normal(0, 1e-3, (n, 3)).astype(np.float32),
        vel=rng.normal(0, 0.5, (n, 3)).astype(np.float32),
        rho=(1000 + rng.normal(0, 5, n)).astype(np.float32),
        code=code, idp=np.asarray(st.idp),
        boundnormal=np.asarray(st.boundnormal))
    import jax.numpy as jnp
    jst = dataclasses.replace(
        st, pos=jnp.asarray(arrays["pos"]), vel=jnp.asarray(arrays["vel"]),
        rho=jnp.asarray(arrays["rho"]), code=jnp.asarray(code))
    pst = convert.simstate(arrays, device="cpu")
    perm = torch.tensor(rng.permutation(n))
    return case, jst, pst.permuted(perm)


def test_partwriter_items_match_jax(states, tmp_path):
    case, jst, pst = states
    csp = convert.ctesph(dataclasses.asdict(case.csp))
    kw = dict(casename="dambreak2d", np_total=case.np_total, nfixed=case.npb,
              nfluid=case.np_total - case.npb, posmin=case.dom.posmin,
              posmax=case.dom.posmax, nortimes=True)
    for posdouble in (True, False):
        d = tmp_path / f"pd{int(posdouble)}"
        pp = PD.PartWriter(str(d / "port"), csp, posdouble=posdouble,
                           **kw).save(7, 0.0125, pst, nstep=42)
        jp = jPD.PartWriter(str(d / "jax"), case.csp, posdouble=posdouble,
                            **kw).save(7, 0.0125, jst, nstep=42)
        assert os.path.basename(pp) == os.path.basename(jp) == "Part_0007.bi4"
        proot, jroot = jJB.read_file(pp), jJB.read_file(jp)
        assert_items_equal(proot, jroot, PROGRAM_TEXT)
        assert proot.get("RunCode") == "cpu" and jroot.get("RunCode") == "tpu"
        assert proot.get("AppName") == "dualsphysics_multilayer_tpu_torch"
        part = proot.items[0]
        assert (part.get("Npok"), part.get("Nout")) == (case.np_total - 2, 2)
    # the readers agree on the port's file
    mine, theirs = PD.read_part(pp), jPD.read_part(pp)
    assert mine.keys() == theirs.keys()
    for k, v in mine.items():
        if isinstance(v, np.ndarray):
            assert v.tobytes() == theirs[k].tobytes(), k
        else:
            assert v == theirs[k], k


def test_float_channels_match_jax_and_read_back(tmp_path):
    rng = np.random.default_rng(5)
    b = 2
    head = dict(mkbound=np.arange(b, dtype=np.uint16),
                begin=np.array([10, 40], np.uint32),
                count=np.array([30, 20], np.uint32),
                mass=np.array([5.0, 2.5], np.float32),
                massp=np.array([0.1, 0.05], np.float32))
    parts = [dict(center=rng.normal(size=(b, 3)), fvel=rng.normal(size=(b, 3)),
                  fomega=rng.normal(size=(b, 3)), step=3 * k)
             for k in range(3)]
    outs = [(k, dict(idp=np.arange(2 * k) + 5 * k,
                     pos=rng.normal(size=(2 * k, 3)),
                     vel=rng.normal(size=(2 * k, 3)),
                     rhop=rng.normal(1000, 1, 2 * k),
                     motive=np.full(2 * k, k, np.uint8))) for k in (1, 2)]
    out = {}
    for name, mod in (("port", FD), ("jax", jFD)):
        d = tmp_path / name
        d.mkdir()
        w = mod.FloatBi4Writer(str(d), **head)
        for k, p in enumerate(parts):
            w.save_part(k, 0.01 * k, flush=k == 2, **p)
        ow = mod.PartOutWriter(str(d))
        for k, batch in outs:
            ow.save_part(k, 0.01 * k, **batch)
        ow.save_part(3, 0.03, idp=np.zeros(0), pos=np.zeros((0, 3)),
                     vel=np.zeros((0, 3)), rhop=np.zeros(0),
                     motive=np.zeros(0))
        mod.write_parthead(str(d), convert.ctesph(dataclasses.asdict(
            jcases.dambreak2d(dp=0.2).csp)) if name == "port"
            else jcases.dambreak2d(dp=0.2).csp, casename="c", appname="app",
            mkblocks=[dict(type="Bound", mk=11, mktype=0, count=40),
                      dict(type="Fluid", mk=1, mktype=0, count=60)],
            mapposmin=(-1, 0, -1), mapposmax=(4, 0, 3), firstpart=2)
        out[name] = d
    for f in ("PartFloat.fbi4", "PartOut_000.obi4", "Part_Head.ibi4"):
        assert (out["port"] / f).read_bytes() == (out["jax"] / f).read_bytes(), f
    fhead, fparts = FD.read_floatbi4(str(out["port"] / "PartFloat.fbi4"))
    assert fhead["ftcount"] == b
    assert [p["step"] for p in fparts] == [0, 3, 6]
    np.testing.assert_array_equal(fparts[2]["center"], parts[2]["center"])
    np.testing.assert_array_equal(fparts[1]["fvel"],
                                  parts[1]["fvel"].astype(np.float32))
    pout = FD.read_partout(str(out["port"] / "PartOut_000.obi4"))
    assert [p["cpart"] for p in pout] == [1, 2]
    np.testing.assert_array_equal(pout[1]["idp"], np.arange(4) + 10)
    ph = FD.read_parthead(str(out["port"] / "Part_Head.ibi4"))
    assert ph == jFD.read_parthead(str(out["jax"] / "Part_Head.ibi4"))
    assert [m["count"] for m in ph["mkblocks"]] == [40, 60]


def test_extradata_matches_jax_and_restores_normals(states, tmp_path):
    case, jst, pst = states
    nbound = case.npb
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    pp = X.save_extradata(str(tmp_path / "p"), 3, 0.5, pst, casenbound=nbound,
                          nstep=9)
    jp = jX.save_extradata(str(tmp_path / "j"), 3, 0.5, jst,
                           casenbound=nbound, nstep=9)
    assert_items_equal(jJB.read_file(pp), jJB.read_file(jp), PROGRAM_TEXT)
    extra = X.load_extradata(str(tmp_path / "p"), 3)
    assert extra["casenbound"] == nbound and not extra["usenormalsft"]
    nor = X.apply_normals(extra, pst.idp, pst.code, pst.n)
    bound = (td.code_type(pst.code) < td.TYPE_FLUID).numpy()
    np.testing.assert_array_equal(nor[bound], pst.boundnormal.numpy()[bound])
    assert X.load_extradata(str(tmp_path / "p"), 4) is None


def test_vtk_bytes_equal(states, tmp_path):
    case, jst, pst = states
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(17, 3))
    fields = dict(Idp=np.arange(17, dtype=np.uint32),
                  Vel=rng.normal(size=(17, 3)).astype(np.float32),
                  Rhop=rng.normal(1000, 3, 17))
    for binary in (True, False):
        a = V.write_vtk_particles(str(tmp_path / f"p{binary}.vtk"), pos,
                                  fields, binary=binary)
        b = jV.write_vtk_particles(str(tmp_path / f"j{binary}.vtk"), pos,
                                   fields, binary=binary)
        assert open(a, "rb").read() == open(b, "rb").read()
    tris = rng.integers(0, 17, (5, 3))
    lines = [np.array([0, 1, 2]), np.array([3, 4])]
    a = V.write_vtk_mesh(str(tmp_path / "pm.vtk"), pos, polys=tris,
                         lines=lines, fields={"Rhop": fields["Rhop"]})
    b = jV.write_vtk_mesh(str(tmp_path / "jm.vtk"), pos, polys=tris,
                          lines=lines, fields={"Rhop": fields["Rhop"]})
    assert open(a, "rb").read() == open(b, "rb").read()
    # the state dump: the port's state in the JAX state's slot order
    order = torch.argsort(pst.idp)
    a = V.write_state_vtk(str(tmp_path / "ps.vtk"), pst.permuted(order))
    b = jV.write_state_vtk(str(tmp_path / "js.vtk"), jst)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_schedules_terminate_and_ranges_match_jax(tmp_path):
    table = [(0.0, 0.1), (0.5, 0.05), (1.0, 0.2)]
    mine, theirs = OUT.OutputTime(table), jOUT.OutputTime(table)
    for t in np.linspace(-0.1, 1.5, 97):
        assert mine.interval(t) == theirs.interval(t)
    with pytest.raises(ValueError):
        OUT.OutputTime([(0.1, 0.2)])
    for txt in ("1,3-5,7", "2", " 4 , 1-2 ,", "10-12,11"):
        np.testing.assert_array_equal(common.parse_range_filter(txt),
                                      jcommon.parse_range_filter(txt))
    polls = []
    for mod in (RI, jRI):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        tc = mod.TerminateCheck(str(d))
        seen = [tc.poll()]
        (d / "TERMINATE").write_text("0.75")
        seen.append(tc.poll())
        seen.append(tc.poll())
        os.utime(d / "TERMINATE", ns=(1, 10 ** 9))
        (d / "TERMINATE").write_text("")
        os.utime(d / "TERMINATE", ns=(2, 2 * 10 ** 9))
        seen.append(tc.poll())
        polls.append(seen)
    assert polls[0] == polls[1] == [None, 0.75, None, 0.0]
