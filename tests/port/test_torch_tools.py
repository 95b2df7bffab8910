"""The post-processing tools and GenCase's writer against the JAX
package's, on the CPU.

* Each of the eleven tools, the port's (through ``tools.main``, the
  ``dsphtorchtools`` dispatch, with ``-cpu`` where its sums would run on
  the card) and the JAX package's, on the same files written by the
  port's writers: a 2D PART series with tests/test_tools.py's geometry, a
  small 3D series (IsoSurface's tetrahedra, a 3D elevation), a
  PartFloat.fbi4, a PartOut file and ReadSwash tables.  The files each
  writes are compared: numbers within rtol 1e-6 (abs 1e-9), everything
  else equal; binary VTK files byte for byte.
* ``common.device_pairs`` against brute force, in chunks.
* A device tool without a card and without ``-cpu`` leaves with an error.
* ``io.gencase.write_case`` against JAX's on the floating box: the .bi4
  items and the XML equal apart from the date fields.

No JAX compile: the JAX tools are numpy.
"""

import os
import re

import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import tools as jtools
from dualsphysics_multilayer_tpu.io import gencase as jgencase
from dualsphysics_multilayer_tpu.models import cases as jcases
from dualsphysics_multilayer_tpu_torch import tools
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.io import gencase
from dualsphysics_multilayer_tpu_torch.io import jbinary as jb
from dualsphysics_multilayer_tpu_torch.io import partdata
from dualsphysics_multilayer_tpu_torch.io.floatdata import (FloatBi4Writer,
                                                            PartOutWriter)
from dualsphysics_multilayer_tpu_torch.models import cases
from dualsphysics_multilayer_tpu_torch.tools import common as C
from dualsphysics_multilayer_tpu_torch.tools import measuretool

torch.set_num_threads(2)


class _St:
    """A state as the port's writers read it (torch tensors)."""

    def __init__(self, pos, vel, rho, code, idp):
        self.pos = torch.tensor(pos)
        self.vel = torch.tensor(vel)
        self.rho = torch.tensor(rho)
        self.code = torch.tensor(code.astype(np.int32))
        self.idp = torch.tensor(idp.astype(np.int64))


def _write_series(d, csp, wall, fluid, drift):
    pos = np.concatenate([wall, fluid])
    nb, nf = len(wall), len(fluid)
    n = nb + nf
    code = np.concatenate([
        np.full(nb, td.code_make(td.TYPE_FIXED, 0), np.uint32),
        np.full(nf, td.code_make(td.TYPE_FLUID, 0), np.uint32)])
    idp = np.arange(n)
    w = partdata.PartWriter(str(d), csp, np_total=n, nfixed=nb, nfluid=nf,
                            posmin=tuple(pos.min(0)), posmax=tuple(pos.max(0)))
    rng = np.random.default_rng(3)
    for cpart in range(3):
        p = pos.copy()
        p[nb:] += np.asarray(drift) * cpart
        vel = np.zeros((n, 3), np.float32)
        vel[nb:] = rng.normal(0.0, 0.1, (nf, 3)) + (0.1 * cpart, 0.0, 0.0)
        if csp.simulate2d:
            vel[:, 1] = 0.0
        rho = (1000.0 + cpart + rng.normal(0.0, 0.5, n)).astype(np.float32)
        w.save(cpart, 0.1 * cpart, _St(p, vel, rho, code, idp))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The input files: the 2D series of tests/test_tools.py (a wall row
    and an 8x8 fluid block, dp 0.05, drifting along x), a 3D series (a
    floor and a 6x4x6 block), a PartFloat.fbi4, a PartOut file, a boxes
    file and ReadSwash tables."""
    root = tmp_path_factory.mktemp("tool_inputs")
    dp = 0.05
    csp = td.make_ctesph(simulate2d=True, dp=dp, hswl=0.4)
    xw = np.arange(0, 1.0 + 1e-9, dp)
    wall = np.column_stack([xw, 0 * xw, 0 * xw - dp])
    fx, fz = np.meshgrid(np.arange(dp, 0.4, dp), np.arange(0, 0.4, dp))
    fluid = np.column_stack([fx.ravel(), 0 * fx.ravel(), fz.ravel() + dp])
    _write_series(root / "s2d", csp, wall, fluid, (0.01, 0.0, 0.0))

    csp3 = td.make_ctesph(simulate2d=False, dp=dp, hswl=0.3)
    g = np.arange(0, 0.5 + 1e-9, dp)
    gx, gy = np.meshgrid(g, g[:6], indexing="ij")
    floor = np.column_stack([gx.ravel(), gy.ravel(), 0 * gx.ravel() - dp])
    b = np.arange(6) * dp + dp
    bx, by, bz = np.meshgrid(b, b[:4], b - dp, indexing="ij")
    block = np.column_stack([bx.ravel(), by.ravel(), bz.ravel()])
    _write_series(root / "s3d", csp3, floor, block, (0.005, 0.0, -0.002))

    fl, po = root / "float", root / "partout"
    fl.mkdir()
    po.mkdir()
    w = FloatBi4Writer(str(fl), mkbound=[51, 52], begin=[0, 4],
                       count=[4, 3], mass=[1.0, 0.6], massp=[0.25, 0.2])
    for k in range(3):
        w.save_part(k, 0.05 * k,
                    center=[[0.1 * k, 0, 0.3], [0.5, 0, 0.2 - 0.01 * k]],
                    fvel=[[0.2, 0, 0], [0, 0, -0.2 * k]],
                    fomega=[[0, 0.1 * k, 0], [0, 0, 0]])
    w = PartOutWriter(str(po))
    w.save_part(1, 0.1, idp=[7, 9], pos=[[0, 0, 0], [1, 1, 1]],
                vel=[[0, 0, -1], [0, 0, -2]], rhop=[650.0, 1400.0],
                motive=[2, 2])
    w.save_part(2, 0.2, idp=[11], pos=[[0.5, 0, 0.2]], vel=[[1, 0, 0]],
                rhop=[1000.0], motive=[1])
    (root / "boxes.txt").write_text(
        "BOX @Left\n0 -1 0\n0.21 -1 0\n0.21 1 0\n0 1 0\n"
        "0 -1 1\n0.21 -1 1\n0.21 1 1\n0 1 1\n"
        "BOX @Right\n0.21 -1 0\n1.1 -1 0\n1.1 1 0\n0.21 1 0\n"
        "0.21 -1 1\n1.1 -1 1\n1.1 1 1\n0.21 1 1\n")
    t = np.linspace(0.0, 2.0, 101)
    v = 0.3 + np.sin(2 * np.pi * t)
    (root / "vel.csv").write_text(
        "time;v0\n" + "\n".join(f"{a};{b}" for a, b in zip(t, v)))
    vx = np.tile(v[:, None], (1, 4))
    (root / "velx.csv").write_text(
        "time;" + ";".join(f"v{i}" for i in range(4)) + "\n"
        + "\n".join(f"{a};" + ";".join(f"{x}" for x in row)
                    for a, row in zip(t, vx)))
    return root


# tool, argv over the inputs ``i`` and an output directory ``o``; the
# port's run adds "-cpu" to the device tools
CASES = {
    "partvtk": ("partvtk", lambda i, o: [
        "-dirin", f"{i}/s2d", "-savevtk", f"{o}/fluid.vtk",
        "-onlytype:-all,+fluid", "-vars:+press,+mass,+energy",
        "-savecsv", f"{o}/all.csv", "-savestatscsv", f"{o}/stats.csv",
        "-saveenergy", f"{o}/energy.csv"]),
    "measuretool": ("measuretool", lambda i, o: [
        "-dirin", f"{i}/s2d",
        "-pointsdef:ptls[x=0.02:0.05:10,z=0.0:0.04:12]",
        "-vars:+rhop,+vel,+press,+vol", "-savecsv", f"{o}/probe",
        "-savevtk", f"{o}/probe.vtk", "-onlytype:-all,+fluid"]),
    "measuretool-elevation": ("measuretool", lambda i, o: [
        "-dirin", f"{i}/s3d", "-pointsdef:ptls[x=0.02:0.04:10,y=0.06:0.05:3]",
        "-elevation", "-savecsv", f"{o}/eta.csv", "-onlytype:-all,+fluid"]),
    "isosurface": ("isosurface", lambda i, o: [
        "-dirin", f"{i}/s3d", "-saveiso", f"{o}/iso.vtk",
        "-distnode_dp:1.0"]),
    "isosurface-2d": ("isosurface", lambda i, o: [
        "-dirin", f"{i}/s2d", "-saveiso", f"{o}/iso.vtk", "-last:1",
        "-distnode_dp:1.0"]),
    "computeforces": ("computeforces", lambda i, o: [
        "-dirin", f"{i}/s2d", "-savecsv", f"{o}/forces", "-viscoart:0.1",
        "-momentex_xyz:0.5:0:0", "-savevtk", f"{o}/force.vtk",
        "-balancex"]),
    "computeforces-3d": ("computeforces", lambda i, o: [
        "-dirin", f"{i}/s3d", "-savecsv", f"{o}/forces",
        "-viscoart:0.05:1.0", "-momentaxisin:0:0:0:0:1:0:Mhinge"]),
    "flowtool": ("flowtool", lambda i, o: [
        "-dirin", f"{i}/s2d", "-fileboxes", f"{i}/boxes.txt",
        "-savecsv", f"{o}/flow.csv"]),
    "floatinginfo": ("floatinginfo", lambda i, o: [
        "-dirin", f"{i}/float", "-savemotion", f"{o}/motion"]),
    "partvtkout": ("partvtkout", lambda i, o: [
        "-dirin", f"{i}/partout", "-savecsv", f"{o}/out.csv",
        "-savevtk", f"{o}/out.vtk"]),
    "boundaryvtk": ("boundaryvtk", lambda i, o: [
        "-dirin", f"{i}/s3d", "-savevtkdata", f"{o}/bound.vtk"]),
    "tracerparts": ("tracerparts", lambda i, o: [
        "-dirin", f"{i}/s2d", "-savevtk", f"{o}/traj.vtk", "-maxparts:10",
        "-onlypos:0:-1:-1:2:1:1"]),
    "bifileinfo": ("bifileinfo", lambda i, o: [f"{i}/s3d/Part_0001.bi4"]),
    "readswash": ("readswash", lambda i, o: [
        "-correctcsv:2.0", f"{i}/vel.csv", f"{o}/velc.csv",
        "-savevtkveldp:0.05", f"{o}/vel", "-file_velx", f"{i}/velx.csv",
        "-dt", "0.5", "-tmin", "0", "-tmax", "2.0", "-dirout", str(o)]),
}
DEVICE_TOOLS = ("measuretool", "isosurface", "computeforces")
_NUM = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def assert_same_text(a, b, name):
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb), name
    for ra, rb in zip(la, lb):
        ta, tb = re.split(r"([;,\s]+)", ra), re.split(r"([;,\s]+)", rb)
        assert len(ta) == len(tb), (name, ra, rb)
        for x, y in zip(ta, tb):
            if x != y:
                assert _NUM.match(x) and _NUM.match(y), (name, ra, rb)
                np.testing.assert_allclose(float(y), float(x), rtol=1e-6,
                                           atol=1e-9, err_msg=name)


def assert_same_outputs(want_dir, got_dir):
    want = sorted(os.listdir(want_dir))
    assert want and sorted(os.listdir(got_dir)) == want
    for name in want:
        a = open(os.path.join(want_dir, name), "rb").read()
        b = open(os.path.join(got_dir, name), "rb").read()
        assert a, name
        if name.endswith(".vtk"):
            assert a == b, name
        else:
            assert_same_text(a.decode(), b.decode(), name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_matches_jax(inputs, tmp_path, capsys, case):
    name, argv = CASES[case]
    want, got = tmp_path / "jax", tmp_path / "port"
    want.mkdir()
    got.mkdir()
    assert jtools.main([name] + argv(inputs, want)) in (0, None)
    out_jax = capsys.readouterr().out.replace(str(want), "OUT")
    extra = ["-cpu"] if name in DEVICE_TOOLS else []
    assert tools.main([name] + argv(inputs, got) + extra) in (0, None)
    out_port = capsys.readouterr().out.replace(str(got), "OUT")
    assert_same_text(out_jax, out_port, "stdout")
    if name == "bifileinfo":
        assert "ARRAY Posd" in out_port
    else:
        assert_same_outputs(want, got)


def test_isosurface_has_triangles(inputs, tmp_path):
    tools.main(["isosurface", "-dirin", f"{inputs}/s3d", "-saveiso",
                f"{tmp_path}/iso.vtk", "-last:0", "-distnode_dp:1.0",
                "-cpu"])
    assert b"POLYGONS" in open(tmp_path / "iso_0000.vtk", "rb").read()


def test_device_pairs_match_bruteforce():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 1, (400, 3))
    tgt = rng.uniform(-0.2, 1.2, (120, 3))
    r = 0.15
    d2 = ((tgt[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    want = set(zip(*np.where(d2 < r * r)))
    got = []
    for ti, sj in C.device_pairs(torch.tensor(src), torch.tensor(tgt), r,
                                 max_pairs=500):
        assert ti.dtype == sj.dtype == torch.int64
        got += list(zip(ti.tolist(), sj.tolist()))
    assert len(got) == len(set(got)) and set(got) == want
    assert list(C.device_pairs(torch.tensor(src), torch.zeros((0, 3)), r)) == []


@pytest.mark.parametrize("name", DEVICE_TOOLS)
def test_device_tool_without_a_card_leaves(inputs, tmp_path, monkeypatch,
                                           name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = dict(measuretool=["-pointsdef:pt=0.2:0:0.2", "-savecsv",
                             f"{tmp_path}/p"],
                isosurface=["-saveiso", f"{tmp_path}/iso.vtk"],
                computeforces=["-savecsv", f"{tmp_path}/f"])[name]
    with pytest.raises(SystemExit, match="no CUDA device"):
        tools.main([name, "-dirin", f"{inputs}/s2d"] + argv)
    assert not os.listdir(tmp_path)
    d = partdata.read_part(f"{inputs}/s2d/Part_0000.bi4")
    with pytest.raises(SystemExit, match="no CUDA device"):
        measuretool.interpolate(d, np.zeros((1, 3)), ["rhop"])


def _bi4_items(path):
    def walk(item, prefix):
        out = {}
        for k, (t, v) in item.values.items():
            if k != "Date":
                out[f"{prefix}{k}"] = (t, v)
        for ar in item.arrays:
            out[f"{prefix}[{ar.name}]"] = (ar.type, ar.data.tobytes())
        for ch in item.items:
            out.update(walk(ch, f"{prefix}{ch.name}/"))
        return out
    return walk(jb.read_file(path), "")


def test_write_case_matches_jax(tmp_path):
    jcase = jcases.floatingbox2d(dp=0.04)
    case = cases.floatingbox2d(dp=0.04, device="cpu")
    params = {"StepAlgorithm": 2, "TimeMax": 0.5}
    want = jgencase.write_case(jcase, str(tmp_path / "jax"), "Box",
                               params=params)
    got = gencase.write_case(case, str(tmp_path / "port"), "Box",
                             params=params)
    assert [os.path.basename(p) for p in got] == ["Box.bi4", "Box.xml"]
    assert _bi4_items(got[0]) == _bi4_items(want[0])
    strip = lambda p: re.sub(r'date="[^"]*"', "", open(p).read())
    assert strip(got[1]) == strip(want[1])
    assert "<floating" in strip(got[1])
