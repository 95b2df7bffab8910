"""The port's command line against the JAX package's.

* ``cli.main`` on the CPU with the same options as JAX's ``cli.main``
  (``-builtin dambreak2d -dp 0.05``, the DDT ramp crossing both of its ends,
  ``-savedt``, ``-nsteps``, ``-sv:binx,info,csv -nortimes``): the same file
  names; each ``Part_XXXX.bi4`` with equal ``Npok``, ``Nout`` and ``Step``,
  ``TimeStep`` at rtol 1e-6 and the particles by id at 1e-4*dp (positions)
  and rtol 2e-3 of the largest value (velocity, density: the force rule);
  ``SaveDt.csv`` and ``PartInfo.csv`` row for row (numbers at rtol 2e-3);
  JAX's ``tools.partvtk`` reads the port's series.  The PART interval
  holds a few steps: JAX's ``-svsteps`` (a tout of 1e-9 s) saves once per
  1e-9 s of simulated time, thousands of PARTs between two steps
  (``ROADMAP.md`` §3), so the port's ``-svsteps``, a PART after every
  step, is checked on its own.
* ``python -m dualsphysics_multilayer_tpu_torch.cli -cpu -builtin
  dambreak2d -dp 0.05 -tmax:0.01 -tout:0.005`` writes Part_0000-0002,
  which JAX's ``read_part`` reads; ``-partbegin:1`` from there goes on
  with Part_0001-0002, the last within 0.25*dp of the first run's by id.
* ``-pallas``/``-no-pallas`` and ``-cpu -shard`` without a count, which
  the JAX CLI runs, run and write the plain run's PARTs.
* Every option the port refuses leaves with a message naming it;
  ``-initnorpla``/``-initnorpart`` give the run's state JAX's normals
  under mDBC walls, and an NN case under ``-mdbc`` runs and says that its
  step runs no mDBC pre-pass.
* A ``DsphConfig.xml`` gives the CLI its defaults as JAX's does
  (explicit flags win; Run.csv takes its separator), and the package
  exports the JAX package's top-level names.
* A fresh interpreter importing the CLI, the output modules,
  ``port_verify_e2e.py`` and the examples' twins (without running them)
  loads neither JAX nor the JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu import cli as jcli
from dualsphysics_multilayer_tpu.io import jbinary as jJB
from dualsphysics_multilayer_tpu.io import partdata as jPD
from dualsphysics_multilayer_tpu_torch import cli
from dualsphysics_multilayer_tpu_torch.io import partdata as PD

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the subprocesses' torch threads, as this process's
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}
DP = 0.05
OPTIONS = ["-cpu", "-builtin", "dambreak2d", "-dp", str(DP), "-tmax:0.002",
           "-tout:0.0005", "-nsteps:6", "-savedt", "-ddtramp:0.0015:0.001:0.3",
           "-nortimes", "-sv:binx,info,csv"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    os.environ["DSPH_COMPCACHE"] = "0"     # no JAX compile cache under HOME
    try:
        assert jcli.main(OPTIONS + ["-dirout", str(d / "jax")]) == 0
    finally:
        del os.environ["DSPH_COMPCACHE"]
    assert cli.main(OPTIONS + ["-dirout", str(d / "port")]) == 0
    return d / "port", d / "jax"


def by_id(part):
    order = np.argsort(part["idp"])
    return {k: part[k][order] for k in ("idp", "pos", "vel", "rhop", "code")}


def close(got, want, rtol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_cli_parts_match_jax(runs):
    port, jax_ = runs
    names = sorted(os.listdir(jax_))
    assert sorted(os.listdir(port)) == names
    parts = [f for f in names if f.startswith("Part_0")]
    assert len(parts) >= 4
    steps = []
    for f in parts:
        mine, theirs = jPD.read_part(port / f), jPD.read_part(jax_ / f)
        assert (mine["npok"], mine["nstep"]) == (theirs["npok"], theirs["nstep"])
        steps.append(mine["nstep"])
        nout = [jJB.read_file(d / f).items[0].get("Nout") for d in runs]
        assert nout == [0, 0]
        np.testing.assert_allclose(mine["timestep"], theirs["timestep"],
                                   rtol=1e-6)
        a, b = by_id(mine), by_id(theirs)
        np.testing.assert_array_equal(a["idp"], b["idp"])
        np.testing.assert_array_equal(a["code"], b["code"])
        np.testing.assert_allclose(a["pos"], b["pos"], rtol=0, atol=1e-4 * DP)
        close(a["vel"], b["vel"], 2e-3)
        close(a["rhop"], b["rhop"], 2e-3)
    assert steps[-1] >= 6 and len(set(steps)) == len(steps)


def read_rows(path):
    with open(path) as f:
        head, *rows = [line.strip().split(";") for line in f]
    return head, rows


@pytest.mark.parametrize("name", ["SaveDt.csv", "PartInfo.csv"])
def test_cli_tables_match_jax(runs, name):
    port, jax_ = runs
    (h1, r1), (h2, r2) = read_rows(port / name), read_rows(jax_ / name)
    assert h1 == h2 and len(r1) == len(r2) >= 4
    for a, b in zip(r1, r2):
        assert a[0] == b[0]
        np.testing.assert_allclose(np.asarray(a[1:], float),
                                   np.asarray(b[1:], float), rtol=2e-3)


def test_jax_partvtk_reads_the_port_series(runs, tmp_path):
    from dualsphysics_multilayer_tpu.tools import partvtk
    port, _ = runs
    assert partvtk.main(["-dirin", str(port), "-savecsv",
                         str(tmp_path / "pv.csv")]) == 0
    nparts = len([f for f in os.listdir(port) if f.startswith("Part_0")])
    for k in range(nparts):
        assert (tmp_path / f"pv_{k:04d}.csv").exists()


def test_svsteps_saves_every_step(tmp_path):
    d = tmp_path / "steps"
    assert cli.main(["-cpu", "-builtin", "dambreak2d", "-dp", "0.1",
                     "-svsteps", "-nsteps:3", "-savedt", "-nortimes",
                     "-no-svres", "-dirout", str(d)]) == 0
    parts = [PD.read_part(d / PD.part_filename(k)) for k in range(4)]
    assert not (d / PD.part_filename(4)).exists()
    assert [p["nstep"] for p in parts] == [0, 1, 2, 3]
    _, rows = read_rows(d / "SaveDt.csv")
    times = np.asarray([r[1] for r in rows], float)
    dts = np.asarray([r[2] for r in rows], float)
    # each PART at its step's end time: the next step's start
    np.testing.assert_allclose([p["timestep"] for p in parts[1:3]], times[1:],
                               rtol=1e-6)
    np.testing.assert_allclose(parts[3]["timestep"], times[2] + dts[2],
                               rtol=1e-6)


def test_module_run_writes_parts_jax_reads_and_restarts(tmp_path):
    subprocess.run([sys.executable, "-m", "dualsphysics_multilayer_tpu_torch.cli",
                    "-cpu", "-builtin", "dambreak2d", "-dp", "0.05",
                    "-tmax:0.01", "-tout:0.005", "-dirout", str(tmp_path)],
                   check=True, cwd=ROOT, capture_output=True, env=ENV)
    for k in range(3):
        d = jPD.read_part(tmp_path / f"Part_{k:04d}.bi4")
        assert d["cpart"] == k and d["npok"] == 1001
        assert abs(d["timestep"] - 0.005 * k) < 1e-9
    assert not (tmp_path / "Part_0003.bi4").exists()
    # a restart from Part_0001 goes on with its numbers and reaches the
    # first run's Part_0002 within 0.25*dp by id (tests/test_io.py:76)
    again = tmp_path / "again"
    assert cli.main(["-cpu", "-builtin", "dambreak2d", "-dp", "0.05",
                     "-tmax:0.01", "-tout:0.005", "-partbegin:1",
                     str(tmp_path), "-dirout", str(again)]) == 0
    assert sorted(f for f in os.listdir(again) if f.startswith("Part_0")) \
        == ["Part_0001.bi4", "Part_0002.bi4"]
    a = by_id(PD.read_part(again / "Part_0002.bi4"))
    b = by_id(PD.read_part(tmp_path / "Part_0002.bi4"))
    np.testing.assert_array_equal(a["idp"], b["idp"])
    assert np.abs(a["pos"] - b["pos"]).max() < 0.25 * DP


@pytest.mark.parametrize("argv,name", [
    (["-case", "x.xml"], "-case"),
    # channel2d runs its inlet/outlet zones; a restart of it is refused
    (["-builtin", "channel2d", "-partbegin:1", "prev"], "channel2d"),
    # -initnorpla/-initnorpart run (test_initnor_options_give_jax_normals):
    # the refusal named is the next option's
    (["-builtin", "dambreak2d", "-initnorpla", "mkbound=0:normal=0:0:1",
      "-cellmode:half"], "-cellmode:half"),
    # -restartchrono runs: a restart of a Chrono case needs it
    (["-case", "CHRONO_CASE", "-initnorpart", "mkbound=0", "-partbegin:1",
      "prev"], "-restartchrono"),
    (["-case", "CHRONO_CASE", "-partbegin:1", "prev"], "-restartchrono"),
    (["-builtin", "dambreak2d", "-cellmode:half"], "-cellmode:half"),
])
def test_refused_options_name_themselves(argv, name, tmp_path):
    if "CHRONO_CASE" in argv:
        from test_torch_couplings import write_case
        case = write_case(tmp_path / "case", "chrono")
        argv = [case if a == "CHRONO_CASE" else a for a in argv]
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match=name) as e:
        cli.main(["-cpu", "-dirout", str(out)] + argv)
    assert "TPU" not in str(e.value) and "lane" not in str(e.value)
    assert not out.exists()


RUN_DP = 0.1
RUN_ARGV = ["-cpu", "-builtin", "dambreak2d", "-dp", str(RUN_DP),
            "-tmax:0.004", "-tout:0.002", "-sv:binx", "-nortimes"]


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("plain")
    assert cli.main(RUN_ARGV + ["-dirout", str(out)]) == 0
    return out


@pytest.mark.parametrize("flag", ["-pallas", "-no-pallas", "-shard"])
def test_options_the_jax_cli_runs_run(flag, plain_run, tmp_path, capsys):
    """``-pallas``/``-no-pallas`` (the JAX package's choice between two
    implementations of the same physics) run the port's one path and say
    so; ``-cpu -shard`` without a count runs one rank, as the JAX CLI's
    ``-shard`` runs over its CPU backend's one device.  Each writes the
    plain run's PARTs, by id within 1e-4*dp (bit-equal under the Pallas
    switch)."""
    out = tmp_path / "out"
    threads = torch.get_num_threads()
    try:
        assert cli.main(RUN_ARGV + [flag, "-dirout", str(out)]) == 0
    finally:
        torch.set_num_threads(threads)
    said = capsys.readouterr().out
    assert (cli.PALLAS_NOTE in said) == (flag != "-shard")
    assert ("sharded" in said or "rank" in said) == (flag == "-shard")
    names = sorted(f for f in os.listdir(plain_run) if f.endswith(".bi4"))
    assert len(names) == 3
    assert names == sorted(f for f in os.listdir(out) if f.endswith(".bi4"))
    for f in names:
        a, b = PD.read_part(plain_run / f), PD.read_part(out / f)
        np.testing.assert_array_equal(a["idp"], b["idp"])
        if flag == "-shard":
            np.testing.assert_allclose(b["pos"], a["pos"], rtol=0,
                                       atol=1e-4 * RUN_DP)
        else:
            np.testing.assert_array_equal(b["pos"], a["pos"])
            np.testing.assert_array_equal(b["rhop"], a["rhop"])


# a coarse 2D wet dam break (dp 0.05, 126 particles): two phases, the SPH
# velocity gradient, a first step of DtIni = 1 ms, a two-row timeout table
# and PartsOutMax
NN_XML = """<?xml version="1.0"?>
<case>
 <casedef>
  <constantsdef>
   <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/>
   <hswl value="0" auto="true"/><gamma value="7"/>
   <speedsystem value="0" auto="true"/><coefsound value="20"/>
   <speedsound value="0" auto="true"/><coefh value="1.0"/>
   <cflnumber value="0.2"/>
  </constantsdef>
  <geometry>
   <definition dp="0.05"><pointmin x="0" y="0" z="0"/>
    <pointmax x="2" y="0" z="1"/></definition>
   <commands><mainlist>
    <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right</boxfill>
     <point x="0" y="0" z="0"/><size x="1" y="0" z="0.6"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="0.9" y="0" z="0.1"/></drawbox>
    <setmkfluid mk="1"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="0.25" y="0" z="0.3"/></drawbox>
   </mainlist></commands>
  </geometry>
 </casedef>
 <execution>
  <special>
   <nnphases>
    <phase mkfluid="0"><rhop value="1000"/><visco value="0.001"/></phase>
    <phase mkfluid="1"><rhop value="1500"/><visco value="0.1"/>
     <tau_yield value="0.001"/><HBP_m value="10"/><HBP_n value="1"/></phase>
   </nnphases>
   <timeout><tout time="0" timeout="0.0005"/>
    <tout time="0.001" timeout="0.0003"/></timeout>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.01"/>
   <parameter key="StepAlgorithm" value="2"/>
   <parameter key="VelocityGradientType" value="2"/>
   <parameter key="ViscoTreatment" value="3"/>
   <parameter key="DensityDT" value="2"/>
   <parameter key="PartsOutMax" value="0.5"/>
   <parameter key="DtIni" value="0.001"/>
  </parameters>
 </execution>
</case>
"""


def test_case_runs_an_nn_xml_through_the_nn_step(tmp_path, monkeypatch):
    """``-cpu -case`` on an ``<nnphases>`` XML: two symplectic steps of
    ``make_nn_step`` (four NN interactions), the PARTs at the times of its
    ``<timeout>`` table (every 0.5 ms, from 1 ms every 0.3 ms; TimeOut
    alone would save at 0.01 s), the phases' densities in the PARTs, and
    the run's ``PartsOutMax``."""
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    from dualsphysics_multilayer_tpu_torch.ops import forces_nn as NN
    xmlp = tmp_path / "WetDambreak_Def.xml"
    xmlp.write_text(NN_XML)
    sims, calls = [], []
    inner = NN.interaction_forces_nn

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    class Recorded(W.Simulation):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            sims.append(self)

    monkeypatch.setattr(NN, "interaction_forces_nn", counted)
    monkeypatch.setattr(W, "Simulation", Recorded)
    d = tmp_path / "out"
    assert cli.main(["-cpu", "-case", str(xmlp), "-nsteps:2", "-nortimes",
                     "-dirout", str(d)]) == 0
    assert len(calls) == 4 and sims[0].carry.nstep == 2
    assert sims[0].partsoutmax == 0.5
    parts = [PD.read_part(d / PD.part_filename(k)) for k in range(4)]
    assert not (d / PD.part_filename(4)).exists()
    assert [p["nstep"] for p in parts] == [0, 1, 1, 2]
    np.testing.assert_allclose([p["timestep"] for p in parts],
                               [0.0, 5e-4, 1e-3, 1.3e-3], rtol=1e-9)
    code = parts[0]["code"]
    fluid = (code >> 16) & 3 == 3
    heavy = fluid & ((code & 0xFFFF) == 1)
    assert heavy.any() and (fluid & ~heavy).any()
    for p in parts:
        rho = p["rhop"]
        assert np.all(np.abs(rho[heavy] / 1500.0 - 1) < 0.1)
        assert np.all(np.abs(rho[fluid & ~heavy] / 1000.0 - 1) < 0.1)


@pytest.mark.parametrize("option", ["-verlet", "-savedt",
                                    "-ddtramp:0.01:0.005:0.3"])
def test_nn_case_leaves_with_the_nn_steps_refusal(option, tmp_path):
    """The NN step's refusals (forces_nn.check_supported_nn) leave the CLI
    with their message."""
    xmlp = tmp_path / "WetDambreak_Def.xml"
    xmlp.write_text(NN_XML)
    with pytest.raises(SystemExit, match="torch port") as e:
        cli.main(["-cpu", "-case", str(xmlp), option,
                  "-dirout", str(tmp_path / "out")])
    assert str(xmlp) in str(e.value)


def record_simulations(monkeypatch):
    """[(state, opts)] of every Simulation the CLI builds from now on."""
    from dualsphysics_multilayer_tpu_torch.models import wcsph as W
    made = []

    class Recorded(W.Simulation):
        def __init__(self, csp, opts, dom, st, *a, **k):
            super().__init__(csp, opts, dom, st, *a, **k)
            made.append((st, opts))

    monkeypatch.setattr(W, "Simulation", Recorded)
    return made


def test_nn_case_runs_under_mdbc_and_says_so(tmp_path, monkeypatch, capsys):
    """``-mdbc`` on an ``<nnphases>`` case: the NN step under mDBC walls
    (the builtin faces' normals), one line saying that it runs no mDBC
    pre-pass, and two steps."""
    xmlp = tmp_path / "WetDambreak_Def.xml"
    xmlp.write_text(NN_XML)
    made = record_simulations(monkeypatch)
    assert cli.main(["-cpu", "-case", str(xmlp), "-mdbc", "-nsteps:2",
                     "-sv:none", "-dirout", str(tmp_path / "out")]) == 0
    from dualsphysics_multilayer_tpu_torch.models.nnewtonian import MDBC_NOTE
    assert MDBC_NOTE in capsys.readouterr().out
    st, opts = made[0]
    assert opts.tboundary.name == "MDBC" and st.boundnormal is not None


@pytest.mark.parametrize("argv", [
    ["-initnorpla:mkbound=0:normal=0:0:1:point=auto"],
    ["-initnorpla", "mkbound=0:normal=1:0:0:point=0:0:0:maxdisth=3",
     "-initnorpart:mkbound=0:maxdisth=2"],
])
def test_initnor_options_give_jax_normals(argv, tmp_path, monkeypatch):
    """``-initnorpla``/``-initnorpart`` on the builtin 2D dam break: the
    run's state carries the normals (and velocity) that JAX's
    ``apply_initialize`` gives the JAX builtin from the same specs (the
    JAX CLI's rule, cli.py:413-421), under mDBC walls."""
    from dualsphysics_multilayer_tpu.features import initialize as jI
    from dualsphysics_multilayer_tpu.models import cases as jC
    made = record_simulations(monkeypatch)
    assert cli.main(["-cpu", "-builtin", "dambreak2d", "-dp", str(DP)]
                    + argv + ["-tmax:0.0002", "-tout:0.0002", "-sv:none",
                              "-dirout", str(tmp_path)]) == 0
    st, opts = made[0]
    assert opts.tboundary.name == "MDBC"
    args = cli.build_parser().parse_args(cli._normalize(argv))
    ops = [op for s in args.initnorpla
           for op in jI.parse_initnor_cli(s, kind="plane")]
    ops += [op for s in args.initnorpart
            for op in jI.parse_initnor_cli(s, kind="parts")]
    jcase = jC.dambreak2d(dp=DP)
    want = jI.apply_initialize(ops, jcase.csp, jcase.state)
    np.testing.assert_array_equal(st.idp.numpy(), np.asarray(want.idp))
    np.testing.assert_allclose(st.boundnormal.numpy(),
                               np.asarray(want.boundnormal), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(st.vel.numpy(), np.asarray(want.vel))
    assert float(st.boundnormal.abs().max()) > 0


# a feature the NN step runs no hook for: a moving tank (<motion>), the
# time-varying viscosity table (ViscoTime and its CSV beside the XML)
_NN_FEATURES = {
    "motion": (("</geometry>", """</geometry>
  <motion><objreal ref="0"><begin mov="1" start="0"/>
   <mvrect id="1" duration="1"><vel x="0.1" y="0" z="0"/></mvrect>
  </objreal></motion>"""), "<motion>"),
    "viscotime": (("<parameters>", """<parameters>
   <parameter key="ViscoTime" value="visco.csv"/>"""), "ViscoTime"),
}


@pytest.mark.parametrize("feature", sorted(_NN_FEATURES))
def test_nn_case_refuses_the_features_its_step_does_not_run(feature,
                                                            tmp_path):
    """An ``<nnphases>`` case that also sets a feature leaves before the
    run, naming the feature's XML node: the NN step has no feature hook,
    and JAX's would run the case with the feature ignored."""
    (old, new), node = _NN_FEATURES[feature]
    xmlp = tmp_path / "WetDambreak_Def.xml"
    xmlp.write_text(NN_XML.replace(old, new))
    (tmp_path / "visco.csv").write_text("0.0 0.001\n0.5 0.002\n")
    d = tmp_path / "out"
    with pytest.raises(SystemExit, match="on the NN step") as e:
        cli.main(["-cpu", "-case", str(xmlp), "-dirout", str(d)])
    assert node in str(e.value) and str(xmlp) in str(e.value)
    assert not d.exists()


def test_case_leaves_naming_a_refused_node(tmp_path):
    xmlp = tmp_path / "Inout_Def.xml"
    xmlp.write_text(NN_XML.replace("<special>",
                                   "<special><inout><inoutzone/></inout>"))
    with pytest.raises(SystemExit, match="<special><inout>"):
        cli.main(["-cpu", "-case", str(xmlp), "-dirout", str(tmp_path)])


def test_dsphconfig_defaults(tmp_path, monkeypatch):
    """The machine's DsphConfig.xml gives the CLI its defaults (JDsphConfig;
    JAX's tests/test_cli_channels.py test of the same name), explicit flags
    win, and a run's Run.csv takes the file's separator."""
    (tmp_path / "DsphConfig.xml").write_text(
        '<?xml version="1.0"?><dsphconfig><common>'
        '<createdirs v="0"/><csvseparator v="1"/>'
        '</common></dsphconfig>')
    monkeypatch.delenv("DSPHCONFIG", raising=False)
    monkeypatch.chdir(tmp_path)
    cfg = cli.load_dsphconfig()
    assert cfg == dict(createdirs=0, csvsep=1) == jcli.load_dsphconfig()
    p = cli.build_parser()
    p.set_defaults(**cfg)
    args = p.parse_args([])
    assert args.createdirs == 0 and args.csvsep == 1
    # explicit flags still win
    assert p.parse_args(["-csvsep", "0"]).csvsep == 0
    assert cli.load_dsphconfig([str(tmp_path / "none.xml")]) == {}
    out = tmp_path / "out"
    assert cli.main(["-cpu", "-builtin", "dambreak2d", "-dp", "0.1",
                     "-tmax:0.001", "-tout:0.001", "-svres", "-runname",
                     "chan", "-dirout", str(out)]) == 0
    head, row = open(out / "Run.csv").read().splitlines()[:2]
    assert ";" not in head and row.split(",")[0] == "chan"


def test_package_exports_jax_top_level_names():
    """The package's top-level names are JAX's (``__init__.py:11-19``):
    ``TpRigidMode`` and ``__version__``, the CLI's version."""
    import dualsphysics_multilayer_tpu as J
    import dualsphysics_multilayer_tpu_torch as P
    from dualsphysics_multilayer_tpu_torch import TpRigidMode, __version__
    assert __version__ == cli.VERSION == J.__version__
    assert [m.name for m in TpRigidMode] == [m.name for m in J.TpRigidMode]
    assert {"TpRigidMode", "__version__"} <= set(P.__all__)
    # every name JAX's package defines (its subpackages aside) is the port's
    names = {k for k, v in vars(J).items()
             if not k.startswith("_") and not isinstance(v, type(J))}
    assert names | {"__version__", "typesdef"} <= set(P.__all__)


def test_cli_and_output_modules_import_no_jax():
    code = ("import sys\n"
            "import dualsphysics_multilayer_tpu_torch.cli\n"
            "import dualsphysics_multilayer_tpu_torch.io.xmlcase\n"
            "import dualsphysics_multilayer_tpu_torch.io.meshfile\n"
            "import dualsphysics_multilayer_tpu_torch.utils.numex\n"
            "import dualsphysics_multilayer_tpu_torch.io.output\n"
            "import dualsphysics_multilayer_tpu_torch.io.jbinary\n"
            "import dualsphysics_multilayer_tpu_torch.tools.common\n"
            "import dualsphysics_multilayer_tpu_torch.utils.runinfo\n"
            "import dualsphysics_multilayer_tpu_torch.utils.log\n"
            "import dualsphysics_multilayer_tpu_torch.utils.timers\n"
            "import dualsphysics_multilayer_tpu_torch.utils.pips\n"
            "import dualsphysics_multilayer_tpu_torch.features.viscoinput\n"
            "import dualsphysics_multilayer_tpu_torch.features.initialize\n"
            "from dualsphysics_multilayer_tpu_torch.tools.common import (\n"
            "    pair_indices, parse_range_filter, wendland_wab)\n"
            "import importlib.util\n"
            "for path in ('port_verify_e2e.py',) + tuple(\n"
            "        'examples/torch/' + f for f in (\n"
            "        '02_waveflume.py', '03_floating_moored.py',\n"
            "        '04_inout_channel.py', '05_nn_mud_dambreak.py',\n"
            "        '06_sharded_runup.py')):\n"
            "    spec = importlib.util.spec_from_file_location('twin', path)\n"
            "    twin = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(twin)\n"
            "    assert callable(twin.main), path\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'dualsphysics_multilayer_tpu.'))"
            " or m == 'dualsphysics_multilayer_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=ENV)


def test_ver_and_info(capsys):
    import json
    assert cli.main(["-ver"]) == 0
    features = json.loads(capsys.readouterr().out)["features"]
    assert {"ddtramp", "symmetry", "initialize", "initnorpla",
            "initnorpart", "nn-mdbc"} <= set(features)
    assert cli.main(["-info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["features"]["builtin"] == list(cli.BUILTINS)
    assert "symmetry(y=0)" in info["features"]["boundary"]
    assert "-initnorpla" in info["features"]["initialize"]
