"""The port's case-XML loader (``io/xmlcase.py``) against the JAX package's.

Each inline ``*_Def.xml`` goes through JAX ``io.xmlcase.load_case`` and the
port's ``load_case(device="cpu")``, and the two results are compared array
by array: ``CteSph`` and ``SolverOpts`` field by field (enums by name),
positions as float32 bit for bit in id order, typecodes, ids and densities
equal, mDBC normals within 1e-6, the optional state fields and the
floating bodies' state equal, the domain's grid, the run values and the
meta values equal, and the feature configurations equal to
``convert.features`` of JAX's.  The fixtures are copies of the JAX tests'
XML (tests/test_gencase_geo.py, test_io.py, test_features.py,
test_wavegen_full.py, test_relaxzone_mlpiston.py) plus a floating box and
an ``<nnphases>`` case.  Loading compiles no JAX step.

The XML dam break draws the builtin ``cases.dambreak3d``'s particles, an
``<inout>`` zone the loader cannot read raises ``NotImplementedError``
naming the node, ``Symmetry=1`` in 2D and ``<moorings>`` without floating
bodies raise JAX's ValueError, and ``<chrono>`` and ``RigidAlgorithm=2``,
once refused, load as JAX's loader loads them.
"""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from dualsphysics_multilayer_tpu.io import xmlcase as jX
from dualsphysics_multilayer_tpu_torch import convert
from dualsphysics_multilayer_tpu_torch import typesdef as td
from dualsphysics_multilayer_tpu_torch.io import xmlcase as X
from dualsphysics_multilayer_tpu_torch.models import cases

torch.set_num_threads(2)

_XML = """<?xml version="1.0"?>
<case>
 <casedef>
  <constantsdef>
   <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/>
   <hswl value="{hswl}" auto="false"/><gamma value="7"/>
   <speedsystem value="0" auto="true"/><coefsound value="20"/>
   <speedsound value="{cs}" auto="false"/><coefh value="1.0"/>
   <cflnumber value="0.2"/>
  </constantsdef>
  <mkconfig boundcount="240" fluidcount="10"/>
  <geometry>
   <definition dp="{dp}">
    <pointmin x="{lo[0]}" y="{lo[1]}" z="{lo[2]}"/>
    <pointmax x="{hi[0]}" y="{hi[1]}" z="{hi[2]}"/>
   </definition>
   <commands>{lists}<mainlist>
    {cmds}
   </mainlist></commands>
  </geometry>
  {casedef}
 </casedef>
 <execution>
  <uservars>{uservars}</uservars>
  <special>{special}</special>
  <parameters>
   {params}
  </parameters>
 </execution>
</case>
"""
_TIMES = ('<parameter key="TimeMax" value="0.1"/>'
          '<parameter key="TimeOut" value="0.05"/>')
# a tank and water below most fixtures' specials
_TANK = """<setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="0" y="0" z="0"/><size x="{w}" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="{f}" y="0" z="0.3"/></drawbox>"""


def xml(cmds, *, dp=0.05, lo=(0, 0, 0), hi=(1, 0, 1), special="",
        params="", casedef="", uservars="", lists="", hswl=0.3, cs=0):
    return _XML.format(cmds=cmds, dp=dp, lo=lo, hi=hi, special=special,
                       params=params or _TIMES, casedef=casedef,
                       uservars=uservars, lists=lists, hswl=hswl, cs=cs)


def stl_cube(path, lo=0.2, size=0.3):
    """A binary STL of the cube [lo, lo + size]^3 (12 triangles)."""
    faces = []
    for axis in range(3):
        for side in (0.0, 1.0):
            pts = []
            for u in ((0, 0), (1, 0), (1, 1), (0, 1)):
                p = [0.0, 0.0, 0.0]
                p[axis] = side
                p[(axis + 1) % 3] = float(u[0])
                p[(axis + 2) % 3] = float(u[1])
                pts.append([lo + size * c for c in p])
            faces += [[pts[0], pts[1], pts[2]], [pts[0], pts[2], pts[3]]]
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(faces)))
        for tri in faces:
            f.write(struct.pack("<3f", 0, 0, 0))
            for v in tri:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))


_CUBE_FIG = "".join(f'<point x="{x}" y="{y}" z="{z}"/>'
                    for x in (0, 0.4) for y in (-0.2, 0.2) for z in (0, 0.4))
_CUBE_TRIS = "".join(
    f'<triangle x="{a}" y="{b}" z="{c}"/>'
    for a, b, c in [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
                    (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
                    (1, 5, 7), (1, 7, 3)])
_PRISM = """<point x="0" y="-0.3" z="0"/><point x="0.6" y="-0.3" z="0"/>
      <point x="0.3" y="-0.3" z="0.6"/>
      <point x="0" y="0.3" z="0"/><point x="0.6" y="0.3" z="0"/>
      <point x="0.3" y="0.3" z="0.6"/>"""

# name -> (xml, {file name: its text, or a function that writes it})
FIXTURES = {
    # tests/test_gencase_geo.py: the transform stack on a solid and a face
    # box, a saved and reloaded matrix, a moved box
    "rotated_boxes": (xml("""
    <setmkbound mk="0"/>
    <drawbox><boxfill>bottom</boxfill>
      <point x="-0.5" y="0" z="-0.3"/><size x="2.0" y="0" z="0.02"/></drawbox>
    <setmkfluid mk="0"/>
    <matrixsave/>
    <rotateline ang="45">
      <point x="0" y="0" z="0"/><point x="0" y="1" z="0"/>
    </rotateline>
    <drawbox><boxfill>solid</boxfill>
      <point x="0" y="0" z="0"/><size x="0.4" y="0" z="0.2"/></drawbox>
    <setmkbound mk="2"/>
    <drawbox><boxfill>left|right|top</boxfill>
      <point x="0.6" y="0" z="0"/><size x="0.3" y="0" z="0.3"/></drawbox>
    <matrixload/>
    <move x="0.1" y="0" z="1.0"/><scale x="1" y="1" z="1"/>
    <rotate ang="30" x="0" y="1" z="0"/>
    <setmkbound mk="3"/>
    <drawbox><boxfill>solid</boxfill>
      <point x="0" y="0" z="0"/><size x="0.2" y="0" z="0.1"/></drawbox>
    <matrixreset/>
    """, dp=0.02, lo=(-1, 0, -1), hi=(2, 0, 2), hswl=0.1, cs=20), {}),
    "setvar_fillpoint": (xml("""
    <setvar W="0.4" H="W/2"/>
    <setmkbound mk="0"/>
    <drawbox><boxfill>bottom|left|right|top</boxfill>
      <point x="0" y="0" z="0"/><size x="W" y="0" z="H+0.1"/></drawbox>
    <setmkfluid mk="0"/>
    <fillpoint x="W/2" y="0" z="0.05"><modefill>fluid</modefill></fillpoint>
    <fillvoidpoint x="0.1" y="0" z="0.1"/>
    """, dp=0.02, lo=(-1, 0, -1), hi=(2, 0, 2), hswl=0.1, cs=20), {}),
    "lines_strips_pyramid": (xml("""
    <setmkbound mk="0"/>
    <setlinebegin x="0" y="0" z="0"/>
    <drawlineto x="0.5" y="0" z="0"/>
    <drawlineto x="0.5" y="0" z="0.5"/>
    <drawline><point x="0" y="0" z="0.7"/><point x="0.4" y="0" z="0.9"/>
    </drawline>
    <drawtrianglesstrip>
      <point x="0" y="0" z="1"/><point x="0.2" y="0" z="1"/>
      <point x="0" y="0" z="1.2"/><point x="0.2" y="0" z="1.2"/>
    </drawtrianglesstrip>
    <drawtrianglesfan>
      <point x="1" y="0" z="1"/><point x="1.2" y="0" z="1"/>
      <point x="1.2" y="0" z="1.2"/><point x="1" y="0" z="1.2"/>
    </drawtrianglesfan>
    <drawpyramid>
      <point x="1.5" y="0" z="0.5"/>
      <point x="1.3" y="0" z="0"/><point x="1.7" y="0" z="0"/>
    </drawpyramid>
    <drawquadri><point x="1.0" y="0" z="1.5"/><point x="1.2" y="0" z="1.5"/>
      <point x="1.2" y="0" z="1.7"/><point x="1.0" y="0" z="1.7"/>
    </drawquadri>
    <drawpoints><point x="1.9" y="0" z="1.9"/><point x="1.8" y="0" z="1.9"/>
    </drawpoints>
    <drawbeach><point x="0" y="0" z="1.8"/><point x="0.3" y="0" z="1.9"/>
    </drawbeach>
    <setmkfluid mk="0"/>
    <drawbox><boxfill>solid</boxfill>
      <point x="-0.5" y="0" z="-0.5"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <drawwave depth="0.4" hmaxwave="0.2" x0="0.5" z0="0.4">
      <point x="-1" y="0" z="-0.9"/><size x="1" y="0" z="1"/>
    </drawwave>
    """, dp=0.02, lo=(-1, 0, -1), hi=(2, 0, 2), hswl=0.1, cs=20), {}),
    "redraw_mkstack": (xml("""
    <setmkbound mk="0"/>
    <drawbox><boxfill>solid</boxfill>
      <point x="0" y="0" z="0"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <mksave/>
    <setmkbound mk="3"/>
    <redrawbox mkbound="0">
      <point x="0" y="0" z="0.1"/><size x="0.3" y="0" z="0.2"/>
    </redrawbox>
    <mkload/>
    <drawbox><boxfill>solid</boxfill>
      <point x="0.5" y="0" z="0"/><size x="0.1" y="0" z="0.1"/></drawbox>
    <setmkvoid/>
    <drawbox><boxfill>solid</boxfill>
      <point x="0.5" y="0" z="0"/><size x="0.04" y="0" z="0.04"/></drawbox>
    <setmkfluid mk="1"/>
    <redraw mkbound="3"/>
    <setmknextauto auto="true"/>
    <setmkbound mk="5"/>
    <drawbox><boxfill>solid</boxfill>
      <point x="0.8" y="0" z="0"/><size x="0.1" y="0" z="0.1"/></drawbox>
    <drawbox><boxfill>solid</boxfill>
      <point x="1.0" y="0" z="0"/><size x="0.1" y="0" z="0.1"/></drawbox>
    <setmknextauto auto="false"/>
    <setactive drawpoints="false"/>
    <drawbox><boxfill>solid</boxfill>
      <point x="1.2" y="0" z="0"/><size x="0.1" y="0" z="0.1"/></drawbox>
    <setactive drawpoints="true"/>
    <setshapemode>actual</setshapemode>
    <cellsout file="snap"/>
    """, dp=0.02, lo=(-1, 0, -1), hi=(2, 0, 2), hswl=0.1, cs=20), {}),
    # GenCase command lists with fillbox and redrawnear (RedrawGenCase)
    "lists_redrawnear": (xml("""
    <runlist name="walls"/>
    <setmkfluid mk="0"/>
    <fillbox x="0.2" y="0" z="0.2"><modefill>void</modefill>
      <point x="0" y="0" z="0"/><size x="0.5" y="0" z="0.5"/></fillbox>
    <setmkfluid mk="4"/>
    <redrawnear times="2" targettp="fluid" bordertp="bound">
      <dirfilter>left|bottom</dirfilter></redrawnear>
    <setmkbound mk="6"/>
    <redrawnearbox times="1" targettp="void" bordertp="bound" bordermk="1">
      <point x="-0.2" y="0" z="-0.2"/><size x="0.9" y="0" z="0.9"/>
    </redrawnearbox>
    <setmkfluid mk="7"/>
    <redraw/>
    """, dp=0.05, lo=(-0.3, 0, -0.3), hi=(0.8, 0, 0.8), hswl=0.1, cs=20,
        lists="""<list name="walls"><setmkbound mk="1"/>
     <drawbox><boxfill>bottom|left|right</boxfill>
      <point x="0" y="0" z="0"/><size x="0.5" y="0" z="0.5"/></drawbox>
    </list>"""), {}),
    "solids3d": (xml(f"""
    <setmkbound mk="0"/>
    <setdrawmode mode="face"/>
    <drawprism>{_PRISM}</drawprism>
    <fillprism x="0.3" y="0" z="0.2" mkfluid="1">{_PRISM}</fillprism>
    <setdrawmode mode="full"/>
    <setmkbound mk="2"/>
    <drawsphere radius="0.15"><point x="1.2" y="0" z="0.3"/></drawsphere>
    <drawcylinder radius="0.1"><point x="1.6" y="0" z="0"/>
      <point x="1.6" y="0" z="0.4"/></drawcylinder>
    <drawellipsoid radius="1"><point x="0" y="-0.5" z="1"/>
      <point x="0.4" y="-0.3" z="1.2"/></drawellipsoid>
    <setdrawmode mode="face"/>
    <drawsphere radius="0.15"><point x="1.2" y="0" z="1.0"/></drawsphere>
    <drawpolygon><point x="-0.8" y="-0.8" z="0"/><point x="-0.4" y="-0.8" z="0"/>
      <point x="-0.6" y="-0.4" z="0"/><extrude x="0" y="0" z="0.2"/>
    </drawpolygon>
    <setmkbound mk="3"/>
    <drawfilestl file="cube.stl"><drawmove x="0" y="0.1" z="0"/></drawfilestl>
    <drawfigure><points>{_CUBE_FIG}</points>
      <triangles>{_CUBE_TRIS}</triangles></drawfigure>
    <fillfigure x="0.2" y="0" z="0.2" mkfluid="2">
      <points>{_CUBE_FIG}</points><triangles>{_CUBE_TRIS}</triangles>
    </fillfigure>
    """, lo=(-1, -1, -1), hi=(2, 1, 2), hswl=0.1, cs=20),
        {"cube.stl": stl_cube}),
    "bathymetry": (xml("""
    <setmkbound mk="0"/>
    <drawfilecsv file="bathy.csv" mode="bathymetry"/>
    <setmkfluid mk="0"/>
    <drawbox><boxfill>solid</boxfill>
      <point x="-0.5" y="0" z="0.4"/><size x="0.5" y="0" z="0.2"/></drawbox>
    """, dp=0.02, lo=(-1, 0, -1), hi=(2, 0, 2), hswl=0.1, cs=20),
        {"bathy.csv": "x;y;z\n" + "\n".join(
            f"{-1.0 + i * 0.075};{-0.1 + j * 0.1};{0.3 + 0.1 * (-1.0 + i * 0.075)}"
            for i in range(41) for j in range(3))}),
    # tests/test_io.py: parameters from uservars and #expressions
    "uservars": (xml(_TANK.format(w=1, f=0.35), hswl=0, uservars="""
   <varnum name="tfactor" value="2.0"/><varnum name="k" value="#tfactor*3"/>
   <varstr name="tag" value="abc"/>""", params="""
   <parameter key="TimeMax" value="#0.1*tfactor"/>
   <parameter key="TimeOut" value="#H"/>
   <parameter key="Visco" value="#0.005*tfactor"/>
   <parameter key="DensityDT" value="2"/>
   <parameter key="DensityDTvalue" value="#0.05*k"/>
   <parameter key="CaseName" value="uv"/>"""), {}),
    "gauges": (xml(_TANK.format(w=2, f=1.4), hi=(2, 0, 2.2), special="""
   <gauges>
    <default><computedt value="0.01"/></default>
    <velocity name="Vel-0">
     <computetime start="0.05" end="0.11"/>
     <point x="1.0" y="0" z="0.1"/>
    </velocity>
    <swl name="Swl_x09">
     <masslimit coef="0.45"/>
     <pointdp coefdp="0.5"/>
     <point0 x="0.9" y="0" z="0"/><point2 x="0.9" y="0" z="2.1"/>
    </swl>
    <swl name="Swl_v"><masslimit value="1.0"/><pointdp value="0.03"/>
     <point0 x="0.5" y="0" z="0"/><point2 x="0.5" y="0" z="1"/></swl>
    <maxz name="MaxZ">
     <point0 x="0.9" y="0" z="0"/><height value="2.1"/>
     <distlimit coefh="0.1"/><computedt value="0.02"/>
    </maxz>
    <force name="Force1"><target mkbound="1"/></force>
    <velocity name="off" active="false"><point x="0" y="0" z="0"/></velocity>
   </gauges>"""), {}),
    # tests/test_features.py: motion chains and accinputs
    "motion_accinput": (xml("""
    <setmkbound mk="7"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="0.9" y="0" z="-0.1"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkbound mk="8"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="-1" y="0" z="1"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkbound mk="9"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="2" y="0" z="1"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkfluid mk="0"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="-1.5" y="0" z="-1.5"/><size x="0.2" y="0" z="0.2"/></drawbox>
    """, lo=(-2, 0, -2), hi=(3, 0, 3), cs=30, casedef="""
  <motion>
   <objreal ref="7">
    <begin mov="1" start="0"/>
    <mvcir id="1" duration="10" anglesunits="degrees">
     <vel ang="90"/>
     <ref x="1" y="0" z="0"/>
     <axisp1 x="0" y="0" z="0"/><axisp2 x="0" y="1" z="0"/>
    </mvcir>
   </objreal>
   <objreal ref="8">
    <begin mov="1" start="0"/>
    <mvrect id="1" duration="0.5" next="2"><vel x="1" y="0" z="0"/></mvrect>
    <mvrect id="2" duration="0.5" next="1"><vel x="-1" y="0" z="0"/></mvrect>
   </objreal>
   <obj>
    <begin mov="1" start="0" finish="3"/>
    <mvrectsinu id="1" duration="2" anglesunits="radians">
     <freq x="0.5" y="0" z="0"/><ampl x="0.1" y="0" z="0"/>
     <phase x="0.2" y="0" z="0"/></mvrectsinu>
    <objreal ref="9">
     <begin mov="1" start="0.5"/>
     <mvrotsinu id="1" duration="1" next="2">
      <axisp1 x="2" y="0" z="1"/><axisp2 x="2" y="1" z="1"/>
      <freq v="1"/><ampl v="10"/><phase v="30"/></mvrotsinu>
     <wait id="2" duration="0.5" next="3"/>
     <mvrotace id="3" duration="1">
      <axisp1 x="2" y="0" z="1"/><axisp2 x="2" y="1" z="1"/>
      <velini ang="5"/><ace ang="2"/></mvrotace>
    </objreal>
   </obj>
  </motion>""", special="""
   <accinputs>
    <accinput mkfluid="0">
     <time start="0" end="10"/>
     <acccentre x="0" y="0" z="0"/>
     <globalgravity value="1"/>
     <acctimes>
      <timevalue time="0.0" linz="0"/>
      <timevalue time="0.5" linz="2" angy="5"/>
     </acctimes>
    </accinput>
    <accinput mkbound="7-8">
     <acccentre x="0" y="0" z="0"/>
     <globalgravity value="0"/>
     <acctimesfile value="forces.csv"/>
    </accinput>
   </accinputs>"""),
        {"forces.csv": "#t ax ay az angx angy angz\n0;1;0;0;0;0;0\n"
                       "5;1;0;0;0;0;0\n"}),
    # tests/test_wavegen_full.py: wave paddles, with an AWAS piston
    "wavepaddles": (xml("""
   <setmkbound mk="10"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="0" y="0" z="0"/><size x="0.05" y="0" z="0.4"/></drawbox>
   <setmkbound mk="11"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="3" y="0" z="0"/><size x="0.05" y="0" z="0.4"/></drawbox>
   <setmkbound mk="12"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="4" y="0" z="0"/><size x="0.05" y="0" z="0.4"/></drawbox>
   <setmkbound mk="13"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="5" y="0" z="0"/><size x="0.05" y="0" z="0.4"/></drawbox>
   <setmkbound mk="14"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="6" y="0" z="0"/><size x="0.05" y="0" z="0.4"/></drawbox>
   <setmkbound mk="15"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="7" y="0" z="0"/><size x="0.05" y="0" z="0.4"/></drawbox>
   <setmkfluid mk="0"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="0.1" y="0" z="0"/><size x="2.8" y="0" z="0.3"/></drawbox>
    """, lo=(-0.2, 0, -0.1), hi=(7.5, 0, 1), special="""
  <wavepaddles>
   <piston_spectrum>
    <mkbound value="10"/><depth value="0.3"/>
    <spectrum value="jonswap"/><discretization value="stretched"/>
    <waveheight value="0.08"/><waveperiod value="1.4"/>
    <waves value="12"/><randomseed value="2"/>
   </piston_spectrum>
   <piston_solitary>
    <mkbound value="11"/><depth value="0.3"/>
    <waveheight value="0.05"/><theory value="2"/>
   </piston_solitary>
   <flap>
    <mkbound value="12"/><depth value="0.3"/>
    <flapaxis0 x="4.025" y="0" z="0"/><flapaxis1 x="4.025" y="1" z="0"/>
    <waveheight value="0.06"/><waveperiod value="1.2"/>
   </flap>
   <piston>
    <mkbound value="13"/><waveorder value="2"/><waveheight value="0.05"/>
    <waveperiod value="1.1"/><phase value="0.5"/><ramp value="1"/>
    <awas_zsurf><startawas value="0.5"/><swl value="0.3"/>
     <gaugex valuedp="4"/></awas_zsurf>
   </piston>
   <flap_spectrum>
    <mkbound value="14"/><depth value="0.3"/><waveheight value="0.05"/>
    <waveperiod value="1.3"/><waves value="8"/>
    <flapaxis0 x="6.025" y="0" z="0"/><flapaxis1 x="6.025" y="1" z="0"/>
   </flap_spectrum>
   <piston_focused>
    <mkbound value="15"/><depth value="0.3"/><waveheight value="0.05"/>
    <waveperiod value="1.3"/><waves value="16"/><xf value="2"/>
   </piston_focused>
  </wavepaddles>"""), {}),
    # tests/test_relaxzone_mlpiston.py: multi-layer pistons
    "mlpistons": (xml("""
    <setmkbound mk="10"/><drawbox><boxfill>solid</boxfill>
     <point x="-0.2" y="0" z="0"/><size x="0.1" y="0" z="0.6"/></drawbox>
    <setmkbound mk="11"/><drawbox><boxfill>solid</boxfill>
     <point x="1.5" y="0" z="0"/><size x="0.1" y="0" z="0.6"/></drawbox>
    <setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="0" y="0" z="0"/><size x="2" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.1" y="0" z="0.05"/><size x="1" y="0" z="0.3"/></drawbox>
    """, lo=(-0.3, 0, 0), hi=(2, 0, 1), hswl=0, special="""
   <mlayerpistons>
    <piston1d>
     <mkbound value="10"/>
     <filevelx value="velx.csv"/>
     <incz value="0.05"/>
     <timedataini value="0.5"/>
     <smooth value="1"/>
    </piston1d>
    <piston2d>
     <mkbound value="11"/><incz value="0.02"/><smoothz value="1"/>
     <veldata><filevelx value="velx_y1.csv"/><posy value="1"/></veldata>
     <veldata><filevelx value="velx.csv"/><posy value="0"/></veldata>
    </piston2d>
   </mlayerpistons>"""),
        {"velx.csv": "time;v1;v2;v3\n0.0;0.1;0.2;0.3\n2.0;0.5;0.6;0.7\n",
         "velx_y1.csv": "time v1 v2 v3\n0.0 1.0 1.0 1.0\n2.0 1.0 1.0 1.0\n"}),
    "relaxzones": (xml(_TANK.format(w=4, f=3.9), hi=(4, 0, 1), hswl=0,
                       special="""
   <relaxationzones>
    <rzwaves_regular>
     <start value="0"/><duration value="0"/>
     <waveorder value="2"/><waveheight value="0.16"/><waveperiod value="2"/>
     <depth value="0.35"/><swl value="0.35"/>
     <center x="0.5" y="0" z="0"/><width value="0.4"/>
     <phase value="0.5"/><ramp value="1"/>
     <coefdir x="1" y="0" z="0"/><coefdt value="1000"/>
     <function psi="0.9" beta="1"/>
     <driftcorrection value="1.0"/>
    </rzwaves_regular>
    <rzwaves_spectrum>
     <spectrum value="jonswap"/><peakcoef value="3.3"/>
     <discretization value="stretched"/>
     <waveheight value="0.1"/><waveperiod value="3"/><waves value="32"/>
     <randomseed value="2"/><depth value="0.35"/><swl value="0.35"/>
     <center x="1.5" y="0" z="0"/><width value="0.4"/>
     <ramptime value="1"/><serieini value="0"/>
     <function psi="0.9" beta="1"/>
    </rzwaves_spectrum>
    <rzwaves_external_1d>
     <depth value="0.35"/><swl value="0.35"/>
     <filesvel value="ext"/><movedata x="0.2" z="0"/>
     <usevelz value="false"/>
     <center x="2.5" y="0" z="0"/><width value="0.4"/>
    </rzwaves_external_1d>
    <rz_uniform>
     <domainbox>
      <point x="3.0" y="-0.5" z="0"/><size x="0.5" y="1" z="0.5"/>
      <direction x="-1" y="0" z="0"/>
     </domainbox>
     <velocitytimes>
      <timevalue time="0.0" v="0"/><timevalue time="2.0" v="0.5"/>
     </velocitytimes>
    </rz_uniform>
    <rz_uniform>
     <domainbox>
      <point x="3.0" y="-0.5" z="0"/><size x="0.5" y="1" z="0.5"/>
      <direction x="-1" y="0" z="0"/>
      <rotateaxis angle="-45" anglesunits="degrees">
       <point1 x="3.25" y="0" z="0"/><point2 x="3.25" y="1" z="0"/>
      </rotateaxis>
     </domainbox>
     <velocity value="0.3"/>
    </rz_uniform>
   </relaxationzones>
   <damping>
    <dampingzone><limitmin x="3" y="0" z="0"/><limitmax x="3.8" y="0" z="0"/>
     <overlimit value="0.1"/><redumax value="8"/></dampingzone>
    <dampingbox><limitmin><pointini x="0" y="0" z="0"/>
     <pointend x="1" y="1" z="1"/></limitmin>
     <limitmax><pointini x="-0.1" y="-0.1" z="-0.1"/>
     <pointend x="1.1" y="1.1" z="1.1"/></limitmax></dampingbox>
    <dampingcylinder><point1 x="2" y="0" z="0"/><point2 x="2" y="0" z="1"/>
     <limitmin radius="0.2"/><limitmax radius="0.4"/></dampingcylinder>
   </damping>"""),
        {"ext.csv": "fmtversion;grid_dpx;grid_dpz;grid_nx;grid_nz;vars\n"
                    "1;0.5;0.1;2;3;velx\n0.0;1;1;1;1;1;1\n"
                    "9.9;2;2;2;2;2;2\n"}),
    # a floating box with its initial velocity and the run's channels:
    # mDBC walls, FtSaveMotion, SaveDt, a timeout table, PartsOutMax
    "floating_mdbc": (xml("""
    <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right</boxfill>
     <point x="0" y="0" z="0"/><size x="1" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="0.9" y="0" z="0.3"/></drawbox>
    <setmkbound mk="5"/><drawbox><boxfill>solid</boxfill>
     <point x="0.4" y="0" z="0.3"/><size x="0.2" y="0" z="0.1"/></drawbox>
    <setmkbound mk="6"/><drawbox><boxfill>solid</boxfill>
     <point x="0.1" y="0" z="0.5"/><size x="0.1" y="0" z="0.1"/></drawbox>
    """, hswl=0, casedef="""
  <floatings>
   <floating mkbound="5"><rhopbody value="600"/>
    <linearvelini x="0.1" y="0" z="0"/><angularvelini x="0" y="0.5" z="0"/>
    <translationDOF x="1" y="0" z="1"/></floating>
   <floating mkbound="6" massbody="2.5"/>
   <floating mkbound="9"/>
  </floatings>""", special="""
   <savedt/>
   <timeout><tout time="0" timeout="0.01"/><tout time="0.05" timeout="0.02"/>
   </timeout>""", params="""
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
   <parameter key="Boundary" value="2"/><parameter key="SlipMode" value="2"/>
   <parameter key="FtSaveMotion" value="0.005"/>
   <parameter key="PartsOutMax" value="0.5"/>
   <parameter key="StepAlgorithm" value="2"/>
   <parameter key="VerletSteps" value="30"/>
   <parameter key="Kernel" value="1"/><parameter key="Shifting" value="2"/>
   <parameter key="ViscoTreatment" value="2"/>
   <parameter key="ViscoTime" value="visco.csv"/>
   <parameter key="RigidAlgorithm" value="1"/>"""),
        {"visco.csv": "0.0 0.001\n0.5 0.002\n"}),
    # <special><initialize>: a linear velocity profile and wall normals
    # from a plane and from the particles, which make the walls mDBC
    "initialize": (xml(_TANK.format(w=1, f=0.35), special="""
   <initialize>
    <fluidvelocity mkfluid="0"><direction x="1" y="0" z="0"/>
     <velocity2 v="0.2" v2="0.6" z="0.05" z2="0.35"/></fluidvelocity>
    <boundnormal_plane mkbound="0"><point auto="true"/>
     <normal x="0" y="0" z="1"/></boundnormal_plane>
    <boundnormal_parts mkbound="0"><onlypos><posmin x="0.8" y="-1" z="-1"/>
     </onlypos></boundnormal_parts>
   </initialize>"""), {}),
    # two phases with the NN keys (the mphase examples' 01_WetDambreak)
    "nnphases": (xml("""
    <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right</boxfill>
     <point x="0" y="0" z="0"/><size x="2" y="0" z="1"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="1.9" y="0" z="0.15"/></drawbox>
    <setmkfluid mk="1"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="0.5" y="0" z="0.3"/></drawbox>
    """, hi=(2, 0, 1), hswl=0, special="""
   <nnphases>
    <!---Phase 1--->
    <phase mkfluid="1"><rhop value="1500"/><visco value="0.1"/>
     <tau_yield value="0.001"/><HBP_m value="10"/>
     <HBP_n value="1" comment="<1 for shear thinning"/></phase>
    <phase mkfluid="0"><rhop value="1000"/><visco value="0.001"/>
     <csound value="30"/><gamma value="7"/></phase>
   </nnphases>""", params="""
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
   <parameter key="VelocityGradientType" value="2"/>
   <parameter key="RelaxationDt" value="0.25"/>
   <parameter key="ViscoTreatment" value="3"/>
   <parameter key="DensityDT" value="2"/>"""), {}),
}


def write_case(tmp_path, name):
    text, files = FIXTURES[name]
    for fn, content in files.items():
        if callable(content):
            content(tmp_path / fn)
        else:
            (tmp_path / fn).write_text(content)
    p = tmp_path / f"{name}_Def.xml"
    p.write_text(text)
    return str(p)


def _name(v):
    return v.name if hasattr(v, "name") else v


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_states_equal(j, p):
    pos_j = np.asarray(j.pos, np.float32)
    np.testing.assert_array_equal(host(p.idp), np.asarray(j.idp, np.int64))
    np.testing.assert_array_equal(host(p.pos).view(np.uint32),
                                  pos_j.view(np.uint32))
    np.testing.assert_array_equal(host(p.code), np.asarray(j.code, np.int64))
    np.testing.assert_array_equal(host(p.rho), np.asarray(j.rho, np.float32))
    np.testing.assert_array_equal(host(p.vel), np.asarray(j.vel, np.float32))
    for k in ("velm1", "rhom1", "spstau", "motionvel"):
        a, b = getattr(j, k), getattr(p, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(host(b), np.asarray(a), err_msg=k)
    assert (j.boundnormal is None) == (p.boundnormal is None)
    if j.boundnormal is not None:
        np.testing.assert_allclose(host(p.boundnormal),
                                   np.asarray(j.boundnormal), atol=1e-6)
    assert (j.ft is None) == (p.ft is None)
    if j.ft is not None:
        for k in ("center", "fvel", "fomega", "angles"):
            np.testing.assert_array_equal(host(getattr(p.ft, k)),
                                          np.asarray(getattr(j.ft, k)),
                                          err_msg=k)


def assert_loads_equal(jres, pres):
    (jc, jo, jr), (pc, po, pr) = jres, pres
    assert convert.ctesph(dataclasses.asdict(jc.csp)) == pc.csp
    for f in dataclasses.fields(po):
        assert _name(getattr(po, f.name)) == _name(getattr(jo, f.name)), \
            f.name
    assert convert.domain(dataclasses.asdict(jc.dom)) == pc.dom
    assert (pc.npb, pc.np_total) == (jc.npb, jc.np_total)
    assert_states_equal(jc.state, pc.state)
    assert pr == jr
    jm, pm = jc.meta, pc.meta
    assert set(pm) == set(jm)
    for k in ("name", "dp", "zsurf", "gauge_windows", "gauge_computedts",
              "cellsout"):
        assert pm[k] == jm[k], k
    assert pm["gauges"] == tuple(convert.feature(g) for g in jm["gauges"])
    assert (pm["phases"] is None) == (jm["phases"] is None)
    if jm["phases"] is not None:
        assert pm["phases"] == convert.phasecfg(jm["phases"])
    assert (pm["features"] is None) == (jm["features"] is None)
    if jm["features"] is not None:
        jf = jm["features"]
        want = dataclasses.replace(convert.features(jf), viscotime=None)
        assert dataclasses.replace(pm["features"], viscotime=None) == want
        jv, pv = jf.viscotime, pm["features"].viscotime
        assert (jv is None) == (pv is None)
        if jv is not None:
            assert (pv.times, pv.values) == (tuple(jv.times),
                                             tuple(jv.values))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_loader_matches_jax(name, tmp_path):
    path = write_case(tmp_path, name)
    assert_loads_equal(jX.load_case(path), X.load_case(path, device="cpu"))


def test_mdbc_argument_draws_the_normals(tmp_path):
    """``load_case(mdbc=True)`` gives a DBC case the drawn faces' normals
    and mDBC walls, as JAX's does."""
    path = write_case(tmp_path, "rotated_boxes")
    pres = X.load_case(path, mdbc=True, device="cpu")
    assert_loads_equal(jX.load_case(path, mdbc=True), pres)
    assert pres[1].tboundary == td.TpBoundary.MDBC
    assert float(pres[0].state.boundnormal.abs().max()) > 0


def test_xml_dambreak_draws_the_builtin(tmp_path):
    """The dam break's three boxes in XML (CaseDambreak_Def.xml) give
    ``cases.dambreak3d(obstacle=True)``'s particles with their codes and
    densities, and its constants.  The ids differ: the loader gives each
    (type, mk) one id block, as GenCase does, where the builtin numbers
    the tank and the obstacle together, so the rows are compared sorted."""
    dp = 0.04
    p = tmp_path / "Dambreak_Def.xml"
    p.write_text(xml("""
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0" y="0" z="0"/><size x="0.4" y="0.67" z="0.3"/></drawbox>
    <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right|front|back</boxfill>
     <point x="0" y="0" z="0"/><size x="1.6" y="0.67" z="0.4"/></drawbox>
    <setmkbound mk="1"/><drawbox><boxfill>top|left|right|front|back</boxfill>
     <point x="0.9" y="0.24" z="0"/><size x="0.12" y="0.12" z="0.45"/></drawbox>
    """, dp=dp, lo=(-0.05, -0.05, -0.05), hi=(2, 0.7, 1), hswl=0.3, params="""
   <parameter key="Visco" value="0.1"/><parameter key="DensityDT" value="2"/>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
    """))
    case, opts, _run = X.load_case(str(p), device="cpu")
    ref = cases.dambreak3d(dp=dp, device="cpu")
    assert case.np_total == ref.np_total and case.npb == ref.npb

    def rows(st):
        r = np.column_stack([host(st.pos), host(st.code), host(st.rho)])
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_array_equal(rows(case.state), rows(ref.state))
    assert dataclasses.replace(case.csp, dtini=ref.csp.dtini,
                               dtmin=ref.csp.dtmin) == ref.csp
    assert opts.tdensity == td.TpDensity.FOURTAKAS


_REFUSED = {
    # a zone whose geometry the loader does not read (the JAX loader drops
    # it and runs without it)
    "inout": ("<special><inout>", dict(
        special="<inout><inoutzone/></inout>")),
    # <chrono> without floating bodies builds nothing, as in JAX (the
    # couplings: test_torch_couplings.py)
    "chrono": (None, dict(special="<chrono/>")),
    # <moorings> needs floating bodies: JAX's ValueError
    "moorings": ("<moorings> needs floating bodies",
                 dict(special="<moorings/>")),
    # RigidAlgorithm=2 runs DEM contact on the floating floor
    "dem": (None, dict(
        casedef='<floatings><floating mkbound="0"/></floatings>',
        params='<parameter key="RigidAlgorithm" value="2"/>' + _TIMES)),
    # the symmetry plane runs in 3D only (test_torch_symmetry.py): this
    # tank is 2D, which the loader refuses as JAX's does
    "symmetry": ("Symmetry is not allowed with 2-D", dict(
        params='<parameter key="Symmetry" value="1"/>' + _TIMES)),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_refused_nodes_name_themselves(name, tmp_path):
    """The nodes the loader refuses name themselves (``<inout>`` zones it
    cannot read, JAX's ValueErrors); the nodes it once refused load as
    JAX's loader loads them."""
    node, kw = _REFUSED[name]
    p = tmp_path / "refused_Def.xml"
    p.write_text(xml(_TANK.format(w=1, f=0.35), **kw))
    if node is None:
        jres, pres = jX.load_case(str(p)), X.load_case(str(p), device="cpu")
        jf, pf = jres[0].meta["features"], pres[0].meta["features"]
        if name == "dem":
            assert pf.dem is not None
            want = convert.demcfg(jf.dem, np.asarray(jres[0].state.idp))
            for f in dataclasses.fields(want):
                np.testing.assert_array_equal(getattr(pf.dem, f.name),
                                              getattr(want, f.name))
            jres[0].meta["features"] = dataclasses.replace(jf, dem=None)
            pres[0].meta["features"] = dataclasses.replace(pf, dem=None)
        assert_loads_equal(jres, pres)
        return
    error = NotImplementedError if name == "inout" else ValueError
    with pytest.raises(error, match=node):
        X.load_case(str(p), device="cpu")


def test_initialize_gives_velocity_normals_and_mdbc(tmp_path):
    """The ``initialize`` fixture's operations reach the state: the fluid
    moves at 0.2-0.6 m/s along x and the walls carry normals, so the
    walls are mDBC (the loads equal JAX's: test_loader_matches_jax)."""
    case, opts, _ = X.load_case(write_case(tmp_path, "initialize"),
                                device="cpu")
    st = case.state
    fluid = td.is_fluid(st.code)
    vx = st.vel[fluid, 0]
    assert float(vx.min()) >= 0.2 - 1e-6 and float(vx.max()) <= 0.6 + 1e-6
    assert not st.vel[fluid, 1:].any()
    assert opts.tboundary == td.TpBoundary.MDBC
    walls = td.is_bound(st.code)
    assert bool((st.boundnormal[walls].norm(dim=1) > 0).all())
