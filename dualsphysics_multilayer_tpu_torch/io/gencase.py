"""GenCase's writer: a built case as ``<case>.bi4`` and ``<case>.xml``.

Counterpart of `dualsphysics_multilayer_tpu/io/gencase.py`.  The reference
ships GenCase only as a closed binary, yet its solver reads GenCase's two
outputs: ``<case>.bi4`` (the initial particles, `JPartDataBi4` layout)
and ``<case>.xml`` (the run XML, `<execution><constants>/<parameters>/
<particles>`; readers `JCaseCtes::ReadXmlRun` JCaseCtes.cpp:201 and
`JCaseParts::ReadXml` JCaseParts.cpp:484).  :func:`write_case` writes
both from the port's ``Case``, whose torch state it copies to the host
once; the files are those of the JAX package's writer.
"""

from __future__ import annotations

import datetime
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from .. import typesdef as td
from . import jbinary as jb

MKBOUNDFIRST = 11   # GenCase mk offsets (JSphMk defaults)
MKFLUIDFIRST = 1


def _blocks(code):
    """Contiguous (tag, mktype, begin, count) blocks in canonical id order
    (Draw.build orders fixed < moving < floating < fluid)."""
    ctype = np.asarray(td.code_type(code))
    cval = np.asarray(td.code_value(code))
    tags = {td.TYPE_FIXED: "fixed", td.TYPE_MOVING: "moving",
            td.TYPE_FLOATING: "floating", td.TYPE_FLUID: "fluid"}
    out = []
    i, n = 0, len(code)
    while i < n:
        j = i
        while j < n and ctype[j] == ctype[i] and cval[j] == cval[i]:
            j += 1
        out.append((tags[int(ctype[i])], int(cval[i]), i, j - i))
        i = j
    return out


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def write_case(case, outdir, casename, *, params=None):
    """Write ``<casename>.bi4`` + ``<casename>.xml`` for a built Case (its
    state on any device).  Returns the two paths."""
    os.makedirs(outdir, exist_ok=True)
    csp = case.csp
    st = case.state
    code = _host(st.code).astype(np.uint32)
    live = td.is_active(code)
    pos = _host(st.pos)[live]
    vel = _host(st.vel)[live]
    rho = _host(st.rho)[live]
    idp = _host(st.idp)[live]
    order = np.argsort(idp)
    pos, vel, rho, idp = pos[order], vel[order], rho[order], idp[order]
    codes = code[live][order]
    n = len(pos)

    # ---- <casename>.bi4 ------------------------------------------------------
    root = jb.JItem(name="JPartDataBi4")
    root.set_uint("Piece", 0)
    root.set_uint("Npiece", 1)
    root.set_text("RunCode", "gencase-tpu")
    root.set_text("Date", datetime.datetime.now().isoformat(" ")[:19])
    root.set_text("AppName", "dualsphysics_multilayer_tpu GenCase")
    root.set_text("CaseName", casename)
    root.set_bool("Data2d", csp.simulate2d)
    root.set_double("Data2dPosY", float(pos[0, 1]) if csp.simulate2d else 0.0)
    root.set_double3("MapPosMin", (0.0, 0.0, 0.0))
    root.set_double3("MapPosMax", (0.0, 0.0, 0.0))
    root.set_int("PeriMode", 0)
    root.set_double3("PeriXinc", (0, 0, 0))
    root.set_double3("PeriYinc", (0, 0, 0))
    root.set_double3("PeriZinc", (0, 0, 0))
    root.set_int("AxisDiv", 0)
    ctype = np.asarray(td.code_type(codes))
    counts = dict(
        CaseNp=n,
        CaseNfixed=int((ctype == td.TYPE_FIXED).sum()),
        CaseNmoving=int((ctype == td.TYPE_MOVING).sum()),
        CaseNfloat=int((ctype == td.TYPE_FLOATING).sum()),
        CaseNfluid=int((ctype == td.TYPE_FLUID).sum()))
    for k, v in counts.items():
        root.set_ullong(k, v)
    root.set_double3("CasePosMin", tuple(pos.min(0)))
    root.set_double3("CasePosMax", tuple(pos.max(0)))
    root.set_bool("NpDynamic", False)
    root.set_bool("ReuseIds", False)
    root.set_bool("Symmetry", False)
    root.set_bool("Splitting", False)
    root.set_double("Dp", csp.dp)
    root.set_double("H", csp.kernelh)
    root.set_double("B", csp.cteb)
    root.set_double("Rhop0", csp.rhopzero)
    root.set_double("Gamma", csp.gamma)
    root.set_double("MassBound", csp.massbound)
    root.set_double("MassFluid", csp.massfluid)
    part = root.child("PART_0000")
    part.set_uint("Cpart", 0)
    part.set_double("TimeStep", 0.0)
    part.set_uint("Npok", n)
    part.set_uint("Nout", 0)
    part.set_uint("Step", 0)
    part.set_double("RunTime", 0.0)
    part.set_double3("DomainMin", tuple(pos.min(0)))
    part.set_double3("DomainMax", tuple(pos.max(0)))
    part.add_array("Idp", jb.UINT, idp.astype(np.uint32))
    part.add_array("Posd", jb.DOUBLE3, pos.astype(np.float64))
    part.add_array("Vel", jb.FLOAT3, vel.astype(np.float32))
    part.add_array("Rhop", jb.FLOAT, rho.astype(np.float32))
    bi4path = os.path.join(outdir, f"{casename}.bi4")
    jb.write_file(bi4path, root, filecode="JPartDataBi4")

    # ---- <casename>.xml ------------------------------------------------------
    case_el = ET.Element("case")
    case_el.set("app", "dualsphysics_multilayer_tpu GenCase")
    case_el.set("date", datetime.datetime.now().isoformat(" ")[:19])
    execu = ET.SubElement(case_el, "execution")
    ctes = ET.SubElement(execu, "constants")

    def val(tag, v, attr="value"):
        e = ET.SubElement(ctes, tag)
        e.set(attr, repr(float(v)) if isinstance(v, float) else str(v))
        return e

    val("data2d", str(bool(csp.simulate2d)).lower())
    val("data2dposy", float(pos[0, 1]) if csp.simulate2d else 0.0)
    g = ET.SubElement(ctes, "gravity")
    for a, v in zip("xyz", csp.gravity):
        g.set(a, repr(float(v)))
    val("cflnumber", csp.cflnumber)
    val("gamma", csp.gamma)
    val("rhop0", csp.rhopzero)
    val("eps", 0.0)
    val("dp", csp.dp)
    val("h", f"{csp.kernelh:.10E}")
    val("b", f"{csp.cteb:.10E}")
    val("massbound", f"{csp.massbound:.10E}")
    val("massfluid", f"{csp.massfluid:.10E}")

    parms = ET.SubElement(execu, "parameters")
    for key, value in (params or {}).items():
        e = ET.SubElement(parms, "parameter")
        e.set("key", key)
        e.set("value", str(value))

    parts = ET.SubElement(execu, "particles")
    parts.set("np", str(n))
    parts.set("nb", str(n - counts["CaseNfluid"]))
    parts.set("nbf", str(counts["CaseNfixed"]))
    parts.set("mkboundfirst", str(MKBOUNDFIRST))
    parts.set("mkfluidfirst", str(MKFLUIDFIRST))
    feats = case.meta.get("features")
    ftcfg = getattr(feats, "floating", None) if feats is not None else None
    if ftcfg is None:
        ftcfg = case.meta.get("ftcfg")
    ftst = st.ft

    nmoving = 0
    for tag, mk, begin, cnt in _blocks(codes):
        e = ET.SubElement(parts, tag)
        mkout = mk
        if tag == "floating" and ftcfg is not None \
                and getattr(ftcfg, "mkbound", ()) and mk < len(ftcfg.mkbound):
            # floating typecode value is the body INDEX; export the body's
            # source mkbound so blocks keep distinct mks
            mkout = int(ftcfg.mkbound[mk])
        e.set("mkfluid" if tag == "fluid" else "mkbound", str(mkout))
        e.set("begin", str(begin))
        e.set("count", str(cnt))
        if tag == "moving":
            # motion-object index the solver pairs with <motion> objreal
            # refs (JCasePartBlock_Moving::RefMotion, JCaseParts.cpp:177)
            e.set("refmotion", str(nmoving))
            nmoving += 1
        elif tag == "floating" and ftcfg is not None and ftst is not None:
            # rigid-body data the solver's loader requires
            # (JCasePartBlock_Floating::ReadXml, JCaseParts.cpp:200+);
            # floating typecode value == body index
            b = mk
            ET.SubElement(e, "massbody").set(
                "value", f"{float(ftcfg.mass[b]):.10E}")
            ET.SubElement(e, "masspart").set(
                "value", f"{float(ftcfg.massp[b]):.10E}")
            cen = ET.SubElement(e, "center")
            cvals = _host(ftst.center)[b]
            for a, v in zip("xyz", cvals):
                cen.set(a, f"{float(v):.10E}")
            I = np.asarray(ftcfg.inertia0).reshape(-1, 9)[b].reshape(3, 3)
            ine = ET.SubElement(e, "inertia")
            if abs(I[0, 1]) + abs(I[0, 2]) + abs(I[1, 2]) < 1e-12:
                for a, v in zip("xyz", np.diag(I)):
                    ine.set(a, f"{float(v):.10E}")
            else:
                for r in range(3):
                    row = ET.SubElement(ine, f"values{r + 1}")
                    for ci, a in enumerate(("x", "y", "z")):
                        row.set(a, f"{float(I[r, ci]):.10E}")
            if ftcfg.translation_dof:
                td3 = np.asarray(ftcfg.translation_dof).reshape(-1, 3)[b]
                el = ET.SubElement(e, "translationDOF")
                for a, v in zip("xyz", td3):
                    el.set(a, str(int(v)))
            if ftcfg.rotation_dof:
                rd3 = np.asarray(ftcfg.rotation_dof).reshape(-1, 3)[b]
                el = ET.SubElement(e, "rotationDOF")
                for a, v in zip("xyz", rd3):
                    el.set(a, str(int(v)))

    xmlpath = os.path.join(outdir, f"{casename}.xml")
    ET.indent(case_el)
    ET.ElementTree(case_el).write(xmlpath, xml_declaration=True,
                                  encoding="UTF-8")
    return bi4path, xmlpath
