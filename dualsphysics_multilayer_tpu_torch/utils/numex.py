"""XML arithmetic-expression evaluator — the JNumexLib replacement.

Counterpart of `dualsphysics_multilayer_tpu/utils/numex.py`, copied: it is
pure Python, and the port keeps its own copy because importing the JAX
package's module loads JAX.

Reference: the closed `libjnumexlib` evaluates XML attribute values starting
with ``#`` (numeric expressions, `JXml.cpp:578-615`) or ``$`` (string
expressions, `:470`), over a variable table of user variables
(`<case><execution><uservars>` ``<varnum>``/``<varstr>``, JCaseUserVars) plus
case constants registered by `JSph::LoadConfigVars` (`JSph.cpp:869-902`:
CaseName, Data2D, Data2DPosy, H, KernelSize, B, Gamma, Rhop0, Dp, Gravity,
MassFluid, MassBound; later TimeMax/TimeOut).

This implementation parses with Python's ``ast`` restricted to arithmetic
nodes — no attribute access, no calls except a whitelist of math functions —
so XML content can never execute arbitrary code.
"""

from __future__ import annotations

import ast
import math


_FUNCS = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "asin": math.asin, "acos": math.acos, "atan": math.atan,
    "atan2": math.atan2, "sinh": math.sinh, "cosh": math.cosh,
    "tanh": math.tanh, "sqrt": math.sqrt, "abs": abs, "fabs": abs,
    "exp": math.exp, "log": math.log, "log10": math.log10,
    "pow": math.pow, "min": min, "max": max, "floor": math.floor,
    "ceil": math.ceil, "round": round, "int": int,
    "radians": math.radians, "degrees": math.degrees,
}
_CONSTS = {"pi": math.pi, "PI": math.pi, "e": math.e}

_ALLOWED = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Name,
            ast.Call, ast.Compare, ast.BoolOp, ast.IfExp, ast.Load,
            ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow,
            ast.FloorDiv, ast.USub, ast.UAdd, ast.Not,
            ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
            ast.And, ast.Or)


class NumexVars:
    """Variable table + safe evaluator (JNumexLib::CreateVar/ComputeExpr)."""

    def __init__(self, initial=None):
        self.vars = dict(initial or {})

    def set(self, name, value):
        self.vars[name] = value

    def compute(self, expr: str) -> float:
        """Evaluate a ``#``-style numeric expression (marker already
        stripped).  ``^`` means power, as in the reference's syntax."""
        src = expr.strip().replace("^", "**")
        try:
            tree = ast.parse(src, mode="eval")
        except SyntaxError as e:
            raise ValueError(f"bad XML expression {expr!r}: {e}") from None
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED):
                raise ValueError(
                    f"disallowed construct {type(node).__name__} in XML "
                    f"expression {expr!r}")
            if isinstance(node, ast.Call):
                if not (isinstance(node.func, ast.Name)
                        and node.func.id in _FUNCS):
                    raise ValueError(
                        f"unknown function in XML expression {expr!r}")
        names = {**_CONSTS, **_FUNCS, **self.vars}
        try:
            val = eval(compile(tree, "<numex>", "eval"),
                       {"__builtins__": {}}, names)
        except NameError as e:
            raise ValueError(f"unknown variable in XML expression {expr!r}: "
                             f"{e}") from None
        return float(val)

    def value(self, raw):
        """Attribute-value hook: evaluate '#expr' (JXml numeric read), look
        up '$var' (string read), pass plain values through."""
        if isinstance(raw, str) and raw[:1] == "#":
            return self.compute(raw[1:])
        if isinstance(raw, str) and raw[:1] == "$":
            return self.vars.get(raw[1:].strip(), raw)
        return raw


def load_uservars(root, vars_: NumexVars):
    """Read <case><execution><uservars> varnum/varstr items (JCaseUserVars::
    ReadXml); varnum values may themselves be expressions over earlier vars."""
    node = root.find(".//execution/uservars")
    if node is None:
        return vars_
    for el in node:
        name = el.get("name")
        if name is None:
            continue
        raw = el.get("value", "0")
        if el.tag == "varstr":
            vars_.set(name, raw)
        else:
            try:
                vars_.set(name, float(raw))
            except ValueError:
                vars_.set(name, vars_.compute(raw.lstrip("#")))
    return vars_


def case_vars(csp, casename="case") -> NumexVars:
    """The constant table of JSph::LoadConfigVars (JSph.cpp:884-896)."""
    return NumexVars({
        "CaseName": casename,
        "Data2D": 1.0 if csp.simulate2d else 0.0,
        "Data2DPosy": 0.0,
        "H": csp.kernelh,
        "KernelSize": csp.kernelsize,
        "B": csp.cteb,
        "Gamma": csp.gamma,
        "Rhop0": csp.rhopzero,
        "Dp": csp.dp,
        "Gravity": csp.gravity[2],
        "MassFluid": csp.massfluid,
        "MassBound": csp.massbound,
    })
