"""JBinaryData-compatible self-describing binary container (.bi4 family).

Counterpart of `dualsphysics_multilayer_tpu/io/jbinary.py`, whose
pure-Python writer and reader it copies (and, as there, a C++ writer of
the same bytes, ``native/``, by default): the base of every DualSPHysics
particle-data file (PART .bi4, Part_Head.ibi4, PartOut .obi4, PartFloat
.fbi4): a 64-byte header ("#FileJBD <filecode>") followed by a tree of items,
each carrying named typed values and typed arrays.  Files written here are
byte-equal to the JAX package's on equal trees.

Wire format (little-endian):
  file   := head(64) item
  head   := titu[60] byteorder(u8) pad[3]        (titu = "#FileJBD <code>",
             space-padded to col 58, titu[58]='\\n')
  item   := u32 size_of_itembase itembase values arrays... subitems...
  itembase := str("\\nITEM\\n") str(name) bool(hide) bool(hidevalues)
             str(fmtfloat) str(fmtdouble) u32 narrays u32 nitems
             u32 size_of_values
  values := str("\\nVALUES") u32 num { str(name) i32 type payload }*
  array  := u32 size_of_arraybase arraybase data
  arraybase := str("\\nARRAY") str(name) bool(hide) i32 type u32 count
             u32 size_of_data
  str    := u32 len bytes
  bool   := i32 (0/1)

Type codes (JBinaryDataDef::TpData, JBinaryData.h:72-76): text=1 bool=2
char=3 uchar=4 short=5 ushort=6 int=7 uint=8 llong=9 ullong=10 float=11
double=12 int3=20 uint3=21 float3=22 double3=23.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

CODE_ITEM = b"\nITEM\n"
CODE_VALUES = b"\nVALUES"
CODE_ARRAY = b"\nARRAY"

# TpData codes
TEXT, BOOL, CHAR, UCHAR = 1, 2, 3, 4
SHORT, USHORT, INT, UINT, LLONG, ULLONG = 5, 6, 7, 8, 9, 10
FLOAT, DOUBLE = 11, 12
INT3, UINT3, FLOAT3, DOUBLE3 = 20, 21, 22, 23

_SCALAR_FMT = {BOOL: "<i", CHAR: "<b", UCHAR: "<B", SHORT: "<h", USHORT: "<H",
               INT: "<i", UINT: "<I", LLONG: "<q", ULLONG: "<Q",
               FLOAT: "<f", DOUBLE: "<d"}
_TRIPLE_FMT = {INT3: "<3i", UINT3: "<3I", FLOAT3: "<3f", DOUBLE3: "<3d"}
_NP_DTYPE = {CHAR: np.int8, UCHAR: np.uint8, SHORT: np.int16,
             USHORT: np.uint16, INT: np.int32, UINT: np.uint32,
             LLONG: np.int64, ULLONG: np.uint64, FLOAT: np.float32,
             DOUBLE: np.float64, INT3: np.int32, UINT3: np.uint32,
             FLOAT3: np.float32, DOUBLE3: np.float64}


@dataclass
class JArray:
    name: str
    type: int
    data: np.ndarray       # triples stored as (count, 3)

    @property
    def count(self):
        return len(self.data)


@dataclass
class JItem:
    """One node of the tree: named values + arrays + child items."""
    name: str
    values: dict = field(default_factory=dict)   # name -> (type, value)
    arrays: list = field(default_factory=list)
    items: list = field(default_factory=list)
    fmtfloat: str = "%15.7E"
    fmtdouble: str = "%20.12E"

    # ---- convenience setters (the SetvXxx API of the reference) ----------
    def set(self, name, type_, value):
        self.values[name] = (type_, value)
        return self

    def set_uint(self, n, v):
        return self.set(n, UINT, int(v))

    def set_ullong(self, n, v):
        return self.set(n, ULLONG, int(v))

    def set_int(self, n, v):
        return self.set(n, INT, int(v))

    def set_bool(self, n, v):
        return self.set(n, BOOL, bool(v))

    def set_text(self, n, v):
        return self.set(n, TEXT, str(v))

    def set_float(self, n, v):
        return self.set(n, FLOAT, float(v))

    def set_double(self, n, v):
        return self.set(n, DOUBLE, float(v))

    def set_double3(self, n, v):
        return self.set(n, DOUBLE3, tuple(float(x) for x in v))

    def set_uint3(self, n, v):
        return self.set(n, UINT3, tuple(int(x) for x in v))

    def get(self, name, default=None):
        v = self.values.get(name)
        return default if v is None else v[1]

    def add_array(self, name, type_, data):
        self.arrays.append(JArray(name=name, type=type_,
                                  data=np.ascontiguousarray(data)))
        return self

    def child(self, name):
        it = JItem(name=name)
        self.items.append(it)
        return it

    def find(self, name):
        for it in self.items:
            if it.name == name:
                return it
        return None

    def array(self, name):
        for a in self.arrays:
            if a.name == name:
                return a
        return None


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _w_str(out, s):
    b = s if isinstance(s, bytes) else s.encode()
    out.append(struct.pack("<I", len(b)))
    out.append(b)


def _w_value(out, name, type_, value):
    _w_str(out, name)
    out.append(struct.pack("<i", type_))
    if type_ == TEXT:
        _w_str(out, value)
    elif type_ in _SCALAR_FMT:
        v = int(value) if type_ != FLOAT and type_ != DOUBLE else value
        out.append(struct.pack(_SCALAR_FMT[type_],
                               (1 if value else 0) if type_ == BOOL else v))
    elif type_ in _TRIPLE_FMT:
        out.append(struct.pack(_TRIPLE_FMT[type_], *value))
    else:
        raise ValueError(f"bad value type {type_}")


def _values_blob(item: JItem) -> bytes:
    out = []
    _w_str(out, CODE_VALUES)
    out.append(struct.pack("<I", len(item.values)))
    for name, (t, v) in item.values.items():
        _w_value(out, name, t, v)
    return b"".join(out)


def _itembase_blob(item: JItem, values_size: int) -> bytes:
    out = []
    _w_str(out, CODE_ITEM)
    _w_str(out, item.name)
    out.append(struct.pack("<i", 0))   # hide
    out.append(struct.pack("<i", 0))   # hidevalues
    _w_str(out, item.fmtfloat)
    _w_str(out, item.fmtdouble)
    out.append(struct.pack("<I", len(item.arrays)))
    out.append(struct.pack("<I", len(item.items)))
    out.append(struct.pack("<I", values_size))
    return b"".join(out)


def _array_head(ar: JArray, nbytes: int) -> bytes:
    base = []
    _w_str(base, CODE_ARRAY)
    _w_str(base, ar.name)
    base.append(struct.pack("<i", 0))          # hide
    base.append(struct.pack("<i", ar.type))
    base.append(struct.pack("<I", ar.count))
    base.append(struct.pack("<I", nbytes))
    base_b = b"".join(base)
    return struct.pack("<I", len(base_b)) + base_b


def _write_item(f, item: JItem):
    """Stream ``item`` to the open file ``f``: its heads, then each
    array's buffer as it is (no copy unless its type needs a cast)."""
    values = _values_blob(item)
    base = _itembase_blob(item, len(values))
    f.write(struct.pack("<I", len(base)) + base + values)
    for ar in item.arrays:
        data = np.ascontiguousarray(
            np.ascontiguousarray(ar.data).astype(_NP_DTYPE[ar.type],
                                                 copy=False))
        f.write(_array_head(ar, data.nbytes))
        f.write(memoryview(data).cast("B"))
    for it in item.items:
        _write_item(f, it)


# an array's count and byte size and an item's counts are uint32 fields
U32_MAX = 0xFFFFFFFF


def check_sizes(root: JItem) -> None:
    """Raise ValueError, naming the limit, when a count or byte size in the
    tree ``root`` does not fit the format's 32-bit unsigned fields: each
    array's count and bytes, each item's arrays, items and values."""
    stack = [root]
    while stack:
        item = stack.pop()
        sizes = [(f"item {item.name}: {k}", len(v)) for k, v in (
            ("arrays", item.arrays), ("items", item.items),
            ("values", item.values))]
        for ar in item.arrays:
            nbytes = ar.data.size * np.dtype(
                _NP_DTYPE.get(ar.type, np.uint8)).itemsize
            sizes += [(f"array {ar.name}: count", ar.count),
                      (f"array {ar.name}: bytes", nbytes)]
        for what, n in sizes:
            if n > U32_MAX:
                raise ValueError(f"{what} {n} exceeds the .bi4 format's "
                                 f"32-bit field (at most {U32_MAX})")
        stack.extend(item.items)


def write_file(path, root: JItem, filecode=None, native=True):
    """Write the tree ``root`` as a .bi4 file of ``filecode`` (the root's
    name by default): through the port's C++ writer (``native/``, built
    with g++ at first use; a failed build or write raises), or with
    ``native=False`` through the pure writer below, which streams each
    array's buffer to the file, byte for byte the same file.  A tree whose
    sizes the format cannot hold raises before the file is made
    (:func:`check_sizes`)."""
    check_sizes(root)
    if native:
        from ..native import write_item
        write_item(path, root, filecode)
        return
    filecode = filecode or root.name
    titu = ("#FileJBD " + filecode)[:58].ljust(58) + "\n"
    head = titu.encode() + b"\x00" + bytes([0, 0, 0, 0])
    assert len(head) == 64
    with open(path, "wb") as f:
        f.write(head)
        _write_item(f, root)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.off = 0

    def u32(self):
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def i32(self):
        v = struct.unpack_from("<i", self.buf, self.off)[0]
        self.off += 4
        return v

    def raw(self, n):
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def s(self):
        return self.raw(self.u32())

    def value(self):
        name = self.s().decode()
        t = self.i32()
        if t == TEXT:
            v = self.s().decode()
        elif t in _SCALAR_FMT:
            fmt = _SCALAR_FMT[t]
            v = struct.unpack_from(fmt, self.buf, self.off)[0]
            self.off += struct.calcsize(fmt)
            if t == BOOL:
                v = bool(v)
        elif t in _TRIPLE_FMT:
            fmt = _TRIPLE_FMT[t]
            v = struct.unpack_from(fmt, self.buf, self.off)
            self.off += struct.calcsize(fmt)
        else:
            raise ValueError(f"bad value type {t} for {name}")
        return name, t, v

    def item(self) -> JItem:
        self.u32()                       # size of itembase
        assert self.s() == CODE_ITEM, "bad item code"
        name = self.s().decode()
        self.i32()                       # hide
        self.i32()                       # hidevalues
        fmtf = self.s().decode()
        fmtd = self.s().decode()
        narrays = self.u32()
        nitems = self.u32()
        vsize = self.u32()
        it = JItem(name=name, fmtfloat=fmtf, fmtdouble=fmtd)
        if vsize:
            assert self.s() == CODE_VALUES
            num = self.u32()
            for _ in range(num):
                nm, t, v = self.value()
                it.values[nm] = (t, v)
        for _ in range(narrays):
            self.u32()                   # size of arraybase
            assert self.s() == CODE_ARRAY
            aname = self.s().decode()
            self.i32()                   # hide
            atype = self.i32()
            count = self.u32()
            dsize = self.u32()
            raw = self.raw(dsize)
            if atype == TEXT:
                r2 = _Reader(raw)
                data = np.array([r2.s().decode() for _ in range(count)])
            else:
                data = np.frombuffer(raw, dtype=_NP_DTYPE[atype])
                if atype in _TRIPLE_FMT:
                    data = data.reshape(count, 3)
            it.arrays.append(JArray(name=aname, type=atype, data=data))
        for _ in range(nitems):
            it.items.append(self.item())
        return it


def read_file(path) -> JItem:
    with open(path, "rb") as f:
        buf = f.read()
    if not buf[:9] == b"#FileJBD ":
        raise ValueError(f"{path}: not a JBinaryData file")
    if buf[60] != 0:
        raise ValueError(f"{path}: big-endian files not supported")
    r = _Reader(buf)
    r.off = 64
    return r.item()
