// Native JBinaryData (.bi4) writer of the torch port: the PART write path.
//
// Counterpart of dualsphysics_multilayer_tpu/native/jbinary_native.cpp
// (the reference's JBinaryData.cpp serializer).  The JAX package's version
// copies every array into an in-memory tree and then into one buffer; this
// one streams: Python walks the tree depth first (io/jbinary.py's order),
// each item's header and values are buffered until its first array or
// child, and each array's bytes go from the caller's buffer straight to the
// file with one fwrite, without a copy.  The bytes are those of
// io/jbinary.py's pure writer.
//
// Format (io/jbinary.py's docstring): a 64-byte "#FileJBD <code>" head,
// then items, each  u32 size_of_itembase, itembase, values, arrays...,
// sub-items...; little-endian.
//
// C API (ctypes):
//   jbn_open(path, filecode) -> handle, or null if the file cannot be made
//   jbn_item(h, name, fmtfloat, fmtdouble, narrays, nitems)
//   jbn_text(h, name, text)
//   jbn_num(h, name, type, a, b, c)        float, double, float3, double3
//   jbn_int(h, name, type, a, b, c)        the integer and bool types
//   jbn_array(h, name, type, count, data, nbytes)
//   jbn_close(h) -> 0, or nonzero if a write or a call failed
//
// Build: g++ -std=c++17 -O2 -shared -fPIC (ops/cuda/build.py host_library).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum TpData : int32_t {
  DatText = 1, DatBool = 2, DatChar = 3, DatUchar = 4, DatShort = 5,
  DatUshort = 6, DatInt = 7, DatUint = 8, DatLlong = 9, DatUllong = 10,
  DatFloat = 11, DatDouble = 12,
  DatInt3 = 20, DatUint3 = 21, DatFloat3 = 22, DatDouble3 = 23,
};

struct Buf {
  std::vector<uint8_t> d;
  void raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    d.insert(d.end(), b, b + n);
  }
  template <typename T> void put(T v) { raw(&v, sizeof(T)); }
  void str(const char* s) {
    size_t n = strlen(s);
    put<uint32_t>(static_cast<uint32_t>(n));
    raw(s, n);
  }
};

struct Writer {
  FILE* f = nullptr;
  bool failed = false;
  bool pending = false;      // an item's header and values not yet written
  Buf base;                  // itembase without its size_of_values
  Buf values;                // "\nVALUES", count (patched), values
  uint32_t nvalues = 0;

  void write(const void* p, size_t n) {
    if (!failed && n && fwrite(p, 1, n, f) != n) failed = true;
  }

  // the pending item: u32 size_of_itembase, itembase, values
  void flush() {
    if (!pending) return;
    pending = false;
    memcpy(values.d.data() + 4 + 7, &nvalues, 4);
    base.put<uint32_t>(static_cast<uint32_t>(values.d.size()));
    uint32_t nb = static_cast<uint32_t>(base.d.size());
    write(&nb, 4);
    write(base.d.data(), base.d.size());
    write(values.d.data(), values.d.size());
  }

  // a value of the pending item: name and type, then the payload
  Buf* value(const char* name, int32_t type) {
    if (!pending) {
      failed = true;
      return nullptr;
    }
    nvalues++;
    values.str(name);
    values.put<int32_t>(type);
    return &values;
  }
};

}  // namespace

extern "C" {

void* jbn_open(const char* path, const char* filecode) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  // 64-byte head: "#FileJBD <code>" space-padded to column 58, '\n', then
  // the byte order (0) and 4 bytes of padding
  std::string titu = std::string("#FileJBD ") + filecode;
  titu.resize(58, ' ');
  titu += "\n";
  char head[64];
  memset(head, 0, sizeof(head));
  memcpy(head, titu.data(), 59);
  w->write(head, 64);
  return w;
}

int jbn_item(void* h, const char* name, const char* fmtfloat,
             const char* fmtdouble, unsigned narrays, unsigned nitems) {
  Writer* w = static_cast<Writer*>(h);
  w->flush();
  w->pending = true;
  w->base.d.clear();
  w->base.str("\nITEM\n");
  w->base.str(name);
  w->base.put<int32_t>(0);  // hide
  w->base.put<int32_t>(0);  // hidevalues
  w->base.str(fmtfloat);
  w->base.str(fmtdouble);
  w->base.put<uint32_t>(narrays);
  w->base.put<uint32_t>(nitems);
  w->values.d.clear();
  w->values.str("\nVALUES");
  w->values.put<uint32_t>(0);  // the count, patched by flush
  w->nvalues = 0;
  return 0;
}

int jbn_text(void* h, const char* name, const char* text) {
  Buf* b = static_cast<Writer*>(h)->value(name, DatText);
  if (!b) return 1;
  b->str(text);
  return 0;
}

int jbn_num(void* h, const char* name, int type, double a, double b,
            double c) {
  Buf* v = static_cast<Writer*>(h)->value(name, type);
  if (!v) return 1;
  const double x[3] = {a, b, c};
  switch (type) {
    case DatFloat: v->put<float>(static_cast<float>(a)); return 0;
    case DatDouble: v->put<double>(a); return 0;
    case DatFloat3:
      for (double e : x) v->put<float>(static_cast<float>(e));
      return 0;
    case DatDouble3:
      for (double e : x) v->put<double>(e);
      return 0;
  }
  static_cast<Writer*>(h)->failed = true;
  return 1;
}

int jbn_int(void* h, const char* name, int type, long long a, long long b,
            long long c) {
  Buf* v = static_cast<Writer*>(h)->value(name, type);
  if (!v) return 1;
  const long long x[3] = {a, b, c};
  switch (type) {
    case DatBool: case DatInt: v->put<int32_t>(static_cast<int32_t>(a));
      return 0;
    case DatChar: v->put<int8_t>(static_cast<int8_t>(a)); return 0;
    case DatUchar: v->put<uint8_t>(static_cast<uint8_t>(a)); return 0;
    case DatShort: v->put<int16_t>(static_cast<int16_t>(a)); return 0;
    case DatUshort: v->put<uint16_t>(static_cast<uint16_t>(a)); return 0;
    case DatUint: v->put<uint32_t>(static_cast<uint32_t>(a)); return 0;
    case DatLlong: v->put<int64_t>(static_cast<int64_t>(a)); return 0;
    case DatUllong: v->put<uint64_t>(static_cast<uint64_t>(a)); return 0;
    case DatInt3:
      for (long long e : x) v->put<int32_t>(static_cast<int32_t>(e));
      return 0;
    case DatUint3:
      for (long long e : x) v->put<uint32_t>(static_cast<uint32_t>(e));
      return 0;
  }
  static_cast<Writer*>(h)->failed = true;
  return 1;
}

int jbn_array(void* h, const char* name, int type, unsigned count,
              const void* data, unsigned long long nbytes) {
  Writer* w = static_cast<Writer*>(h);
  w->flush();
  Buf ab;
  ab.str("\nARRAY");
  ab.str(name);
  ab.put<int32_t>(0);  // hide
  ab.put<int32_t>(type);
  ab.put<uint32_t>(count);
  ab.put<uint32_t>(static_cast<uint32_t>(nbytes));
  uint32_t nb = static_cast<uint32_t>(ab.d.size());
  w->write(&nb, 4);
  w->write(ab.d.data(), ab.d.size());
  w->write(data, static_cast<size_t>(nbytes));
  return 0;
}

int jbn_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  w->flush();
  bool failed = w->failed;
  if (fclose(w->f) != 0) failed = true;
  delete w;
  return failed ? 1 : 0;
}

}  // extern "C"
