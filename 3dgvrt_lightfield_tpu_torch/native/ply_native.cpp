// Native PLY parser for INRIA 3DGS splat files.
//
// This repository's equivalent of the reference's miniply dependency
// (reference: base/Vulkan3DGRTModel.cpp:7-125 uses miniply::PLYReader); written
// from scratch: memory-maps the file, parses the header, and exposes per-
// property float extraction over the first "vertex" element via a C ABI
// consumed through ctypes (see ply_native.py).
//
// Supports binary_little_endian and ascii formats with scalar properties
// (float/double/int8..int32), which covers every 3DGS splat PLY in the wild.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

enum class PType : uint8_t { F32, F64, I8, U8, I16, U16, I32, U32 };

size_t psize(PType t) {
  switch (t) {
    case PType::F32: case PType::I32: case PType::U32: return 4;
    case PType::F64: return 8;
    case PType::I16: case PType::U16: return 2;
    default: return 1;
  }
}

bool parse_type(const std::string& s, PType* out) {
  if (s == "float" || s == "float32") *out = PType::F32;
  else if (s == "double" || s == "float64") *out = PType::F64;
  else if (s == "char" || s == "int8") *out = PType::I8;
  else if (s == "uchar" || s == "uint8") *out = PType::U8;
  else if (s == "short" || s == "int16") *out = PType::I16;
  else if (s == "ushort" || s == "uint16") *out = PType::U16;
  else if (s == "int" || s == "int32") *out = PType::I32;
  else if (s == "uint" || s == "uint32") *out = PType::U32;
  else return false;
  return true;
}

struct Prop {
  std::string name;
  PType type;
  size_t offset;  // byte offset within a row (binary) or column idx (ascii)
};

struct PlyFile {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  const uint8_t* data = nullptr;  // start of vertex element payload
  int64_t num_rows = 0;
  size_t row_size = 0;  // bytes per row (binary only)
  bool ascii = false;
  std::vector<Prop> props;
  std::vector<float> ascii_data;  // parsed ascii payload, row-major
};

}  // namespace

extern "C" {

void* ply_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) { close(fd); return nullptr; }
  size_t size = static_cast<size_t>(st.st_size);
  const uint8_t* map = static_cast<const uint8_t*>(
      mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  if (map == MAP_FAILED) { close(fd); return nullptr; }

  auto fail = [&]() -> void* { munmap(const_cast<uint8_t*>(map), size); close(fd); return nullptr; };

  // --- header parse (line-oriented ascii) ---
  size_t pos = 0;
  auto next_line = [&](std::string* line) -> bool {
    if (pos >= size) return false;
    size_t end = pos;
    while (end < size && map[end] != '\n') end++;
    size_t len = end - pos;
    if (len && map[pos + len - 1] == '\r') len--;
    line->assign(reinterpret_cast<const char*>(map + pos), len);
    pos = end + 1;
    return true;
  };

  std::string line;
  if (!next_line(&line) || line != "ply") return fail();

  auto* f = new PlyFile();
  f->fd = fd; f->map = map; f->map_size = size;

  bool in_vertex = false, done_vertex = false;
  size_t offset = 0;
  int64_t skip_rows_before = -1;
  while (next_line(&line)) {
    char tok0[32], tok1[64], tok2[64], tok3[64];
    if (line.rfind("format", 0) == 0) {
      if (line.find("binary_little_endian") != std::string::npos) f->ascii = false;
      else if (line.find("ascii") != std::string::npos) f->ascii = true;
      else { delete f; return fail(); }  // big-endian unsupported
    } else if (line.rfind("comment", 0) == 0) {
      continue;
    } else if (line.rfind("element", 0) == 0) {
      if (in_vertex) { done_vertex = true; }
      if (sscanf(line.c_str(), "%31s %63s %63s", tok0, tok1, tok2) == 3 &&
          strcmp(tok1, "vertex") == 0 && !done_vertex) {
        in_vertex = true;
        f->num_rows = atoll(tok2);
      } else if (!done_vertex && !in_vertex) {
        // a non-vertex element before vertex: unsupported layout
        delete f; return fail();
      }
    } else if (line.rfind("property", 0) == 0) {
      if (!in_vertex || done_vertex) continue;
      if (sscanf(line.c_str(), "%31s %63s %63s", tok0, tok1, tok2) != 3) continue;
      if (strcmp(tok1, "list") == 0) { delete f; return fail(); }
      PType t;
      if (!parse_type(tok1, &t)) { delete f; return fail(); }
      f->props.push_back({tok2, t, offset});
      offset += f->ascii ? 1 : psize(t);
      (void)tok3;
    } else if (line == "end_header") {
      break;
    }
  }
  if (f->num_rows <= 0 || f->props.empty()) { delete f; return fail(); }
  f->row_size = offset;
  f->data = map + pos;
  (void)skip_rows_before;

  if (f->ascii) {
    // Parse all floats once; strtof is the hot loop.
    size_t ncols = f->props.size();
    f->ascii_data.resize(static_cast<size_t>(f->num_rows) * ncols);
    const char* p = reinterpret_cast<const char*>(f->data);
    const char* endp = reinterpret_cast<const char*>(map + size);
    for (size_t i = 0; i < f->ascii_data.size(); i++) {
      char* q = nullptr;
      while (p < endp && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) p++;
      f->ascii_data[i] = strtof(p, &q);
      if (q == p) { delete f; return fail(); }
      p = q;
    }
  } else if (pos + static_cast<size_t>(f->num_rows) * f->row_size > size) {
    delete f; return fail();
  }
  return f;
}

int64_t ply_num_rows(void* h) { return static_cast<PlyFile*>(h)->num_rows; }
int32_t ply_num_props(void* h) {
  return static_cast<int32_t>(static_cast<PlyFile*>(h)->props.size());
}
const char* ply_prop_name(void* h, int32_t i) {
  auto* f = static_cast<PlyFile*>(h);
  if (i < 0 || i >= static_cast<int32_t>(f->props.size())) return "";
  return f->props[i].name.c_str();
}

// Extract property column `i` into `out` (float32, length num_rows).
int32_t ply_extract(void* h, int32_t i, float* out) {
  auto* f = static_cast<PlyFile*>(h);
  if (i < 0 || i >= static_cast<int32_t>(f->props.size())) return 1;
  const Prop& p = f->props[i];
  const int64_t n = f->num_rows;
  if (f->ascii) {
    const size_t ncols = f->props.size();
    for (int64_t r = 0; r < n; r++) out[r] = f->ascii_data[r * ncols + p.offset];
    return 0;
  }
  const uint8_t* base = f->data + p.offset;
  const size_t stride = f->row_size;
  switch (p.type) {
    case PType::F32:
      for (int64_t r = 0; r < n; r++) {
        float v; memcpy(&v, base + r * stride, 4); out[r] = v;
      }
      break;
    case PType::F64:
      for (int64_t r = 0; r < n; r++) {
        double v; memcpy(&v, base + r * stride, 8); out[r] = static_cast<float>(v);
      }
      break;
    case PType::U8:
      for (int64_t r = 0; r < n; r++) out[r] = base[r * stride];
      break;
    case PType::I8:
      for (int64_t r = 0; r < n; r++) out[r] = static_cast<int8_t>(base[r * stride]);
      break;
    case PType::I16:
      for (int64_t r = 0; r < n; r++) {
        int16_t v; memcpy(&v, base + r * stride, 2); out[r] = v;
      }
      break;
    case PType::U16:
      for (int64_t r = 0; r < n; r++) {
        uint16_t v; memcpy(&v, base + r * stride, 2); out[r] = v;
      }
      break;
    case PType::I32:
      for (int64_t r = 0; r < n; r++) {
        int32_t v; memcpy(&v, base + r * stride, 4); out[r] = static_cast<float>(v);
      }
      break;
    case PType::U32:
      for (int64_t r = 0; r < n; r++) {
        uint32_t v; memcpy(&v, base + r * stride, 4); out[r] = static_cast<float>(v);
      }
      break;
  }
  return 0;
}

void ply_close(void* h) {
  auto* f = static_cast<PlyFile*>(h);
  if (f->map) munmap(const_cast<uint8_t*>(f->map), f->map_size);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

}  // extern "C"
